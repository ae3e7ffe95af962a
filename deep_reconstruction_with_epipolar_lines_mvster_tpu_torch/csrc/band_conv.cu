// K6: 3x3, stride-1, pad-1 convolution with a fused per-channel scale, bias
// and ReLU: the eval-mode ConvBnReLU once the BatchNorm's running statistics
// are folded into `scale` and `bias`.
//
// Replaces the TPU kernel
//   deep_reconstruction_with_epipolar_lines_mvster_tpu/ops/pallas/reg_band_proto.py:89
//   band_conv3x3 (_kernel :56, pallas_call :111),
// and computes, for x [N, H, W, Ci] (NHWC, float32 or bf16) and the OIHW
// float32 weight w [Co, Ci, 3, 3] rounded to x's dtype,
//   acc[n, y, x, co] = sum_{ky, kx, ci} x[n, y+ky-1, x+kx-1, ci] * w[co, ci, ky, kx]
//   out[n, y, x, co] = max(acc * scale[co] + bias[co], 0)
// with zero padding, the sum in float32 and one rounding to x's dtype at
// the end.
//
// The TPU kernel lays channels in sublanes and width in lanes
// ([N, H, Ci, W], W padded to 128), turns the row and channel contraction
// into three banded matmuls on the MXU, and relies on zero lane padding and
// two column masks for the borders. None of that carries over: on Hopper the
// natural form is a direct convolution. One block of 256 threads owns a
// 16x16 output tile of one image. It stages the tile's 18x18 input halo
// (zeros outside the image: the padding) for a chunk of up to 16 input
// channels in shared memory, channel-major so that neighbouring threads read
// neighbouring words, and the chunk's weights as [ky*3+kx][ci][co] rounded
// to x's dtype. Each thread keeps the float32 sums of its pixel for a chunk
// of up to 16 output channels in registers; per input value it reads one
// float from shared memory and the chunk's weights as float4 broadcasts.
// After the last input chunk it applies scale, bias and ReLU and writes the
// pixel's output channels once, as 16-byte vectors where Co allows, so that
// a warp's stores cover one contiguous run of memory. Any H, W, Ci and Co:
// more than 16 input or output channels loop over chunks.
//
// Bound on an H100: bytes. At the flagship eval forward's eight layers
// (Ci, Co <= 16, bf16) the function reads x once and writes out once, 634 MB
// per forward, 0.19 ms at 3.35 TB/s; its 25.1 GFLOP take 0.375 ms on the
// float32 CUDA cores (67 TFLOP/s), where this kernel computes them, and
// 0.025 ms on the bf16 tensor cores, where a later form (mma/wgmma over the
// staged halo) would. The halo costs 18*18/(16*16) = 1.27x the input reads.

#include <stdint.h>

#include "common.cuh"

namespace {

using port::store1;

constexpr int TILE = 16;                 // output tile TILE x TILE, a thread per pixel
constexpr int HALO = TILE + 2;
constexpr int HALO_PIX = HALO * HALO;
constexpr int CI_CHUNK = 16;
constexpr int THREADS = TILE * TILE;

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// a float32 weight rounded to the working dtype, as the plain version's
// weight.to(x.dtype)
__device__ __forceinline__ float as_dtype(float v, const float*) { return v; }
__device__ __forceinline__ float as_dtype(float v, const __nv_bfloat16*) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// COB consecutive output channels of one pixel as 16-byte stores
template <int COB>
__device__ __forceinline__ void store_vec(float* o, const float r[COB]) {
#pragma unroll
    for (int q = 0; q < COB / 4; ++q)
        reinterpret_cast<float4*>(o)[q] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2],
                                                      r[4 * q + 3]);
}

template <int COB>
__device__ __forceinline__ void store_vec(__nv_bfloat16* o, const float r[COB]) {
#pragma unroll
    for (int q = 0; q < COB / 8; ++q) {
        uint4 v;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(r[8 * q + 2 * i], r[8 * q + 2 * i + 1]);
        reinterpret_cast<uint4*>(o)[q] = v;
    }
}

template <typename T, int COB>
__global__ void __launch_bounds__(THREADS) band_conv_kernel(
    const T* __restrict__ x,            // [N, H, W, Ci]
    const float* __restrict__ w,        // [Co, Ci, 3, 3]
    const float* __restrict__ scale,    // [Co]
    const float* __restrict__ bias,     // [Co]
    T* __restrict__ out,                // [N, H, W, Co]
    int H, int W, int Ci, int Co) {
    __shared__ float s_x[CI_CHUNK * HALO_PIX];                 // [ci][halo pixel]
    __shared__ __align__(16) float s_w[9 * CI_CHUNK * COB];    // [k][ci][co]
    const int n = blockIdx.z;
    const int y0 = blockIdx.y * TILE, x0 = blockIdx.x * TILE;
    const int tid = threadIdx.x;
    const int ty = tid / TILE, tx = tid % TILE;
    const int oy = y0 + ty, ox = x0 + tx;
    const T* xn = x + (long long)n * H * W * Ci;
    const bool vec = (Co % 8 == 0);

    for (int co0 = 0; co0 < Co; co0 += COB) {
        const int nco = min(COB, Co - co0);
        float acc[COB];
#pragma unroll
        for (int c = 0; c < COB; ++c) acc[c] = 0.0f;
        for (int ci0 = 0; ci0 < Ci; ci0 += CI_CHUNK) {
            const int nci = min(CI_CHUNK, Ci - ci0);
            __syncthreads();   // the previous chunk's readers are done
            // the halo, channel fastest as in device memory, so that a warp
            // reads a contiguous run of each halo row; zero outside the image
            for (int i = tid; i < HALO_PIX * nci; i += THREADS) {
                const int c = i % nci, p = i / nci;
                const int hy = y0 - 1 + p / HALO, hx = x0 - 1 + p % HALO;
                float v = 0.0f;
                if (hy >= 0 && hy < H && hx >= 0 && hx < W)
                    v = load1(xn + ((long long)hy * W + hx) * Ci + ci0 + c);
                s_x[c * HALO_PIX + p] = v;
            }
            // the chunk's weights, zero past Ci and Co
            for (int i = tid; i < 9 * CI_CHUNK * COB; i += THREADS) {
                const int co = i % COB, ci = (i / COB) % CI_CHUNK, k = i / (COB * CI_CHUNK);
                float v = 0.0f;
                if (co < nco && ci < nci)
                    v = as_dtype(__ldg(w + ((long long)(co0 + co) * Ci + ci0 + ci) * 9 + k), x);
                s_w[i] = v;
            }
            __syncthreads();
            for (int ci = 0; ci < nci; ++ci) {
                const float* sx = s_x + ci * HALO_PIX + ty * HALO + tx;
#pragma unroll
                for (int k = 0; k < 9; ++k) {
                    const float v = sx[(k / 3) * HALO + k % 3];
                    const float4* wk =
                        reinterpret_cast<const float4*>(s_w + (k * CI_CHUNK + ci) * COB);
#pragma unroll
                    for (int q = 0; q < COB / 4; ++q) {
                        const float4 wq = wk[q];
                        acc[4 * q] = fmaf(v, wq.x, acc[4 * q]);
                        acc[4 * q + 1] = fmaf(v, wq.y, acc[4 * q + 1]);
                        acc[4 * q + 2] = fmaf(v, wq.z, acc[4 * q + 2]);
                        acc[4 * q + 3] = fmaf(v, wq.w, acc[4 * q + 3]);
                    }
                }
            }
        }
        if (oy < H && ox < W) {
            // acc * scale + bias as two roundings (the plain version's mul
            // and add), then ReLU that keeps a NaN, as torch.relu does
            float r[COB];
#pragma unroll
            for (int c = 0; c < COB; ++c) {
                const float s = c < nco ? __ldg(scale + co0 + c) : 0.0f;
                const float b = c < nco ? __ldg(bias + co0 + c) : 0.0f;
                const float v = __fadd_rn(__fmul_rn(acc[c], s), b);
                r[c] = v < 0.0f ? 0.0f : v;
            }
            T* o = out + (((long long)n * H + oy) * W + ox) * Co + co0;
            if (vec && nco == COB) {
                store_vec<COB>(o, r);
            } else {
#pragma unroll
                for (int c = 0; c < COB; ++c)
                    if (c < nco) store1(o + c, r[c]);
            }
        }
    }
}

template <typename T, int COB>
int launch(const void* x, const float* w, const float* scale, const float* bias, void* out,
           int N, int H, int W, int Ci, int Co, cudaStream_t stream) {
    const dim3 grid((unsigned)((W + TILE - 1) / TILE), (unsigned)((H + TILE - 1) / TILE),
                    (unsigned)N);
    band_conv_kernel<T, COB><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), w, scale, bias, static_cast<T*>(out), H, W, Ci, Co);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_co(const void* x, const float* w, const float* scale, const float* bias, void* out,
              int N, int H, int W, int Ci, int Co, cudaStream_t stream) {
    if (Co <= 8) return launch<T, 8>(x, w, scale, bias, out, N, H, W, Ci, Co, stream);
    return launch<T, 16>(x, w, scale, bias, out, N, H, W, Ci, Co, stream);
}

}  // namespace

// x [N, H, W, Ci] -> out [N, H, W, Co], both in one dtype (is_bf16); w
// [Co, Ci, 3, 3], scale and bias [Co], float32. The caller keeps N under
// 65536 and out 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int band_conv_launch(const void* x, const float* w, const float* scale,
                                const float* bias, void* out, int N, int H, int W, int Ci,
                                int Co, int is_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return launch_co<__nv_bfloat16>(x, w, scale, bias, out, N, H, W, Ci, Co, s);
    return launch_co<float>(x, w, scale, bias, out, N, H, W, Ci, Co, s);
}
