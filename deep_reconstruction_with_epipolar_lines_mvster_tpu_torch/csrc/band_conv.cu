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
// That direct form (band_conv_kernel) is the float32 route, and the bf16
// route for Ci or Co over 64.
//
// Bound on an H100: bytes. At the flagship eval forward's eight layers
// (Ci, Co <= 16, bf16) the function reads x once and writes out once, 634 MB
// per forward, 0.19 ms at 3.35 TB/s; its 25.1 GFLOP take 0.375 ms on the
// float32 CUDA cores (67 TFLOP/s) and 0.025 ms on the bf16 tensor cores.
// The direct form took 1.58 ms per bf16 forward (its eight layers, H100
// 80GB HBM3 at 700 W): it sums in float32 on the CUDA cores, reading one
// shared float and Co/4 float4 weights per Co FMAs, stages the halo element by element,
// and its 18 x 18 halo costs 1.27x the input reads.
//
// The bf16 route (band_conv_kernel_mma, Ci and Co <= 64) is an implicit GEMM on
// the tensor cores, mma.sync m16n8k16 with bf16 inputs and float32
// accumulators: M = 16 output pixels of a tile row, N = Co padded to a
// multiple of 8 (NT n-tiles), K = 9 taps x Ci padded to CIP (8, 16, 32 or
// 64): two taps per k16 step at CIP 8, CIP / 16 steps per tap above.
//   - Tiles of 64 output columns x 16 rows (8 at CIP 32, 4 at CIP 64), so
//     the 18 x 66 halo costs 1.16x the input reads at CIP <= 16. The whole
//     halo, all CIP channels, stays in shared memory, pixel-major, 16-byte
//     chunks XOR-swizzled by the pixel index so that the eight rows of an
//     ldmatrix phase fall on eight bank groups at every one-pixel shift.
//   - Persistent CTAs of 8 warps, as many as fit on the card, each walking
//     tiles with two halo buffers: the next tile's halo loads while the
//     MMAs run on this one's (a one-tile CTA left its loads and its MMAs
//     in series: 2.8-6x the byte bound at 8-16 channels).
//   - Staging: cp.async in 16-byte chunks where Ci % 8 == 0, zero outside
//     the image and past Ci; at Ci = 3 or 4 (no 16-byte chunk of such a
//     pixel is aligned) each thread builds a pixel's 16-byte chunk from its
//     channels (one 8-byte load at Ci = 4) and stores it once.
//   - A tap is the halo window shifted by (dy, dx): one ldmatrix.x4 a
//     16-pixel m-tile, each lane giving the address of its pixel, so the
//     shift costs nothing.
//   - B fragments built once per CTA from the float32 weight (rounded to
//     bf16) into shared memory, 8 bytes a lane, read conflict-free in the
//     k-loop: no packing pass on the host, whose three small launches a
//     call cost more than the kernel at the small Reg2D layers, and none of
//     the register pressure of building them in the k-loop (255 registers
//     and spills at CIP 64).
//   - Epilogue: acc * scale + bias and the ReLU in float32, as the direct
//     form's two roundings, one bf16 rounding, 4-byte stores that cover
//     whole 16-byte channel runs of 8 pixels per warp instruction.
// wgmma is not needed: at N = Co <= 64 the layers are bound by bytes.

#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

using port::cp_async16;
using port::ldmatrix_x4;
using port::mma_bf16;
using port::pack_bf16;
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

// ------------------------------------------------------ bf16, tensor cores

constexpr int MMA_THREADS = 256;
constexpr int MTC = 64;                          // output columns per tile

// output rows per tile: a halo of CIP channels stays near 20-50 KB a buffer
template <int CIP> __host__ __device__ constexpr int mma_rows() {
    return CIP <= 16 ? 16 : CIP == 32 ? 8 : 4;
}

template <int CIP>
__host__ __device__ constexpr size_t mma_buffer_bytes() {
    return (size_t)(mma_rows<CIP>() + 2) * (MTC + 2) * CIP * 2;
}

// the B fragments of all k-steps and n-tiles, 8 bytes a lane
template <int CIP>
__host__ __device__ constexpr int mma_ksteps() { return CIP == 8 ? 5 : 9 * (CIP / 16); }

template <int CIP, int NT>
__host__ __device__ constexpr size_t mma_smem_bytes() {
    return 2 * mma_buffer_bytes<CIP>() + (size_t)mma_ksteps<CIP>() * NT * 32 * 8;
}

// byte offset of 16-byte chunk c of halo pixel p (NCH chunks a pixel)
template <int NCH>
__device__ __forceinline__ int swz(int p, int c) {
    constexpr int SSH = NCH == 8 ? 0 : NCH == 4 ? 1 : NCH == 2 ? 2 : 3;
    return (p * NCH + (c ^ ((p >> SSH) & (NCH - 1)))) * 16;
}

// Stage the halo of tile (n, r0, c0) into xs, zero outside the image and
// past Ci: cp.async 16-byte chunks where Ci % 8 == 0 (not waited for here),
// else one 16-byte shared store per chunk, built from the pixel's channels.
template <int CIP>
__device__ __forceinline__ void stage_halo(char* xs, const __nv_bfloat16* x, int n, int r0,
                                           int c0, int H, int W, int Ci, int tid) {
    constexpr int HC = MTC + 2, NPX = (mma_rows<CIP>() + 2) * HC, NCH = CIP / 8;
    const __nv_bfloat16* xn = x + (long long)n * H * W * Ci;
    if (Ci % 8 == 0) {
        for (int i = tid; i < NPX * NCH; i += MMA_THREADS) {
            const int p = i / NCH, c = i % NCH;
            const int hy = r0 - 1 + p / HC, hx = c0 - 1 + p % HC;
            const bool ok = hy >= 0 && hy < H && hx >= 0 && hx < W && c * 8 < Ci;
            cp_async16(xs + swz<NCH>(p, c),
                       xn + (ok ? ((long long)hy * W + hx) * Ci + c * 8 : 0), ok);
        }
        return;
    }
    if (Ci == 4) {                               // one aligned 8-byte load a pixel
        const uint2* xr = reinterpret_cast<const uint2*>(xn);
#pragma unroll 4
        for (int p = tid; p < NPX; p += MMA_THREADS) {
            const int hy = r0 - 1 + p / HC, hx = c0 - 1 + p % HC;
            const bool ok = hy >= 0 && hy < H && hx >= 0 && hx < W;
            const uint2 v = ok ? __ldg(xr + (long long)hy * W + hx) : make_uint2(0u, 0u);
            *reinterpret_cast<uint4*>(xs + swz<NCH>(p, 0)) = make_uint4(v.x, v.y, 0u, 0u);
        }
        return;
    }
    const unsigned short* xr = reinterpret_cast<const unsigned short*>(xn);
#pragma unroll 4
    for (int i = tid; i < NPX * NCH; i += MMA_THREADS) {
        const int p = i / NCH, c = i % NCH;
        const int hy = r0 - 1 + p / HC, hx = c0 - 1 + p % HC;
        const bool ok = hy >= 0 && hy < H && hx >= 0 && hx < W;
        const unsigned short* px = xr + ((long long)hy * W + hx) * Ci + c * 8;
        unsigned short v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = ok && c * 8 + e < Ci ? __ldg(px + e) : 0;
        *reinterpret_cast<uint4*>(xs + swz<NCH>(p, c)) =
            make_uint4(v[0] | (unsigned)v[1] << 16, v[2] | (unsigned)v[3] << 16,
                       v[4] | (unsigned)v[5] << 16, v[6] | (unsigned)v[7] << 16);
    }
}

// The B fragment of `lane` for k-step ks and n-tile j, built from the
// float32 weight [Co, Ci, 3, 3] and rounded to bf16 (as the plain
// version's weight.to(x.dtype)): n = 8j + lane / 4, and k = 2t, 2t + 1
// (b.x), 2t + 8, 2t + 9 (b.y), t = lane % 4. At CIP 8, k-step ks holds taps
// 2 ks (k 0-7) and 2 ks + 1 (k 8-15), 8 channels each; above, tap ks / KCN
// holds channels 16 (ks % KCN) + k. A k past Ci or the taps, or an n past
// Co, is 0.
template <int CIP>
__device__ __forceinline__ uint2 b_frag(const float* __restrict__ w, int ks, int j, int lane,
                                        int Ci, int Co) {
    constexpr int KCN = CIP >= 16 ? CIP / 16 : 1;
    const int n = 8 * j + (lane >> 2), t = lane & 3;
    float v[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
        const int kk = 2 * t + (h & 1) + 8 * (h >> 1);
        const int tap = CIP == 8 ? 2 * ks + (kk >> 3) : ks / KCN;
        const int ch = CIP == 8 ? kk & 7 : (ks % KCN) * 16 + kk;
        v[h] = tap < 9 && ch < Ci && n < Co ? __ldg(w + ((long long)n * Ci + ch) * 9 + tap) : 0.0f;
    }
    return make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

// Persistent: CTA b takes tiles b, b + gridDim.x, ...; the halo of its next
// tile loads into the other of two buffers while the MMAs run on this one.
template <int CIP, int NT>
__global__ void __launch_bounds__(MMA_THREADS) band_conv_kernel_mma(
    const __nv_bfloat16* __restrict__ x,  // [N, H, W, Ci]
    const float* __restrict__ w,          // [Co, Ci, 3, 3]
    const float* __restrict__ scale,      // [Co]
    const float* __restrict__ bias,       // [Co]
    __nv_bfloat16* __restrict__ out,      // [N, H, W, Co]
    int N, int H, int W, int Ci, int Co) {
    constexpr int TR = mma_rows<CIP>();
    constexpr int HC = MTC + 2;
    constexpr int NCH = CIP / 8;                 // 16-byte chunks a pixel
    constexpr int KCN = CIP >= 16 ? CIP / 16 : 1;  // k-steps a tap
    constexpr int KS = mma_ksteps<CIP>();
    constexpr int MTW = TR * (MTC / 16) / 8;     // m-tiles a warp: 8, 4 or 2
    constexpr int MW = MTW < 16 / NT ? MTW : 16 / NT;   // m-tiles a pass
    constexpr size_t BUF = mma_buffer_bytes<CIP>();
    extern __shared__ uint4 smem_mma[];
    char* xs0 = reinterpret_cast<char*>(smem_mma);
    uint2* fb = reinterpret_cast<uint2*>(xs0 + 2 * BUF);   // [KS][NT][32]

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, tq = lane & 3;
    const int tiles_x = (W + MTC - 1) / MTC, tiles_y = (H + TR - 1) / TR;
    const int ntiles = N * tiles_y * tiles_x;

    int t = blockIdx.x;
    if (t >= ntiles) return;
    // the B fragments, once per CTA (read after the loop's first barrier)
    for (int i = tid; i < KS * NT * 32; i += MMA_THREADS)
        fb[i] = b_frag<CIP>(w, i / (NT * 32), (i / 32) % NT, i % 32, Ci, Co);
    stage_halo<CIP>(xs0, x, t / (tiles_y * tiles_x), (t / tiles_x % tiles_y) * TR,
                    (t % tiles_x) * MTC, H, W, Ci, tid);
    asm volatile("cp.async.commit_group;\n");
#pragma unroll 1
    for (int it = 0; t < ntiles; ++it, t += gridDim.x) {
        char* xs = xs0 + (it & 1) * BUF;
        const int tn = t + gridDim.x;
        if (tn < ntiles)
            stage_halo<CIP>(xs0 + ((it + 1) & 1) * BUF, x, tn / (tiles_y * tiles_x),
                            (tn / tiles_x % tiles_y) * TR, (tn % tiles_x) * MTC, H, W, Ci, tid);
        asm volatile("cp.async.commit_group;\n");
        asm volatile("cp.async.wait_group 1;\n");   // this tile's halo has landed
        __syncthreads();

        const int n = t / (tiles_y * tiles_x);
        const int r0 = (t / tiles_x % tiles_y) * TR, c0 = (t % tiles_x) * MTC;
#pragma unroll 1
        for (int m0 = 0; m0 < MTW; m0 += MW) {
            float acc[MW][NT][4];
#pragma unroll
            for (int mi = 0; mi < MW; ++mi)
#pragma unroll
                for (int j = 0; j < NT; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;
#pragma unroll 1
            for (int ks = 0; ks < KS; ++ks) {
                uint2 b[NT];
#pragma unroll
                for (int j = 0; j < NT; ++j) b[j] = fb[(ks * NT + j) * 32 + lane];
                // the tap and the 16-byte chunk this lane addresses: lanes 0-15
                // give k 0-7 of the step, lanes 16-31 k 8-15
                int tap, c;
                if (CIP == 8) {
                    tap = min(2 * ks + (lane >> 4), 8);
                    c = 0;
                } else {
                    tap = ks / KCN;
                    c = 2 * (ks % KCN) + (lane >> 4);
                }
                const int dy = tap / 3, dx = tap % 3;
#pragma unroll
                for (int mi = 0; mi < MW; ++mi) {
                    const int mt = warp * MTW + m0 + mi;
                    const int row = mt / (MTC / 16), cq = mt % (MTC / 16);
                    const int p = (row + dy) * HC + cq * 16 + (lane & 15) + dx;
                    uint32_t a[4];
                    ldmatrix_x4(a, xs + swz<NCH>(p, c));
                    if (CIP == 8 && ks == KS - 1) {  // k 8-15 of the last step: no tap
                        a[2] = 0u;
                        a[3] = 0u;
                    }
#pragma unroll
                    for (int j = 0; j < NT; ++j) mma_bf16(acc[mi][j], a, b[j]);
                }
            }
            // acc * scale + bias, ReLU (keeps a NaN), one bf16 rounding
#pragma unroll
            for (int mi = 0; mi < MW; ++mi) {
                const int mt = warp * MTW + m0 + mi;
                const int orow = r0 + mt / (MTC / 16);
                if (orow >= H) continue;
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int ocol = c0 + (mt % (MTC / 16)) * 16 + gq + 8 * half;
                    if (ocol >= W) continue;
                    __nv_bfloat16* op = out + (((long long)n * H + orow) * W + ocol) * Co;
#pragma unroll
                    for (int j = 0; j < NT; ++j) {
                        const int co = 8 * j + 2 * tq;
                        float r[2];
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const float sc = co + e < Co ? __ldg(scale + co + e) : 0.0f;
                            const float bs = co + e < Co ? __ldg(bias + co + e) : 0.0f;
                            const float v = __fadd_rn(__fmul_rn(acc[mi][j][2 * half + e], sc), bs);
                            r[e] = v < 0.0f ? 0.0f : v;
                        }
                        if (co + 1 < Co && (Co & 1) == 0) {
                            *reinterpret_cast<__nv_bfloat162*>(op + co) =
                                __floats2bfloat162_rn(r[0], r[1]);
                        } else {
                            if (co < Co) store1(op + co, r[0]);
                            if (co + 1 < Co) store1(op + co + 1, r[1]);
                        }
                    }
                }
            }
        }
        __syncthreads();                         // this buffer is free for tile t + 2 grid
    }
}

// The persistent grid: the CTAs that fit on the card at once, found once
// per instance (the port runs on one card) with the shared-memory limit set.
template <int CIP, int NT>
int launch_mma(const void* x, const float* w, const float* scale, const float* bias, void* out,
               int N, int H, int W, int Ci, int Co, cudaStream_t stream) {
    auto kernel = band_conv_kernel_mma<CIP, NT>;
    const size_t bytes = mma_smem_bytes<CIP, NT>();
    static int resident = 0;
    if (resident == 0) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)bytes);
        int dev = 0, sms = 0, per_sm = 0;
        if (e == cudaSuccess) e = cudaGetDevice(&dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, MMA_THREADS, bytes);
        if (e != cudaSuccess) return (int)e;
        resident = sms * std::max(per_sm, 1);
    }
    constexpr int TR = mma_rows<CIP>();
    const long long ntiles = (long long)N * ((H + TR - 1) / TR) * ((W + MTC - 1) / MTC);
    const long long grid = std::min<long long>(ntiles, resident);
    kernel<<<(unsigned)grid, MMA_THREADS, bytes, stream>>>(
        static_cast<const __nv_bfloat16*>(x), w, scale, bias,
        static_cast<__nv_bfloat16*>(out), N, H, W, Ci, Co);
    return (int)cudaGetLastError();
}

template <int CIP>
int launch_mma_nt(int nt, const void* x, const float* w, const float* scale, const float* bias,
                  void* out, int N, int H, int W, int Ci, int Co, cudaStream_t s) {
    switch (nt) {
        case 1: return launch_mma<CIP, 1>(x, w, scale, bias, out, N, H, W, Ci, Co, s);
        case 2: return launch_mma<CIP, 2>(x, w, scale, bias, out, N, H, W, Ci, Co, s);
        case 4: return launch_mma<CIP, 4>(x, w, scale, bias, out, N, H, W, Ci, Co, s);
        case 8: return launch_mma<CIP, 8>(x, w, scale, bias, out, N, H, W, Ci, Co, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// ------------------------------------------------------------- launchers

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
// [Co, Ci, 3, 3], scale and bias [Co], float32. With cip > 0 (bf16 only):
// the tensor-core route for cip in {8, 16, 32, 64} >= Ci and nt in {1, 2, 4,
// 8}, 8 nt >= Co; x 16-byte aligned. Otherwise the direct form. The caller
// keeps N under 65536 and out 16-byte aligned. Returns cudaGetLastError()
// after the launch.
extern "C" int band_conv_launch(const void* x, const float* w, const float* scale,
                                const float* bias, void* out, int N, int H, int W, int Ci,
                                int Co, int is_bf16, int cip, int nt, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (cip > 0) {
        if (!is_bf16 || Ci > cip || Co > 8 * nt) return (int)cudaErrorInvalidValue;
        switch (cip) {
            case 8: return launch_mma_nt<8>(nt, x, w, scale, bias, out, N, H, W, Ci, Co, s);
            case 16: return launch_mma_nt<16>(nt, x, w, scale, bias, out, N, H, W, Ci, Co, s);
            case 32: return launch_mma_nt<32>(nt, x, w, scale, bias, out, N, H, W, Ci, Co, s);
            case 64: return launch_mma_nt<64>(nt, x, w, scale, bias, out, N, H, W, Ci, Co, s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    if (is_bf16)
        return launch_co<__nv_bfloat16>(x, w, scale, bias, out, N, H, W, Ci, Co, s);
    return launch_co<float>(x, w, scale, bias, out, N, H, W, Ci, Co, s);
}
