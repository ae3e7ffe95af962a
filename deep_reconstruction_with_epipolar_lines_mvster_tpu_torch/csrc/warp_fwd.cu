// K4: the plain plane-sweep bilinear warp forward, one source view.
//
// Replaces the TPU kernels that compute this function from precomputed
// coordinate planes, each truncated to a band of source rows (and columns):
//   deep_reconstruction_with_epipolar_lines_mvster_tpu/ops/pallas/
//     warp_fwd_v3.py:522 warp_tiles_pallas_v3 without ref (_kernel :42,
//       _kernel_xchunk :89), reached through ops/warp_mxu._warp_v3;
//     warp_xband_kernel.py:111 warp_tiles_pallas_xband (_kernel :48);
//     warp_kernel.py:83 warp_tiles_pallas (_kernel :35),
// and computes out[b,d,y,x,c] = bilinear(src[b], coords(b,d,y,x))[c] with
// zeros padding, as core/geometry.grid_sample_2d at warp_coords does, in
// float32, stored in the source dtype.
//
// The TPU kernels are banded matmuls because the TPU has no fast gather;
// they drop taps outside their band. Here the natural form is a direct,
// exact gather:
//   - one thread per (b, d, y, x, 8-channel group): the C/8 threads of a
//     pixel are neighbours, so each thread stores 16 bytes (bf16) or 32
//     bytes (float32) next to its neighbour's and a warp's stores
//     coalesce along C;
//   - coordinates and taps from common.cuh's plane_taps, the same device
//     code as K1 and K3, so forward, fused correlation and backward address
//     the same corners with the same weights, bit for bit with the plain
//     version (the _rn intrinsics stop nvcc from contracting into FMAs);
//   - the four taps are summed in the plain version's order,
//     ((a*w00 + b*w10) + c*w01) + d*w11.
//
// Bound on an H100: bytes. Each output element costs 4 taps (8 FLOPs) and
// one store; per pixel the function reads its depth (4 B), writes C values
// and reads the source, which the D hypotheses and neighbouring pixels
// share through L1/L2. The least traffic is the source read once, the
// hypotheses read once and the output written once: at the DTU recipe's
// stage 4 (B6 D4 512x640 C8, bf16) that is ~126 MB of output plus ~31 MB
// of hypotheses and ~31 MB of source, 56 us at 3.35 TB/s.

#include <stdint.h>

#include "common.cuh"

namespace {

using port::load8;
using port::plane_taps;
using port::Taps;

constexpr int THREADS = 256;

__device__ __forceinline__ void store8(float* p, const float v[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = r;
}

template <typename T, int C>
__global__ void __launch_bounds__(THREADS) warp_fwd_kernel(
    const T* __restrict__ src,      // [B, Hs, Ws, C]
    const float* __restrict__ rel,  // [B, 4, 4], rows 0..2 used
    const float* __restrict__ hypo, // [B, D, H, W]
    T* __restrict__ out,            // [B, D, H, W, C]
    int B, int D, int H, int W, int Hs, int Ws) {
    constexpr int NG = C / 8;
    const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
    const long long total = (long long)B * D * H * W * NG;
    if (idx >= total) return;
    const int c8 = (int)(idx % NG) * 8;
    const long long p = idx / NG;               // (b, d, y, x)
    const int x = (int)(p % W);
    long long t = p / W;
    const int y = (int)(t % H);
    t /= H;
    const int b = (int)(t / D);

    T* o = out + p * C + c8;
    float s[8];
    Taps tp;
    if (!plane_taps(rel + 16 * b, x, y, __ldg(hypo + p), Hs, Ws, tp)) {
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i] = 0.0f;
        store8(o, s);
        return;
    }
    const T* img = src + (long long)b * Hs * Ws * C + c8;
    float a[8], bq[8], cq[8], dq[8];
    load8(img + ((long long)tp.ya * Ws + tp.xa) * C, a);
    load8(img + ((long long)tp.ya * Ws + tp.xb) * C, bq);
    load8(img + ((long long)tp.yb * Ws + tp.xa) * C, cq);
    load8(img + ((long long)tp.yb * Ws + tp.xb) * C, dq);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        float v = __fmul_rn(a[i], tp.w00);
        v = __fadd_rn(v, __fmul_rn(bq[i], tp.w10));
        v = __fadd_rn(v, __fmul_rn(cq[i], tp.w01));
        s[i] = __fadd_rn(v, __fmul_rn(dq[i], tp.w11));
    }
    store8(o, s);
}

template <typename T, int C>
int launch(const void* src, const void* rel, const void* hypo, void* out,
           int B, int D, int H, int W, int Hs, int Ws, cudaStream_t stream) {
    const long long total = (long long)B * D * H * W * (C / 8);
    const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
    warp_fwd_kernel<T, C><<<blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(src), static_cast<const float*>(rel),
        static_cast<const float*>(hypo), static_cast<T*>(out), B, D, H, W, Hs, Ws);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_c(int C, const void* src, const void* rel, const void* hypo, void* out,
             int B, int D, int H, int W, int Hs, int Ws, cudaStream_t s) {
    switch (C) {
        case 8: return launch<T, 8>(src, rel, hypo, out, B, D, H, W, Hs, Ws, s);
        case 16: return launch<T, 16>(src, rel, hypo, out, B, D, H, W, Hs, Ws, s);
        case 32: return launch<T, 32>(src, rel, hypo, out, B, D, H, W, Hs, Ws, s);
        case 64: return launch<T, 64>(src, rel, hypo, out, B, D, H, W, Hs, Ws, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// channel count without an instantiation).
extern "C" int warp_fwd_launch(const void* src, const void* rel, const void* hypo, void* out,
                               int B, int D, int H, int W, int Hs, int Ws, int C,
                               int is_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return launch_c<__nv_bfloat16>(C, src, rel, hypo, out, B, D, H, W, Hs, Ws, s);
    return launch_c<float>(C, src, rel, hypo, out, B, D, H, W, Hs, Ws, s);
}
