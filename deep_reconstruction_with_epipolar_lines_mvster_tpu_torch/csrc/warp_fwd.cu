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
// Any channel count: the stages' widths C in {8, 16, 32, 64} (FPN base 8)
// have an instance with C fixed at compile time, one thread per 8 channels;
// every other C (any --fpn_base_channel) takes the generic instance, the
// same body with C read at run time and a thread per 8, 4 or 1 channels
// (the widest that divides C, so that its loads and stores stay aligned).
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

using port::loadv;
using port::plane_taps;
using port::storev;
using port::Taps;

constexpr int THREADS = 256;

// CT > 0: C fixed at compile time; CT == 0: the generic instance, C = c_rt.
// One thread per (b, d, y, x, VW channels).
template <typename T, int CT, int VW>
__global__ void __launch_bounds__(THREADS) warp_fwd_kernel(
    const T* __restrict__ src,      // [B, Hs, Ws, C]
    const float* __restrict__ rel,  // [B, 4, 4], rows 0..2 used
    const float* __restrict__ hypo, // [B, D, H, W]
    T* __restrict__ out,            // [B, D, H, W, C]
    int B, int D, int H, int W, int Hs, int Ws, int c_rt) {
    const int C = CT > 0 ? CT : c_rt;
    const int NG = C / VW;
    const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
    const long long total = (long long)B * D * H * W * NG;
    if (idx >= total) return;
    const int cv = (int)(idx % NG) * VW;
    const long long p = idx / NG;               // (b, d, y, x)
    const int x = (int)(p % W);
    long long t = p / W;
    const int y = (int)(t % H);
    t /= H;
    const int b = (int)(t / D);

    T* o = out + p * C + cv;
    float s[VW];
    Taps tp;
    if (!plane_taps(rel + 16 * b, x, y, __ldg(hypo + p), Hs, Ws, tp)) {
#pragma unroll
        for (int i = 0; i < VW; ++i) s[i] = 0.0f;
        storev<VW>(o, s);
        return;
    }
    const T* img = src + (long long)b * Hs * Ws * C + cv;
    float a[VW], bq[VW], cq[VW], dq[VW];
    loadv<VW>(img + ((long long)tp.ya * Ws + tp.xa) * C, a);
    loadv<VW>(img + ((long long)tp.ya * Ws + tp.xb) * C, bq);
    loadv<VW>(img + ((long long)tp.yb * Ws + tp.xa) * C, cq);
    loadv<VW>(img + ((long long)tp.yb * Ws + tp.xb) * C, dq);
#pragma unroll
    for (int i = 0; i < VW; ++i) {
        float v = __fmul_rn(a[i], tp.w00);
        v = __fadd_rn(v, __fmul_rn(bq[i], tp.w10));
        v = __fadd_rn(v, __fmul_rn(cq[i], tp.w01));
        s[i] = __fadd_rn(v, __fmul_rn(dq[i], tp.w11));
    }
    storev<VW>(o, s);
}

template <typename T, int CT, int VW>
int launch(const void* src, const void* rel, const void* hypo, void* out,
           int B, int D, int H, int W, int Hs, int Ws, int C, cudaStream_t stream) {
    const long long total = (long long)B * D * H * W * (C / VW);
    const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
    warp_fwd_kernel<T, CT, VW><<<blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(src), static_cast<const float*>(rel),
        static_cast<const float*>(hypo), static_cast<T*>(out), B, D, H, W, Hs, Ws, C);
    return (int)cudaGetLastError();
}

#define WARP_FWD_ARGS src, rel, hypo, out, B, D, H, W, Hs, Ws, C, s

template <typename T>
int launch_c(int C, const void* src, const void* rel, const void* hypo, void* out,
             int B, int D, int H, int W, int Hs, int Ws, cudaStream_t s) {
    switch (C) {
        case 8: return launch<T, 8, 8>(WARP_FWD_ARGS);
        case 16: return launch<T, 16, 8>(WARP_FWD_ARGS);
        case 32: return launch<T, 32, 8>(WARP_FWD_ARGS);
        case 64: return launch<T, 64, 8>(WARP_FWD_ARGS);
        default: break;
    }
    if (C % 8 == 0) return launch<T, 0, 8>(WARP_FWD_ARGS);
    if (C % 4 == 0) return launch<T, 0, 4>(WARP_FWD_ARGS);
    return launch<T, 0, 1>(WARP_FWD_ARGS);
}

}  // namespace

// Any C >= 1: C in {8, 16, 32, 64} takes its compile-time instance, any
// other the generic one. src and out 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int warp_fwd_launch(const void* src, const void* rel, const void* hypo, void* out,
                               int B, int D, int H, int W, int Hs, int Ws, int C,
                               int is_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return launch_c<__nv_bfloat16>(C, src, rel, hypo, out, B, D, H, W, Hs, Ws, s);
    return launch_c<float>(C, src, rel, hypo, out, B, D, H, W, Hs, Ws, s);
}
