// K1: fused plane-sweep warp + group correlation, one source view.
//
// Replaces the TPU kernel
//   deep_reconstruction_with_epipolar_lines_mvster_tpu/ops/pallas/warp_fwd_v3.py:438
//   warp_cor_tiles_pallas_v3_ik (inner kernels _kernel_cor_ik :311,
//   _kernel_xchunk_cor_ik :363, coordinates _tile_coords_ik :278),
// and computes the function of JAX correlate_view(impl="gather",
// group_cor=True): out[b,d,y,x,g] = mean over the C/G channels c of group g
// of bilinear(src[b], coords(b,d,y,x))[c] * ref[b,y,x,c], zeros padding.
//
// The TPU kernel is a banded matmul because the TPU has no fast gather;
// here the natural form is a direct gather. One thread per (b, d, y, x):
//   1. coordinates and taps from common.cuh's plane_taps, shared with
//      K3: the order of core/geometry.warp_coords_xy, (m0*u + m1*v +
//      m2)*d + m3, with the z == 0 -> 1e-9 guard; the _rn intrinsics stop
//      nvcc from contracting into FMAs, so the coordinates are the plain
//      PyTorch version's to the bit;
//   2. four NHWC taps, eight channels per 16-byte load for bf16;
//   3. the product with ref, summed per group in float32 registers;
//   4. G group means written in the source dtype.
// A coordinate outside (-2, Ws+1) x (-2, Hs+1), NaN included, means four
// invalid taps: it is tested before any float -> int cast (undefined in
// CUDA for NaN and huge values) and gives 0, as the JAX gather does.
//
// Bound on an H100: bytes. Each (b,d,y,x) reads its depth (4 B), its ref
// pixel (2C B) and four source pixels, and writes G values; per output
// element that is a few loads for ~6C FLOPs, far under the card's
// FLOP/byte line. The source and ref rows of one tile are reused by the
// D hypotheses and by neighbouring threads through L1/L2, so the traffic
// to device memory is close to one read of each input and one write of
// the output: about 105 MB at the bench stage 4 (B4 D4 512x640 C8 G4 bf16;
// the bf16 output alone is 42 MB), 31 us at 3.35 TB/s. Stages 1-3 launch
// grids too small to fill the card and are bound by latency, not bytes.
// Threads along x read neighbouring ref pixels and,
// for the small disparities of a plane sweep, neighbouring source pixels,
// so the loads coalesce.

#include <stdint.h>

#include "common.cuh"

namespace {

using port::load8;
using port::store1;
using port::plane_taps;
using port::Taps;

template <typename T, int C, int G>
__global__ void __launch_bounds__(256) warp_cor_kernel(
    const T* __restrict__ src,     // [B, Hs, Ws, C]
    const T* __restrict__ ref,     // [B, H, W, C]
    const float* __restrict__ rel, // [B, 4, 4], rows 0..2 used
    const float* __restrict__ hypo,// [B, D, H, W]
    T* __restrict__ out,           // [B, D, H, W, G]
    int B, int D, int H, int W, int Hs, int Ws) {
    constexpr int CPG = C / G;
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long total = (long long)B * D * H * W;
    if (idx >= total) return;
    const int x = (int)(idx % W);
    long long t = idx / W;
    const int y = (int)(t % H);
    t /= H;
    const int b = (int)(t / D);

    T* o = out + idx * G;
    Taps tp;
    if (!plane_taps(rel + 16 * b, x, y, __ldg(hypo + idx), Hs, Ws, tp)) {
#pragma unroll
        for (int g = 0; g < G; ++g) store1(o + g, 0.0f);
        return;
    }
    const float w00 = tp.w00, w10 = tp.w10, w01 = tp.w01, w11 = tp.w11;
    const T* img = src + (long long)b * Hs * Ws * C;
    const T* p00 = img + ((long long)tp.ya * Ws + tp.xa) * C;
    const T* p10 = img + ((long long)tp.ya * Ws + tp.xb) * C;
    const T* p01 = img + ((long long)tp.yb * Ws + tp.xa) * C;
    const T* p11 = img + ((long long)tp.yb * Ws + tp.xb) * C;
    const T* r = ref + (((long long)b * H + y) * W + x) * C;

    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.0f;
#pragma unroll
    for (int c8 = 0; c8 < C; c8 += 8) {
        float a[8], bq[8], cq[8], dq[8], rr[8];
        load8(p00 + c8, a);
        load8(p10 + c8, bq);
        load8(p01 + c8, cq);
        load8(p11 + c8, dq);
        load8(r + c8, rr);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            float s = __fmul_rn(a[i], w00);
            s = __fadd_rn(s, __fmul_rn(bq[i], w10));
            s = __fadd_rn(s, __fmul_rn(cq[i], w01));
            s = __fadd_rn(s, __fmul_rn(dq[i], w11));
            acc[(c8 + i) / CPG] = __fadd_rn(acc[(c8 + i) / CPG], __fmul_rn(s, rr[i]));
        }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) store1(o + g, __fdiv_rn(acc[g], (float)CPG));
}

template <typename T, int C, int G>
int launch(const void* src, const void* ref, const void* rel, const void* hypo, void* out,
           int B, int D, int H, int W, int Hs, int Ws, cudaStream_t stream) {
    const long long total = (long long)B * D * H * W;
    const unsigned blocks = (unsigned)((total + 255) / 256);
    warp_cor_kernel<T, C, G><<<blocks, 256, 0, stream>>>(
        static_cast<const T*>(src), static_cast<const T*>(ref),
        static_cast<const float*>(rel), static_cast<const float*>(hypo),
        static_cast<T*>(out), B, D, H, W, Hs, Ws);
    return (int)cudaGetLastError();
}

template <typename T, int C>
int launch_g(int G, const void* src, const void* ref, const void* rel, const void* hypo,
             void* out, int B, int D, int H, int W, int Hs, int Ws, cudaStream_t s) {
    switch (G) {
        case 1: return launch<T, C, 1>(src, ref, rel, hypo, out, B, D, H, W, Hs, Ws, s);
        case 2: return launch<T, C, 2>(src, ref, rel, hypo, out, B, D, H, W, Hs, Ws, s);
        case 4: return launch<T, C, 4>(src, ref, rel, hypo, out, B, D, H, W, Hs, Ws, s);
        case 8: return launch<T, C, 8>(src, ref, rel, hypo, out, B, D, H, W, Hs, Ws, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <typename T>
int launch_c(int C, int G, const void* src, const void* ref, const void* rel,
             const void* hypo, void* out, int B, int D, int H, int W, int Hs, int Ws,
             cudaStream_t s) {
    switch (C) {
        case 8: return launch_g<T, 8>(G, src, ref, rel, hypo, out, B, D, H, W, Hs, Ws, s);
        case 16: return launch_g<T, 16>(G, src, ref, rel, hypo, out, B, D, H, W, Hs, Ws, s);
        case 32: return launch_g<T, 32>(G, src, ref, rel, hypo, out, B, D, H, W, Hs, Ws, s);
        case 64: return launch_g<T, 64>(G, src, ref, rel, hypo, out, B, D, H, W, Hs, Ws, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// channel or group count without an instantiation).
extern "C" int warp_cor_launch(const void* src, const void* ref, const void* rel,
                               const void* hypo, void* out, int B, int D, int H, int W,
                               int Hs, int Ws, int C, int G, int is_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return launch_c<__nv_bfloat16>(C, G, src, ref, rel, hypo, out, B, D, H, W, Hs, Ws, s);
    return launch_c<float>(C, G, src, ref, rel, hypo, out, B, D, H, W, Hs, Ws, s);
}
