// K3: backward of the plane-sweep bilinear warp, dL/dsrc for one source view.
//
// Replaces the TPU kernel
//   deep_reconstruction_with_epipolar_lines_mvster_tpu/ops/pallas/warp_xband_bwd.py:410
//   warp_tiles_pallas_xband_bwd_ik (inner kernel _kernel_v4_ik :332),
// the backward of ops/warp_mxu._warp_hybrid_ik, and computes for every
// (b, d, y, x) and each of the four bilinear corners inside the source image
//   dsrc[b, yc, xc, :] += w_corner * g[b, d, y, x, :]
// at the coordinates of core/geometry.warp_coords_xy (zeros padding), in
// float32. Coordinates are stop-gradient, as in the JAX package. The TPU
// kernel is a banded matmul with a sequential read-modify-write of an HBM
// accumulator, because a TPU has neither a fast scatter nor atomics; here
// the natural form is a scatter-add.
//
// Bound on an H100: bytes. The function reads each (b, d, y, x)'s depth
// (4 B) and cotangent (2C B in bf16) once and writes dsrc once in float32;
// 6C FLOPs per pixel are far under the card's FLOP/byte line. At the DTU
// recipe's stage 4 (B6 D4 512x640 C8, bf16 g) that is ~220 MB per launch,
// 66 us at 3.35 TB/s; 0.532 ms over the 16 launches of a train step. The
// wrapper's zeroing pass of dsrc (another 4 B per element) is a cost of the
// scatter design and is not part of the bound.
//
// What held the first design back (PR 2): one thread per (b, d, y, x, c)
// issued up to four scalar float32 atomicAdds into device memory, ~250M at
// stage 4, which the L2 serves one sector at a time: 170/331/339/672 us at
// stages 1-4 against bounds of 12/25/31/66 us, 6.04 ms per train step,
// slower than aten.grid_sampler_2d_backward (5.62 ms). The atomics are
// redundant twice over: the four corners of neighbouring reference pixels
// land on the same source pixels, and the D planes of a pixel land on a
// short stretch of its epipolar line, which at stages 2-4 of the train path
// is a window around the previous stage's depth.
//
// The design, in the steps it was built and measured in (chip_smoke.py's
// kernel_shapes rows, bf16, per train step, on the train path's hypotheses
// / on PR 4's full-range rows; H100 80GB HBM3 at 700 W):
//   1. Vector atomics. One thread owns a pixel's group of 4 channels, so a
//      warp's g loads stay coalesced (8 or 16 B a thread), and adds each
//      corner with one sm_90 float4 atomicAdd (REDG.E.ADD.F32x4): 4x fewer
//      atomic instructions. C % 4 == 0 and a torch.zeros buffer keep every
//      target 16-byte aligned. 3.54 / 3.56 ms.
//   2. Shared-memory accumulation of a tile's footprint, not kept: one CTA
//      per (b, reference tile) summed the taps of all D (or, where they
//      did not fit, of one plane) into a shared-memory window over their
//      bounding box and flushed it once with float4 atomics. 3.31 / 3.43
//      ms. Hopper has no float add on shared memory: atomicAdd on a shared
//      float compiles to a compare-and-swap loop (ATOMS.CAST.SPIN), which
//      costs about what the device-memory atomics it saves cost.
//   3. Runs of planes in registers, kept. The thread walks its (pixel,
//      group) through the D planes and sums the taps in registers while
//      consecutive planes keep the same four corners, with one float4
//      atomic per corner when the run ends. At stages 2-4 of the train path
//      the planes of a pixel lie within a pixel of each other, so most runs
//      span all D. Inside step 2's tiled kernel: 2.19 / 3.31 ms without
//      the window, 2.84 / 3.87 ms with it, so the window went; this kernel,
//      one thread per (b, y, x, 4 channels), takes 1.84 / 2.98 ms
//      (aten.grid_sampler_2d_backward: 5.36 / 5.63 ms).
//
// Any C: C % 4 == 0 (every stage at an FPN base that is a multiple of 4)
// takes the float4 path above; any other C (base 1, 2, 3, 5, ...) the same
// kernel with one channel a thread and scalar float atomics (VW = 1).
//
// Kept from the first design: coordinates and taps from common.cuh's
// pixel_rows (once per pixel) and depth_taps (once per plane), the same
// device code as K1 and K4, so forward and backward read and write the same
// corners with the same weights, and each product w * g is the plain
// version's, bit for bit; the range test comes before any float -> int cast
// (in depth_taps), so a NaN or huge coordinate gives no taps. The order
// of the float32 sums (a run's in registers, then the
// atomics from threads in any order) changes from run to run.

#include <stdint.h>

#include "common.cuh"

namespace {

using port::loadv;
using port::depth_taps;
using port::pixel_rows;
using port::PixelRows;
using port::Taps;

constexpr int THREADS = 256;

template <int VW>
__device__ __forceinline__ void mul(float w, const float* g, float* out) {
#pragma unroll
    for (int i = 0; i < VW; ++i) out[i] = __fmul_rn(w, g[i]);
}

template <int VW>
__device__ __forceinline__ void mul_add(float* acc, float w, const float* g) {
#pragma unroll
    for (int i = 0; i < VW; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(w, g[i]));
}

// one float4 atomic (VW 4) or one float atomic (VW 1) into dsrc, none for
// a sum that is 0
template <int VW>
__device__ __forceinline__ void add_group(float* p, const float* v) {
    if constexpr (VW == 4) {
        if (v[0] != 0.0f || v[1] != 0.0f || v[2] != 0.0f || v[3] != 0.0f)
            atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    } else {
        if (v[0] != 0.0f) atomicAdd(p, v[0]);
    }
}

// The taps of one (pixel, channel group) over a run of consecutive planes
// that share their four corners, summed in registers.
template <int VW>
struct Run {
    int xa, xb, ya, yb;
    float s00[VW], s10[VW], s01[VW], s11[VW];
};

template <int VW>
__device__ __forceinline__ void flush(const Run<VW>& r, float* img, int Ws, int C) {
    add_group<VW>(img + ((long long)r.ya * Ws + r.xa) * C, r.s00);
    add_group<VW>(img + ((long long)r.ya * Ws + r.xb) * C, r.s10);
    add_group<VW>(img + ((long long)r.yb * Ws + r.xa) * C, r.s01);
    add_group<VW>(img + ((long long)r.yb * Ws + r.xb) * C, r.s11);
}

template <typename T, int VW>
__global__ void __launch_bounds__(THREADS) warp_bwd_kernel(
    const T* __restrict__ g,        // [B, D, H, W, C]
    const float* __restrict__ rel,  // [B, 4, 4], rows 0..2 used
    const float* __restrict__ hypo, // [B, D, H, W]
    float* __restrict__ dsrc,       // [B, Hs, Ws, C], zeroed
    int D, int H, int W, int Hs, int Ws, int C) {
    // blockIdx.y = b; one thread per (y, x, VW-channel group) of the plane
    const int NG = C / VW;
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= H * W * NG) return;
    const int q = i % NG, p = i / NG;
    const int x = p % W, y = p / W;
    const int b = blockIdx.y;
    const PixelRows pr = pixel_rows(rel + 16 * b, x, y);
    const long long plane = (long long)H * W;
    const float* hyp = hypo + (long long)b * D * plane + p;
    const T* gp = g + ((long long)b * D * plane + p) * C + VW * q;
    float* img = dsrc + (long long)b * Hs * Ws * C + VW * q;

    Run<VW> r;
    bool open = false;
    for (int d = 0; d < D; ++d) {
        Taps tp;
        if (!depth_taps(pr, __ldg(hyp + d * plane), Hs, Ws, tp)) continue;
        float gv[VW];
        loadv<VW>(gp + d * plane * C, gv);
        if (open && tp.xa == r.xa && tp.xb == r.xb && tp.ya == r.ya && tp.yb == r.yb) {
            mul_add<VW>(r.s00, tp.w00, gv);
            mul_add<VW>(r.s10, tp.w10, gv);
            mul_add<VW>(r.s01, tp.w01, gv);
            mul_add<VW>(r.s11, tp.w11, gv);
            continue;
        }
        if (open) flush<VW>(r, img, Ws, C);
        r.xa = tp.xa; r.xb = tp.xb; r.ya = tp.ya; r.yb = tp.yb;
        mul<VW>(tp.w00, gv, r.s00);
        mul<VW>(tp.w10, gv, r.s10);
        mul<VW>(tp.w01, gv, r.s01);
        mul<VW>(tp.w11, gv, r.s11);
        open = true;
    }
    if (open) flush<VW>(r, img, Ws, C);
}

template <typename T, int VW>
int launch(const void* g, const void* rel, const void* hypo, void* dsrc, int B, int D, int H,
           int W, int Hs, int Ws, int C, cudaStream_t stream) {
    const dim3 grid((unsigned)((H * W * (C / VW) + THREADS - 1) / THREADS), (unsigned)B);
    warp_bwd_kernel<T, VW><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(g), static_cast<const float*>(rel),
        static_cast<const float*>(hypo), static_cast<float*>(dsrc), D, H, W, Hs, Ws, C);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_c(const void* g, const void* rel, const void* hypo, void* dsrc, int B, int D,
             int H, int W, int Hs, int Ws, int C, cudaStream_t s) {
    if (C % 4 == 0) return launch<T, 4>(g, rel, hypo, dsrc, B, D, H, W, Hs, Ws, C, s);
    return launch<T, 1>(g, rel, hypo, dsrc, B, D, H, W, Hs, Ws, C, s);
}

}  // namespace

// Adds into dsrc, which the caller zeroes and keeps 16-byte aligned; any
// C >= 1 (float4 atomics where C % 4 == 0, else scalar ones). The caller
// keeps D*H*W*C and Hs*Ws*C under 2^31 and B under 65536. Returns
// cudaGetLastError() after the launch.
extern "C" int warp_bwd_launch(const void* g, const void* rel, const void* hypo,
                               void* dsrc, int B, int D, int H, int W, int Hs, int Ws,
                               int C, int is_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return launch_c<__nv_bfloat16>(g, rel, hypo, dsrc, B, D, H, W, Hs, Ws, C, s);
    return launch_c<float>(g, rel, hypo, dsrc, B, D, H, W, Hs, Ws, C, s);
}
