// K3: backward of the plane-sweep bilinear warp, dL/dsrc for one source view.
//
// Replaces the TPU kernel
//   deep_reconstruction_with_epipolar_lines_mvster_tpu/ops/pallas/warp_xband_bwd.py:410
//   warp_tiles_pallas_xband_bwd_ik (inner kernel _kernel_v4_ik :332),
// the backward of ops/warp_mxu._warp_hybrid_ik, and computes for every
// (b, d, y, x) and each of the four bilinear corners inside the source image
//   dsrc[b, yc, xc, :] += w_corner * g[b, d, y, x, :]
// at the coordinates of core/geometry.warp_coords_xy (zeros padding), in
// float32. Coordinates are stop-gradient, as in the JAX package.
//
// The TPU kernel is a banded matmul with a sequential read-modify-write of
// an HBM accumulator because a TPU has neither a fast scatter nor atomics;
// none of that carries over. Here the natural form is a scatter-add:
//   - one thread per (b, d, y, x, c): the C threads of a pixel are
//     neighbours, so a warp's g loads coalesce and each of its atomics
//     lands on 32 consecutive floats of dsrc (a few 32-byte sectors), not
//     on 32 sectors as a thread per pixel walking its channels would
//     (measured 4x slower at the recipe's stage 4);
//   - coordinates and taps from common.cuh's plane_taps, the same device
//     code as K1, so forward and backward read and write the same corners
//     with the same weights, bit for bit with the plain version;
//   - the range test comes before any float -> int cast (in plane_taps),
//     so a NaN or huge coordinate gives four invalid taps;
//   - scalar float32 atomicAdd into dsrc, zeroed by the wrapper.
// The order of the float32 sum therefore changes from run to run.
//
// Bound on an H100: bytes. The function reads each (b, d, y, x)'s depth
// (4 B) and cotangent (2C B in bf16) once and writes dsrc once in float32
// (4 B per element); 6C FLOPs per pixel are far under the card's FLOP/byte
// line. At the DTU recipe's stage 4 (B6 D4 512x640 C8, bf16 g) that is
// ~220 MB per launch, 66 us at 3.35 TB/s. The atomic design adds a
// zeroing pass of dsrc (another 4 B per element, ~63 MB at stage 4), a
// cost of this design that the TPU kernel, which flushes its accumulator
// once, does not pay; it is not part of the bound. This first version
// issues 4C scalar atomics per pixel, which the L2 serves one sector at a
// time: it is bound by atomic throughput, not bytes. Vector
// red.global.add (sm_90) or shared-memory tile accumulation, which would
// also drop the zeroing pass, is the next step.

#include <stdint.h>

#include "common.cuh"

namespace {

using port::plane_taps;
using port::Taps;

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS) warp_bwd_kernel(
    const T* __restrict__ g,        // [B, D, H, W, C]
    const float* __restrict__ rel,  // [B, 4, 4], rows 0..2 used
    const float* __restrict__ hypo, // [B, D, H, W]
    float* __restrict__ dsrc,       // [B, Hs, Ws, C], zeroed
    int D, int H, int W, int Hs, int Ws, int C) {
    // blockIdx.y = b * D + d; 32-bit index within the (d, b) plane
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= H * W * C) return;
    const int c = i % C, p = i / C;
    const int x = p % W, y = p / W;
    const int b = blockIdx.y / D;
    const long long plane = (long long)blockIdx.y * H * W;

    Taps tp;
    if (!plane_taps(rel + 16 * b, x, y, __ldg(hypo + plane + p), Hs, Ws, tp)) return;
    const float gv = to_f32(g[plane * C + i]);
    float* img = dsrc + (long long)b * Hs * Ws * C + c;
    if (tp.w00 != 0.0f) atomicAdd(img + (tp.ya * Ws + tp.xa) * C, __fmul_rn(tp.w00, gv));
    if (tp.w10 != 0.0f) atomicAdd(img + (tp.ya * Ws + tp.xb) * C, __fmul_rn(tp.w10, gv));
    if (tp.w01 != 0.0f) atomicAdd(img + (tp.yb * Ws + tp.xa) * C, __fmul_rn(tp.w01, gv));
    if (tp.w11 != 0.0f) atomicAdd(img + (tp.yb * Ws + tp.xb) * C, __fmul_rn(tp.w11, gv));
}

template <typename T>
int launch(const void* g, const void* rel, const void* hypo, void* dsrc,
           int B, int D, int H, int W, int Hs, int Ws, int C, cudaStream_t stream) {
    const dim3 grid((unsigned)((H * W * C + THREADS - 1) / THREADS), (unsigned)(B * D));
    warp_bwd_kernel<T><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(g), static_cast<const float*>(rel),
        static_cast<const float*>(hypo), static_cast<float*>(dsrc),
        D, H, W, Hs, Ws, C);
    return (int)cudaGetLastError();
}

}  // namespace

// Adds into dsrc, which the caller zeroes; the caller keeps H*W*C and
// Hs*Ws*C under 2^31 and B*D under 65536. Returns cudaGetLastError() after
// the launch.
extern "C" int warp_bwd_launch(const void* g, const void* rel, const void* hypo,
                               void* dsrc, int B, int D, int H, int W, int Hs, int Ws,
                               int C, int is_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return launch<__nv_bfloat16>(g, rel, hypo, dsrc, B, D, H, W, Hs, Ws, C, s);
    return launch<float>(g, rel, hypo, dsrc, B, D, H, W, Hs, Ws, C, s);
}
