// K2: one FPN top-down level,
//   u = up2_align_corners(intra) + Conv1x1(skip) + bi     (64 channels)
//   o = Conv3x3(u), zero padding, no bias                 (Co channels)
// with u also written out for the mid levels (its next level's input).
//
// Replaces the TPU kernel
//   deep_reconstruction_with_epipolar_lines_mvster_tpu/ops/pallas/topdown_fused.py:317
//   _run_kernel_v4 (inner kernel _kernel_v4 :202), reached through
//   topdown_fused_chain :698 -> _chain_impl :609.
// The TPU kernel works channels-in-sublanes with lane rolls for the 3x3 taps
// and hoists the W-resize into an XLA einsum; none of that carries over.
// Here the upsample, the 1x1 and the 3x3 all run inside one kernel, and
// the full-resolution 64-channel u never goes to device memory unless a
// mid level asks for it.
//
// Design: one CTA of 256 threads per (n, 8-row x 32-column output tile).
//   1. Build the (8+2) x (32+2) x 64 u tile in shared memory in float32
//      (channel-major planes, so that phase 2 reads are conflict-free):
//      align-corners bilinear taps of intra (row pass, then column pass,
//      as core/geometry.resize_align_corners), plus the 1x1 over the skip
//      pixel's Cs channels, plus the bias; rounded once to the working
//      dtype, as the TPU kernel and the unfused chain round it; zero
//      outside the image. The index and weight tables come from the host,
//      computed in float64.
//   2. Each thread computes all Co outputs of one pixel from shared
//      memory: 9 x 64 taps, weights broadcast from shared memory.
// Shared memory is 87 KB for the u tile plus 18-74 KB of weights, above
// the 48 KB default, so the launch raises the dynamic limit.
//
// Bound on an H100 at the bench shape (N16, L4 512x640, Cs=Co=8, bf16):
// 336 MB of input and output, 100 us at 3.35 TB/s; the 54 GFLOP would
// take 55 us on the bf16 tensor cores, so the level is bound by bytes.
// This first version runs its FLOPs in float32 on the CUDA cores
// (67 TFLOP/s: at least 0.8 ms at L4), so it is bound by operations, not
// by the bytes it moves; an implicit GEMM on the tensor cores is the next
// step.

#include <stdint.h>

#include "common.cuh"

namespace {

using port::load8;
using port::store1;

constexpr int CI = 64;   // top-down pathway width (8 x base 8)
constexpr int TR = 8;    // output rows per tile
constexpr int TC = 32;   // output columns per tile
constexpr int HR = TR + 2, HC = TC + 2, NP = HR * HC;
constexpr int THREADS = TR * TC;

__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

template <int CS, int CO>
constexpr size_t smem_bytes() {
    return sizeof(float) * (CI * NP + 9 * CI * CO + CS * CI + CI);
}

template <typename T, int CS, int CO>
__global__ void __launch_bounds__(THREADS) topdown_kernel(
    const T* __restrict__ intra,     // [N, Hh, Wh, 64]
    const T* __restrict__ skip,      // [N, H, W, CS]
    const float* __restrict__ wi,    // [CS, 64]
    const float* __restrict__ bi,    // [64]
    const float* __restrict__ wo,    // [3, 3, 64, CO]
    const int* __restrict__ hidx, const float* __restrict__ hw0,
    const float* __restrict__ hw1,   // [H] row taps
    const int* __restrict__ widx, const float* __restrict__ ww0,
    const float* __restrict__ ww1,   // [W] column taps
    T* __restrict__ out,             // [N, H, W, CO]
    T* __restrict__ uout,            // [N, H, W, 64] or null
    int H, int W, int Hh, int Wh) {
    extern __shared__ float smem[];
    float* us = smem;                // [64][HR][HC]
    float* ws = us + CI * NP;        // [9 * 64][CO]
    float* wis = ws + 9 * CI * CO;   // [CS][64]
    float* bis = wis + CS * CI;      // [64]

    const int n = blockIdx.z, r0 = blockIdx.y * TR, c0 = blockIdx.x * TC;
    const int tid = threadIdx.x;
    for (int i = tid; i < 9 * CI * CO; i += THREADS) ws[i] = wo[i];
    for (int i = tid; i < CS * CI; i += THREADS) wis[i] = wi[i];
    if (tid < CI) bis[tid] = bi[tid];
    __syncthreads();

    // phase 1: the u tile with a one-pixel halo
    for (int p = tid; p < NP; p += THREADS) {
        const int pr = p / HC, pc = p % HC;
        const int g = r0 - 1 + pr, gc = c0 - 1 + pc;
        if (g < 0 || g >= H || gc < 0 || gc >= W) {
#pragma unroll 8
            for (int ci = 0; ci < CI; ++ci) us[ci * NP + p] = 0.0f;
            continue;
        }
        float sk[CS];
        const T* sp = skip + (((long long)n * H + g) * W + gc) * CS;
#pragma unroll
        for (int c8 = 0; c8 < CS; c8 += 8) load8(sp + c8, sk + c8);
        const int h0 = hidx[g], v0 = widx[gc];
        const float a0 = hw0[g], a1 = hw1[g], b0 = ww0[gc], b1 = ww1[gc];
        const int h1 = min(h0 + 1, Hh - 1), v1 = min(v0 + 1, Wh - 1);
        const T* base = intra + (long long)n * Hh * Wh * CI;
        const T* q00 = base + ((long long)h0 * Wh + v0) * CI;
        const T* q01 = base + ((long long)h0 * Wh + v1) * CI;
        const T* q10 = base + ((long long)h1 * Wh + v0) * CI;
        const T* q11 = base + ((long long)h1 * Wh + v1) * CI;
        const bool center = pr >= 1 && pr <= TR && pc >= 1 && pc <= TC;
        T* up = uout ? uout + (((long long)n * H + g) * W + gc) * CI : nullptr;
#pragma unroll 1
        for (int c8 = 0; c8 < CI; c8 += 8) {
            float e00[8], e01[8], e10[8], e11[8];
            load8(q00 + c8, e00);
            load8(q01 + c8, e01);
            load8(q10 + c8, e10);
            load8(q11 + c8, e11);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int ci = c8 + i;
                const float left = __fadd_rn(__fmul_rn(a0, e00[i]), __fmul_rn(a1, e10[i]));
                const float right = __fadd_rn(__fmul_rn(a0, e01[i]), __fmul_rn(a1, e11[i]));
                const float upv = __fadd_rn(__fmul_rn(b0, left), __fmul_rn(b1, right));
                float s = 0.0f;
#pragma unroll
                for (int cs = 0; cs < CS; ++cs) s = fmaf(sk[cs], wis[cs * CI + ci], s);
                const float uv = round_to(__fadd_rn(upv, __fadd_rn(s, bis[ci])), intra);
                us[ci * NP + p] = uv;
                if (center && up) store1(up + ci, uv);
            }
        }
    }
    __syncthreads();

    // phase 2: the 3x3 conv, one output pixel per thread, all CO channels
    const int tr = tid / TC, tc = tid % TC;
    float acc[CO];
#pragma unroll
    for (int co = 0; co < CO; ++co) acc[co] = 0.0f;
#pragma unroll 1
    for (int ci = 0; ci < CI; ++ci) {
        const float* uc = us + ci * NP + tr * HC + tc;
#pragma unroll
        for (int k = 0; k < 9; ++k) {
            const float uv = uc[(k / 3) * HC + (k % 3)];
            const float4* w4 = reinterpret_cast<const float4*>(ws + (k * CI + ci) * CO);
#pragma unroll
            for (int q = 0; q < CO / 4; ++q) {
                const float4 w = w4[q];
                acc[4 * q] = fmaf(uv, w.x, acc[4 * q]);
                acc[4 * q + 1] = fmaf(uv, w.y, acc[4 * q + 1]);
                acc[4 * q + 2] = fmaf(uv, w.z, acc[4 * q + 2]);
                acc[4 * q + 3] = fmaf(uv, w.w, acc[4 * q + 3]);
            }
        }
    }
    const int orow = r0 + tr, ocol = c0 + tc;
    if (orow < H && ocol < W) {
        T* op = out + (((long long)n * H + orow) * W + ocol) * CO;
#pragma unroll
        for (int co = 0; co < CO; ++co) store1(op + co, acc[co]);
    }
}

template <typename T, int CS, int CO>
int launch(const void* intra, const void* skip, const void* wi, const void* bi,
           const void* wo, const void* hidx, const void* hw0, const void* hw1,
           const void* widx, const void* ww0, const void* ww1, void* out, void* uout,
           int N, int H, int W, int Hh, int Wh, cudaStream_t stream) {
    constexpr size_t bytes = smem_bytes<CS, CO>();
    cudaError_t e = cudaFuncSetAttribute(topdown_kernel<T, CS, CO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((W + TC - 1) / TC, (H + TR - 1) / TR, N);
    topdown_kernel<T, CS, CO><<<grid, THREADS, bytes, stream>>>(
        static_cast<const T*>(intra), static_cast<const T*>(skip),
        static_cast<const float*>(wi), static_cast<const float*>(bi),
        static_cast<const float*>(wo), static_cast<const int*>(hidx),
        static_cast<const float*>(hw0), static_cast<const float*>(hw1),
        static_cast<const int*>(widx), static_cast<const float*>(ww0),
        static_cast<const float*>(ww1), static_cast<T*>(out), static_cast<T*>(uout),
        H, W, Hh, Wh);
    return (int)cudaGetLastError();
}

#define TOPDOWN_ARGS intra, skip, wi, bi, wo, hidx, hw0, hw1, widx, ww0, ww1, out, uout, \
                     N, H, W, Hh, Wh, s

template <typename T, int CS>
int launch_co(int CO, const void* intra, const void* skip, const void* wi, const void* bi,
              const void* wo, const void* hidx, const void* hw0, const void* hw1,
              const void* widx, const void* ww0, const void* ww1, void* out, void* uout,
              int N, int H, int W, int Hh, int Wh, cudaStream_t s) {
    switch (CO) {
        case 8: return launch<T, CS, 8>(TOPDOWN_ARGS);
        case 16: return launch<T, CS, 16>(TOPDOWN_ARGS);
        case 32: return launch<T, CS, 32>(TOPDOWN_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <typename T>
int launch_cs(int CS, int CO, const void* intra, const void* skip, const void* wi,
              const void* bi, const void* wo, const void* hidx, const void* hw0,
              const void* hw1, const void* widx, const void* ww0, const void* ww1,
              void* out, void* uout, int N, int H, int W, int Hh, int Wh, cudaStream_t s) {
    switch (CS) {
        case 8: return launch_co<T, 8>(CO, TOPDOWN_ARGS);
        case 16: return launch_co<T, 16>(CO, TOPDOWN_ARGS);
        case 32: return launch_co<T, 32>(CO, TOPDOWN_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// (Cs, Co) pair without an instantiation). uout may be null.
extern "C" int topdown_launch(const void* intra, const void* skip, const void* wi,
                              const void* bi, const void* wo, const void* hidx,
                              const void* hw0, const void* hw1, const void* widx,
                              const void* ww0, const void* ww1, void* out, void* uout,
                              int N, int H, int W, int Hh, int Wh, int CS, int CO,
                              int is_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return launch_cs<__nv_bfloat16>(CS, CO, TOPDOWN_ARGS);
    return launch_cs<float>(CS, CO, TOPDOWN_ARGS);
}
