// K5: the cross-view attention accumulation of the eval forward.
//
// Replaces the TPU kernel
//   deep_reconstruction_with_epipolar_lines_mvster_tpu/ops/pallas/attn_fuse.py:98
//   attn_fuse_native (_kernel :51, pallas_call :112),
// and computes, for every pixel (b, y, x) over the S = V-1 source views'
// group-correlation volumes cors[s, b, :, y, x, :] ([D, G] each),
//   w[s, d]  = softmax_D(sum_G cors[s, b, d, y, x, :] / attn_temp) / sqrt(C)
//   out[b, d, y, x, g] = sum_s w[s, d] * cors[s, b, d, y, x, g]
//                        / (1e-8 + sum_s w[s, d])
// in float32, stored in the working dtype: the reference accumulation
// (models/mvs4net_utils.py:1078-1100) with its 1e-8 seed of the weight sum.
//
// The TPU kernel holds all D hypothesis slabs of a row tile in VMEM and
// rides the G sums on tiny 0/1 matmuls because Mosaic refuses strided
// sublane slices. None of that carries over: here the natural form is one
// thread per (b, y, x) holding the pixel's D*G (<= 64) accumulators and D
// weight sums in registers. Per source view it loads the pixel's D*G
// values (G contiguous values per hypothesis, one vector load each),
// forms the D group sums, the softmax over D and the weighted sums, and
// after the last view it writes acc / norm once. That form is instantiated
// for D in {2, 4, 8} and G in {1, 2, 4, 8}, the (D, G) of the model's
// stages. Any other (D, G) (an --ndepths of 16 or 32, say) goes to a second
// kernel of the same arithmetic in the same order, with D and G at run
// time: it keeps acc and norm in a float32 workspace that the caller
// allocates, one slot per thread and (d, g), and reads each view's D*G
// values three times (the max over D, the exponential sum, the weights), so
// the two agree bit for bit.
//
// Bound on an H100: bytes. The function reads the S volumes once and
// writes one; per element it does a few FLOPs and per pixel D exponentials,
// far under the card's FLOP/byte line. Threads along x read neighbouring
// G-vectors, so each warp's loads and stores coalesce. At the flagship's
// stage 4 (B4 D4 512x640 G4 bf16, three source views) that is 4 x 42 MB =
// 168 MB, 50 us at 3.35 TB/s. Against the plain PyTorch chain (about ten
// float32 passes per view over the volume), it keeps the weights, acc and
// norm out of device memory.

#include <stdint.h>

#include "common.cuh"

namespace {

using port::store1;

constexpr int THREADS = 128;

// G consecutive values of one (s, b, d, y, x) widened to float32, as one
// or two vector loads where the G values fill them.
template <int G>
__device__ __forceinline__ void load_group(const float* p, float v[G]) {
    if constexpr (G % 4 == 0) {
#pragma unroll
        for (int i = 0; i < G / 4; ++i) {
            const float4 a = __ldg(reinterpret_cast<const float4*>(p) + i);
            v[4 * i] = a.x; v[4 * i + 1] = a.y; v[4 * i + 2] = a.z; v[4 * i + 3] = a.w;
        }
    } else if constexpr (G == 2) {
        const float2 a = __ldg(reinterpret_cast<const float2*>(p));
        v[0] = a.x; v[1] = a.y;
    } else {
        v[0] = __ldg(p);
    }
}

template <int G>
__device__ __forceinline__ void load_group(const __nv_bfloat16* p, float v[G]) {
    if constexpr (G == 8) {
        const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            v[2 * i] = f.x; v[2 * i + 1] = f.y;
        }
    } else if constexpr (G == 4) {
        const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            v[2 * i] = f.x; v[2 * i + 1] = f.y;
        }
    } else if constexpr (G == 2) {
        const float2 f = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
        v[0] = f.x; v[1] = f.y;
    } else {
        v[0] = __bfloat162float(p[0]);
    }
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(THREADS) attn_fuse_kernel(
    const T* __restrict__ cors,   // [S, B, D, H, W, G]
    T* __restrict__ out,          // [B, D, H, W, G]
    int S, int B, int HW, float temp, float sqrt_c) {
    const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;  // (b, y, x)
    if (idx >= (long long)B * HW) return;
    const int b = (int)(idx / HW);
    const int p = (int)(idx % HW);
    const long long plane = (long long)HW * G;           // one (s, b, d) slab
    const long long view = (long long)B * D * plane;     // one source view

    float acc[D][G], norm[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
        norm[d] = 1e-8f;
#pragma unroll
        for (int g = 0; g < G; ++g) acc[d][g] = 0.0f;
    }
    const T* base = cors + (long long)b * D * plane + (long long)p * G;
    for (int s = 0; s < S; ++s) {
        float c[D][G], z[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
            load_group<G>(base + s * view + d * plane, c[d]);
            float t = c[d][0];
#pragma unroll
            for (int g = 1; g < G; ++g) t = __fadd_rn(t, c[d][g]);
            z[d] = __fdiv_rn(t, temp);                   // sum_G / attn_temp
        }
        float m = z[0];
#pragma unroll
        for (int d = 1; d < D; ++d) m = fmaxf(m, z[d]);
        float esum = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
            z[d] = expf(__fsub_rn(z[d], m));
            esum = __fadd_rn(esum, z[d]);
        }
#pragma unroll
        for (int d = 0; d < D; ++d) {
            const float w = __fdiv_rn(__fdiv_rn(z[d], esum), sqrt_c);
            norm[d] = __fadd_rn(norm[d], w);
#pragma unroll
            for (int g = 0; g < G; ++g) acc[d][g] = __fadd_rn(acc[d][g], __fmul_rn(w, c[d][g]));
        }
    }
    T* o = out + (long long)b * D * plane + (long long)p * G;
#pragma unroll
    for (int d = 0; d < D; ++d)
#pragma unroll
        for (int g = 0; g < G; ++g) store1(o + d * plane + g, __fdiv_rn(acc[d][g], norm[d]));
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// sum_G of the G values at p, over attn_temp: the register kernel's z[d]
template <typename T>
__device__ __forceinline__ float group_score(const T* p, int G, float temp) {
    float t = load1(p);
    for (int g = 1; g < G; ++g) t = __fadd_rn(t, load1(p + g));
    return __fdiv_rn(t, temp);
}

// Any D and G: acc [B, D, H*W, G] and norm [B, D, H*W] float32 in device
// memory, each slot owned by one thread, so nothing needs zeroing first.
template <typename T>
__global__ void __launch_bounds__(THREADS) attn_fuse_kernel_any(
    const T* __restrict__ cors, T* __restrict__ out, float* __restrict__ acc,
    float* __restrict__ norm, int S, int B, int D, int HW, int G, float temp, float sqrt_c) {
    const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;  // (b, y, x)
    if (idx >= (long long)B * HW) return;
    const int b = (int)(idx / HW);
    const int p = (int)(idx % HW);
    const long long plane = (long long)HW * G;
    const long long view = (long long)B * D * plane;
    const long long at = (long long)b * D * plane + (long long)p * G;   // (b, d = 0, p, g = 0)
    const long long nat = (long long)b * D * HW + p;                    // (b, d = 0, p)

    for (int d = 0; d < D; ++d) {
        norm[nat + d * (long long)HW] = 1e-8f;
        for (int g = 0; g < G; ++g) acc[at + d * plane + g] = 0.0f;
    }
    for (int s = 0; s < S; ++s) {
        const T* c = cors + s * view + at;
        float m = group_score(c, G, temp);
        for (int d = 1; d < D; ++d) m = fmaxf(m, group_score(c + d * plane, G, temp));
        float esum = 0.0f;
        for (int d = 0; d < D; ++d)
            esum = __fadd_rn(esum, expf(__fsub_rn(group_score(c + d * plane, G, temp), m)));
        for (int d = 0; d < D; ++d) {
            const T* cd = c + d * plane;
            const float e = expf(__fsub_rn(group_score(cd, G, temp), m));
            const float w = __fdiv_rn(__fdiv_rn(e, esum), sqrt_c);
            float* n = norm + nat + d * (long long)HW;
            *n = __fadd_rn(*n, w);
            float* a = acc + at + d * plane;
            for (int g = 0; g < G; ++g) a[g] = __fadd_rn(a[g], __fmul_rn(w, load1(cd + g)));
        }
    }
    for (int d = 0; d < D; ++d) {
        const float n = norm[nat + d * (long long)HW];
        for (int g = 0; g < G; ++g)
            store1(out + at + d * plane + g, __fdiv_rn(acc[at + d * plane + g], n));
    }
}

template <typename T, int D, int G>
int launch(const void* cors, void* out, int S, int B, int HW, float temp, float sqrt_c,
           cudaStream_t stream) {
    const long long total = (long long)B * HW;
    const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
    attn_fuse_kernel<T, D, G><<<blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(cors), static_cast<T*>(out), S, B, HW, temp, sqrt_c);
    return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_g(int G, const void* cors, void* out, int S, int B, int HW, float temp,
             float sqrt_c, cudaStream_t s) {
    switch (G) {
        case 1: return launch<T, D, 1>(cors, out, S, B, HW, temp, sqrt_c, s);
        case 2: return launch<T, D, 2>(cors, out, S, B, HW, temp, sqrt_c, s);
        case 4: return launch<T, D, 4>(cors, out, S, B, HW, temp, sqrt_c, s);
        case 8: return launch<T, D, 8>(cors, out, S, B, HW, temp, sqrt_c, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <typename T>
int launch_d(int D, int G, const void* cors, void* out, int S, int B, int HW, float temp,
             float sqrt_c, cudaStream_t s) {
    switch (D) {
        case 2: return launch_g<T, 2>(G, cors, out, S, B, HW, temp, sqrt_c, s);
        case 4: return launch_g<T, 4>(G, cors, out, S, B, HW, temp, sqrt_c, s);
        case 8: return launch_g<T, 8>(G, cors, out, S, B, HW, temp, sqrt_c, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <typename T>
int launch_any(const void* cors, void* out, float* acc, float* norm, int S, int B, int D,
               int HW, int G, float temp, float sqrt_c, cudaStream_t stream) {
    const long long total = (long long)B * HW;
    const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
    attn_fuse_kernel_any<T><<<blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(cors), static_cast<T*>(out), acc, norm, S, B, D, HW, G, temp,
        sqrt_c);
    return (int)cudaGetLastError();
}

bool in_registers(int D, int G) {
    return (D == 2 || D == 4 || D == 8) && (G == 1 || G == 2 || G == 4 || G == 8);
}

}  // namespace

// cors [S, B, D, H, W, G] -> out [B, D, H, W, G], both in one dtype; the
// caller keeps B*H*W*D*G*S under 2^63 and H*W under 2^31. `temp` is
// attn_temp and `sqrt_c` sqrt(C), both rounded to float32 as the plain
// version's scalar operands are. A (D, G) outside the register kernel's
// instantiations takes the workspace kernel, with `acc` (B*D*H*W*G floats)
// and `norm` (B*D*H*W floats); for the others they may be null. Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue when a needed
// workspace is missing.
extern "C" int attn_fuse_launch(const void* cors, void* out, float* acc, float* norm, int S,
                                int B, int D, int HW, int G, float temp, float sqrt_c,
                                int is_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (!in_registers(D, G)) {
        if (acc == nullptr || norm == nullptr) return (int)cudaErrorInvalidValue;
        if (is_bf16)
            return launch_any<__nv_bfloat16>(cors, out, acc, norm, S, B, D, HW, G, temp,
                                             sqrt_c, s);
        return launch_any<float>(cors, out, acc, norm, S, B, D, HW, G, temp, sqrt_c, s);
    }
    if (is_bf16)
        return launch_d<__nv_bfloat16>(D, G, cors, out, S, B, HW, temp, sqrt_c, s);
    return launch_d<float>(D, G, cors, out, S, B, HW, temp, sqrt_c, s);
}
