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
// sublane slices. None of that carries over. Here a lane owns one
// hypothesis d of PX neighbouring pixels: its G accumulators a pixel and
// its weight sum. The L = (D rounded up to a power of two, <= 32) lanes of
// a pixel group sit in one warp, d-major (lane = d * Q + q, Q = 32 / L
// pixel groups a warp), so that the Q lanes of one d read neighbouring
// pixels of one (s, b, d) slab. Per block of up to 4 source views a lane
// issues the loads of every view first (PX * G values a view, 16 bytes
// where the layout allows: PX = 2 pixels at G 4 bf16, 4 at G 2), then per
// view forms its group sum over attn_temp, receives the group's D scores
// by __shfl_sync, and forms the max and the exponential sum over d = 0 ..
// D-1 in that order, its own exponential, weight and sums: every float32
// operation on a (pixel, d) and its order as in the first design (one
// thread per pixel, D*G sums in registers: few warps resident at D8 G8,
// one thin wave at stage 1, 8-byte loads at G 4 bf16: 0.207 ms per eval
// forward against 0.078, H100 80GB HBM3, 700 W). G is a template (1, 2, 4,
// 8, 16; a G in between takes the next one up with its loads and sums cut
// to G), D a run-time value up to 32, and a template at the stages' 4 and 8
// (the D loops of shuffles unroll, saving issue slots: the kernel is bound
// by the instructions between its loads and stores). D over 32 or G over
// 16 goes to a second kernel of the same arithmetic in the same order, with
// D and G at run time: it keeps acc and norm in a float32 workspace that the caller
// allocates, one slot per thread and (d, g), and reads each view's D*G
// values three times (the max over D, the exponential sum, the weights), so
// the two agree bit for bit.
//
// Bound on an H100: bytes. The function reads the S volumes once and
// writes one; per element it does a few FLOPs and per pixel D exponentials,
// far under the card's FLOP/byte line. At the flagship's stage 4 (B4 D4
// 512x640 G4 bf16, three source views) that is 4 x 42 MB = 168 MB, 50 us
// at 3.35 TB/s. Against the plain PyTorch chain (about ten float32 passes
// per view over the volume), it keeps the weights, acc and norm out of
// device memory. This form takes 0.128 ms per eval forward against that
// 0.078 ms bound (H100 80GB HBM3, 700 W; tools/ab_eval_forward.py --path
// kernels), stage 4 at 1.6x. A build with the loads and stores alone ran
// far closer to the bound: the rest is the arithmetic's instructions (three
// IEEE divisions and an exponential a view per (pixel, d), G divisions at
// the end), which a thread issues between its loads and its stores.

#include <stdint.h>

#include "common.cuh"

namespace {

using port::pack_bf16;
using port::store1;

constexpr int THREADS = 128;               // the workspace kernel's CTA
constexpr int LANE_THREADS = 256;          // the register kernel's CTA: 8 warps
constexpr unsigned FULL = 0xffffffffu;

// VL consecutive values at p widened to float32: vector loads of 16, 8, 4
// or 2 bytes (p aligned to the smaller of 16 and their size)
template <typename T, int VL>
__device__ __forceinline__ void load_vals(const T* p, float* v) {
    constexpr int BYTES = VL * (int)sizeof(T);
    if constexpr (BYTES == 2) {
        v[0] = __uint_as_float((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
    } else {
        constexpr int WORDS = BYTES / 4;
        uint32_t u[WORDS];
        if constexpr (BYTES >= 16) {
#pragma unroll
            for (int i = 0; i < WORDS / 4; ++i) {
                const uint4 r = __ldg(reinterpret_cast<const uint4*>(p) + i);
                u[4 * i] = r.x; u[4 * i + 1] = r.y; u[4 * i + 2] = r.z; u[4 * i + 3] = r.w;
            }
        } else if constexpr (BYTES == 8) {
            const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
            u[0] = r.x; u[1] = r.y;
        } else {
            u[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
        }
#pragma unroll
        for (int i = 0; i < WORDS; ++i) {
            if constexpr (sizeof(T) == 4) {
                v[i] = __uint_as_float(u[i]);
            } else {                         // a bf16 is the high half of its float32
                v[2 * i] = __uint_as_float(u[i] << 16);
                v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
            }
        }
    }
}

// VL float32 values stored at p in T, each rounded once: vector stores as
// load_vals loads
template <typename T, int VL>
__device__ __forceinline__ void store_vals(T* p, const float* v) {
    constexpr int BYTES = VL * (int)sizeof(T);
    if constexpr (BYTES == 2) {
        store1(p, v[0]);
    } else {
        constexpr int WORDS = BYTES / 4;
        uint32_t u[WORDS];
#pragma unroll
        for (int i = 0; i < WORDS; ++i) {
            if constexpr (sizeof(T) == 4)
                u[i] = __float_as_uint(v[i]);
            else
                u[i] = pack_bf16(v[2 * i], v[2 * i + 1]);
        }
        if constexpr (BYTES >= 16) {
#pragma unroll
            for (int i = 0; i < WORDS / 4; ++i)
                reinterpret_cast<uint4*>(p)[i] =
                    make_uint4(u[4 * i], u[4 * i + 1], u[4 * i + 2], u[4 * i + 3]);
        } else if constexpr (BYTES == 8) {
            *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
        } else {
            *reinterpret_cast<unsigned int*>(p) = u[0];
        }
    }
}

// grid (pixel groups / (8 Q), B); lanes d-major in each warp (see above).
// EXACT: G == GM, the PX * G values of a view one vector; else PX = 1 and
// G < GM values, one scalar load each. DL: D at compile time where it is a
// power of two of the stages (4, 8; the D loops unroll), else 0 (D, log_q
// at run time).
template <typename T, int GM, int PX, bool EXACT, int DL>
__global__ void __launch_bounds__(LANE_THREADS) attn_fuse_kernel(
    const T* __restrict__ cors,   // [S, B, D, H, W, G]
    T* __restrict__ out,          // [B, D, H, W, G]
    int S, int D_rt, int HW, int G, int log_q_rt, float temp, float sqrt_c) {
    constexpr int VL = PX * GM;
    constexpr int SB = VL <= 8 ? 4 : 2;          // views loaded together
    const int D = DL ? DL : D_rt;
    const int log_q = DL == 4 ? 3 : DL == 8 ? 2 : log_q_rt;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int b = blockIdx.y;
    const int d = lane >> log_q, q = lane & ((1 << log_q) - 1);
    const long long p0 =
        (((long long)blockIdx.x * (LANE_THREADS / 32) + warp) * (1 << log_q) + q) * PX;
    const bool on = d < D && p0 < HW;
    const long long plane = (long long)HW * G;               // one (s, b, d) slab
    const long long view = (long long)gridDim.y * D * plane;  // one source view
    const long long at = ((long long)b * D + d) * plane + p0 * G;

    float acc[VL], norm[PX];
#pragma unroll
    for (int i = 0; i < VL; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int px = 0; px < PX; ++px) norm[px] = 1e-8f;

#pragma unroll 1
    for (int s0 = 0; s0 < S; s0 += SB) {
        float c[SB][VL];
#pragma unroll
        for (int sb = 0; sb < SB; ++sb) {
            const bool ld = on && s0 + sb < S;
            const T* src = cors + (s0 + sb) * view + at;
            if constexpr (EXACT) {
                if (ld) {
                    load_vals<T, VL>(src, c[sb]);
                } else {
#pragma unroll
                    for (int i = 0; i < VL; ++i) c[sb][i] = 0.0f;
                }
            } else {
#pragma unroll
                for (int g = 0; g < GM; ++g) c[sb][g] = ld && g < G ? port::ldg1(src + g) : 0.0f;
            }
        }
#pragma unroll
        for (int sb = 0; sb < SB; ++sb) {
            if (s0 + sb >= S) break;
            float z[PX], m[PX], e[PX], esum[PX];
#pragma unroll
            for (int px = 0; px < PX; ++px) {
                float t = c[sb][px * GM];
#pragma unroll
                for (int g = 1; g < GM; ++g)
                    if (EXACT || g < G) t = __fadd_rn(t, c[sb][px * GM + g]);
                z[px] = __fdiv_rn(t, temp);                  // sum_G / attn_temp
                m[px] = __shfl_sync(FULL, z[px], q);         // the score of d = 0
            }
#pragma unroll
            for (int dd = 1; dd < D; ++dd)
#pragma unroll
                for (int px = 0; px < PX; ++px)
                    m[px] = fmaxf(m[px], __shfl_sync(FULL, z[px], (dd << log_q) + q));
#pragma unroll
            for (int px = 0; px < PX; ++px) {
                e[px] = expf(__fsub_rn(z[px], m[px]));
                esum[px] = 0.0f;
            }
#pragma unroll
            for (int dd = 0; dd < D; ++dd)
#pragma unroll
                for (int px = 0; px < PX; ++px)
                    esum[px] = __fadd_rn(esum[px], __shfl_sync(FULL, e[px], (dd << log_q) + q));
#pragma unroll
            for (int px = 0; px < PX; ++px) {
                const float w = __fdiv_rn(__fdiv_rn(e[px], esum[px]), sqrt_c);
                norm[px] = __fadd_rn(norm[px], w);
#pragma unroll
                for (int g = 0; g < GM; ++g)
                    acc[px * GM + g] =
                        __fadd_rn(acc[px * GM + g], __fmul_rn(w, c[sb][px * GM + g]));
            }
        }
    }
    if (!on) return;
    float r[VL];
#pragma unroll
    for (int px = 0; px < PX; ++px)
#pragma unroll
        for (int g = 0; g < GM; ++g) r[px * GM + g] = __fdiv_rn(acc[px * GM + g], norm[px]);
    if constexpr (EXACT) {
        store_vals<T, VL>(out + at, r);
    } else {
#pragma unroll
        for (int g = 0; g < GM; ++g)
            if (g < G) store1(out + at + g, r[g]);
    }
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

// How a call runs (attn_fuse_plan): on the register kernel where D <= 32
// and G <= 16, else on the workspace kernel. The register kernel's
// instance: GM = G rounded up to a power of two; PX pixels a lane where G
// == GM, the G values of a pixel fill less than 16 bytes and H*W is a
// multiple of PX (so that every slab starts 16-byte aligned), else 1; L = D
// rounded up to a power of two lanes a pixel group (log_l), Q = 32 / L
// groups a warp; its grid (ctas_x, B).
struct Plan {
    bool in_registers;
    int gm, px, log_l;
    long long ctas_x;
};

Plan plan_of(int D, int HW, int G, int esize) {
    Plan p{};
    p.in_registers = D <= 32 && G <= 16;
    if (!p.in_registers) return p;
    p.gm = 1;
    while (p.gm < G) p.gm *= 2;
    const int pxw = p.gm * esize < 16 ? 16 / (p.gm * esize) : 1;
    p.px = p.gm == G && HW % pxw == 0 ? pxw : 1;
    while ((1 << p.log_l) < D) ++p.log_l;
    const long long groups = (HW + p.px - 1) / p.px;
    const long long per_cta = (long long)(LANE_THREADS / 32) << (5 - p.log_l);
    p.ctas_x = (groups + per_cta - 1) / per_cta;
    return p;
}

template <typename T, int GM, int PX, bool EXACT>
int launch(const void* cors, void* out, int S, int B, int D, int HW, int G, float temp,
           float sqrt_c, const Plan& p, cudaStream_t stream) {
    const int log_q = 5 - p.log_l;
    const dim3 grid((unsigned)p.ctas_x, (unsigned)B);
    const T* c = static_cast<const T*>(cors);
    T* o = static_cast<T*>(out);
    if (D == 4)
        attn_fuse_kernel<T, GM, PX, EXACT, 4><<<grid, LANE_THREADS, 0, stream>>>(
            c, o, S, D, HW, G, log_q, temp, sqrt_c);
    else if (D == 8)
        attn_fuse_kernel<T, GM, PX, EXACT, 8><<<grid, LANE_THREADS, 0, stream>>>(
            c, o, S, D, HW, G, log_q, temp, sqrt_c);
    else
        attn_fuse_kernel<T, GM, PX, EXACT, 0><<<grid, LANE_THREADS, 0, stream>>>(
            c, o, S, D, HW, G, log_q, temp, sqrt_c);
    return (int)cudaGetLastError();
}

// the instance of plan p at G instance GM (its PX where the plan takes
// more than one pixel a lane)
template <typename T, int GM>
int launch_g(const void* cors, void* out, int S, int B, int D, int HW, int G, float temp,
             float sqrt_c, const Plan& p, cudaStream_t s) {
    constexpr int PXW = GM * (int)sizeof(T) < 16 ? 16 / (GM * (int)sizeof(T)) : 1;
    if (G != GM) {
        if constexpr (GM > 2)
            return launch<T, GM, 1, false>(cors, out, S, B, D, HW, G, temp, sqrt_c, p, s);
        return (int)cudaErrorInvalidValue;
    }
    if constexpr (PXW > 1)
        if (p.px == PXW)
            return launch<T, GM, PXW, true>(cors, out, S, B, D, HW, G, temp, sqrt_c, p, s);
    return launch<T, GM, 1, true>(cors, out, S, B, D, HW, G, temp, sqrt_c, p, s);
}

template <typename T>
int launch_reg(const void* cors, void* out, int S, int B, int D, int HW, int G, float temp,
               float sqrt_c, const Plan& p, cudaStream_t s) {
    switch (p.gm) {
        case 1: return launch_g<T, 1>(cors, out, S, B, D, HW, G, temp, sqrt_c, p, s);
        case 2: return launch_g<T, 2>(cors, out, S, B, D, HW, G, temp, sqrt_c, p, s);
        case 4: return launch_g<T, 4>(cors, out, S, B, D, HW, G, temp, sqrt_c, p, s);
        case 8: return launch_g<T, 8>(cors, out, S, B, D, HW, G, temp, sqrt_c, p, s);
        default: return launch_g<T, 16>(cors, out, S, B, D, HW, G, temp, sqrt_c, p, s);
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

}  // namespace

// cors [S, B, D, H, W, G] -> out [B, D, H, W, G], both in one dtype; the
// caller keeps B*H*W*D*G*S under 2^63 and H*W under 2^31. `temp` is
// attn_temp and `sqrt_c` sqrt(C), both rounded to float32 as the plain
// version's scalar operands are. A call the workspace kernel takes
// (attn_fuse_plan) needs `acc` (B*D*H*W*G floats) and `norm` (B*D*H*W
// floats); for the others they may be null, and B stays under 65536.
// Returns cudaGetLastError() after the launch, cudaErrorInvalidValue when a
// needed workspace is missing.
extern "C" int attn_fuse_launch(const void* cors, void* out, float* acc, float* norm, int S,
                                int B, int D, int HW, int G, float temp, float sqrt_c,
                                int is_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Plan p = plan_of(D, HW, G, is_bf16 ? 2 : 4);
    if (!p.in_registers) {
        if (acc == nullptr || norm == nullptr) return (int)cudaErrorInvalidValue;
        if (is_bf16)
            return launch_any<__nv_bfloat16>(cors, out, acc, norm, S, B, D, HW, G, temp,
                                             sqrt_c, s);
        return launch_any<float>(cors, out, acc, norm, S, B, D, HW, G, temp, sqrt_c, s);
    }
    if (B > 65535) return (int)cudaErrorInvalidValue;
    if (is_bf16)
        return launch_reg<__nv_bfloat16>(cors, out, S, B, D, HW, G, temp, sqrt_c, p, s);
    return launch_reg<float>(cors, out, S, B, D, HW, G, temp, sqrt_c, p, s);
}

// The launch attn_fuse_launch takes for a shape: plan[0..4] = 1 on the
// register kernel (0: the workspace kernel, and the rest 0), G instance
// (GM), pixels a lane, lanes a pixel group, CTAs (ctas_x * B).
extern "C" int attn_fuse_plan(int B, int D, int HW, int G, int is_bf16, long long* plan) {
    const Plan p = plan_of(D, HW, G, is_bf16 ? 2 : 4);
    plan[0] = p.in_registers;
    plan[1] = p.gm;
    plan[2] = p.px;
    plan[3] = p.in_registers ? 1 << p.log_l : 0;
    plan[4] = p.ctas_x * B;
    return 0;
}
