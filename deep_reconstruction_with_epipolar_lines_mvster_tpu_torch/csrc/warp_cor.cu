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
// here the natural form is a direct gather. Per (b, d, y, x):
//   1. coordinates and taps from common.cuh's pixel_rows and depth_taps,
//      shared with K3 and K4: the order of core/geometry.warp_coords_xy,
//      (m0*u + m1*v + m2)*d + m3, with the z == 0 -> 1e-9 guard; the _rn
//      intrinsics stop nvcc from contracting into FMAs, so the coordinates
//      are the plain PyTorch version's to the bit;
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
// FLOP/byte line. The least traffic is one read of each input and one
// write of the output: about 105 MB at the bench stage 4 (B4 D4 512x640
// C8 G4 bf16; the bf16 output alone is 42 MB), 31 us at 3.35 TB/s.
//
// The design (the second; the first took one thread per (b, d, y, x),
// rebuilt its coordinates from a flat index with three 64-bit divisions,
// and loaded the reference pixel once per plane):
//   - no flat-index division: the launch shape of K4 (common.cuh:
//     sweep_plan): grid.x the rows b*H + y, grid.y the x tiles, grid.z
//     chunks of planes, so that a launch of few pixels (stage 1, one view of
//     the B1 pipeline) still has two CTAs per SM;
//   - a thread is one 8-channel lane of a pixel (C/8 lanes, neighbours in a
//     warp); it loads its eight reference channels once into registers and
//     walks the pixel's D planes (common.cuh:sweep), the taps of each plane
//     computed by one lane and shared by __shfl_sync, the depths of up to
//     four planes loaded before any taps are computed; the taps carry the
//     corners as element offsets, and the four corner loads are issued
//     before any is widened (as K4);
//   - where a group has at most 8 channels (C/G <= 8, every stage of the
//     flagship: (64, 8), (32, 8), (16, 4), (8, 4)) a lane owns whole groups
//     and sums each in channel order, as the first design did, bit for
//     bit (the mean: a product with 1/(C/G), a power of two, so the
//     quotient to the bit); it stores its 8/(C/G) means as one 2- to
//     16-byte store (one or two for float32) where the output is aligned
//     for it, with the evict-first hint, as K4's. A group of more
//     than 8 channels spans C/G/8 lanes: each lane sums its 8 channels in
//     order, then the lanes' sums are added pairwise by __shfl_xor_sync
//     (lanes 0+1, 2+3, then (0+1)+(2+3), ...), an order the float32
//     tolerance covers, and the group's first lane stores the mean.
// What bounds it now: as K4, the instructions of the taps and the four-tap
// sum at stage 4 (C 8, one lane a pixel), and at stages 1-2 a few CTAs of
// long per-thread plane loops (a launch of 20,480 pixels); splitting the
// planes between more CTAs measured no faster (PERF.md).
//
// Any C and G (G dividing C): the stages' (C, G) of FPN base 8, C in {8,
// 16, 32, 64} and G in {1, 2, 4, 8}, have the instance above with both
// fixed at compile time; every other pair (any --fpn_base_channel, any
// --group_cor_dim) takes the generic instance, warp_cor_kernel_any: the
// same launch shape and sweep with one thread a pixel (the planes split
// between more CTAs), the first design's products in the same order, one
// running group sum stored as the group's last channel is added, and 8-,
// 4- or 1-wide loads (the widest that divides C).

#include <stdint.h>

#include "common.cuh"

namespace {

using port::corners;
using port::load8;
using port::loadv;
using port::pixel_rows;
using port::PixelRows;
using port::storev_cs;
using port::sweep;
using port::SweepPlan;
using port::Tap4;

constexpr int THREADS = 256;

// GL consecutive group means of one lane, evict-first: one vector store
// where `vec` (the output aligned for it), else GL scalar stores
template <int GL, typename T>
__device__ __forceinline__ void store_groups(T* p, const float* v, bool vec) {
    if (GL == 1 || !vec) {
#pragma unroll
        for (int g = 0; g < GL; ++g) storev_cs<1>(p + g, v + g);
    } else if constexpr (GL == 2) {
        if constexpr (std::is_same<T, float>::value) {
            __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
        } else {
            const __nv_bfloat162 h = __floats2bfloat162_rn(v[0], v[1]);
            __stcs(reinterpret_cast<unsigned*>(p), *reinterpret_cast<const unsigned*>(&h));
        }
    } else {
        storev_cs<GL>(p, v);
    }
}

template <typename T, int C, int G>
__global__ void __launch_bounds__(THREADS) warp_cor_kernel(
    const T* __restrict__ src,     // [B, Hs, Ws, C]
    const T* __restrict__ ref,     // [B, H, W, C]
    const float* __restrict__ rel, // [B, 4, 4], rows 0..2 used
    const float* __restrict__ hypo,// [B, D, H, W]
    T* __restrict__ out,           // [B, D, H, W, G]
    int B, int D, int H, int W, int Hs, int Ws, int dchunk, int vec) {
    constexpr int NL = C / 8, CPG = C / G;
    constexpr int GL = CPG <= 8 ? 8 / CPG : 1;      // groups a lane owns whole
    constexpr int RL = CPG > 8 ? CPG / 8 : 1;       // lanes a group spans
    // the mean: CPG is a power of two, so x * (1/CPG) is x / CPG to the bit
    constexpr float INV_CPG = 1.0f / CPG;
    const int lane = threadIdx.x & (NL - 1);
    const int xt = (int)((blockIdx.y * blockDim.x + threadIdx.x) / NL);
    const unsigned row = blockIdx.x * blockDim.y + threadIdx.y;    // b*H + y
    const bool active = xt < W && row < (unsigned)B * (unsigned)H;
    const int b = active ? (int)(row / (unsigned)H) : 0;
    const int y = active ? (int)row - b * H : 0;
    const int x = active ? xt : 0;

    const PixelRows pr = pixel_rows(rel + 16 * b, x, y);
    float rr[8];
    if (active) {
        load8(ref + ((long long)row * W + x) * C + 8 * lane, rr);
    } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) rr[i] = 0.0f;
    }
    const long long plane = (long long)H * W;
    const long long pix = ((long long)b * D * H + y) * W + x;      // (b, 0, y, x)
    const T* img = src + (long long)b * Hs * Ws * C + 8 * lane;
    const int dbeg = blockIdx.z * dchunk;
    const int dend = min(D, dbeg + dchunk);
    T* od = out + (pix + dbeg * plane) * G;     // plane dbeg's pixel
    sweep<NL>(pr, hypo + pix, plane, dbeg, dend, NL, lane, active, Hs, Ws, C,
              [&](int, const Tap4& t) {
        T* o = od;                  // the planes come in order: the next one's
        od += plane * G;
        float acc[GL];
#pragma unroll
        for (int g = 0; g < GL; ++g) acc[g] = 0.0f;
        if (t.o00 >= 0) {
            float a[8], bq[8], cq[8], dq[8];
            corners<8>(img, t, 0, a, bq, cq, dq);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                float s = __fmul_rn(a[i], t.w00);
                s = __fadd_rn(s, __fmul_rn(bq[i], t.w10));
                s = __fadd_rn(s, __fmul_rn(cq[i], t.w01));
                s = __fadd_rn(s, __fmul_rn(dq[i], t.w11));
                const int g = CPG <= 8 ? i / CPG : 0;
                acc[g] = __fadd_rn(acc[g], __fmul_rn(s, rr[i]));
            }
        }
        if constexpr (RL > 1) {
            // every lane of the warp runs the shuffles, inside the image or not
#pragma unroll
            for (int off = 1; off < RL; off <<= 1)
                acc[0] = __fadd_rn(acc[0], __shfl_xor_sync(0xffffffffu, acc[0], off));
        }
        if (!active) return;
        if constexpr (RL > 1) {
            if ((lane & (RL - 1)) == 0) {
                const float m = __fmul_rn(acc[0], INV_CPG);
                storev_cs<1>(o + lane / RL, &m);
            }
        } else {
            float m[GL];
#pragma unroll
            for (int g = 0; g < GL; ++g) m[g] = __fmul_rn(acc[g], INV_CPG);
            store_groups<GL>(o + lane * GL, m, vec != 0);
        }
    });
}

// The generic instance: C and G at run time, VW channels per load, one
// thread a pixel.
template <typename T, int VW>
__global__ void __launch_bounds__(THREADS) warp_cor_kernel_any(
    const T* __restrict__ src,     // [B, Hs, Ws, C]
    const T* __restrict__ ref,     // [B, H, W, C]
    const float* __restrict__ rel, // [B, 4, 4], rows 0..2 used
    const float* __restrict__ hypo,// [B, D, H, W]
    T* __restrict__ out,           // [B, D, H, W, G]
    int B, int D, int H, int W, int Hs, int Ws, int C, int G, int dchunk) {
    const int CPG = C / G;
    const int xt = (int)(blockIdx.y * blockDim.x + threadIdx.x);
    const unsigned row = blockIdx.x * blockDim.y + threadIdx.y;    // b*H + y
    const bool active = xt < W && row < (unsigned)B * (unsigned)H;
    const int b = active ? (int)(row / (unsigned)H) : 0;
    const int y = active ? (int)row - b * H : 0;
    const int x = active ? xt : 0;

    const PixelRows pr = pixel_rows(rel + 16 * b, x, y);
    const long long plane = (long long)H * W;
    const long long pix = ((long long)b * D * H + y) * W + x;      // (b, 0, y, x)
    const T* img = src + (long long)b * Hs * Ws * C;
    const T* r = ref + ((long long)row * W + x) * C;
    const int dbeg = blockIdx.z * dchunk;
    const int dend = min(D, dbeg + dchunk);
    T* on = out + (pix + dbeg * plane) * G;     // plane dbeg's pixel
    sweep<1>(pr, hypo + pix, plane, dbeg, dend, 1, 0, active, Hs, Ws, C,
             [&](int, const Tap4& t) {
        T* od = on;                 // the planes come in order: the next one's
        on += plane * G;
        if (!active) return;
        if (t.o00 < 0) {
            const float zero = 0.0f;
            for (int g = 0; g < G; ++g) storev_cs<1>(od + g, &zero);
            return;
        }
        const T* p00 = img + t.o00;
        const T* p10 = img + t.o10;
        const T* p01 = img + t.o01;
        const T* p11 = img + t.o11;
        float acc = 0.0f;
        int g = 0, k = 0;
#pragma unroll 1
        for (int c0 = 0; c0 < C; c0 += VW) {
            float a[VW], bq[VW], cq[VW], dq[VW], rv[VW];
            loadv<VW>(p00 + c0, a);
            loadv<VW>(p10 + c0, bq);
            loadv<VW>(p01 + c0, cq);
            loadv<VW>(p11 + c0, dq);
            loadv<VW>(r + c0, rv);
#pragma unroll
            for (int i = 0; i < VW; ++i) {
                float s = __fmul_rn(a[i], t.w00);
                s = __fadd_rn(s, __fmul_rn(bq[i], t.w10));
                s = __fadd_rn(s, __fmul_rn(cq[i], t.w01));
                s = __fadd_rn(s, __fmul_rn(dq[i], t.w11));
                acc = __fadd_rn(acc, __fmul_rn(s, rv[i]));
                if (++k == CPG) {
                    const float m = __fdiv_rn(acc, (float)CPG);
                    storev_cs<1>(od + g, &m);
                    ++g;
                    k = 0;
                    acc = 0.0f;
                }
            }
        }
    });
}

// the generic instance walks all C channels of a pixel in one thread: it
// splits the planes between CTAs until the launch has 8 CTAs an SM (the
// compile-time instances: 2)
constexpr int ANY_CTAS_PER_SM = 8;

bool is_fast(int C, int G) {
    return (C == 8 || C == 16 || C == 32 || C == 64) && (G == 1 || G == 2 || G == 4 || G == 8);
}

template <typename T, int C, int G>
void launch_kernel(const SweepPlan& p, const void* src, const void* ref, const void* rel,
                   const void* hypo, void* out, int B, int D, int H, int W, int Hs, int Ws,
                   int vec, cudaStream_t stream) {
    warp_cor_kernel<T, C, G><<<dim3(p.gx, p.gy, p.gz), dim3(p.tx, p.ty), 0, stream>>>(
        static_cast<const T*>(src), static_cast<const T*>(ref),
        static_cast<const float*>(rel), static_cast<const float*>(hypo),
        static_cast<T*>(out), B, D, H, W, Hs, Ws, p.dchunk, vec);
}

template <typename T, int C, int G>
int launch(const void* src, const void* ref, const void* rel, const void* hypo, void* out,
           int B, int D, int H, int W, int Hs, int Ws, cudaStream_t stream) {
    SweepPlan p;
    if (!port::sweep_plan(B, D, H, W, Hs, Ws, C, C / 8, 2, p))
        return (int)cudaErrorInvalidConfiguration;
    // a lane's GL means are one aligned store when the output is aligned to it
    constexpr int CPG = C / G, GL = CPG <= 8 ? 8 / CPG : 1;
    constexpr int align = GL * (int)sizeof(T) < 16 ? GL * (int)sizeof(T) : 16;
    const int vec = reinterpret_cast<uintptr_t>(out) % align == 0;
    launch_kernel<T, C, G>(p, src, ref, rel, hypo, out, B, D, H, W, Hs, Ws, vec, stream);
    return (int)cudaGetLastError();
}

template <typename T, int VW>
void launch_kernel_any(const SweepPlan& p, const void* src, const void* ref, const void* rel,
                       const void* hypo, void* out, int B, int D, int H, int W, int Hs, int Ws,
                       int C, int G, cudaStream_t stream) {
    warp_cor_kernel_any<T, VW><<<dim3(p.gx, p.gy, p.gz), dim3(p.tx, p.ty), 0, stream>>>(
        static_cast<const T*>(src), static_cast<const T*>(ref),
        static_cast<const float*>(rel), static_cast<const float*>(hypo),
        static_cast<T*>(out), B, D, H, W, Hs, Ws, C, G, p.dchunk);
}

template <typename T, int VW>
int launch_any(const void* src, const void* ref, const void* rel, const void* hypo, void* out,
               int B, int D, int H, int W, int Hs, int Ws, int C, int G,
               cudaStream_t stream) {
    SweepPlan p;
    if (!port::sweep_plan(B, D, H, W, Hs, Ws, C, 1, ANY_CTAS_PER_SM, p))
        return (int)cudaErrorInvalidConfiguration;
    launch_kernel_any<T, VW>(p, src, ref, rel, hypo, out, B, D, H, W, Hs, Ws, C, G, stream);
    return (int)cudaGetLastError();
}

#define WARP_COR_ARGS src, ref, rel, hypo, out, B, D, H, W, Hs, Ws, s

template <typename T, int C>
int launch_g(int G, const void* src, const void* ref, const void* rel, const void* hypo,
             void* out, int B, int D, int H, int W, int Hs, int Ws, cudaStream_t s) {
    switch (G) {
        case 1: return launch<T, C, 1>(WARP_COR_ARGS);
        case 2: return launch<T, C, 2>(WARP_COR_ARGS);
        case 4: return launch<T, C, 4>(WARP_COR_ARGS);
        default: return launch<T, C, 8>(WARP_COR_ARGS);
    }
}

template <typename T>
int launch_c(int C, int G, const void* src, const void* ref, const void* rel,
             const void* hypo, void* out, int B, int D, int H, int W, int Hs, int Ws,
             cudaStream_t s) {
    if (is_fast(C, G)) {
        switch (C) {
            case 8: return launch_g<T, 8>(G, WARP_COR_ARGS);
            case 16: return launch_g<T, 16>(G, WARP_COR_ARGS);
            case 32: return launch_g<T, 32>(G, WARP_COR_ARGS);
            default: return launch_g<T, 64>(G, WARP_COR_ARGS);
        }
    }
    if (C % 8 == 0)
        return launch_any<T, 8>(src, ref, rel, hypo, out, B, D, H, W, Hs, Ws, C, G, s);
    if (C % 4 == 0)
        return launch_any<T, 4>(src, ref, rel, hypo, out, B, D, H, W, Hs, Ws, C, G, s);
    return launch_any<T, 1>(src, ref, rel, hypo, out, B, D, H, W, Hs, Ws, C, G, s);
}

}  // namespace

// Any C and G with G dividing C: the (C, G) of FPN base 8 take their
// compile-time instance, any other the generic one. src and ref 16-byte
// aligned; B*H and Hs*Ws*C under 2^31. Returns cudaGetLastError() after
// the launch.
extern "C" int warp_cor_launch(const void* src, const void* ref, const void* rel,
                               const void* hypo, void* out, int B, int D, int H, int W,
                               int Hs, int Ws, int C, int G, int is_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return launch_c<__nv_bfloat16>(C, G, src, ref, rel, hypo, out, B, D, H, W, Hs, Ws, s);
    return launch_c<float>(C, G, src, ref, rel, hypo, out, B, D, H, W, Hs, Ws, s);
}

// The launch shape warp_cor_launch takes for a shape: plan[0..5] = fast
// instance (1) or generic (0), lanes a pixel, channels a lane's load, CTA
// threads along x, CTA rows, planes a CTA. Returns 0, or 1 when the shape
// exceeds the grid's limits.
extern "C" int warp_cor_plan(int B, int D, int H, int W, int Hs, int Ws, int C, int G,
                             int* plan) {
    const bool fast = is_fast(C, G);
    SweepPlan p;
    if (!port::sweep_plan(B, D, H, W, Hs, Ws, C, fast ? C / 8 : 1, fast ? 2 : ANY_CTAS_PER_SM,
                          p))
        return 1;
    plan[0] = fast;
    plan[1] = p.nl;
    plan[2] = fast ? 8 : C % 8 == 0 ? 8 : C % 4 == 0 ? 4 : 1;
    plan[3] = p.tx;
    plan[4] = p.ty;
    plan[5] = p.dchunk;
    return 0;
}
