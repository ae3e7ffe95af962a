// Device helpers shared by the port's kernels: eight channels of an NHWC
// pixel as one 16-byte load (bf16) or two (float32), widened to float32,
// and the 8-, 4- and 1-wide loads and stores of the generic instances (any
// channel count), one float32 value stored in the tensor's dtype, the PTX
// of the staged routes (cp.async, ldmatrix, mma.sync), and the plane-sweep
// bilinear taps (a per-pixel part, a per-depth part and the depth sweep
// that shares them between the lanes of a pixel) that the warp kernels (K1
// and K4 forward, K3 backward) all use, so that they agree with each other
// and with the plain PyTorch version to the bit.
#pragma once

#include <stdint.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <algorithm>
#include <type_traits>

namespace port {

__device__ __forceinline__ void load8(const float* p, float v[8]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
    }
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float ldg1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg1(const __nv_bfloat16* p) {
    const unsigned short r = __ldg(reinterpret_cast<const unsigned short*>(p));
    return __bfloat162float(__ushort_as_bfloat16(r));
}

// VW (8, 4 or 1) consecutive channels widened to float32: one or two 16-byte
// loads, one 16- or 8-byte load, or a scalar load. The generic instances of
// the kernels take VW = 8 where C % 8 == 0, 4 where C % 4 == 0, else 1, so
// that every vector load stays aligned.
template <int VW, typename T>
__device__ __forceinline__ void loadv(const T* p, float* v) {
    if constexpr (VW == 8) {
        load8(p, v);
    } else if constexpr (VW == 4) {
        if constexpr (std::is_same<T, float>::value) {
            const float4 a = __ldg(reinterpret_cast<const float4*>(p));
            v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        } else {
            const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
            const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
            const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
            v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
        }
    } else {
#pragma unroll
        for (int i = 0; i < VW; ++i) v[i] = ldg1(p + i);
    }
}

// VW channels as loaded (ldraw), widened to float32 later (widen): a
// caller that loads several pixels issues all their loads before it widens
// any, so that they are in flight together (loadv lets nvcc interleave
// each load with the arithmetic on the previous one)
template <int VW, typename T>
struct Raw {
    float v[VW];               // VW 1: loaded and widened at once
};
template <>
struct Raw<8, __nv_bfloat16> {
    uint4 u;
};
template <>
struct Raw<8, float> {
    float4 a, b;
};
template <>
struct Raw<4, __nv_bfloat16> {
    uint2 u;
};
template <>
struct Raw<4, float> {
    float4 a;
};

template <int VW, typename T>
__device__ __forceinline__ Raw<VW, T> ldraw(const T* p) {
    Raw<VW, T> r;
    if constexpr (VW == 8 && std::is_same<T, float>::value) {
        r.a = __ldg(reinterpret_cast<const float4*>(p));
        r.b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    } else if constexpr (VW == 8) {
        r.u = __ldg(reinterpret_cast<const uint4*>(p));
    } else if constexpr (VW == 4 && std::is_same<T, float>::value) {
        r.a = __ldg(reinterpret_cast<const float4*>(p));
    } else if constexpr (VW == 4) {
        r.u = __ldg(reinterpret_cast<const uint2*>(p));
    } else {
#pragma unroll
        for (int i = 0; i < VW; ++i) r.v[i] = ldg1(p + i);
    }
    return r;
}

template <int VW, typename T>
__device__ __forceinline__ void widen(const Raw<VW, T>& r, float* v) {
    if constexpr (VW == 8 && std::is_same<T, float>::value) {
        v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
        v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
    } else if constexpr (VW == 4 && std::is_same<T, float>::value) {
        v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
    } else if constexpr (VW == 8 || VW == 4) {
        // a bf16 is the high half of its float32: one shift or one mask a
        // value (__bfloat1622float2 spends two on the high one)
        const uint32_t* h = reinterpret_cast<const uint32_t*>(&r.u);
#pragma unroll
        for (int i = 0; i < VW / 2; ++i) {
            v[2 * i] = __uint_as_float(h[i] << 16);
            v[2 * i + 1] = __uint_as_float(h[i] & 0xffff0000u);
        }
    } else {
#pragma unroll
        for (int i = 0; i < VW; ++i) v[i] = r.v[i];
    }
}

// VW consecutive float32 values stored in the tensor's dtype, each rounded
// once; vector stores for VW 8 and 4 (the caller keeps them aligned)
template <int VW, typename T>
__device__ __forceinline__ void storev(T* p, const float* v) {
    if constexpr (VW == 1) {
        store1(p, v[0]);
    } else if constexpr (std::is_same<T, float>::value) {
#pragma unroll
        for (int q = 0; q < VW / 4; ++q)
            reinterpret_cast<float4*>(p)[q] =
                make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    } else if constexpr (VW == 8) {
        uint4 r;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
        for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        *reinterpret_cast<uint4*>(p) = r;
    } else {
        uint2 r;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
        h[0] = __floats2bfloat162_rn(v[0], v[1]);
        h[1] = __floats2bfloat162_rn(v[2], v[3]);
        *reinterpret_cast<uint2*>(p) = r;
    }
}

// The plane-sweep coordinates of reference pixel (x, y) at depth `dep`
// through rows 0..2 of the relative projection `m`, in the order of
// core/geometry.warp_coords_xy: (m0*u + m1*v + m2)*d + m3 per row, without
// contraction into FMAs. The d-independent part m0*u + m1*v + m2 of the
// three rows is computed once per pixel (pixel_rows), the rest once per
// depth (depth_taps); the split changes no operation, so the coordinates
// are the plain version's to the bit.
struct PixelRows {
    float s[3];    // m0*u + m1*v + m2 of rows 0..2
    float t[3];    // m3 of rows 0..2
};

__device__ __forceinline__ PixelRows pixel_rows(const float* m, int x, int y) {
    const float u = (float)x, v = (float)y;
    PixelRows r;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const float* mi = m + 4 * i;
        r.s[i] = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(mi), u), __fmul_rn(__ldg(mi + 1), v)),
                           __ldg(mi + 2));
        r.t[i] = __ldg(mi + 3);
    }
    return r;
}

// The four bilinear taps of source image (Hs, Ws) that a pixel with rows
// `r` reads at depth `dep` (core/geometry.warp_coords_xy, then
// grid_sample_2d): clamped pixel indices and weights, a weight 0 for a
// corner outside the image.
// A coordinate outside (-2, Ws+1) x (-2, Hs+1), NaN included, gives four
// zero weights: it is tested before any float -> int cast (undefined in
// CUDA for NaN and huge values), as the plain version clamps before its.
// Returns false when all four taps are invalid for that reason.
struct Taps {
    int xa, xb, ya, yb;            // clamped columns / rows of the corners
    float w00, w10, w01, w11;      // (xa,ya) (xb,ya) (xa,yb) (xb,yb)
};


__device__ __forceinline__ bool depth_taps(const PixelRows& r, float dep, int Hs, int Ws,
                                           Taps& t) {
    const float xn = __fadd_rn(__fmul_rn(r.s[0], dep), r.t[0]);
    const float yn = __fadd_rn(__fmul_rn(r.s[1], dep), r.t[1]);
    float z = __fadd_rn(__fmul_rn(r.s[2], dep), r.t[2]);
    if (z == 0.0f) z = 1e-9f;
    const float px = __fdiv_rn(xn, z);
    const float py = __fdiv_rn(yn, z);
    if (!(px > -2.0f && px < (float)Ws + 1.0f && py > -2.0f && py < (float)Hs + 1.0f))
        return false;
    const float fx0 = floorf(px), fy0 = floorf(py);
    const int x0 = (int)fx0, y0 = (int)fy0;
    const float lx = __fsub_rn(px, fx0), ly = __fsub_rn(py, fy0);
    const float mx = __fsub_rn(1.0f, lx), my = __fsub_rn(1.0f, ly);
    const bool vx0 = x0 >= 0 && x0 <= Ws - 1, vx1 = x0 + 1 >= 0 && x0 + 1 <= Ws - 1;
    const bool vy0 = y0 >= 0 && y0 <= Hs - 1, vy1 = y0 + 1 >= 0 && y0 + 1 <= Hs - 1;
    t.w00 = (vx0 && vy0) ? __fmul_rn(mx, my) : 0.0f;
    t.w10 = (vx1 && vy0) ? __fmul_rn(lx, my) : 0.0f;
    t.w01 = (vx0 && vy1) ? __fmul_rn(mx, ly) : 0.0f;
    t.w11 = (vx1 && vy1) ? __fmul_rn(lx, ly) : 0.0f;
    t.xa = min(max(x0, 0), Ws - 1);
    t.xb = min(max(x0 + 1, 0), Ws - 1);
    t.ya = min(max(y0, 0), Hs - 1);
    t.yb = min(max(y0 + 1, 0), Hs - 1);
    return true;
}

// The taps of K1 and K4: the four corners as element offsets into the
// source image (32-bit: the launchers keep Hs*Ws*C < 2^31), so that a lane
// turns each into an address with one multiply-add; o00 = -1 marks four
// invalid taps.
struct Tap4 {
    int o00, o10, o01, o11;        // (xa,ya) (xb,ya) (xa,yb) (xb,yb)
    float w00, w10, w01, w11;
};

__device__ __forceinline__ bool depth_tap4(const PixelRows& r, float dep, int Hs, int Ws, int C,
                                           Tap4& q) {
    Taps t;
    if (!depth_taps(r, dep, Hs, Ws, t)) return false;
    const int ra = t.ya * Ws, rb = t.yb * Ws;
    q.o00 = (ra + t.xa) * C;
    q.o10 = (ra + t.xb) * C;
    q.o01 = (rb + t.xa) * C;
    q.o11 = (rb + t.xb) * C;
    q.w00 = t.w00; q.w10 = t.w10; q.w01 = t.w01; q.w11 = t.w11;
    return true;
}

// VW channels (from channel offset c) of the four corners of taps q, all
// four loads issued before any is widened
template <int VW, typename T>
__device__ __forceinline__ void corners(const T* img, const Tap4& q, int c, float* a, float* b,
                                        float* cq, float* d) {
    const Raw<VW, T> ra = ldraw<VW>(img + q.o00 + c);
    const Raw<VW, T> rb = ldraw<VW>(img + q.o10 + c);
    const Raw<VW, T> rc = ldraw<VW>(img + q.o01 + c);
    const Raw<VW, T> rd = ldraw<VW>(img + q.o11 + c);
    widen(ra, a);
    widen(rb, b);
    widen(rc, cq);
    widen(rd, d);
}

// lane `src` of each `width`-lane segment's taps, to every lane of it
__device__ __forceinline__ Tap4 shfl_taps(const Tap4& t, int src, int width) {
    constexpr unsigned ALL = 0xffffffffu;
    Tap4 o;
    o.o00 = __shfl_sync(ALL, t.o00, src, width);
    o.o10 = __shfl_sync(ALL, t.o10, src, width);
    o.o01 = __shfl_sync(ALL, t.o01, src, width);
    o.o11 = __shfl_sync(ALL, t.o11, src, width);
    o.w00 = __shfl_sync(ALL, t.w00, src, width);
    o.w10 = __shfl_sync(ALL, t.w10, src, width);
    o.w01 = __shfl_sync(ALL, t.w01, src, width);
    o.w11 = __shfl_sync(ALL, t.w11, src, width);
    return o;
}

// The depth sweep of K1 and K4: the `nl` lanes of one pixel (adjacent
// lanes of a warp, nl a power of two) walk the planes [dbeg, dend) in
// blocks of nl planes. In a block, lane j computes the taps of plane
// d0 + j (depth_tap4, for a source of C channels), then every lane
// receives each plane's taps by shuffle, so a pixel's taps are computed
// once per plane, not once per lane, and body(d, taps) runs for each plane
// in order. The depths are the one input that comes from device memory
// before any work can start, so a lane loads those of HQ blocks at once
// (HQ * nl planes: 4 for the compile-time nl of 1 and 2, nl for 4 and 8;
// more raised the registers past what paid on an H100) before it computes
// any taps.
// Every lane of the warp runs every shuffle (and `body`, which may shuffle
// too): a lane outside the image passes active = false, gets taps marked
// invalid (o00 = -1), and its body must not touch memory. NL_CT > 0 fixes nl
// at compile time; NL_CT == 0 takes nl at run time (HQ = 1).
template <int NL_CT, typename Body>
__device__ __forceinline__ void sweep(const PixelRows& pr, const float* hyp, long long plane,
                                      int dbeg, int dend, int nl, int lane, bool active,
                                      int Hs, int Ws, int C, Body&& body) {
    constexpr int HQ = NL_CT > 0 && NL_CT < 4 ? 4 / NL_CT : 1;
    const long long step = nl * plane;                 // a block's planes
    const float* hp = hyp + (dbeg + lane) * plane;     // this lane's next depth
    for (int s0 = dbeg; s0 < dend; s0 += nl * HQ) {
        float hv[HQ];
#pragma unroll
        for (int i = 0; i < HQ; ++i) {
            const int d = s0 + i * nl + lane;
            hv[i] = active && d < dend ? __ldg(hp) : 0.0f;
            hp += step;
        }
#pragma unroll
        for (int i = 0; i < HQ; ++i) {
            const int d0 = s0 + i * nl;
            if (d0 >= dend) break;
            Tap4 mine;
            if (!(active && d0 + lane < dend && depth_tap4(pr, hv[i], Hs, Ws, C, mine)))
                mine.o00 = -1;
            if constexpr (NL_CT == 1) {
                body(d0, mine);
            } else if constexpr (NL_CT > 1) {
#pragma unroll
                for (int k = 0; k < NL_CT; ++k) {
                    if (d0 + k >= dend) break;
                    body(d0 + k, shfl_taps(mine, k, NL_CT));
                }
            } else {
#pragma unroll 1
                for (int k = 0; k < nl; ++k) {
                    if (d0 + k >= dend) break;
                    body(d0 + k, nl == 1 ? mine : shfl_taps(mine, k, nl));
                }
            }
        }
    }
}

// VW consecutive float32 values stored in the tensor's dtype, as storev,
// with the evict-first hint (st.global.cs): for outputs that the kernel
// does not read again, so that L2 keeps the gathered source rows
template <int VW, typename T>
__device__ __forceinline__ void storev_cs(T* p, const float* v) {
    if constexpr (VW == 1) {
        if constexpr (std::is_same<T, float>::value) {
            __stcs(p, v[0]);
        } else {
            const __nv_bfloat16 h = __float2bfloat16_rn(v[0]);
            __stcs(reinterpret_cast<unsigned short*>(p),
                   *reinterpret_cast<const unsigned short*>(&h));
        }
    } else if constexpr (std::is_same<T, float>::value) {
#pragma unroll
        for (int q = 0; q < VW / 4; ++q)
            __stcs(reinterpret_cast<float4*>(p) + q,
                   make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
    } else if constexpr (VW == 8) {
        uint4 r;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
        for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        __stcs(reinterpret_cast<uint4*>(p), r);
    } else {
        uint2 r;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
        h[0] = __floats2bfloat162_rn(v[0], v[1]);
        h[1] = __floats2bfloat162_rn(v[2], v[3]);
        __stcs(reinterpret_cast<uint2*>(p), r);
    }
}

// The launch shape of the depth sweep (K1, K4): CTAs of 256 threads as
// (tx, ty), tx threads along a row (nl lanes per pixel, tx a multiple of 32
// so that a warp lies in one row and a pixel's lanes in one warp: of 32, 64
// and 128 the one that leaves the fewest threads past the row's end) and
// ty rows; grid.x walks the B*H rows (up to 2^31 - 1), grid.y the row's
// x tiles, grid.z chunks of planes. A launch with fewer than ctas_per_sm
// CTAs per SM splits D into chunks until it has that many, or one plane a
// CTA.
struct SweepPlan {
    int tx, ty, nl, dchunk;
    unsigned gx, gy, gz;
};

inline int sm_count() {
    static int n = 0;
    if (n <= 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        if (n <= 0) n = 132;
    }
    return n;
}

// false when the shape exceeds the grid's limits (B*H >= 2^31, or more
// than 65535 x tiles) or a source image has 2^31 elements or more
inline bool sweep_plan(int B, int D, int H, int W, int Hs, int Ws, int C, int nl,
                       int ctas_per_sm, SweepPlan& p) {
    constexpr int threads = 256;
    const long long rows = (long long)B * H;
    const long long row_threads = (long long)W * nl;
    p.nl = nl;
    p.tx = 128;
    for (int tx = 64; tx >= 32; tx /= 2)
        if ((row_threads + tx - 1) / tx * tx < (row_threads + p.tx - 1) / p.tx * p.tx) p.tx = tx;
    p.ty = threads / p.tx;
    const long long gx = (rows + p.ty - 1) / p.ty, gy = (row_threads + p.tx - 1) / p.tx;
    if (rows > 0x7fffffffLL || gx > 0x7fffffffLL || gy > 65535) return false;
    if ((long long)Hs * Ws * C > 0x7fffffffLL) return false;
    p.gx = (unsigned)gx;
    p.gy = (unsigned)gy;
    const long long ctas = gx * gy, want = (long long)ctas_per_sm * sm_count();
    const long long split = ctas >= want ? 1 : std::min<long long>(D, (want + ctas - 1) / ctas);
    p.dchunk = (int)((D + split - 1) / split);
    p.gz = (unsigned)((D + p.dchunk - 1) / p.dchunk);
    return true;
}

// ---------------------------------------- the staged routes' PTX (K2, K6)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes from global to shared memory, or 4 zero bytes when !valid: one
// element to any shared address, so that a copy can transpose as it lands
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// d += a * b: m16n8k16, bf16 inputs, float32 accumulators
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint2 b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// two floats as a bf16 pair, each rounded to nearest even, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

}  // namespace port
