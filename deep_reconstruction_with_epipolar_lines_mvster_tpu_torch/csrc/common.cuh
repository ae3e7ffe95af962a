// Device helpers shared by the port's kernels: eight channels of an NHWC
// pixel as one 16-byte load (bf16) or two (float32), widened to float32,
// and the 8-, 4- and 1-wide loads and stores of the generic instances (any
// channel count), one float32 value stored in the tensor's dtype, the PTX
// of the tensor-core routes (cp.async, ldmatrix, mma.sync), and the plane-sweep
// bilinear taps of one (b, d, y, x) that the warp kernels (K1 forward, K3
// backward) both use, so that the two agree with each other and with the
// plain PyTorch version to the bit.
#pragma once

#include <stdint.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

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

// (m0*u + m1*v + m2)*d + m3 without contraction into FMAs
__device__ __forceinline__ float plane_row(const float* m, float u, float v, float d) {
    const float s = __fadd_rn(__fadd_rn(__fmul_rn(m[0], u), __fmul_rn(m[1], v)), m[2]);
    return __fadd_rn(__fmul_rn(s, d), m[3]);
}

// The four bilinear taps of source image (Hs, Ws) that reference pixel
// (x, y) at depth `dep` reads through rows 0..2 of the relative projection
// `m` (core/geometry.warp_coords_xy, then grid_sample_2d): clamped pixel
// indices and weights, a weight 0 for a corner outside the image.
// A coordinate outside (-2, Ws+1) x (-2, Hs+1), NaN included, gives four
// zero weights: it is tested before any float -> int cast (undefined in
// CUDA for NaN and huge values), as the plain version clamps before its.
// Returns false when all four taps are invalid for that reason.
struct Taps {
    int xa, xb, ya, yb;            // clamped columns / rows of the corners
    float w00, w10, w01, w11;      // (xa,ya) (xb,ya) (xa,yb) (xb,yb)
};

__device__ __forceinline__ bool plane_taps(const float* m, int x, int y, float dep,
                                           int Hs, int Ws, Taps& t) {
    const float u = (float)x, v = (float)y;
    const float xn = plane_row(m, u, v, dep);
    const float yn = plane_row(m + 4, u, v, dep);
    float z = plane_row(m + 8, u, v, dep);
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

// ---------------------------------------- the tensor-core routes' PTX (K2, K6)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
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
