// K2: one FPN top-down level,
//   u = up2_align_corners(intra) + Conv1x1(skip) + bi     (64 channels)
//   o = Conv3x3(u), zero padding, no bias                 (Co channels)
// with u also written out for the mid levels (its next level's input), or,
// in the u_only mode of the chain's backward, u alone.
//
// Replaces the TPU kernel
//   deep_reconstruction_with_epipolar_lines_mvster_tpu/ops/pallas/topdown_fused.py:317
//   _run_kernel_v4 (inner kernel _kernel_v4 :202, whose u_only mode is the
//   u_only mode here), reached through topdown_fused_chain :698 ->
//   _chain_impl :609.
// The TPU kernel works channels-in-sublanes with lane rolls for the 3x3 taps
// and hoists the W-resize into an XLA einsum; none of that carries over.
// Here the upsample, the 1x1 and the 3x3 all run inside one kernel, and
// the full-resolution 64-channel u never goes to device memory unless a
// mid level asks for it.
//
// Bound on an H100 at the eval shape (N16, L4 512x640, Cs=Co=8, bf16):
// 336 MB of input and output, 100 us at 3.35 TB/s; the 54 GFLOP take 55 us
// on the bf16 tensor cores, so the level is bound by bytes.
//
// The first design (PR 1, kept below as the float32 route) ran every FLOP
// in float32 on the CUDA cores: per thread one output pixel, one u value
// and CO/4 float4 weight vectors from shared memory per CO FMAs (three
// loads per eight FMAs at Co = 8); phase 1 gathered four 64-channel corners
// of intra from device memory for each of the 10x34 halo pixels and ran the
// 1x1 on the CUDA cores; u sat in shared memory as float32 (87 KB). 6.99 ms
// per bf16 eval forward (L2/L3/L4 1018/2520/3451 us against bounds of
// 28/88/100 us, H100 80GB HBM3 at 700 W).
//
// The bf16 route (topdown_kernel_mma): one CTA of 8 warps per (n, 8-row x
// 32-column output tile).
//   0. cp.async stages the tile's intra footprint (7 x 19 half-resolution
//      pixels, 17 KB) and its skip halo (10 x 34 pixels) in shared memory,
//      zero outside the image.
//   1. The 1x1 runs on the tensor cores: mma.sync m16n8k16 (bf16 x bf16,
//      float32 accumulators started at the bias) over 22 m-tiles of 16 halo
//      pixels, K = Cs (8 padded to 16), N = 64, its columns permuted on the
//      host so that each lane's accumulators are 16 consecutive channels of
//      its two pixels; each accumulator then takes the align-corners
//      upsample of intra, read from shared memory in 16-byte chunks (row
//      pass, then column pass, as core/geometry.resize_align_corners, with
//      the host's float64 tap tables), and is rounded once to bf16 into the
//      u tile, again in 16-byte chunks: pixel-major, 64 channels = 128 B a
//      pixel, the chunk index XOR-swizzled by the halo pixel's index, so
//      that eight consecutive pixels put a chunk on eight different bank
//      groups (43 KB, half the float32 tile's 87 KB). Halo pixels outside
//      the image are 0.
//   2. The 3x3 is an implicit GEMM on the tensor cores over the u tile: each
//      warp owns one output row (two m-tiles of 16 pixels), K = 9 taps x 64
//      channels, N = Co; a tap (dy, dx) is the halo shifted by a row or a
//      column, and ldmatrix takes one address per lane, so the shift costs
//      nothing. B fragments come from the bf16 weights, packed on the host
//      in fragment order ([tap][k-step][n-tile][lane] x 8 B) and read through
//      the L1. o is rounded once to bf16, staged in shared memory and
//      stored, as u is, in 16-byte vectors.
// mma.sync and not wgmma: at N = Co = 8-32 the level is bound by bytes
// whichever MMA runs it, and a wgmma that reads A from shared memory needs
// every shifted window in its canonical layout, which a swizzled layout
// does not keep under a one-pixel shift.
// Shared memory: 45 KB u tile + 17 KB intra + 6-23 KB skip halo; the o
// staging reuses the intra footprint's space. Three CTAs share an SM at Cs
// <= 16 (at most 85 registers a thread), two at Cs = 32 (83 KB each).
//
// Measured (chip_smoke.py's kernel_shapes rows, H100 80GB HBM3 at 700 W):
// 1.155 ms per bf16 eval forward (L2/L3/L4 0.116 / 0.266 / 0.774 ms), 3.67
// ms per train step (forward and u_only at N 30).
//
// The float32 route (topdown_kernel_f32) keeps the first design: in full
// float32 on the CUDA cores, as the float32 pipeline is held to the CPU
// (no TF32), 1.87 ms per pipeline view (N 4). u_only skips its 3x3.

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using port::load8;
using port::store1;

constexpr int CI = 64;   // top-down pathway width (8 x base 8)
constexpr int TR = 8;    // output rows per tile
constexpr int TC = 32;   // output columns per tile
constexpr int HR = TR + 2, HC = TC + 2, NP = HR * HC;
constexpr int THREADS = TR * TC;

// ---------------------------------------------------------------- float32

template <int CS, int CO>
constexpr size_t f32_smem_bytes() {
    return sizeof(float) * (CI * NP + 9 * CI * CO + CS * CI + CI);
}

template <int CS, int CO>
__global__ void __launch_bounds__(THREADS) topdown_kernel_f32(
    const float* __restrict__ intra, // [N, Hh, Wh, 64]
    const float* __restrict__ skip,  // [N, H, W, CS]
    const float* __restrict__ wi,    // [CS, 64]
    const float* __restrict__ bi,    // [64]
    const float* __restrict__ wo,    // [3, 3, 64, CO]
    const int* __restrict__ hidx, const float* __restrict__ hw0,
    const float* __restrict__ hw1,   // [H] row taps
    const int* __restrict__ widx, const float* __restrict__ ww0,
    const float* __restrict__ ww1,   // [W] column taps
    float* __restrict__ out,         // [N, H, W, CO] or null (u_only)
    float* __restrict__ uout,        // [N, H, W, 64] or null
    int H, int W, int Hh, int Wh) {
    extern __shared__ float smem[];
    float* us = smem;                // [64][HR][HC]
    float* ws = us + CI * NP;        // [9 * 64][CO]
    float* wis = ws + 9 * CI * CO;   // [CS][64]
    float* bis = wis + CS * CI;      // [64]

    const int n = blockIdx.z, r0 = blockIdx.y * TR, c0 = blockIdx.x * TC;
    const int tid = threadIdx.x;
    if (out)
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
        const float* sp = skip + (((long long)n * H + g) * W + gc) * CS;
#pragma unroll
        for (int c8 = 0; c8 < CS; c8 += 8) load8(sp + c8, sk + c8);
        const int h0 = hidx[g], v0 = widx[gc];
        const float a0 = hw0[g], a1 = hw1[g], b0 = ww0[gc], b1 = ww1[gc];
        const int h1 = min(h0 + 1, Hh - 1), v1 = min(v0 + 1, Wh - 1);
        const float* base = intra + (long long)n * Hh * Wh * CI;
        const float* q00 = base + ((long long)h0 * Wh + v0) * CI;
        const float* q01 = base + ((long long)h0 * Wh + v1) * CI;
        const float* q10 = base + ((long long)h1 * Wh + v0) * CI;
        const float* q11 = base + ((long long)h1 * Wh + v1) * CI;
        const bool center = pr >= 1 && pr <= TR && pc >= 1 && pc <= TC;
        float* up = uout ? uout + (((long long)n * H + g) * W + gc) * CI : nullptr;
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
                const float uv = __fadd_rn(upv, __fadd_rn(s, bis[ci]));
                us[ci * NP + p] = uv;
                if (center && up) store1(up + ci, uv);
            }
        }
    }
    if (!out) return;                // u_only
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
        float4* op = reinterpret_cast<float4*>(out + (((long long)n * H + orow) * W + ocol) * CO);
#pragma unroll
        for (int q = 0; q < CO / 4; ++q)
            op[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
}

// ------------------------------------------------------ bf16, tensor cores

constexpr int MT1 = (NP + 15) / 16;          // m-tiles of the 1x1 over the halo
constexpr int NPM = MT1 * 16;                // halo pixels, padded
constexpr int IR = TR / 2 + 3, IC = TC / 2 + 3;  // intra footprint
constexpr size_t US_BYTES = (size_t)NPM * CI * 2;
constexpr size_t IS_BYTES = (size_t)IR * IC * CI * 2;

template <int CS>
constexpr size_t mma_smem_bytes() {
    return US_BYTES + IS_BYTES + (size_t)NPM * CS * 2;
}

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

__device__ __forceinline__ void ldmatrix_x2(uint32_t r[2], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

// d += a * b: m16n8k16, bf16 inputs, float32 accumulators
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint2 b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// byte offset of 16-byte chunk `c` of pixel `p` in a swizzled 128 B/pixel tile
__device__ __forceinline__ int swz(int p, int c) { return (p * 8 + (c ^ (p & 7))) * 16; }

template <int CS, int CO>
__global__ void __launch_bounds__(THREADS, CS == 32 ? 2 : 3) topdown_kernel_mma(
    const __nv_bfloat16* __restrict__ intra,  // [N, Hh, Wh, 64]
    const __nv_bfloat16* __restrict__ skip,   // [N, H, W, CS]
    const uint2* __restrict__ wi,    // 1x1 B fragments [max(CS/16,1)][8][32], permuted N
    const float* __restrict__ bi,    // [64]
    const uint2* __restrict__ wo,    // 3x3 B fragments [9][4][CO/8][32]
    const int* __restrict__ hidx, const float* __restrict__ hw0,
    const float* __restrict__ hw1,   // [H] row taps
    const int* __restrict__ widx, const float* __restrict__ ww0,
    const float* __restrict__ ww1,   // [W] column taps
    __nv_bfloat16* __restrict__ out, // [N, H, W, CO] or null (u_only)
    __nv_bfloat16* __restrict__ uout,  // [N, H, W, 64] or null
    int H, int W, int Hh, int Wh) {
    constexpr int CSC = CS / 8;                      // 16-byte chunks per skip pixel
    constexpr int SSH = CSC == 4 ? 1 : CSC == 2 ? 2 : 3;   // skip swizzle shift
    constexpr int KS = CS >= 16 ? CS / 16 : 1;       // k-steps of the 1x1
    constexpr int NT = CO / 8;                       // n-tiles of the 3x3
    extern __shared__ uint4 smem_raw[];
    char* us = reinterpret_cast<char*>(smem_raw);    // u tile, swizzled
    char* is = us + US_BYTES;                        // intra footprint, swizzled
    char* ss = is + IS_BYTES;                        // skip halo

    const int n = blockIdx.z, r0 = blockIdx.y * TR, c0 = blockIdx.x * TC;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, tq = lane & 3;         // fragment row, column pair

    // 0. stage the intra footprint and the skip halo
    const int hbase = hidx[max(r0 - 1, 0)], wbase = widx[max(c0 - 1, 0)];
    const __nv_bfloat16* ibase = intra + (long long)n * Hh * Wh * CI;
    for (int i = tid; i < IR * IC * 8; i += THREADS) {
        const int f = i >> 3, c = i & 7;
        const int hr = hbase + f / IC, wc = wbase + f % IC;
        const bool ok = hr < Hh && wc < Wh;
        cp_async16(is + swz(f, c), ibase + ((long long)(ok ? hr : 0) * Wh + (ok ? wc : 0)) * CI + c * 8,
                   ok);
    }
    for (int i = tid; i < NPM * CSC; i += THREADS) {
        const int p = i / CSC, c = i % CSC;
        const int g = r0 - 1 + p / HC, gc = c0 - 1 + p % HC;
        const bool ok = p < NP && g >= 0 && g < H && gc >= 0 && gc < W;
        const long long off = ok ? (((long long)n * H + g) * W + gc) * CS : 0;
        cp_async16(ss + (p * CSC + (c ^ ((p >> SSH) & (CSC - 1)))) * 16, skip + off + c * 8, ok);
    }
    asm volatile("cp.async.commit_group;\n");
    asm volatile("cp.async.wait_all;\n");
    __syncthreads();

    // 1. u = round(up2(intra) + (1x1(skip) + bi)) over the halo. The 1x1's
    // 64 output columns are permuted on the host so that the C fragment of
    // lane (gq, tq) holds channels 16tq .. 16tq + 15 of its two pixels
    // (n-tile j, column 2tq + e is channel 16tq + 2j + e): the upsample
    // reads and the u stores are then two 16-byte chunks a pixel.
    for (int mt = warp; mt < MT1; mt += THREADS / 32) {
        uint32_t a[KS][4];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
            const int p = mt * 16 + (lane & 15);
            if (CS == 8) {
                ldmatrix_x2(a[ks], ss + p * 16);
                a[ks][2] = 0u; a[ks][3] = 0u;
            } else {
                const int c = 2 * ks + (lane >> 4);
                ldmatrix_x4(a[ks], ss + (p * CSC + (c ^ ((p >> SSH) & (CSC - 1)))) * 16);
            }
        }
        // the align-corners taps of the lane's two pixels (rows gq, gq + 8):
        // the four corners in the intra footprint and the four weights; a
        // halo pixel outside the image reads its clamped neighbour's taps
        // (inside the footprint) and stores 0
        int f[2][4];
        float tw[2][4];
        bool inside[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int p = min(mt * 16 + gq + 8 * half, NP - 1);
            const int g = r0 - 1 + p / HC, gc = c0 - 1 + p % HC;
            inside[half] = mt * 16 + gq + 8 * half < NP && g >= 0 && g < H && gc >= 0 && gc < W;
            const int gs = min(max(g, 0), H - 1), gcs = min(max(gc, 0), W - 1);
            const int h0 = hidx[gs], v0 = widx[gcs];
            const int fr0 = h0 - hbase, fr1 = min(h0 + 1, Hh - 1) - hbase;
            const int fc0 = v0 - wbase, fc1 = min(v0 + 1, Wh - 1) - wbase;
            f[half][0] = fr0 * IC + fc0; f[half][1] = fr0 * IC + fc1;
            f[half][2] = fr1 * IC + fc0; f[half][3] = fr1 * IC + fc1;
            tw[half][0] = hw0[gs]; tw[half][1] = hw1[gs];
            tw[half][2] = ww0[gcs]; tw[half][3] = ww1[gcs];
        }
        // channels 16tq + 8hc .. + 8 (n-tiles 4hc .. 4hc + 3): one 16-byte
        // chunk of the pixel, chunk 2tq + hc
#pragma unroll
        for (int hc = 0; hc < 2; ++hc) {
            float acc[4][4];
            const float4* b4 = reinterpret_cast<const float4*>(bi + 16 * tq + 8 * hc);
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                const float4 v = __ldg(b4 + q);
                acc[2 * q][0] = v.x; acc[2 * q][1] = v.y; acc[2 * q][2] = v.x; acc[2 * q][3] = v.y;
                acc[2 * q + 1][0] = v.z; acc[2 * q + 1][1] = v.w;
                acc[2 * q + 1][2] = v.z; acc[2 * q + 1][3] = v.w;
            }
#pragma unroll
            for (int ks = 0; ks < KS; ++ks)
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    mma_bf16(acc[i], a[ks], __ldg(wi + (ks * 8 + 4 * hc + i) * 32 + lane));
            const int c = 2 * tq + hc;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int p = mt * 16 + gq + 8 * half;
                if (p >= NP) continue;
                const uint4 q00 = *reinterpret_cast<const uint4*>(is + swz(f[half][0], c));
                const uint4 q01 = *reinterpret_cast<const uint4*>(is + swz(f[half][1], c));
                const uint4 q10 = *reinterpret_cast<const uint4*>(is + swz(f[half][2], c));
                const uint4 q11 = *reinterpret_cast<const uint4*>(is + swz(f[half][3], c));
                const uint32_t w00[4] = {q00.x, q00.y, q00.z, q00.w};
                const uint32_t w01[4] = {q01.x, q01.y, q01.z, q01.w};
                const uint32_t w10[4] = {q10.x, q10.y, q10.z, q10.w};
                const uint32_t w11[4] = {q11.x, q11.y, q11.z, q11.w};
                const float a0 = tw[half][0], a1 = tw[half][1];
                const float b0 = tw[half][2], b1 = tw[half][3];
                uint32_t o[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {            // channel pair 8hc + 2i
                    const float2 e00 = unpack_bf16(w00[i]), e01 = unpack_bf16(w01[i]);
                    const float2 e10 = unpack_bf16(w10[i]), e11 = unpack_bf16(w11[i]);
                    const float ex00[2] = {e00.x, e00.y}, ex01[2] = {e01.x, e01.y};
                    const float ex10[2] = {e10.x, e10.y}, ex11[2] = {e11.x, e11.y};
                    float uv[2];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float left = __fadd_rn(__fmul_rn(a0, ex00[e]), __fmul_rn(a1, ex10[e]));
                        const float right = __fadd_rn(__fmul_rn(a0, ex01[e]), __fmul_rn(a1, ex11[e]));
                        const float upv = __fadd_rn(__fmul_rn(b0, left), __fmul_rn(b1, right));
                        uv[e] = __fadd_rn(upv, acc[i][2 * half + e]);
                    }
                    o[i] = inside[half] ? pack_bf16(uv[0], uv[1]) : 0u;
                }
                *reinterpret_cast<uint4*>(us + swz(p, c)) = make_uint4(o[0], o[1], o[2], o[3]);
            }
        }
    }
    __syncthreads();

    // u of the tile's own pixels, 16 bytes a thread
    if (uout) {
        for (int i = tid; i < TR * TC * 8; i += THREADS) {
            const int px = i >> 3, c = i & 7;
            const int tr = px / TC, tc = px % TC, row = r0 + tr, col = c0 + tc;
            if (row >= H || col >= W) continue;
            const int p = (tr + 1) * HC + tc + 1;
            *reinterpret_cast<uint4*>(uout + (((long long)n * H + row) * W + col) * CI + c * 8) =
                *reinterpret_cast<const uint4*>(us + swz(p, c));
        }
    }
    if (!out) return;                // u_only

    // 2. the 3x3: warp `warp` owns output row r0 + warp, two m-tiles of 16
    float acc[2][NT][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
            uint2 b[NT];
#pragma unroll
            for (int j = 0; j < NT; ++j) b[j] = __ldg(wo + ((tap * 4 + ks) * NT + j) * 32 + lane);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
                const int p = (warp + ky) * HC + mi * 16 + (lane & 15) + kx;
                uint32_t a[4];
                ldmatrix_x4(a, us + swz(p, 2 * ks + (lane >> 4)));
#pragma unroll
                for (int j = 0; j < NT; ++j) mma_bf16(acc[mi][j], a, b[j]);
            }
        }
    }

    // o: rounded once, staged in the intra footprint's space (read only in
    // phase 1), stored in 16-byte vectors
    __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(is) + warp * TC * CO;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int col = mi * 16 + gq + 8 * half;
                *reinterpret_cast<uint32_t*>(os + col * CO + 8 * j + 2 * tq) =
                    pack_bf16(acc[mi][j][2 * half], acc[mi][j][2 * half + 1]);
            }
    __syncwarp();
    const int row = r0 + warp;
    if (row >= H) return;
    for (int i = lane; i < TC * CO / 8; i += 32) {
        const int col = c0 + (i * 8) / CO;
        if (col >= W) continue;
        *reinterpret_cast<uint4*>(out + (((long long)n * H + row) * W + c0) * CO + i * 8) =
            reinterpret_cast<const uint4*>(os)[i];
    }
}

// ------------------------------------------------------------- launchers

template <typename KernelFn, typename T, typename WT>
int run(KernelFn kernel, size_t bytes, const void* intra, const void* skip, const void* wi,
        const void* bi, const void* wo, const void* hidx, const void* hw0, const void* hw1,
        const void* widx, const void* ww0, const void* ww1, void* out, void* uout, int N,
        int H, int W, int Hh, int Wh, cudaStream_t stream) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((W + TC - 1) / TC, (H + TR - 1) / TR, N);
    kernel<<<grid, THREADS, bytes, stream>>>(
        static_cast<const T*>(intra), static_cast<const T*>(skip),
        static_cast<const WT*>(wi), static_cast<const float*>(bi),
        static_cast<const WT*>(wo), static_cast<const int*>(hidx),
        static_cast<const float*>(hw0), static_cast<const float*>(hw1),
        static_cast<const int*>(widx), static_cast<const float*>(ww0),
        static_cast<const float*>(ww1), static_cast<T*>(out), static_cast<T*>(uout),
        H, W, Hh, Wh);
    return (int)cudaGetLastError();
}

template <typename T, int CS, int CO>
int launch(const void* intra, const void* skip, const void* wi, const void* bi,
           const void* wo, const void* hidx, const void* hw0, const void* hw1,
           const void* widx, const void* ww0, const void* ww1, void* out, void* uout,
           int N, int H, int W, int Hh, int Wh, cudaStream_t s) {
    if constexpr (std::is_same<T, float>::value)
        return run<decltype(&topdown_kernel_f32<CS, CO>), float, float>(
            topdown_kernel_f32<CS, CO>, f32_smem_bytes<CS, CO>(), intra, skip, wi, bi, wo,
            hidx, hw0, hw1, widx, ww0, ww1, out, uout, N, H, W, Hh, Wh, s);
    else
        return run<decltype(&topdown_kernel_mma<CS, CO>), __nv_bfloat16, uint2>(
            topdown_kernel_mma<CS, CO>, mma_smem_bytes<CS>(), intra, skip, wi, bi, wo,
            hidx, hw0, hw1, widx, ww0, ww1, out, uout, N, H, W, Hh, Wh, s);
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
// (Cs, Co) pair without an instantiation). uout may be null; out null is the
// u_only mode (then uout is not). Float32: wi [Cs, 64] and wo [3, 3, 64, Co]
// float32. bf16: wi and wo the B fragments the wrapper packs.
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
