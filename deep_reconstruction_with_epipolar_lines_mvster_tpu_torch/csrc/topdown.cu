// K2: one FPN top-down level,
//   u = up2_align_corners(intra) + Conv1x1(skip) + bi     (CI = 8 x base channels)
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
// The first design (the float32 route until the generic kernel below
// replaced it) ran every FLOP in float32 on the CUDA cores: per thread one
// output pixel, one u value and CO/4 float4 weight vectors from shared
// memory per CO FMAs (three loads per eight FMAs at Co = 8); phase 1
// gathered four 64-channel corners of intra from device memory for each of
// the 10x34 halo pixels and ran the 1x1 on the CUDA cores; u sat in shared
// memory as float32 (87 KB). 6.99 ms
// per bf16 eval forward (L2/L3/L4 1018/2520/3451 us against bounds of
// 28/88/100 us, H100 80GB HBM3 at 700 W).
//
// The bf16 route (topdown_kernel_mma), for CI = 64 (base 8) and Cs, Co in
// {8, 16, 32}: one CTA of 8 warps per (n, 8-row x 32-column output tile).
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
// The generic kernel (topdown_kernel_gen) is the float32 route and serves
// every shape: CI = 8 x base (a multiple of 8), any Cs and Co, at run time,
// in float32 storage or in bf16 for the shapes the tensor-core route has no
// instance for (the sums in float32, u and o rounded once each, as
// topdown_level_ref rounds them). It stays in full float32 on the CUDA
// cores (the float32 pipeline is held to the CPU with TF32 off). It
// replaces the first design, which cost 1.87 ms per float32
// pipeline view (N 4; L2/L3/L4 0.301 / 0.617 / 0.955 ms against an
// operation bound of 0.050 / 0.100 / 0.200 ms) because:
//   - its 3x3 read one u float and Co/4 float4 weights from shared memory
//     per Co FMAs (three loads per eight FMAs at Co = 8);
//   - its phase 1 gathered the four 64-channel corners of intra from device
//     memory for each of the 10 x 34 halo pixels;
//   - its float32 u tile (87 KB) and weights held one or two CTAs an SM.
// The generic design: one CTA per (n, 16-row x 32-column output tile; 8
// rows where Co > 8, so that the smaller L2 and L3 grids fill the card),
// over u in chunks of 8 channels (so any CI fits: 20-41 KB of shared
// memory, not 87-174 KB):
//   0. cp.async stages the skip halo once where it fits in 48 KB (phase 1
//      reads it in every chunk; from device memory that was a chain of L2
//      round trips per pixel), then per chunk the intra footprint (11 x 19
//      half-resolution pixels), its 1x1 weights and its 3x3 weights;
//   1. u of the chunk over the 18 x 34 halo, with the first design's
//      operations in its order (the 1x1 as fmaf over Cs from 0, then the
//      __fmul_rn/__fadd_rn upsample and bias), so float32 u is bit-equal to
//      the first design's; zero outside the image; then the tile's own
//      pixels of the chunk to u in device memory where asked, two lanes to
//      a pixel's 32 bytes (one lane a pixel, at a 4 CI-byte stride, wrote
//      at 0.24 TB/s: 1.42 ms for L4's u alone);
//   2. the 3x3 register-tiled: each thread owns a strip of 4 adjacent
//      output pixels x 8 output channels (8 x rows x NCB threads, NCB = 1,
//      2, 4 for Co <= 8, 16, more; wider Co runs passes), keeps the strip's 3 x 6
//      u window of one channel in registers (two vector loads a row), and
//      reads each tap's 8 weights as two float4 broadcasts once for all 4
//      pixels: per channel 24 loads for 288 FMAs (the first design: 27 for
//      72 at Co = 8). Each output sums over (ci, tap) in the first design's
//      order.

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using port::cp_async16;
using port::ldmatrix_x4;
using port::load8;
using port::mma_bf16;
using port::pack_bf16;
using port::smem_addr;
using port::store1;

constexpr int CI = 64;   // top-down pathway width (8 x base 8)
constexpr int TR = 8;    // output rows per tile
constexpr int TC = 32;   // output columns per tile
constexpr int HR = TR + 2, HC = TC + 2, NP = HR * HC;
constexpr int THREADS = TR * TC;

// commit this thread's cp.async copies and wait for all of them
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\n");
    asm volatile("cp.async.wait_all;\n");
}

// ------------------------------------- generic: float32 route, any shape

constexpr int GTC = 32;                       // output tile columns
constexpr int GHC = GTC + 2;                  // u halo columns
constexpr int GHS = GHC + 2;                  // its row stride, 16-byte aligned
constexpr int GIC = GTC / 2 + 3;              // intra footprint columns
constexpr int CK = 8;                         // u channels per chunk (CI = 8 x base)

// output tile rows: 16 where a thread block covers Co <= 8, 8 above (twice
// the CTAs, so that the small L2 and L3 grids fill the card)
template <int NCB> __host__ __device__ constexpr int gen_rows() { return NCB == 1 ? 16 : 8; }

// bytes of shared memory: the u chunk, the 3x3 weights of the chunk, the
// 1x1 weights of the chunk, the intra footprint of the chunk, and, where
// staged, the skip halo
template <typename T, int NCB>
size_t gen_smem_bytes(int cs, bool skip_staged) {
    constexpr int TR = gen_rows<NCB>();
    return sizeof(float) * ((size_t)CK * (TR + 2) * GHS + 9 * CK * 8 * NCB + (size_t)cs * CK) +
           sizeof(T) * (TR / 2 + 3) * GIC * CK +
           (skip_staged ? sizeof(T) * (size_t)(TR + 2) * GHC * cs : 0);
}

// the largest skip halo staged in shared memory; a wider one is read from
// device memory in every chunk
constexpr size_t SKIP_STAGE_MAX = 48 * 1024;

// four or one channel(s) of a skip pixel in shared or device memory (a
// generic load), widened to float32
__device__ __forceinline__ void ld4(const float* p, float v[4]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float v[4]) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// eight channels of a staged footprint pixel, widened to float32
__device__ __forceinline__ void lds8(const float* p, float v[8]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void lds8(const __nv_bfloat16* p, float v[8]) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
    }
}

// The generic instance: CI (a multiple of 8), CS and CO at run time; T is
// the storage (float32, or bf16 for the shapes the tensor-core route does
// not take), the sums are float32 and u and o are rounded to T once each.
// NCB: 8-channel blocks of o per pass, one thread per (strip, block), so a
// thread keeps 4 pixels x 8 sums; CO > 8 NCB runs ceil(CO / (8 NCB)) passes.
// At least 20 warps an SM (the register cap: ~100 at 128 threads, 128 at
// 256; left to itself ptxas took 166-177 and held 8 warps).
template <typename T, int NCB>
__global__ void __launch_bounds__(gen_rows<NCB>() * 8 * NCB, 640 / (gen_rows<NCB>() * 8 * NCB))
topdown_kernel_gen(
    const T* __restrict__ intra,     // [N, Hh, Wh, CI]
    const T* __restrict__ skip,      // [N, H, W, CS]
    const float* __restrict__ wi,    // [CS, CI], rounded to T
    const float* __restrict__ bi,    // [CI]
    const float* __restrict__ wo,    // [passes][3][3][CI][8 NCB], rounded to T, 0 past CO
    const int* __restrict__ hidx, const float* __restrict__ hw0,
    const float* __restrict__ hw1,   // [H] row taps
    const int* __restrict__ widx, const float* __restrict__ ww0,
    const float* __restrict__ ww1,   // [W] column taps
    T* __restrict__ out,             // [N, H, W, CO] or null (u_only)
    T* __restrict__ uout,            // [N, H, W, CI] or null
    int H, int W, int Hh, int Wh, int CI, int CS, int CO, int skip_staged) {
    constexpr int COB = 8 * NCB;
    constexpr int TR = gen_rows<NCB>(), GHR = TR + 2, GNP = GHR * GHC, GIR = TR / 2 + 3;
    constexpr int STRIPS = TR * 8;               // 4-pixel strips of the tile
    constexpr int UCH = GHR * GHS;               // channel stride of the u chunk
    constexpr int TCH = CK * sizeof(T) / 16;     // 16-byte pieces of a footprint pixel
    extern __shared__ float4 smem_gen[];
    float* us = reinterpret_cast<float*>(smem_gen);   // [CK][GHR][GHS]
    float* ws = us + CK * UCH;                         // [9][CK][COB]
    float* wis = ws + 9 * CK * COB;                    // [CS][CK]
    T* isf = reinterpret_cast<T*>(wis + CS * CK);      // [GIR * GIC][CK]
    T* sks = isf + GIR * GIC * CK;                     // [GNP][CS] where staged

    const int n = blockIdx.z, r0 = blockIdx.y * TR, c0 = blockIdx.x * GTC;
    constexpr int NTH = STRIPS * NCB;
    const int tid = threadIdx.x;
    const int st = tid % STRIPS, cb = tid / STRIPS;  // strip, 8-channel block of o
    const int tr = st >> 3, tj = st & 7;         // strip: row tr, columns 4tj .. 4tj + 3
    const int hbase = hidx[max(r0 - 1, 0)], wbase = widx[max(c0 - 1, 0)];
    const T* ibase = intra + (long long)n * Hh * Wh * CI;
    const int passes = out ? (CO + COB - 1) / COB : 1;

    // the skip halo, once for all chunks and passes (it lands with the first
    // chunk's copies), zero outside the image
    if (skip_staged) {
        const int PC = CS * (int)sizeof(T) / 16;     // 16-byte pieces of a pixel
        for (int i = tid; i < GNP * PC; i += NTH) {
            const int p = i / PC, c = i % PC;
            const int g = r0 - 1 + p / GHC, gc = c0 - 1 + p % GHC;
            const bool ok = g >= 0 && g < H && gc >= 0 && gc < W;
            cp_async16(reinterpret_cast<char*>(sks) + (p * PC + c) * 16,
                       skip + (ok ? (((long long)n * H + g) * W + gc) * CS : 0) +
                           c * (16 / (int)sizeof(T)),
                       ok);
        }
    }

#pragma unroll 1
    for (int pass = 0; pass < passes; ++pass) {
        float acc[4][8];
#pragma unroll
        for (int px = 0; px < 4; ++px)
#pragma unroll
            for (int co = 0; co < 8; ++co) acc[px][co] = 0.0f;

#pragma unroll 1
        for (int ci0 = 0; ci0 < CI; ci0 += CK) {
            __syncthreads();                     // the previous chunk's readers are done
            // 0. stage the chunk: intra footprint, 1x1 and 3x3 weights
            for (int i = tid; i < GIR * GIC * TCH; i += NTH) {
                const int f = i / TCH, c = i % TCH;
                const int hr = hbase + f / GIC, wc = wbase + f % GIC;
                const bool ok = hr < Hh && wc < Wh;
                cp_async16(reinterpret_cast<char*>(isf) + (f * TCH + c) * 16,
                           ibase + ((long long)(ok ? hr : 0) * Wh + (ok ? wc : 0)) * CI + ci0 +
                               c * (16 / (int)sizeof(T)),
                           ok);
            }
            for (int i = tid; i < CS * 2; i += NTH)
                cp_async16(wis + i * 4, wi + (long long)(i >> 1) * CI + ci0 + (i & 1) * 4, true);
            if (out) {
                constexpr int PT = CK * COB / 4;     // 16-byte pieces of one tap's weights
                for (int i = tid; i < 9 * PT; i += NTH) {
                    const int k = i / PT, r = i % PT;
                    cp_async16(ws + k * CK * COB + 4 * r,
                               wo + (((long long)pass * 9 + k) * CI + ci0) * COB + 4 * r, true);
                }
            }
            cp_async_wait_all();
            __syncthreads();

            // 1. u = up2(intra) + (1x1(skip) + bi) over the halo, this chunk's
            // channels, in the first design's operations and order
            for (int p = tid; p < GNP; p += NTH) {
                const int pr = p / GHC, pc = p % GHC;
                const int g = r0 - 1 + pr, gc = c0 - 1 + pc;
                float* up = us + pr * GHS + pc;
                if (g < 0 || g >= H || gc < 0 || gc >= W) {
#pragma unroll
                    for (int i = 0; i < CK; ++i) up[i * UCH] = 0.0f;
                    continue;
                }
                float s[CK];
#pragma unroll
                for (int i = 0; i < CK; ++i) s[i] = 0.0f;
                const T* sp = skip_staged ? sks + p * CS
                                          : skip + (((long long)n * H + g) * W + gc) * CS;
                if ((CS & 3) == 0) {
#pragma unroll 2
                    for (int cs = 0; cs < CS; cs += 4) {
                        float v[4];
                        ld4(sp + cs, v);
#pragma unroll
                        for (int q = 0; q < 4; ++q)
#pragma unroll
                            for (int i = 0; i < CK; ++i)
                                s[i] = fmaf(v[q], wis[(cs + q) * CK + i], s[i]);
                    }
                } else {
#pragma unroll 1
                    for (int cs = 0; cs < CS; ++cs) {
                        const float v = ld1(sp + cs);
#pragma unroll
                        for (int i = 0; i < CK; ++i) s[i] = fmaf(v, wis[cs * CK + i], s[i]);
                    }
                }
                const int h0 = hidx[g], v0 = widx[gc];
                const float a0 = hw0[g], a1 = hw1[g], b0 = ww0[gc], b1 = ww1[gc];
                const int h1 = min(h0 + 1, Hh - 1), v1 = min(v0 + 1, Wh - 1);
                const int fr0 = (h0 - hbase) * GIC, fr1 = (h1 - hbase) * GIC;
                const int fc0 = v0 - wbase, fc1 = v1 - wbase;
                float e00[CK], e01[CK], e10[CK], e11[CK];
                lds8(isf + (fr0 + fc0) * CK, e00);
                lds8(isf + (fr0 + fc1) * CK, e01);
                lds8(isf + (fr1 + fc0) * CK, e10);
                lds8(isf + (fr1 + fc1) * CK, e11);
#pragma unroll
                for (int i = 0; i < CK; ++i) {
                    const float left = __fadd_rn(__fmul_rn(a0, e00[i]), __fmul_rn(a1, e10[i]));
                    const float right = __fadd_rn(__fmul_rn(a0, e01[i]), __fmul_rn(a1, e11[i]));
                    const float upv = __fadd_rn(__fmul_rn(b0, left), __fmul_rn(b1, right));
                    const float uv = __fadd_rn(upv, __fadd_rn(s[i], __ldg(bi + ci0 + i)));
                    up[i * UCH] = round_as(uv, skip);
                }
            }
            __syncthreads();

            // the tile's own pixels of the u chunk to device memory: 16 bytes a
            // lane, neighbouring lanes on one pixel's 32-byte (float32) chunk
            // (a lane per pixel, 32 B at a 4 CI-byte stride, ran at 0.24 TB/s)
            if (uout && pass == 0) {
                constexpr int EPP = 16 / (int)sizeof(T);     // channels a store
                constexpr int PPX = CK / EPP;                // stores a pixel
                for (int i = tid; i < TR * GTC * PPX; i += NTH) {
                    const int px = i / PPX, h = i % PPX;
                    const int r = px / GTC, c = px % GTC, g = r0 + r, gc = c0 + c;
                    if (g >= H || gc >= W) continue;
                    const float* src = us + (r + 1) * GHS + c + 1 + h * EPP * UCH;
                    float v[EPP];
#pragma unroll
                    for (int j = 0; j < EPP; ++j) v[j] = src[j * UCH];
                    port::storev<EPP>(uout + (((long long)n * H + g) * W + gc) * CI + ci0 + h * EPP,
                                      v);
                }
            }
            if (!out) continue;                  // u_only

            // 2. the 3x3 over the chunk: each thread keeps the 3 x 6 window of
            // its strip for one channel in registers, so a u value serves up
            // to 3 taps and 4 pixels, and a weight vector 4 pixels
#pragma unroll 1
            for (int ck = 0; ck < CK; ++ck) {
                float win[3][6];
#pragma unroll
                for (int dy = 0; dy < 3; ++dy) {
                    const float* row = us + ck * UCH + (tr + dy) * GHS + 4 * tj;
                    const float4 a = *reinterpret_cast<const float4*>(row);
                    const float2 b = *reinterpret_cast<const float2*>(row + 4);
                    win[dy][0] = a.x; win[dy][1] = a.y; win[dy][2] = a.z; win[dy][3] = a.w;
                    win[dy][4] = b.x; win[dy][5] = b.y;
                }
#pragma unroll
                for (int k = 0; k < 9; ++k) {
                    const int dy = k / 3, dx = k % 3;
                    const float4* w4 =
                        reinterpret_cast<const float4*>(ws + (k * CK + ck) * COB + 8 * cb);
#pragma unroll
                    for (int q = 0; q < 2; ++q) {
                        const float4 w = w4[q];
#pragma unroll
                        for (int px = 0; px < 4; ++px) {
                            const float u = win[dy][px + dx];
                            acc[px][4 * q] = fmaf(u, w.x, acc[px][4 * q]);
                            acc[px][4 * q + 1] = fmaf(u, w.y, acc[px][4 * q + 1]);
                            acc[px][4 * q + 2] = fmaf(u, w.z, acc[px][4 * q + 2]);
                            acc[px][4 * q + 3] = fmaf(u, w.w, acc[px][4 * q + 3]);
                        }
                    }
                }
            }
        }
        if (!out) return;

        // o of the strip, this thread's 8 channels; 16-byte (float32) or
        // 8-byte (bf16) vectors where CO % 4 == 0
        const int orow = r0 + tr, co0 = pass * COB + 8 * cb, nco = min(8, CO - co0);
        if (orow < H && nco > 0) {
#pragma unroll
            for (int px = 0; px < 4; ++px) {
                const int ocol = c0 + 4 * tj + px;
                if (ocol >= W) continue;
                T* op = out + (((long long)n * H + orow) * W + ocol) * CO + co0;
                if ((CO & 3) == 0) {
#pragma unroll
                    for (int q = 0; q < 2; ++q)
                        if (4 * q < nco) port::storev<4>(op + 4 * q, &acc[px][4 * q]);
                } else {
#pragma unroll
                    for (int co = 0; co < 8; ++co)
                        if (co < nco) store1(op + co, acc[px][co]);
                }
            }
        }
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

__device__ __forceinline__ void ldmatrix_x2(uint32_t r[2], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
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
    cp_async_wait_all();
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

#define TOPDOWN_PTRS intra, skip, wi, bi, wo, hidx, hw0, hw1, widx, ww0, ww1, out, uout

template <int CS, int CO>
int launch_mma(const void* intra, const void* skip, const void* wi, const void* bi,
               const void* wo, const void* hidx, const void* hw0, const void* hw1,
               const void* widx, const void* ww0, const void* ww1, void* out, void* uout,
               int N, int H, int W, int Hh, int Wh, cudaStream_t s) {
    auto kernel = topdown_kernel_mma<CS, CO>;
    const size_t bytes = mma_smem_bytes<CS>();
    static bool allowed = false;
    if (!allowed) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)bytes);
        if (e != cudaSuccess) return (int)e;
        allowed = true;
    }
    const dim3 grid((W + TC - 1) / TC, (H + TR - 1) / TR, N);
    kernel<<<grid, THREADS, bytes, s>>>(
        static_cast<const __nv_bfloat16*>(intra), static_cast<const __nv_bfloat16*>(skip),
        static_cast<const uint2*>(wi), static_cast<const float*>(bi),
        static_cast<const uint2*>(wo), static_cast<const int*>(hidx),
        static_cast<const float*>(hw0), static_cast<const float*>(hw1),
        static_cast<const int*>(widx), static_cast<const float*>(ww0),
        static_cast<const float*>(ww1), static_cast<__nv_bfloat16*>(out),
        static_cast<__nv_bfloat16*>(uout), H, W, Hh, Wh);
    return (int)cudaGetLastError();
}

template <int CS>
int launch_mma_co(int CO, const void* intra, const void* skip, const void* wi, const void* bi,
                  const void* wo, const void* hidx, const void* hw0, const void* hw1,
                  const void* widx, const void* ww0, const void* ww1, void* out, void* uout,
                  int N, int H, int W, int Hh, int Wh, cudaStream_t s) {
    switch (CO) {
        case 8: return launch_mma<CS, 8>(TOPDOWN_PTRS, N, H, W, Hh, Wh, s);
        case 16: return launch_mma<CS, 16>(TOPDOWN_PTRS, N, H, W, Hh, Wh, s);
        case 32: return launch_mma<CS, 32>(TOPDOWN_PTRS, N, H, W, Hh, Wh, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <typename T, int NCB>
int launch_gen(const void* intra, const void* skip, const void* wi, const void* bi,
               const void* wo, const void* hidx, const void* hw0, const void* hw1,
               const void* widx, const void* ww0, const void* ww1, void* out, void* uout,
               int N, int H, int W, int Hh, int Wh, int CI, int CS, int CO, cudaStream_t s) {
    auto kernel = topdown_kernel_gen<T, NCB>;
    constexpr int TR = gen_rows<NCB>();
    const bool staged = CS * sizeof(T) % 16 == 0 &&
                        sizeof(T) * (size_t)(TR + 2) * GHC * CS <= SKIP_STAGE_MAX;
    const size_t bytes = gen_smem_bytes<T, NCB>(CS, staged);
    static size_t allowed = 0;                   // the limit set so far
    if (bytes > allowed) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)bytes);
        if (e != cudaSuccess) return (int)e;
        allowed = bytes;
    }
    const dim3 grid((W + GTC - 1) / GTC, (H + TR - 1) / TR, N);
    kernel<<<grid, TR * 8 * NCB, bytes, s>>>(
        static_cast<const T*>(intra), static_cast<const T*>(skip),
        static_cast<const float*>(wi), static_cast<const float*>(bi),
        static_cast<const float*>(wo), static_cast<const int*>(hidx),
        static_cast<const float*>(hw0), static_cast<const float*>(hw1),
        static_cast<const int*>(widx), static_cast<const float*>(ww0),
        static_cast<const float*>(ww1), static_cast<T*>(out), static_cast<T*>(uout),
        H, W, Hh, Wh, CI, CS, CO, (int)staged);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_gen_ncb(int ncb, const void* intra, const void* skip, const void* wi,
                   const void* bi, const void* wo, const void* hidx, const void* hw0,
                   const void* hw1, const void* widx, const void* ww0, const void* ww1,
                   void* out, void* uout, int N, int H, int W, int Hh, int Wh, int CI, int CS,
                   int CO, cudaStream_t s) {
    switch (ncb) {
        case 1: return launch_gen<T, 1>(TOPDOWN_PTRS, N, H, W, Hh, Wh, CI, CS, CO, s);
        case 2: return launch_gen<T, 2>(TOPDOWN_PTRS, N, H, W, Hh, Wh, CI, CS, CO, s);
        case 4: return launch_gen<T, 4>(TOPDOWN_PTRS, N, H, W, Hh, Wh, CI, CS, CO, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape that the chosen route has no instance for). uout may be null; out
// null is the u_only mode (then uout is not).
//   mma = 1 (bf16, CI = 64, CS and CO in {8, 16, 32}): the tensor-core
//     route; wi and wo are the B fragments the wrapper packs.
//   mma = 0: the generic kernel, any CI (a multiple of 8), CS and CO, float32
//     or bf16 storage; wi [CS, CI] and wo [passes][3][3][CI][8 ncb] float32,
//     rounded to the storage dtype, wo zero past CO; ncb in {1, 2, 4}.
extern "C" int topdown_launch(const void* intra, const void* skip, const void* wi,
                              const void* bi, const void* wo, const void* hidx,
                              const void* hw0, const void* hw1, const void* widx,
                              const void* ww0, const void* ww1, void* out, void* uout,
                              int N, int H, int W, int Hh, int Wh, int CI, int CS, int CO,
                              int is_bf16, int mma, int ncb, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (mma) {
        if (!is_bf16 || CI != 64) return (int)cudaErrorInvalidValue;
        switch (CS) {
            case 8: return launch_mma_co<8>(CO, TOPDOWN_PTRS, N, H, W, Hh, Wh, s);
            case 16: return launch_mma_co<16>(CO, TOPDOWN_PTRS, N, H, W, Hh, Wh, s);
            case 32: return launch_mma_co<32>(CO, TOPDOWN_PTRS, N, H, W, Hh, Wh, s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    if (CI % 8 != 0 || CS < 1 || CO < 1) return (int)cudaErrorInvalidValue;
    if (is_bf16)
        return launch_gen_ncb<__nv_bfloat16>(ncb, TOPDOWN_PTRS, N, H, W, Hh, Wh, CI, CS, CO, s);
    return launch_gen_ncb<float>(ncb, TOPDOWN_PTRS, N, H, W, Hh, Wh, CI, CS, CO, s);
}
