// K6: 3x3, stride-1, pad-1 convolution with a fused per-channel scale, bias
// and ReLU: the eval-mode ConvBnReLU once the BatchNorm's running statistics
// are folded into `scale` and `bias`.
//
// Replaces the TPU kernel
//   deep_reconstruction_with_epipolar_lines_mvster_tpu/ops/pallas/reg_band_proto.py:89
//   band_conv3x3 (_kernel :56, pallas_call :111),
// and computes, for x [N, H, W, Ci] (NHWC, float32 or bf16) and the OIHW
// float32 weight w [Co, Ci, 3, 3] rounded to x's dtype,
//   acc[n, y, x, co] = sum_{ky, kx, ci} x[n, y+ky-1, x+kx-1, ci] * w[co, ci, ky, kx]
//   out[n, y, x, co] = max(acc * scale[co] + bias[co], 0)
// with zero padding, the sum in float32 and one rounding to x's dtype at
// the end.
//
// The TPU kernel lays channels in sublanes and width in lanes
// ([N, H, Ci, W], W padded to 128), turns the row and channel contraction
// into three banded matmuls on the MXU, and relies on zero lane padding and
// two column masks for the borders. None of that carries over: on Hopper the
// kernel has three routes.
//
// The float32 route (band_conv_kernel_f32, any Ci and Co) is a direct
// convolution with float32 FMAs on the CUDA cores, bound by operations at
// 8-64 channels (the pipeline's conv1.x and conv2.x: 90 us each at B4 at 67
// TFLOP/s) and by bytes at 3-8 (conv0.x, Reg2D.conv0 at 512x640: the
// output's writes). Its first design, a thread per pixel over a 16 x 16
// tile, read one shared float and Co/4 float4 weights per Co FMAs (three
// shared-memory instructions per eight FMAs at Co 8, so the load pipe and
// not the FMA pipe set the pace), staged its halo element by element with a
// division per element, and did so in series with its math: 2.275 ms per B4
// float32 forward against a 0.639 ms bound (H100 80GB HBM3, 700 W). Now:
//   - Register blocking. A thread owns a strip of 4 output columns x RT = 2
//     rows x 8 output channels (64 float32 sums). Per input channel it reads
//     its RT + 2 halo rows as one float4 each, takes the two edge columns
//     from its neighbours by __shfl (the strip's first and last lane read
//     them), and per tap 8 weights as two float4 broadcasts: 576 FMAs for
//     16 shared-memory instructions and 8 shuffles. These phases run at the
//     FMA pipe's rate.
//   - Tiles of 64 columns. A warp covers 64 x 2 RT outputs of one 8-channel
//     group, the CTA's 4 warps (8 at Co over 32) COG groups (Co <= 8 COG, a
//     pass of up to 64 channels; wider Co loops over passes) of RQ = 4 /
//     COG warps (1 at COG 4 and 8): tiles of 16, 8, 4 and 4 rows. CTAs of 8
//     warps (32 / COG rows: a 1.10x halo at 32 rows against 1.19x at 16)
//     took as long or longer at every layer of the pipeline but conv2.x at
//     B4 (3% faster; H100 80GB HBM3, 700 W). Where a launch would have
//     fewer work items than two a SM, a thread owns RT = 1 row and the tile
//     half the rows: Reg2D.conv0 at stage 1 of one pipeline view (8 images
//     of 64x80) 32 tiles of 32 rows took 14.4 us, 64 of 16 rows 10.6 us, 128
//     of 8 rows at RT 1 7.5 us (the first design's 16 x 16 tiles: 9.1).
//   - A unit of work is (tile, CIC = 4 or 8 input channels), so that shared
//     memory stays fixed for any Ci and Co. Persistent CTAs, four a SM, copy
//     the next unit while the FMAs run on this one: by TMA, one tensor copy
//     of the halo (the hardware fills zeros outside the image and past Ci)
//     and one of the weights, issued by one thread against an mbarrier. The
//     first copy path, 4-byte cp.async of every element, cost more cycles to
//     issue than the FMAs took (an LDGSTS per element, few in flight a warp).
//     A halo lands as the pixels lie in memory ([row][column][channel]); one
//     pass transposes it into the channel planes the strips read ([c][row]
//     [column], rows of 72 floats so that a strip's float4 is aligned,
//     planes padded so that the writes fall on 32 banks) and the weights
//     into [c][tap][co].
//   - Epilogue: acc * scale + bias and the ReLU, two roundings as the plain
//     version's; the tile, a thread's row at a time, goes through shared memory
//     (XOR-swizzled 16-byte chunks) so that the stores cover whole runs of
//     pixels. Each thread storing its own 4 pixels as 16-byte pieces sent
//     32 separate half-sector writes per instruction to L2 and made the
//     epilogue the largest phase.
//   - Copy paths by shape: a 4-D map of x [N, H, W, Ci] at Ci % 4 == 0; a
//     3-D map [N, H, W Ci] at Ci <= 3, whose rows start on 16 bytes (TMA
//     faults otherwise); 4-byte cp.async for any other Ci, or where x or w
//     are not 16-byte aligned. At conv0.0 (Ci 3) the 3-D map took 115 us at
//     B4 and 38 us a pipeline view against cp.async's 159 and 50.
// The sum over (ci, ky, kx) runs in another order than the convolution
// library's, within TOLERANCE. At B4 the route's 10 layers of at most 32
// channels take 1.31 ms (H100 80GB HBM3, 700 W, tools/ab_eval_forward.py
// --path kernels): the FMA phases run at the pipe's rate, but copy issue,
// transpose and epilogue are phases of each unit too, and four CTAs a SM
// overlap them only in part.
//
// The direct form of the first design (band_conv_kernel) remains for bf16
// with Ci or Co over 64 only, off the path at every FPN width the flagship
// runs in bf16.
//
// The bf16 route (band_conv_kernel_mma, Ci and Co <= 64) is an implicit GEMM on
// the tensor cores, mma.sync m16n8k16 with bf16 inputs and float32
// accumulators: M = 16 output pixels of a tile row, N = Co padded to a
// multiple of 8 (NT n-tiles), K = 9 taps x Ci padded to CIP (8, 16, 32 or
// 64): two taps per k16 step at CIP 8, CIP / 16 steps per tap above.
//   - Tiles of 64 output columns x 16 rows (8 at CIP 32, 4 at CIP 64), so
//     the 18 x 66 halo costs 1.16x the input reads at CIP <= 16. The whole
//     halo, all CIP channels, stays in shared memory, pixel-major, 16-byte
//     chunks XOR-swizzled by the pixel index so that the eight rows of an
//     ldmatrix phase fall on eight bank groups at every one-pixel shift.
//   - Persistent CTAs of 8 warps, as many as fit on the card, each walking
//     tiles with two halo buffers: the next tile's halo loads while the
//     MMAs run on this one's (a one-tile CTA left its loads and its MMAs
//     in series: 2.8-6x the byte bound at 8-16 channels).
//   - Staging: cp.async in 16-byte chunks where Ci % 8 == 0, zero outside
//     the image and past Ci; at Ci = 3 or 4 (no 16-byte chunk of such a
//     pixel is aligned) each thread builds a pixel's 16-byte chunk from its
//     channels (one 8-byte load at Ci = 4) and stores it once.
//   - A tap is the halo window shifted by (dy, dx): one ldmatrix.x4 a
//     16-pixel m-tile, each lane giving the address of its pixel, so the
//     shift costs nothing.
//   - B fragments built once per CTA from the float32 weight (rounded to
//     bf16) into shared memory, 8 bytes a lane, read conflict-free in the
//     k-loop: no packing pass on the host, whose three small launches a
//     call cost more than the kernel at the small Reg2D layers, and none of
//     the register pressure of building them in the k-loop (255 registers
//     and spills at CIP 64).
//   - Epilogue: acc * scale + bias and the ReLU in float32, as the direct
//     form's two roundings, one bf16 rounding, 4-byte stores that cover
//     whole 16-byte channel runs of 8 pixels per warp instruction.
// wgmma is not needed: at N = Co <= 64 the layers are bound by bytes.

#include <stdint.h>

#include <algorithm>

#include <cuda.h>   // CUtensorMap; the driver's encoder is looked up at run time

#include "common.cuh"

namespace {

using port::cp_async16;
using port::cp_async4;
using port::ldmatrix_x4;
using port::mma_bf16;
using port::pack_bf16;
using port::store1;

// ------------------------------------------- bf16 over 64 channels, direct

constexpr int TILE = 16;                 // output tile TILE x TILE, a thread per pixel
constexpr int HALO = TILE + 2;
constexpr int HALO_PIX = HALO * HALO;
constexpr int CI_CHUNK = 16;
constexpr int THREADS = TILE * TILE;

// a float32 weight rounded to bf16, as the plain version's weight.to(x.dtype)
__device__ __forceinline__ float as_bf16(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// COB consecutive output channels of one pixel as 16-byte stores
template <int COB>
__device__ __forceinline__ void store_vec(__nv_bfloat16* o, const float r[COB]) {
#pragma unroll
    for (int q = 0; q < COB / 8; ++q) {
        uint4 v;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(r[8 * q + 2 * i], r[8 * q + 2 * i + 1]);
        reinterpret_cast<uint4*>(o)[q] = v;
    }
}

template <int COB>
__global__ void __launch_bounds__(THREADS) band_conv_kernel(
    const __nv_bfloat16* __restrict__ x,   // [N, H, W, Ci]
    const float* __restrict__ w,        // [Co, Ci, 3, 3]
    const float* __restrict__ scale,    // [Co]
    const float* __restrict__ bias,     // [Co]
    __nv_bfloat16* __restrict__ out,       // [N, H, W, Co]
    int H, int W, int Ci, int Co) {
    __shared__ float s_x[CI_CHUNK * HALO_PIX];                 // [ci][halo pixel]
    __shared__ __align__(16) float s_w[9 * CI_CHUNK * COB];    // [k][ci][co]
    const int n = blockIdx.z;
    const int y0 = blockIdx.y * TILE, x0 = blockIdx.x * TILE;
    const int tid = threadIdx.x;
    const int ty = tid / TILE, tx = tid % TILE;
    const int oy = y0 + ty, ox = x0 + tx;
    const __nv_bfloat16* xn = x + (long long)n * H * W * Ci;
    const bool vec = (Co % 8 == 0);

    for (int co0 = 0; co0 < Co; co0 += COB) {
        const int nco = min(COB, Co - co0);
        float acc[COB];
#pragma unroll
        for (int c = 0; c < COB; ++c) acc[c] = 0.0f;
        for (int ci0 = 0; ci0 < Ci; ci0 += CI_CHUNK) {
            const int nci = min(CI_CHUNK, Ci - ci0);
            __syncthreads();   // the previous chunk's readers are done
            // the halo, channel fastest as in device memory, so that a warp
            // reads a contiguous run of each halo row; zero outside the image
            for (int i = tid; i < HALO_PIX * nci; i += THREADS) {
                const int c = i % nci, p = i / nci;
                const int hy = y0 - 1 + p / HALO, hx = x0 - 1 + p % HALO;
                float v = 0.0f;
                if (hy >= 0 && hy < H && hx >= 0 && hx < W)
                    v = port::ldg1(xn + ((long long)hy * W + hx) * Ci + ci0 + c);
                s_x[c * HALO_PIX + p] = v;
            }
            // the chunk's weights, zero past Ci and Co
            for (int i = tid; i < 9 * CI_CHUNK * COB; i += THREADS) {
                const int co = i % COB, ci = (i / COB) % CI_CHUNK, k = i / (COB * CI_CHUNK);
                float v = 0.0f;
                if (co < nco && ci < nci)
                    v = as_bf16(__ldg(w + ((long long)(co0 + co) * Ci + ci0 + ci) * 9 + k));
                s_w[i] = v;
            }
            __syncthreads();
            for (int ci = 0; ci < nci; ++ci) {
                const float* sx = s_x + ci * HALO_PIX + ty * HALO + tx;
#pragma unroll
                for (int k = 0; k < 9; ++k) {
                    const float v = sx[(k / 3) * HALO + k % 3];
                    const float4* wk =
                        reinterpret_cast<const float4*>(s_w + (k * CI_CHUNK + ci) * COB);
#pragma unroll
                    for (int q = 0; q < COB / 4; ++q) {
                        const float4 wq = wk[q];
                        acc[4 * q] = fmaf(v, wq.x, acc[4 * q]);
                        acc[4 * q + 1] = fmaf(v, wq.y, acc[4 * q + 1]);
                        acc[4 * q + 2] = fmaf(v, wq.z, acc[4 * q + 2]);
                        acc[4 * q + 3] = fmaf(v, wq.w, acc[4 * q + 3]);
                    }
                }
            }
        }
        if (oy < H && ox < W) {
            // acc * scale + bias as two roundings (the plain version's mul
            // and add), then ReLU that keeps a NaN, as torch.relu does
            float r[COB];
#pragma unroll
            for (int c = 0; c < COB; ++c) {
                const float s = c < nco ? __ldg(scale + co0 + c) : 0.0f;
                const float b = c < nco ? __ldg(bias + co0 + c) : 0.0f;
                const float v = __fadd_rn(__fmul_rn(acc[c], s), b);
                r[c] = v < 0.0f ? 0.0f : v;
            }
            __nv_bfloat16* o = out + (((long long)n * H + oy) * W + ox) * Co + co0;
            if (vec && nco == COB) {
                store_vec<COB>(o, r);
            } else {
#pragma unroll
                for (int c = 0; c < COB; ++c)
                    if (c < nco) store1(o + c, r[c]);
            }
        }
    }
}

// ---------------------------------------------------- float32, CUDA cores

constexpr int F32_TC = 64;                       // output columns per tile
constexpr int F32_HC = F32_TC + 2;               // halo columns
constexpr int F32_RS = 72;                       // floats a halo row of a plane
constexpr unsigned FULL = 0xffffffffu;

// The instance for COG groups of 8 output channels a pass and RQ row quads:
// a warp covers 4 tile rows of one group, the CTA COG groups of RQ warps
// (32 COG RQ threads, 4 RQ tile rows); input channels a unit; and the plane
// stride, = 32 / CIC mod 32 floats so that a warp's transpose writes (32 /
// CIC columns x CIC channels) fall on 32 banks
template <int COG, int RQ> __host__ __device__ constexpr int f32_threads() {
    return 32 * COG * RQ;
}
template <int RQ, int RT> __host__ __device__ constexpr int f32_rows() { return 2 * RT * RQ; }
template <int COG> __host__ __device__ constexpr int f32_cic() { return COG == 1 ? 4 : 8; }
template <int COG, int RQ, int RT> __host__ __device__ constexpr int f32_plane() {
    return (f32_rows<RQ, RT>() + 2) * F32_RS + (32 / f32_cic<COG>() + 16) % 32;
}
// the planes and the unit's weights [c][tap][co] the FMAs read, also the
// staging of half a tile's outputs
template <int COG, int RQ, int RT> __host__ __device__ constexpr int f32_planar_floats() {
    return std::max(f32_cic<COG>() * f32_plane<COG, RQ, RT>() + 9 * f32_cic<COG>() * 8 * COG,
                    2 * RQ * F32_TC * 8 * COG);
}
// Where work item t lies: pass (output channels co0..), image n, tile
// (r0, c0); the items of one pass run over the tiles of every image.
struct F32Item {
    int n, r0, c0, co0;
};

template <int COG, int RQ, int RT>
__device__ __forceinline__ F32Item f32_item(int t, int N, int tiles_y, int tiles_x) {
    const int per_image = tiles_y * tiles_x, tiles = N * per_image;
    const int pass = t / tiles, r = t - pass * tiles;
    const int n = r / per_image, q = r - n * per_image;
    return {n, (q / tiles_x) * f32_rows<RQ, RT>(), (q % tiles_x) * F32_TC, pass * 8 * COG};
}

// the next unit as copied, at 128-byte aligned offsets (TMA's): the halo
// [row][column][channel] (pixel stride CIC, row stride 66 CIC; Ci <= 3 by
// the 3-D map: pixel stride Ci, rows of F32_BX3 floats), then the weights
// [co][c * 9 + tap] (row stride 9 CIC from TMA, 9 CIC + 1 from cp.async:
// conflict-free transpose reads)
constexpr int F32_BX3 = 204;                     // >= 3 + 66 * 3, a multiple of 4
__host__ __device__ constexpr int round32(int n) { return (n + 31) / 32 * 32; }
template <int COG, int RQ, int RT> __host__ __device__ constexpr int f32_raw_x_floats() {
    return round32((f32_rows<RQ, RT>() + 2) * F32_HC * f32_cic<COG>());
}
template <int COG> __host__ __device__ constexpr int f32_raw_w_floats() {
    return 8 * COG * (9 * f32_cic<COG>() + 1);
}
template <int COG, int RQ, int RT> __host__ __device__ constexpr size_t f32_smem_bytes() {
    return ((size_t)round32(f32_planar_floats<COG, RQ, RT>()) + f32_raw_x_floats<COG, RQ, RT>()
            + f32_raw_w_floats<COG>()) * sizeof(float) + 16;   // + the mbarrier
}

// How a launch copies its units: TMA (a 4-D map [N, H, W, Ci] of x at Ci %
// 4 == 0 with a 2-D map [Co, 9 Ci] of w; a 3-D map [N, H, W Ci] at Ci <= 3,
// weights by cp.async), or cp.async alone, 4 bytes an element (any other
// Ci, or x not 16-byte aligned).
enum F32Mode { F32_CPASYNC = 0, F32_TMA4 = 1, F32_TMA3 = 2 };

// The 3-D map's first element of a halo row: the column before the tile,
// rounded down to 16 bytes (TMA starts a row's copy on a 16-byte boundary)
__device__ __forceinline__ int f32_row_start(int c0, int Ci) { return ((c0 - 1) * Ci) & ~3; }

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\n"
        "bra WAIT;\n"
        "DONE:\n"
        "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// Copy unit (item `it`, input channels ci0 .. ci0 + CIC) into the raw
// buffers, not waited for here. TMA: thread 0 posts the bytes on the
// mbarrier and issues one tensor copy of the halo (zero outside the image
// and past Ci, as the map's bounds give) and, at F32_TMA4, one of the
// weights (zero past Co). cp.async: a warp a halo row, its lanes over
// (column, channel) in memory order, zero outside the image; the weights'
// rows of 9 nci taps.
template <int COG, int RQ, int RT>
__device__ __forceinline__ void f32_copy(float* raw_x, float* raw_w, uint32_t bar,
                                         const CUtensorMap* tmx, const CUtensorMap* tmw,
                                         int mode, const float* __restrict__ x,
                                         const float* __restrict__ w, F32Item it, int ci0,
                                         int H, int W, int Ci, int Co, int tid) {
    constexpr int TR = f32_rows<RQ, RT>(), CIC = f32_cic<COG>();
    constexpr int LOG_CIC = CIC == 4 ? 2 : 3, COP = 8 * COG;
    const int nci = min(CIC, Ci - ci0);
    if (mode != F32_CPASYNC && tid == 0) {
        // the raw buffers' last readers are past a barrier
        const uint32_t xbytes = (mode == F32_TMA4 ? F32_HC * CIC : F32_BX3) * (TR + 2) * 4;
        const uint32_t wbytes = mode == F32_TMA4 ? 9 * CIC * COP * 4 : 0;
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(bar), "r"(xbytes + wbytes) : "memory");
        if (mode == F32_TMA4) {
            asm volatile(
                "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
                " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
                :: "r"(port::smem_addr(raw_x)), "l"(reinterpret_cast<uint64_t>(tmx)), "r"(ci0),
                   "r"(it.c0 - 1), "r"(it.r0 - 1), "r"(it.n), "r"(bar) : "memory");
            asm volatile(
                "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
                " [%0], [%1, {%2, %3}], [%4];\n"
                :: "r"(port::smem_addr(raw_w)), "l"(reinterpret_cast<uint64_t>(tmw)),
                   "r"(9 * ci0), "r"(it.co0), "r"(bar) : "memory");
        } else {
            asm volatile(
                "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
                " [%0], [%1, {%2, %3, %4}], [%5];\n"
                :: "r"(port::smem_addr(raw_x)), "l"(reinterpret_cast<uint64_t>(tmx)),
                   "r"(f32_row_start(it.c0, Ci)), "r"(it.r0 - 1), "r"(it.n), "r"(bar)
                : "memory");
        }
    }
    if (mode == F32_CPASYNC) {
        const int warp = tid >> 5, lane = tid & 31;
        const float* xn = x + (long long)it.n * H * W * Ci + ci0;
        for (int hr = warp; hr < TR + 2; hr += COG * RQ) {
            const int hy = it.r0 - 1 + hr;
            const bool row_ok = hy >= 0 && hy < H;
            for (int j = lane; j < F32_HC * CIC; j += 32) {
                const int c = j & (CIC - 1), hc = j >> LOG_CIC;
                if (c >= nci) continue;
                const int hx = it.c0 - 1 + hc;
                const bool ok = row_ok && hx >= 0 && hx < W;
                cp_async4(raw_x + (hr * F32_HC + hc) * CIC + c,
                          ok ? xn + ((long long)hy * W + hx) * Ci + c : x, ok);
            }
        }
    }
    if (mode != F32_TMA4) {
        for (int i = tid; i < COP * 9 * CIC; i += f32_threads<COG, RQ>()) {
            const int co = i / (9 * CIC), e = i - co * (9 * CIC);   // constant divisor
            if (e < 9 * nci && it.co0 + co < Co)
                cp_async4(raw_w + co * (9 * CIC + 1) + e,
                          w + ((long long)(it.co0 + co) * Ci + ci0) * 9 + e, true);
        }
    }
    asm volatile("cp.async.commit_group;\n");
}

// Wait for the unit's copies (this thread's cp.async, the mbarrier's phase
// `parity` for TMA), then make every thread's visible.
__device__ __forceinline__ void f32_wait(int mode, uint32_t bar, uint32_t parity) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    if (mode != F32_CPASYNC) mbar_wait(bar, parity);
    __syncthreads();
}

// raw -> planar: the halo into CIC planes [c][row][column + 3] (so that a
// strip's four columns are one aligned float4), the weights into [c][tap][co],
// zero past Co.
template <int COG, int RQ, int RT>
__device__ __forceinline__ void f32_transpose(float* planar, const float* raw_x,
                                              const float* raw_w, int mode, int c0, int Ci,
                                              int nci, int ncop, int tid) {
    constexpr int TR = f32_rows<RQ, RT>(), CIC = f32_cic<COG>(), PS = f32_plane<COG, RQ, RT>();
    constexpr int COP = 8 * COG;
    // a halo pixel a thread, consecutive threads on consecutive columns
    const int off3 = (c0 - 1) * Ci - f32_row_start(c0, Ci);
    for (int i = tid; i < (TR + 2) * F32_HC; i += f32_threads<COG, RQ>()) {
        const int hr = i / F32_HC, hc = i - hr * F32_HC;        // constant divisor
        float* dst = planar + hr * F32_RS + hc + 3;
        if (mode == F32_TMA3) {                  // pixel stride Ci <= 3
            const float* src = raw_x + hr * F32_BX3 + off3 + hc * Ci;
            for (int c = 0; c < Ci; ++c) dst[c * PS] = src[c];
            continue;
        }
        const float4* src = reinterpret_cast<const float4*>(raw_x + i * CIC);
#pragma unroll
        for (int c4 = 0; c4 < CIC / 4; ++c4) {
            const float4 v = src[c4];
            const float vc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int c = 0; c < 4; ++c)
                if (4 * c4 + c < nci) dst[(4 * c4 + c) * PS] = vc[c];
        }
    }
    const int rws = mode == F32_TMA4 ? 9 * CIC : 9 * CIC + 1;
    float* pw = planar + CIC * PS;
    for (int i = tid; i < 9 * CIC * COP; i += f32_threads<COG, RQ>()) {
        const int co = i % COP, e = i / COP;    // e = c * 9 + tap
        pw[i] = co < ncop && e < 9 * nci ? raw_w[co * rws + e] : 0.0f;
    }
}

// Persistent: CTA b takes work items b, b + gridDim.x, ..., each in units of
// CIC input channels. The copies of unit u + 1 are in flight while the FMAs
// run on unit u; then they are transposed into the planes.
template <int COG, int RQ, int RT>
__global__ void __launch_bounds__(f32_threads<COG, RQ>(), 512 / f32_threads<COG, RQ>())
band_conv_kernel_f32(
    const float* __restrict__ x,        // [N, H, W, Ci]
    const float* __restrict__ w,        // [Co, Ci, 3, 3]
    const float* __restrict__ scale,    // [Co]
    const float* __restrict__ bias,     // [Co]
    float* __restrict__ out,            // [N, H, W, Co]
    int N, int H, int W, int Ci, int Co,
    const __grid_constant__ CUtensorMap tmx,   // x, for TMA (mode)
    const __grid_constant__ CUtensorMap tmw,   // w, for TMA at F32_TMA4
    int mode) {
    constexpr int TR = f32_rows<RQ, RT>(), CIC = f32_cic<COG>(), PS = f32_plane<COG, RQ, RT>();
    constexpr int COP = 8 * COG, QC = COP / 4;
    constexpr int LOG_QC = COG == 1 ? 1 : COG == 2 ? 2 : COG == 4 ? 3 : 4;
    extern __shared__ float4 smem_f32[];
    float* const planar = reinterpret_cast<float*>(smem_f32);
    float* const raw_x = planar + round32(f32_planar_floats<COG, RQ, RT>());
    float* const raw_w = raw_x + f32_raw_x_floats<COG, RQ, RT>();
    const uint32_t bar = port::smem_addr(raw_w + f32_raw_w_floats<COG>());
    uint32_t parity = 0;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int cg = warp % COG;                   // the warp's 8 output channels
    const int strip = lane & 15;                 // columns 4 strip .. 4 strip + 3
    const int lr = (warp / COG) * 2 * RT + (lane >> 4) * RT;   // tile rows lr .. lr + RT - 1
    const int tiles_x = (W + F32_TC - 1) / F32_TC, tiles_y = (H + TR - 1) / TR;
    const int items = N * tiles_y * tiles_x * ((Co + COP - 1) / COP);
    const int nch = (Ci + CIC - 1) / CIC;

    int t = blockIdx.x;
    if (t >= items) return;
    if (tid == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    F32Item it = f32_item<COG, RQ, RT>(t, N, tiles_y, tiles_x);
    f32_copy<COG, RQ, RT>(raw_x, raw_w, bar, &tmx, &tmw, mode, x, w, it, 0, H, W, Ci, Co, tid);
    f32_wait(mode, bar, parity);
    parity ^= 1;
    f32_transpose<COG, RQ, RT>(planar, raw_x, raw_w, mode, it.c0, Ci, min(CIC, Ci), min(COP, Co - it.co0),
                       tid);
    __syncthreads();

    float acc[RT][4][8];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[r][p][q] = 0.0f;

    int ch = 0;
#pragma unroll 1
    for (;;) {
        // the next unit: this item's next chunk, or the next item's first
        int t_next = t, ch_next = ch + 1;
        if (ch_next == nch) {
            ch_next = 0;
            t_next = t + gridDim.x;
        }
        const F32Item it_next =
            t_next < items ? f32_item<COG, RQ, RT>(t_next, N, tiles_y, tiles_x) : it;
        if (t_next < items)
            f32_copy<COG, RQ, RT>(raw_x, raw_w, bar, &tmx, &tmw, mode, x, w, it_next, ch_next * CIC, H,
                          W, Ci, Co, tid);

        const float* sw = planar + CIC * PS + cg * 8;
        const int nci = min(CIC, Ci - ch * CIC);
#pragma unroll 1
        for (int c = 0; c < nci; ++c) {
            // halo rows lr .. lr + RT + 1, columns 4 strip - 1 .. 4 strip + 4
            const float* xc = planar + c * PS + lr * F32_RS + 4 * strip + 4;
            float e[RT + 2][6];
#pragma unroll
            for (int j = 0; j < RT + 2; ++j) {
                const float4 v = *reinterpret_cast<const float4*>(xc + j * F32_RS);
                float left = __shfl_up_sync(FULL, v.w, 1, 16);
                float right = __shfl_down_sync(FULL, v.x, 1, 16);
                if (strip == 0) left = xc[j * F32_RS - 1];
                if (strip == 15) right = xc[j * F32_RS + 4];
                e[j][0] = left; e[j][1] = v.x; e[j][2] = v.y;
                e[j][3] = v.z; e[j][4] = v.w; e[j][5] = right;
            }
#pragma unroll
            for (int k = 0; k < 9; ++k) {
                const float4 wa = *reinterpret_cast<const float4*>(sw + (c * 9 + k) * COP);
                const float4 wb = *reinterpret_cast<const float4*>(sw + (c * 9 + k) * COP + 4);
                const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
                const int ky = k / 3, kx = k % 3;
#pragma unroll
                for (int r = 0; r < RT; ++r)
#pragma unroll
                    for (int p = 0; p < 4; ++p)
#pragma unroll
                        for (int q = 0; q < 8; ++q)
                            acc[r][p][q] = fmaf(e[r + ky][p + kx], wv[q], acc[r][p][q]);
            }
        }

        if (ch == nch - 1) {
            // acc * scale + bias as two roundings (the plain version's mul
            // and add), then ReLU that keeps a NaN, as torch.relu does; half
            // a tile (rows of one parity) at a time through shared memory, so
            // that the stores cover whole runs of pixels:
            // float4 f = (row / 2, pixel, channel / 4) at f ^ ((pixel >> 2) & 7)
            const int cob = it.co0 + cg * 8;
            float sc[8], bs[8];
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                sc[q] = cob + q < Co ? __ldg(scale + cob + q) : 0.0f;
                bs[q] = cob + q < Co ? __ldg(bias + cob + q) : 0.0f;
            }
            float4* stage = reinterpret_cast<float4*>(planar);
#pragma unroll
            for (int r = 0; r < RT; ++r) {
                __syncthreads();                 // the planes, or the last half, are read
#pragma unroll
                for (int p = 0; p < 4; ++p) {
                    const int px = 4 * strip + p;
                    float v[8];
#pragma unroll
                    for (int q = 0; q < 8; ++q) {
                        const float a = __fadd_rn(__fmul_rn(acc[r][p][q], sc[q]), bs[q]);
                        v[q] = a < 0.0f ? 0.0f : a;
                    }
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int f = ((lr / RT) * 64 + px) * QC + cg * 2 + h;
                        stage[f ^ ((px >> 2) & 7)] =
                            make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
                    }
                }
                __syncthreads();
#pragma unroll
                for (int f = tid; f < (TR / RT) * 64 * QC; f += f32_threads<COG, RQ>()) {
                    const int q4 = f & (QC - 1), px = (f >> LOG_QC) & 63, sr = f >> (LOG_QC + 6);
                    const int oy = it.r0 + RT * sr + r, ox = it.c0 + px, co = it.co0 + 4 * q4;
                    if (oy >= H || ox >= W || co >= Co) continue;
                    const float4 v = stage[f ^ ((px >> 2) & 7)];
                    float* o = out + (((long long)it.n * H + oy) * W + ox) * Co + co;
                    if (Co % 4 == 0) {
                        *reinterpret_cast<float4*>(o) = v;
                    } else {
                        const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                        for (int e4 = 0; e4 < 4; ++e4)
                            if (co + e4 < Co) o[e4] = vv[e4];
                    }
                }
            }
#pragma unroll
            for (int r = 0; r < RT; ++r)
#pragma unroll
                for (int p = 0; p < 4; ++p)
#pragma unroll
                    for (int q = 0; q < 8; ++q) acc[r][p][q] = 0.0f;
        }
        if (t_next >= items) break;
        f32_wait(mode, bar, parity);             // the next unit has landed, the planes are read
        parity ^= 1;
        f32_transpose<COG, RQ, RT>(planar, raw_x, raw_w, mode, it_next.c0, Ci,
                           min(CIC, Ci - ch_next * CIC), min(COP, Co - it_next.co0), tid);
        __syncthreads();                         // the planes hold the next unit, raw is free
        t = t_next;
        ch = ch_next;
        it = it_next;
    }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q)
                == cudaSuccess && q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// A float32 tensor map of `rank` dims (innermost first, sizes in elements,
// strides of dims 1.. in bytes), box `box`, zero outside the tensor.
bool encode_f32(CUtensorMap* map, int rank, const void* base, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box) {
    const EncodeTiled encode = tensor_map_encoder();
    const cuuint32_t ones[4] = {1, 1, 1, 1};
    return encode != nullptr
           && encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, (cuuint32_t)rank,
                     const_cast<void*>(base), dims, strides, box, ones,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// How a float32 launch runs: COG, the fewest groups of 8 output channels
// that cover Co (at most 8: a pass of 64, wider Co loops over passes); RQ
// warps a group (the CTA's warps COG x RQ) of RT rows a thread (a warp 2 RT
// tile rows); its work items (tile, pass); and its copy mode (F32Mode).
struct F32Plan {
    int cog, rq, rt, mode;
    long long items;
};

long long f32_items(int N, int H, int W, int Co, int cog, int rq, int rt) {
    const int tr = 2 * rt * rq;
    return (long long)N * ((H + tr - 1) / tr) * ((W + F32_TC - 1) / F32_TC)
           * ((Co + 8 * cog - 1) / (8 * cog));
}

// CTAs of 4 warps (8 at COG 8), 2 rows a thread; 1 row a thread where the
// items would be fewer than two a SM.
F32Plan f32_plan(int N, int H, int W, int Ci, int Co, bool aligned, int sms) {
    F32Plan p;
    p.cog = Co <= 8 ? 1 : Co <= 16 ? 2 : Co <= 32 ? 4 : 8;
    p.rq = std::max(1, 4 / p.cog);
    p.rt = 2;
    if (f32_items(N, H, W, Co, p.cog, p.rq, p.rt) < 2LL * sms) p.rt = 1;
    p.items = f32_items(N, H, W, Co, p.cog, p.rq, p.rt);
    p.mode = aligned && Ci % 4 == 0                    ? F32_TMA4
             : aligned && Ci <= 3 && W * Ci % 4 == 0 ? F32_TMA3
                                                      : F32_CPASYNC;
    return p;
}

// the card's SMs, read once (the port runs on one card)
int sm_count(int* sms) {
    static int count = 0;
    if (count == 0) {
        int dev = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return (int)e;
    }
    *sms = count;
    return 0;
}

// The persistent grid: the CTAs that fit on the card at once (512 / 32 COG
// RQ a SM by the launch bounds), found once per instance with the
// shared-memory limit set.
template <int COG, int RQ, int RT>
int launch_f32(const void* x, const float* w, const float* scale, const float* bias, void* out,
               int N, int H, int W, int Ci, int Co, const F32Plan& p, cudaStream_t stream) {
    auto kernel = band_conv_kernel_f32<COG, RQ, RT>;
    const size_t bytes = f32_smem_bytes<COG, RQ, RT>();
    static int resident = 0;
    if (resident == 0) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)bytes);
        int dev = 0, sms = 0, per_sm = 0;
        if (e == cudaSuccess) e = cudaGetDevice(&dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                              f32_threads<COG, RQ>(), bytes);
        if (e != cudaSuccess) return (int)e;
        resident = sms * std::max(per_sm, 1);
    }
    if (p.items >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    const long long grid = std::min<long long>(p.items, resident);
    constexpr int TR = f32_rows<RQ, RT>(), CIC = f32_cic<COG>();
    CUtensorMap tmx{}, tmw{};
    const cuuint64_t n = N, h = H, wd = W, ci = Ci, co = Co;
    if (p.mode == F32_TMA4) {
        const cuuint64_t xdims[4] = {ci, wd, h, n};
        const cuuint64_t xstr[3] = {ci * 4, wd * ci * 4, h * wd * ci * 4};
        const cuuint32_t xbox[4] = {CIC, F32_HC, TR + 2, 1};
        const cuuint64_t wdims[2] = {9 * ci, co}, wstr[1] = {9 * ci * 4};
        const cuuint32_t wbox[2] = {9 * CIC, 8 * COG};
        if (!encode_f32(&tmx, 4, x, xdims, xstr, xbox)
                || !encode_f32(&tmw, 2, w, wdims, wstr, wbox))
            return (int)cudaErrorInvalidValue;
    } else if (p.mode == F32_TMA3) {
        const cuuint64_t xdims[3] = {wd * ci, h, n}, xstr[2] = {wd * ci * 4, h * wd * ci * 4};
        const cuuint32_t xbox[3] = {F32_BX3, TR + 2, 1};
        if (!encode_f32(&tmx, 3, x, xdims, xstr, xbox)) return (int)cudaErrorInvalidValue;
    }
    kernel<<<(unsigned)grid, f32_threads<COG, RQ>(), bytes, stream>>>(
        static_cast<const float*>(x), w, scale, bias, static_cast<float*>(out), N, H, W, Ci, Co,
        tmx, tmw, p.mode);
    return (int)cudaGetLastError();
}

// the instance of plan p
template <int COG, int RQ>
int launch_f32_rt(const void* x, const float* w, const float* scale, const float* bias,
                  void* out, int N, int H, int W, int Ci, int Co, const F32Plan& p,
                  cudaStream_t s) {
    if (p.rq != RQ) return (int)cudaErrorInvalidValue;
    if (p.rt == 2) return launch_f32<COG, RQ, 2>(x, w, scale, bias, out, N, H, W, Ci, Co, p, s);
    return launch_f32<COG, RQ, 1>(x, w, scale, bias, out, N, H, W, Ci, Co, p, s);
}

int launch_f32_plan(const void* x, const float* w, const float* scale, const float* bias,
                    void* out, int N, int H, int W, int Ci, int Co, cudaStream_t s) {
    int sms = 0;
    const int e = sm_count(&sms);
    if (e != 0) return e;
    const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0
                         && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    const F32Plan p = f32_plan(N, H, W, Ci, Co, aligned, sms);
    switch (p.cog) {
        case 1: return launch_f32_rt<1, 4>(x, w, scale, bias, out, N, H, W, Ci, Co, p, s);
        case 2: return launch_f32_rt<2, 2>(x, w, scale, bias, out, N, H, W, Ci, Co, p, s);
        case 4: return launch_f32_rt<4, 1>(x, w, scale, bias, out, N, H, W, Ci, Co, p, s);
        default: return launch_f32_rt<8, 1>(x, w, scale, bias, out, N, H, W, Ci, Co, p, s);
    }
}

// ------------------------------------------------------ bf16, tensor cores

constexpr int MMA_THREADS = 256;
constexpr int MTC = 64;                          // output columns per tile

// output rows per tile: a halo of CIP channels stays near 20-50 KB a buffer
template <int CIP> __host__ __device__ constexpr int mma_rows() {
    return CIP <= 16 ? 16 : CIP == 32 ? 8 : 4;
}

template <int CIP>
__host__ __device__ constexpr size_t mma_buffer_bytes() {
    return (size_t)(mma_rows<CIP>() + 2) * (MTC + 2) * CIP * 2;
}

// the B fragments of all k-steps and n-tiles, 8 bytes a lane
template <int CIP>
__host__ __device__ constexpr int mma_ksteps() { return CIP == 8 ? 5 : 9 * (CIP / 16); }

template <int CIP, int NT>
__host__ __device__ constexpr size_t mma_smem_bytes() {
    return 2 * mma_buffer_bytes<CIP>() + (size_t)mma_ksteps<CIP>() * NT * 32 * 8;
}

// byte offset of 16-byte chunk c of halo pixel p (NCH chunks a pixel)
template <int NCH>
__device__ __forceinline__ int swz(int p, int c) {
    constexpr int SSH = NCH == 8 ? 0 : NCH == 4 ? 1 : NCH == 2 ? 2 : 3;
    return (p * NCH + (c ^ ((p >> SSH) & (NCH - 1)))) * 16;
}

// Stage the halo of tile (n, r0, c0) into xs, zero outside the image and
// past Ci: cp.async 16-byte chunks where Ci % 8 == 0 (not waited for here),
// else one 16-byte shared store per chunk, built from the pixel's channels.
template <int CIP>
__device__ __forceinline__ void stage_halo(char* xs, const __nv_bfloat16* x, int n, int r0,
                                           int c0, int H, int W, int Ci, int tid) {
    constexpr int HC = MTC + 2, NPX = (mma_rows<CIP>() + 2) * HC, NCH = CIP / 8;
    const __nv_bfloat16* xn = x + (long long)n * H * W * Ci;
    if (Ci % 8 == 0) {
        for (int i = tid; i < NPX * NCH; i += MMA_THREADS) {
            const int p = i / NCH, c = i % NCH;
            const int hy = r0 - 1 + p / HC, hx = c0 - 1 + p % HC;
            const bool ok = hy >= 0 && hy < H && hx >= 0 && hx < W && c * 8 < Ci;
            cp_async16(xs + swz<NCH>(p, c),
                       xn + (ok ? ((long long)hy * W + hx) * Ci + c * 8 : 0), ok);
        }
        return;
    }
    if (Ci == 4) {                               // one aligned 8-byte load a pixel
        const uint2* xr = reinterpret_cast<const uint2*>(xn);
#pragma unroll 4
        for (int p = tid; p < NPX; p += MMA_THREADS) {
            const int hy = r0 - 1 + p / HC, hx = c0 - 1 + p % HC;
            const bool ok = hy >= 0 && hy < H && hx >= 0 && hx < W;
            const uint2 v = ok ? __ldg(xr + (long long)hy * W + hx) : make_uint2(0u, 0u);
            *reinterpret_cast<uint4*>(xs + swz<NCH>(p, 0)) = make_uint4(v.x, v.y, 0u, 0u);
        }
        return;
    }
    const unsigned short* xr = reinterpret_cast<const unsigned short*>(xn);
#pragma unroll 4
    for (int i = tid; i < NPX * NCH; i += MMA_THREADS) {
        const int p = i / NCH, c = i % NCH;
        const int hy = r0 - 1 + p / HC, hx = c0 - 1 + p % HC;
        const bool ok = hy >= 0 && hy < H && hx >= 0 && hx < W;
        const unsigned short* px = xr + ((long long)hy * W + hx) * Ci + c * 8;
        unsigned short v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = ok && c * 8 + e < Ci ? __ldg(px + e) : 0;
        *reinterpret_cast<uint4*>(xs + swz<NCH>(p, c)) =
            make_uint4(v[0] | (unsigned)v[1] << 16, v[2] | (unsigned)v[3] << 16,
                       v[4] | (unsigned)v[5] << 16, v[6] | (unsigned)v[7] << 16);
    }
}

// The B fragment of `lane` for k-step ks and n-tile j, built from the
// float32 weight [Co, Ci, 3, 3] and rounded to bf16 (as the plain
// version's weight.to(x.dtype)): n = 8j + lane / 4, and k = 2t, 2t + 1
// (b.x), 2t + 8, 2t + 9 (b.y), t = lane % 4. At CIP 8, k-step ks holds taps
// 2 ks (k 0-7) and 2 ks + 1 (k 8-15), 8 channels each; above, tap ks / KCN
// holds channels 16 (ks % KCN) + k. A k past Ci or the taps, or an n past
// Co, is 0.
template <int CIP>
__device__ __forceinline__ uint2 b_frag(const float* __restrict__ w, int ks, int j, int lane,
                                        int Ci, int Co) {
    constexpr int KCN = CIP >= 16 ? CIP / 16 : 1;
    const int n = 8 * j + (lane >> 2), t = lane & 3;
    float v[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
        const int kk = 2 * t + (h & 1) + 8 * (h >> 1);
        const int tap = CIP == 8 ? 2 * ks + (kk >> 3) : ks / KCN;
        const int ch = CIP == 8 ? kk & 7 : (ks % KCN) * 16 + kk;
        v[h] = tap < 9 && ch < Ci && n < Co ? __ldg(w + ((long long)n * Ci + ch) * 9 + tap) : 0.0f;
    }
    return make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

// Persistent: CTA b takes tiles b, b + gridDim.x, ...; the halo of its next
// tile loads into the other of two buffers while the MMAs run on this one.
template <int CIP, int NT>
__global__ void __launch_bounds__(MMA_THREADS) band_conv_kernel_mma(
    const __nv_bfloat16* __restrict__ x,  // [N, H, W, Ci]
    const float* __restrict__ w,          // [Co, Ci, 3, 3]
    const float* __restrict__ scale,      // [Co]
    const float* __restrict__ bias,       // [Co]
    __nv_bfloat16* __restrict__ out,      // [N, H, W, Co]
    int N, int H, int W, int Ci, int Co) {
    constexpr int TR = mma_rows<CIP>();
    constexpr int HC = MTC + 2;
    constexpr int NCH = CIP / 8;                 // 16-byte chunks a pixel
    constexpr int KCN = CIP >= 16 ? CIP / 16 : 1;  // k-steps a tap
    constexpr int KS = mma_ksteps<CIP>();
    constexpr int MTW = TR * (MTC / 16) / 8;     // m-tiles a warp: 8, 4 or 2
    constexpr int MW = MTW < 16 / NT ? MTW : 16 / NT;   // m-tiles a pass
    constexpr size_t BUF = mma_buffer_bytes<CIP>();
    extern __shared__ uint4 smem_mma[];
    char* xs0 = reinterpret_cast<char*>(smem_mma);
    uint2* fb = reinterpret_cast<uint2*>(xs0 + 2 * BUF);   // [KS][NT][32]

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, tq = lane & 3;
    const int tiles_x = (W + MTC - 1) / MTC, tiles_y = (H + TR - 1) / TR;
    const int ntiles = N * tiles_y * tiles_x;

    int t = blockIdx.x;
    if (t >= ntiles) return;
    // the B fragments, once per CTA (read after the loop's first barrier)
    for (int i = tid; i < KS * NT * 32; i += MMA_THREADS)
        fb[i] = b_frag<CIP>(w, i / (NT * 32), (i / 32) % NT, i % 32, Ci, Co);
    stage_halo<CIP>(xs0, x, t / (tiles_y * tiles_x), (t / tiles_x % tiles_y) * TR,
                    (t % tiles_x) * MTC, H, W, Ci, tid);
    asm volatile("cp.async.commit_group;\n");
#pragma unroll 1
    for (int it = 0; t < ntiles; ++it, t += gridDim.x) {
        char* xs = xs0 + (it & 1) * BUF;
        const int tn = t + gridDim.x;
        if (tn < ntiles)
            stage_halo<CIP>(xs0 + ((it + 1) & 1) * BUF, x, tn / (tiles_y * tiles_x),
                            (tn / tiles_x % tiles_y) * TR, (tn % tiles_x) * MTC, H, W, Ci, tid);
        asm volatile("cp.async.commit_group;\n");
        asm volatile("cp.async.wait_group 1;\n");   // this tile's halo has landed
        __syncthreads();

        const int n = t / (tiles_y * tiles_x);
        const int r0 = (t / tiles_x % tiles_y) * TR, c0 = (t % tiles_x) * MTC;
#pragma unroll 1
        for (int m0 = 0; m0 < MTW; m0 += MW) {
            float acc[MW][NT][4];
#pragma unroll
            for (int mi = 0; mi < MW; ++mi)
#pragma unroll
                for (int j = 0; j < NT; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;
#pragma unroll 1
            for (int ks = 0; ks < KS; ++ks) {
                uint2 b[NT];
#pragma unroll
                for (int j = 0; j < NT; ++j) b[j] = fb[(ks * NT + j) * 32 + lane];
                // the tap and the 16-byte chunk this lane addresses: lanes 0-15
                // give k 0-7 of the step, lanes 16-31 k 8-15
                int tap, c;
                if (CIP == 8) {
                    tap = min(2 * ks + (lane >> 4), 8);
                    c = 0;
                } else {
                    tap = ks / KCN;
                    c = 2 * (ks % KCN) + (lane >> 4);
                }
                const int dy = tap / 3, dx = tap % 3;
#pragma unroll
                for (int mi = 0; mi < MW; ++mi) {
                    const int mt = warp * MTW + m0 + mi;
                    const int row = mt / (MTC / 16), cq = mt % (MTC / 16);
                    const int p = (row + dy) * HC + cq * 16 + (lane & 15) + dx;
                    uint32_t a[4];
                    ldmatrix_x4(a, xs + swz<NCH>(p, c));
                    if (CIP == 8 && ks == KS - 1) {  // k 8-15 of the last step: no tap
                        a[2] = 0u;
                        a[3] = 0u;
                    }
#pragma unroll
                    for (int j = 0; j < NT; ++j) mma_bf16(acc[mi][j], a, b[j]);
                }
            }
            // acc * scale + bias, ReLU (keeps a NaN), one bf16 rounding
#pragma unroll
            for (int mi = 0; mi < MW; ++mi) {
                const int mt = warp * MTW + m0 + mi;
                const int orow = r0 + mt / (MTC / 16);
                if (orow >= H) continue;
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int ocol = c0 + (mt % (MTC / 16)) * 16 + gq + 8 * half;
                    if (ocol >= W) continue;
                    __nv_bfloat16* op = out + (((long long)n * H + orow) * W + ocol) * Co;
#pragma unroll
                    for (int j = 0; j < NT; ++j) {
                        const int co = 8 * j + 2 * tq;
                        float r[2];
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const float sc = co + e < Co ? __ldg(scale + co + e) : 0.0f;
                            const float bs = co + e < Co ? __ldg(bias + co + e) : 0.0f;
                            const float v = __fadd_rn(__fmul_rn(acc[mi][j][2 * half + e], sc), bs);
                            r[e] = v < 0.0f ? 0.0f : v;
                        }
                        if (co + 1 < Co && (Co & 1) == 0) {
                            *reinterpret_cast<__nv_bfloat162*>(op + co) =
                                __floats2bfloat162_rn(r[0], r[1]);
                        } else {
                            if (co < Co) store1(op + co, r[0]);
                            if (co + 1 < Co) store1(op + co + 1, r[1]);
                        }
                    }
                }
            }
        }
        __syncthreads();                         // this buffer is free for tile t + 2 grid
    }
}

// The persistent grid: the CTAs that fit on the card at once, found once
// per instance (the port runs on one card) with the shared-memory limit set.
template <int CIP, int NT>
int launch_mma(const void* x, const float* w, const float* scale, const float* bias, void* out,
               int N, int H, int W, int Ci, int Co, cudaStream_t stream) {
    auto kernel = band_conv_kernel_mma<CIP, NT>;
    const size_t bytes = mma_smem_bytes<CIP, NT>();
    static int resident = 0;
    if (resident == 0) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)bytes);
        int dev = 0, sms = 0, per_sm = 0;
        if (e == cudaSuccess) e = cudaGetDevice(&dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, MMA_THREADS, bytes);
        if (e != cudaSuccess) return (int)e;
        resident = sms * std::max(per_sm, 1);
    }
    constexpr int TR = mma_rows<CIP>();
    const long long ntiles = (long long)N * ((H + TR - 1) / TR) * ((W + MTC - 1) / MTC);
    const long long grid = std::min<long long>(ntiles, resident);
    kernel<<<(unsigned)grid, MMA_THREADS, bytes, stream>>>(
        static_cast<const __nv_bfloat16*>(x), w, scale, bias,
        static_cast<__nv_bfloat16*>(out), N, H, W, Ci, Co);
    return (int)cudaGetLastError();
}

template <int CIP>
int launch_mma_nt(int nt, const void* x, const float* w, const float* scale, const float* bias,
                  void* out, int N, int H, int W, int Ci, int Co, cudaStream_t s) {
    switch (nt) {
        case 1: return launch_mma<CIP, 1>(x, w, scale, bias, out, N, H, W, Ci, Co, s);
        case 2: return launch_mma<CIP, 2>(x, w, scale, bias, out, N, H, W, Ci, Co, s);
        case 4: return launch_mma<CIP, 4>(x, w, scale, bias, out, N, H, W, Ci, Co, s);
        case 8: return launch_mma<CIP, 8>(x, w, scale, bias, out, N, H, W, Ci, Co, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// ------------------------------------------------------------- launchers

template <int COB>
int launch(const void* x, const float* w, const float* scale, const float* bias, void* out,
           int N, int H, int W, int Ci, int Co, cudaStream_t stream) {
    const dim3 grid((unsigned)((W + TILE - 1) / TILE), (unsigned)((H + TILE - 1) / TILE),
                    (unsigned)N);
    band_conv_kernel<COB><<<grid, THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), w, scale, bias, static_cast<__nv_bfloat16*>(out),
        H, W, Ci, Co);
    return (int)cudaGetLastError();
}

int launch_co(const void* x, const float* w, const float* scale, const float* bias, void* out,
              int N, int H, int W, int Ci, int Co, cudaStream_t stream) {
    if (Co <= 8) return launch<8>(x, w, scale, bias, out, N, H, W, Ci, Co, stream);
    return launch<16>(x, w, scale, bias, out, N, H, W, Ci, Co, stream);
}

}  // namespace

// x [N, H, W, Ci] -> out [N, H, W, Co], both in one dtype (is_bf16); w
// [Co, Ci, 3, 3], scale and bias [Co], float32. float32 (cip 0): the
// register-blocked route. bf16 with cip > 0: the tensor-core route for cip
// in {8, 16, 32, 64} >= Ci and nt in {1, 2, 4, 8}, 8 nt >= Co; x 16-byte
// aligned. bf16 with cip 0: the direct form. The caller keeps N under 65536
// and out 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int band_conv_launch(const void* x, const float* w, const float* scale,
                                const float* bias, void* out, int N, int H, int W, int Ci,
                                int Co, int is_bf16, int cip, int nt, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (!is_bf16) {
        if (cip > 0) return (int)cudaErrorInvalidValue;
        return launch_f32_plan(x, w, scale, bias, out, N, H, W, Ci, Co, s);
    }
    if (cip > 0) {
        if (Ci > cip || Co > 8 * nt) return (int)cudaErrorInvalidValue;
        switch (cip) {
            case 8: return launch_mma_nt<8>(nt, x, w, scale, bias, out, N, H, W, Ci, Co, s);
            case 16: return launch_mma_nt<16>(nt, x, w, scale, bias, out, N, H, W, Ci, Co, s);
            case 32: return launch_mma_nt<32>(nt, x, w, scale, bias, out, N, H, W, Ci, Co, s);
            case 64: return launch_mma_nt<64>(nt, x, w, scale, bias, out, N, H, W, Ci, Co, s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    return launch_co(x, w, scale, bias, out, N, H, W, Ci, Co, s);
}

// The float32 launch band_conv_launch takes for a shape (f32_plan), x and w
// 16-byte aligned or not: plan[0..4] = output-channel groups a pass (COG),
// tile rows, input channels a unit, work items (tile, pass), copy mode
// (F32Mode). Returns 0, or a CUDA error (no card, or 2^31 items or more).
extern "C" int band_conv_plan(int N, int H, int W, int Ci, int Co, int aligned, int* plan) {
    int sms = 0;
    const int e = sm_count(&sms);
    if (e != 0) return e;
    const F32Plan p = f32_plan(N, H, W, Ci, Co, aligned != 0, sms);
    if (p.items >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    plan[0] = p.cog;
    plan[1] = 2 * p.rt * p.rq;
    plan[2] = p.cog == 1 ? f32_cic<1>() : f32_cic<2>();
    plan[3] = (int)p.items;
    plan[4] = p.mode;
    return 0;
}
