// The deformable 3x3 conv of a DCN head (DCN v1, stride 1, one deformable
// group; models/fpn.DeformConv2d) after its offset conv, in eval and bf16:
//   px = (x + kx) + off[n, y, x, 2t + 1],  py = (y + ky) + off[n, y, x, 2t]
//   s[t, i] = bilinear sample of x[n, :, :, i] at (px, py)  (tap t = 3 ky' + kx')
//   out[n, y, x, o] = sum over t, i of s[t, i] * weight[o, i, ky', kx']
// with core/geometry.grid_sample_2d's rules: pixel coordinates (align
// corners), a corner outside the image contributes 0, a NaN or huge
// coordinate contributes 0. Coordinates, corner weights and the blend are
// float32, in the plain version's order of operations (no FMA), so each
// sample equals the plain version's float32 sample to the bit; it is then
// rounded once to bf16 (the A operand), contracted on the tensor cores
// (mma.sync m16n8k16, bf16 in, float32 accumulate) and the C outputs are
// rounded once to bf16. The plain bf16 route rounds each corner's product
// and each partial sum to bf16 besides.
//
// Replaces no Pallas kernel: the JAX package's DCN is plain jnp, as the
// port's plain version (ops/kernels/deform_conv.deform_conv_ref) is, which
// runs per tap a float32 coordinate, four torch.gathers over an int64
// index, bf16 corner products and sums, then a torch.cat of the nine taps
// into an [N, H, W, 9C] tensor and one matmul: about 250 launches a head,
// and at C 8 a 755 MB intermediate for a 168 MB head.
//
// Bound (benchmark/counts/dcn.py's pieces less the offset conv, a B4 V4
// 512x640 forward, H100 SXM): the four heads read x and write out once,
// 2 P C bf16 values (10.5, 21.0, 42.0, 83.9 MB at C 64, 32, 16, 8), plus
// the 18 offsets a pixel (2.9, 11.8, 47.2, 188.7 MB: no part of the count,
// which puts the offset conv inside the head); 9 P (10 + 7 C) CUDA-core
// FLOPs for the taps (5.5 GFLOP, 0.08 ms at 67 TFLOP/s) and 2 P 9 C C on the
// tensor cores (24 GFLOP, 0.025 ms at 989). So the kernel is bound by the
// CUDA cores' sampling and by bytes, about 0.1 ms for the four heads,
// and a corner is read from L1/L2 up to 36 times a pixel. The design:
//   - A CTA of 256 threads takes tiles of M = 2048 / C pixels, a TY x TX
//     block of one image (16 x 16, 8 x 16, 8 x 8, 4 x 8 at C 8, 16, 32,
//     64; cut at the image's edges): thread u samples pixel u / (C/8) at
//     channels 8 (u % (C/8)) .. +7 for all nine taps, so neighbouring
//     threads read neighbouring bytes of a corner, each corner with one
//     16-byte load through L1 (__ldg). A thread issues the 36 corner loads
//     of its nine taps before it blends any. A tap's coordinate is tested
//     before any float -> int cast; the corners of a tap wholly outside
//     the image weigh 0 and read pixel 0. Corners are read straight from
//     global memory at any offset: no halo tile and no limit on the
//     displacement. A square block keeps the corners that its taps read
//     in fewer rows than a run along one row does, so that they stay in
//     L1 when the offsets are pixels (on an H100, the four heads of a B4
//     V4 512x640 forward at offsets of 4 px std took 1.03 ms in 16 x 16
//     blocks against 1.74 in runs of 256 pixels; at 0.1 px, 0.92 and
//     0.95).
//   - Each sample lands in shared memory as the tile's A rows [M][9C]
//     (rows padded by 8 values: conflict-free ldmatrix and 16-byte stores);
//     no [N, H, W, 9C] tensor exists in device memory. Then the 8 warps
//     contract it: the (M/16) x (C/8) tiles of m16n8 outputs, two a warp,
//     9C/16 k steps (9C rounded up to 16 at C 8, the pad zero).
//   - weight [C, C, 3, 3] float32 is rounded to bf16 and packed as
//     [o][t C + i] into shared memory by every CTA at every launch, so a
//     captured graph reads the parameters as they are at replay; a
//     persistent grid (the CTAs resident at once) packs it once a CTA.
//   - The outputs leave the accumulators as bf16 pairs, two pixels' rows a
//     thread, written once.
// Shared memory: 46.5, 43.8, 56.8 and 112 KB at C 8, 16, 32 and 64.
// C 8, 16, 32, 64 only (C over 64: the weight passes 227 KB).

#include "common.cuh"

namespace {

using port::ldraw;
using port::Raw;
using port::widen;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TAPS = 9;
constexpr int OFFSETS = 2 * TAPS;

template <int C>
struct Shape {
    static constexpr int M = 2048 / C;                  // pixels a tile
    static constexpr int CH = C / 8;                    // 16-byte chunks a pixel
    static constexpr int K = TAPS * C;                  // contraction length
    static constexpr int KP = (K + 15) / 16 * 16;       // padded to the k step
    static constexpr int S = KP + 8;                    // row stride, bf16 values
    static constexpr int MT = M / 16, NT = C / 8;       // m16 and n8 tiles
    static constexpr int WN = NT == 1 ? 1 : 2;          // n8 tiles a warp
    static constexpr int WM = NT == 1 ? 2 : 1;          // m16 tiles a warp
    static constexpr int NG = NT / WN;                  // warps along n
    static constexpr int TX = M >= 128 ? 16 : 8, TY = M / TX;   // a tile's block
    static constexpr size_t SMEM = (size_t)(C + M) * S * 2;
    static_assert(M * CH == THREADS, "one (pixel, chunk) a thread");
    static_assert(MT * NT == 2 * WARPS, "two output tiles a warp");
};

// The corners of the tap at pixel coordinate (fx, fy) of an H x W image as
// pixel offsets into it, and their weights (core/geometry.grid_sample_2d):
// a corner outside the image weighs 0 and reads a clamped pixel. A
// coordinate outside (-2, W+1) x (-2, H+1), NaN included, has every corner
// outside: it is tested before any float -> int cast (undefined in CUDA for
// NaN and huge values), and its four corners read pixel 0.
__device__ __forceinline__ port::Tap4 tap4(float fx, float fy, int H, int W) {
    port::Tap4 q;
    const bool in = fx > -2.0f && fx < (float)W + 1.0f && fy > -2.0f && fy < (float)H + 1.0f;
    const float x0f = floorf(in ? fx : 0.0f), y0f = floorf(in ? fy : 0.0f);
    const int x0 = (int)x0f, y0 = (int)y0f;
    const float lx = __fsub_rn(fx, x0f), ly = __fsub_rn(fy, y0f);
    const float mx = __fsub_rn(1.0f, lx), my = __fsub_rn(1.0f, ly);
    const bool vx0 = in && x0 >= 0 && x0 <= W - 1, vx1 = in && x0 + 1 >= 0 && x0 + 1 <= W - 1;
    const bool vy0 = y0 >= 0 && y0 <= H - 1, vy1 = y0 + 1 >= 0 && y0 + 1 <= H - 1;
    q.w00 = (vx0 && vy0) ? __fmul_rn(mx, my) : 0.0f;
    q.w10 = (vx1 && vy0) ? __fmul_rn(lx, my) : 0.0f;
    q.w01 = (vx0 && vy1) ? __fmul_rn(mx, ly) : 0.0f;
    q.w11 = (vx1 && vy1) ? __fmul_rn(lx, ly) : 0.0f;
    const int xa = min(max(x0, 0), W - 1), xb = min(max(x0 + 1, 0), W - 1);
    const int ra = min(max(y0, 0), H - 1) * W, rb = min(max(y0 + 1, 0), H - 1) * W;
    q.o00 = ra + xa;
    q.o10 = ra + xb;
    q.o01 = rb + xa;
    q.o11 = rb + xb;
    return q;
}

// The tiles: TY x TX blocks of pixels of each image, cut at its edges
template <int C>
struct Grid {
    int tiles_x, tiles_y;
    long long tiles;

    __host__ __device__ Grid(int N, int H, int W)
        : tiles_x((W + Shape<C>::TX - 1) / Shape<C>::TX),
          tiles_y((H + Shape<C>::TY - 1) / Shape<C>::TY),
          tiles((long long)N * tiles_y * tiles_x) {}

    // image n, row y and column x of pixel j of tile `tile`; false past the
    // image's edge
    __device__ __forceinline__ bool pixel(long long tile, int j, int H, int W, int& n, int& y,
                                          int& x) const {
        const long long rest = tile / tiles_x;
        n = (int)(rest / tiles_y);
        y = (int)(rest % tiles_y) * Shape<C>::TY + j / Shape<C>::TX;
        x = (int)(tile % tiles_x) * Shape<C>::TX + j % Shape<C>::TX;
        return y < H && x < W;
    }
};

__device__ __forceinline__ void ldmatrix_x2(uint32_t r[2], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(port::smem_addr(p)));
}

template <int C>
__global__ void __launch_bounds__(THREADS)
dcn_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ off,
           const float* __restrict__ weight, __nv_bfloat16* __restrict__ out, int N, int H,
           int W) {
    using Sh = Shape<C>;
    constexpr int M = Sh::M, CH = Sh::CH, K = Sh::K, KP = Sh::KP, S = Sh::S;
    extern __shared__ __align__(16) __nv_bfloat16 smem[];
    __nv_bfloat16* ws = smem;                   // [C][S]: weight, row o, column t C + i
    __nv_bfloat16* as = smem + C * S;           // [M][S]: the tile's samples

    const int tid = threadIdx.x;
    for (int e = tid; e < C * KP; e += THREADS) {
        const int o = e / KP, k = e % KP;
        const float v = k < K ? __ldg(weight + (o * C + k % C) * TAPS + k / C) : 0.0f;
        ws[o * S + k] = __float2bfloat16_rn(v);
    }
    if constexpr (KP > K) {
        for (int e = tid; e < M * (KP - K); e += THREADS)
            as[(e / (KP - K)) * S + K + e % (KP - K)] = __float2bfloat16_rn(0.0f);
    }

    const int HW = H * W;
    const Grid<C> grid(N, H, W);
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, tq = lane & 3;
    // this warp's output tiles
    const int m0 = Sh::NT == 1 ? 2 * warp : warp / Sh::NG;
    const int n0 = Sh::NT == 1 ? 0 : (warp % Sh::NG) * Sh::WN;
    // this thread's (pixel, chunk) in a tile
    const int pm = tid / CH, ch = (tid % CH) * 8;

    for (long long tile = blockIdx.x; tile < grid.tiles; tile += gridDim.x) {
        int n, py0, px0;
        const bool valid = grid.pixel(tile, pm, H, W, n, py0, px0);
        __nv_bfloat16* arow = as + pm * S + ch;
        if (valid) {
            const __nv_bfloat16* img = x + (long long)n * HW * C + ch;
            // (dy, dx) of each tap: one bf16 pair, dy the low half
            const uint32_t* op = reinterpret_cast<const uint32_t*>(
                off + (((long long)n * H + py0) * W + px0) * OFFSETS);
            port::Tap4 q[TAPS];
            Raw<8, __nv_bfloat16> raw[TAPS][4];
#pragma unroll
            for (int t = 0; t < TAPS; ++t) {
                const uint32_t pair = __ldg(op + t);
                const float dy = __uint_as_float(pair << 16);
                const float dx = __uint_as_float(pair & 0xffff0000u);
                q[t] = tap4(__fadd_rn((float)(px0 + t % 3 - 1), dx),
                            __fadd_rn((float)(py0 + t / 3 - 1), dy), H, W);
                raw[t][0] = ldraw<8>(img + q[t].o00 * C);
                raw[t][1] = ldraw<8>(img + q[t].o10 * C);
                raw[t][2] = ldraw<8>(img + q[t].o01 * C);
                raw[t][3] = ldraw<8>(img + q[t].o11 * C);
            }
#pragma unroll
            for (int t = 0; t < TAPS; ++t) {
                float a[8], b[8], c[8], d[8], s[8];
                widen(raw[t][0], a);
                widen(raw[t][1], b);
                widen(raw[t][2], c);
                widen(raw[t][3], d);
                // grid_sample_2d's sum: ((v00 w00 + v10 w10) + v01 w01) + v11 w11
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    s[j] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a[j], q[t].w00),
                                                         __fmul_rn(b[j], q[t].w10)),
                                               __fmul_rn(c[j], q[t].w01)),
                                     __fmul_rn(d[j], q[t].w11));
                uint4 v;
                v.x = port::pack_bf16(s[0], s[1]);
                v.y = port::pack_bf16(s[2], s[3]);
                v.z = port::pack_bf16(s[4], s[5]);
                v.w = port::pack_bf16(s[6], s[7]);
                *reinterpret_cast<uint4*>(arow + t * C) = v;
            }
        } else {
#pragma unroll
            for (int t = 0; t < TAPS; ++t)
                *reinterpret_cast<uint4*>(arow + t * C) = make_uint4(0u, 0u, 0u, 0u);
        }
        __syncthreads();

        float acc[Sh::WM][Sh::WN][4];
#pragma unroll
        for (int i = 0; i < Sh::WM; ++i)
#pragma unroll
            for (int j = 0; j < Sh::WN; ++j)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
#pragma unroll 4
        for (int k0 = 0; k0 < KP; k0 += 16) {
            uint32_t af[Sh::WM][4];
#pragma unroll
            for (int i = 0; i < Sh::WM; ++i)
                port::ldmatrix_x4(af[i], as + ((m0 + i) * 16 + (lane & 15)) * S + k0
                                             + (lane >> 4) * 8);
            uint2 bf[Sh::WN];
            if constexpr (Sh::WN == 2) {
                uint32_t r[4];
                port::ldmatrix_x4(r, ws + (n0 * 8 + (lane >> 4) * 8 + (lane & 7)) * S + k0
                                         + ((lane >> 3) & 1) * 8);
                bf[0] = make_uint2(r[0], r[1]);
                bf[1] = make_uint2(r[2], r[3]);
            } else {
                uint32_t r[2];
                ldmatrix_x2(r, ws + (n0 * 8 + (lane & 7)) * S + k0 + ((lane >> 3) & 1) * 8);
                bf[0] = make_uint2(r[0], r[1]);
            }
#pragma unroll
            for (int i = 0; i < Sh::WM; ++i)
#pragma unroll
                for (int j = 0; j < Sh::WN; ++j) port::mma_bf16(acc[i][j], af[i], bf[j]);
        }

#pragma unroll
        for (int i = 0; i < Sh::WM; ++i) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                int qn, qy, qx;
                if (!grid.pixel(tile, (m0 + i) * 16 + g + 8 * h, H, W, qn, qy, qx)) continue;
                const long long q = ((long long)qn * H + qy) * W + qx;
                __nv_bfloat16* orow = out + q * C + n0 * 8 + 2 * tq;
#pragma unroll
                for (int j = 0; j < Sh::WN; ++j)
                    *reinterpret_cast<uint32_t*>(orow + 8 * j) =
                        port::pack_bf16(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
            }
        }
        __syncthreads();
    }
}

// one grid of the CTAs resident at once (looked up once an instance, with
// the shared-memory limit raised to the instance's), or one a tile where
// there are fewer tiles
template <int C>
int launch(const void* x, const void* off, const float* weight, void* out, int N, int H, int W,
           cudaStream_t stream) {
    auto kernel = dcn_kernel<C>;
    constexpr size_t bytes = Shape<C>::SMEM;
    static int resident = 0;
    if (resident == 0) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)bytes);
        int per_sm = 0;
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, bytes);
        if (e != cudaSuccess) return (int)e;
        resident = port::sm_count() * std::max(per_sm, 1);
    }
    const long long tiles = Grid<C>(N, H, W).tiles;
    const long long grid = std::min<long long>(tiles, resident);
    kernel<<<(unsigned)grid, THREADS, bytes, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(off), weight,
        static_cast<__nv_bfloat16*>(out), N, H, W);
    return (int)cudaGetLastError();
}

}  // namespace

// out [N, H, W, C] bf16 = the deformable 3x3 conv of x [N, H, W, C] bf16 at
// offsets off [N, H, W, 18] bf16 with weight [C, C, 3, 3] float32, all
// contiguous; x and out 16-byte aligned, off 4-byte aligned. The caller
// keeps C in {8, 16, 32, 64}, N H W >= 1, and N H W C and N H W 18 under
// 2^31. Returns cudaGetLastError() after the launch.
extern "C" int dcn_launch(const void* x, const void* off, const float* weight, void* out, int N,
                          int H, int W, int C, void* stream) {
    if (N < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (C) {
        case 8: return launch<8>(x, off, weight, out, N, H, W, s);
        case 16: return launch<16>(x, off, weight, out, N, H, W, s);
        case 32: return launch<32>(x, off, weight, out, N, H, W, s);
        case 64: return launch<64>(x, off, weight, out, N, H, W, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
