// The patchify ConvNeXt block (models/fpn.ConvNeXt4Block, the reference's
// convnext4_block) in eval and bf16, as one pass: from x [N, H, W, dim]
// NHWC to out [N, H/2, W/2, 2 dim],
//   inp = conv 2x2 stride 2 (x) + sconv bias                 (dim -> 2 dim)
//   c   = conv 7x7 (inp), dim groups of 2 in / 2 out, zero padding 3, + bias
//   y   = LayerNorm(c) over the 2 dim channels, eps, float32 weight and bias
//   g   = gelu(y W1^T + b1)                 (2 dim -> 4 dim, the exact erf form)
//   out = inp + gamma * (g W2^T + b2)       (4 dim -> 2 dim)
// with the plain route's rounding points and no others: inp rounded once
// to bf16 (the 7x7 conv's input and the residual), y rounded to bf16 (the
// first GEMM's A operand), g rounded to bf16 (the second's), out once.
// Everything else is float32: the 7x7 conv's sums, the LayerNorm, the
// GEMMs' accumulators (mma.sync m16n8k16, bf16 in, float32 accumulate),
// GELU, the layer scale and the residual. Weights and biases are rounded to
// bf16 where the plain route casts them to the activations' dtype (all but
// the LayerNorm's), from the float32 parameters as they are at each launch.
// The plain bf16 route rounds c, the first GEMM's output, the second's and
// gamma times it besides.
//
// Replaces no Pallas kernel: the JAX package's blocks are plain flax
// (nn.Conv with feature_group_count, nn.LayerNorm, nn.Dense, nn.gelu). The
// port ran each block as ~12 library and PyTorch launches with every
// intermediate in device memory; of them the library's grouped 7x7 conv of
// two channels a group (two engines) took ~8 of the three blocks' 11.8 ms
// in a B4 V4 512x640 forward, the float32 LayerNorm and its casts ~2.7.
//
// Bound (benchmark/counts/convnext.py, a B4 V4 512x640 forward, H100 SXM):
// 220 MB (x read once, out written once, in bf16: 0.066 ms) against 19.3
// GFLOP of convolutions. Of those the 7x7 conv's 7.2 GFLOP (98 products an
// output channel) have no tensor-core form without 4x zeros (two channels a
// group), so they run on the float32 CUDA cores (0.11 ms at 67 TFLOP/s):
// the kernel is bound by the 7x7 conv's FMAs, then by bytes. The design:
//   - A CTA of 256 threads takes tiles of TH x 16 output pixels of one
//     image (TH 16 at dim 8 and 16, 8 at dim 32: its shared memory), a
//     persistent grid walking the tiles. Phase 1 computes inp on the tile's
//     (TH + 6) x 22 halo on the tensor cores, straight from x in device
//     memory (a pixel's four input pixels are two runs of 2 dim values, and
//     no input pixel feeds two inp pixels), so x is read ~1.9x (the halo)
//     and never staged; the k order of each 16-wide step is permuted so
//     that a lane reads its four values of a row with one 8-byte load, the
//     weights packed to match. inp lands in shared memory as one plane a
//     channel pair (a group's two input channels, 4 bytes a pixel), zero
//     outside the image: the 7x7 conv's padding.
//   - Phase 2: a thread takes 8 rows of one column of one group (a warp one
//     group, its 32 lanes on 16 columns x 2 row strips: conflict-free
//     4-byte reads), and per kernel column reads its 14 inp values once and
//     runs 7 x 8 x 4 FMAs against the group's weights (float4 broadcasts).
//     c goes to shared memory in float32, [pixel][2 dim].
//   - Phase 3: a warp takes 16 pixels: each lane reads its quarter of two
//     rows of c, the quad reduces mean and variance by shuffles, and the
//     normalised values are packed straight into the first GEMM's A
//     fragments; each 16 x 8 output tile of the first GEMM gets its bias
//     and GELU in registers and becomes half of a 16 x 16 A fragment of the
//     second GEMM, so the 4 dim hidden values never leave registers; the
//     second GEMM's tiles take bias, gamma and the residual (inp from the
//     planes) and are written once as bf16 pairs.
//   - Each CTA packs every weight from the float32 parameters into shared
//     memory before its first tile, at every launch, so that a captured
//     graph reads the parameters as they are at replay.
// inp, c and the hidden activations never reach device memory. Shared
// memory: 43.9, 93.8 and 157.5 KB at dim 8, 16 and 32; dim 8, 16, 32 only.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TW = 16;               // a tile's output columns
constexpr int PITCH = TW + 6;        // a halo row of inp, pixels
constexpr int KT = 7;                // the depthwise kernel's side
constexpr float RSQRT2 = 0.70710678118654752f;

// The row stride (values) of a [rows][k] operand that a quad's lanes read
// 8 bytes each at column 16 ks + 4 tq: an odd multiple of 16, so that the
// four rows of a half-warp's load fall on distinct banks.
__host__ __device__ constexpr int kstride(int k) { return k % 32 == 16 ? k : k + 16; }

template <int D>
struct Shape {
    static constexpr int C2 = 2 * D, C4 = 4 * D, K0 = 4 * D;   // inp, hidden, sconv's k
    static constexpr int TH = D >= 32 ? 8 : 16;                 // a tile's output rows
    static constexpr int M = TH * TW;                           // a tile's output pixels
    static constexpr int HALO = (TH + 6) * PITCH;               // its inp pixels
    static constexpr int HM = (HALO + 15) / 16;                 // m16 tiles of them
    // a channel pair's plane (words): phase 2's two groups a warp (TH 8)
    // 16 banks apart; phase 1's four planes a store 8 apart (TH 16)
    static constexpr int PS = TH == 16 ? 488 : 336;
    static constexpr int STRIPS = TH / 8;                       // 8-row strips a column
    static constexpr int ITEMS = D * STRIPS * TW;               // (group, strip, column)
    static constexpr int R = C2 + 2;                            // a row of c, floats
    static constexpr int S0 = kstride(K0), S1 = kstride(C2), S2 = kstride(C4);
    static constexpr int KS0 = K0 / 16, NT0 = C2 / 8;           // sconv's k steps, n tiles
    static constexpr int KS1 = C2 / 16, NT1 = C4 / 8;           // the first GEMM's
    static constexpr int KS2 = C4 / 16, NT2 = C2 / 8;           // the second's
    static constexpr int NVEC = 6 * C2 + C4;                    // the vectors, floats
    // shared memory, bytes
    static constexpr size_t PLANES = 0;                               // [D][PS] bf16 pairs
    static constexpr size_t CV = PLANES + (size_t)D * PS * 4;         // [M][R] float
    static constexpr size_t WDW = CV + (size_t)M * R * 4;             // [D][kx][ky] float4
    static constexpr size_t VEC = WDW + (size_t)D * KT * KT * 16;     // NVEC floats
    static constexpr size_t WSC = VEC + (size_t)NVEC * 4;             // [C2][S0] bf16
    static constexpr size_t W1 = WSC + (size_t)C2 * S0 * 2;           // [C4][S1] bf16
    static constexpr size_t W2 = W1 + (size_t)C4 * S1 * 2;            // [C2][S2] bf16
    static constexpr size_t SMEM = W2 + (size_t)C2 * S2 * 2;
    static constexpr int MIN_BLOCKS = D >= 32 ? 1 : 2;
    static_assert(PS >= HALO && M == 16 * WARPS * (M / 16 / WARPS), "tile");
    static_assert(CV % 16 == 0 && WDW % 16 == 0 && VEC % 16 == 0 && WSC % 16 == 0, "align");
};

// the block's parameters as the module holds them, float32, contiguous
struct Params {
    const float* sw;      // sconv.weight [2 dim, dim, 2, 2]
    const float* sb;      // sconv.bias [2 dim]
    const float* dw;      // dwconv.weight [2 dim, 2, 7, 7]
    const float* db;      // dwconv.bias [2 dim]
    const float* lw;      // norm.weight [2 dim]
    const float* lb;      // norm.bias [2 dim]
    const float* w1;      // pwconv1.weight [4 dim, 2 dim]
    const float* b1;      // pwconv1.bias [4 dim]
    const float* w2;      // pwconv2.weight [2 dim, 4 dim]
    const float* b2;      // pwconv2.bias [2 dim]
    const float* gamma;   // gamma [2 dim]
};

__device__ __forceinline__ float bf16r(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float lo16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// the exact GELU in float32, as PyTorch's: x / 2 (1 + erf(x / sqrt 2))
__device__ __forceinline__ float gelu(float v) {
    return v * 0.5f * (1.0f + erff(v * RSQRT2));
}

// Every weight into shared memory, rounded to bf16 where the plain route
// rounds it: sconv's as [o][kh 2 dim + kw dim + i] (a pixel's two input
// runs in memory order); the 7x7 conv's as float4 (i0 -> o0, i0 -> o1,
// i1 -> o0, i1 -> o1) per group and tap, kx major; W1 as [n][k]; W2 as
// [n][k] with k permuted in each 16 (position 4 t + q holds 2 t + (q & 1)
// + 8 (q >> 1)), the order of the A fragments that the first GEMM's
// output tiles become.
template <int D>
__device__ void pack_weights(const Params& p, unsigned char* smem) {
    using Sh = Shape<D>;
    constexpr int C2 = Sh::C2, C4 = Sh::C4, K0 = Sh::K0;
    __nv_bfloat16* wsc = reinterpret_cast<__nv_bfloat16*>(smem + Sh::WSC);
    __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem + Sh::W1);
    __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + Sh::W2);
    float4* wdw = reinterpret_cast<float4*>(smem + Sh::WDW);
    float* vec = reinterpret_cast<float*>(smem + Sh::VEC);
    const int tid = threadIdx.x;
    for (int e = tid; e < C2 * K0; e += THREADS) {
        const int o = e / K0, k = e % K0;
        const int kh = k / (2 * D), kw = (k / D) % 2, i = k % D;
        wsc[o * Sh::S0 + k] = __float2bfloat16_rn(__ldg(p.sw + ((o * D + i) * 2 + kh) * 2 + kw));
    }
    for (int e = tid; e < D * KT * KT; e += THREADS) {
        const int g = e / (KT * KT), kx = e % (KT * KT) / KT, ky = e % KT;
        auto w = [&](int o, int i) {
            return bf16r(__ldg(p.dw + (((2 * g + o) * 2 + i) * KT + ky) * KT + kx));
        };
        wdw[e] = make_float4(w(0, 0), w(1, 0), w(0, 1), w(1, 1));
    }
    for (int c = tid; c < C2; c += THREADS) {
        vec[c] = bf16r(__ldg(p.sb + c));
        vec[C2 + c] = bf16r(__ldg(p.db + c));
        vec[2 * C2 + c] = __ldg(p.lw + c);
        vec[3 * C2 + c] = __ldg(p.lb + c);
        vec[4 * C2 + c] = bf16r(__ldg(p.b2 + c));
        vec[5 * C2 + c] = bf16r(__ldg(p.gamma + c));
    }
    for (int c = tid; c < C4; c += THREADS) vec[6 * C2 + c] = bf16r(__ldg(p.b1 + c));
    for (int e = tid; e < C4 * C2; e += THREADS)
        w1s[(e / C2) * Sh::S1 + e % C2] = __float2bfloat16_rn(__ldg(p.w1 + e));
    for (int e = tid; e < C2 * C4; e += THREADS) {
        const int n = e / C4, pos = e % C4, j = pos % 16, t = j / 4, q = j % 4;
        const int k = pos - j + 2 * t + (q & 1) + 8 * (q >> 1);
        w2s[n * Sh::S2 + pos] = __float2bfloat16_rn(__ldg(p.w2 + n * C4 + k));
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS, Shape<D>::MIN_BLOCKS)
cnx_block(const __nv_bfloat16* __restrict__ x, const Params p, __nv_bfloat16* __restrict__ out,
          int N, int H, int W, float eps) {
    using Sh = Shape<D>;
    constexpr int C2 = Sh::C2, TH = Sh::TH, PS = Sh::PS, R = Sh::R;
    extern __shared__ __align__(16) unsigned char smem[];
    uint32_t* planes = reinterpret_cast<uint32_t*>(smem + Sh::PLANES);
    float* cv = reinterpret_cast<float*>(smem + Sh::CV);
    const float4* wdw = reinterpret_cast<const float4*>(smem + Sh::WDW);
    const float* vec = reinterpret_cast<const float*>(smem + Sh::VEC);
    const float *bsc = vec, *bdw = vec + C2, *lnw = vec + 2 * C2, *lnb = vec + 3 * C2;
    const float *b2s = vec + 4 * C2, *gam = vec + 5 * C2, *b1s = vec + 6 * C2;
    const __nv_bfloat16* wsc = reinterpret_cast<const __nv_bfloat16*>(smem + Sh::WSC);
    const __nv_bfloat16* w1s = reinterpret_cast<const __nv_bfloat16*>(smem + Sh::W1);
    const __nv_bfloat16* w2s = reinterpret_cast<const __nv_bfloat16*>(smem + Sh::W2);

    pack_weights<D>(p, smem);
    __syncthreads();

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, tq = lane & 3;
    const int Ho = H / 2, Wo = W / 2;
    const int tiles_x = (Wo + TW - 1) / TW, tiles_y = (Ho + TH - 1) / TH;
    const long long tiles = (long long)N * tiles_y * tiles_x;

    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const long long rest = tile / tiles_x;
        const int n = (int)(rest / tiles_y);
        const int Y0 = (int)(rest % tiles_y) * TH, X0 = (int)(tile % tiles_x) * TW;

        // 1. inp over the halo: m16 tiles of halo pixels, row-major
        for (int mt = warp; mt < Sh::HM; mt += WARPS) {
            bool ok[2];
            const __nv_bfloat16* src[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = mt * 16 + g + 8 * h;
                const int Y = Y0 - 3 + r / PITCH, X = X0 - 3 + r % PITCH;
                ok[h] = r < Sh::HALO && Y >= 0 && Y < Ho && X >= 0 && X < Wo;
                src[h] = x + (((long long)n * H + 2 * (ok[h] ? Y : 0)) * W
                              + 2 * (ok[h] ? X : 0)) * D + 4 * tq;
            }
            uint2 a[Sh::KS0][2];
#pragma unroll
            for (int ks = 0; ks < Sh::KS0; ++ks) {
                // k step ks: input row kh, values j0 .. j0 + 15 of its 2 dim run
                const int kh = 16 * ks / (2 * D), j0 = 16 * ks % (2 * D);
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    a[ks][h] = ok[h] ? __ldg(reinterpret_cast<const uint2*>(
                                           src[h] + (long long)kh * W * D + j0))
                                     : make_uint2(0u, 0u);
            }
#pragma unroll
            for (int nt = 0; nt < Sh::NT0; ++nt) {
                float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
                for (int ks = 0; ks < Sh::KS0; ++ks) {
                    const uint32_t af[4] = {a[ks][0].x, a[ks][1].x, a[ks][0].y, a[ks][1].y};
                    const uint2 b = *reinterpret_cast<const uint2*>(
                        wsc + (nt * 8 + g) * Sh::S0 + 16 * ks + 4 * tq);
                    port::mma_bf16(acc, af, b);
                }
                const int c = nt * 8 + 2 * tq;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int r = mt * 16 + g + 8 * h;
                    if (r < Sh::HALO)
                        planes[(c / 2) * PS + r] =
                            ok[h] ? port::pack_bf16(acc[2 * h] + bsc[c], acc[2 * h + 1] + bsc[c + 1])
                                  : 0u;
                }
            }
        }
        __syncthreads();

        // 2. the 7x7 conv: 8 rows of one column of one group a thread
        for (int it = tid; it < Sh::ITEMS; it += THREADS) {
            const int xc = it % TW, s = it / TW % Sh::STRIPS, grp = it / (TW * Sh::STRIPS);
            const uint32_t* col = planes + grp * PS + 8 * s * PITCH + xc;
            const float4* wg = wdw + grp * KT * KT;
            float acc[8][2];
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = 0.0f;
#pragma unroll 1
            for (int kx = 0; kx < KT; ++kx) {
                float v0[8 + KT - 1], v1[8 + KT - 1];
#pragma unroll
                for (int r = 0; r < 8 + KT - 1; ++r) {
                    const uint32_t w = col[r * PITCH + kx];
                    v0[r] = lo16(w);
                    v1[r] = hi16(w);
                }
#pragma unroll
                for (int ky = 0; ky < KT; ++ky) {
                    const float4 w = wg[kx * KT + ky];
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        acc[j][0] = fmaf(v0[j + ky], w.x, acc[j][0]);
                        acc[j][0] = fmaf(v1[j + ky], w.z, acc[j][0]);
                        acc[j][1] = fmaf(v0[j + ky], w.y, acc[j][1]);
                        acc[j][1] = fmaf(v1[j + ky], w.w, acc[j][1]);
                    }
                }
            }
            const float b0 = bdw[2 * grp], b1 = bdw[2 * grp + 1];
#pragma unroll
            for (int j = 0; j < 8; ++j)
                *reinterpret_cast<float2*>(cv + ((8 * s + j) * TW + xc) * R + 2 * grp) =
                    make_float2(acc[j][0] + b0, acc[j][1] + b1);
        }
        __syncthreads();

        // 3. LayerNorm, the MLP and the output: 16 pixels (one tile row) a warp
        for (int mt = warp; mt < Sh::M / 16; mt += WARPS) {
            float xv[2][C2 / 4];           // channels 16 ks + 4 tq + q of pixels g, g + 8
            float mean[2], rstd[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const float* row = cv + (mt * 16 + g + 8 * h) * R + 4 * tq;
#pragma unroll
                for (int ks = 0; ks < Sh::KS1; ++ks) {
                    const float2 u = *reinterpret_cast<const float2*>(row + 16 * ks);
                    const float2 v = *reinterpret_cast<const float2*>(row + 16 * ks + 2);
                    xv[h][4 * ks] = u.x;
                    xv[h][4 * ks + 1] = u.y;
                    xv[h][4 * ks + 2] = v.x;
                    xv[h][4 * ks + 3] = v.y;
                }
                float s = 0.0f;
#pragma unroll
                for (int i = 0; i < C2 / 4; ++i) s += xv[h][i];
                s += __shfl_xor_sync(0xffffffffu, s, 1);
                s += __shfl_xor_sync(0xffffffffu, s, 2);
                mean[h] = s * (1.0f / C2);
                float q = 0.0f;
#pragma unroll
                for (int i = 0; i < C2 / 4; ++i) {
                    const float d = xv[h][i] - mean[h];
                    q = fmaf(d, d, q);
                }
                q += __shfl_xor_sync(0xffffffffu, q, 1);
                q += __shfl_xor_sync(0xffffffffu, q, 2);
                rstd[h] = rsqrtf(q * (1.0f / C2) + eps);
            }
            // the first GEMM's A: lane tq's k slots 2 tq, 2 tq + 1, 2 tq + 8,
            // 2 tq + 9 hold channels 4 tq .. 4 tq + 3 of each 16 (W1 as is)
            uint32_t a1[Sh::KS1][4];
#pragma unroll
            for (int ks = 0; ks < Sh::KS1; ++ks) {
                float y[2][4];
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int ch = 16 * ks + 4 * tq + q;
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        y[h][q] = (xv[h][4 * ks + q] - mean[h]) * rstd[h] * lnw[ch] + lnb[ch];
                }
                a1[ks][0] = port::pack_bf16(y[0][0], y[0][1]);
                a1[ks][1] = port::pack_bf16(y[1][0], y[1][1]);
                a1[ks][2] = port::pack_bf16(y[0][2], y[0][3]);
                a1[ks][3] = port::pack_bf16(y[1][2], y[1][3]);
            }
            // the first GEMM a 16 x 8 tile at a time, its bias and GELU; tile
            // nt is half (nt & 1) of the second GEMM's A for k step nt / 2
            uint32_t a2[Sh::KS2][4];
#pragma unroll
            for (int nt = 0; nt < Sh::NT1; ++nt) {
                float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
                for (int ks = 0; ks < Sh::KS1; ++ks) {
                    const uint2 b = *reinterpret_cast<const uint2*>(
                        w1s + (nt * 8 + g) * Sh::S1 + 16 * ks + 4 * tq);
                    port::mma_bf16(acc, a1[ks], b);
                }
                const int c = nt * 8 + 2 * tq;
                a2[nt / 2][2 * (nt & 1)] =
                    port::pack_bf16(gelu(acc[0] + b1s[c]), gelu(acc[1] + b1s[c + 1]));
                a2[nt / 2][2 * (nt & 1) + 1] =
                    port::pack_bf16(gelu(acc[2] + b1s[c]), gelu(acc[3] + b1s[c + 1]));
            }
#pragma unroll
            for (int nt = 0; nt < Sh::NT2; ++nt) {
                float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
                for (int ks = 0; ks < Sh::KS2; ++ks) {
                    const uint2 b = *reinterpret_cast<const uint2*>(
                        w2s + (nt * 8 + g) * Sh::S2 + 16 * ks + 4 * tq);
                    port::mma_bf16(acc, a2[ks], b);
                }
                const int c = nt * 8 + 2 * tq;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int xx = g + 8 * h, Y = Y0 + mt, X = X0 + xx;
                    if (Y >= Ho || X >= Wo) continue;
                    const uint32_t r = planes[(c / 2) * PS + (mt + 3) * PITCH + xx + 3];
                    const float o0 = fmaf(gam[c], acc[2 * h] + b2s[c], lo16(r));
                    const float o1 = fmaf(gam[c + 1], acc[2 * h + 1] + b2s[c + 1], hi16(r));
                    *reinterpret_cast<uint32_t*>(out + (((long long)n * Ho + Y) * Wo + X) * C2
                                                 + c) = port::pack_bf16(o0, o1);
                }
            }
        }
        __syncthreads();
    }
}

// one grid of the CTAs resident at once (looked up once an instance, with
// the shared-memory limit raised to the instance's), or one a tile where
// there are fewer tiles
template <int D>
int launch(const void* x, const Params& p, void* out, int N, int H, int W, float eps,
           cudaStream_t stream) {
    using Sh = Shape<D>;
    auto kernel = cnx_block<D>;
    static int resident = 0;
    if (resident == 0) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)Sh::SMEM);
        int per_sm = 0;
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, Sh::SMEM);
        if (e != cudaSuccess) return (int)e;
        resident = port::sm_count() * std::max(per_sm, 1);
    }
    const long long tiles = (long long)N * ((H / 2 + Sh::TH - 1) / Sh::TH)
                            * ((W / 2 + TW - 1) / TW);
    const long long grid = std::min<long long>(tiles, resident);
    kernel<<<(unsigned)grid, THREADS, Sh::SMEM, stream>>>(
        static_cast<const __nv_bfloat16*>(x), p, static_cast<__nv_bfloat16*>(out), N, H, W, eps);
    return (int)cudaGetLastError();
}

}  // namespace

// out [N, H/2, W/2, 2 dim] bf16 = the patchify ConvNeXt block of x [N, H, W,
// dim] bf16 (an odd last row or column of x is not read, as the stride-2
// conv leaves it), with the block's eleven float32 parameters in the
// module's layouts (Params), all contiguous; x 16-byte aligned, out 4-byte.
// The caller keeps dim in {8, 16, 32}, N, H/2, W/2 >= 1, and N H W dim
// under 2^31. Returns cudaGetLastError() after the launch.
extern "C" int cnx_launch(const void* x, const float* sw, const float* sb, const float* dw,
                          const float* db, const float* lw, const float* lb, const float* w1,
                          const float* b1, const float* w2, const float* b2, const float* gamma,
                          void* out, int N, int H, int W, int dim, float eps, void* stream) {
    if (N < 1 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
    const Params p{sw, sb, dw, db, lw, lb, w1, b1, w2, b2, gamma};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dim) {
        case 8: return launch<8>(x, p, out, N, H, W, eps, s);
        case 16: return launch<16>(x, p, out, N, H, W, eps, s);
        case 32: return launch<32>(x, p, out, N, H, W, eps, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
