// Train-mode BatchNorm with an optional ReLU, forward and backward, over
// activations x [N, H, W, C] (contiguous, channels last, bf16 or float32)
// whose batch folds G view groups: image n belongs to group g = n % G (the
// fold b*V + v; G = 1 for one group), and each group has its own batch
// statistics over its N/G images and all their pixels:
//   mean, var = the mean and biased variance of x over group g, per channel
//   rstd      = 1 / sqrt(var + eps)
//   y         = relu(((x - mean) * rstd) * weight + bias)          (relu)
//   running   = m^G running + (1 - m) sum_v m^(G-1-v) stat_v       (m = 0.9,
//               the unbiased variance: the reference's G sequential updates)
// and the full BatchNorm backward through the batch statistics, per group:
//   dy'  = dy where the rounded y > 0 (relu; F.relu's backward), else dy
//   dx   = weight * rstd * (dy' - sum(dy') / n - xhat * sum(dy' xhat) / n)
//   dweight = sum over every group of dy' xhat, dbias = sum of dy'
// with xhat = (x - mean) * rstd and n = (N / G) H W. Every statistic, sum and
// output is computed in float32 from x's values (the merges in float64),
// and each output element is rounded once to x's dtype.
//
// Replaces no Pallas kernel. On the TPU, XLA fused the train-mode norm into
// its neighbouring convolutions, so the JAX package has none; the port ran
// it as a chain of PyTorch ops (cast to float32, var_mean, subtract,
// rsqrt, multiply, affine, cast back, ReLU, about ten small updates of the
// running statistics), which autograd recorded with float32 copies of the
// activations and mirrored in its backward: about a third of a B6 V5 train
// step on an H100.
//
// It is bound by bytes: x read twice and y written once in the forward, x
// and dy read twice and dx written once in the backward, 16 bytes a bf16
// element (32 a float32 one); the [G, C] statistics and the per-CTA
// partials are small beside them.
//
// Design, and how it keeps to that bound:
//   - Slabs. Every streaming kernel (stats, apply, grad_reduce, dx) gives
//     each CTA one slab: `pps` consecutive pixels of one image, so that its
//     group is uniform and its per-channel parameters stay in registers.
//     The CTA's threads form a lane grid over the slab: CV = C / VW channel
//     vectors a pixel (VW = 8 bf16 or 4 float32 values, 16 bytes, where C is
//     a multiple of VW and the tensors are 16-byte aligned; VW = 1
//     otherwise), `cols` = min(CV, 256) vectors a pass and R = 256 / CV pixel
//     rows, so that neighbouring threads read neighbouring 16 bytes and each
//     thread keeps the same channels throughout; a thread loads U = 4 pixels
//     before it computes any. Wider C than 256 vectors walks the channels in
//     passes.
//   - Statistics without cancellation and without atomics. A thread sums
//     x - k and (x - k)^2 with k the slab's first pixel (one shift per CTA
//     and channel, so the thread sums add as they are); the CTA adds its
//     rows in a fixed tree in shared memory and writes (mean, M2) per
//     channel for its slab. The finalize kernel merges a group's slabs with
//     Chan's parallel formula in float64, about one shift (the mean of the
//     group's first slab), in a fixed order: contiguous chunks of the slab
//     list, then a fixed tree over the chunks, with no division until the
//     end. Nothing depends on the order in which CTAs run, so a replay gives
//     the same bits, as the plain chain does; and no float32 E[x^2] -
//     E[x]^2 is ever formed.
//   - The finalize also writes mean and rstd [G, C] for the apply and the
//     backward, and applies the running-statistics update in place in the
//     same launch (and adds G to num_batches_tracked): one launch where the
//     chain had about ten.
//   - The apply and the backward read weight and bias as they are at launch,
//     so a captured graph replayed after the optimizer's in-place update
//     sees the new values.
//   - The backward recomputes the forward's rounded y from x with the same
//     operations (no contraction into FMAs: __fsub_rn, __fmul_rn,
//     __fadd_rn), so its ReLU mask is the forward output's bit for bit, and
//     autograd keeps only x and the [G, C] statistics. grad_reduce sums dy'
//     and dy' xhat per slab with the same lane grid and tree; the gradient
//     finalize adds the slabs in float64 in the same fixed order and writes
//     the per-group sums and dweight, dbias; dx then streams once more.
//   - Slab size: pps = R x iters pixels with 1 <= iters <= 16, the fewest
//     that give about 1024 CTAs (ops/kernels/bn_train.py:plan), so small
//     calls still fill the card and large ones keep few partials.
//
// Launches a call: 3 forward (stats, finalize, apply) and 3 backward
// (grad_reduce, grad_finalize, dx), each its own C entry, so the counter
// bn_train.launches counts kernels.

#include "common.cuh"

#include <initializer_list>

namespace {

using port::ldraw;
using port::Raw;
using port::storev;
using port::widen;

constexpr int THREADS = 256;        // a streaming CTA
constexpr int FIN_THREADS = 1024;   // the one finalize CTA
constexpr int U = 4;                // pixels a thread loads before it computes any
constexpr int MAX_VW = 8;
constexpr int MAX_CHANNELS = 4096;

// The lane grid of a slab (see the note above): thread t is row t / cols,
// column t % cols; rows from R on idle.
struct Lanes {
    int CV, cols, R, passes;
    __device__ __forceinline__ Lanes(int C, int VW)
        : CV(C / VW), cols(min(C / VW, THREADS)), R(max(1, THREADS / (C / VW))),
          passes((C / VW + THREADS - 1) / THREADS) {}
};

// this CTA's slab: image n, pixels [p0, p0 + cnt), index s = blockIdx.x
struct Slab {
    long long s, n, p0;
    int cnt;
    __device__ __forceinline__ Slab(long long P, long long pps, int slabs) {
        s = blockIdx.x;
        n = s / slabs;
        p0 = (s - n * slabs) * pps;
        cnt = (int)min(pps, P - p0);
    }
};

__device__ __forceinline__ float xhat_of(float v, float mean, float rstd) {
    return __fmul_rn(__fsub_rn(v, mean), rstd);
}

__device__ __forceinline__ float affine(float xh, float w, float b) {
    return __fadd_rn(__fmul_rn(xh, w), b);
}

// whether F.relu's backward passes the gradient at an output whose float32
// value before rounding to T is y: not (rounded y <= 0), so a NaN passes
template <typename T>
__device__ __forceinline__ bool passes(float y) {
    if constexpr (std::is_same<T, float>::value) {
        return !(y <= 0.0f);
    } else {
        return !(__bfloat162float(__float2bfloat16_rn(y)) <= 0.0f);
    }
}

// the per-channel parameters of VW channels from c of group g
template <int VW>
struct Params {
    float mean[VW], rstd[VW], w[VW], b[VW];
    __device__ __forceinline__ Params(const float* mean_gc, const float* rstd_gc,
                                      const float* weight, const float* bias, int g, int C,
                                      int c) {
#pragma unroll
        for (int i = 0; i < VW; ++i) {
            mean[i] = __ldg(mean_gc + g * C + c + i);
            rstd[i] = __ldg(rstd_gc + g * C + c + i);
            w[i] = __ldg(weight + c + i);
            b[i] = __ldg(bias + c + i);
        }
    }
};

// adds rows 0..R-1 of a[R][width] and b[R][width] into row 0 in a fixed
// tree; the caller has synchronised after writing them
__device__ __forceinline__ void row_tree(float* a, float* b, int R, int width) {
    int top = 1;
    while (top < R) top <<= 1;
    for (int stride = top >> 1; stride >= 1; stride >>= 1) {
        for (int i = threadIdx.x; i < stride * width; i += THREADS) {
            if (i / width + stride < R) {
                a[i] += a[i + stride * width];
                b[i] += b[i + stride * width];
            }
        }
        __syncthreads();
    }
}

// part[s][0][c] = the slab's mean, part[s][1][c] = its sum of squared
// deviations M2, each channel
template <typename T, int VW>
__global__ void __launch_bounds__(THREADS)
stats_kernel(const T* __restrict__ x, float* __restrict__ part, long long P, int C,
             long long pps, int slabs) {
    __shared__ float sa[THREADS * MAX_VW], sb[THREADS * MAX_VW];
    const Lanes ln(C, VW);
    const Slab sl(P, pps, slabs);
    const T* base = x + (sl.n * P + sl.p0) * C;
    const int r = threadIdx.x / ln.cols, col = threadIdx.x % ln.cols;
    const int width = ln.cols * VW;
    float* out = part + sl.s * 2 * C;
    for (int q = 0; q < ln.passes; ++q) {
        const int cv = q * ln.cols + col;
        float s1[VW], s2[VW];
#pragma unroll
        for (int i = 0; i < VW; ++i) s1[i] = s2[i] = 0.0f;
        if (r < ln.R && cv < ln.CV) {
            const T* px = base + cv * VW;
            float k[VW];
            widen(ldraw<VW>(px), k);
            for (int p = r; p < sl.cnt; p += U * ln.R) {
                Raw<VW, T> raw[U];
#pragma unroll
                for (int u = 0; u < U; ++u)
                    if (p + u * ln.R < sl.cnt) raw[u] = ldraw<VW>(px + (long long)(p + u * ln.R) * C);
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    if (p + u * ln.R < sl.cnt) {
                        float v[VW];
                        widen(raw[u], v);
#pragma unroll
                        for (int i = 0; i < VW; ++i) {
                            const float d = __fsub_rn(v[i], k[i]);
                            s1[i] = __fadd_rn(s1[i], d);
                            s2[i] = __fmaf_rn(d, d, s2[i]);
                        }
                    }
                }
            }
        }
        if (r < ln.R) {
#pragma unroll
            for (int i = 0; i < VW; ++i) {
                sa[r * width + col * VW + i] = s1[i];
                sb[r * width + col * VW + i] = s2[i];
            }
        }
        __syncthreads();
        row_tree(sa, sb, ln.R, width);
        for (int e = threadIdx.x; e < width; e += THREADS) {
            const int c = q * width + e;
            if (c < C) {
                const float k = port::ldg1(base + c);
                const float n = (float)sl.cnt, S1 = sa[e];
                out[c] = __fadd_rn(k, __fdiv_rn(S1, n));
                out[C + c] = fmaxf(__fsub_rn(sb[e], __fdiv_rn(__fmul_rn(S1, S1), n)), 0.0f);
            }
        }
        __syncthreads();
    }
}

// y = relu(((x - mean) * rstd) * w + b) of group n % G, rounded once
template <typename T, int VW>
__global__ void __launch_bounds__(THREADS)
apply_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ mean,
             const float* __restrict__ rstd, const float* __restrict__ weight,
             const float* __restrict__ bias, long long P, int C, int G, long long pps, int slabs,
             int relu_flag) {
    const Lanes ln(C, VW);
    const Slab sl(P, pps, slabs);
    const int r = threadIdx.x / ln.cols, col = threadIdx.x % ln.cols;
    if (r >= ln.R) return;
    const long long off = (sl.n * P + sl.p0) * C;
    const int g = (int)(sl.n % G);
    const bool relu = relu_flag != 0;
    for (int q = 0; q < ln.passes; ++q) {
        const int cv = q * ln.cols + col;
        if (cv >= ln.CV) break;
        const int c = cv * VW;
        const Params<VW> pm(mean, rstd, weight, bias, g, C, c);
        for (int p = r; p < sl.cnt; p += U * ln.R) {
            Raw<VW, T> raw[U];
#pragma unroll
            for (int u = 0; u < U; ++u)
                if (p + u * ln.R < sl.cnt)
                    raw[u] = ldraw<VW>(x + off + (long long)(p + u * ln.R) * C + c);
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (p + u * ln.R < sl.cnt) {
                    float f[VW];
                    widen(raw[u], f);
#pragma unroll
                    for (int i = 0; i < VW; ++i) {
                        const float v = affine(xhat_of(f[i], pm.mean[i], pm.rstd[i]), pm.w[i], pm.b[i]);
                        // NaN stays NaN, as F.relu leaves it
                        f[i] = relu && v < 0.0f ? 0.0f : v;
                    }
                    storev<VW>(y + off + (long long)(p + u * ln.R) * C + c, f);
                }
            }
        }
    }
}

// part[s][0][c] = the slab's sum of dy', part[s][1][c] = of dy' xhat
template <typename T, int VW>
__global__ void __launch_bounds__(THREADS)
grad_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const float* __restrict__ mean, const float* __restrict__ rstd,
                   const float* __restrict__ weight, const float* __restrict__ bias,
                   float* __restrict__ part, long long P, int C, int G, long long pps, int slabs,
                   int relu_flag) {
    __shared__ float sa[THREADS * MAX_VW], sb[THREADS * MAX_VW];
    const Lanes ln(C, VW);
    const Slab sl(P, pps, slabs);
    const long long off = (sl.n * P + sl.p0) * C;
    const int g = (int)(sl.n % G);
    const bool relu = relu_flag != 0;
    const int r = threadIdx.x / ln.cols, col = threadIdx.x % ln.cols;
    const int width = ln.cols * VW;
    float* out = part + sl.s * 2 * C;
    for (int q = 0; q < ln.passes; ++q) {
        const int cv = q * ln.cols + col;
        float s1[VW], s2[VW];
#pragma unroll
        for (int i = 0; i < VW; ++i) s1[i] = s2[i] = 0.0f;
        if (r < ln.R && cv < ln.CV) {
            const int c = cv * VW;
            const Params<VW> pm(mean, rstd, weight, bias, g, C, c);
            for (int p = r; p < sl.cnt; p += U * ln.R) {
                Raw<VW, T> rx[U], rg[U];
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    if (p + u * ln.R < sl.cnt) {
                        const long long o = off + (long long)(p + u * ln.R) * C + c;
                        rx[u] = ldraw<VW>(x + o);
                        rg[u] = ldraw<VW>(dy + o);
                    }
                }
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    if (p + u * ln.R < sl.cnt) {
                        float fx[VW], fg[VW];
                        widen(rx[u], fx);
                        widen(rg[u], fg);
#pragma unroll
                        for (int i = 0; i < VW; ++i) {
                            const float xh = xhat_of(fx[i], pm.mean[i], pm.rstd[i]);
                            const float d =
                                !relu || passes<T>(affine(xh, pm.w[i], pm.b[i])) ? fg[i] : 0.0f;
                            s1[i] = __fadd_rn(s1[i], d);
                            s2[i] = __fmaf_rn(d, xh, s2[i]);
                        }
                    }
                }
            }
        }
        if (r < ln.R) {
#pragma unroll
            for (int i = 0; i < VW; ++i) {
                sa[r * width + col * VW + i] = s1[i];
                sb[r * width + col * VW + i] = s2[i];
            }
        }
        __syncthreads();
        row_tree(sa, sb, ln.R, width);
        for (int e = threadIdx.x; e < width; e += THREADS) {
            const int c = q * width + e;
            if (c < C) {
                out[c] = sa[e];
                out[C + c] = sb[e];
            }
        }
        __syncthreads();
    }
}

// dx = w * rstd * ((dy' - sum(dy') / n) - xhat * sum(dy' xhat) / n), rounded once;
// sums [2][G][C] from grad_finalize_kernel
template <typename T, int VW>
__global__ void __launch_bounds__(THREADS)
dx_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
          const float* __restrict__ mean, const float* __restrict__ rstd,
          const float* __restrict__ weight, const float* __restrict__ bias,
          const float* __restrict__ sums, long long P, int C, int G, long long pps, int slabs,
          int relu_flag, float inv_n) {
    const Lanes ln(C, VW);
    const Slab sl(P, pps, slabs);
    const int r = threadIdx.x / ln.cols, col = threadIdx.x % ln.cols;
    if (r >= ln.R) return;
    const long long off = (sl.n * P + sl.p0) * C;
    const int g = (int)(sl.n % G);
    const bool relu = relu_flag != 0;
    for (int q = 0; q < ln.passes; ++q) {
        const int cv = q * ln.cols + col;
        if (cv >= ln.CV) break;
        const int c = cv * VW;
        const Params<VW> pm(mean, rstd, weight, bias, g, C, c);
        float a[VW], mdy[VW], mdyx[VW];
#pragma unroll
        for (int i = 0; i < VW; ++i) {
            a[i] = __fmul_rn(pm.w[i], pm.rstd[i]);
            mdy[i] = __fmul_rn(__ldg(sums + g * C + c + i), inv_n);
            mdyx[i] = __fmul_rn(__ldg(sums + (G + g) * C + c + i), inv_n);
        }
        for (int p = r; p < sl.cnt; p += U * ln.R) {
            Raw<VW, T> rx[U], rg[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (p + u * ln.R < sl.cnt) {
                    const long long o = off + (long long)(p + u * ln.R) * C + c;
                    rx[u] = ldraw<VW>(x + o);
                    rg[u] = ldraw<VW>(dy + o);
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (p + u * ln.R < sl.cnt) {
                    float fx[VW], fg[VW];
                    widen(rx[u], fx);
                    widen(rg[u], fg);
#pragma unroll
                    for (int i = 0; i < VW; ++i) {
                        const float xh = xhat_of(fx[i], pm.mean[i], pm.rstd[i]);
                        const float d =
                            !relu || passes<T>(affine(xh, pm.w[i], pm.b[i])) ? fg[i] : 0.0f;
                        fx[i] = __fmul_rn(a[i], __fsub_rn(__fsub_rn(d, mdy[i]),
                                                          __fmul_rn(xh, mdyx[i])));
                    }
                    storev<VW>(dx + off + (long long)(p + u * ln.R) * C + c, fx);
                }
            }
        }
    }
}

// The finalize CTA's layout: the G*C columns (k = g*C + c) in passes of
// `cols`; thread t takes column k0 + t % cols and chunk t / cols of the J
// contiguous chunks of the group's slab list (entry l = i * slabs + j:
// image g + i*G, slab j), then a fixed tree adds the chunks.
struct FinLayout {
    int GC, cols, J, jc, ci, top;
    long long L;
    __device__ __forceinline__ FinLayout(int N, int C, int G, int slabs) {
        GC = G * C;
        cols = min(GC, FIN_THREADS);
        J = FIN_THREADS / cols;
        jc = threadIdx.x / cols;
        ci = threadIdx.x - jc * cols;
        L = (long long)(N / G) * slabs;
        top = 1;
        while (top < J) top <<= 1;
    }
    __device__ __forceinline__ long long l0() const { return L * jc / J; }
    __device__ __forceinline__ long long l1() const { return L * (jc + 1) / J; }
};

// f(a, b, n) for entries [l0, l1) of group g's slab list, in order: a and b
// the slab's two partials of channel c, n its pixels; BATCH slabs' loads
// are issued before any f, and the entry's image and slab advance without
// a division
template <typename F>
__device__ __forceinline__ void walk(const float* __restrict__ part, int g, int G, int C, int c,
                                     long long P, long long pps, int slabs, long long l0,
                                     long long l1, F&& f) {
    constexpr int BATCH = 8;
    long long i = l0 / slabs;
    int j = (int)(l0 - i * slabs);
    for (long long l = l0; l < l1; l += BATCH) {
        float a[BATCH], b[BATCH], n[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
            a[u] = b[u] = n[u] = 0.0f;
            if (l + u < l1) {
                const float* p = part + ((g + i * G) * slabs + j) * 2LL * C + c;
                a[u] = __ldg(p);
                b[u] = __ldg(p + C);
                n[u] = (float)min(pps, P - j * pps);
                if (++j == slabs) {
                    j = 0;
                    ++i;
                }
            }
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
            if (n[u] > 0.0f) f(a[u], b[u], n[u]);
    }
}

// Chan's parallel merge of a group's slabs, about one shift: with k the
// mean of the group's first slab and d_s = mean_s - k, the group's count
// is n = sum n_s, its mean k + S / n and its M2 Q - S^2 / n, where S = sum
// n_s d_s and Q = sum (M2_s + n_s d_s^2), all in float64; S and Q of the
// chunks then add, so neither the walk nor the tree divides
__global__ void __launch_bounds__(FIN_THREADS)
stats_finalize_kernel(const float* __restrict__ part, float* __restrict__ mean_out,
                      float* __restrict__ rstd_out, float* __restrict__ var_out,
                      float* __restrict__ run_mean, float* __restrict__ run_var,
                      long long* __restrict__ batches, int N, long long P, int C, int G,
                      long long pps, int slabs, float eps, float momentum, float m_pow_g,
                      float one_minus_m, float unbias) {
    __shared__ double sn[FIN_THREADS], ss[FIN_THREADS], sq[FIN_THREADS];
    const FinLayout fl(N, C, G, slabs);
    const int t = threadIdx.x;
    for (int k0 = 0; k0 < fl.GC; k0 += fl.cols) {
        const int k = k0 + fl.ci, g = k / C, c = k - g * C;
        double n = 0.0, sum = 0.0, sq_sum = 0.0;
        if (fl.jc < fl.J && k < fl.GC) {
            const double shift = __ldg(part + (long long)g * slabs * 2 * C + c);
            walk(part, g, G, C, c, P, pps, slabs, fl.l0(), fl.l1(),
                 [&](float mb, float Mb, float nb) {
                     const double d = (double)mb - shift;
                     n += nb;
                     sum += nb * d;
                     sq_sum += (double)Mb + nb * d * d;
                 });
        }
        sn[t] = n;
        ss[t] = sum;
        sq[t] = sq_sum;
        __syncthreads();
        for (int stride = fl.top >> 1; stride >= 1; stride >>= 1) {
            if (fl.jc < stride && fl.jc + stride < fl.J) {
                const int o = t + stride * fl.cols;
                sn[t] += sn[o];
                ss[t] += ss[o];
                sq[t] += sq[o];
            }
            __syncthreads();
        }
        if (fl.jc == 0 && k < fl.GC) {
            const double shift = part[(long long)g * slabs * 2 * C + c];
            const double dm = ss[t] / sn[t];
            const float var = (float)(fmax(sq[t] - ss[t] * dm, 0.0) / sn[t]);
            mean_out[k] = (float)(shift + dm);
            var_out[k] = var;
            rstd_out[k] = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
        }
        __syncthreads();
    }
    // the G momentum updates in closed form, in place
    for (int c = t; c < C; c += FIN_THREADS) {
        float am = 0.0f, av = 0.0f;
        for (int v = 0; v < G; ++v) {
            const float w = powf(momentum, (float)(G - 1 - v));
            am = __fadd_rn(am, __fmul_rn(w, mean_out[v * C + c]));
            av = __fadd_rn(av, __fmul_rn(w, __fmul_rn(var_out[v * C + c], unbias)));
        }
        run_mean[c] = __fadd_rn(__fmul_rn(run_mean[c], m_pow_g), __fmul_rn(one_minus_m, am));
        run_var[c] = __fadd_rn(__fmul_rn(run_var[c], m_pow_g), __fmul_rn(one_minus_m, av));
    }
    if (t == 0) *batches += G;
}

// sums[0][g][c] = sum of dy', sums[1][g][c] = sum of dy' xhat over group g,
// in float64 in the order of the statistics; dbias, dweight = their sums
// over g
__global__ void __launch_bounds__(FIN_THREADS)
grad_finalize_kernel(const float* __restrict__ part, float* __restrict__ sums,
                     float* __restrict__ dweight, float* __restrict__ dbias, int N, long long P,
                     int C, int G, long long pps, int slabs) {
    __shared__ double sa[FIN_THREADS], sb[FIN_THREADS];
    const FinLayout fl(N, C, G, slabs);
    const int t = threadIdx.x;
    for (int k0 = 0; k0 < fl.GC; k0 += fl.cols) {
        const int k = k0 + fl.ci, g = k / C, c = k - g * C;
        double a = 0.0, b = 0.0;
        if (fl.jc < fl.J && k < fl.GC)
            walk(part, g, G, C, c, P, pps, slabs, fl.l0(), fl.l1(), [&](float pa, float pb, float) {
                a += pa;
                b += pb;
            });
        sa[t] = a;
        sb[t] = b;
        __syncthreads();
        for (int stride = fl.top >> 1; stride >= 1; stride >>= 1) {
            if (fl.jc < stride && fl.jc + stride < fl.J) {
                sa[t] += sa[t + stride * fl.cols];
                sb[t] += sb[t + stride * fl.cols];
            }
            __syncthreads();
        }
        if (fl.jc == 0 && k < fl.GC) {
            sums[k] = (float)sa[t];
            sums[fl.GC + k] = (float)sb[t];
        }
        __syncthreads();
    }
    for (int c = t; c < C; c += FIN_THREADS) {
        float db = 0.0f, dw = 0.0f;
        for (int g = 0; g < G; ++g) {
            db = __fadd_rn(db, sums[g * C + c]);
            dw = __fadd_rn(dw, sums[fl.GC + g * C + c]);
        }
        dbias[c] = db;
        dweight[c] = dw;
    }
}

// the checks every streaming entry shares; 0 or a CUDA error
int check_stream(int N, long long P, int C, int G, int vw, int is_bf16, long long pps,
                 int& slabs, std::initializer_list<const void*> ptrs) {
    if (N < 1 || P < 1 || C < 1 || C > MAX_CHANNELS || G < 1 || N % G || pps < 1)
        return (int)cudaErrorInvalidValue;
    if (vw != 1 && (vw != (is_bf16 ? 8 : 4) || C % vw)) return (int)cudaErrorInvalidValue;
    for (const void* p : ptrs)
        if (vw != 1 && (uintptr_t)p % 16) return (int)cudaErrorMisalignedAddress;
    const long long per_image = (P + pps - 1) / pps, ctas = per_image * N;
    if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    slabs = (int)per_image;
    return 0;
}

// each streaming kernel's launch, one instance a dtype and vector width
template <typename T, int VW>
int run_stats(const void* x, float* part, int N, long long P, int C, long long pps, int slabs,
          cudaStream_t s) {
    stats_kernel<T, VW><<<(unsigned)(N * (long long)slabs), THREADS, 0, s>>>(
        static_cast<const T*>(x), part, P, C, pps, slabs);
    return (int)cudaGetLastError();
}

template <typename T, int VW>
int run_apply(const void* x, void* y, const float* mean, const float* rstd, const float* weight,
          const float* bias, int N, long long P, int C, int G, long long pps, int slabs, int relu,
          cudaStream_t s) {
    apply_kernel<T, VW><<<(unsigned)(N * (long long)slabs), THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(y), mean, rstd, weight, bias, P, C, G, pps,
        slabs, relu);
    return (int)cudaGetLastError();
}

template <typename T, int VW>
int run_grad_reduce(const void* x, const void* dy, const float* mean, const float* rstd,
                const float* weight, const float* bias, float* part, int N, long long P, int C,
                int G, long long pps, int slabs, int relu, cudaStream_t s) {
    grad_reduce_kernel<T, VW><<<(unsigned)(N * (long long)slabs), THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), mean, rstd, weight, bias, part, P,
        C, G, pps, slabs, relu);
    return (int)cudaGetLastError();
}

template <typename T, int VW>
int run_dx(const void* x, const void* dy, void* dx, const float* mean, const float* rstd,
       const float* weight, const float* bias, const float* sums, int N, long long P, int C,
       int G, long long pps, int slabs, int relu, float inv_n, cudaStream_t s) {
    dx_kernel<T, VW><<<(unsigned)(N * (long long)slabs), THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx), mean, rstd,
        weight, bias, sums, P, C, G, pps, slabs, relu, inv_n);
    return (int)cudaGetLastError();
}

// FN<T, VW>(...) for the dtype (is_bf16) and the vector width (vw)
#define BN_TRAIN_DISPATCH(is_bf16, vw, FN, ...)                                          \
    ((is_bf16) ? ((vw) == 8 ? FN<__nv_bfloat16, 8>(__VA_ARGS__)                           \
                            : FN<__nv_bfloat16, 1>(__VA_ARGS__))                          \
               : ((vw) == 4 ? FN<float, 4>(__VA_ARGS__) : FN<float, 1>(__VA_ARGS__)))

}  // namespace

// Each entry launches one kernel on `stream` and returns cudaGetLastError()
// after it (or the error of its argument checks). x, dy, y, dx: N*P*C
// elements, contiguous, channels last, bf16 where is_bf16 else float32; vw
// the vector width (8 bf16 or 4 float32 values where C % vw == 0 and every
// tensor starts on 16 bytes; 1 otherwise); pps the pixels of a slab (the
// same within one direction: stats, finalize and apply; grad_reduce,
// grad_finalize and dx); part: N * ceil(P / pps) * 2 * C floats; mean,
// rstd, var: [G, C] floats; sums: [2, G, C].

extern "C" int bn_train_stats_launch(const void* x, float* part, int N, long long P, int C,
                                     int vw, long long pps, int is_bf16, void* stream) {
    int slabs = 0;
    const int e = check_stream(N, P, C, 1, vw, is_bf16, pps, slabs, {x});
    if (e) return e;
    return BN_TRAIN_DISPATCH(is_bf16, vw, run_stats, x, part, N, P, C, pps, slabs,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int bn_train_finalize_launch(const float* part, float* mean, float* rstd, float* var,
                                        float* run_mean, float* run_var, long long* batches,
                                        int N, long long P, int C, int G, long long pps, float eps,
                                        float momentum, float m_pow_g, float one_minus_m,
                                        float unbias, void* stream) {
    int slabs = 0;
    const int e = check_stream(N, P, C, G, 1, 0, pps, slabs, {});
    if (e) return e;
    stats_finalize_kernel<<<1, FIN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        part, mean, rstd, var, run_mean, run_var, batches, N, P, C, G, pps, slabs, eps, momentum,
        m_pow_g, one_minus_m, unbias);
    return (int)cudaGetLastError();
}

extern "C" int bn_train_apply_launch(const void* x, void* y, const float* mean, const float* rstd,
                                     const float* weight, const float* bias, int N, long long P,
                                     int C, int G, int vw, long long pps, int relu, int is_bf16,
                                     void* stream) {
    int slabs = 0;
    const int e = check_stream(N, P, C, G, vw, is_bf16, pps, slabs, {x, y});
    if (e) return e;
    return BN_TRAIN_DISPATCH(is_bf16, vw, run_apply, x, y, mean, rstd, weight, bias, N, P, C, G, pps,
                             slabs, relu, static_cast<cudaStream_t>(stream));
}

extern "C" int bn_train_grad_reduce_launch(const void* x, const void* dy, const float* mean,
                                           const float* rstd, const float* weight,
                                           const float* bias, float* part, int N, long long P,
                                           int C, int G, int vw, long long pps, int relu,
                                           int is_bf16, void* stream) {
    int slabs = 0;
    const int e = check_stream(N, P, C, G, vw, is_bf16, pps, slabs, {x, dy});
    if (e) return e;
    return BN_TRAIN_DISPATCH(is_bf16, vw, run_grad_reduce, x, dy, mean, rstd, weight, bias, part, N,
                             P, C, G, pps, slabs, relu, static_cast<cudaStream_t>(stream));
}

extern "C" int bn_train_grad_finalize_launch(const float* part, float* sums, float* dweight,
                                             float* dbias, int N, long long P, int C, int G,
                                             long long pps, void* stream) {
    int slabs = 0;
    const int e = check_stream(N, P, C, G, 1, 0, pps, slabs, {});
    if (e) return e;
    grad_finalize_kernel<<<1, FIN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        part, sums, dweight, dbias, N, P, C, G, pps, slabs);
    return (int)cudaGetLastError();
}

extern "C" int bn_train_dx_launch(const void* x, const void* dy, void* dx, const float* mean,
                                  const float* rstd, const float* weight, const float* bias,
                                  const float* sums, int N, long long P, int C, int G, int vw,
                                  long long pps, int relu, float inv_n, int is_bf16,
                                  void* stream) {
    int slabs = 0;
    const int e = check_stream(N, P, C, G, vw, is_bf16, pps, slabs, {x, dy, dx});
    if (e) return e;
    return BN_TRAIN_DISPATCH(is_bf16, vw, run_dx, x, dy, dx, mean, rstd, weight, bias, sums, N, P, C,
                             G, pps, slabs, relu, inv_n, static_cast<cudaStream_t>(stream));
}
