// Eval-mode BatchNorm with an optional ReLU as one pass over activations
// whose last axis is the channels (NHWC, or the folded cost volume):
//   scale[c] = weight[c] * (1 / sqrt(running_var[c] + eps))
//   shift[c] = bias[c] - running_mean[c] * scale[c]
//   out[..., c] = max(x[..., c] * scale[c] + shift[c], 0)      (relu)
//   out[..., c] = x[..., c] * scale[c] + shift[c]              (no relu)
// in float32, x widened from bf16 or float32 and the result rounded once to
// x's dtype: the arithmetic of K6's epilogue (band_conv.cu, two roundings,
// no FMA) on BatchNorm's own four [C] tensors.
//
// Replaces no Pallas kernel. On the TPU, XLA fused this affine map and the
// ReLU into the neighbouring convolution, so the JAX package has none; the
// port, which runs the convolution library's conv and then the norm, had it
// as a chain of PyTorch elementwise kernels (cast to float32, subtract,
// rsqrt, multiply, affine, cast back, ReLU: ~9 launches and ~48 bytes moved
// per bf16 element, ~40 per float32 one).
//
// It does no arithmetic to speak of, so it is bound by bytes: x read once
// and out written once, 2 x numel x itemsize (4 bytes a bf16 element, 8 a
// float32 one). The design meets that bound as follows:
//   - Every thread moves 16 bytes per load and per store (8 bf16 or 4
//     float32 values), neighbouring threads on neighbouring addresses, and
//     has two such loads in flight before it computes either; a grid-stride
//     loop over as many CTAs as are resident on the card at once.
//   - A CTA forms scale and shift of every channel in shared memory before
//     its loop, from the four [C] tensors as they are at launch: no fold in
//     a separate launch, and nothing stale when a captured graph replays
//     after the statistics or the affine parameters change in place. The
//     table holds C + 8 entries, entry i for channel i % C, so a vector
//     that starts at channel c reads entries c .. c + 7 without wrapping,
//     whatever C is; where C is a multiple of the vector width, it reads
//     them as float4.
//   - A vector's first channel is carried from one step of the loop to the
//     next (one add and one compare): no division per element.
//   - The numel % width last elements go one by one, and so does all of x
//     where x or out does not start on 16 bytes.
// out is a fresh tensor: it never aliases x.

#include "common.cuh"

namespace {

using port::ldraw;
using port::Raw;
using port::storev;
using port::widen;

constexpr int THREADS = 256;
constexpr int UNROLL = 2;          // vectors a thread loads before it computes any
constexpr int TABLE_PAD = 8;       // extra table entries: the widest vector
// the widest C: the table's 2 (C + TABLE_PAD) floats fit the 48 KB of shared
// memory a launch gets without opting in
constexpr int MAX_CHANNELS = 4096;

// y of one element in float32, before the rounding to x's dtype
__device__ __forceinline__ float affine(float v, float scale, float shift, bool relu) {
    const float y = __fadd_rn(__fmul_rn(v, scale), shift);
    // NaN stays NaN, as F.relu leaves it
    return relu && y < 0.0f ? 0.0f : y;
}

// VW elements of x per vector (16 bytes, or 1 where x or out is not 16-byte
// aligned); CH_ALIGNED: C % VW == 0, so that a vector starts on a channel
// that is a multiple of VW and its table entries load as float4
template <typename T, int VW, bool CH_ALIGNED>
__global__ void __launch_bounds__(THREADS)
norm_act_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ weight,
                const float* __restrict__ bias, const float* __restrict__ mean,
                const float* __restrict__ var, long long n, int C, float eps, int relu_flag) {
    extern __shared__ __align__(16) float table[];
    float* s_scale = table;                        // [C + TABLE_PAD]
    float* s_shift = table + C + TABLE_PAD;        // [C + TABLE_PAD]
    for (int i = threadIdx.x; i < C + TABLE_PAD; i += THREADS) {
        const int c = i % C;
        const float sc = __fmul_rn(__ldg(weight + c),
                                   __frcp_rn(__fsqrt_rn(__fadd_rn(__ldg(var + c), eps))));
        s_scale[i] = sc;
        s_shift[i] = __fsub_rn(__ldg(bias + c), __fmul_rn(__ldg(mean + c), sc));
    }
    __syncthreads();
    const bool relu = relu_flag != 0;

    const long long stride = (long long)gridDim.x * THREADS;     // vectors
    const long long nv = n / VW;
    const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
    // the first channel of each of this thread's UNROLL vectors, and how far
    // it moves a step of the loop (UNROLL * stride vectors)
    const int step_c = (int)((UNROLL * stride * VW) % C);
    int c0[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) c0[u] = (int)(((first + u * stride) * VW) % C);

    for (long long base = first; base < nv; base += UNROLL * stride) {
        Raw<VW, T> raw[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long v = base + u * stride;
            if (v < nv) raw[u] = ldraw<VW>(x + v * VW);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long v = base + u * stride;
            if (v < nv) {
                float f[VW];
                widen(raw[u], f);
                const int c = c0[u];
                if constexpr (CH_ALIGNED && VW % 4 == 0) {
#pragma unroll
                    for (int q = 0; q < VW / 4; ++q) {
                        const float4 sc = *reinterpret_cast<const float4*>(s_scale + c + 4 * q);
                        const float4 sh = *reinterpret_cast<const float4*>(s_shift + c + 4 * q);
                        f[4 * q] = affine(f[4 * q], sc.x, sh.x, relu);
                        f[4 * q + 1] = affine(f[4 * q + 1], sc.y, sh.y, relu);
                        f[4 * q + 2] = affine(f[4 * q + 2], sc.z, sh.z, relu);
                        f[4 * q + 3] = affine(f[4 * q + 3], sc.w, sh.w, relu);
                    }
                } else {
#pragma unroll
                    for (int j = 0; j < VW; ++j)
                        f[j] = affine(f[j], s_scale[c + j], s_shift[c + j], relu);
                }
                storev<VW>(out + v * VW, f);
            }
            c0[u] += step_c;
            if (c0[u] >= C) c0[u] -= C;
        }
    }
    // the last n % VW elements, one a thread
    for (long long i = nv * VW + first; i < n; i += stride) {
        const int c = (int)(i % C);
        port::store1(out + i, affine(port::ldg1(x + i), s_scale[c], s_shift[c], relu));
    }
}

template <typename T, int VW, bool CH_ALIGNED>
int launch(const void* x, void* out, const float* weight, const float* bias, const float* mean,
           const float* var, long long n, int C, float eps, int relu, cudaStream_t s) {
    auto kernel = norm_act_kernel<T, VW, CH_ALIGNED>;
    const size_t smem = 2 * (size_t)(C + TABLE_PAD) * sizeof(float);
    // CTAs resident a SM at this table size, looked up once an instance and C
    static int per_sm[MAX_CHANNELS + 1];
    if (per_sm[C] <= 0) {
        int k = 0;
        const cudaError_t e =
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k, kernel, THREADS, smem);
        if (e != cudaSuccess) return (int)e;
        per_sm[C] = std::max(k, 1);
    }
    const long long ctas = (n / VW + THREADS - 1) / THREADS;
    const long long grid =
        std::max(1LL, std::min(ctas, (long long)per_sm[C] * port::sm_count()));
    kernel<<<(unsigned)grid, THREADS, smem, s>>>(static_cast<const T*>(x), static_cast<T*>(out),
                                                 weight, bias, mean, var, n, C, eps, relu);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const void* x, void* out, const float* weight, const float* bias,
                 const float* mean, const float* var, long long n, int C, float eps, int relu,
                 cudaStream_t s) {
    constexpr int VEC = 16 / sizeof(T);
    if (((uintptr_t)x | (uintptr_t)out) % 16)
        return launch<T, 1, true>(x, out, weight, bias, mean, var, n, C, eps, relu, s);
    if (C % VEC == 0)
        return launch<T, VEC, true>(x, out, weight, bias, mean, var, n, C, eps, relu, s);
    return launch<T, VEC, false>(x, out, weight, bias, mean, var, n, C, eps, relu, s);
}

}  // namespace

// out = the eval BatchNorm (and ReLU where relu != 0) of x: n elements,
// contiguous, channels C the last axis (n a multiple of C), bf16 where
// is_bf16 else float32; weight, bias, mean and var float32 [C]. The caller
// keeps 1 <= C <= MAX_CHANNELS and n >= 1. Returns cudaGetLastError()
// after the launch.
extern "C" int norm_act_launch(const void* x, void* out, const float* weight, const float* bias,
                               const float* mean, const float* var, long long n, int C,
                               float eps, int relu, int is_bf16, void* stream) {
    if (C < 1 || C > MAX_CHANNELS || n < 1 || n % C)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return launch_dtype<__nv_bfloat16>(x, out, weight, bias, mean, var, n, C, eps, relu, s);
    return launch_dtype<float>(x, out, weight, bias, mean, var, n, C, eps, relu, s);
}
