// K4: the plain plane-sweep bilinear warp forward, one source view.
//
// Replaces the TPU kernels that compute this function from precomputed
// coordinate planes, each truncated to a band of source rows (and columns):
//   deep_reconstruction_with_epipolar_lines_mvster_tpu/ops/pallas/
//     warp_fwd_v3.py:522 warp_tiles_pallas_v3 without ref (_kernel :42,
//       _kernel_xchunk :89), reached through ops/warp_mxu._warp_v3;
//     warp_xband_kernel.py:111 warp_tiles_pallas_xband (_kernel :48);
//     warp_kernel.py:83 warp_tiles_pallas (_kernel :35),
// and computes out[b,d,y,x,c] = bilinear(src[b], coords(b,d,y,x))[c] with
// zeros padding, as core/geometry.grid_sample_2d at warp_coords does, in
// float32, stored in the source dtype.
//
// The TPU kernels are banded matmuls because the TPU has no fast gather;
// they drop taps outside their band. Here the natural form is a direct,
// exact gather.
//
// Bound on an H100: bytes. Each output element costs 4 taps (8 FLOPs) and
// one store; per pixel the function reads its depth (4 B), writes C values
// and reads the source, which the D hypotheses and neighbouring pixels
// share through L1/L2. The least traffic is the source read once, the
// hypotheses read once and the output written once: at the DTU recipe's
// stage 4 (B6 D4 512x640 C8, bf16) that is ~126 MB of output plus ~31 MB
// of hypotheses and ~31 MB of source, 56 us at 3.35 TB/s; the output is
// 80% of the bytes of every stage.
//
// The design (the second; the first took one thread per (b, d, y, x,
// 8 channels), rebuilt its coordinates from a flat index with three 64-bit
// divisions and recomputed a pixel's taps in each of its C/8 threads, and
// issued about as many instructions as the bound allows bytes):
//   - no flat-index division: grid.x walks the rows b*H + y, grid.y the x
//     tiles of a row, grid.z chunks of planes (common.cuh:sweep_plan); a
//     thread is one 8-channel lane of a pixel, the C/8 lanes of a pixel
//     neighbours in a warp, so a warp's 16-byte (bf16) or 32-byte (float32)
//     stores are contiguous along x and C;
//   - a pixel's lanes walk its D planes (common.cuh:sweep): the d-independent
//     part of the coordinates once per pixel, the taps of each plane once,
//     by one lane of the pixel, and sent to the others by __shfl_sync; the
//     depths of up to four planes are loaded before any taps are computed;
//   - the taps carry the four corners as 32-bit element offsets
//     (common.cuh:Tap4), so a lane forms each address with one
//     multiply-add; it issues the four corner loads before it widens any
//     (a bf16 to float32 by one shift or one mask);
//   - the output, not read again by this kernel, is stored with the
//     evict-first hint (st.global.cs), so that L2 keeps the source rows that
//     the gathers of neighbouring rows and planes reuse;
//   - the arithmetic is the first design's: the same coordinates, taps and
//     weights (common.cuh, shared with K1 and K3; the _rn intrinsics stop
//     nvcc from contracting into FMAs) and the four taps summed in the plain
//     version's order, ((a*w00 + b*w10) + c*w01) + d*w11, bit for bit.
// What bounds it now, on an H100 at stage 4 (C 8, one lane a pixel): the
// instructions of a (pixel, plane), the taps with their two IEEE
// divisions, the four-tap sum (56 float32 operations) and the widening
// (32), against 16 bytes stored; issue and memory overlap only in part.
// Loading more planes' depths or taps at once, capping the registers,
// other CTA shapes and more CTAs per SM measured no faster (PERF.md).
//
// Any channel count: the stages' widths C in {8, 16, 32, 64} (FPN base 8)
// have an instance with C fixed at compile time, C/8 lanes of 8 channels a
// pixel; every other C (any --fpn_base_channel) takes the generic instance,
// the same sweep with C read at run time: lanes of 8, 4 or 1 channels (the
// widest that divides C, so that loads and stores stay aligned), as many
// lanes a pixel as the largest power of two up to 32 that divides C / VW,
// each lane looping over its share of the VW-channel chunks (one lane a
// pixel is an instance of its own, which loads four depths at once).

#include <stdint.h>

#include "common.cuh"

namespace {

using port::corners;
using port::pixel_rows;
using port::PixelRows;
using port::storev_cs;
using port::sweep;
using port::SweepPlan;
using port::Tap4;

constexpr int THREADS = 256;

// CT > 0: C fixed at compile time, VW 8, C/8 lanes a pixel; CT == 0: the
// generic instance, C = c_rt, and NL lanes a pixel, or nl_rt where NL == 0
// (one lane a pixel is fixed at compile time, so that its sweep loads the
// depths of four planes at once, as C 8's does).
template <typename T, int CT, int VW, int NL>
__global__ void __launch_bounds__(THREADS) warp_fwd_kernel(
    const T* __restrict__ src,      // [B, Hs, Ws, C]
    const float* __restrict__ rel,  // [B, 4, 4], rows 0..2 used
    const float* __restrict__ hypo, // [B, D, H, W]
    T* __restrict__ out,            // [B, D, H, W, C]
    int B, int D, int H, int W, int Hs, int Ws, int c_rt, int nl_rt, int dchunk) {
    constexpr int NL_CT = CT > 0 ? CT / VW : NL;
    const int C = CT > 0 ? CT : c_rt;
    const int nl = NL_CT > 0 ? NL_CT : nl_rt;
    const int cpl = CT > 0 ? 1 : C / (VW * nl);     // VW-channel chunks a lane
    const int lane = threadIdx.x & (nl - 1);
    const int xt = (int)((blockIdx.y * blockDim.x + threadIdx.x) / nl);
    const unsigned row = blockIdx.x * blockDim.y + threadIdx.y;    // b*H + y
    const bool active = xt < W && row < (unsigned)B * (unsigned)H;
    const int b = active ? (int)(row / (unsigned)H) : 0;
    const int y = active ? (int)row - b * H : 0;
    const int x = active ? xt : 0;

    const PixelRows pr = pixel_rows(rel + 16 * b, x, y);
    const long long plane = (long long)H * W;
    const long long pix = ((long long)b * D * H + y) * W + x;      // (b, 0, y, x)
    const T* img = src + (long long)b * Hs * Ws * C + lane * cpl * VW;
    const int dbeg = blockIdx.z * dchunk;
    const int dend = min(D, dbeg + dchunk);
    T* od = out + (pix + dbeg * plane) * C + lane * cpl * VW;   // plane dbeg's pixel
    sweep<NL_CT>(pr, hypo + pix, plane, dbeg, dend, nl, lane, active, Hs, Ws, C,
                 [&](int, const Tap4& t) {
        T* o = od;                  // the planes come in order: the next one's
        od += plane * C;
        if (!active) return;
#pragma unroll
        for (int k = 0; k < cpl; ++k) {
            float s[VW];
            if (t.o00 < 0) {
#pragma unroll
                for (int i = 0; i < VW; ++i) s[i] = 0.0f;
                storev_cs<VW>(o + k * VW, s);
                continue;
            }
            float a[VW], bq[VW], cq[VW], dq[VW];
            corners<VW>(img, t, k * VW, a, bq, cq, dq);
#pragma unroll
            for (int i = 0; i < VW; ++i) {
                float v = __fmul_rn(a[i], t.w00);
                v = __fadd_rn(v, __fmul_rn(bq[i], t.w10));
                v = __fadd_rn(v, __fmul_rn(cq[i], t.w01));
                s[i] = __fadd_rn(v, __fmul_rn(dq[i], t.w11));
            }
            storev_cs<VW>(o + k * VW, s);
        }
    });
}

// VW-channel lanes a pixel: C/8 for the compile-time instances; for the
// generic one the largest power of two up to 32 that divides C / VW
int lanes(int C, int VW, bool fast) {
    if (fast) return C / 8;
    const int chunks = C / VW;
    int nl = 1;
    while (nl < 32 && chunks % (2 * nl) == 0) nl *= 2;
    return nl;
}

int vec_width(int C) { return C % 8 == 0 ? 8 : C % 4 == 0 ? 4 : 1; }

bool is_fast(int C) { return C == 8 || C == 16 || C == 32 || C == 64; }

template <typename T, int CT, int VW, int NL>
void launch_kernel(const SweepPlan& p, const void* src, const void* rel, const void* hypo,
                   void* out, int B, int D, int H, int W, int Hs, int Ws, int C,
                   cudaStream_t stream) {
    warp_fwd_kernel<T, CT, VW, NL><<<dim3(p.gx, p.gy, p.gz), dim3(p.tx, p.ty), 0, stream>>>(
        static_cast<const T*>(src), static_cast<const float*>(rel),
        static_cast<const float*>(hypo), static_cast<T*>(out), B, D, H, W, Hs, Ws, C, p.nl,
        p.dchunk);
}

template <typename T, int CT, int VW>
int launch(const void* src, const void* rel, const void* hypo, void* out, int B, int D, int H,
           int W, int Hs, int Ws, int C, cudaStream_t stream) {
    SweepPlan p;
    if (!port::sweep_plan(B, D, H, W, Hs, Ws, C, lanes(C, VW, CT > 0), 2, p))
        return (int)cudaErrorInvalidConfiguration;
    constexpr int NL1 = CT > 0 ? 0 : 1;     // the generic instance of one lane a pixel
    if (CT == 0 && p.nl == 1)
        launch_kernel<T, CT, VW, NL1>(p, src, rel, hypo, out, B, D, H, W, Hs, Ws, C, stream);
    else
        launch_kernel<T, CT, VW, 0>(p, src, rel, hypo, out, B, D, H, W, Hs, Ws, C, stream);
    return (int)cudaGetLastError();
}

#define WARP_FWD_ARGS src, rel, hypo, out, B, D, H, W, Hs, Ws, C, s

template <typename T>
int launch_c(int C, const void* src, const void* rel, const void* hypo, void* out,
             int B, int D, int H, int W, int Hs, int Ws, cudaStream_t s) {
    switch (C) {
        case 8: return launch<T, 8, 8>(WARP_FWD_ARGS);
        case 16: return launch<T, 16, 8>(WARP_FWD_ARGS);
        case 32: return launch<T, 32, 8>(WARP_FWD_ARGS);
        case 64: return launch<T, 64, 8>(WARP_FWD_ARGS);
        default: break;
    }
    if (C % 8 == 0) return launch<T, 0, 8>(WARP_FWD_ARGS);
    if (C % 4 == 0) return launch<T, 0, 4>(WARP_FWD_ARGS);
    return launch<T, 0, 1>(WARP_FWD_ARGS);
}

}  // namespace

// Any C >= 1: C in {8, 16, 32, 64} takes its compile-time instance, any
// other the generic one. src and out 16-byte aligned; B*H and Hs*Ws*C
// under 2^31. Returns cudaGetLastError() after the launch.
extern "C" int warp_fwd_launch(const void* src, const void* rel, const void* hypo, void* out,
                               int B, int D, int H, int W, int Hs, int Ws, int C,
                               int is_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return launch_c<__nv_bfloat16>(C, src, rel, hypo, out, B, D, H, W, Hs, Ws, s);
    return launch_c<float>(C, src, rel, hypo, out, B, D, H, W, Hs, Ws, s);
}

// The launch shape warp_fwd_launch takes for a shape: plan[0..5] = fast
// instance (1) or generic (0), lanes a pixel, channels a lane's load, CTA
// threads along x, CTA rows, planes a CTA. Returns 0, or 1 when the shape
// exceeds the grid's limits.
extern "C" int warp_fwd_plan(int B, int D, int H, int W, int Hs, int Ws, int C, int* plan) {
    const bool fast = is_fast(C);
    const int vw = fast ? 8 : vec_width(C);
    SweepPlan p;
    if (!port::sweep_plan(B, D, H, W, Hs, Ws, C, lanes(C, vw, fast), 2, p)) return 1;
    plan[0] = fast;
    plan[1] = p.nl;
    plan[2] = vw;
    plan[3] = p.tx;
    plan[4] = p.ty;
    plan[5] = p.dchunk;
    return 0;
}
