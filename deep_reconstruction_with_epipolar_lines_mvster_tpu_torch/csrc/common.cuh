// Device helpers shared by the port's kernels: eight channels of an NHWC
// pixel as one 16-byte load (bf16) or two (float32), widened to float32,
// and one float32 value stored in the tensor's dtype.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

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

}  // namespace port
