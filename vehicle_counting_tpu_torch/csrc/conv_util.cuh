// Element helpers shared by the direct-convolution (f32 parity) kernels of
// reid_block.cu and conv_s2.cu: 8-wide vector loads and stores of
// consecutive channels (32-byte aligned).

#pragma once

#include <cuda_runtime.h>

namespace vct_conv {

// w[0..8) <- p[0..8), read-only path
__device__ __forceinline__ void load8(const float* p, float w[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// p[0..8) <- v[0..8)
__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

}  // namespace vct_conv
