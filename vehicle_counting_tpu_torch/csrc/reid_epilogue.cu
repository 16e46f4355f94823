// The ReID trunk's BatchNorm epilogue (K8): everything between one
// convolution and the next, in one pass over the activations.
//
// Replaces no TPU kernel. On the TPU, XLA fuses the elementwise chain that
// follows each convolution of `models/reid.py` into one loop; PyTorch runs
// it eagerly, one launch per op: the conv output's cast to f32, the stem's
// bias, BN's subtract, two multiplies and add, the residual add, the ReLU
// and the next convolution's cast to bf16, 8-10 launches and as many f32
// round trips through device memory per convolution. Here, per element i
// of channel c (x the convolution's raw output, bf16 or f32):
//
//   y = x                          (+ pre_bias[c]: the stem's conv bias)
//   y = ((y - mean[c]) * inv[c]) * scale[c] + bias[c]
//   y = residual[i] + y            (optional: the BasicBlock's shortcut)
//   y = relu(y)                    (optional; a NaN passes, as torch.relu)
//   out_f32[i] = y, out_lo[i] = bf16(y)   (either or both)
//
// Every step rounds to f32 in the eager chain's order (__fadd_rn,
// __fsub_rn, __fmul_rn: no contraction into FMA, besides the build's
// --fmad=false), and bf16 rounds to nearest even as torch's cast does, so
// the outputs are bitwise the eager chain's. inv = rsqrt(var + eps) comes
// from the wrapper, computed by torch as before.
//
// Layout: x, residual and the outputs share one memory order, NCHW or
// channels-last (NHWC): the kernel walks memory linearly and derives each
// element's channel, so the outputs keep the layout the convolution chose
// and the next convolution finds the same one.
//
// Bound on the H100: bytes. The stem's [128, 64, 50, 50] reads 41 MB of
// bf16 and writes 82 MB of f32: 36.7 us at 3.35 TB/s, about 2 operations
// per byte. Each thread moves 8 elements with 16-byte loads and stores
// (bf16 in: one load; f32: two), the channel advanced by a counter rather
// than a division per element; the BN vectors come through the read-only
// cache. A tensor whose size is not a multiple of 8 or whose pointers are
// not 16-byte aligned takes the one-element-per-thread kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;  // 2048 resident threads per SM

struct Args {
  const void* x;
  const float* mean;
  const float* inv;
  const float* scale;
  const float* bias;
  const float* pre_bias;  // or nullptr
  const float* residual;  // or nullptr
  float* out_f32;         // or nullptr
  __nv_bfloat16* out_lo;  // or nullptr
  long long total;
  int c;
  int hw;
  bool relu;
};

__device__ __forceinline__ float bn(const Args& a, float v, int c) {
  if (a.pre_bias) v = __fadd_rn(v, __ldg(a.pre_bias + c));
  v = __fsub_rn(v, __ldg(a.mean + c));
  v = __fmul_rn(v, __ldg(a.inv + c));
  v = __fmul_rn(v, __ldg(a.scale + c));
  return __fadd_rn(v, __ldg(a.bias + c));
}

__device__ __forceinline__ float relu(float v) { return isnan(v) ? v : fmaxf(v, 0.0f); }

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // element 2k in the low half: bf16 -> f32 is exact
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ float load1(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p, long long i) { return __bfloat162float(p[i]); }

// 8 consecutive elements per thread and step of a grid-stride loop
template <typename T, bool CL>
__global__ void __launch_bounds__(THREADS) reid_epilogue_vec8(Args a) {
  const T* x = static_cast<const T*>(a.x);
  const long long nvec = a.total >> 3;
  for (long long v = (long long)blockIdx.x * THREADS + threadIdx.x; v < nvec; v += (long long)gridDim.x * THREADS) {
    const long long i0 = v << 3;
    float y[8], r[8];
    load8(x + i0, y);
    if (a.residual) load8(a.residual + i0, r);
    int c, pos = 0;  // channel, and (NCHW) the position inside the channel's plane
    if (CL) {
      c = (int)(i0 % a.c);
    } else {
      const long long plane = i0 / a.hw;
      pos = (int)(i0 - plane * a.hw);
      c = (int)(plane % a.c);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float t = bn(a, y[j], c);
      if (a.residual) t = __fadd_rn(r[j], t);
      y[j] = a.relu ? relu(t) : t;
      if (CL) {
        if (++c == a.c) c = 0;
      } else if (++pos == a.hw) {
        pos = 0;
        if (++c == a.c) c = 0;
      }
    }
    if (a.out_f32) {
      *reinterpret_cast<float4*>(a.out_f32 + i0) = make_float4(y[0], y[1], y[2], y[3]);
      *reinterpret_cast<float4*>(a.out_f32 + i0 + 4) = make_float4(y[4], y[5], y[6], y[7]);
    }
    if (a.out_lo) {
      *reinterpret_cast<uint4*>(a.out_lo + i0) =
          make_uint4(pack2(y[0], y[1]), pack2(y[2], y[3]), pack2(y[4], y[5]), pack2(y[6], y[7]));
    }
  }
}

// one element per thread and step: sizes or pointers the vector kernel does not take
template <typename T, bool CL>
__global__ void __launch_bounds__(THREADS) reid_epilogue_scalar(Args a) {
  const T* x = static_cast<const T*>(a.x);
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < a.total; i += (long long)gridDim.x * THREADS) {
    const int c = CL ? (int)(i % a.c) : (int)((i / a.hw) % a.c);
    float t = bn(a, load1(x, i), c);
    if (a.residual) t = __fadd_rn(a.residual[i], t);
    if (a.relu) t = relu(t);
    if (a.out_f32) a.out_f32[i] = t;
    if (a.out_lo) a.out_lo[i] = __float2bfloat16_rn(t);
  }
}

template <typename T, bool CL>
void launch(const Args& a, bool vec, int max_blocks, cudaStream_t stream) {
  const long long items = vec ? a.total >> 3 : a.total;
  long long blocks = (items + THREADS - 1) / THREADS;
  if (blocks > max_blocks) blocks = max_blocks;
  if (vec) {
    reid_epilogue_vec8<T, CL><<<(int)blocks, THREADS, 0, stream>>>(a);
  } else {
    reid_epilogue_scalar<T, CL><<<(int)blocks, THREADS, 0, stream>>>(a);
  }
}

int sm_count() {
  static int counts[64] = {0};  // per device ordinal, read once
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0) n = 132;
    counts[dev] = n;
  }
  return counts[dev];
}

}  // namespace

// x: the convolution's output, [N, C, H, W] in NCHW (channels_last = 0) or
// channels-last order, bf16 (x_bf16 = 1) or f32; mean, inv, scale, bias
// (and pre_bias where not null) [C] f32; residual, out_f32 and out_lo in
// x's order, each null where unused (out_f32 / out_lo: at least one).
// Returns a cudaError_t.
extern "C" int vct_reid_epilogue(const void* x, int x_bf16, const float* mean, const float* inv, const float* scale,
                                 const float* bias, const float* pre_bias, const float* residual, float* out_f32,
                                 void* out_lo, long long total, int c, int hw, int channels_last, int relu,
                                 void* stream) {
  if (total <= 0) return 0;
  if (c <= 0 || hw <= 0 || (!out_f32 && !out_lo)) return (int)cudaErrorInvalidValue;
  const Args a{x, mean, inv, scale, bias, pre_bias, residual, out_f32, static_cast<__nv_bfloat16*>(out_lo),
               total, c, hw, relu != 0};
  const uintptr_t ptrs = (uintptr_t)x | (uintptr_t)residual | (uintptr_t)out_f32 | (uintptr_t)out_lo;
  const bool vec = total % 8 == 0 && (ptrs & 15) == 0;
  const int max_blocks = sm_count() * BLOCKS_PER_SM;
  const cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16) {
    if (channels_last) launch<__nv_bfloat16, true>(a, vec, max_blocks, s);
    else launch<__nv_bfloat16, false>(a, vec, max_blocks, s);
  } else {
    if (channels_last) launch<float, true>(a, vec, max_blocks, s);
    else launch<float, false>(a, vec, max_blocks, s);
  }
  return (int)cudaGetLastError();
}
