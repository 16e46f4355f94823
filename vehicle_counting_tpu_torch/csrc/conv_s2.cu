// YOLO layer 1 as one kernel: silu(conv3x3 stride 2 pad 1 (x, w) + b),
// x [B, H, W, 32] NHWC in T (bf16 or f32), w HWIO [3, 3, 32, 64] in T,
// b [64] f32, out [B, H/2, W/2, 64] in T. f32 accumulation, bias and SiLU
// in f32.
//
// Replaces the TPU kernel vehicle_counting_tpu/ops/pallas/conv_s2.py
// (conv1_s2_silu_pallas, body _conv1_kernel_body). The TPU kernel packed
// four pixels' channels into 128 lanes and ran one block-structured MXU
// matmul per 16 output rows; here the convolution is direct.
//
// Bound on the H100: at [128, 384, 640, 32] bf16 the kernel moves ~0.75 GB
// (0.22 ms at 3.35 TB/s) and does 36 G FMAs, ~1.1 ms on the CUDA cores at
// peak, so this first version (no tensor cores) is compute-bound. Design:
// one block per 8 x 16 output tile, all 64 channels. The 17 x 33 x 32
// input window sits in shared memory channel-major, so the stride-2 reads
// of a warp's 16 output columns hit distinct banks; out-of-image taps are
// zeros written at load time (the pad). 8 warps: warp w owns output
// channels 8w .. 8w+8; lane l owns column l % 16 and rows l / 16 + 2j,
// j < 4. Per (tap, input channel): 4 shared loads, one uniform vector
// weight load (broadcast through L1), 32 FMAs. Stores are 8 channels wide.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv_util.cuh"

namespace {

using vct_conv::from_f;
using vct_conv::load8;
using vct_conv::store8;
using vct_conv::to_f;

constexpr int CIN = 32;
constexpr int COUT = 64;
constexpr int TH = 8;             // output rows per block
constexpr int TW = 16;            // output columns per block
constexpr int PH = 2 * TH + 1;    // input window rows
constexpr int PW = 2 * TW + 1;    // input window columns
constexpr int PPLANE = PH * PW;   // window pixels per channel
constexpr int NT = 256;
constexpr int PX = 4;             // output rows per thread

template <typename T>
__global__ void __launch_bounds__(NT)
    conv1_s2_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
                    T* __restrict__ out, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);  // [CIN][PH][PW]
  const int OH = H / 2, OW = W / 2;
  const int ox0 = blockIdx.x * TW, oy0 = blockIdx.y * TH, b = blockIdx.z;
  const int t = threadIdx.x;

  const int iy0 = 2 * oy0 - 1, ix0 = 2 * ox0 - 1;
  const T* xb = x + (size_t)b * H * W * CIN;
  for (int i = t; i < PPLANE * CIN; i += NT) {
    const int ci = i % CIN, pix = i / CIN;
    const int r = pix / PW, cc = pix - r * PW;
    const int iy = iy0 + r, ix = ix0 + cc;
    const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
    xs[ci * PPLANE + pix] = in ? xb[((size_t)iy * W + ix) * CIN + ci] : from_f<T>(0.0f);
  }
  __syncthreads();

  const int lane = t & 31;
  const int co0 = (t >> 5) * 8;
  const int oxl = lane & 15;
  const int oyl0 = lane >> 4;
  float acc[PX][8];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[j][k] = 0.0f;
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    const T* sp = xs + dy * PW + 2 * oxl + dx;
    const T* wp = w + tap * CIN * COUT + co0;
#pragma unroll 4
    for (int ci = 0; ci < CIN; ++ci) {
      float wv[8];
      load8(wp + ci * COUT, wv);
      float xv[PX];
#pragma unroll
      for (int j = 0; j < PX; ++j) xv[j] = to_f(sp[ci * PPLANE + 2 * (oyl0 + 2 * j) * PW]);
#pragma unroll
      for (int j = 0; j < PX; ++j)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[j][k] = fmaf(xv[j], wv[k], acc[j][k]);
    }
  }

  float bv[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) bv[k] = __ldg(bias + co0 + k);
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int oy = oy0 + oyl0 + 2 * j, ox = ox0 + oxl;
    float y[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float v = acc[j][k] + bv[k];
      y[k] = v / (1.0f + expf(-v));  // SiLU, as torch's silu
    }
    store8(out + (((size_t)b * OH + oy) * OW + ox) * COUT + co0, y);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* out, int B, int H, int W, cudaStream_t stream) {
  const size_t smem = (size_t)CIN * PPLANE * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(conv1_s2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(W / 2 / TW, H / 2 / TH, B);
  conv1_s2_kernel<T><<<grid, NT, smem, stream>>>((const T*)x, (const T*)w, (const float*)bias, (T*)out, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// Needs H % 16 == 0 and W % 32 == 0 (the wrapper asks for the TPU
// kernel's H % 32 == 0 and W % 64 == 0).
extern "C" int vct_conv1_s2_silu(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
                                 int bf16, void* stream) {
  if (B <= 0) return 0;
  if (H % (2 * TH) != 0 || W % (2 * TW) != 0) return (int)cudaErrorInvalidValue;
  if (bf16) return launch<__nv_bfloat16>(x, w, bias, out, B, H, W, (cudaStream_t)stream);
  return launch<float>(x, w, bias, out, B, H, W, (cudaStream_t)stream);
}
