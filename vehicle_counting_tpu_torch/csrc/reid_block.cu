// Fused ReID stage-1 BasicBlock on [N, 64, 25, 25] crops:
//   out = relu(bn2(conv3x3(h1)) + x),  h1 = relu(bn1(conv3x3(x)))
// with inference BN folded to a*v + b (a, b in f32, computed by the caller).
//
// Replaces the TPU kernel vehicle_counting_tpu/ops/pallas/reid_block.py
// (reid_block64_pallas, body _block_kernel). Same numerics: conv operands
// in the compute dtype T (bf16 or f32), f32 accumulation, h1 rounded to T
// and zero outside the crop (the pad), residual added in f32, output in T.
// The TPU kernel built a [G*650, 576] patch matrix per conv for the MXU;
// here the convolutions are direct, with the activations in shared memory.
//
// Layout: NCHW, the port's ReID layout (models/reid.py), so no transpose
// is added around the block; weights are HWIO [3, 3, 64, 64] in T (8
// consecutive output channels are one 16- or 32-byte load).
//
// Bound on the H100: FLOPs on the CUDA cores (2 x 625 x 64 x 576 FMAs per
// crop; 177 G FMAs at N = 3840), since this first version uses no tensor
// cores. Design: one persistent block per SM walks the crops. The padded
// 27x27x64 tiles of x and h1 sit in shared memory (bf16: 2 x 93,312 B; for
// f32 only the h1 tile fits, 186,624 B, and x is read from a zero-padded
// copy in global memory). 16 warps: warp w owns output channels
// 8 (w % 8) .. +8 and a 32-pixel lane slice; each thread accumulates 5
// pixels x 8 channels in registers per pass (2 passes cover 625 pixels).
// Per (tap, input channel) a thread does 5 shared loads (consecutive
// pixels across the warp: no bank conflicts), one uniform vector weight
// load (broadcast through L1) and 40 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv_util.cuh"

namespace {

using vct_conv::from_f;
using vct_conv::load8;
using vct_conv::to_f;

constexpr int S = 25;        // crop side
constexpr int P = S * S;     // 625 pixels
constexpr int SP = S + 2;    // padded side
constexpr int TP = SP * SP;  // 729 padded pixels per channel
constexpr int C = 64;
constexpr int NT = 512;      // threads: 8 channel groups x 2 pixel slices x 32 lanes
constexpr int PX = 5;        // pixels per thread per pass
constexpr int PSTRIDE = 64;  // pixel stride between a thread's pixels
constexpr int NPASS = 2;     // 2 x 5 x 64 = 640 >= 625

// acc[j][k] = sum over taps and input channels of src * w, for this
// thread's pixels (padded window origins base[j]) and channels co0 + k
template <typename T>
__device__ __forceinline__ void conv3x3(const T* src, const T* __restrict__ w, const int base[PX], int co0,
                                        float acc[PX][8]) {
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[j][k] = 0.0f;
  for (int tap = 0; tap < 9; ++tap) {
    const T* sp = src + (tap / 3) * SP + (tap % 3);
    const T* wp = w + tap * C * C + co0;
#pragma unroll 2
    for (int ci = 0; ci < C; ++ci) {
      float wv[8];
      load8(wp + ci * C, wv);
      float xv[PX];
#pragma unroll
      for (int j = 0; j < PX; ++j) xv[j] = to_f(sp[ci * TP + base[j]]);
#pragma unroll
      for (int j = 0; j < PX; ++j)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[j][k] = fmaf(xv[j], wv[k], acc[j][k]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
    reid_block_kernel(const T* __restrict__ x, const T* __restrict__ xpad, const T* __restrict__ w1,
                      const T* __restrict__ w2, const float* __restrict__ ab, T* __restrict__ out, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* hs = reinterpret_cast<T*>(smem);  // [C][TP] padded h1
  T* xs = hs + C * TP;                 // [C][TP] padded x (when xpad is null)
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int co0 = (warp & 7) * 8;
  const int pix0 = (warp >> 3) * 32 + (t & 31);

  // zero the tiles once: the borders stay zero (the pad), interiors are
  // rewritten for every crop
  const int nsm = (xpad ? 1 : 2) * C * TP;
  for (int i = t; i < nsm; i += NT) hs[i] = from_f<T>(0.0f);
  __syncthreads();

  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    const T* xn = x + (size_t)n * C * P;
    const T* src = xs;
    if (xpad) {
      src = xpad + (size_t)n * C * TP;
    } else {
      for (int i = t; i < C * P; i += NT) {
        const int c = i / P, p = i - c * P, y = p / S;
        xs[c * TP + (y + 1) * SP + (p - y * S) + 1] = xn[i];
      }
    }
    __syncthreads();

    // conv1 -> h1 = relu(acc * a1 + b1) in T, into the padded h1 tile
    for (int pass = 0; pass < NPASS; ++pass) {
      int base[PX];
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const int p = pix0 + PSTRIDE * (pass * PX + j);
        const int q = p < P ? p : 0;
        base[j] = (q / S) * SP + q % S;
      }
      float acc[PX][8];
      conv3x3(src, w1, base, co0, acc);
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        if (pix0 + PSTRIDE * (pass * PX + j) >= P) continue;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int co = co0 + k;
          const float h = fmaxf(acc[j][k] * __ldg(ab + co) + __ldg(ab + C + co), 0.0f);
          hs[co * TP + base[j] + SP + 1] = from_f<T>(h);
        }
      }
    }
    __syncthreads();

    // conv2 -> out = relu(acc * a2 + b2 + x) in T. The next crop's writes
    // to the tiles come after its first barrier, which every thread
    // reaches only once done here.
    for (int pass = 0; pass < NPASS; ++pass) {
      int base[PX];
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const int p = pix0 + PSTRIDE * (pass * PX + j);
        const int q = p < P ? p : 0;
        base[j] = (q / S) * SP + q % S;
      }
      float acc[PX][8];
      conv3x3(static_cast<const T*>(hs), w2, base, co0, acc);
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const int p = pix0 + PSTRIDE * (pass * PX + j);
        if (p >= P) continue;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int co = co0 + k;
          const float y = acc[j][k] * __ldg(ab + 2 * C + co) + __ldg(ab + 3 * C + co) + to_f(xn[co * P + p]);
          out[(size_t)n * C * P + co * P + p] = from_f<T>(fmaxf(y, 0.0f));
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* xpad, const void* w1, const void* w2, const void* ab, void* out, int N,
           cudaStream_t stream) {
  const size_t smem = (xpad ? 1 : 2) * (size_t)C * TP * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(reid_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int grid = N < sms ? N : sms;
  reid_block_kernel<T><<<grid, NT, smem, stream>>>(
      (const T*)x, (const T*)xpad, (const T*)w1, (const T*)w2, (const float*)ab, (T*)out, N);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out [N, 64, 25, 25] in T (bf16 when bf16 != 0, else f32); xpad: null
// for bf16, else x zero-padded to [N, 64, 27, 27]; w1, w2 HWIO [3,3,64,64]
// in T; ab [4, 64] f32 rows a1, b1, a2, b2.
extern "C" int vct_reid_block64(const void* x, const void* xpad, const void* w1, const void* w2, const void* ab,
                                void* out, int N, int bf16, void* stream) {
  if (N <= 0) return 0;
  if (bf16) {
    if (xpad) return (int)cudaErrorInvalidValue;
    return launch<__nv_bfloat16>(x, nullptr, w1, w2, ab, out, N, (cudaStream_t)stream);
  }
  if (!xpad) return (int)cudaErrorInvalidValue;
  return launch<float>(x, xpad, w1, w2, ab, out, N, (cudaStream_t)stream);
}
