// ReID crop gather + cv2-bilinear 50x50 resize + ImageNet normalisation.
//
// Replaces the TPU kernel vehicle_counting_tpu/ops/pallas/crops.py
// (_crop_gather_call / gather_crops_batch_pallas). The Pallas kernel DMAs
// each crop's row band into VMEM, picks the tap rows with a one-hot matmul
// and mixes columns with a second matmul; XLA then does the vertical mix
// and the normalisation. Here one thread block handles one crop and each
// thread computes whole output pixels, reading the four taps of each
// channel straight from the planar uint8 frames; the vertical mix, /255,
// -mean, /std and the valid mask are fused, and [D, 50, 50, 3] f32 is
// written once.
//
// Bound on the H100: bytes. Per crop it reads at most 2 x 50 rows x 50
// taps x 3 channels of u8 (mostly L2 hits: neighbouring output pixels
// share taps) and writes 30 KB of f32; there is no reuse a tensor core
// could exploit. The design keeps the u8 frames as the only input read and
// writes the normalised crop once, instead of materialising tap rows.
//
// Bit-exactness with the plain PyTorch version (ops/crops.py) is the
// contract. Tap indices and weights come from the same `_bilinear_coords`
// computed by the wrapper; the kernel is built with --fmad=false so every
// a*b+c rounds twice, like the separate PyTorch ops, and divides with IEEE
// division. Coincident clamp taps (x0c == x1c) multiply the pixel once by
// ((1-fx) + fx), as the one-hot column matmul of the reference does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OH = 50;
constexpr int OW = 50;

__device__ __forceinline__ float col_mix(const uint8_t* row, int c0, int c1, float w0, float w1) {
  if (c0 == c1) return (float)row[c0] * (w0 + w1);
  return (float)row[c0] * w0 + (float)row[c1] * w1;
}

__global__ void crop_gather_kernel(
    const uint8_t* __restrict__ frames, int B, int H, int W,
    const int32_t* __restrict__ fidx,
    const int32_t* __restrict__ y0c, const int32_t* __restrict__ y1c, const float* __restrict__ fy,
    const int32_t* __restrict__ x0c, const int32_t* __restrict__ x1c, const float* __restrict__ fx,
    const uint8_t* __restrict__ valid,
    float mean0, float mean1, float mean2, float std0, float std1, float std2,
    float* __restrict__ out) {
  const int d = blockIdx.x;
  float* o = out + (size_t)d * OH * OW * 3;
  if (!valid[d]) {
    for (int t = threadIdx.x; t < OH * OW * 3; t += blockDim.x) o[t] = 0.0f;
    return;
  }
  __shared__ int s_y0[OH], s_y1[OH], s_x0[OW], s_x1[OW];
  __shared__ float s_fy[OH], s_fx[OW];
  if (threadIdx.x < OH) {
    const int i = d * OH + threadIdx.x;
    s_y0[threadIdx.x] = y0c[i];
    s_y1[threadIdx.x] = y1c[i];
    s_fy[threadIdx.x] = fy[i];
  } else if (threadIdx.x < OH + OW) {
    const int i = d * OW + threadIdx.x - OH;
    s_x0[threadIdx.x - OH] = x0c[i];
    s_x1[threadIdx.x - OH] = x1c[i];
    s_fx[threadIdx.x - OH] = fx[i];
  }
  __syncthreads();

  const int f = min(max(fidx[d], 0), B - 1);  // gather clamps like the reference
  const size_t plane = (size_t)H * W;
  const uint8_t* base = frames + (size_t)f * 3 * plane;
  const float mean[3] = {mean0, mean1, mean2};
  const float stdv[3] = {std0, std1, std2};
  for (int t = threadIdx.x; t < OH * OW; t += blockDim.x) {
    const int oy = t / OW, ox = t - (t / OW) * OW;
    const int c0 = s_x0[ox], c1 = s_x1[ox];
    const float wx1 = s_fx[ox], wx0 = 1.0f - wx1;
    const float wy1 = s_fy[oy], wy0 = 1.0f - wy1;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const uint8_t* pl = base + c * plane;
      const float m0 = col_mix(pl + (size_t)s_y0[oy] * W, c0, c1, wx0, wx1);
      const float m1 = col_mix(pl + (size_t)s_y1[oy] * W, c0, c1, wx0, wx1);
      const float v = m0 * wy0 + m1 * wy1;
      o[t * 3 + c] = (v / 255.0f - mean[c]) / stdv[c];
    }
  }
}

}  // namespace

extern "C" int vct_crop_gather(
    const void* frames, int B, int H, int W, const void* fidx,
    const void* y0c, const void* y1c, const void* fy,
    const void* x0c, const void* x1c, const void* fx,
    const void* valid, int D,
    float mean0, float mean1, float mean2, float std0, float std1, float std2,
    void* out, void* stream) {
  if (D > 0) {
    crop_gather_kernel<<<D, 256, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)frames, B, H, W, (const int32_t*)fidx,
        (const int32_t*)y0c, (const int32_t*)y1c, (const float*)fy,
        (const int32_t*)x0c, (const int32_t*)x1c, (const float*)fx,
        (const uint8_t*)valid, mean0, mean1, mean2, std0, std1, std2, (float*)out);
  }
  return (int)cudaGetLastError();
}
