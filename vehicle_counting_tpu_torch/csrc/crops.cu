// ReID crop gather + cv2-bilinear 50x50 resize + ImageNet normalisation,
// from the boxes to the normalised crops in one launch.
//
// Replaces the TPU kernel vehicle_counting_tpu/ops/pallas/crops.py
// (_crop_gather_call / gather_crops_batch_pallas). The Pallas kernel DMAs
// each crop's row band into VMEM, picks the tap rows with a one-hot matmul
// and mixes columns with a second matmul; XLA computes the sample
// coordinates before it and the vertical mix and the normalisation after.
// Here one thread block handles one crop, start to end:
// - the coordinate math (integer crop bounds, cv2's (d + 0.5) * scale - 0.5
//   source positions, tap indices and weights) runs in the block, 50 + 50
//   entries into shared memory, so the wrapper makes this launch and
//   nothing else;
// - the crop's source band (rows y0c[0] .. y1c[49], columns x0c[0] ..
//   x1c[49] of the three u8 planes) is staged in shared memory with 16-byte
//   cp.async copies, each row segment starting at the 16-byte boundary at
//   or below its first column so that source and destination stay aligned;
//   the four taps of every output value then come from shared memory. A
//   band that does not fit BAND_MAX (a crop can be the whole frame), or a
//   frame whose rows are not 16-byte multiples, takes the direct route:
//   the same arithmetic with the taps read from global memory;
// - each thread computes whole output pixels (three channels share the
//   taps' coordinates) into a [50, 50, 3] f32 stage in shared memory, which
//   the block then writes with 16-byte stores; invalid crops are
//   zero-filled with 16-byte stores.
//
// Bound on the H100: bytes. 3840 crops of 20-80 px boxes read ~29 MB of u8
// pixels and write 115 MB of f32, 0.043 ms at 3.35 TB/s; a 128-crop call
// is bound by the launch. With 24 KB of band and 30 KB of stage per block,
// four blocks fit on an SM, so one crop's copies overlap the others'
// arithmetic.
//
// Bit-exactness with the plain PyTorch version (ops/crops.py) is the
// contract: every f32 operation is the plain version's, in its order, with
// explicitly rounded intrinsics (no FMA contraction; the two divisions by
// constants as `div_by`, whose quotient is IEEE division's), so the result
// does not hang on a compiler flag. Coincident clamp taps
// (x0c == x1c) multiply the pixel once by ((1 - fx) + fx), as the one-hot
// column matmul of the reference does. Boxes must be finite and within
// +-2^31: float -> int conversion of anything else differs between CUDA
// (saturating) and PyTorch.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "wgmma_util.cuh"

namespace {

using vct_wgmma::cp_async16;
using vct_wgmma::cp_async_commit;
using vct_wgmma::cp_async_wait;
using vct_wgmma::smem_u32;

constexpr int OS = 50;                  // output side
constexpr int NV4 = OS * OS * 3 / 4;    // 16-byte groups of one crop's output
constexpr int NT = 256;
constexpr int BAND_MAX = 24 * 1024;     // staged band bytes per block
constexpr int STAGE = OS * OS * 3 * 4;  // the output stage: one crop in f32 (a multiple of 16)

// Tap indices (clamped to the axis) and the weight of the second tap for
// output index i along one axis: crop [lo, hi) of a `size`-pixel axis. The
// operations and their order are ops/crops.py::_bilinear_coords'.
__device__ __forceinline__ void axis_coords(float lo, float hi, int size, int i, int& i0c, int& i1c, float& f) {
  const int a = max(__float2int_rz(lo), 0);
  const int b = min(__float2int_rz(hi), size - 1);
  const float c = (float)max(b - a, 1);
  const float q = __fdiv_rn(c, (float)OS);
  float t = __fsub_rn(__fmul_rn(__fadd_rn((float)i, 0.5f), q), 0.5f);
  t = fminf(fmaxf(t, 0.0f), __fsub_rn(c, 1.0f));
  const float s = __fadd_rn((float)a, t);
  const int i0 = __float2int_rz(floorf(s));
  f = __fsub_rn(s, (float)i0);
  i0c = min(max(i0, 0), size - 1);
  i1c = min(max(i0 + 1, 0), size - 1);
}

struct Taps {
  int2 yi[OS];    // y0c, y1c
  float2 yw[OS];  // 1 - fy, fy
  int2 xi[OS];    // x0c, x1c
  float2 xw[OS];  // 1 - fx, fx; (1 - fx) + fx, 0 where the taps coincide
};

// x / c correctly rounded, for a divisor whose correctly rounded reciprocal
// rc = RN(1 / c) is at hand: q = RN(x rc), the residual r = x - q c exactly
// by one FMA, then RN(q + r rc) (Markstein, 1990; it holds unless c's
// significand is all ones, which the entry point refuses, and away from
// subnormals, which pixel values never reach). Three instructions where the
// division routine takes a dozen; the quotient is IEEE division's, bit for bit.
__device__ __forceinline__ float div_by(float x, float c, float rc) {
  const float q = __fmul_rn(x, rc);
  return __fmaf_rn(__fmaf_rn(-q, c, x), rc, q);
}

// The crop's values from `src` (plane c at src + c * cstride, row y at
// (y - yoff) * pitch, column x at x - xoff) into `stage` [50, 50, 3]: one
// output pixel per thread and step, its three channels sharing the taps'
// coordinates.
__device__ __forceinline__ void mix(const uint8_t* src, int cstride, int pitch, int yoff, int xoff, const Taps& tp,
                                    const float (&mean)[3], const float (&stdv)[3], float* stage) {
  const float r255 = __frcp_rn(255.0f);
  const float rstd[3] = {__frcp_rn(stdv[0]), __frcp_rn(stdv[1]), __frcp_rn(stdv[2])};
  for (int t = threadIdx.x; t < OS * OS; t += NT) {
    const int oy = t / OS, ox = t - oy * OS;
    const int2 xi = tp.xi[ox], yi = tp.yi[oy];
    const float2 xw = tp.xw[ox], yw = tp.yw[oy];
    const uint8_t* r0 = src + (yi.x - yoff) * pitch - xoff;
    const uint8_t* r1 = src + (yi.y - yoff) * pitch - xoff;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const uint8_t *p0 = r0 + c * cstride, *p1 = r1 + c * cstride;
      const float m0 = __fadd_rn(__fmul_rn((float)p0[xi.x], xw.x), __fmul_rn((float)p0[xi.y], xw.y));
      const float m1 = __fadd_rn(__fmul_rn((float)p1[xi.x], xw.x), __fmul_rn((float)p1[xi.y], xw.y));
      const float v = __fadd_rn(__fmul_rn(m0, yw.x), __fmul_rn(m1, yw.y));
      stage[3 * t + c] = div_by(__fsub_rn(div_by(v, 255.0f, r255), mean[c]), stdv[c], rstd[c]);
    }
  }
}

__global__ void __launch_bounds__(NT)
    crop_gather_kernel(const uint8_t* __restrict__ frames, int B, int H, int W, const void* __restrict__ fidx,
                       int fidx64, const float4* __restrict__ boxes, const uint8_t* __restrict__ valid, int can_stage,
                       float mean0, float mean1, float mean2, float std0, float std1, float std2,
                       float* __restrict__ out, int* __restrict__ staged_count) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* stage = reinterpret_cast<float*>(smem);  // the crop's output, [50, 50, 3]
  uint8_t* band = smem + STAGE;
  __shared__ Taps tp;
  const float mean[3] = {mean0, mean1, mean2}, stdv[3] = {std0, std1, std2};
  const int d = blockIdx.x, tid = threadIdx.x;
  float4* o = reinterpret_cast<float4*>(out + (size_t)d * OS * OS * 3);
  if (!valid[d]) {
    for (int k = tid; k < NV4; k += NT) o[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  if (tid < 2 * OS) {
    const float4 bx = boxes[d];  // x1, y1, x2, y2
    int i0, i1;
    float f;
    if (tid < OS) {
      axis_coords(bx.y, bx.w, H, tid, i0, i1, f);
      tp.yi[tid] = make_int2(i0, i1);
      tp.yw[tid] = make_float2(__fsub_rn(1.0f, f), f);
    } else {
      axis_coords(bx.x, bx.z, W, tid - OS, i0, i1, f);
      const float w0 = __fsub_rn(1.0f, f);
      tp.xi[tid - OS] = make_int2(i0, i1);
      // p0 * (w0 + w1) + p0 * 0 is p0 * (w0 + w1) exactly: one formula for both cases
      tp.xw[tid - OS] = i0 == i1 ? make_float2(__fadd_rn(w0, f), 0.0f) : make_float2(w0, f);
    }
  }
  __syncthreads();

  const long long fi = fidx64 ? static_cast<const long long*>(fidx)[d] : static_cast<const int*>(fidx)[d];
  const int f = (int)min(max(fi, 0ll), (long long)B - 1);  // the gather clamps like the reference
  const int plane = H * W;
  const uint8_t* base = frames + (size_t)f * 3 * plane;

  // the band: taps are monotone along each axis, so its corners are the first and last entries
  const int ylo = tp.yi[0].x, nrows = tp.yi[OS - 1].y - ylo + 1;
  const int xa = tp.xi[0].x & ~15, cpr = ((tp.xi[OS - 1].y - xa) >> 4) + 1, pitch = 16 * cpr;
  if (can_stage && 3 * nrows * pitch <= BAND_MAX) {
    const uint32_t dst = smem_u32(band);
    for (int i = tid; i < 3 * nrows * cpr; i += NT) {
      const int row = i / cpr, ch = i - row * cpr;  // row = plane * nrows + band row
      const int c = row / nrows, y = row - c * nrows;
      cp_async16(dst + row * pitch + 16 * ch, base + (size_t)c * plane + (size_t)(ylo + y) * W + xa + 16 * ch, 16);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (staged_count != nullptr && tid == 0) atomicAdd(staged_count, 1);
    mix(band, nrows * pitch, pitch, ylo, xa, tp, mean, stdv, stage);
  } else {
    mix(base, plane, W, 0, 0, tp, mean, stdv, stage);
  }
  __syncthreads();
  const float4* st = reinterpret_cast<const float4*>(stage);
  for (int k = tid; k < NV4; k += NT) o[k] = st[k];
}

}  // namespace

// frames [B, 3, H, W] u8; fidx [D] int32 (fidx64 == 0) or int64; boxes
// [D, 4] f32 xyxy; valid [D] u8; out [D, 50, 50, 3] f32, 16-byte aligned.
// staged_count: null, or a device int that each crop taking the staged
// route adds one to (for checks; the caller zeroes it).
extern "C" int vct_crop_gather(
    const void* frames, int B, int H, int W, const void* fidx, int fidx64,
    const void* boxes, const void* valid, int D,
    float mean0, float mean1, float mean2, float std0, float std1, float std2,
    void* out, void* staged_count, void* stream) {
  if (D <= 0) return 0;
  if (((uintptr_t)out | (uintptr_t)boxes) & 15) return (int)cudaErrorMisalignedAddress;
  const float sds[3] = {std0, std1, std2};
  for (const float sd : sds) {  // div_by's condition on its divisor
    uint32_t bits;
    memcpy(&bits, &sd, 4);
    if (!(sd > 0.0f) || (bits & 0x7FFFFF) == 0x7FFFFF) return (int)cudaErrorInvalidValue;
  }
  const int can_stage = W % 16 == 0 && (uintptr_t)frames % 16 == 0;
  // above the default 48 KB; set per launch: the attribute belongs to the current device
  const cudaError_t e = cudaFuncSetAttribute(crop_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             STAGE + BAND_MAX);
  if (e != cudaSuccess) return (int)e;
  crop_gather_kernel<<<D, NT, STAGE + BAND_MAX, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, B, H, W, fidx, fidx64, (const float4*)boxes, (const uint8_t*)valid, can_stage,
      mean0, mean1, mean2, std0, std1, std2, (float*)out, (int*)staged_count);
  return (int)cudaGetLastError();
}

// staged band bytes a block may hold
extern "C" int vct_crop_gather_band_max() { return BAND_MAX; }
