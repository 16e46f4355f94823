// YOLO layer 1 as one kernel: silu(conv3x3 stride 2 pad 1 (x, w) + b),
// x [B, H, W, 32] NHWC in T (bf16 or f32), b [64] f32, out [B, H/2, W/2, 64]
// in T. Operands in T, f32 accumulation, bias and SiLU in f32, one rounding
// to T at the end.
//
// Replaces the TPU kernel vehicle_counting_tpu/ops/pallas/conv_s2.py
// (conv1_s2_silu_pallas, body _conv1_kernel_body). The TPU kernel packed
// four pixels' channels into 128 lanes and ran one block-structured MXU
// matmul per 16 output rows.
//
// bf16 (the card's path): an implicit GEMM on the tensor cores. At
// [128, 192, 320, 32] it is M = 1,966,080 output pixels, N = 64, K = 288:
// 72.5 GFLOP (0.073 ms at the dense bf16 peak) against 755 MB of traffic
// (0.225 ms at 3.35 TB/s), so the bound is bytes: x is streamed once with
// 16-byte copies and the MMAs stay off the critical path.
// Design: one persistent block per SM, three warpgroups, each an
// independent worker that walks its own 4 x 16 output tiles (one M tile of
// 64 pixels each). A worker runs its phases one after another (copies
// issued, MMAs, epilogue), and each phase keeps another unit of the SM
// busy (load/store, tensor cores, special-function and f32 pipes), so it
// is the other workers that fill the gaps: with two workers the kernel took
// the same time with its loads or its stores removed, with three or four
// it runs at the card's copy rate. Three leave shared memory to spare.
// - Weights resident in shared memory: the 9 taps' [64 co][32 ci] pair up
//   into 5 K-major slabs [64 co][2 taps x 32 ci] (tap 9 is zeros) of 128-byte
//   rows in the tensor cores' 128-byte swizzle, packed by the wrapper
//   (ops/conv_s2.py::pack_conv1_weights) and loaded once per block by bulk
//   async copies onto an mbarrier. Pairing keeps the rows 128 bytes wide, so
//   the descriptor is the one reid_block.cu uses.
// - Each worker keeps a ring of two input windows (9 x 33 pixels x 64 B):
//   the next tile's window arrives by cp.async (16 bytes a copy, zeros
//   where the tap leaves the image: only row -1 and column -1 can) while
//   this tile's MMAs and epilogue run. A deeper ring or a taller tile
//   changed nothing.
// - The window is pixel-major, 64 B a pixel, with the columns de-interleaved
//   (even window columns first, then odd): a stride-2 tap then reads 8
//   consecutive slots per ldmatrix phase, and XOR-ing the 16-byte chunk with
//   bits 1-2 of the slot spreads them over all 8 bank groups.
// - A operand in registers by ldmatrix.x4 (a wgmma shared-memory descriptor
//   cannot express the stride-2 rows; with A in registers each lane supplies
//   its own row address), double-buffered across taps; wgmma.mma_async
//   m64n64k16 with f32 accumulators, 18 per M tile.
// - Epilogue: bias + SiLU in f32 on the accumulator fragments (v / (1 +
//   __expf(-v)) with the fast division: their error is far below one bf16
//   rounding), rounded to bf16 into a swizzled 2 KB stage per warp (a
//   warp's 16 accumulator rows are 16 consecutive output pixels of one
//   row, 2 KB contiguous in NHWC), then written with 16-byte streaming
//   stores.
//
// f32 (parity mode): a direct convolution on the CUDA cores. One block
// per 8 x 16 output tile, all 64 channels; the 17 x 33 x 32 window sits in
// shared memory channel-major, so the stride-2 reads of a warp's 16 output
// columns hit distinct banks. 8 warps: warp w owns output channels 8w ..
// 8w+8; lane l owns column l % 16 and rows l / 16 + 2j, j < 4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_util.cuh"

namespace {

constexpr int CIN = 32;
constexpr int COUT = 64;
constexpr int TW = 16;            // output columns per tile
constexpr int PW = 2 * TW + 1;    // input window columns

// ---------------------------------------------------------------- bf16

namespace tc {

using namespace vct_wgmma;

constexpr int WG = 3;                          // warpgroups = independent workers
constexpr int NT = WG * 128;
constexpr int TH = 4;                          // output rows per tile: TH / 4 M tiles of 4 x 16 pixels
constexpr int PH = 2 * TH + 1;                 // input window rows
constexpr int RING = 2;                        // windows per worker
constexpr int SLAB = COUT * 64 * 2;            // [64 co][2 taps x 32 ci] bf16
constexpr int NSLAB = 5;
constexpr int WBYTES = NSLAB * SLAB;
constexpr int PIX = CIN * 2;                   // bytes per input pixel
constexpr int WIN = (PH * PW * PIX + 127) / 128 * 128;
constexpr int NCHUNK = PH * PW * 4;            // 16-byte chunks per window
constexpr int ODD0 = (PW + 1) / 2;             // first slot of the odd window columns
constexpr int STAGE = 16 * COUT * 2;           // one warp's 16 output pixels
constexpr int OFF_WIN = WBYTES;                // weights | windows | stages | bias | barrier
constexpr int OFF_STAGE = OFF_WIN + WG * RING * WIN;
constexpr int OFF_BIAS = OFF_STAGE + NT / 32 * STAGE;
constexpr int OFF_BAR = OFF_BIAS + COUT * 4;
constexpr int SMEM = OFF_BAR + 8 + 1024;       // + slack to align the weights to 1024 B

static_assert(TH % 4 == 0 && RING >= 2, "whole M tiles; one window in use, at least one in flight");
static_assert(OFF_WIN % 128 == 0 && WIN % 128 == 0 && OFF_STAGE % 128 == 0, "bank-group alignment");
static_assert(SMEM <= 232448, "fits one block's shared memory");

// byte offset of 16-byte chunk c (8 channels) of window slot s
__device__ __forceinline__ uint32_t cell(int s, int c) { return s * PIX + ((c ^ ((s >> 1) & 3)) << 4); }

// starts the copies of the window of tile (b, oy0, ox0) into `win`; t is
// the thread's index in its warpgroup
__device__ __forceinline__ void start_window(uint32_t win, const char* x, int b, int oy0, int ox0, int H, int W,
                                             int t) {
  const char* xb = x + (size_t)b * H * W * PIX;
  const int iy0 = 2 * oy0 - 1, ix0 = 2 * ox0 - 1;
  for (int i = t; i < NCHUNK; i += 128) {
    const int pix = i >> 2, c = i & 3;
    const int wr = pix / PW, wc = pix - wr * PW;
    const int iy = iy0 + wr, ix = ix0 + wc;
    const bool in = iy >= 0 && ix >= 0;  // H and W are even: the window never leaves below or right
    const char* src = in ? xb + ((size_t)iy * W + ix) * PIX + c * 16 : x;
    const int s = wr * PW + ((wc & 1) ? ODD0 + (wc >> 1) : (wc >> 1));
    cp_async16(win + cell(s, c), src, in ? 16 : 0);
  }
}

__global__ void __launch_bounds__(NT, 1)
    conv1_s2_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                  const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int B, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t wa = smem_u32(smem), bar = wa + OFF_BAR;
  float* bs = reinterpret_cast<float*>(smem + OFF_BIAS);
  const int tid = threadIdx.x;
  const int wg = tid >> 7, t = tid & 127, wq = t >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int oxl = lane & 15, kh = lane >> 4;  // this lane's ldmatrix row (output column) and 8-channel half

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, WBYTES);
    for (int k = 0; k < NSLAB; ++k) bulk_load(wa + k * SLAB, w + k * COUT * 64, SLAB, bar);
  }
  if (tid < COUT) bs[tid] = bias[tid];

  const int OH = H / 2, OW = W / 2;
  const int tiles_x = OW / TW, tiles_y = OH / TH;
  const int n_tiles = B * tiles_y * tiles_x;
  const int stride = WG * gridDim.x;
  const uint32_t win0 = wa + OFF_WIN + wg * RING * WIN;
  unsigned char* stage = smem + OFF_STAGE + (tid >> 5) * STAGE;
  const char* xc = reinterpret_cast<const char*>(x);

  // the window of tile `tl` into ring slot `slot`; commits a group either way, so that groups count tiles
  auto fetch = [&](int tl, int slot) {
    if (tl < n_tiles) {
      const int b = tl / (tiles_y * tiles_x), r = tl - b * tiles_y * tiles_x;
      start_window(win0 + slot * WIN, xc, b, (r / tiles_x) * TH, (r % tiles_x) * TW, H, W, t);
    }
    cp_async_commit();
  };
  int tile = WG * blockIdx.x + wg;
#pragma unroll
  for (int j = 0; j < RING - 1; ++j) fetch(tile + j * stride, j);
  __syncthreads();    // the bias is in place
  mbar_wait(bar, 0);  // the weights have landed

  for (int k = 0; tile < n_tiles; tile += stride, ++k) {
    const int b = tile / (tiles_y * tiles_x), r = tile - b * tiles_y * tiles_x;
    const int oy0 = (r / tiles_x) * TH, ox0 = (r % tiles_x) * TW;
    cp_async_wait<RING - 2>();   // this thread's copies of this tile's window are done
    named_barrier<128>(1 + wg);  // so are the other threads'; every warp is done with the window before it
    fetch(tile + (RING - 1) * stride, (k + RING - 1) % RING);  // into that window's slot
    const uint32_t win = win0 + (k % RING) * WIN;
#pragma unroll 1
    for (int mt = 0; mt < TH / 4; ++mt) {  // M tile: output rows 4 mt .. 4 mt + 3, this warp's row 4 mt + wq
      const int oyl = 4 * mt + wq;
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
      uint32_t a[2][2][4];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        // window column 2 oxl + dx: even columns sit at slot column / 2, odd ones after them
        const int s = (2 * oyl + dy) * PW + (dx == 1 ? ODD0 + oxl : oxl + dx / 2);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) ldsm_x4(win + cell(s, 2 * ks + kh), a[tap & 1][ks]);
        wg_fence();
        const uint64_t desc = desc_sw128(wa + (tap >> 1) * SLAB) + 4 * (tap & 1);  // +32 B per k16
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) wgmma_m64n64k16(acc, a[tap & 1][ks], desc + 2 * ks);
        wg_commit();
        wg_wait<1>();  // the previous tap's MMAs are done: its A buffer is free
      }
      wg_wait<0>();
      fence_acc(acc);

      // acc[4 jj + 2 h + e] is output pixel (row oyl, column gq + 8 h), channel 8 jj + 2 tq + e
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 bv = *reinterpret_cast<const float2*>(bs + 8 * jj + 2 * tq);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v0 = acc[4 * jj + 2 * h] + bv.x, v1 = acc[4 * jj + 2 * h + 1] + bv.y;
          const __nv_bfloat162 y = __floats2bfloat162_rn(__fdividef(v0, 1.0f + __expf(-v0)),
                                                         __fdividef(v1, 1.0f + __expf(-v1)));
          const int row = gq + 8 * h;
          *reinterpret_cast<__nv_bfloat162*>(stage + row * 128 + ((jj ^ (row & 7)) << 4) + 4 * tq) = y;
        }
      }
      __syncwarp();
      uint4* dst = reinterpret_cast<uint4*>(out + (((size_t)b * OH + oy0 + oyl) * OW + ox0) * COUT);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = lane + 32 * i, row = idx >> 3, ch = idx & 7;
        __stcs(dst + idx, *reinterpret_cast<const uint4*>(stage + row * 128 + ((ch ^ (row & 7)) << 4)));
      }
      __syncwarp();  // the stage is free for the next M tile
    }
  }
}

int launch(const void* x, const void* w, const void* bias, void* out, int B, int H, int W, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(conv1_s2_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = B * (H / 2 / TH) * (W / 2 / TW);
  const int want = (n_tiles + WG - 1) / WG;
  conv1_s2_bf16<<<want < sms ? want : sms, NT, SMEM, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)bias, (__nv_bfloat16*)out, B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ----------------------------------------------------------------- f32

namespace direct {

// w[0..8) <- p[0..8), read-only path (32-byte aligned)
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

constexpr int TH = 8;             // output rows per tile
constexpr int PH = 2 * TH + 1;    // input window rows
constexpr int PPLANE = PH * PW;   // window pixels per channel
constexpr int NT = 256;
constexpr int PX = 4;             // output rows per thread
constexpr int SMEM = CIN * PPLANE * 4;

__global__ void __launch_bounds__(NT)
    conv1_s2_f32(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
                 float* __restrict__ out, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [CIN][PH][PW]
  const int OH = H / 2, OW = W / 2;
  const int ox0 = blockIdx.x * TW, oy0 = blockIdx.y * TH, b = blockIdx.z;
  const int t = threadIdx.x;

  const int iy0 = 2 * oy0 - 1, ix0 = 2 * ox0 - 1;
  const float* xb = x + (size_t)b * H * W * CIN;
  for (int i = t; i < PPLANE * CIN; i += NT) {
    const int ci = i % CIN, pix = i / CIN;
    const int r = pix / PW, cc = pix - r * PW;
    const int iy = iy0 + r, ix = ix0 + cc;
    const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
    xs[ci * PPLANE + pix] = in ? xb[((size_t)iy * W + ix) * CIN + ci] : 0.0f;
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
    const float* sp = xs + dy * PW + 2 * oxl + dx;
    const float* wp = w + tap * CIN * COUT + co0;
#pragma unroll 4
    for (int ci = 0; ci < CIN; ++ci) {
      float wv[8];
      load8(wp + ci * COUT, wv);
      float xv[PX];
#pragma unroll
      for (int j = 0; j < PX; ++j) xv[j] = sp[ci * PPLANE + 2 * (oyl0 + 2 * j) * PW];
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

int launch(const void* x, const void* w, const void* bias, void* out, int B, int H, int W, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(conv1_s2_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(W / 2 / TW, H / 2 / TH, B);
  conv1_s2_f32<<<grid, NT, SMEM, stream>>>((const float*)x, (const float*)w, (const float*)bias, (float*)out, H, W);
  return (int)cudaGetLastError();
}

}  // namespace direct

}  // namespace

// Needs H % 16 == 0 and W % 32 == 0 (the wrapper asks for the TPU
// kernel's H % 32 == 0 and W % 64 == 0).
// bf16 != 0: x, out bf16; w the packed bf16 weights of
//   ops/conv_s2.py::pack_conv1_weights ([5 slabs][64 co][64 k], k = (tap % 2)
//   * 32 + ci of tap 2 slab + k / 32, each 128-byte row swizzled: k chunk c
//   at chunk c ^ (co % 8)); x and w 16-byte aligned.
// bf16 == 0: x, out f32; w HWIO [3, 3, 32, 64] f32.
extern "C" int vct_conv1_s2_silu(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
                                 int bf16, void* stream) {
  if (B <= 0) return 0;
  if (H % 16 != 0 || W % 32 != 0) return (int)cudaErrorInvalidValue;
  if (bf16) {
    if (((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) & 15) return (int)cudaErrorMisalignedAddress;
    return tc::launch(x, w, bias, out, B, H, W, (cudaStream_t)stream);
  }
  return direct::launch(x, w, bias, out, B, H, W, (cudaStream_t)stream);
}

// dynamic shared memory a block of the bf16 (bf16 != 0) or f32 kernel takes
extern "C" int vct_conv1_s2_smem(int bf16) { return bf16 ? tc::SMEM : direct::SMEM; }
