// Fused ReID stage-1 BasicBlock on [N, 64, 25, 25] crops:
//   out = relu(bn2(conv3x3(h1)) + x),  h1 = relu(bn1(conv3x3(x)))
// with inference BN folded to a*v + b (a, b in f32, computed by the caller).
//
// Replaces the TPU kernel vehicle_counting_tpu/ops/pallas/reid_block.py
// (reid_block64_pallas, body _block_kernel). Same numerics: conv operands
// in the compute dtype (bf16 or f32), f32 accumulation, h1 rounded to the
// compute dtype and zero outside the crop (the pad), residual added in f32,
// output in the compute dtype. Like the TPU kernel, x and h1 never leave
// the SM between the two convs; the TPU kernel's [G*650, 576] patch
// matrices are not built.
//
// Layout: NCHW, the port's ReID layout (models/reid.py), so no transpose
// is added around the block.
//
// bf16 (the card's path): tensor cores. Each conv is 9 shifted GEMMs
// (M = 625 pixels padded to 640, N = 64 co, K = 64 ci per tap), 46 M MACs
// per crop for both; at the dense bf16 peak that is 0.36 ms for N = 3840,
// and reading x plus writing out (614 MB) 0.18 ms, so the bound is the
// tensor cores' feed: A (2 KB by ldmatrix) and B (2 KB by wgmma) per
// m64n64k16 is 128 B/clock of shared memory, the SM's whole bandwidth at
// the tensor-core rate.
// Design: one persistent block per SM walks the crops.
// - Both convs' weights stay in shared memory: 18 per-tap [64 co][64 ci]
//   slabs (8 KB each, K-major, 128-byte swizzle, packed by the wrapper),
//   each one bulk async copy onto an mbarrier.
// - Beside them fits one activation tile: [625 pixels + 1 zero row][64 ch]
//   bf16, 128 B per pixel, the 16-byte chunks of pixel q swizzled by XOR
//   with (q & 7) so the 8 pixels of an ldmatrix phase hit 8 bank groups.
//   It holds x for conv1, then h1 for conv2, written over x once every
//   warp is done reading it: h1 never leaves the SM. The residual x is
//   read back from global memory (L2) and the output stored from the
//   accumulators.
// - A operand (pixels x ci) in registers: one ldmatrix.x4 per k16 step,
//   one row address per lane, so tap (dy, dx) costs only an address; a
//   lane whose tap pixel lies outside the crop reads the zero row (the
//   conv's pad). A fragments are double-buffered across taps.
// - wgmma.mma_async m64n64k16, f32 accumulators (32 registers): two
//   warpgroups, each owning 5 of the 10 M tiles and running all 9 taps of
//   one tile before the next, so one warpgroup's epilogue overlaps the
//   other's MMAs. conv1's relu(acc * a1 + b1) waits in registers as bf16
//   until the tile may be overwritten.
// - The next crop comes in during conv2: one bulk async copy stages its
//   first 58 channel planes (NCHW) in conv1's idle slabs, its other 6
//   planes go to registers. After conv2 they are transposed into the tile
//   and conv1's slabs are copied back from global memory (L2).
// - Eight warps, so ptxas may give each thread up to 255 registers (a
//   ninth warp caps them at 168: 3 warps on one of the SM's 4 register-file
//   quarters).
// Left in the way of the tensor cores: the 2-byte NCHW stores of the
// output and loads of the residual (the accumulator layout puts 8
// consecutive pixels of a channel in a warp's store), and the transpose
// and slab reload between crops.
//
// f32 (parity mode; the card's embed never sends f32 here): a direct
// convolution on the CUDA cores. Only the h1 tile fits in shared memory in
// f32 (186,624 B), so x is read from a zero-padded copy in global memory.
// 16 warps: warp w owns output channels 8 (w % 8) .. +8 and a 32-pixel lane
// slice; each thread accumulates 5 pixels x 8 channels per pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_util.cuh"
#include "wgmma_util.cuh"

namespace {

constexpr int S = 25;        // crop side
constexpr int P = S * S;     // 625 pixels
constexpr int SP = S + 2;    // padded side
constexpr int TP = SP * SP;  // 729 padded pixels
constexpr int C = 64;

// ---------------------------------------------------------------- bf16

namespace tc {

constexpr int WG = 2;                          // warpgroups
constexpr int NT = WG * 128;                   // threads
constexpr int MT = 5;                          // M tiles of 64 rows per warpgroup: wg + 2 j
constexpr int SLAB = C * C * 2;                // one tap's [64 co][64 ci] bf16
constexpr int WBYTES = 18 * SLAB;              // both convs, 9 taps each
constexpr int ZROW = P;                        // the zero pixel row after the crop's
constexpr int TILE = (P + 1) * C * 2;
constexpr int OFF_X = WBYTES;                  // weights | tile | a, b | barrier
constexpr int OFF_AB = OFF_X + TILE;
constexpr int OFF_BAR = OFF_AB + 4 * C * 4;
constexpr int SMEM = OFF_BAR + 8 + 1024;       // + slack to align the weights to 1024 B
constexpr int ITEMS = (8 * P + NT - 1) / NT;  // 8-channel pixel chunks per thread, first crop
constexpr int STAGED = 58;                     // channel planes of the next crop staged in conv1's slabs
constexpr int STAGE_BYTES = (STAGED * P * 2 + 15) / 16 * 16;
constexpr int REST = (C - STAGED) * P;         // the other planes' values, through registers
constexpr int REST_PER = (REST + NT - 1) / NT;

static_assert(WG * MT * 64 >= P, "M tiles cover the crop");
static_assert(OFF_X % 128 == 0, "pixel-row alignment");
static_assert(STAGE_BYTES <= 9 * SLAB && STAGED >= 56, "the staged planes fit conv1's slabs and cover chunks 0-6");

using namespace vct_wgmma;

// byte offset of channel chunk c8 (8 channels) of pixel q in the tile
__device__ __forceinline__ uint32_t cell(int q, int c8) { return q * 128 + ((c8 ^ (q & 7)) << 4); }

// acc = conv3x3 of the tile at `src` with the 9 slabs at `w`, for the 64
// pixels of M tile m. Lane l feeds ldmatrix row r (its warp's 16 rows)
// and 8-channel half kh of each k16 step.
__device__ __forceinline__ void conv_tile(uint32_t src, uint32_t w, int m, int r, int kh, float (&acc)[32]) {
  asm volatile("" : "+r"(r));  // computed here, not hoisted out of the crop loop into local memory
  const int p = m * 64 + r, y = p / S, x = p - y * S;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  uint32_t a[2][4][4];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int yy = y + tap / 3 - 1, xx = x + tap % 3 - 1;
    const int q = p < P && yy >= 0 && yy < S && xx >= 0 && xx < S ? yy * S + xx : ZROW;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) ldsm_x4(src + cell(q, 2 * ks + kh), a[tap & 1][ks]);
    wg_fence();
    const uint64_t desc = desc_sw128(w + tap * SLAB);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_m64n64k16(acc, a[tap & 1][ks], desc + 2 * ks);  // +32 B per k16
    wg_commit();
    wg_wait<1>();  // the previous tap's MMAs are done: its A buffer is free
  }
  wg_wait<0>();
  fence_acc(acc);
}

// the tile <- crop xn (NCHW), 8 channels of one pixel per thread and step
__device__ __forceinline__ void load_tile(unsigned char* tile, const __nv_bfloat16* __restrict__ xn, int tid) {
  uint4 v[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = min(tid + k * NT, 8 * P - 1), c8 = i / P, p = i - c8 * P;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v[k]);
#pragma unroll
    for (int c = 0; c < 8; ++c) e[c] = xn[(c8 * 8 + c) * P + p];
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = tid + k * NT, c8 = i / P, p = i - c8 * P;
    if (i < 8 * P) *reinterpret_cast<uint4*>(tile + cell(p, c8)) = v[k];
  }
}

__global__ void __launch_bounds__(NT, 1)
    reid_block_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                    const __nv_bfloat16* __restrict__ w2, const float* __restrict__ ab,
                    __nv_bfloat16* __restrict__ out, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* xt = smem + OFF_X;
  float* abs_ = reinterpret_cast<float*>(smem + OFF_AB);
  const uint32_t wa = smem_u32(smem), xa = smem_u32(xt), bar = wa + OFF_BAR;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, WBYTES);
    for (int k = 0; k < 18; ++k) bulk_load(wa + k * SLAB, (k < 9 ? w1 : w2) + (k % 9) * C * C, SLAB, bar);
  }
  for (int i = tid; i < C * 2 / 16; i += NT) reinterpret_cast<uint4*>(xt + ZROW * 128)[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < 4 * C; i += NT) abs_[i] = ab[i];
  load_tile(xt, x + (size_t)blockIdx.x * C * P, tid);  // the first crop
  mbar_wait(bar, 0);  // the weights have landed

  const int wg = tid >> 7, wq = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int r = wq * 16 + (lane & 15), kh = lane >> 4;
  uint32_t phase = 1;  // of `bar`'s next completion
  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    __syncthreads();  // the tile holds crop n, conv1's slabs are in place
    uint32_t h1[MT][16];  // relu(acc * a1 + b1) as bf16 pairs, [tile][2 jj + h]
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      float acc[32];
      conv_tile(xa, wa, wg + 2 * j, r, kh, acc);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 a = *reinterpret_cast<const float2*>(abs_ + 8 * jj + 2 * tq);
        const float2 b = *reinterpret_cast<const float2*>(abs_ + C + 8 * jj + 2 * tq);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(fmaxf(acc[4 * jj + 2 * h] * a.x + b.x, 0.0f),
                                                         fmaxf(acc[4 * jj + 2 * h + 1] * a.y + b.y, 0.0f));
          h1[j][2 * jj + h] = *reinterpret_cast<const uint32_t*>(&v);
        }
      }
    }
    __syncthreads();  // every warp is done reading x and conv1's slabs
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (wg + 2 * j) * 64 + wq * 16 + gq + 8 * h;
        if (p >= P) continue;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) *reinterpret_cast<uint32_t*>(xt + cell(p, jj) + 4 * tq) = h1[j][2 * jj + h];
      }
    const int next = n + gridDim.x;
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(x + (size_t)min(next, N - 1) * C * P);
    if (tid == 0 && next < N) {  // the next crop's first planes into conv1's slabs, during conv2
      mbar_expect_tx(bar, STAGE_BYTES);
      bulk_load(wa, xs, STAGE_BYTES, bar);
    }
    uint32_t rest[REST_PER];  // and its other planes' values, used after conv2
#pragma unroll
    for (int k = 0; k < REST_PER; ++k) rest[k] = __ldg(xs + STAGED * P + min(tid + k * NT, REST - 1));
    __syncthreads();  // the tile holds h1

    const unsigned short* xn = reinterpret_cast<const unsigned short*>(x + (size_t)n * C * P);
    __nv_bfloat16* on = out + (size_t)n * C * P;
#pragma unroll 1
    for (int j = 0; j < MT; ++j) {
      const int m = wg + 2 * j;
      uint32_t res[2][16];  // this thread's residual x (bf16 bits), [h][2 jj + (0, 1)]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = min(m * 64 + wq * 16 + gq + 8 * h, P - 1);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          res[h][2 * jj] = __ldg(xn + (8 * jj + 2 * tq) * P + p);
          res[h][2 * jj + 1] = __ldg(xn + (8 * jj + 2 * tq + 1) * P + p);
        }
      }
      float acc[32];
      conv_tile(xa, wa + 9 * SLAB, m, r, kh, acc);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(res[h][i]));  // loads land during the MMAs
      // out = relu(acc * a2 + b2 + x) in bf16
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int co = 8 * jj + 2 * tq;
        const float2 a = *reinterpret_cast<const float2*>(abs_ + 2 * C + co);
        const float2 b = *reinterpret_cast<const float2*>(abs_ + 3 * C + co);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = m * 64 + wq * 16 + gq + 8 * h;
          if (p >= P) continue;
          on[co * P + p] = __float2bfloat16_rn(
              fmaxf(acc[4 * jj + 2 * h] * a.x + b.x + __uint_as_float(res[h][2 * jj] << 16), 0.0f));
          on[(co + 1) * P + p] = __float2bfloat16_rn(
              fmaxf(acc[4 * jj + 2 * h + 1] * a.y + b.y + __uint_as_float(res[h][2 * jj + 1] << 16), 0.0f));
        }
      }
    }
    if (next >= N) break;
    __syncthreads();  // every warp is done reading h1
    mbar_wait(bar, phase);  // the staged planes have landed
    phase ^= 1;
    // the next crop into the tile: staged planes [c][p] -> pixel-major chunks
    const unsigned short* st = reinterpret_cast<const unsigned short*>(smem);
    for (int i = tid; i < 7 * P; i += NT) {  // chunks 0-6: planes 0-55
      const int c8 = i / P, p = i - c8 * P;
      uint4 v;
      unsigned short* e = reinterpret_cast<unsigned short*>(&v);
#pragma unroll
      for (int c = 0; c < 8; ++c) e[c] = st[(c8 * 8 + c) * P + p];
      *reinterpret_cast<uint4*>(xt + cell(p, c8)) = v;
    }
    for (int p = tid; p < P; p += NT)  // planes 56, 57 of chunk 7
      *reinterpret_cast<uint32_t*>(xt + cell(p, 7)) = st[56 * P + p] | (uint32_t)st[57 * P + p] << 16;
#pragma unroll
    for (int k = 0; k < REST_PER; ++k) {  // planes 58-63 of chunk 7
      const int i = tid + k * NT;
      if (i >= REST) continue;
      const int c = STAGED + i / P, p = i % P;
      *reinterpret_cast<unsigned short*>(xt + cell(p, 7) + (c & 7) * 2) = (unsigned short)rest[k];
    }
    __syncthreads();  // every warp is done reading the staged planes
    if (tid == 0) {  // conv1's slabs back
      fence_proxy_async();
      mbar_expect_tx(bar, 9 * SLAB);
      for (int k = 0; k < 9; ++k) bulk_load(wa + k * SLAB, w1 + k * C * C, SLAB, bar);
    }
    mbar_wait(bar, phase);
    phase ^= 1;
  }
}

}  // namespace tc

// ----------------------------------------------------------------- f32

namespace direct {

using vct_conv::load8;

constexpr int NT = 512;      // threads: 8 channel groups x 2 pixel slices x 32 lanes
constexpr int PX = 5;        // pixels per thread per pass
constexpr int PSTRIDE = 64;  // pixel stride between a thread's pixels
constexpr int NPASS = 2;     // 2 x 5 x 64 = 640 >= 625
constexpr int SMEM = C * TP * 4;

// acc[j][k] = sum over taps and input channels of src * w, for this
// thread's pixels (padded window origins base[j]) and channels co0 + k
__device__ __forceinline__ void conv3x3(const float* src, const float* __restrict__ w, const int base[PX], int co0,
                                        float acc[PX][8]) {
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[j][k] = 0.0f;
  for (int tap = 0; tap < 9; ++tap) {
    const float* sp = src + (tap / 3) * SP + (tap % 3);
    const float* wp = w + tap * C * C + co0;
#pragma unroll 2
    for (int ci = 0; ci < C; ++ci) {
      float wv[8];
      load8(wp + ci * C, wv);
      float xv[PX];
#pragma unroll
      for (int j = 0; j < PX; ++j) xv[j] = sp[ci * TP + base[j]];
#pragma unroll
      for (int j = 0; j < PX; ++j)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[j][k] = fmaf(xv[j], wv[k], acc[j][k]);
    }
  }
}

__global__ void __launch_bounds__(NT, 1)
    reid_block_f32(const float* __restrict__ x, const float* __restrict__ xpad, const float* __restrict__ w1,
                   const float* __restrict__ w2, const float* __restrict__ ab, float* __restrict__ out, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* hs = reinterpret_cast<float*>(smem);  // [C][TP] padded h1
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int co0 = (warp & 7) * 8;
  const int pix0 = (warp >> 3) * 32 + (t & 31);

  // zero the tile once: the border stays zero (the pad), the interior is
  // rewritten for every crop
  for (int i = t; i < C * TP; i += NT) hs[i] = 0.0f;
  __syncthreads();

  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    const float* xn = x + (size_t)n * C * P;
    const float* src = xpad + (size_t)n * C * TP;

    // conv1 -> h1 = relu(acc * a1 + b1), into the padded h1 tile
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
          hs[co * TP + base[j] + SP + 1] = fmaxf(acc[j][k] * __ldg(ab + co) + __ldg(ab + C + co), 0.0f);
        }
      }
    }
    __syncthreads();

    // conv2 -> out = relu(acc * a2 + b2 + x); the barrier after it keeps
    // the next crop's h1 writes behind every thread's reads here
    for (int pass = 0; pass < NPASS; ++pass) {
      int base[PX];
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const int p = pix0 + PSTRIDE * (pass * PX + j);
        const int q = p < P ? p : 0;
        base[j] = (q / S) * SP + q % S;
      }
      float acc[PX][8];
      conv3x3(static_cast<const float*>(hs), w2, base, co0, acc);
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const int p = pix0 + PSTRIDE * (pass * PX + j);
        if (p >= P) continue;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int co = co0 + k;
          const float y = acc[j][k] * __ldg(ab + 2 * C + co) + __ldg(ab + 3 * C + co) + xn[co * P + p];
          out[(size_t)n * C * P + co * P + p] = fmaxf(y, 0.0f);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace direct

template <typename K, typename... A>
int launch(K kernel, int threads, int smem, int N, cudaStream_t stream, A... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int grid = N < sms ? N : sms;
  kernel<<<grid, threads, smem, stream>>>(args..., N);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out [N, 64, 25, 25]; ab [4, 64] f32 rows a1, b1, a2, b2.
// bf16 != 0: x, out bf16, xpad null, w1 and w2 the packed bf16 weights of
//   ops/reid_block.py::pack_weights ([9 taps][64 co][64 ci], each 128-byte
//   row swizzled: ci chunk c at chunk c ^ (co % 8)).
// bf16 == 0: x, out f32, xpad x zero-padded to [N, 64, 27, 27], w1 and w2
//   HWIO [3, 3, 64, 64] f32.
extern "C" int vct_reid_block64(const void* x, const void* xpad, const void* w1, const void* w2, const void* ab,
                                void* out, int N, int bf16, void* stream) {
  if (N <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    if (xpad) return (int)cudaErrorInvalidValue;
    return launch(tc::reid_block_bf16, tc::NT, tc::SMEM, N, st, (const __nv_bfloat16*)x, (const __nv_bfloat16*)w1,
                  (const __nv_bfloat16*)w2, (const float*)ab, (__nv_bfloat16*)out);
  }
  if (!xpad) return (int)cudaErrorInvalidValue;
  return launch(direct::reid_block_f32, direct::NT, direct::SMEM, N, st, (const float*)x, (const float*)xpad,
                (const float*)w1, (const float*)w2, (const float*)ab, (float*)out);
}

// dynamic shared memory a block of the bf16 (bf16 != 0) or f32 kernel takes
extern "C" int vct_reid_block64_smem(int bf16) { return bf16 ? tc::SMEM : direct::SMEM; }
