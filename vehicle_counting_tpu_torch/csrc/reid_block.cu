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
// f32 (parity mode; the card's embed never sends f32 here, the trainer's
// extract_features does): FFMA on the CUDA cores, f32 products, f32 sums.
// The same 46 M MACs per crop are 5.28 ms at the 67 TFLOP/s f32 peak for
// N = 3840, against 1.23 GB (0.37 ms) of x and out: the bound is the FMA
// pipes, one warp FFMA per clock per SM quarter, so every other
// instruction the SM issues is time taken from them.
// Design: one persistent block of 8 warps per SM walks the crops.
// - One tile in shared memory holds a whole crop, zero-padded: 64 planes of
//   27 rows x 28 floats (row stride 28: a warp's window loads hit at most
//   2 lanes per bank; 27 gave 5), a plane's bottom pad row shared with the
//   next plane's top, 186,480 B. It holds x for conv1, then h1 (written
//   over x once every warp is done reading it: h1 never leaves the SM),
//   then conv2's acc * a2 + b2. f32 x and h1 do not both fit; a 2-block
//   cluster or an L2 scratch for h1 is not needed, since x is not needed
//   after conv1 except as the residual, which is read from global memory.
// - The weights are streamed: [8 ci][9 taps][64 co] chunks (18,432 B, 8
//   per conv, packed by ops/reid_block.py::pack_weights_f32) by one bulk
//   async copy each into a ring of two stages on mbarriers, refilled two
//   chunks ahead, across the two convs and across crops: a copy lands
//   while the previous chunk's FMAs run.
// - Thread micro-tile: two 5-pixel row segments x 16 output channels, 160
//   accumulators in registers for the whole conv (the crop's 125 segments
//   over 64 slots x 4 channel groups = 256 threads; 3 slots have one).
//   Per input channel and tap row, 7 window floats per segment (scalar
//   shared loads) serve the 3 taps of that row; per tap, 16 weights by 4
//   16-byte loads that are one broadcast for the warp (a warp shares its
//   channel group) and serve both segments. 1,440 FFMA to 78 loads per
//   input channel: ~95 % of the issued instructions are FFMA, and shared
//   memory's 128 B per clock to registers (a warp's 16-byte load takes 4
//   clocks of it, broadcast or not) is 60 % used where one segment per
//   thread used 95 %. What is left between this and the FMA peak (the
//   kernel issues ~2.95 instructions per clock of the SM's 4) did not
//   move with the tiling; the FMA loop's order moved it by 2-7 %
//   (operand reuse and register banks), and this order was the fastest.
// - Epilogue: acc * a2 + b2 goes into the tile; one coalesced pass over
//   the crop then reads the residual x (16-byte loads, prefetched into L2
//   during conv2), stores out = relu(. + x) with 16-byte stores, and writes
//   the next crop's x into the tile in the same pass, the one moment the
//   tile is free.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_util.cuh"

namespace {

constexpr int S = 25;        // crop side
constexpr int P = S * S;     // 625 pixels
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

namespace ffma {

constexpr int PX = 5;               // pixels of a segment: a fifth of one row
constexpr int PG = P / PX;          // 125 segments
constexpr int SEG = 2;              // segments per thread (1: 16 warps, 3 % slower)
constexpr int SLOTS = 128 / SEG;    // threads per channel group: segment j of thread t is t + SLOTS j
constexpr int NT = 4 * SLOTS;       // 4 channel groups
constexpr int CO = 16;              // output channels per thread
constexpr int RS = 28;              // padded row stride in floats: window loads at most 2-way bank conflicts (27: 5-way)
constexpr int PS = 26 * RS;         // plane stride: a plane's bottom pad row is the next plane's top one
constexpr int TILE = C * PS + RS;   // floats: 64 planes, the last one's bottom pad row
constexpr int CK = 8;               // input channels per weight chunk
constexpr int CHUNK = CK * 9 * C;   // floats of one chunk: [8 ci][9 taps][64 co], 18,432 B
constexpr int NCHUNK = C / CK;      // chunks per conv
constexpr int V4 = C * P / 4;       // 16-byte pieces of one crop
constexpr int OFF_W = TILE * 4;     // bytes: tile | ring of two chunks | a, b | two mbarriers
constexpr int OFF_AB = OFF_W + 2 * CHUNK * 4;
constexpr int OFF_BAR = OFF_AB + 4 * C * 4;
constexpr int SMEM = OFF_BAR + 2 * 8;

static_assert(OFF_W % 16 == 0 && (CHUNK * 4) % 16 == 0, "bulk copies move 16-byte units");
static_assert(SMEM <= 232448, "one block per SM");
static_assert(SLOTS * SEG >= PG && SLOTS % 32 == 0, "a channel group's warps cover the segments");

using namespace vct_wgmma;

// tile offset of pixel p of channel ci: padded row y + 1, column x + 1
__device__ __forceinline__ int at(int ci, int p) {
  const int y = p / S;
  return ci * PS + (y + 1) * RS + (p - y * S) + 1;
}

// the tile's interior <- crop xn (NCHW), 16-byte coalesced loads
__device__ __forceinline__ void load_crop(float* tile, const float* __restrict__ xn, int tid) {
  const float4* x4 = reinterpret_cast<const float4*>(xn);
  for (int k0 = tid; k0 < V4; k0 += 4 * NT) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = __ldg(x4 + min(k0 + u * NT, V4 - 1));
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u * NT;
      if (k >= V4) break;
      const float e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = 4 * k + i, ci = q / P;
        tile[at(ci, q - ci * P)] = e[i];
      }
    }
  }
}

// out = relu(tile + x) over crop n (the tile holds acc2 * a2 + b2), and in
// the same pass the tile's interior <- the next crop (xnext null: none)
__device__ __forceinline__ void finish_crop(float* tile, const float* __restrict__ xn, const float* __restrict__ xnext,
                                            float* __restrict__ on, int tid) {
  const float4* r4 = reinterpret_cast<const float4*>(xn);
  const float4* n4 = reinterpret_cast<const float4*>(xnext);
  float4* o4 = reinterpret_cast<float4*>(on);
  for (int k0 = tid; k0 < V4; k0 += 4 * NT) {
    float4 res[4], nx[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = min(k0 + u * NT, V4 - 1);
      res[u] = __ldg(r4 + k);
      nx[u] = xnext ? __ldg(n4 + k) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u * NT;
      if (k >= V4) break;
      const float r[4] = {res[u].x, res[u].y, res[u].z, res[u].w};
      const float nv[4] = {nx[u].x, nx[u].y, nx[u].z, nx[u].w};
      float o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = 4 * k + i, ci = q / P, t = at(ci, q - ci * P);
        o[i] = fmaxf(tile[t] + r[i], 0.0f);
        if (xnext) tile[t] = nv[i];
      }
      o4[k] = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

__device__ __forceinline__ void prefetch_l2(const float* p, int tid) {
  const char* b = reinterpret_cast<const char*>(p);
  for (int off = tid * 128; off < C * P * 4; off += NT * 128) asm volatile("prefetch.global.L2 [%0];" ::"l"(b + off));
}

// acc = conv3x3 of the tile with one conv's weights, streamed through the
// ring: chunk `it` (counted over the whole launch) sits in stage it % 2.
// Each chunk ends with a barrier, after which thread 0 refills the stage
// with chunk it + 2 if this block will use it.
__device__ __forceinline__ void conv(const float* tile, const float* ring, uint32_t ring_a, uint32_t bar,
                                     const float* __restrict__ w, uint32_t& it, uint32_t total, const int (&win0)[SEG],
                                     int g, int tid, float (&acc)[SEG][PX][CO]) {
#pragma unroll
  for (int s = 0; s < SEG; ++s)
#pragma unroll
    for (int j = 0; j < PX; ++j)
#pragma unroll
      for (int k = 0; k < CO; ++k) acc[s][j][k] = 0.0f;
#pragma unroll 1
  for (int cc = 0; cc < NCHUNK; ++cc, ++it) {
    const uint32_t s = it & 1;
    mbar_wait(bar + 8 * s, (it >> 1) & 1);
    const float* xs = tile + cc * CK * PS;
    const float* ws = ring + s * CHUNK + CO * g;
#pragma unroll 1
    for (int ci = 0; ci < CK; ++ci, xs += PS, ws += 9 * C) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float v[SEG][PX + 2];  // per segment: input row r + dy - 1, columns 5c - 1 .. 5c + 5
#pragma unroll
        for (int s = 0; s < SEG; ++s)
#pragma unroll
          for (int j = 0; j < PX + 2; ++j) v[s][j] = xs[win0[s] + dy * RS + j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4* wp = reinterpret_cast<const float4*>(ws + (dy * 3 + dx) * C);
          float wv[CO];
#pragma unroll
          for (int q = 0; q < CO / 4; ++q) {
            const float4 t = wp[q];
            wv[4 * q] = t.x; wv[4 * q + 1] = t.y; wv[4 * q + 2] = t.z; wv[4 * q + 3] = t.w;
          }
#pragma unroll
          for (int s = 0; s < SEG; ++s)
#pragma unroll
            for (int j = 0; j < PX; ++j)
#pragma unroll
              for (int k = 0; k < CO; ++k) acc[s][j][k] = fmaf(v[s][j + dx], wv[k], acc[s][j][k]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage (and, after the last chunk, with the tile)
    if (tid == 0 && it + 2 < total) {
      const uint32_t nxt = it + 2;
      mbar_expect_tx(bar + 8 * s, CHUNK * 4);
      bulk_load(ring_a + s * CHUNK * 4, w + ((nxt / NCHUNK) % 2 * NCHUNK + nxt % NCHUNK) * CHUNK, CHUNK * 4, bar + 8 * s);
    }
  }
}

__global__ void __launch_bounds__(NT, 1)
    reid_block_f32(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ ab,
                   float* __restrict__ out, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);
  const float* ring = reinterpret_cast<const float*>(smem + OFF_W);
  float* abs_ = reinterpret_cast<float*>(smem + OFF_AB);
  const uint32_t ring_a = smem_u32(smem + OFF_W), bar = smem_u32(smem + OFF_BAR);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = warp & 3;                        // output channels 16 g .. 16 g + 15
  const int t = (warp >> 2) * 32 + (tid & 31);  // slot in the channel group
  int win0[SEG];   // per segment (row r, columns 5 c .. 5 c + 4): padded row r, column 5 c (input row r - 1, x 5 c - 1)
  bool live[SEG];  // slots past the crop compute segment 124 and store nothing
#pragma unroll
  for (int s = 0; s < SEG; ++s) {
    live[s] = t + SLOTS * s < PG;
    const int q = live[s] ? t + SLOTS * s : PG - 1, r = q / PX;
    win0[s] = r * RS + PX * (q - r * PX);
  }
  // chunks this block consumes: two convs of NCHUNK for each of its crops
  const uint32_t total = 2 * NCHUNK * ((N - 1 - (int)blockIdx.x) / (int)gridDim.x + 1);

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < TILE; i += NT) tile[i] = 0.0f;  // the pads stay zero: only the interior is rewritten
  for (int i = tid; i < 4 * C; i += NT) abs_[i] = ab[i];
  __syncthreads();
  if (tid == 0)
    for (uint32_t s = 0; s < 2; ++s) {
      mbar_expect_tx(bar + 8 * s, CHUNK * 4);
      bulk_load(ring_a + s * CHUNK * 4, w + s * CHUNK, CHUNK * 4, bar + 8 * s);
    }
  load_crop(tile, x + (size_t)blockIdx.x * C * P, tid);

  uint32_t it = 0;
  float acc[SEG][PX][CO];
  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    const int next = n + gridDim.x;
    const float* xn = x + (size_t)n * C * P;
    const float* xnext = next < N ? x + (size_t)next * C * P : nullptr;
    __syncthreads();  // the tile holds crop n
    conv(tile, ring, ring_a, bar, w, it, total, win0, g, tid, acc);
#pragma unroll
    for (int s = 0; s < SEG; ++s)  // h1 = relu(acc * a1 + b1) over x, which every warp is done reading
      if (live[s])
#pragma unroll
        for (int k = 0; k < CO; ++k) {
          const int co = CO * g + k;
          const float a = abs_[co], b = abs_[C + co];
#pragma unroll
          for (int j = 0; j < PX; ++j) tile[co * PS + win0[s] + RS + 1 + j] = fmaxf(acc[s][j][k] * a + b, 0.0f);
        }
    prefetch_l2(xn, tid);  // the residual and the next crop, read after conv2
    if (xnext) prefetch_l2(xnext, tid);
    __syncthreads();  // the tile holds h1
    conv(tile, ring, ring_a, bar, w, it, total, win0, g, tid, acc);
#pragma unroll
    for (int s = 0; s < SEG; ++s)  // acc * a2 + b2 over h1; the residual and relu follow in finish_crop
      if (live[s])
#pragma unroll
        for (int k = 0; k < CO; ++k) {
          const int co = CO * g + k;
          const float a = abs_[2 * C + co], b = abs_[3 * C + co];
#pragma unroll
          for (int j = 0; j < PX; ++j) tile[co * PS + win0[s] + RS + 1 + j] = acc[s][j][k] * a + b;
        }
    __syncthreads();
    finish_crop(tile, xn, xnext, out + (size_t)n * C * P, tid);
  }
}

}  // namespace ffma

// per kernel and device: the SM count once the shared-memory limit is set
constexpr int MAX_DEVICES = 64;

template <typename K, typename... A>
int launch(K kernel, int (&sms)[MAX_DEVICES], int threads, int smem, int N, cudaStream_t stream, A... args) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {  // once per device: both calls are host work, not the launch's
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    int n = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    sms[dev] = n;
  }
  const int grid = N < sms[dev] ? N : sms[dev];
  kernel<<<grid, threads, smem, stream>>>(args..., N);
  return (int)cudaGetLastError();
}

int sms_bf16[MAX_DEVICES], sms_f32[MAX_DEVICES];

}  // namespace

// x, out [N, 64, 25, 25]; ab [4, 64] f32 rows a1, b1, a2, b2; w both
// convs' weights, packed by ops/reid_block.py:
// bf16 != 0: x, out bf16, w pack_weights' [2 convs][9 taps][64 co][64 ci]
//   bf16, each 128-byte row swizzled: ci chunk c at chunk c ^ (co % 8).
// bf16 == 0: x, out f32, w pack_weights_f32's [2 convs][64 ci][9 taps][64 co]
//   f32. x and w 16-byte aligned.
extern "C" int vct_reid_block64(const void* x, const void* w, const void* ab, void* out, int N, int bf16,
                                void* stream) {
  if (N <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    const __nv_bfloat16* wb = (const __nv_bfloat16*)w;
    return launch(tc::reid_block_bf16, sms_bf16, tc::NT, tc::SMEM, N, st, (const __nv_bfloat16*)x, wb,
                  wb + 9 * C * C, (const float*)ab, (__nv_bfloat16*)out);
  }
  return launch(ffma::reid_block_f32, sms_f32, ffma::NT, ffma::SMEM, N, st, (const float*)x, (const float*)w,
                (const float*)ab, (float*)out);
}

// dynamic shared memory a block of the bf16 (bf16 != 0) or f32 kernel takes
extern "C" int vct_reid_block64_smem(int bf16) { return bf16 ? tc::SMEM : ffma::SMEM; }
