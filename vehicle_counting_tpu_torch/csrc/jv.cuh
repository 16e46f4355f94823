// Jonker-Volgenant shortest-augmenting-path row insertion, one column per
// thread, shared by the association kernel (cascade.cu, K2) and the
// assignment kernels (assignment.cu, K4: the compacted insertion and the
// fused matching stage).
//
// Same steps as vehicle_counting_tpu_torch/tracking/assignment.py::
// _insert_rows: for each inserted element, a Dijkstra search over the
// live columns with dual potentials u (inserted side, shared memory) and
// v (scanned side, one register per column thread), then augmentation
// along `way`. The tie-broken argmin of each step is ONE 64-bit block min
// over (order-preserving f32 bits, order key, lane): ties go to the
// smallest order key, then the smallest lane. The arithmetic is f32
// subtraction and comparison only, so a plain version doing the same
// steps is bitwise-equal.
//
// The chain is latency-bound, so barriers are what it pays for: a Dijkstra
// step costs one __syncthreads (inside the block min), an inserted element
// two more.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vct_jv {

constexpr float INF = 1e18f;
constexpr int RED_WORDS = 64;  // two banks of one word per warp

template <int LANE_BITS>
__device__ __forceinline__ unsigned long long pack(float x, int key, int lane) {
  x = x + 0.0f;  // -0 -> +0: equal values must tie
  unsigned int b = __float_as_uint(x);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)b << 32) | ((unsigned int)key << LANE_BITS) | (unsigned int)lane;
}

__device__ __forceinline__ float unpack_value(unsigned long long q) {
  unsigned int b = (unsigned int)(q >> 32);
  b = (b & 0x80000000u) ? (b & 0x7fffffffu) : ~b;
  return __uint_as_float(b);
}

__device__ __forceinline__ unsigned long long warp_min_u64(unsigned long long x, int from) {
  for (int o = from; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_xor_sync(0xffffffffu, x, o);
    x = y < x ? y : x;
  }
  return x;
}

// Block-wide min with ONE barrier per call: every warp leaves its partial
// in a bank of `red` (RED_WORDS words, two banks used in turns) and, after
// the barrier, every warp reduces the bank itself. A bank is rewritten two
// calls later, and the barrier of the call in between orders that write
// after every read of this one. All threads of the block must make every
// call. Every thread gets the result.
struct BlockMin {
  unsigned long long* red;
  int bank;

  __device__ __forceinline__ explicit BlockMin(unsigned long long* r) : red(r), bank(0) {}

  __device__ __forceinline__ unsigned long long operator()(unsigned long long x) {
    const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
    const int nw = blockDim.x >> 5;
    x = warp_min_u64(x, 16);
    unsigned long long* r = red + bank;
    bank ^= 32;
    if (l == 0) r[w] = x;
    __syncthreads();
    x = l < nw ? r[l] : ~0ull;
    // the partials sit in lanes 0..nw-1: reduce that group, lane 0 tells the rest
    x = warp_min_u64(x, nw > 16 ? 16 : nw > 8 ? 8 : nw > 4 ? 4 : nw > 2 ? 2 : 1);
    return __shfl_sync(0xffffffffu, x, 0);
  }
};

// Insert n_ins elements, in the order ins_order[0..n_ins) (pos itself when
// ins_order is null), against K scanned columns. Thread t < K owns column
// t; thread K is the virtual root column, so the block needs > K threads.
// live: column t takes part; skey: its tie order key (< 2^(32-LANE_BITS));
// cost(i0): this thread's column cost against inserted element i0.
// Caller sets u[0..K] = 0 and p[0..K] = -1 and synchronises first. On
// return p[j] is the element assigned to column j (-1 free) and p[K] the
// last inserted element; the block is synchronised.
//
// Why a step needs no barrier of its own: u[.] is written only for the
// rows of used columns, the next step reads u[.] of the row of a column
// that was not used yet (rows of distinct columns are distinct), and the
// next step's writes come after its block min's barrier; p is not written
// between augmentations.
template <int LANE_BITS, class Cost>
__device__ void insert_rows(int n_ins, int K, const int* ins_order, bool live, int skey, Cost cost,
                            float* u, int* p, int* way_s, BlockMin& bmin) {
  const int t = threadIdx.x;
  float v = 0.0f;
  if (t == 0 && n_ins > 0) p[K] = ins_order ? ins_order[0] : 0;
  __syncthreads();
  for (int pos = 0; pos < n_ins; ++pos) {
    float minv = INF;
    int way = K;
    bool used = false;
    int j0 = K;
    // each step marks one more column used, so K + 1 steps bound the search
    for (int step = 0; step <= K; ++step) {
      const int i0 = p[j0];
      if (i0 == -1) break;  // j0 is free: augment
      if (t == j0) used = true;
      const bool cand = live && !used;
      if (cand) {
        const float cur = cost(i0) - u[i0] - v;
        if (cur < minv) {
          minv = cur;
          way = j0;
        }
      }
      const unsigned long long best = bmin(pack<LANE_BITS>(cand ? minv : INF, skey, t));
      const float delta = unpack_value(best);
      const int j1 = (int)(best & ((1u << LANE_BITS) - 1));
      if (used) {
        u[p[t]] += delta;  // rows of used columns are distinct
        v -= delta;
      } else if (live) {
        minv -= delta;
      }
      j0 = j1;
    }
    if (t < K) way_s[t] = way;
    __syncthreads();
    if (t == 0) {
      int j = j0;
      while (j != K) {
        const int j1 = way_s[j];
        p[j] = p[j1];
        j = j1;
      }
      if (pos + 1 < n_ins) p[K] = ins_order ? ins_order[pos + 1] : pos + 1;
    }
    __syncthreads();
  }
}

}  // namespace vct_jv
