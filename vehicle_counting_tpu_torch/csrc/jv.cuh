// Jonker-Volgenant shortest-augmenting-path row insertion, one column per
// thread, shared by the association kernel (cascade.cu, K2) and the
// batched assignment kernel (assignment.cu, K4).
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

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vct_jv {

constexpr float INF = 1e18f;

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

// Block-wide min; red holds 32 words. Every thread gets the result.
__device__ inline unsigned long long block_min_u64(unsigned long long x, unsigned long long* red) {
  for (int o = 16; o > 0; o >>= 1) {
    unsigned long long y = __shfl_down_sync(0xffffffffu, x, o);
    x = y < x ? y : x;
  }
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  __syncthreads();  // the previous call's broadcast has been read
  if (l == 0) red[w] = x;
  __syncthreads();
  if (w == 0) {
    const int nw = blockDim.x >> 5;
    x = l < nw ? red[l] : ~0ull;
    for (int o = 16; o > 0; o >>= 1) {
      unsigned long long y = __shfl_down_sync(0xffffffffu, x, o);
      x = y < x ? y : x;
    }
    if (l == 0) red[0] = x;
  }
  __syncthreads();
  return red[0];
}

// Insert n_ins elements, in the order ins_order[0..n_ins) (pos itself when
// ins_order is null), against K scanned columns. Thread t < K owns column
// t; thread K is the virtual root column, so the block needs > K threads.
// live: column t takes part; skey: its tie order key (< 2^(31-LANE_BITS));
// cost(i0): this thread's column cost against inserted element i0.
// Caller sets u[0..K] = 0 and p[0..K] = -1 and synchronises first. On
// return p[j] is the element assigned to column j (-1 free) and p[K] the
// last inserted element.
template <int LANE_BITS, class Cost>
__device__ void insert_rows(int n_ins, int K, const int* ins_order, bool live, int skey, Cost cost,
                            float* u, int* p, int* way_s, unsigned long long* red) {
  const int t = threadIdx.x;
  float v = 0.0f;
  for (int pos = 0; pos < n_ins; ++pos) {
    if (t == 0) p[K] = ins_order ? ins_order[pos] : pos;
    float minv = INF;
    int way = K;
    bool used = false;
    int j0 = K;
    __syncthreads();
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
      const unsigned long long best = block_min_u64(pack<LANE_BITS>(cand ? minv : INF, skey, t), red);
      const float delta = unpack_value(best);
      const int j1 = (int)(best & ((1u << LANE_BITS) - 1));
      if (used) {
        u[p[t]] += delta;  // rows of used columns are distinct
        v -= delta;
      } else if (live) {
        minv -= delta;
      }
      j0 = j1;
      __syncthreads();
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
    }
    __syncthreads();
  }
}

}  // namespace vct_jv
