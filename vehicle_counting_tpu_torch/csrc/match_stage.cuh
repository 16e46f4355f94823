// One min_cost_matching stage of the DeepSORT association for one class,
// in masked, key-ordered form: shared by the association kernel
// (cascade.cu, K2: every stage of a frame in one launch) and the fused
// matching stage of the staged route (assignment.cu, vct_match_stage: one
// stage per launch).
//
// Same function as vehicle_counting_tpu_torch/ops/assignment.py::
// match_stage_plain: the stage's rows (tracks) and the free detections are
// ranked stably by their order keys, the smaller side is inserted in rank
// order (scipy's transpose rule) with jv.cuh's insert_rows, ties going to
// the first minimum in rank order, each pair is accepted or rejected
// against the threshold, and a rejected detection is demoted to key
// base * K + (its rank among the rejects, in row order).
//
// No compaction: a thread owns one track slot and one detection slot. The
// order keys themselves never enter the packed argmin word, only their
// ranks (< K <= 1023, 10 bits), so keys may be any int32. Ranks are counted
// over the participants only, found by warp ballots: a steady frame has a
// handful of rows per cascade level, not K.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "jv.cuh"

namespace vct_stage {

constexpr int LANE_BITS = 10;  // lanes 0..K, K <= 1023; ranks take the next 10 bits
constexpr int MAX_K = 1023;
constexpr int WORDS = 96;      // three ballots of up to 32 warps: rows, free detections, rejects
constexpr int ARRAYS = 9;      // the (K + 1)-word arrays below

struct Shared {
  unsigned long long* red;  // [vct_jv::RED_WORDS]
  unsigned int* words;      // [WORDS]
  float* u;                 // [K+1] duals of the inserted side
  int* p;                   // [K+1] scanned column -> inserted element (-1 free), K = root
  int* way;                 // [K+1]
  int* ins_orig;            // [K+1] insertion order
  int* det_free;            // [K] in/out
  int* det_key;             // [K] in/out
  int* track_col;           // [K] in/out: track slot -> matched detection (-1 none)
  int* rowrank;             // [K] stable rank of the stage's rows
  int* rej;                 // [K] track slot had its pair rejected
};

__host__ __device__ inline size_t shared_bytes(int K) {
  return vct_jv::RED_WORDS * sizeof(unsigned long long) + WORDS * sizeof(unsigned int) +
         (size_t)ARRAYS * (K + 1) * sizeof(int);
}

// Lay `s` out at `base` (8-byte aligned); returns the first word after it.
__device__ inline int* carve(Shared& s, unsigned long long* base, int K) {
  const int n = K + 1;
  s.red = base;
  s.words = (unsigned int*)(base + vct_jv::RED_WORDS);
  int* w = (int*)(s.words + WORDS);
  s.u = (float*)w; w += n;
  s.p = w; w += n;
  s.way = w; w += n;
  s.ins_orig = w; w += n;
  s.det_free = w; w += n;
  s.det_key = w; w += n;
  s.track_col = w; w += n;
  s.rowrank = w; w += n;
  s.rej = w; w += n;
  return w;
}

// One word per warp: which of its lanes hold `pred`. Synchronise before reading.
__device__ __forceinline__ void ballot_to(unsigned int* words, bool pred) {
  const unsigned int b = __ballot_sync(0xffffffffu, pred);
  if ((threadIdx.x & 31) == 0) words[threadIdx.x >> 5] = b;
}

// Stable rank of (key[t], t) among the slots whose bit is set in `words`.
__device__ __forceinline__ int rank_among(const unsigned int* words, int nwords, const int* key, int t) {
  const int kt = key[t];
  int r = 0;
  for (int w = 0; w < nwords; ++w) {
    unsigned int m = words[w];
    while (m) {
      const int j = (w << 5) + __ffs(m) - 1;
      m &= m - 1;
      const int kj = key[j];
      r += (kj < kt) || (kj == kt && j < t);
    }
  }
  return r;
}

// The stage. is_row / is_det: this thread's track slot is a row of the
// stage / its detection slot is free (false for t >= K); nr, nc: their
// block-wide counts, both > 0. cost(tr, de): the clamped cost. rowkey [K]:
// the rows' order keys (shared or global memory). out_row (shared memory,
// may be null): detection slot -> matched track slot. clk (PROF only):
// clock64 ticks of thread 0 added to [0] ranks and set-up, [1] insertion,
// [2] accept / reject / demote. Block-uniform control flow; returns
// synchronised.
template <bool PROF, class Cost>
__device__ void match_stage(const Shared& s, int K, bool is_row, bool is_det, int nr, int nc, Cost cost,
                            float thr, const int* rowkey, int base, int* out_row,
                            vct_jv::BlockMin& bmin, long long* clk) {
  const int t = threadIdx.x;
  const int nw = blockDim.x >> 5;
  long long c0 = 0;
  if (PROF) c0 = clock64();

  ballot_to(s.words, is_row);
  ballot_to(s.words + 32, is_det);
  if (t <= K) {
    s.u[t] = 0.0f;
    s.p[t] = -1;
  }
  if (t < K) s.rej[t] = 0;
  __syncthreads();
  const int rr = is_row ? rank_among(s.words, nw, rowkey, t) : 0;
  const int dr = is_det ? rank_among(s.words + 32, nw, s.det_key, t) : 0;
  const bool flip = nr > nc;  // scipy inserts the smaller side
  const int n_ins = flip ? nc : nr;
  if (flip ? is_det : is_row) s.ins_orig[flip ? dr : rr] = t;
  if (t < K) s.rowrank[t] = rr;
  const bool live = flip ? is_row : is_det;  // scanned side, one column per thread
  const int skey = flip ? rr : dr;
  __syncthreads();
  if (PROF) {
    const long long c1 = clock64();
    if (t == 0) clk[0] += c1 - c0;
    c0 = c1;
  }

  vct_jv::insert_rows<LANE_BITS>(
      n_ins, K, s.ins_orig, live, skey,
      [&](int i0) { return flip ? cost(t, i0) : cost(i0, t); }, s.u, s.p, s.way, bmin);
  if (PROF) {
    const long long c1 = clock64();
    if (t == 0) clk[1] += c1 - c0;
    c0 = c1;
  }

  // accept / reject the stage's pairs: the pairs are a matching, so every
  // write below has its own target
  int tr = -1, de = -1;
  bool rejected = false;
  if (t < K && s.p[t] >= 0) {
    tr = flip ? t : s.p[t];
    de = flip ? s.p[t] : t;
    if (cost(tr, de) <= thr) {
      s.track_col[tr] = de;
      s.det_free[de] = 0;
      if (out_row) out_row[de] = tr;
    } else {
      rejected = true;
      s.rej[tr] = 1;
    }
  }
  if (__syncthreads_count(rejected)) {
    // demote behind every live key, in ascending row order of the rejects
    ballot_to(s.words + 64, t < K && s.rej[t]);
    __syncthreads();
    if (rejected) {
      const int kt = s.rowrank[tr];
      int r = 0;
      for (int w = 0; w < nw; ++w) {
        unsigned int m = s.words[64 + w];
        while (m) {
          const int j = (w << 5) + __ffs(m) - 1;
          m &= m - 1;
          r += s.rowrank[j] < kt;
        }
      }
      s.det_key[de] = base * K + r;
    }
    __syncthreads();
  }
  if (PROF) {
    const long long c1 = clock64();
    if (t == 0) clk[2] += c1 - c0;
  }
}

}  // namespace vct_stage
