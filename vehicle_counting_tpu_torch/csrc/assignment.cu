// Batched Jonker-Volgenant row insertion on compacted [S, S] f32 costs:
// one thread block per problem, one launch for all classes.
//
// Replaces the TPU kernel vehicle_counting_tpu/ops/pallas/assignment.py
// (_insert_rows_pallas_batched, and _insert_rows_pallas_base as its C = 1
// case; body _insert_rows_body). On the TPU the problems were grid steps
// run in order, each a while loop over [1, LANES] vector tiles; here they
// are independent blocks that run concurrently.
//
// Bound on the H100: latency, like the association kernel. Each Dijkstra
// step reads one cost row (S floats, coalesced, from L2), takes one
// block-wide min and updates the duals; the barriers of that chain set
// the time. The design keeps one column per thread (its v dual and minv in
// registers; u, p and way in shared memory) and reads cost rows straight
// from global memory, so S is bounded by the block's 1024 threads
// (S + 1 <= 1024), not by shared memory. The Dijkstra-and-augment loop is
// jv.cuh's insert_rows, shared with the association kernel (cascade.cu).
//
// Compacted form: every column 0..S-1 takes part and the tie key is the
// column index, so ties go to the first minimum, as in scipy and the plain
// version (vehicle_counting_tpu_torch/tracking/assignment.py::
// _insert_rows). f32 subtraction and comparison only: bitwise-equal.
//
// vct_match_stage is the staged route's whole matching stage in one
// launch (the plain version is ops/assignment.py::match_stage_plain: two
// stable argsorts, two gathers, the transpose rule around the insertion,
// the scatter back, accept / reject and the demotion, ~45 small kernels).
// It works on the uncompacted [K, K] cost with masks and order keys, like
// the association kernel (match_stage.cuh is shared with cascade.cu), and
// updates det_free, track_col and det_key in place. The staged route
// exists for order keys past the association kernel's range, so only the
// keys' ranks enter the packed argmin word and the keys may be any int32.
// One column per thread up to K = 1023; the cost stays in global memory
// (the clamp is applied as it is read). A class whose stage has no row or
// no free detection returns before it reads anything else.

#include <cuda_runtime.h>
#include <stdint.h>

#include "match_stage.cuh"

namespace {

constexpr int LANE_BITS = 10;  // lanes 0..S (S <= 1023)
constexpr int MAX_S = 1023;

__global__ void insert_rows_kernel(const float* __restrict__ costs, const int* __restrict__ n_ins,
                                   int S, int* __restrict__ p_out) {
  extern __shared__ unsigned long long smem_u64[];
  const int t = threadIdx.x;
  const int c = blockIdx.x;
  vct_jv::BlockMin bmin(smem_u64);
  float* u = (float*)(smem_u64 + vct_jv::RED_WORDS);
  int* p = (int*)(u + S + 1);
  int* way = p + S + 1;

  if (t <= S) {
    u[t] = 0.0f;
    p[t] = -1;
  }
  int n = n_ins[c];
  n = n < 0 ? 0 : (n > S ? S : n);
  __syncthreads();
  const float* m = costs + (size_t)c * S * S;
  vct_jv::insert_rows<LANE_BITS>(
      n, S, nullptr, t < S, 0, [&](int i0) { return m[(size_t)i0 * S + t]; }, u, p, way, bmin);
  if (t <= S) p_out[(size_t)c * (S + 1) + t] = p[t];
}

__global__ void match_stage_kernel(const float* __restrict__ cost, const unsigned char* __restrict__ rows,
                                   unsigned char* __restrict__ det_free, const int* __restrict__ row_order,
                                   int* __restrict__ det_key, int* __restrict__ track_col,
                                   const int* __restrict__ stage_base, int K, float thr, float clampv) {
  extern __shared__ unsigned long long smem_u64[];
  const int t = threadIdx.x;
  const size_t off = (size_t)blockIdx.x * K;
  const bool is_row = t < K && rows[off + t] != 0;
  const bool is_det = t < K && det_free[off + t] != 0;
  const int nr = __syncthreads_count(is_row);
  const int nc = __syncthreads_count(is_det);
  if (nr == 0 || nc == 0) return;  // an empty stage changes nothing

  vct_stage::Shared s;
  vct_stage::carve(s, smem_u64, K);
  vct_jv::BlockMin bmin(s.red);
  if (t < K) {
    s.det_free[t] = is_det;
    s.det_key[t] = det_key[off + t];
    s.track_col[t] = track_col[off + t];
  }
  __syncthreads();
  const float* m = cost + off * K;
  vct_stage::match_stage<false>(
      s, K, is_row, is_det, nr, nc,
      [&](int tr, int de) { return fminf(m[(size_t)tr * K + de], clampv); },
      thr, row_order + off, stage_base[blockIdx.x], nullptr, bmin, nullptr);
  if (t < K) {
    det_free[off + t] = (unsigned char)(s.det_free[t] != 0);
    det_key[off + t] = s.det_key[t];
    track_col[off + t] = s.track_col[t];
  }
}

}  // namespace

// One matching stage for C classes, in place on det_free (bool bytes),
// det_key and track_col (int32 [C, K]). cost [C, K, K] f32, rows bool
// bytes, row_order int32 [C, K], stage_base int32 [C].
extern "C" int vct_match_stage(const void* cost, const void* rows, void* det_free, const void* row_order,
                               void* det_key, void* track_col, const void* stage_base, int C, int K,
                               float thr, float clampv, void* stream) {
  if (C <= 0 || K <= 0) return 0;
  if (K > vct_stage::MAX_K) return (int)cudaErrorInvalidValue;
  const int threads = ((K + 1 + 31) / 32) * 32;
  match_stage_kernel<<<C, threads, vct_stage::shared_bytes(K), (cudaStream_t)stream>>>(
      (const float*)cost, (const unsigned char*)rows, (unsigned char*)det_free, (const int*)row_order,
      (int*)det_key, (int*)track_col, (const int*)stage_base, K, thr, clampv);
  return (int)cudaGetLastError();
}

extern "C" int vct_insert_rows(const void* costs, const void* n_ins, int C, int S, void* p_out,
                               void* stream) {
  if (C <= 0 || S <= 0) return 0;
  if (S > MAX_S) return (int)cudaErrorInvalidValue;
  const size_t smem = vct_jv::RED_WORDS * sizeof(unsigned long long) + (size_t)3 * (S + 1) * sizeof(int);
  const int threads = ((S + 1 + 31) / 32) * 32;
  insert_rows_kernel<<<C, threads, smem, (cudaStream_t)stream>>>(
      (const float*)costs, (const int*)n_ins, S, (int*)p_out);
  return (int)cudaGetLastError();
}
