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

#include <cuda_runtime.h>
#include <stdint.h>

#include "jv.cuh"

namespace {

constexpr int LANE_BITS = 10;  // lanes 0..S (S <= 1023)
constexpr int MAX_S = 1023;

__global__ void insert_rows_kernel(const float* __restrict__ costs, const int* __restrict__ n_ins,
                                   int S, int* __restrict__ p_out) {
  extern __shared__ unsigned long long smem_u64[];
  const int t = threadIdx.x;
  const int c = blockIdx.x;
  unsigned long long* red = smem_u64;
  float* u = (float*)(smem_u64 + 32);
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
      n, S, nullptr, t < S, 0, [&](int i0) { return m[(size_t)i0 * S + t]; }, u, p, way, red);
  if (t <= S) p_out[(size_t)c * (S + 1) + t] = p[t];
}

}  // namespace

extern "C" int vct_insert_rows(const void* costs, const void* n_ins, int C, int S, void* p_out,
                               void* stream) {
  if (C <= 0 || S <= 0) return 0;
  if (S > MAX_S) return (int)cudaErrorInvalidValue;
  const size_t smem = 32 * sizeof(unsigned long long) + (size_t)3 * (S + 1) * sizeof(int);
  const int threads = ((S + 1 + 31) / 32) * 32;
  insert_rows_kernel<<<C, threads, smem, (cudaStream_t)stream>>>(
      (const float*)costs, (const int*)n_ins, S, (int*)p_out);
  return (int)cudaGetLastError();
}
