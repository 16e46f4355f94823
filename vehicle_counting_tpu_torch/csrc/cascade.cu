// Per-frame DeepSORT association for every class: matching cascade over
// occupied age levels, a scipy-exact Jonker-Volgenant Hungarian solve per
// stage, threshold rejection with unmatched-list demotion, and the IoU
// stage -- one thread block per class, all state in shared memory.
//
// Replaces the TPU kernels vehicle_counting_tpu/ops/pallas/cascade.py
// (_cascade_pallas_cp / cascade_match_classparallel and
// _cascade_pallas_batched / cascade_match_batched). On the TPU the classes
// were either grid steps run in order or sublane-batched state machines;
// here they are independent blocks that run concurrently.
//
// Bound on the H100: latency. The work per class is a chain of small
// dependent steps (each Dijkstra step is a row read, a masked min over
// K lanes and a dual update), so the block's barriers and the
// reduction depth set the time, not bytes or FLOPs. The design keeps the
// clamped [K, K] cost matrices of both stages in shared memory (row stride
// K + 1 so transposed reads are bank-conflict free; matrices too large for
// shared memory are read from global memory instead), keeps one column per
// thread in registers, and does the tie-broken argmin as ONE 64-bit
// warp-shuffle min over (ordered f32 value, order rank, lane) behind one
// barrier. The stage itself (ranks, insertion, accept / reject / demote)
// is match_stage.cuh's, shared with the staged route's kernel
// (assignment.cu); the Dijkstra-and-augment loop is jv.cuh's.
//
// The launch is made to be a node of a captured CUDA graph: the kernel
// reads the bool operands as the bytes they are, writes det_free as bool
// bytes and the per-track matched column (track_col) beside the
// per-detection matched row (out_row), so the caller runs no cast and no
// scatter around it, and it allocates and configures nothing at launch
// (vct_cascade_prepare raises the shared-memory limit once, at first use).
//
// Same masked, key-ordered form as the Pallas kernel: no compaction; ties
// go to the first minimum in the reference's column order; rows are
// inserted in ascending row key; scipy's transpose rule inserts the
// smaller side. The arithmetic is f32 subtraction and comparison only, so
// the result is bitwise-equal to the plain PyTorch version
// (vehicle_counting_tpu_torch/ops/cascade.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "match_stage.cuh"

namespace {

constexpr int IMAX = 2147483647;
constexpr int EXTRA_ARRAYS = 5;              // lvl, tent, ckey, ikey, out_row: (K + 1) words each
constexpr size_t SMEM_MATS_LIMIT = 200 * 1024;  // both cost matrices move into shared memory below this
constexpr int PROF_WORDS = 8;                // per class: load, level walk, ranks, insertion, accept, store, total, stages

__host__ __device__ inline size_t base_bytes(int K) {
  return vct_stage::shared_bytes(K) + (size_t)EXTRA_ARRAYS * (K + 1) * sizeof(int);
}

__host__ __device__ inline size_t mats_bytes(int K) { return 2 * (size_t)K * (K + 1) * sizeof(float); }

__device__ __forceinline__ int block_min_i32(int x, vct_jv::BlockMin& bmin) {
  // non-negative ints only (levels and IMAX)
  return (int)bmin((unsigned long long)(unsigned int)x);
}

template <bool PROF>
__global__ void cascade_kernel(const float* __restrict__ gated, const float* __restrict__ iou,
                               const int* __restrict__ lvl, const unsigned char* __restrict__ tent,
                               const int* __restrict__ row_key, const int* __restrict__ iou_key,
                               const unsigned char* __restrict__ det_valid, const int* __restrict__ det_order,
                               int K, float thr_c, float thr_i, float clamp_c, float clamp_i,
                               int max_age, int use_smem,
                               int* __restrict__ out_row_g, unsigned char* __restrict__ det_free_g,
                               int* __restrict__ det_key_g, int* __restrict__ track_col_g,
                               long long* __restrict__ prof) {
  extern __shared__ unsigned long long smem_u64[];
  const int cls = blockIdx.x;
  const int t = threadIdx.x;
  const int n = K + 1;
  long long clk[3] = {0, 0, 0};  // the stages' sections (match_stage)
  long long t_walk = 0, c_start = 0, c0 = 0;
  int n_stages = 0;
  if (PROF) c_start = c0 = clock64();

  vct_stage::Shared s;
  int* w = vct_stage::carve(s, smem_u64, K);
  int* s_lvl = w; w += n;
  int* s_tent = w; w += n;
  int* s_ckey = w; w += n;
  int* s_ikey = w; w += n;
  int* s_out_row = w; w += n;
  float* mat_c = (float*)w;  // [K][K+1] clamped cascade cost (shared-memory path)
  float* mat_i = mat_c + K * n;
  vct_jv::BlockMin bmin(s.red);

  const size_t off = (size_t)cls * K;
  const float* mc = gated + off * K;
  const float* mi = iou + off * K;
  int ld = K;
  if (use_smem) {
    if (use_smem == 2) {
      // K % 4 == 0 and 16-byte aligned matrices: four entries of one row per load
      const float4* g4 = (const float4*)mc;
      const float4* i4 = (const float4*)mi;
#pragma unroll 4
      for (int q = t; q < (K * K) >> 2; q += blockDim.x) {
        const float4 a = g4[q], b = i4[q];
        const int idx = q << 2, r = idx / K;
        float* dc = mat_c + r * n + (idx - r * K);
        float* di = mat_i + r * n + (idx - r * K);
        dc[0] = fminf(a.x, clamp_c); dc[1] = fminf(a.y, clamp_c); dc[2] = fminf(a.z, clamp_c); dc[3] = fminf(a.w, clamp_c);
        di[0] = fminf(b.x, clamp_i); di[1] = fminf(b.y, clamp_i); di[2] = fminf(b.z, clamp_i); di[3] = fminf(b.w, clamp_i);
      }
    } else {
      for (int idx = t; idx < K * K; idx += blockDim.x) {
        const int r = idx / K, col = idx - r * K;
        mat_c[r * n + col] = fminf(mc[idx], clamp_c);
        mat_i[r * n + col] = fminf(mi[idx], clamp_i);
      }
    }
    mc = mat_c;
    mi = mat_i;
    ld = n;
  }
  if (t < K) {
    s_lvl[t] = lvl[off + t];
    s_tent[t] = tent[off + t] != 0;
    s_ckey[t] = row_key[off + t];
    s_ikey[t] = iou_key[off + t];
    s.det_free[t] = det_valid[off + t] != 0;
    s.det_key[t] = det_order[off + t];
    s.track_col[t] = -1;
    s_out_row[t] = -1;
  }
  __syncthreads();
  long long t_load = 0;
  if (PROF) {
    const long long c1 = clock64();
    t_load = c1 - c0;
    c0 = c1;
  }

  // fminf is idempotent on the pre-clamped shared copies
  auto cost_c = [&](int tr, int de) { return fminf(mc[tr * ld + de], clamp_c); };
  auto cost_i = [&](int tr, int de) { return fminf(mi[tr * ld + de], clamp_i); };

  // matching cascade over occupied age levels, ascending
  int level = block_min_i32(t < K ? s_lvl[t] : IMAX, bmin);
  while (level != IMAX) {
    const bool is_det = t < K && s.det_free[t];
    const int nc = __syncthreads_count(is_det);
    if (nc == 0) break;
    const bool is_row = t < K && s_lvl[t] == level;
    const int nr = __syncthreads_count(is_row);  // > 0: the level is occupied
    if (PROF) {
      const long long c1 = clock64();
      t_walk += c1 - c0;
      ++n_stages;
    }
    vct_stage::match_stage<PROF>(s, K, is_row, is_det, nr, nc, cost_c, thr_c, s_ckey, 1 + level,
                                 s_out_row, bmin, clk);
    if (PROF) c0 = clock64();
    level = block_min_i32(t < K && s_lvl[t] > level ? s_lvl[t] : IMAX, bmin);
  }

  // IoU stage: tentative tracks + confirmed tracks missed only this frame
  // that the cascade left unmatched
  {
    const bool is_det = t < K && s.det_free[t];
    const bool is_row = t < K && (s_tent[t] || (s_lvl[t] == 0 && s.track_col[t] < 0));
    const int nc = __syncthreads_count(is_det);
    const int nr = __syncthreads_count(is_row);
    if (PROF) {
      const long long c1 = clock64();
      t_walk += c1 - c0;
    }
    if (nr > 0 && nc > 0) {
      ++n_stages;
      vct_stage::match_stage<PROF>(s, K, is_row, is_det, nr, nc, cost_i, thr_i, s_ikey, 1 + max_age,
                                   s_out_row, bmin, clk);
    }
    if (PROF) c0 = clock64();
  }

  if (t < K) {
    out_row_g[off + t] = s_out_row[t];
    det_free_g[off + t] = (unsigned char)(s.det_free[t] != 0);
    det_key_g[off + t] = s.det_key[t];
    track_col_g[off + t] = s.track_col[t];
  }
  if (PROF && t == 0) {
    const long long c1 = clock64();
    long long* o = prof + (size_t)cls * PROF_WORDS;
    o[0] = t_load;
    o[1] = t_walk;
    o[2] = clk[0];
    o[3] = clk[1];
    o[4] = clk[2];
    o[5] = c1 - c0;
    o[6] = c1 - c_start;
    o[7] = n_stages;
  }
}

template <bool PROF>
cudaError_t raise_smem_limit() {
  return cudaFuncSetAttribute(cascade_kernel<PROF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(SMEM_MATS_LIMIT));
}

}  // namespace

// Once per device, before the first launch there and outside any stream capture:
// let a launch take more than 48 KB of dynamic shared memory (K >= 73).
extern "C" int vct_cascade_prepare() {
  cudaError_t e = raise_smem_limit<false>();
  if (e == cudaSuccess) e = raise_smem_limit<true>();
  return (int)e;
}

extern "C" int vct_cascade_prof_words() { return PROF_WORDS; }

// The most threads a block of the kernel can have on this device (its
// registers decide): a launch takes K + 1 threads rounded up to a warp.
extern "C" int vct_cascade_max_threads() {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, cascade_kernel<false>) != cudaSuccess) return -1;
  return a.maxThreadsPerBlock;
}

// tent, det_valid and det_free are bool bytes; every other vector is int32.
// prof: null, or [C, vct_cascade_prof_words()] int64 of clock64 ticks (the
// instrumented variant of the kernel runs then).
extern "C" int vct_cascade_match(const void* gated, const void* iou, const void* lvl,
                                 const void* tent, const void* row_key, const void* iou_key,
                                 const void* det_valid, const void* det_order, int C, int K,
                                 float thr_c, float thr_i, float clamp_c, float clamp_i,
                                 int max_age, void* out_row, void* det_free, void* det_key,
                                 void* track_col, void* prof, void* stream) {
  if (C <= 0 || K <= 0) return 0;
  if (K > vct_stage::MAX_K) return (int)cudaErrorInvalidValue;
  int use_smem = base_bytes(K) + mats_bytes(K) <= SMEM_MATS_LIMIT;
  if (use_smem && K % 4 == 0 && (((uintptr_t)gated | (uintptr_t)iou) & 15) == 0) use_smem = 2;  // float4 loads
  const size_t smem = base_bytes(K) + (use_smem ? mats_bytes(K) : 0);
  const int threads = ((K + 1 + 31) / 32) * 32;
  auto kernel = prof ? cascade_kernel<true> : cascade_kernel<false>;
  kernel<<<C, threads, smem, (cudaStream_t)stream>>>(
      (const float*)gated, (const float*)iou, (const int*)lvl, (const unsigned char*)tent,
      (const int*)row_key, (const int*)iou_key, (const unsigned char*)det_valid, (const int*)det_order,
      K, thr_c, thr_i, clamp_c, clamp_i, max_age, use_smem,
      (int*)out_row, (unsigned char*)det_free, (int*)det_key, (int*)track_col, (long long*)prof);
  return (int)cudaGetLastError();
}
