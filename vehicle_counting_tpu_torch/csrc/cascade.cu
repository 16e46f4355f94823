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
// K <= 256 lanes and a dual update), so the block's barriers and the
// reduction depth set the time, not bytes or FLOPs. The design keeps the
// clamped [K, K] cost matrices of both stages in shared memory (row stride
// K + 1 so transposed reads are bank-conflict free; matrices too large for
// shared memory are read from global memory instead), keeps one column per
// thread in registers, and does the tie-broken argmin as ONE 64-bit
// warp-shuffle min over (ordered f32 value, order key, lane). That
// Dijkstra-and-augment loop is jv.cuh's insert_rows, shared with the
// batched assignment kernel (assignment.cu).
//
// Same masked, key-ordered form as the Pallas kernel: no compaction; ties
// go to the first minimum in the reference's column order (minimum order
// key, keys unique among live lanes); rows are inserted in ascending row
// key; scipy's transpose rule inserts the smaller side. The arithmetic is
// f32 subtraction and comparison only, so the result is bitwise-equal to
// the plain PyTorch version (vehicle_counting_tpu_torch/ops/cascade.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "jv.cuh"

namespace {

constexpr int IMAX = 2147483647;
constexpr int LANE_BITS = 9;  // lanes 0..K (K <= 256) and the block's spare lanes

struct Shared {
  unsigned long long* red;  // [32] warp partials
  float* u;                 // [K+1] row duals (inserted side)
  int* p;                   // [K+1] column -> inserted element (-1 free), K = root
  int* way;                 // [K+1]
  int* ins_orig;            // [K+1] insertion order
  int* lvl;
  int* tent;
  int* crank;
  int* irank;
  int* det_free;
  int* det_key;
  int* out_row;
  int* matched;
  int* rows;
  int* ins_key;
  int* ins_part;
  int* track_of_det;
  int* acc_det;
  int* rej_track;
  float* mat_c;             // [K][K+1] clamped cascade cost (shared-memory path)
  float* mat_i;             // [K][K+1] clamped IoU cost
};

constexpr int kIntArrays = 18;  // u .. rej_track, (K+1) words each

__device__ __forceinline__ int block_min_i32(int x, unsigned long long* red) {
  // non-negative ints only (levels and IMAX)
  return (int)vct_jv::block_min_u64((unsigned long long)(unsigned int)x, red);
}

__device__ __forceinline__ float cost_at(const float* m, int ld, float clampv, int tr, int de) {
  return fminf(m[tr * ld + de], clampv);  // idempotent on pre-clamped shared copies
}

// One min_cost_matching stage over the rows in s.rows and the free
// detections in s.det_free. rowrank: stable rank of the stage's row key.
__device__ void stage(Shared& s, int K, const float* m, int ld, float clampv, float thr,
                      const int* rowrank, int base) {
  const int t = threadIdx.x;
  const int nr = __syncthreads_count(t < K && s.rows[t]);
  const int nc = __syncthreads_count(t < K && s.det_free[t]);
  if (nr == 0 || nc == 0) return;
  const bool flip = nr > nc;  // scipy inserts the smaller side
  const int n_ins = nr < nc ? nr : nc;

  // inserted side: tracks (normal) or free detections (flipped)
  if (t < K) {
    s.ins_part[t] = flip ? s.det_free[t] : s.rows[t];
    s.ins_key[t] = flip ? s.det_key[t] : rowrank[t];
  }
  // scanned side, one column per thread
  const bool live = t < K && (flip ? s.rows[t] : s.det_free[t]);
  const int skey = t < K ? (flip ? rowrank[t] : s.det_key[t]) : 0;
  if (t <= K) {
    s.u[t] = 0.0f;
    s.p[t] = -1;
  }
  __syncthreads();
  if (t < K && s.ins_part[t]) {
    const int kt = s.ins_key[t];
    int r = 0;
    for (int j = 0; j < K; ++j)
      if (s.ins_part[j]) r += (s.ins_key[j] < kt) || (s.ins_key[j] == kt && j < t);
    s.ins_orig[r] = t;
  }
  __syncthreads();
  vct_jv::insert_rows<LANE_BITS>(
      n_ins, K, s.ins_orig, live, skey,
      [&](int i0) { return flip ? cost_at(m, ld, clampv, t, i0) : cost_at(m, ld, clampv, i0, t); },
      s.u, s.p, s.way, s.red);

  // accept / reject the stage's pairs
  if (t < K) {
    s.track_of_det[t] = -1;
    s.acc_det[t] = 0;
    s.rej_track[t] = 0;
  }
  __syncthreads();
  if (t < K && s.p[t] >= 0) {
    const int tr = flip ? t : s.p[t];
    const int de = flip ? s.p[t] : t;
    const int acc = cost_at(m, ld, clampv, tr, de) <= thr;
    s.track_of_det[de] = tr;
    s.acc_det[de] = acc;
    if (!acc) s.rej_track[tr] = 1;
  }
  __syncthreads();
  if (t < K) {
    const int tr = s.track_of_det[t];
    if (tr >= 0) {
      if (s.acc_det[t]) {
        s.out_row[t] = tr;
        s.det_free[t] = 0;
        s.matched[tr] = 1;
      } else {
        // demote behind every live key, in ascending row order of rejects
        const int kt = rowrank[tr];
        int r = 0;
        for (int j = 0; j < K; ++j) r += s.rej_track[j] && rowrank[j] < kt;
        s.det_key[t] = base * K + r;
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ int stable_rank(const int* keys, int K, int t) {
  const int kt = keys[t];
  int r = 0;
  for (int j = 0; j < K; ++j) r += (keys[j] < kt) || (keys[j] == kt && j < t);
  return r;
}

__global__ void cascade_kernel(const float* __restrict__ gated, const float* __restrict__ iou,
                               const int* __restrict__ lvl, const int* __restrict__ tent,
                               const int* __restrict__ row_key, const int* __restrict__ iou_key,
                               const int* __restrict__ det_valid, const int* __restrict__ det_order,
                               int K, float thr_c, float thr_i, float clamp_c, float clamp_i,
                               int max_age, int use_smem,
                               int* __restrict__ out_row, int* __restrict__ det_free_out,
                               int* __restrict__ det_key_out) {
  extern __shared__ unsigned long long smem_u64[];
  const int cls = blockIdx.x;
  const int t = threadIdx.x;
  const int n = K + 1;

  Shared s;
  s.red = smem_u64;
  int* w = (int*)(smem_u64 + 32);
  s.u = (float*)w; w += n;
  s.p = w; w += n;
  s.way = w; w += n;
  s.ins_orig = w; w += n;
  s.lvl = w; w += n;
  s.tent = w; w += n;
  s.crank = w; w += n;
  s.irank = w; w += n;
  s.det_free = w; w += n;
  s.det_key = w; w += n;
  s.out_row = w; w += n;
  s.matched = w; w += n;
  s.rows = w; w += n;
  s.ins_key = w; w += n;
  s.ins_part = w; w += n;
  s.track_of_det = w; w += n;
  s.acc_det = w; w += n;
  s.rej_track = w; w += n;
  s.mat_c = (float*)w;
  s.mat_i = s.mat_c + K * n;

  const size_t off = (size_t)cls * K;
  const float* gc = gated + off * K;
  const float* ic = iou + off * K;
  const float* mc = gc;
  const float* mi = ic;
  int ld = K;
  if (use_smem) {
    for (int idx = t; idx < K * K; idx += blockDim.x) {
      const int r = idx / K, col = idx - (idx / K) * K;
      s.mat_c[r * n + col] = fminf(gc[idx], clamp_c);
      s.mat_i[r * n + col] = fminf(ic[idx], clamp_i);
    }
    mc = s.mat_c;
    mi = s.mat_i;
    ld = n;
  }
  if (t < K) {
    s.lvl[t] = lvl[off + t];
    s.tent[t] = tent[off + t];
    s.det_free[t] = det_valid[off + t] != 0;
    s.det_key[t] = det_order[off + t];
    s.out_row[t] = -1;
    s.matched[t] = 0;
    s.ins_key[t] = row_key[off + t];  // scratch for the ranks below
    s.ins_part[t] = iou_key[off + t];
  }
  __syncthreads();
  if (t < K) {
    s.crank[t] = stable_rank(s.ins_key, K, t);
    s.irank[t] = stable_rank(s.ins_part, K, t);
  }
  __syncthreads();

  // matching cascade over occupied age levels, ascending
  int level = block_min_i32(t < K ? s.lvl[t] : IMAX, s.red);
  while (level != IMAX) {
    if (__syncthreads_count(t < K && s.det_free[t]) == 0) break;
    if (t < K) s.rows[t] = s.lvl[t] == level;
    __syncthreads();
    stage(s, K, mc, ld, clamp_c, thr_c, s.crank, 1 + level);
    level = block_min_i32(t < K && s.lvl[t] > level ? s.lvl[t] : IMAX, s.red);
  }

  // IoU stage: tentative tracks + confirmed tracks missed only this frame
  // that the cascade left unmatched
  if (t < K) s.rows[t] = s.tent[t] || (s.lvl[t] == 0 && !s.matched[t]);
  __syncthreads();
  stage(s, K, mi, ld, clamp_i, thr_i, s.irank, 1 + max_age);

  if (t < K) {
    out_row[off + t] = s.out_row[t];
    det_free_out[off + t] = s.det_free[t];
    det_key_out[off + t] = s.det_key[t];
  }
}

}  // namespace

extern "C" int vct_cascade_match(const void* gated, const void* iou, const void* lvl,
                                 const void* tent, const void* row_key, const void* iou_key,
                                 const void* det_valid, const void* det_order, int C, int K,
                                 float thr_c, float thr_i, float clamp_c, float clamp_i,
                                 int max_age, void* out_row, void* det_free, void* det_key,
                                 void* stream) {
  if (C <= 0 || K <= 0) return 0;
  const size_t base = 32 * sizeof(unsigned long long) + (size_t)kIntArrays * (K + 1) * sizeof(int);
  const size_t mats = 2 * (size_t)K * (K + 1) * sizeof(float);
  const int use_smem = base + mats <= 200 * 1024;
  const size_t smem = base + (use_smem ? mats : 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(cascade_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = ((K + 1 + 31) / 32) * 32;
  cascade_kernel<<<C, threads, smem, (cudaStream_t)stream>>>(
      (const float*)gated, (const float*)iou, (const int*)lvl, (const int*)tent,
      (const int*)row_key, (const int*)iou_key, (const int*)det_valid, (const int*)det_order,
      K, thr_c, thr_i, clamp_c, clamp_i, max_age, use_smem,
      (int*)out_row, (int*)det_free, (int*)det_key);
  return (int)cudaGetLastError();
}
