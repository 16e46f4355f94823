// Launch-cost probe: o = x + 1.0 on a small f32 block.
//
// Replaces the TPU kernel benchmarks/micro/noop_launch.py (noop_kernel /
// noop): one [64, 128] f32 block held whole in VMEM, o = x + 1.0, called
// 256 times in sequence to read the fixed cost of one kernel call. Here a
// grid-stride loop adds 1.0 to each element; 8192 elements take 32 blocks
// of 256 threads.
//
// Bound on the H100: neither bytes nor operations. 32 KB in and 32 KB out
// are ~20 ns of HBM traffic, so the time of a call is the launch itself:
// the host's path through ctypes and the C entry below to <<<>>>, and the
// card's own launch latency. That is what the probe is for: it takes the
// route every kernel of this package takes, so its time is the floor under
// each of them. With n = 0 the one block finds no element and exits: the
// bare launch.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 1024;

__global__ void noop_add1_kernel(const float* __restrict__ x, float* __restrict__ o, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    o[i] = x[i] + 1.0f;
  }
}

}  // namespace

extern "C" int vct_noop_add1(const float* x, float* o, int n, void* stream) {
  int blocks = (n + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  noop_add1_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(x, o, n);
  return (int)cudaGetLastError();
}
