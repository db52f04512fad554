// An empty kernel, launched with another kernel's grid, block and dynamic
// shared memory: the latency floor of that launch.  The time of a kernel
// cannot fall below the time the card takes to launch, schedule and retire
// its blocks, which for a small batch is far above the time its bytes take.
// chip_smoke.py times it exactly as it times the kernel (replayed from a
// CUDA graph) and reports the larger of it and the byte bound.  It computes
// nothing of bloomRF and replaces no TPU kernel.
#include "bloomrf.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

// smem: at most the 48 KB a launch may ask for without an opt-in
extern "C" int bloomrf_empty(int blocks_x, int blocks_y, int threads,
                             int smem, void* stream) {
  empty_kernel<<<dim3(static_cast<unsigned>(blocks_x),
                      static_cast<unsigned>(blocks_y)),
                 threads, static_cast<size_t>(smem),
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
