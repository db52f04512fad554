// An empty kernel, launched with another kernel's grid, block, dynamic
// shared memory and, where that kernel takes one, its descriptor parameter:
// the latency floor of that launch.  The time of a kernel cannot fall below
// the time the card takes to launch, schedule and retire its blocks, which
// for a small batch is far above the time its bytes take.  chip_smoke.py
// times it exactly as it times the kernel (replayed from a CUDA graph) and
// reports the larger of it and the byte bound.  It computes nothing of
// bloomRF and replaces no TPU kernel.
#include "bloomrf.cuh"

namespace {

__global__ void empty_kernel() {}

__global__ void empty_param_kernel(const __grid_constant__ bloomrf::DescParam) {}

}  // namespace

// smem: at most the 48 KB a launch may ask for without an opt-in; param:
// nonzero to pass a bloomrf::DescParam (kParamDescWords words) as the
// kernels with a descriptor parameter do
extern "C" int bloomrf_empty(int blocks_x, int blocks_y, int threads,
                             int smem, int param, void* stream) {
  const dim3 grid(static_cast<unsigned>(blocks_x),
                  static_cast<unsigned>(blocks_y));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (param) {
    bloomrf::DescParam p{};
    empty_param_kernel<<<grid, threads, static_cast<size_t>(smem), s>>>(p);
  } else {
    empty_kernel<<<grid, threads, static_cast<size_t>(smem), s>>>();
  }
  return static_cast<int>(cudaGetLastError());
}
