// bloomRF batched point probe for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/probe.py::point_probe_resident
// (body _resident_kernel), which pins the filter in VMEM and runs the
// engine's point plan -> gather -> AND over a tile of keys.
//
// Bound: scattered 4-byte reads.  One thread per key computes its positions
// in registers and reads one lane per position straight from device memory
// through L2 (the filter of a per-SST deployment fits the 50 MB L2, so no
// staging in shared memory); it stops at the first clear bit, so absent keys
// mostly cost one read.  Keys are read once as the int64 carrier (8 bytes a
// key), coalesced; verdicts are written as one byte each.
//
// The same kernel replaces repro/kernels/probe.py::point_probe_partitioned
// (B7) for filters above the resident budget: a state far larger than L2
// costs each probe a device-memory round trip, but the design stays one
// thread per key reading up to its first clear bit (measured faster than
// issuing every position's load at once), with no bucketing by block.
#include "bloomrf.cuh"

namespace {

__global__ void point_probe_kernel(const int64_t* __restrict__ keys, int64_t n,
                                   const uint32_t* __restrict__ state,
                                   const uint32_t* __restrict__ gdesc,
                                   int desc_len, bool* __restrict__ out) {
  extern __shared__ uint32_t sdesc[];
  const bloomrf::Desc D = bloomrf::load_desc(gdesc, sdesc, desc_len);
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  out[t] = bloomrf::point_one(state, D, static_cast<uint32_t>(keys[t]));
}

}  // namespace

extern "C" int bloomrf_point_probe(const int64_t* keys, int64_t n,
                                   const uint32_t* state, const uint32_t* desc,
                                   int desc_len, bool* out, void* stream) {
  if (n <= 0) return 0;
  point_probe_kernel<<<bloomrf::grid_for(n), bloomrf::kThreads,
                       desc_len * sizeof(uint32_t),
                       static_cast<cudaStream_t>(stream)>>>(
      keys, n, state, desc, desc_len, out);
  return static_cast<int>(cudaGetLastError());
}
