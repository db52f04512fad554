// bloomRF batched range probe for Hopper.
//
// Replaces the Pallas TPU kernel
// repro/kernels/rangeprobe.py::range_probe_resident (body _range_kernel),
// which pins the filter in VMEM and traces the engine's plan -> one (tile, A)
// gather -> combine over a tile of queries.
//
// Here one thread answers one query: it runs ProbeEngine.plan_range and
// combine_range (repro/core/engine.py) in its registers
// (bloomrf::range_one, shared with the stacked and store-scan kernels).
// Bound: scattered 4-byte reads, at most 4 words x replicas per layer
// (W = 64 words take two lanes), read straight from device memory through
// L2; range_one skips dead paths' words and stops at the verdict (the
// paper's early stop).
// Bounds are read once as int64 carriers (16 bytes a query), coalesced.
//
// Exact-bitmap layouts are rejected by the wrapper, as by the TPU kernel:
// their middle-of-range scan stays on the plain engine path.
#include "bloomrf.cuh"

namespace {

__global__ void range_probe_kernel(const int64_t* __restrict__ lo,
                                   const int64_t* __restrict__ hi, int64_t n,
                                   const uint32_t* __restrict__ state,
                                   const uint32_t* __restrict__ gdesc,
                                   int desc_len, bool* __restrict__ out) {
  extern __shared__ uint32_t sdesc[];
  const bloomrf::Desc D = bloomrf::load_desc(gdesc, sdesc, desc_len);
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  out[t] = bloomrf::range_one(state, D, static_cast<uint32_t>(lo[t]),
                              static_cast<uint32_t>(hi[t]));
}

}  // namespace

extern "C" int bloomrf_range_probe(const int64_t* lo, const int64_t* hi,
                                   int64_t n, const uint32_t* state,
                                   const uint32_t* desc, int desc_len,
                                   bool* out, void* stream) {
  if (n <= 0) return 0;
  range_probe_kernel<<<bloomrf::grid_for(n), bloomrf::kThreads,
                       desc_len * sizeof(uint32_t),
                       static_cast<cudaStream_t>(stream)>>>(
      lo, hi, n, state, desc, desc_len, out);
  return static_cast<int>(cudaGetLastError());
}
