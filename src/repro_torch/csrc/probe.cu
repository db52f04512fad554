// bloomRF batched point probe for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/probe.py::point_probe_resident
// (B2, body _resident_kernel), which pins the filter in VMEM and runs the
// engine's point plan -> gather -> AND over a tile of keys.
//
// The same kernel replaces repro/kernels/probe.py::point_probe_partitioned
// (B7) for filters above the resident budget, with no bucketing by block:
// on Hopper a probe reads one 32-byte sector through L2 whether the state
// sits in L2 or in device memory.
//
// Bound: the L2's rate for random sectors, and the chain in front of each
// read.  One thread per key computes its positions in registers and reads
// one lane per position straight from L2 or device memory (the filter of a
// per-SST deployment fits the 50 MB L2, so no staging in shared memory),
// stopping at the first clear bit, so absent keys mostly cost one read.
// Issuing every position's read at once was measured slower on both
// tiers: it reads a second sector for most absent keys, and the sectors,
// not the chain, set the time.  What the design takes off the chain: the
// layout descriptor is a __grid_constant__ launch parameter, read through
// the constant cache (no block stages it in shared memory behind a
// barrier), and word addresses use each layer's exact reciprocal of its
// word count (rangeplan::word_bitoff) instead of a division.  Keys are read
// once as the int64 carrier (8 bytes a key), coalesced; verdicts are
// written as one byte each.
#include "rangeplan.cuh"

namespace {

__global__ void __launch_bounds__(bloomrf::kThreads)
    point_probe_kernel(const int64_t* __restrict__ keys, int64_t n,
                       const uint32_t* __restrict__ state,
                       const __grid_constant__ bloomrf::DescParam p,
                       bool* __restrict__ out) {
  const bloomrf::Desc D{p.w};
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  out[t] = rangeplan::point_verdict(state, D,
                                    static_cast<uint32_t>(keys[t]));
}

}  // namespace

// desc: the descriptor parameter in host memory, kParamDescWords words
// (kernels/_build.py::param_descriptor), copied into the launch
extern "C" int bloomrf_point_probe(const int64_t* keys, int64_t n,
                                   const uint32_t* state, const uint32_t* desc,
                                   bool* out, void* stream) {
  if (n <= 0) return 0;
  bloomrf::DescParam p;
  if (!bloomrf::to_param(desc, p))
    return static_cast<int>(cudaErrorInvalidValue);
  point_probe_kernel<<<bloomrf::grid_for(n), bloomrf::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(keys, n, state, p,
                                                            out);
  return static_cast<int>(cudaGetLastError());
}
