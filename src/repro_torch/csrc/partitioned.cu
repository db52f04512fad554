// bloomRF range probe for Hopper: one kernel for both tiers of the single
// filter, whether its state sits in the 50 MB L2 or in device memory.
//
// Replaces the Pallas TPU kernels
//   B3  repro/kernels/rangeprobe.py::range_probe_resident (body
//       _range_kernel: the filter pinned in VMEM, the engine's plan -> one
//       (tile, A) gather -> combine over a tile of queries), and
//   B8  repro/kernels/rangeprobe.py::range_probe_partitioned
//       (the engine's range plan, its B x A lanes bucketed by 64 KiB filter
//       block, body _gather_block_kernel, an XLA scatter back to (B, A),
//       then the engine's combine).
// Each wrapper launches this kernel and counts its own launches.
// Its point twin, B7 (repro/kernels/probe.py::point_probe_partitioned), is
// served by probe.cu's kernel.
// The TPU buckets probes so that each tile DMAs one filter block into VMEM.
// On Hopper a probe reads one 32-byte sector through L2, and staging a
// block would move far more than its probes read, so nothing is bucketed
// here: one thread takes one range, runs its plan in registers, reads its
// words straight from L2 or device memory and writes one byte.
//
// Bound: the distinct sectors that the verdicts need, read at random.  On
// the card the time follows the number of sectors read more than the
// number of round trips in a chain, on a state four times the L2 and on
// one inside it alike (prefetching the next layer's words, or issuing
// every layer's words in one wave, was measured slower on both), so the
// kernel reads as few as it can and keeps the loads of one layer in flight
// together: rangeplan::range_layers, whose word addresses use each layer's
// exact reciprocal of its word count.  Verdicts are those of
// ProbeEngine.plan_range + combine_range (repro/core/engine.py) in
// BloomRF._range_one's clip and select order: a word is skipped only where
// the reference masks it out.
// Hashed layouts only: the wrappers reject exact segments for ranges, as
// the TPU kernels do.
#include "rangeplan.cuh"

namespace {

__global__ void __launch_bounds__(bloomrf::kThreads)
    range_partitioned_kernel(const int64_t* __restrict__ lo,
                             const int64_t* __restrict__ hi, int64_t n,
                             const uint32_t* __restrict__ state,
                             const uint32_t* __restrict__ gdesc, int desc_len,
                             bool* __restrict__ out) {
  extern __shared__ uint32_t sdesc[];
  const bloomrf::Desc D = bloomrf::load_desc(gdesc, sdesc, desc_len);
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  out[t] = rangeplan::range_layers(state, D, static_cast<uint32_t>(lo[t]),
                                   static_cast<uint32_t>(hi[t]));
}

}  // namespace

extern "C" int bloomrf_range_partitioned(const int64_t* lo, const int64_t* hi,
                                         int64_t n, const uint32_t* state,
                                         const uint32_t* desc, int desc_len,
                                         bool* out, void* stream) {
  if (n <= 0) return 0;
  range_partitioned_kernel<<<bloomrf::grid_for(n), bloomrf::kThreads,
                             desc_len * sizeof(uint32_t),
                             static_cast<cudaStream_t>(stream)>>>(
      lo, hi, n, state, desc, desc_len, out);
  return static_cast<int>(cudaGetLastError());
}
