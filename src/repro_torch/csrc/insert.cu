// bloomRF bulk insert (filter build) for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/insert.py::insert_resident
// (body _insert_kernel).  That kernel's read-modify-write OR is safe only
// because TPU grid steps run in order on one core.  Hopper blocks run in any
// order, so each bit is set with an atomic OR on its lane; OR does not
// depend on order or grouping, so the state equals the reference insert bit
// for bit.
//
// Bound: the memory system's atomics, on all three traffic shapes.  A
// per-SST filter or a store build's filter (a few MiB) stays in the 50 MB
// L2, where the atomics resolve; an HBM-scale filter (tens to hundreds of
// MiB) pays a device-memory read and a dirty write-back for each 32-byte
// sector its keys touch.  A probe kernel issuing as many atomic ORs a key
// on uniformly spread lanes, with no layout, took the same time as this
// kernel on every shape, and one computing every position but writing none
// 25-40% of it (PERF.md, the insert kernel's findings).  Keys are read once
// as the int64 carrier (8 bytes a key), coalesced.
//
// The design: one thread a key; every atomic's result is unused, so it
// compiles to a fire-and-forget reduction and a thread never waits on one.
// The layout descriptor reaches every thread as a kernel parameter
// (__grid_constant__, read through the constant cache), so no block copies
// it into shared memory and waits at a barrier before its first key.
// Aggregating a warp's atomics on one word (__match_any_sync +
// __reduce_or_sync, always or gated by a ballot of equal neighbours) lost
// on every shape, sorted store builds included (plain atomics on a word
// that neighbouring keys share cost no more than on spread words), and so
// did four keys a thread: more loads in flight do not raise the atomics'
// rate.
#include "bloomrf.cuh"

namespace {

__global__ void __launch_bounds__(bloomrf::kThreads)
    insert_kernel(const int64_t* __restrict__ keys, int64_t n,
                  uint32_t* __restrict__ state,
                  const __grid_constant__ bloomrf::DescParam p) {
  const bloomrf::Desc D{p.w};
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= n) return;
  const uint32_t x = static_cast<uint32_t>(keys[t]);
  bloomrf::for_each_position(D, x, [&](uint32_t pos) {
    atomicOr(state + (pos >> 5), 1u << (pos & 31u));
    return true;
  });
}

}  // namespace

// desc: the descriptor parameter in host memory, kParamDescWords words
// (kernels/_build.py::param_descriptor), copied into the launch
extern "C" int bloomrf_insert(const int64_t* keys, int64_t n, uint32_t* state,
                              const uint32_t* desc, void* stream) {
  if (n <= 0) return 0;
  bloomrf::DescParam p;
  if (!bloomrf::to_param(desc, p))
    return static_cast<int>(cudaErrorInvalidValue);
  insert_kernel<<<bloomrf::grid_for(n), bloomrf::kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(keys, n, state, p);
  return static_cast<int>(cudaGetLastError());
}
