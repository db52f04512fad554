// bloomRF bulk insert (filter build) for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/insert.py::insert_resident
// (body _insert_kernel).  That kernel's read-modify-write OR is safe only
// because TPU grid steps run in order on one core.  Hopper blocks run in any
// order, so each bit is set with atomicOr on its lane; OR does not depend on
// order, so the state equals the reference insert bit for bit.
//
// Bound: scattered memory traffic.  One thread per key computes its
// P = sum(replicas) (+1 exact) positions in registers and issues P 4-byte
// atomics on random lanes; the filter (a few MiB for a per-SST filter) stays
// in the 50 MB L2, so the atomics resolve in L2 rather than device memory.
// Keys are read once as the int64 carrier (8 bytes a key), coalesced.
#include "bloomrf.cuh"

namespace {

__global__ void insert_kernel(const int64_t* __restrict__ keys, int64_t n,
                              uint32_t* __restrict__ state,
                              const uint32_t* __restrict__ gdesc,
                              int desc_len) {
  extern __shared__ uint32_t sdesc[];
  const bloomrf::Desc D = bloomrf::load_desc(gdesc, sdesc, desc_len);
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const uint32_t x = static_cast<uint32_t>(keys[t]);
  bloomrf::for_each_position(D, x, [&](uint32_t pos) {
    atomicOr(state + (pos >> 5), 1u << (pos & 31u));
    return true;
  });
}

}  // namespace

extern "C" int bloomrf_insert(const int64_t* keys, int64_t n, uint32_t* state,
                              const uint32_t* desc, int desc_len,
                              void* stream) {
  if (n <= 0) return 0;
  insert_kernel<<<bloomrf::grid_for(n), bloomrf::kThreads,
                  desc_len * sizeof(uint32_t),
                  static_cast<cudaStream_t>(stream)>>>(keys, n, state, desc,
                                                       desc_len);
  return static_cast<int>(cudaGetLastError());
}
