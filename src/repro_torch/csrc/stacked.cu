// bloomRF stacked probes for Hopper: R filter rows of one layout, one launch.
//
// Replaces the Pallas TPU kernels
// repro/kernels/rangeprobe.py::range_probe_stacked_resident and
// repro/kernels/probe.py::point_probe_stacked_resident, which pin a
// uint32[R, total_u32] stack in VMEM and trace StackedProbe._range_all /
// _point_all (one gather for all rows) over a tile of queries.
//
// Grid: (query tiles x rows); row r starts at lane r * row_lanes, and every
// row shares the one descriptor in shared memory.  A thread answers one
// (query, row) cell with the device functions of the single-filter kernels
// (bloomrf::range_one of B3, bloomrf::point_one of B2, which stops at the
// first clear bit).  Bound: scattered 4-byte reads of the stack through L2,
// the queries (int64 carriers) and the bool[B, R] output.
#include "bloomrf.cuh"

namespace {

__global__ void range_stacked_kernel(const int64_t* __restrict__ lo,
                                     const int64_t* __restrict__ hi, int64_t n,
                                     const uint32_t* __restrict__ stack,
                                     int64_t row_lanes,
                                     const uint32_t* __restrict__ gdesc,
                                     int desc_len, int R,
                                     bool* __restrict__ out) {
  extern __shared__ uint32_t sdesc[];
  const bloomrf::Desc D = bloomrf::load_desc(gdesc, sdesc, desc_len);
  const int r = blockIdx.y;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  out[t * R + r] = bloomrf::range_one(stack + r * row_lanes, D,
                                      static_cast<uint32_t>(lo[t]),
                                      static_cast<uint32_t>(hi[t]));
}

__global__ void point_stacked_kernel(const int64_t* __restrict__ keys,
                                     int64_t n,
                                     const uint32_t* __restrict__ stack,
                                     int64_t row_lanes,
                                     const uint32_t* __restrict__ gdesc,
                                     int desc_len, int R,
                                     bool* __restrict__ out) {
  extern __shared__ uint32_t sdesc[];
  const bloomrf::Desc D = bloomrf::load_desc(gdesc, sdesc, desc_len);
  const int r = blockIdx.y;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  out[t * R + r] = bloomrf::point_one(stack + r * row_lanes, D,
                                      static_cast<uint32_t>(keys[t]));
}

dim3 stacked_grid(int64_t n, int R) {
  return dim3(bloomrf::grid_for(n), static_cast<unsigned>(R));
}

}  // namespace

extern "C" int bloomrf_range_stacked(const int64_t* lo, const int64_t* hi,
                                     int64_t n, const uint32_t* stack,
                                     int64_t row_lanes, int R,
                                     const uint32_t* desc, int desc_len,
                                     bool* out, void* stream) {
  if (n <= 0 || R <= 0) return 0;
  range_stacked_kernel<<<stacked_grid(n, R), bloomrf::kThreads,
                         desc_len * sizeof(uint32_t),
                         static_cast<cudaStream_t>(stream)>>>(
      lo, hi, n, stack, row_lanes, desc, desc_len, R, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bloomrf_point_stacked(const int64_t* keys, int64_t n,
                                     const uint32_t* stack, int64_t row_lanes,
                                     int R, const uint32_t* desc, int desc_len,
                                     bool* out, void* stream) {
  if (n <= 0 || R <= 0) return 0;
  point_stacked_kernel<<<stacked_grid(n, R), bloomrf::kThreads,
                         desc_len * sizeof(uint32_t),
                         static_cast<cudaStream_t>(stream)>>>(
      keys, n, stack, row_lanes, desc, desc_len, R, out);
  return static_cast<int>(cudaGetLastError());
}
