// bloomRF store-scan pruning plane for Hopper: fence compare, stacked range
// probe and quarantine OR in one kernel per scan batch.
//
// Replaces the Pallas TPU kernel repro/kernels/store_scan.py::store_scan_probe
// (body _store_scan_kernel).  The TPU kernel pads every run to one uniform
// (R, rowpad) stack, because a BlockSpec needs uniform rows, and picks each
// run block's combine code through a scalar-prefetched block-type table and
// lax.switch.  Here the rows stay where they are in one flat lane vector
// (row r starts at lane base[r]), and each row points at its own layout
// descriptor, so a run stack of mixed capacity classes takes one launch and
// no padded copy.
//
// Grid: (query tiles x rows).  All threads of a block share one row, so they
// share one descriptor in shared memory, and a warp never diverges on a
// layer count or a delta.  A thread answers one (query, row) cell:
//   fence = hi >= kmin[r] && lo <= kmax[r]
//   touch = fence && (quarantined[r] || range_one(row r, lo, hi))
// The fence is tested first: a fenced-off or quarantined cell reads no
// filter word.  Padding rows carry the empty fence (2^32 - 1, 0).
//
// Bound: scattered 4-byte reads of the touched rows' filter words, through
// L2, plus the bounds (two int64 carriers a query) and the two bool[B, R]
// outputs.  Bounds must already lie in the d-bit domain (the store clamps
// them on the host, as the reference does).
#include "bloomrf.cuh"

namespace {

__global__ void store_scan_kernel(const int64_t* __restrict__ lo,
                                  const int64_t* __restrict__ hi, int64_t n,
                                  const uint32_t* __restrict__ state,
                                  const uint32_t* __restrict__ gdesc,
                                  const int64_t* __restrict__ rowtab,
                                  const int64_t* __restrict__ kmin,
                                  const int64_t* __restrict__ kmax,
                                  const bool* __restrict__ quar, int R,
                                  bool* __restrict__ fence_out,
                                  bool* __restrict__ touch_out) {
  extern __shared__ uint32_t sdesc[];
  const int r = blockIdx.y;
  const uint32_t* g = gdesc + rowtab[2 * r];
  const bloomrf::Desc D =
      bloomrf::load_desc(g, sdesc, static_cast<int>(g[bloomrf::H_LEN]));
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int64_t l = lo[t], h = hi[t];
  const bool fence = h >= kmin[r] && l <= kmax[r];
  bool touch = false;
  if (fence) {
    touch = (quar != nullptr && quar[r]) ||
            bloomrf::range_one(state + rowtab[2 * r + 1], D,
                               static_cast<uint32_t>(l),
                               static_cast<uint32_t>(h));
  }
  fence_out[t * R + r] = fence;
  touch_out[t * R + r] = touch;
}

}  // namespace

// rowtab: int64[R, 2] = (word offset of the row's descriptor in desc, base
// lane of the row in state); quar may be null (no row quarantined).
extern "C" int bloomrf_store_scan(const int64_t* lo, const int64_t* hi,
                                  int64_t n, const uint32_t* state,
                                  const uint32_t* desc, int max_desc_len,
                                  const int64_t* rowtab, const int64_t* kmin,
                                  const int64_t* kmax, const bool* quar, int R,
                                  bool* fence, bool* touch, void* stream) {
  if (n <= 0 || R <= 0) return 0;
  const dim3 grid(bloomrf::grid_for(n), static_cast<unsigned>(R));
  store_scan_kernel<<<grid, bloomrf::kThreads,
                      max_desc_len * sizeof(uint32_t),
                      static_cast<cudaStream_t>(stream)>>>(
      lo, hi, n, state, desc, rowtab, kmin, kmax, quar, R, fence, touch);
  return static_cast<int>(cudaGetLastError());
}
