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
// A scan batch is small (a store scans 512 bounds against about ten runs
// whose filters sit in the 50 MB L2), so the kernel is bound by latency:
// the launch, then each cell's chain of dependent loads and instructions,
// not bytes.  The design shortens that chain:
//
// * one wave before the first filter word: each block stages the records
//   of the rows its cells reach (descriptor offset, base lane, fences,
//   quarantine flag) and the whole stack descriptor (every distinct layout)
//   into shared memory, while each thread loads its cell's bounds; then
//   one barrier;
// * kLanes threads (of one warp) per (scan, row) cell: lane s reads the
//   candidate words of layers k-1-s, k-1-s-kLanes, ... all at once and
//   computes their tests (rangeplan::layer_bits); the group exchanges the
//   test bits by warp shuffles and each lane runs the path flags over them
//   (rangeplan::scan_layer).  The capacity-class ladder's layouts have
//   k = 2..4 layers, so such a cell takes one round trip and a quarter of
//   the work per thread; a tuned layout (tune/solver.py: Δ = 1..7 ladders,
//   a replicated top layer) can have up to d layers and takes
//   ceil(k / kLanes) rounds, its lanes on layers k-1-s, k-1-s-kLanes, ...;
// * cells in row-major order (cell = r * B + t), so the cells of a warp
//   share a row and a layout and never diverge on a layer count or a Δ;
// * word addresses by each layer's exact reciprocal of its word count.
//
// A cell's answer:
//   fence = hi >= kmin[r] && lo <= kmax[r]
//   touch = fence && (quarantined[r] || range verdict of row r on [lo, hi])
// The fence is tested first: a fenced-off or quarantined cell reads no
// filter word.  Padding rows carry the empty fence (2^32 - 1, 0).  Bounds
// must already lie in the d-bit domain (the store clamps them on the host,
// as the reference does).
#include "rangeplan.cuh"

namespace {

// Shared memory of a block, per staged row slot (blockDim.x of them), then
// the stack descriptor: int64 base[], kmin[], kmax[]; uint32 doff[], quar[];
// uint32 desc[desc_words].
inline size_t scan_smem(int threads, int desc_words) {
  return static_cast<size_t>(threads) * 32u +
         static_cast<size_t>(desc_words) * 4u;
}

// threads per cell (kernels/store_scan.py::SCAN_LANES); every lane of a
// warp runs the same number of waves and shuffles
constexpr unsigned kLanes = 4;

__global__ void __launch_bounds__(512)
    store_scan_kernel(const int64_t* __restrict__ lo,
                      const int64_t* __restrict__ hi, unsigned n,
                      const uint32_t* __restrict__ state,
                      const uint32_t* __restrict__ gdesc, int desc_words,
                      const int64_t* __restrict__ rowtab,
                      const int64_t* __restrict__ kmin,
                      const int64_t* __restrict__ kmax,
                      const bool* __restrict__ quar, unsigned R,
                      bool* __restrict__ fence_out,
                      bool* __restrict__ touch_out) {
  extern __shared__ int64_t smem[];
  const unsigned T = blockDim.x;
  int64_t* s_base = smem;
  int64_t* s_kmin = smem + T;
  int64_t* s_kmax = smem + 2 * T;
  uint32_t* s_doff = reinterpret_cast<uint32_t*>(smem + 3 * T);
  uint32_t* s_quar = s_doff + T;
  uint32_t* s_desc = s_quar + T;

  const unsigned cells = n * R;  // < 2^31: the wrapper checks
  const unsigned per_block = T / kLanes;
  const unsigned c0 = blockIdx.x * per_block;
  const unsigned j = threadIdx.x;
  const unsigned sub = j % kLanes;
  const unsigned c = c0 + j / kLanes;
  const unsigned t = c % n, r = c / n, r0 = c0 / n;
  const unsigned slot = r - r0;
  const unsigned nslots = min((c0 + per_block - 1u) / n, R - 1u) - r0 + 1u;
  const bool valid = c < cells;

  // one wave: the cell's bounds, the block's row records, the descriptor
  int64_t l = 0, h = 0;
  if (valid) {
    l = lo[t];
    h = hi[t];
  }
  if (j < nslots) {
    const unsigned srow = r0 + j;
    s_doff[j] = static_cast<uint32_t>(rowtab[2 * srow]);
    s_base[j] = rowtab[2 * srow + 1];
    s_kmin[j] = kmin[srow];
    s_kmax[j] = kmax[srow];
    s_quar[j] = quar != nullptr && quar[srow];
  }
  for (int w = j; w < desc_words; w += T) s_desc[w] = gdesc[w];
  __syncthreads();

  const bool fence = valid && h >= s_kmin[slot] && l <= s_kmax[slot];
  bool touch = fence && s_quar[slot] != 0u;
  const bloomrf::Desc D{s_desc + (valid ? s_doff[slot] : 0u)};
  const uint32_t* row = state + (valid ? s_base[slot] : 0);
  uint32_t L = static_cast<uint32_t>(l), H = static_cast<uint32_t>(h);
  rangeplan::Paths p;
  bool live = fence && !touch;
  if (live && rangeplan::start(D, L, H, p) >= 0) {
    touch = true;
    live = false;
  }
  const int k = live ? D.k() : 0;
  const int waves = __reduce_max_sync(
      0xFFFFFFFFu, static_cast<unsigned>((k + kLanes - 1) / kLanes));
  const bool pairs = (reinterpret_cast<uintptr_t>(row) & 7u) == 0u;
  const unsigned base = (threadIdx.x & 31u) & ~(kLanes - 1u);
  for (int wave = 0; wave < waves; ++wave) {
    const int top = k - 1 - static_cast<int>(kLanes) * wave;
    const int i = top - static_cast<int>(sub);
    unsigned bits = 0u;
    if (live && i >= 0)
      bits = rangeplan::layer_bits(row, pairs, D, i, L, H);
    unsigned got[kLanes];
#pragma unroll
    for (unsigned s = 0; s < kLanes; ++s)
      got[s] = __shfl_sync(0xFFFFFFFFu, bits, base + s);
#pragma unroll
    for (unsigned s = 0; s < kLanes; ++s) {
      if (!live || top - static_cast<int>(s) < 0) break;
      const int v = rangeplan::scan_layer(got[s], top - static_cast<int>(s), p);
      if (v >= 0) {
        touch = v != 0;
        live = false;
      }
    }
  }
  if (valid && sub == 0) {
    fence_out[t * R + r] = fence;
    touch_out[t * R + r] = touch;
  }
}

}  // namespace

// rowtab: int64[R, 2] = (word offset of the row's descriptor in desc, base
// lane of the row in state); desc: the stack descriptor, desc_words long;
// quar may be null (no row quarantined); threads per block: a multiple of
// 32, at most 512.  n * R < 2^31.
extern "C" int bloomrf_store_scan(const int64_t* lo, const int64_t* hi,
                                  int64_t n, const uint32_t* state,
                                  const uint32_t* desc, int desc_words,
                                  const int64_t* rowtab, const int64_t* kmin,
                                  const int64_t* kmax, const bool* quar, int R,
                                  bool* fence, bool* touch, int threads,
                                  void* stream) {
  if (n <= 0 || R <= 0) return 0;
  const size_t smem = scan_smem(threads, desc_words);
  if (smem > 48u * 1024u) {
    const cudaError_t e = cudaFuncSetAttribute(
        store_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t cells = n * R;
  const int64_t per_block = threads / kLanes;
  const unsigned blocks =
      static_cast<unsigned>((cells + per_block - 1) / per_block);
  store_scan_kernel<<<blocks, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      lo, hi, static_cast<unsigned>(n), state, desc, desc_words, rowtab,
      kmin, kmax, quar, static_cast<unsigned>(R), fence, touch);
  return static_cast<int>(cudaGetLastError());
}
