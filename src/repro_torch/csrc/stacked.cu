// bloomRF stacked probes for Hopper: R filter rows of one layout, one launch.
//
// Replaces the Pallas TPU kernels
// repro/kernels/rangeprobe.py::range_probe_stacked_resident (B5) and
// repro/kernels/probe.py::point_probe_stacked_resident (B6), which pin a
// uint32[R, total_u32] stack in VMEM and trace StackedProbe._range_all /
// _point_all (one gather for all rows) over a tile of queries.  Row r
// starts at lane r * row_lanes.
//
// B5, one thread per query.  The bounds are shared and the layout is one,
// so everything a range plan computes per layer (the paths' hit masks,
// which child words they can read, the covering bits' places, the word
// addresses) is the same for every row; only the words and the path flags
// differ.  Bound: instructions, then the chain of dependent loads.  A
// thread per (query, row) cell ran the whole plan once per row (0.050 ms
// on phase 6's 4 rows against 0.035 here; PERF.md, the stacked range
// kernel's findings).  Here a thread computes each layer's shared part once
// (plan_layer) and then, row by row, reads only the words that row's live
// paths need (rangeplan::layer_needs's choice, over word addresses from
// each layer's exact reciprocal), tests them against the shared masks and
// keeps the rows' path flags as bit masks.  Several rows' loads in flight
// at once, more threads a query, or a thread a cell were each measured
// slower: their registers cost more threads in flight, or they repeat the
// shared part.  The layout descriptor is a __grid_constant__ launch
// parameter; a query's R verdicts are adjacent bytes.
//
// B6, a thread per (key, row) cell: grid (key tiles x rows), so the blocks
// in flight at a time mostly read one row.  The rows share the layout and
// the seeds, so a key's positions are the same in every row; computing them
// once per key (a thread a key over all rows, its loads of one position in
// every live row issued together) was measured slower: the blocks in
// flight then read all rows, and fewer of a batch's repeated sectors stay
// in L1 (PERF.md, the stacked point kernel's findings).  The descriptor is
// a __grid_constant__ launch parameter and words are addressed by each
// layer's reciprocal (rangeplan::point_verdict, shared with probe.cu); a
// cell stops at its first clear bit.  Bound: the sectors of the stack that
// the verdicts read through L2, the keys (int64 carriers) and the bool[B, R]
// output; the launch floor is the cell grid's.
#include "rangeplan.cuh"

namespace {

using bloomrf::Desc;
using bloomrf::Word;

// One layer of a query's range plan, the part every row shares: which
// child words each path can read (as bits over the slots LA, LB, RA, RB,
// layer_needs's), the masks its hit test and covering bits apply to them
// (combine_layer's), and the slots' word addresses (replica 0).  Only the
// path flags (left and right alive) and the words differ between rows.
struct LayerPlan {
  uint32_t W;
  bool bottom, same, l_ne, r_ne, lp_ne_rp;
  unsigned need_l, need_r, need_cov;   // slot bits
  bool b_l, b_r;                       // covering bits in word B, not A
  Word m_la, m_lb, m_ra, m_rb;         // hit masks
  uint32_t bit_l, bit_r;               // covering bits' offsets in their word
  uint32_t off[4];                     // the slots' bit offsets, replica 0
};

__device__ __forceinline__ Word bit_of(uint32_t off) {
  return off < 32u ? Word{1u << off, 0u} : Word{0u, 1u << (off - 32u)};
}

// The level of layer i's parents (its level + Δ).
__device__ __forceinline__ uint32_t up(const Desc& D, int i) {
  const uint32_t* lay = D.layer(i);
  return lay[bloomrf::L_LEVEL] + lay[bloomrf::L_DELTA];
}

// The word key of slot j (LA, LB, RA, RB): a child word of L's or R's
// parent at level `lvl`.
__device__ __forceinline__ uint32_t slot_key(uint32_t L, uint32_t R,
                                             uint32_t lvl, int j) {
  return (bloomrf::shr(j < 2 ? L : R, lvl) << 1) |
         static_cast<uint32_t>(j & 1);
}

__device__ __forceinline__ LayerPlan plan_layer(const Desc& D, int i,
                                                uint32_t L, uint32_t R,
                                                bool split) {
  const uint32_t* lay = D.layer(i);
  const uint32_t li = lay[bloomrf::L_LEVEL];
  const uint32_t delta = lay[bloomrf::L_DELTA];
  LayerPlan q;
  q.W = lay[bloomrf::L_W];
  q.bottom = i == 0;
  const uint32_t edge = q.bottom ? 0u : 1u;
  const uint32_t Lp = bloomrf::shr(L, li), Rp = bloomrf::shr(R, li);
  const uint32_t Lpar = bloomrf::shr(L, li + delta);
  const uint32_t Rpar = bloomrf::shr(R, li + delta);
  q.same = Lpar == Rpar;
  q.lp_ne_rp = Lp != Rp;
  const uint32_t l_end = (Lpar << delta) | ((1u << delta) - 1u);
  const uint32_t l_qhi = split ? l_end : Rp - edge;
  q.l_ne = q.bottom || (split ? (Lp != l_end) : (Rp - Lp >= 2u));
  const uint32_t r_start = Rpar << delta;
  q.r_ne = q.bottom || (Rp != r_start);
  bloomrf::child_masks(delta, Lpar, Lp + edge, l_qhi, q.m_la, q.m_lb);
  bloomrf::child_masks(delta, Rpar, r_start, Rp - edge, q.m_ra, q.m_rb);
  const uint32_t cov = li + delta - 1u;
  q.b_l = ((L >> cov) & 1u) != 0u;
  q.b_r = ((R >> cov) & 1u) != 0u;
  q.need_l =
      (q.l_ne ? rangeplan::pair_halves(delta, Lpar, Lp + edge, l_qhi) : 0u) |
      (q.bottom ? 0u : (q.b_l ? 2u : 1u));
  q.need_r = q.r_ne ? rangeplan::pair_halves(delta, Rpar, r_start,
                                             Rp - edge) << 2
                    : 0u;
  q.need_cov = q.bottom ? 0u : (q.b_r ? 8u : 4u);
  q.bit_l = (L >> li) & (q.W - 1u);
  q.bit_r = (R >> li) & (q.W - 1u);
  unsigned any = q.need_l | q.need_r | q.need_cov;
  if (q.same) any = (any | (any >> 2)) & 3u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    q.off[j] = ((any >> j) & 1u)
                   ? rangeplan::word_bitoff(D, i, 0u,
                                            slot_key(L, R, li + delta, j))
                   : 0u;
  return q;
}

// A row's slots at this layer from its path flags (layer_needs).
__device__ __forceinline__ unsigned row_need(const LayerPlan& q, bool split,
                                             bool left, bool right) {
  unsigned need = (left ? q.need_l : 0u) | (right ? q.need_r : 0u) |
                  ((split ? right : (left && q.lp_ne_rp)) ? q.need_cov : 0u);
  return q.same ? (need | (need >> 2)) & 3u : need;
}

// Range verdicts of one query for nrows <= 32 rows, as a bit mask: per
// layer the shared part once (plan_layer), then each live row's needed
// words (replica 0 issued together, further replicas one load each), its
// hit test and its covering bits; the path flags of the rows are bit
// masks, and a row leaves at its verdict.
__device__ __forceinline__ unsigned range_rows(
    const uint32_t* __restrict__ stack, int64_t row_lanes, int nrows,
    const Desc& D, uint32_t L, uint32_t R, const rangeplan::Paths& start) {
  const unsigned all = nrows == 32 ? ~0u : (1u << nrows) - 1u;
  unsigned left = all, right = start.right_alive ? all : 0u, hit = 0u;
  bool split = start.split;
  for (int i = D.k() - 1; i >= 0 && (left | right); --i) {
    const LayerPlan q = plan_layer(D, i, L, R, split);
    unsigned cov_l = 0u, cov_r = 0u;
    for (int r = 0; r < nrows; ++r) {
      const unsigned bit = 1u << r;
      const unsigned need = row_need(q, split, left & bit, right & bit);
      if (!need) continue;
      const uint32_t* row = stack + r * row_lanes;
      const bool pairs = (reinterpret_cast<uintptr_t>(row) & 7u) == 0u;
      uint32_t v[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j][0] = 0xFFFFFFFFu;
        v[j][1] = q.W == 64u ? 0xFFFFFFFFu : 0u;
        if ((need >> j) & 1u)
          rangeplan::lanes_at(row, pairs, q.off[j], q.W, v[j][0], v[j][1]);
      }
      Word w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = Word{0u, 0u};
        if (!((need >> j) & 1u)) continue;
        w[j] = rangeplan::all_ones(q.W);
        rangeplan::and_lanes(q.W, v[j][0], v[j][1], w[j]);
        rangeplan::fold_rest(row, pairs, D, i, slot_key(L, R, up(D, i), j),
                             1u, w[j]);
      }
      const Word ra = q.same ? w[0] : w[2], rb = q.same ? w[1] : w[3];
      if (((left & bit) && q.l_ne &&
           (bloomrf::any_bit(w[0], q.m_la) ||
            bloomrf::any_bit(w[1], q.m_lb))) ||
          ((right & bit) && q.r_ne &&
           (bloomrf::any_bit(ra, q.m_ra) || bloomrf::any_bit(rb, q.m_rb))))
        hit |= bit;
      if (bloomrf::any_bit(q.b_l ? w[1] : w[0], bit_of(q.bit_l)))
        cov_l |= bit;
      if (bloomrf::any_bit(q.b_r ? rb : ra, bit_of(q.bit_r))) cov_r |= bit;
    }
    // a row that hit leaves; below the bottom layer every row has its
    // verdict; else the covering continuation (combine_layer's)
    left &= ~hit;
    right &= ~hit;
    if (q.bottom) break;
    const bool new_split = split || q.lp_ne_rp;
    const unsigned nxt_right =
        (split ? right : (new_split ? left : 0u)) & cov_r;
    left &= cov_l;
    right = nxt_right;
    split = new_split;
  }
  return hit;
}

// One thread per query: its top-level test once, then its rows 32 at a
// time (range_rows).  At most 64 registers (four blocks a SM).
__global__ void __launch_bounds__(bloomrf::kThreads, 4)
    range_stacked_kernel(const int64_t* __restrict__ lo,
                         const int64_t* __restrict__ hi, int64_t n,
                         const uint32_t* __restrict__ stack,
                         int64_t row_lanes,
                         const __grid_constant__ bloomrf::DescParam p,
                         int rows, bool* __restrict__ out) {
  const Desc D{p.w};
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  uint32_t L = static_cast<uint32_t>(lo[t]), R = static_cast<uint32_t>(hi[t]);
  bool* o = out + t * rows;
  rangeplan::Paths start;
  const bool whole = rangeplan::start(D, L, R, start) >= 0;
  for (int c0 = 0; c0 < rows; c0 += 32) {
    const int nc = min(32, rows - c0);
    const unsigned hit =
        whole ? ~0u
              : range_rows(stack + c0 * row_lanes, row_lanes, nc, D, L, R,
                           start);
    for (int r = 0; r < nc; ++r) o[c0 + r] = ((hit >> r) & 1u) != 0u;
  }
}

// B6: grid (key tiles x rows), a thread per (key, row) cell.
__global__ void __launch_bounds__(bloomrf::kThreads)
    point_stacked_kernel(const int64_t* __restrict__ keys, int64_t n,
                         const uint32_t* __restrict__ stack,
                         int64_t row_lanes,
                         const __grid_constant__ bloomrf::DescParam p,
                         int rows, bool* __restrict__ out) {
  const Desc D{p.w};
  const int r = blockIdx.y;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  out[t * rows + r] = rangeplan::point_verdict(
      stack + r * row_lanes, D, static_cast<uint32_t>(keys[t]));
}

}  // namespace

// desc: the descriptor parameter in host memory, kParamDescWords words
// (kernels/_build.py::param_descriptor), copied into the launch
extern "C" int bloomrf_range_stacked(const int64_t* lo, const int64_t* hi,
                                     int64_t n, const uint32_t* stack,
                                     int64_t row_lanes, int R,
                                     const uint32_t* desc, bool* out,
                                     void* stream) {
  if (n <= 0 || R <= 0) return 0;
  bloomrf::DescParam p;
  if (!bloomrf::to_param(desc, p))
    return static_cast<int>(cudaErrorInvalidValue);
  range_stacked_kernel<<<bloomrf::grid_for(n), bloomrf::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      lo, hi, n, stack, row_lanes, p, R, out);
  return static_cast<int>(cudaGetLastError());
}

// desc: the descriptor parameter in host memory, kParamDescWords words
// (kernels/_build.py::param_descriptor), copied into the launch
extern "C" int bloomrf_point_stacked(const int64_t* keys, int64_t n,
                                     const uint32_t* stack, int64_t row_lanes,
                                     int R, const uint32_t* desc, bool* out,
                                     void* stream) {
  if (n <= 0 || R <= 0) return 0;
  bloomrf::DescParam p;
  if (!bloomrf::to_param(desc, p))
    return static_cast<int>(cudaErrorInvalidValue);
  point_stacked_kernel<<<dim3(bloomrf::grid_for(n), static_cast<unsigned>(R)),
                         bloomrf::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      keys, n, stack, row_lanes, p, R, out);
  return static_cast<int>(cudaGetLastError());
}
