// bloomRF range probe for Hopper on filters above the resident budget,
// whose state lives in device memory (far larger than the 50 MB L2).
//
// Replaces the Pallas TPU kernel
//   B8  repro/kernels/rangeprobe.py::range_probe_partitioned
//       (the engine's range plan, its B x A lanes bucketed by 64 KiB filter
//       block, body _gather_block_kernel, an XLA scatter back to (B, A),
//       then the engine's combine).
// Its point twin, B7 (repro/kernels/probe.py::point_probe_partitioned), is
// served by probe.cu's kernel: one thread per key stopping at the first
// clear bit is already the design for a state in device memory.
// The TPU buckets probes so that each tile DMAs one filter block into VMEM.
// On Hopper a probe reads one 32-byte sector through L2, and staging a
// block would move far more than its probes read, so nothing is bucketed
// here: one thread takes one range, runs its plan in registers, reads its
// words straight from device memory and writes one byte.
//
// Bound: the distinct sectors that the verdicts need, read at random from
// device memory.  On the card the time follows the number of sectors read
// more than the number of round trips in a chain (prefetching the next
// layer's words was measured 1.5x slower), so the kernel reads as few as
// it can and keeps the loads of one layer in flight together: per layer,
// only the child words whose bits its masks or its covering bits can
// select (a live path's pair shrinks to the one word that holds both ends
// when the range does not cross the pair's middle).  Those words (left
// pair, right pair, the first kRepBuf replicas of each; a W = 64 word as
// one 8-byte load) are issued together before any is combined.
// Verdicts are those of ProbeEngine.plan_range + combine_range
// (repro/core/engine.py) in BloomRF._range_one's clip and select order, as
// bloomrf::range_one computes them: a word is skipped only where the
// reference masks it out.  Hashed layouts only: the wrapper rejects exact
// segments for ranges, as the TPU kernel does.
#include "bloomrf.cuh"

namespace {

using bloomrf::Desc;
using bloomrf::Word;

constexpr int kRepBuf = 2;  // replicas of a range word issued at once

// Which halves of a child pair a children_hit mask over [qlo, qhi] covers:
// the first word A (children 0..W-1) and the second B (W..2W-1), with the
// clamping of bloomrf::children_hit.
__device__ __forceinline__ unsigned pair_halves(uint32_t delta, uint32_t par,
                                                uint32_t qlo, uint32_t qhi) {
  const int W = 1 << (delta - 1u);
  const uint32_t base = par << delta;
  const uint32_t last = base | ((1u << delta) - 1u);
  const int o_lo = static_cast<int>(min(max(qlo, base), last) - base);
  const int o_hi = static_cast<int>(min(max(qhi, base), last) - base);
  if (o_lo > o_hi) return 0u;
  return (o_lo < W ? 1u : 0u) | (o_hi >= W ? 2u : 0u);
}

// Layer i's child words that the verdict can read, as bits over the slots
// LA, LB, RA, RB: the halves each live path's hit mask covers and the words
// that hold its covering bits.  Depends only on L, R and the path flags.
// Before the split both paths share one parent, and the right path's
// words are the left's (the R bits fold into the L bits).
__device__ __forceinline__ unsigned layer_needs(const Desc& D, int i,
                                                uint32_t L, uint32_t R,
                                                bool split, bool left_alive,
                                                bool right_alive) {
  const uint32_t* lay = D.layer(i);
  const uint32_t li = lay[bloomrf::L_LEVEL];
  const uint32_t delta = lay[bloomrf::L_DELTA];
  const bool bottom = i == 0;
  const uint32_t edge = bottom ? 0u : 1u;
  const uint32_t Lp = bloomrf::shr(L, li), Rp = bloomrf::shr(R, li);
  const uint32_t Lpar = bloomrf::shr(L, li + delta);
  const uint32_t Rpar = bloomrf::shr(R, li + delta);
  const uint32_t cov = li + delta - 1u;  // the bit that picks A or B
  unsigned need = 0u;
  if (left_alive) {
    const uint32_t l_end = (Lpar << delta) | ((1u << delta) - 1u);
    const bool l_nonempty =
        bottom || (split ? (Lp != l_end) : (Rp - Lp >= 2u));
    if (l_nonempty)
      need |= pair_halves(delta, Lpar, Lp + edge, split ? l_end : Rp - edge);
    if (!bottom) need |= 1u << ((L >> cov) & 1u);
  }
  if (right_alive) {
    const uint32_t r_start = Rpar << delta;
    if (bottom || Rp != r_start)
      need |= pair_halves(delta, Rpar, r_start, Rp - edge) << 2;
  }
  if (!bottom && (split ? right_alive : (left_alive && Lp != Rp)))
    need |= 4u << ((R >> cov) & 1u);
  if (Lpar == Rpar) need = (need | (need >> 2)) & 3u;
  return need;
}

// One layer's child words as issued: [slot][replica][lane], slots LA, LB,
// RA, RB.  Lane 1 holds a W = 64 word's high lane, or the bit offset in its
// lane of a word below 32 bits.  A slot not issued holds the AND identity.
struct LayerWords {
  uint32_t v[4][kRepBuf][2];
  unsigned need;  // the slots issued
};

// Replica r's word of layer i at `wordkey`: its lanes as LayerWords holds
// them.  A W = 64 word starts on an even lane (its segment is 64-bit
// aligned), so one 8-byte load reads it when the state is 8-byte aligned.
__device__ __forceinline__ void load_lanes(const uint32_t* __restrict__ state,
                                           bool pairs, const Desc& D, int i,
                                           uint32_t r, uint32_t wordkey,
                                           uint32_t W, uint32_t& lo,
                                           uint32_t& hi) {
  const uint32_t bitoff = bloomrf::word_bitoff(D, i, r, wordkey);
  const uint32_t lane = bitoff >> 5;
  if (W == 64u && pairs) {
    const uint2 p = __ldg(reinterpret_cast<const uint2*>(state + lane));
    lo = p.x;
    hi = p.y;
  } else {
    lo = __ldg(state + lane);
    hi = W == 64u ? __ldg(state + lane + 1) : (bitoff & 31u);
  }
}

__device__ __forceinline__ void issue_layer(const uint32_t* __restrict__ state,
                                            bool pairs, const Desc& D, int i,
                                            uint32_t L, uint32_t R,
                                            unsigned need, LayerWords& b) {
  const uint32_t* lay = D.layer(i);
  const uint32_t W = lay[bloomrf::L_W];
  const uint32_t up = lay[bloomrf::L_LEVEL] + lay[bloomrf::L_DELTA];
  const uint32_t Lpar = bloomrf::shr(L, up), Rpar = bloomrf::shr(R, up);
  const uint32_t key[4] = {Lpar << 1, (Lpar << 1) | 1u, Rpar << 1,
                           (Rpar << 1) | 1u};
  const uint32_t reps = lay[bloomrf::L_REPS];
  b.need = need;
#pragma unroll
  for (int r = 0; r < kRepBuf; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t lo = 0xFFFFFFFFu, hi = W == 64u ? 0xFFFFFFFFu : 0u;
      if (((need >> j) & 1u) && static_cast<uint32_t>(r) < reps)
        load_lanes(state, pairs, D, i, r, key[j], W, lo, hi);
      b.v[j][r][0] = lo;
      b.v[j][r][1] = hi;
    }
  }
}

// AND one replica's lanes into w (as bloomrf::load_word does for each).
__device__ __forceinline__ void and_lanes(uint32_t W, uint32_t lo,
                                          uint32_t hi, Word& w) {
  if (W == 64u) {
    w.lo &= lo;
    w.hi &= hi;
  } else if (W == 32u) {
    w.lo &= lo;
  } else {
    w.lo &= (lo >> hi) & ((1u << W) - 1u);
  }
}

// Slot j's word of layer i, AND-combined across replicas: the issued ones,
// then one load each for replicas beyond kRepBuf.  A slot not issued is
// never read by the verdict and comes back empty.
__device__ __forceinline__ Word fold(const uint32_t* __restrict__ state,
                                     bool pairs, const Desc& D, int i,
                                     uint32_t wordkey, const LayerWords& b,
                                     int j) {
  if (!((b.need >> j) & 1u)) return Word{0u, 0u};
  const uint32_t* lay = D.layer(i);
  const uint32_t W = lay[bloomrf::L_W];
  Word w{0xFFFFFFFFu, W == 64u ? 0xFFFFFFFFu : 0u};
#pragma unroll
  for (int r = 0; r < kRepBuf; ++r) and_lanes(W, b.v[j][r][0], b.v[j][r][1], w);
  for (uint32_t r = kRepBuf; r < lay[bloomrf::L_REPS]; ++r) {
    uint32_t lo, hi;
    load_lanes(state, pairs, D, i, r, wordkey, W, lo, hi);
    and_lanes(W, lo, hi, w);
  }
  return w;
}

// Range verdict for [L, R] (swapped bounds allowed): bloomrf::range_one's
// plan and combine, top layer first, reading per layer only the words of
// layer_needs, issued together.
__device__ bool range_partitioned(const uint32_t* __restrict__ state,
                                  const Desc& D, uint32_t L, uint32_t R) {
  if (L > R) {
    const uint32_t t = L;
    L = R;
    R = t;
  }
  const bool pairs = (reinterpret_cast<uintptr_t>(state) & 7u) == 0u;
  const uint32_t top = D.top();
  bool split = false, left_alive = true, right_alive = false;
  if (top < D.d()) {
    const uint32_t lt = bloomrf::shr(L, top), rt = bloomrf::shr(R, top);
    // saturated top levels: a middle gap of >= 1 top-level DI is positive
    if (rt - lt >= 2u) return true;
    split = lt != rt;
    right_alive = split;
  }
  const int k = D.k();
  LayerWords cur;
  issue_layer(state, pairs, D, k - 1, L, R,
              layer_needs(D, k - 1, L, R, split, true, right_alive), cur);
  for (int i = k - 1; i >= 0; --i) {
    const uint32_t* lay = D.layer(i);
    const uint32_t li = lay[bloomrf::L_LEVEL];
    const uint32_t delta = lay[bloomrf::L_DELTA];
    const bool bottom = i == 0;
    const uint32_t edge = bottom ? 0u : 1u;
    const uint32_t Lp = bloomrf::shr(L, li), Rp = bloomrf::shr(R, li);
    const uint32_t Lpar = bloomrf::shr(L, li + delta);
    const uint32_t Rpar = bloomrf::shr(R, li + delta);
    const bool new_split = split || (Lp != Rp);
    const Word wLA = fold(state, pairs, D, i, Lpar << 1, cur, 0);
    const Word wLB = fold(state, pairs, D, i, (Lpar << 1) | 1u, cur, 1);
    const bool same = Lpar == Rpar;
    const Word wRA = same ? wLA : fold(state, pairs, D, i, Rpar << 1, cur, 2);
    const Word wRB =
        same ? wLB : fold(state, pairs, D, i, (Rpar << 1) | 1u, cur, 3);

    // left path (doubles as the single pre-split path); uint32 wraps as in
    // the reference, and every wrapped bound is masked by its nonempty flag
    const uint32_t l_end = (Lpar << delta) | ((1u << delta) - 1u);
    const uint32_t l_qhi = split ? l_end : Rp - edge;
    const bool l_nonempty =
        bottom || (split ? (Lp != l_end) : (Rp - Lp >= 2u));
    if (l_nonempty && left_alive &&
        bloomrf::children_hit(delta, Lpar, Lp + edge, l_qhi, wLA, wLB))
      return true;

    // right path (only live after the split)
    const uint32_t r_start = Rpar << delta;
    const bool r_nonempty = bottom || (Rp != r_start);
    if (r_nonempty && right_alive &&
        bloomrf::children_hit(delta, Rpar, r_start, Rp - edge, wRA, wRB))
      return true;
    if (bottom) break;

    // covering continuation (early stop as mask AND)
    const bool covL = bloomrf::cov_bit(D, i, L, wLA, wLB);
    const bool covR = bloomrf::cov_bit(D, i, R, wRA, wRB);
    const bool nxt_right =
        (split ? right_alive : (left_alive && new_split)) && covR;
    left_alive = left_alive && covL;
    right_alive = nxt_right;
    split = new_split;
    if (!left_alive && !right_alive) return false;
    issue_layer(state, pairs, D, i - 1, L, R,
                layer_needs(D, i - 1, L, R, split, left_alive, right_alive),
                cur);
  }
  return false;
}

__global__ void __launch_bounds__(bloomrf::kThreads)
    range_partitioned_kernel(const int64_t* __restrict__ lo,
                             const int64_t* __restrict__ hi, int64_t n,
                             const uint32_t* __restrict__ state,
                             const uint32_t* __restrict__ gdesc, int desc_len,
                             bool* __restrict__ out) {
  extern __shared__ uint32_t sdesc[];
  const Desc D = bloomrf::load_desc(gdesc, sdesc, desc_len);
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  out[t] = range_partitioned(state, D, static_cast<uint32_t>(lo[t]),
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
