// Range read plans of the kernels that read the filter words straight from
// L2 or device memory: partitioned.cu (B8, whose kernel B3 launches too),
// stacked.cu (B5) and store_scan.cu (B4); the point kernels (probe.cu for
// B2 and B7, stacked.cu for B6) take its word addressing and
// point_verdict.  All range plans give the verdict of ProbeEngine.plan_range +
// combine_range (repro/core/engine.py) in BloomRF._range_one's clip and
// select order, skipping only words the reference masks out; they differ in
// which words they read and when:
//
// * range_layers (B3, B8): one thread per range, top layer first, reading
//   per layer only the child words that a live path's hit mask or covering
//   bit can select (layer_needs), issued together; the next layer's words
//   wait for this layer's path flags.  Fewest sectors, which is what a
//   batch of many ranges is bound by.  B5 runs the same plan for several
//   filter rows at once, over word addresses computed once (stacked.cu).
// * layer_bits + scan_layer (B4): one thread per layer of a range, each
//   reading its layer's candidate words (left and right pair) at once and
//   computing the layer's tests; the path flags then run over those test
//   bits.  One round trip and a short chain of work per thread, which is
//   what a small, latency-bound batch is bound by.
//
// Word addresses use each layer's exact reciprocal of its word count
// (fast_mod) instead of a division.
#pragma once

#include "bloomrf.cuh"

namespace rangeplan {

using bloomrf::Desc;
using bloomrf::Word;

constexpr int kRepBuf = 2;  // replicas of a range word issued at once

// h mod n by Lemire's fastmod: M = floor((2^64 - 1) / n) + 1 (mod 2^64),
// h mod n = the high 64 bits of (M * h mod 2^64) * n.  Exact for every
// 32-bit h and n >= 1 (kernels/_build.py::fastmod_magic).
__device__ __forceinline__ uint32_t fast_mod(uint32_t h, uint64_t M,
                                             uint32_t n) {
  const uint64_t low = M * h;
  const uint64_t t = static_cast<uint64_t>(static_cast<uint32_t>(low)) * n;
  const uint64_t u =
      static_cast<uint64_t>(static_cast<uint32_t>(low >> 32)) * n + (t >> 32);
  return static_cast<uint32_t>(u >> 32);
}

// bloomrf::word_bitoff with the layer's reciprocal in place of h % nwords.
__device__ __forceinline__ uint32_t word_bitoff(const Desc& D, int i,
                                                uint32_t rep,
                                                uint32_t wordkey) {
  const uint32_t* L = D.layer(i);
  const uint32_t h = bloomrf::mix32(wordkey ^ D.seed(i, rep));
  const uint32_t* m = D.w + L[bloomrf::L_FASTMOD_OFF];
  const uint64_t M = (static_cast<uint64_t>(m[1]) << 32) | m[0];
  return L[bloomrf::L_OFFBITS] + fast_mod(h, M, L[bloomrf::L_NWORDS]) *
                                     L[bloomrf::L_W];
}

// The AND of key x's bits in BloomRF._positions_one's order, stopping at
// the first clear one: the point verdict of probe.cu (B2, B7) and, one row
// a thread, of stacked.cu (B6).
__device__ __forceinline__ bool point_verdict(
    const uint32_t* __restrict__ state, const Desc& D, uint32_t x) {
  for (int i = 0; i < D.k(); ++i) {
    const uint32_t* L = D.layer(i);
    const uint32_t li = L[bloomrf::L_LEVEL];
    const uint32_t off = (x >> li) & (L[bloomrf::L_W] - 1u);
    const uint32_t wkey = x >> (li + L[bloomrf::L_DELTA] - 1u);
    for (uint32_t rep = 0; rep < L[bloomrf::L_REPS]; ++rep) {
      const uint32_t pos = rangeplan::word_bitoff(D, i, rep, wkey) + off;
      if (!((__ldg(state + (pos >> 5)) >> (pos & 31u)) & 1u)) return false;
    }
  }
  if (!D.has_exact()) return true;
  const uint32_t pos = D.exact_off() + bloomrf::shr(x, D.top());
  return ((__ldg(state + (pos >> 5)) >> (pos & 31u)) & 1u) != 0u;
}

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

// The W-bit word at bit offset `bitoff` as two lanes: a W = 64 word's low
// and high lane, or a narrower word's lane and its bit offset in that lane.
// A W = 64 word starts on an even lane (its segment is 64-bit aligned), so
// one 8-byte load reads it when the state is 8-byte aligned (`pairs`).
__device__ __forceinline__ void lanes_at(const uint32_t* __restrict__ state,
                                         bool pairs, uint32_t bitoff,
                                         uint32_t W, uint32_t& lo,
                                         uint32_t& hi) {
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

// Replica r's word of layer i at `wordkey` as two lanes (lanes_at).
__device__ __forceinline__ void load_lanes(const uint32_t* __restrict__ state,
                                           bool pairs, const Desc& D, int i,
                                           uint32_t r, uint32_t wordkey,
                                           uint32_t W, uint32_t& lo,
                                           uint32_t& hi) {
  lanes_at(state, pairs, rangeplan::word_bitoff(D, i, r, wordkey), W, lo, hi);
}

// AND one replica's lanes into w (BloomRF._load_word's AND over replicas;
// a word below 32 bits is cut out of its lane, W < 32 so the shifts are
// defined).
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

__device__ __forceinline__ Word all_ones(uint32_t W) {
  return Word{0xFFFFFFFFu, W == 64u ? 0xFFFFFFFFu : 0u};
}

// The AND over replicas first..reps-1 of layer i's word at `wordkey`, one
// load each, into w.
__device__ __forceinline__ void fold_rest(const uint32_t* __restrict__ state,
                                          bool pairs, const Desc& D, int i,
                                          uint32_t wordkey, uint32_t first,
                                          Word& w) {
  const uint32_t* lay = D.layer(i);
  const uint32_t W = lay[bloomrf::L_W];
  for (uint32_t r = first; r < lay[bloomrf::L_REPS]; ++r) {
    uint32_t lo, hi;
    load_lanes(state, pairs, D, i, r, wordkey, W, lo, hi);
    and_lanes(W, lo, hi, w);
  }
}

// Path state of a range plan between layers.
struct Paths {
  bool split, left_alive, right_alive;
};

// The top-level test of a range plan: sets the bounds in order and the path
// flags; returns 1 when the range spans a whole top-level interval (a hit
// with no word read), else -1.
__device__ __forceinline__ int start(const Desc& D, uint32_t& L, uint32_t& R,
                                     Paths& p) {
  if (L > R) {  // swapped bounds are allowed (L, R = min, max)
    const uint32_t t = L;
    L = R;
    R = t;
  }
  p = Paths{false, true, false};
  const uint32_t top = D.top();
  if (top < D.d()) {
    const uint32_t lt = bloomrf::shr(L, top), rt = bloomrf::shr(R, top);
    // saturated top levels: a middle gap of >= 1 top-level DI is positive
    if (rt - lt >= 2u) return 1;
    p.split = lt != rt;
    p.right_alive = p.split;
  }
  return -1;
}

// Layer i of the plan's combine over its child words: 1 for a hit, 0 when
// both paths die, -1 to go on to layer i - 1 (path flags updated).
__device__ __forceinline__ int combine_layer(const Desc& D, int i, uint32_t L,
                                             uint32_t R, Word wLA, Word wLB,
                                             Word wRA, Word wRB, Paths& p) {
  const uint32_t* lay = D.layer(i);
  const uint32_t li = lay[bloomrf::L_LEVEL];
  const uint32_t delta = lay[bloomrf::L_DELTA];
  const bool bottom = i == 0;
  const uint32_t edge = bottom ? 0u : 1u;
  const uint32_t Lp = bloomrf::shr(L, li), Rp = bloomrf::shr(R, li);
  const uint32_t Lpar = bloomrf::shr(L, li + delta);
  const uint32_t Rpar = bloomrf::shr(R, li + delta);

  // left path (doubles as the single pre-split path); uint32 wraps as in
  // the reference, and every wrapped bound is masked by its nonempty flag
  const uint32_t l_end = (Lpar << delta) | ((1u << delta) - 1u);
  const uint32_t l_qhi = p.split ? l_end : Rp - edge;
  const bool l_nonempty =
      bottom || (p.split ? (Lp != l_end) : (Rp - Lp >= 2u));
  if (l_nonempty && p.left_alive &&
      bloomrf::children_hit(delta, Lpar, Lp + edge, l_qhi, wLA, wLB))
    return 1;

  // right path (only live after the split)
  const uint32_t r_start = Rpar << delta;
  const bool r_nonempty = bottom || (Rp != r_start);
  if (r_nonempty && p.right_alive &&
      bloomrf::children_hit(delta, Rpar, r_start, Rp - edge, wRA, wRB))
    return 1;
  if (bottom) return 0;

  // covering continuation (early stop as mask AND)
  const bool new_split = p.split || (Lp != Rp);
  const bool covL = bloomrf::cov_bit(D, i, L, wLA, wLB);
  const bool covR = bloomrf::cov_bit(D, i, R, wRA, wRB);
  const bool nxt_right =
      (p.split ? p.right_alive : (p.left_alive && new_split)) && covR;
  p.left_alive = p.left_alive && covL;
  p.right_alive = nxt_right;
  p.split = new_split;
  return (p.left_alive || p.right_alive) ? -1 : 0;
}

// ---------------------------------------------------------------------------
// range_layers: layer by layer, only layer_needs's words
// ---------------------------------------------------------------------------

// One layer's child words as issued: [slot][replica][lane], slots LA, LB,
// RA, RB.  A slot not issued holds the AND identity.
struct LayerWords {
  uint32_t v[4][kRepBuf][2];
  unsigned need;  // the slots issued
};

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

// Slot j's word of layer i, AND-combined across replicas: the issued ones,
// then one load each for replicas beyond kRepBuf.  A slot not issued is
// never read by the verdict and comes back empty.
__device__ __forceinline__ Word fold(const uint32_t* __restrict__ state,
                                     bool pairs, const Desc& D, int i,
                                     uint32_t wordkey, const LayerWords& b,
                                     int j) {
  if (!((b.need >> j) & 1u)) return Word{0u, 0u};
  const uint32_t W = D.layer(i)[bloomrf::L_W];
  Word w = all_ones(W);
#pragma unroll
  for (int r = 0; r < kRepBuf; ++r) and_lanes(W, b.v[j][r][0], b.v[j][r][1], w);
  fold_rest(state, pairs, D, i, wordkey, kRepBuf, w);
  return w;
}

// Range verdict for [L, R] (swapped bounds allowed), reading per layer only
// the words of layer_needs, issued together.
__device__ inline bool range_layers(const uint32_t* __restrict__ state,
                                    const Desc& D, uint32_t L, uint32_t R) {
  Paths p;
  if (start(D, L, R, p) >= 0) return true;
  const bool pairs = (reinterpret_cast<uintptr_t>(state) & 7u) == 0u;
  const int k = D.k();
  LayerWords cur;
  issue_layer(state, pairs, D, k - 1, L, R,
              layer_needs(D, k - 1, L, R, p.split, true, p.right_alive), cur);
  for (int i = k - 1; i >= 0; --i) {
    const uint32_t* lay = D.layer(i);
    const uint32_t up = lay[bloomrf::L_LEVEL] + lay[bloomrf::L_DELTA];
    const uint32_t Lpar = bloomrf::shr(L, up), Rpar = bloomrf::shr(R, up);
    const Word wLA = fold(state, pairs, D, i, Lpar << 1, cur, 0);
    const Word wLB = fold(state, pairs, D, i, (Lpar << 1) | 1u, cur, 1);
    const bool same = Lpar == Rpar;
    const Word wRA = same ? wLA : fold(state, pairs, D, i, Rpar << 1, cur, 2);
    const Word wRB =
        same ? wLB : fold(state, pairs, D, i, (Rpar << 1) | 1u, cur, 3);
    const int v = combine_layer(D, i, L, R, wLA, wLB, wRA, wRB, p);
    if (v >= 0) return v != 0;
    issue_layer(state, pairs, D, i - 1, L, R,
                layer_needs(D, i - 1, L, R, p.split, p.left_alive,
                            p.right_alive),
                cur);
  }
  return false;
}

// ---------------------------------------------------------------------------
// layer_bits + scan_layer: each layer's tests apart, then the path flags
// ---------------------------------------------------------------------------

// Layer i's part of the verdict, from its child words alone, as bits:
// 1 the left path hits here, 2 the right path hits here (each as if alive),
// 4 and 8 the covering bits of L and R, 16 Lp != Rp.  The path flags that
// gate them depend on the layers above only through the covering bits:
// entering layer i, the paths have split iff L and R have different
// parents here (Lpar != Rpar), the left path lives iff every covering bit
// of L above is set, and the right path is born where the split happens
// and lives on while the covering bits of R are set (combine_range's
// recursion, solved; scan_layer runs it).
__device__ __forceinline__ unsigned layer_tests(const Desc& D, int i,
                                                uint32_t L, uint32_t R,
                                                Word wLA, Word wLB, Word wRA,
                                                Word wRB) {
  const uint32_t* lay = D.layer(i);
  const uint32_t li = lay[bloomrf::L_LEVEL];
  const uint32_t delta = lay[bloomrf::L_DELTA];
  const bool bottom = i == 0;
  const uint32_t edge = bottom ? 0u : 1u;
  const uint32_t Lp = bloomrf::shr(L, li), Rp = bloomrf::shr(R, li);
  const uint32_t Lpar = bloomrf::shr(L, li + delta);
  const uint32_t Rpar = bloomrf::shr(R, li + delta);
  const bool split = Lpar != Rpar;
  const uint32_t l_end = (Lpar << delta) | ((1u << delta) - 1u);
  const bool l_nonempty = bottom || (split ? (Lp != l_end) : (Rp - Lp >= 2u));
  const uint32_t r_start = Rpar << delta;
  const bool r_nonempty = bottom || (Rp != r_start);
  const bool hit_l =
      l_nonempty && bloomrf::children_hit(delta, Lpar, Lp + edge,
                                          split ? l_end : Rp - edge, wLA, wLB);
  const bool hit_r = r_nonempty && bloomrf::children_hit(
                                       delta, Rpar, r_start, Rp - edge, wRA,
                                       wRB);
  const bool cov_l = !bottom && bloomrf::cov_bit(D, i, L, wLA, wLB);
  const bool cov_r = !bottom && bloomrf::cov_bit(D, i, R, wRA, wRB);
  return (hit_l ? 1u : 0u) | (hit_r ? 2u : 0u) | (cov_l ? 4u : 0u) |
         (cov_r ? 8u : 0u) | (Lp != Rp ? 16u : 0u);
}

// Layer i's tests as bits, from its words: the first replica of its two or
// four candidate words issued together, then the further replicas.
__device__ __forceinline__ unsigned layer_bits(
    const uint32_t* __restrict__ state, bool pairs, const Desc& D, int i,
    uint32_t L, uint32_t R) {
  const uint32_t* lay = D.layer(i);
  const uint32_t W = lay[bloomrf::L_W];
  const uint32_t up = lay[bloomrf::L_LEVEL] + lay[bloomrf::L_DELTA];
  const uint32_t Lpar = bloomrf::shr(L, up), Rpar = bloomrf::shr(R, up);
  const bool same = Lpar == Rpar;
  const uint32_t key[4] = {Lpar << 1, (Lpar << 1) | 1u, Rpar << 1,
                           (Rpar << 1) | 1u};
  uint32_t v[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < 2 || !same)
      load_lanes(state, pairs, D, i, 0, key[j], W, v[j][0], v[j][1]);
  }
  Word x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= 2 && same) {
      x[j] = x[j - 2];
      continue;
    }
    x[j] = all_ones(W);
    and_lanes(W, v[j][0], v[j][1], x[j]);
    fold_rest(state, pairs, D, i, key[j], 1u, x[j]);
  }
  return layer_tests(D, i, L, R, x[0], x[1], x[2], x[3]);
}

// One step of the path flags over layer i's test bits, top first: 1 for a
// hit, 0 when the verdict is "no" (both paths dead, or the bottom layer
// passed without a hit), -1 to go on to layer i - 1.
__device__ __forceinline__ int scan_layer(unsigned bits, int i, Paths& p) {
  if (((bits & 1u) && p.left_alive) || ((bits & 2u) && p.right_alive))
    return 1;
  if (i == 0) return 0;
  const bool new_split = p.split || (bits & 16u);
  const bool nxt_right =
      (p.split ? p.right_alive : (p.left_alive && new_split)) && (bits & 8u);
  p.left_alive = p.left_alive && (bits & 4u);
  p.right_alive = nxt_right;
  p.split = new_split;
  return (p.left_alive || p.right_alive) ? -1 : 0;
}

}  // namespace rangeplan
