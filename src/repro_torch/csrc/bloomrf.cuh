// Device code shared by the bloomRF kernels (insert.cu, probe.cu,
// stacked.cu, and through rangeplan.cuh partitioned.cu and store_scan.cu):
// the layout descriptor, mix32, position and word addressing, the uint32
// mask algebra of repro/core/bloomrf.py, and the per-key point and range
// verdicts.
//
// All state arithmetic is uint32, as in the reference.  Where the reference
// relies on XLA defining a shift by >= 32 as 0, the code here guards the
// shift explicitly (C++ leaves it undefined): see shr(), mask_u32() and
// cov_bit().  uint32 add and subtract wrap here exactly as in the reference.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bloomrf {

// ---------------------------------------------------------------------------
// Layout descriptor: a flat uint32 table built once per layout on the host
// (kernels/_build.py::layout_descriptor) and copied into shared memory by
// every block of the probe kernels (the insert kernel reads it from its
// launch parameters).  Header words, then one record per layer, then the seeds,
// then each layer's exact reciprocal of its word count (two words, low
// first; read by rangeplan.cuh).
// ---------------------------------------------------------------------------
constexpr int kHdr = 8;
constexpr int kLayerStride = 8;
enum Header { H_D = 0, H_K, H_TOP, H_HAS_EXACT, H_EXACT_OFF, H_LEN };
enum LayerField { L_LEVEL = 0, L_DELTA, L_W, L_NWORDS, L_OFFBITS, L_REPS,
                  L_SEED_OFF, L_FASTMOD_OFF };

struct Desc {
  const uint32_t* w;
  __device__ uint32_t d() const { return w[H_D]; }
  __device__ int k() const { return static_cast<int>(w[H_K]); }
  __device__ uint32_t top() const { return w[H_TOP]; }
  __device__ bool has_exact() const { return w[H_HAS_EXACT] != 0; }
  __device__ uint32_t exact_off() const { return w[H_EXACT_OFF]; }
  __device__ const uint32_t* layer(int i) const {
    return w + kHdr + kLayerStride * i;
  }
  __device__ uint32_t seed(int i, uint32_t rep) const {
    return w[layer(i)[L_SEED_OFF] + rep];
  }
};

// Copy the descriptor into shared memory.  Every thread of the block calls
// this before any thread returns (it synchronises the block).
__device__ inline Desc load_desc(const uint32_t* g, uint32_t* s, int len) {
  for (int j = threadIdx.x; j < len; j += blockDim.x) s[j] = g[j];
  __syncthreads();
  return Desc{s};
}

// murmur3-style finalizer (repro/core/hashing.py::mix32).
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// x >> s with s == 32 giving 0 (BloomRF._shr; top_level == d == 32).
__device__ __forceinline__ uint32_t shr(uint32_t x, uint32_t s) {
  return s >= 32u ? 0u : x >> s;
}

// Bit offset of the layer-i word at `wordkey` for one replica.
__device__ __forceinline__ uint32_t word_bitoff(const Desc& D, int i,
                                                uint32_t rep,
                                                uint32_t wordkey) {
  const uint32_t* L = D.layer(i);
  const uint32_t h = mix32(wordkey ^ D.seed(i, rep));
  return L[L_OFFBITS] + (h % L[L_NWORDS]) * L[L_W];
}

// Calls f(bitpos) for every bit position of key x (BloomRF._positions_one),
// in the reference's order; stops early when f returns false.
template <class F>
__device__ __forceinline__ void for_each_position(const Desc& D, uint32_t x,
                                                  F f) {
  for (int i = 0; i < D.k(); ++i) {
    const uint32_t* L = D.layer(i);
    const uint32_t li = L[L_LEVEL];
    const uint32_t off = (x >> li) & (L[L_W] - 1u);
    const uint32_t wkey = x >> (li + L[L_DELTA] - 1u);
    for (uint32_t rep = 0; rep < L[L_REPS]; ++rep) {
      if (!f(word_bitoff(D, i, rep, wkey) + off)) return;
    }
  }
  if (D.has_exact()) f(D.exact_off() + shr(x, D.top()));
}

struct Word {
  uint32_t lo, hi;  // hi is 0 unless W == 64
};

// Layer-i word at `wordkey`, AND-combined across replicas
// (BloomRF._load_word).  W = 64 words take two lanes; words below 32 bits
// are extracted from their lane (W < 32, so the shifts are defined).
__device__ __forceinline__ Word load_word(const uint32_t* __restrict__ state,
                                          const Desc& D, int i,
                                          uint32_t wordkey) {
  const uint32_t* L = D.layer(i);
  const uint32_t W = L[L_W];
  Word w{0xFFFFFFFFu, W == 64u ? 0xFFFFFFFFu : 0u};
  for (uint32_t rep = 0; rep < L[L_REPS]; ++rep) {
    const uint32_t bitoff = word_bitoff(D, i, rep, wordkey);
    const uint32_t lane = bitoff >> 5;
    const uint32_t v = __ldg(state + lane);
    if (W == 64u) {
      w.lo &= v;
      w.hi &= __ldg(state + lane + 1);
    } else if (W == 32u) {
      w.lo &= v;
    } else {
      w.lo &= (v >> (bitoff & 31u)) & ((1u << W) - 1u);
    }
  }
  return w;
}

// uint32 mask with bits [a..b] set, empty when b < a (bloomrf.py::_mask_u32):
// a width of 32 is the full mask, never a shift by 32.
__device__ __forceinline__ uint32_t mask_u32(int a, int b) {
  const int ac = min(max(a, 0), 32);
  const int bc = min(max(b + 1, 0), 32);
  const int width = bc - ac;
  if (width <= 0) return 0u;
  const uint32_t base = width >= 32 ? 0xFFFFFFFFu : ((1u << width) - 1u);
  return base << min(ac, 31);
}

__device__ __forceinline__ Word mask_pair(int a, int b, uint32_t W) {
  if (W <= 32u) return Word{mask_u32(a, b), 0u};
  return Word{mask_u32(a, min(b, 31)), mask_u32(a - 32, b - 32)};
}

// Any child prefix of `parent` in [qlo, qhi] set in child words wa/wb
// (BloomRF._children_any without its nonempty flag).
__device__ __forceinline__ bool children_hit(uint32_t delta, uint32_t parent,
                                             uint32_t qlo, uint32_t qhi,
                                             Word wa, Word wb) {
  const int W = 1 << (delta - 1u);
  const uint32_t base = parent << delta;
  const uint32_t last = base | ((1u << delta) - 1u);
  const int o_lo = static_cast<int>(min(max(qlo, base), last) - base);
  const int o_hi = static_cast<int>(min(max(qhi, base), last) - base);
  const Word mA = mask_pair(o_lo, min(o_hi, W - 1), W);
  uint32_t acc = (wa.lo & mA.lo) | (wa.hi & mA.hi);
  const Word mB = mask_pair(max(o_lo - W, 0), o_hi - W, W);
  acc |= (wb.lo & mB.lo) | (wb.hi & mB.hi);
  return acc != 0u;
}

// Covering bit of x at layer i, served from the child words of x's parent
// (ProbeEngine._cov_bit): off < W <= 64, and each shift is clamped below 32.
__device__ __forceinline__ bool cov_bit(const Desc& D, int i, uint32_t x,
                                        Word wa, Word wb) {
  const uint32_t* L = D.layer(i);
  const uint32_t li = L[L_LEVEL];
  const uint32_t W = L[L_W];
  const uint32_t off = (x >> li) & (W - 1u);
  const bool b = ((x >> (li + L[L_DELTA] - 1u)) & 1u) != 0u;
  const uint32_t lo = b ? wb.lo : wa.lo;
  uint32_t bit = (lo >> min(off, 31u)) & 1u;
  if (W == 64u) {
    const uint32_t hi = b ? wb.hi : wa.hi;
    const uint32_t bit_hi = (hi >> (max(off, 32u) - 32u)) & 1u;
    bit = off < 32u ? bit : bit_hi;
  }
  return bit != 0u;
}

// Range verdict for [L, R] (swapped bounds allowed) against the filter at
// `state` (ProbeEngine.plan_range + combine_range of repro/core/engine.py,
// with the clip and select order of BloomRF._range_one), in one thread's
// registers, top layer first.  The words of a path that is already dead
// are not loaded, the right path reuses the left path's words before the
// split, and the thread returns as soon as the verdict is known: skipped
// words are exactly those the reference masks out, so verdicts are
// unchanged.  Hashed layouts only (no exact segment).  Used by stacked.cu
// (B5); B3, B4 and B8 run the read plans of rangeplan.cuh.
__device__ inline bool range_one(const uint32_t* __restrict__ state,
                                 const Desc& D, uint32_t L, uint32_t R) {
  if (L > R) {  // swapped bounds are allowed (L, R = min, max)
    const uint32_t t = L;
    L = R;
    R = t;
  }
  const uint32_t top = D.top();
  bool split = false, left_alive = true, right_alive = false;
  if (top < D.d()) {
    const uint32_t lt = shr(L, top), rt = shr(R, top);
    // saturated top levels: a middle gap of >= 1 top-level DI is positive
    if (rt - lt >= 2u) return true;
    split = lt != rt;
    right_alive = split;
  }
  for (int i = D.k() - 1; i >= 0; --i) {
    const uint32_t* lay = D.layer(i);
    const uint32_t li = lay[L_LEVEL];
    const uint32_t delta = lay[L_DELTA];
    const bool bottom = i == 0;
    const uint32_t edge = bottom ? 0u : 1u;
    const uint32_t Lp = shr(L, li), Rp = shr(R, li);
    const uint32_t Lpar = shr(L, li + delta);
    const uint32_t Rpar = shr(R, li + delta);

    // child words: the left pair while the left path lives; the right pair
    // while the right path lives or may split off below this layer
    Word wLA{0u, 0u}, wLB{0u, 0u}, wRA{0u, 0u}, wRB{0u, 0u};
    const bool need_l = left_alive;
    const bool need_r = right_alive || (!split && left_alive && !bottom);
    if (need_l) {
      wLA = load_word(state, D, i, Lpar << 1);
      wLB = load_word(state, D, i, (Lpar << 1) | 1u);
    }
    if (need_r && need_l && Rpar == Lpar) {
      wRA = wLA;
      wRB = wLB;
    } else if (need_r) {
      wRA = load_word(state, D, i, Rpar << 1);
      wRB = load_word(state, D, i, (Rpar << 1) | 1u);
    }

    // left path (doubles as the single pre-split path); uint32 wraps as in
    // the reference, and every wrapped bound is masked by its nonempty flag
    const uint32_t l_end = (Lpar << delta) | ((1u << delta) - 1u);
    const uint32_t l_qlo = Lp + edge;
    const uint32_t l_qhi = split ? l_end : Rp - edge;
    const bool l_nonempty =
        bottom || (split ? (Lp != l_end) : (Rp - Lp >= 2u));
    if (l_nonempty && left_alive &&
        children_hit(delta, Lpar, l_qlo, l_qhi, wLA, wLB))
      return true;

    // right path (only live after the split)
    const uint32_t r_start = Rpar << delta;
    const uint32_t r_qhi = Rp - edge;
    const bool r_nonempty = bottom || (Rp != r_start);
    if (r_nonempty && right_alive &&
        children_hit(delta, Rpar, r_start, r_qhi, wRA, wRB))
      return true;

    // covering continuation (early stop as mask AND)
    if (!bottom) {
      const bool covL = cov_bit(D, i, L, wLA, wLB);
      const bool covR = cov_bit(D, i, R, wRA, wRB);
      const bool new_split = split || (Lp != Rp);
      const bool nxt_left = left_alive && covL;
      const bool nxt_right =
          (split ? right_alive : (left_alive && new_split)) && covR;
      left_alive = nxt_left;
      right_alive = nxt_right;
      split = new_split;
      if (!left_alive && !right_alive) return false;
    }
  }
  return false;
}

// Point verdict for key x against the filter at `state`: the AND of every
// position's bit, stopping at the first clear one.  Shared by probe.cu (B2)
// and stacked.cu (B6).
__device__ inline bool point_one(const uint32_t* __restrict__ state,
                                 const Desc& D, uint32_t x) {
  bool all = true;
  for_each_position(D, x, [&](uint32_t pos) {
    all = ((__ldg(state + (pos >> 5)) >> (pos & 31u)) & 1u) != 0u;
    return all;
  });
  return all;
}

constexpr int kThreads = 256;

inline unsigned grid_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace bloomrf

extern "C" const char* bloomrf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
