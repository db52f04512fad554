// Device code shared by the bloomRF kernels (insert.cu, probe.cu,
// stacked.cu, and through rangeplan.cuh partitioned.cu and store_scan.cu):
// the layout descriptor and its launch parameter, mix32, position and word
// addressing, and the uint32 mask algebra of repro/core/bloomrf.py.
//
// All state arithmetic is uint32, as in the reference.  Where the reference
// relies on XLA defining a shift by >= 32 as 0, the code here guards the
// shift explicitly (C++ leaves it undefined): see shr(), mask_u32() and
// cov_bit().  uint32 add and subtract wrap here exactly as in the reference.
#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace bloomrf {

// ---------------------------------------------------------------------------
// Layout descriptor: a flat uint32 table built once per layout on the host
// (kernels/_build.py::layout_descriptor).  The insert (B1), point (B2/B7)
// and stacked (B5, B6) kernels read it from a launch parameter (DescParam);
// the range kernel of partitioned.cu (B3/B8) copies it into shared memory
// in every block (load_desc).  Header words, then one
// record per layer, then the seeds, then each layer's exact reciprocal of
// its word count (two words, low first; read by rangeplan.cuh).
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

// Words of the descriptor as a launch parameter
// (kernels/_build.py::PARAM_DESC_WORDS); every basic layout needs at most 349.
constexpr int kParamDescWords = 512;

// The descriptor as a __grid_constant__ kernel parameter: every thread reads
// it through the constant cache, so no block stages it in shared memory and
// waits at a barrier before its first key.
struct DescParam {
  uint32_t w[kParamDescWords];
};

// Copies a padded host descriptor (kernels/_build.py::param_descriptor) into
// a launch parameter; false when the length it records exceeds the capacity.
inline bool to_param(const uint32_t* desc, DescParam& p) {
  std::memcpy(p.w, desc, sizeof(p.w));
  return p.w[H_LEN] <= static_cast<uint32_t>(kParamDescWords);
}

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

// The masks over child words A (children 0..W-1) and B (W..2W-1) that
// select the child prefixes of `parent` in [qlo, qhi] (BloomRF._children_any
// without its nonempty flag); each is empty where the range misses its word.
__device__ __forceinline__ void child_masks(uint32_t delta, uint32_t parent,
                                            uint32_t qlo, uint32_t qhi,
                                            Word& mA, Word& mB) {
  const int W = 1 << (delta - 1u);
  const uint32_t base = parent << delta;
  const uint32_t last = base | ((1u << delta) - 1u);
  const int o_lo = static_cast<int>(min(max(qlo, base), last) - base);
  const int o_hi = static_cast<int>(min(max(qhi, base), last) - base);
  mA = mask_pair(o_lo, min(o_hi, W - 1), W);
  mB = mask_pair(max(o_lo - W, 0), o_hi - W, W);
}

// Any bit of mask m set in word w.
__device__ __forceinline__ bool any_bit(Word w, Word m) {
  return ((w.lo & m.lo) | (w.hi & m.hi)) != 0u;
}

// Any child prefix of `parent` in [qlo, qhi] set in child words wa/wb.
__device__ __forceinline__ bool children_hit(uint32_t delta, uint32_t parent,
                                             uint32_t qlo, uint32_t qhi,
                                             Word wa, Word wb) {
  Word mA, mB;
  child_masks(delta, parent, qlo, qhi, mA, mB);
  return ((wa.lo & mA.lo) | (wa.hi & mA.hi) | (wb.lo & mB.lo) |
          (wb.hi & mB.hi)) != 0u;
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

constexpr int kThreads = 256;

inline unsigned grid_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace bloomrf

extern "C" const char* bloomrf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
