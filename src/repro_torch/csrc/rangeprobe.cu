// bloomRF batched range probe for Hopper.
//
// Replaces the Pallas TPU kernel
// repro/kernels/rangeprobe.py::range_probe_resident (body _range_kernel),
// which pins the filter in VMEM and traces the engine's plan -> one (tile, A)
// gather -> combine over a tile of queries.
//
// Here one thread answers one query: it runs ProbeEngine.plan_range and
// combine_range (repro/core/engine.py) in its registers, top layer first,
// with the clip and select order of BloomRF._range_one.  Bound: scattered
// 4-byte reads, at most 4 words x replicas per layer (W = 64 words take two
// lanes), read straight from device memory through L2.  The design reads
// fewer: the words of a path that is already dead are not loaded, the right
// path reuses the left path's words before the split, and the thread returns
// as soon as the verdict is known (the paper's early stop) -- skipped words
// are exactly those the reference masks out, so verdicts are unchanged.
// Bounds are read once as int64 carriers (16 bytes a query), coalesced.
//
// Exact-bitmap layouts are rejected by the wrapper, as by the TPU kernel:
// their middle-of-range scan stays on the plain engine path.
#include "bloomrf.cuh"

namespace {

using bloomrf::Word;

__device__ bool range_one(const uint32_t* __restrict__ state,
                          const bloomrf::Desc& D, uint32_t L, uint32_t R) {
  if (L > R) {  // swapped bounds are allowed (L, R = min, max)
    const uint32_t t = L;
    L = R;
    R = t;
  }
  const uint32_t top = D.top();
  bool split = false, left_alive = true, right_alive = false;
  if (top < D.d()) {
    const uint32_t lt = bloomrf::shr(L, top), rt = bloomrf::shr(R, top);
    // saturated top levels: a middle gap of >= 1 top-level DI is positive
    if (rt - lt >= 2u) return true;
    split = lt != rt;
    right_alive = split;
  }
  for (int i = D.k() - 1; i >= 0; --i) {
    const uint32_t* lay = D.layer(i);
    const uint32_t li = lay[bloomrf::L_LEVEL];
    const uint32_t delta = lay[bloomrf::L_DELTA];
    const bool bottom = i == 0;
    const uint32_t edge = bottom ? 0u : 1u;
    const uint32_t Lp = bloomrf::shr(L, li), Rp = bloomrf::shr(R, li);
    const uint32_t Lpar = bloomrf::shr(L, li + delta);
    const uint32_t Rpar = bloomrf::shr(R, li + delta);

    // child words: the left pair while the left path lives; the right pair
    // while the right path lives or may split off below this layer
    Word wLA{0u, 0u}, wLB{0u, 0u}, wRA{0u, 0u}, wRB{0u, 0u};
    const bool need_l = left_alive;
    const bool need_r = right_alive || (!split && left_alive && !bottom);
    if (need_l) {
      wLA = bloomrf::load_word(state, D, i, Lpar << 1);
      wLB = bloomrf::load_word(state, D, i, (Lpar << 1) | 1u);
    }
    if (need_r && need_l && Rpar == Lpar) {
      wRA = wLA;
      wRB = wLB;
    } else if (need_r) {
      wRA = bloomrf::load_word(state, D, i, Rpar << 1);
      wRB = bloomrf::load_word(state, D, i, (Rpar << 1) | 1u);
    }

    // left path (doubles as the single pre-split path); uint32 wraps as in
    // the reference, and every wrapped bound is masked by its nonempty flag
    const uint32_t l_end = (Lpar << delta) | ((1u << delta) - 1u);
    const uint32_t l_qlo = Lp + edge;
    const uint32_t l_qhi = split ? l_end : Rp - edge;
    const bool l_nonempty =
        bottom || (split ? (Lp != l_end) : (Rp - Lp >= 2u));
    if (l_nonempty && left_alive &&
        bloomrf::children_hit(delta, Lpar, l_qlo, l_qhi, wLA, wLB))
      return true;

    // right path (only live after the split)
    const uint32_t r_start = Rpar << delta;
    const uint32_t r_qhi = Rp - edge;
    const bool r_nonempty = bottom || (Rp != r_start);
    if (r_nonempty && right_alive &&
        bloomrf::children_hit(delta, Rpar, r_start, r_qhi, wRA, wRB))
      return true;

    // covering continuation (early stop as mask AND)
    if (!bottom) {
      const bool covL = bloomrf::cov_bit(D, i, L, wLA, wLB);
      const bool covR = bloomrf::cov_bit(D, i, R, wRA, wRB);
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

__global__ void range_probe_kernel(const int64_t* __restrict__ lo,
                                   const int64_t* __restrict__ hi, int64_t n,
                                   const uint32_t* __restrict__ state,
                                   const uint32_t* __restrict__ gdesc,
                                   int desc_len, bool* __restrict__ out) {
  extern __shared__ uint32_t sdesc[];
  const bloomrf::Desc D = bloomrf::load_desc(gdesc, sdesc, desc_len);
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  out[t] = range_one(state, D, static_cast<uint32_t>(lo[t]),
                     static_cast<uint32_t>(hi[t]));
}

}  // namespace

extern "C" int bloomrf_range_probe(const int64_t* lo, const int64_t* hi,
                                   int64_t n, const uint32_t* state,
                                   const uint32_t* desc, int desc_len,
                                   bool* out, void* stream) {
  if (n <= 0) return 0;
  range_probe_kernel<<<bloomrf::grid_for(n), bloomrf::kThreads,
                       desc_len * sizeof(uint32_t),
                       static_cast<cudaStream_t>(stream)>>>(
      lo, hi, n, state, desc, desc_len, out);
  return static_cast<int>(cudaGetLastError());
}
