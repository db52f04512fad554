// bloomRF partitioned point and range probes for Hopper (filters above the
// resident budget).
//
// Replaces the Pallas TPU kernels
//   B7  repro/kernels/probe.py::point_probe_partitioned
//       (body _partitioned_kernel, then an XLA scatter-min per key), and
//   B8  repro/kernels/rangeprobe.py::range_probe_partitioned
//       (body _gather_block_kernel, then an XLA scatter back to (B, A)).
// On the TPU each tile of 512 probe slots DMAs its whole 64 KiB filter
// block into VMEM.  Staging 64 KiB for 512 probes would move 128 bytes a
// probe here, where a direct load moves one 32-byte sector, so both kernels
// read each probe's lane straight from device memory through L2.  The
// probes arrive bucketed by block (kernels/probe.py::_bucket_probes, the
// reference's slot layout): a warp's loads fall in one 64 KiB block and
// share L2 lines.  Each lane is addressed as the reference addresses it,
// its tile's block base plus its offset in the block; for a real slot that
// is the lane itself, so no padded copy of the state is needed.
//
// Bound: scattered 4-byte reads, one per real slot; padding slots (lane < 0)
// return at once.  One thread per slot.
//
// B7 fuses the reference's scatter-min: `acc` (uint8[B + 1], all 1) loses
// its key's 1 when a probe's bit is 0.  Every such store writes the same
// value, so the race between a key's probes is benign and needs no atomic.
// B8 fuses the scatter back: each slot writes its lane to its own index of
// the (B, A) word matrix `g` (int32[B * A + 1]); each index occurs once.
#include "bloomrf.cuh"

namespace {

__device__ __forceinline__ uint32_t load_lane(
    const uint32_t* __restrict__ state, const int32_t* __restrict__ tile_block,
    int64_t t, int tile, int block_u32, int32_t lane) {
  const uint32_t* block =
      state + static_cast<int64_t>(tile_block[t / tile]) * block_u32;
  return __ldg(block + lane % block_u32);
}

__global__ void point_partitioned_kernel(
    const int32_t* __restrict__ lanes, const int32_t* __restrict__ sh,
    const int32_t* __restrict__ keyid, const int32_t* __restrict__ tile_block,
    int64_t n, int tile, int block_u32, const uint32_t* __restrict__ state,
    uint8_t* __restrict__ acc) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int32_t lane = lanes[t];
  if (lane < 0) return;
  const uint32_t w = load_lane(state, tile_block, t, tile, block_u32, lane);
  if (((w >> (static_cast<uint32_t>(sh[t]) & 31u)) & 1u) == 0u) {
    acc[keyid[t]] = 0;
  }
}

__global__ void range_partitioned_kernel(
    const int32_t* __restrict__ lanes, const int32_t* __restrict__ flat,
    const int32_t* __restrict__ tile_block, int64_t n, int tile,
    int block_u32, const uint32_t* __restrict__ state,
    uint32_t* __restrict__ g) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int32_t lane = lanes[t];
  if (lane < 0) return;
  g[flat[t]] = load_lane(state, tile_block, t, tile, block_u32, lane);
}

}  // namespace

extern "C" int bloomrf_point_partitioned(const int32_t* lanes,
                                         const int32_t* sh,
                                         const int32_t* keyid,
                                         const int32_t* tile_block, int64_t n,
                                         int tile, int block_u32,
                                         const uint32_t* state, uint8_t* acc,
                                         void* stream) {
  if (n <= 0) return 0;
  point_partitioned_kernel<<<bloomrf::grid_for(n), bloomrf::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      lanes, sh, keyid, tile_block, n, tile, block_u32, state, acc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bloomrf_range_partitioned(const int32_t* lanes,
                                         const int32_t* flat,
                                         const int32_t* tile_block, int64_t n,
                                         int tile, int block_u32,
                                         const uint32_t* state, uint32_t* g,
                                         void* stream) {
  if (n <= 0) return 0;
  range_partitioned_kernel<<<bloomrf::grid_for(n), bloomrf::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      lanes, flat, tile_block, n, tile, block_u32, state, g);
  return static_cast<int>(cudaGetLastError());
}
