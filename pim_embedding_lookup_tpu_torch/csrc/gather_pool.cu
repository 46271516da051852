// Fixed-L SUM gather+pool over fused embedding storage (kernel K1).
//
// Replaces the Pallas kernel _make_fixedl_kernel / pallas_embedding_bag_fixedl
// (pim_embedding_lookup_tpu/ops/pallas_lookup.py:272-387).  Bag b sums the
// rows of entries b*L .. b*L+L-1 whose mask is set, in f32, into out[b, :].
//
// Storage is [S, 128] lane-packed or [N, d]; both have the row-major bytes of
// [rows, d], so row r starts at storage + r*d whatever the pack.  The TPU
// kernel's 128-lane row fetch plus lane-group select is not carried over.
//
// Bound on the card: bytes.  Each entry moves one d-wide row (64 B at d=16
// f32) plus 4 B of id and 1 B of mask; there is one add per loaded value.
//
// Design (pool_common.cuh has the walk, shared with csr_pool.cu).  The first
// kernel ran one thread per (bag, lane), ~5 waves at the main shape, each
// thread waiting on mask and id before a 4-byte piece of the row.  Now:
// - a group of G threads pools a bag with 16-byte row loads (G = d * elem /
//   16) where the row bytes and the storage pointer are 16-byte aligned;
//   else one element a thread (the scalar path).  The wrapper picks both;
// - a warp's 32/G bags own one contiguous bag-major range of ids and mask
//   bytes, loaded 32 at a time, coalesced, and passed between lanes by
//   __shfl_sync; where a tile holds more than 32 entries (L * 32/G > 32),
//   each group loads and shuffles its own bag's instead (the wrapper picks
//   the walk).  Masked rows are skipped without being read;
// - a bag's row loads are issued before their adds, min(L, 8) at a time
//   (U = 1, 2, 4 or 8; 4 at most by group), looping beyond that;
// - a grid-stride loop over tiles, with a grid of one wave (blocks that fit
//   at once, from the occupancy API, times the SMs).
// What does not help: wgmma has no product to compute; TMA and bulk copies
// give nothing for independent 32-64 B rows; a sum that lives in registers
// needs no shared memory.  ptxas (CUDA 12.8, sm_90a, -O3), registers at
// U = 1 / 2 / 4 / 8 by window, then U = 2 / 4 by group: f32 vector
// 40 / 60 / 63 / 80, 61 / 76; bf16 vector 40 / 48 / 60 / 80, 58 / 80; f32
// scalar 32 / 40 / 48 / 48, 48 / 60; bf16 scalar 40 / 40 / 48 / 48, 48 /
// 60.  Spills of 16-36 bytes in f32 vector U=1 (the single-hot main path),
// f32 scalar U=1 and bf16 scalar U=2 (both walks); none elsewhere.
//
// Plain C interface, loaded with ctypes.  Each launch function returns
// cudaGetLastError() after the launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "pool_common.cuh"

namespace {

template <typename T, bool VEC, int U, bool BY_GROUP>
__global__ void __launch_bounds__(pel::kBlock)
fixedl_pool_kernel(const T* __restrict__ storage, const int* __restrict__ indices,
                   const unsigned char* __restrict__ mask, float* __restrict__ out,
                   long long bags, int pooling, int d, int group) {
  const int lane = threadIdx.x & 31;
  const int bags_per_tile = 32 / group;
  const int g = lane / group;  // this lane's bag in the tile
  const long long tiles = (bags + bags_per_tile - 1) / bags_per_tile;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;

  for (long long id = warp; id < tiles; id += warps) {
    const long long b0 = id * bags_per_tile;
    const int in_tile = (int)min((long long)bags_per_tile, bags - b0);
    const bool bag = g < in_tile;
    pel::Tile tile;  // positions count from the tile's first entry
    tile.ids = indices + b0 * pooling;
    tile.mask = mask == nullptr ? nullptr : mask + b0 * pooling;
    tile.S = 0;
    tile.E = in_tile * pooling;
    tile.s = bag ? g * pooling : 0;
    tile.e = bag ? (g + 1) * pooling : 0;
    tile.dst = bag ? out + (b0 + g) * d : nullptr;
    pel::pool_tile<T, VEC, true, U, BY_GROUP>(storage, d, group, tile);
  }
}

template <typename T, bool VEC, int U, bool BY_GROUP>
int launch(const void* storage, const void* indices, const void* mask,
           void* out, long long bags, int pooling, int d, int group, int device,
           void* stream) {
  if (!pel::geometry_ok<T, VEC>(storage, d, group)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int bags_per_tile = 32 / group;
  const long long tiles = (bags + bags_per_tile - 1) / bags_per_tile;
  const int warps_per_block = pel::kBlock / 32;
  const int grid = pel::wave_blocks<&fixedl_pool_kernel<T, VEC, U, BY_GROUP>>(
      device, (tiles + warps_per_block - 1) / warps_per_block);
  if (grid < 0) return -grid;
  fixedl_pool_kernel<T, VEC, U, BY_GROUP>
      <<<grid, pel::kBlock, 0, (cudaStream_t)stream>>>(
          (const T*)storage, (const int*)indices, (const unsigned char*)mask,
          (float*)out, bags, pooling, d, group);
  return (int)cudaGetLastError();
}

// U: the row loads of min(L, 8) entries of a bag (rounded up to a power of
// two; at most 4 by group) go out before their adds.  A single-hot tile
// (32 / G entries) is always one window.
template <typename T, bool VEC>
int launch(const void* storage, const void* indices, const void* mask,
           void* out, long long bags, int pooling, int d, int group, int by_group,
           int device, void* stream) {
  using Launch = int (*)(const void*, const void*, const void*, void*, long long, int, int,
                         int, int, void*);
  const Launch chosen =
      pooling == 1   ? launch<T, VEC, 1, false>
      : pooling == 2 ? (by_group ? launch<T, VEC, 2, true> : launch<T, VEC, 2, false>)
      : by_group     ? launch<T, VEC, 4, true>
      : pooling <= 4 ? launch<T, VEC, 4, false>
                     : launch<T, VEC, 8, false>;
  return chosen(storage, indices, mask, out, bags, pooling, d, group, device, stream);
}

template <typename T>
int launch(const void* storage, const void* indices, const void* mask,
           void* out, long long bags, int pooling, int d, int vec, int group,
           int by_group, int device, void* stream) {
  return vec ? launch<T, true>(storage, indices, mask, out, bags, pooling, d, group,
                               by_group, device, stream)
             : launch<T, false>(storage, indices, mask, out, bags, pooling, d, group,
                                by_group, device, stream);
}

}  // namespace

extern "C" {

int pel_gather_pool_f32(const void* storage, const void* indices,
                        const void* mask, void* out, long long bags,
                        int pooling, int d, int vec, int group, int by_group,
                        int device, void* stream) {
  return launch<float>(storage, indices, mask, out, bags, pooling, d, vec, group,
                       by_group, device, stream);
}

int pel_gather_pool_bf16(const void* storage, const void* indices,
                         const void* mask, void* out, long long bags,
                         int pooling, int d, int vec, int group, int by_group,
                         int device, void* stream) {
  return launch<__nv_bfloat16>(storage, indices, mask, out, bags, pooling, d, vec,
                               group, by_group, device, stream);
}

const char* pel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
