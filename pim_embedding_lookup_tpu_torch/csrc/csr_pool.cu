// CSR SUM gather+pool (kernels K2 and K3, and the forward of K4) and the
// backward of K4, over fused embedding storage.
//
// Replaces, in pim_embedding_lookup_tpu/ops/pallas_lookup.py:
//   K2  _make_packed_kernel (:92) / pallas_embedding_bag_csr_packed (:390),
//   K3  _make_kernel (:48), reached through _pallas_sum_csr (:157) and
//       pallas_embedding_bag_csr_packed at d == 128,
//   K4  pallas_embedding_bag_csr (:251) -> _bag_sum (:204): its forward is
//       csr_pool_kernel on [N, D] storage, its backward (_bag_sum_bwd :230,
//       an XLA scatter-add there) is csr_grad_kernel.
//
// Indices are [T, C] (entry stride C) and offsets [T, B+1]: bag b of table t
// owns entries [off[t][b], off[t][b+1]) of row t of the indices, and entries
// at or past off[t][B] are padding.  Each table keeps its own offsets row,
// so the padding of one table never falls into a bag of the next.  Bag
// (t, b) writes output row t*B + b.
//
// Storage is [S, 128] lane-packed or [N, d]; both have the row-major bytes
// of [rows, d], so row r starts at storage + r*d whatever the pack.  The TPU
// kernels' 128-lane row fetch, lane-group select and fold are not carried
// over, nor are the per-entry segment ids: each bag walks its own offsets,
// as the reference's DPU kernel walks its bags (emb_dpu_lookup.c:106-116).
//
// Bound on the card: bytes.  Each valid entry moves one d-wide row (64 B at
// d=16 f32) plus a 4-byte id; each bag 8 B of offsets and one d-wide f32
// output row; there is one add per loaded value.  The backward also writes
// the whole dense [N, D] f32 gradient, zeroed by the caller.
//
// Design of csr_pool_kernel (the forward; pool_common.cuh has the walk).
// The first kernel ran one thread per (bag, lane): 1.31 M threads, ~5 waves
// at K2's main shape, each thread a chain of dependent loads (offsets, id,
// a 4-byte piece of the row), so time grew with waves x chain length, not
// with bytes.  Now:
// - a group of G threads pools a bag with 16-byte row loads (G = d * elem /
//   16: 4 at d=16 f32, 2 at d=16 bf16, 32 at d=128 f32) where the row bytes
//   and the storage pointer are 16-byte aligned; else one element a thread
//   (the scalar path, same walk).  The wrapper picks the path and G;
// - a warp's 32/G bags are consecutive bags of one table: lane j loads
//   off[b0 + j] (one coalesced load) and the bags' bounds move between
//   lanes by __shfl_sync;
// - their ids come 32 at a time in windows shared by the warp, or, where
//   the bags are long (C / B entries a bag fill a tile past 32), each group
//   loads and shuffles its own bag's ids (the wrapper picks the walk);
// - each bag issues the row loads of U = 4 entries before their adds;
// - a grid-stride loop over warp tiles, with a grid of one wave (blocks
//   that fit at once, from the occupancy API, times the SMs).
// One offsets -> ids -> rows chain per warp tile replaces one per thread
// per wave.  Measured on an H100 (PERF.md section 6): U = 2, 8 and 16, two
// to eight tiles in flight per warp, and a __launch_bounds__ minimum of 4
// to 8 blocks per SM were all slower (more registers, or spills).  What
// does not help: wgmma has no product to compute; TMA and bulk copies give
// nothing for independent 32-64 B rows; a sum that lives in registers needs
// no shared memory.
// ptxas (CUDA 12.8, sm_90a, -O3), by window / by group: f32 vector 64 / 64
// registers, bf16 vector 60 / 80, f32 scalar 40 / 64, bf16 scalar 48 / 64;
// no spills.
//
// csr_grad_kernel (K4's backward) keeps the first design: one thread per
// (bag, lane), one f32 atomicAdd of g[bag, lane] per (entry, lane), so rows
// shared by several bags sum in an order that changes from run to run.  It
// reaches 96 % of its bound (writing the dense gradient).
//
// Plain C interface, loaded with ctypes.  Each launch function returns
// cudaGetLastError() after the launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "pool_common.cuh"

namespace {

// Entry range [start, end) of bag b, clamped to [0, capacity].
__device__ __forceinline__ void bag_range(const int* off, int b,
                                          long long capacity, long long* start,
                                          long long* end) {
  long long s = off[b], e = off[b + 1];
  s = s < 0 ? 0 : (s > capacity ? capacity : s);
  e = e < s ? s : (e > capacity ? capacity : e);
  *start = s;
  *end = e;
}

constexpr int kUnroll = 4;  // U: row loads of a bag issued before the adds

template <typename T, bool VEC, bool BY_GROUP>
__global__ void __launch_bounds__(pel::kBlock)
csr_pool_kernel(const T* __restrict__ storage, const int* __restrict__ indices,
                const int* __restrict__ offsets, float* __restrict__ out,
                int tables, int batch, long long capacity, int d, int group) {
  const int lane = threadIdx.x & 31;
  const int bags_per_tile = 32 / group;
  const int g = lane / group;  // this lane's bag in the tile
  const long long tiles_per_table = (batch + bags_per_tile - 1) / bags_per_tile;
  const long long tiles = tiles_per_table * tables;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  // offsets are int32, so the clamped bounds fit in int
  const int cap = capacity < INT_MAX ? (int)capacity : INT_MAX;

  for (long long id = warp; id < tiles; id += warps) {
    const long long t = id / tiles_per_table;
    const int b0 = (int)(id - t * tiles_per_table) * bags_per_tile;
    const int* off = offsets + t * (batch + 1);
    const int o = __ldg(off + min(b0 + lane, batch));
    const int o_last = __ldg(off + min(b0 + 32, batch));  // the end of bag 31 when G = 1
    const int start = __shfl_sync(pel::kFull, o, g);
    const int next = __shfl_sync(pel::kFull, o, (g + 1) & 31);
    const bool bag = b0 + g < batch;
    pel::Tile tile;
    tile.s = bag ? min(max(start, 0), cap) : 0;
    tile.e = bag ? min(max(g + 1 == 32 ? o_last : next, tile.s), cap) : 0;
    if constexpr (!BY_GROUP) {  // the windows cover the tile's entries
      tile.S = (int)__reduce_min_sync(pel::kFull, bag ? (unsigned)tile.s : UINT_MAX);
      tile.E = (int)__reduce_max_sync(pel::kFull, bag ? (unsigned)tile.e : 0u);
    }
    tile.ids = indices + t * capacity;
    tile.mask = nullptr;
    tile.dst = bag ? out + (t * batch + b0 + g) * (long long)d : nullptr;
    pel::pool_tile<T, VEC, false, kUnroll, BY_GROUP>(storage, d, group, tile);
  }
}

__global__ void csr_grad_kernel(const float* __restrict__ g,
                                const int* __restrict__ indices,
                                const int* __restrict__ offsets,
                                float* __restrict__ dtable, int tables,
                                int batch, long long capacity, int d) {
  const long long bag = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const int lane = threadIdx.x;
  if (bag >= (long long)tables * batch) return;
  const long long t = bag / batch;
  const int b = (int)(bag - t * batch);
  const int* idx = indices + t * capacity;
  long long start, end;
  bag_range(offsets + t * (batch + 1), b, capacity, &start, &end);
  const float gv = g[bag * d + lane];
  for (long long e = start; e < end; ++e) {
    const long long row = idx[e];
    atomicAdd(dtable + row * d + lane, gv);
  }
}

// (d, bags_per_block) threads: 256 a block for d <= 256
dim3 block_of(int d) { return dim3(d, d >= 256 ? 1 : 256 / d); }

unsigned int grid_of(long long bags, const dim3& block) {
  return (unsigned int)((bags + block.y - 1) / block.y);
}

template <typename T, bool VEC, bool BY_GROUP>
int launch_pool(const void* storage, const void* indices, const void* offsets,
                void* out, int tables, int batch, long long capacity, int d,
                int group, int device, void* stream) {
  if (!pel::geometry_ok<T, VEC>(storage, d, group)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int bags_per_tile = 32 / group;
  const long long tiles = (long long)tables * ((batch + bags_per_tile - 1) / bags_per_tile);
  const int warps_per_block = pel::kBlock / 32;
  const int grid = pel::wave_blocks<&csr_pool_kernel<T, VEC, BY_GROUP>>(
      device, (tiles + warps_per_block - 1) / warps_per_block);
  if (grid < 0) return -grid;
  csr_pool_kernel<T, VEC, BY_GROUP><<<grid, pel::kBlock, 0, (cudaStream_t)stream>>>(
      (const T*)storage, (const int*)indices, (const int*)offsets, (float*)out,
      tables, batch, capacity, d, group);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pool(const void* storage, const void* indices, const void* offsets,
                void* out, int tables, int batch, long long capacity, int d,
                int vec, int group, int by_group, int device, void* stream) {
  const auto launch = vec ? (by_group ? launch_pool<T, true, true> : launch_pool<T, true, false>)
                          : (by_group ? launch_pool<T, false, true> : launch_pool<T, false, false>);
  return launch(storage, indices, offsets, out, tables, batch, capacity, d, group, device,
                stream);
}

}  // namespace

extern "C" {

int pel_csr_pool_f32(const void* storage, const void* indices,
                     const void* offsets, void* out, int tables, int batch,
                     long long capacity, int d, int vec, int group, int by_group,
                     int device, void* stream) {
  return launch_pool<float>(storage, indices, offsets, out, tables, batch,
                            capacity, d, vec, group, by_group, device, stream);
}

int pel_csr_pool_bf16(const void* storage, const void* indices,
                      const void* offsets, void* out, int tables, int batch,
                      long long capacity, int d, int vec, int group, int by_group,
                      int device, void* stream) {
  return launch_pool<__nv_bfloat16>(storage, indices, offsets, out, tables,
                                    batch, capacity, d, vec, group, by_group,
                                    device, stream);
}

int pel_csr_grad_f32(const void* g, const void* indices, const void* offsets,
                     void* dtable, int tables, int batch, long long capacity,
                     int d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block = block_of(d);
  csr_grad_kernel<<<grid_of((long long)tables * batch, block), block, 0,
                    (cudaStream_t)stream>>>(
      (const float*)g, (const int*)indices, (const int*)offsets,
      (float*)dtable, tables, batch, capacity, d);
  return (int)cudaGetLastError();
}

const char* pel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
