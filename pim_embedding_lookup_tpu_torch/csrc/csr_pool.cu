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
// at or past off[t][B] are padding.  An optional mask [T, C] (one byte an
// entry, the stride of the indices) drops the entries whose byte is 0: a
// row shard's ownership mask, so that the rows of other shards (and their
// ids, out of this shard's range) are never read.  A bag whose entries are
// all dropped pools to 0.  The backward takes the same mask: a dropped entry
// adds nothing to the gradient, and its id is never loaded (a row shard's
// gradient under autodiff).  Each table keeps its own offsets row,
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
// d=16 f32, 16 B at d=16 int8) plus a 4-byte id, and in the "row" scale mode
// of int8 storage 4 B of scale; each bag 8 B of offsets and one d-wide f32
// output row; there is one add per loaded value.  The backward also writes
// the whole dense [N, D] f32 gradient, zeroed by the caller.
//
// int8 storage (the capacity mode, which the JAX package gathers with XLA)
// has its own forward instances, as in gather_pool.cu: the codes are pooled
// in f32, and with a scale array ("row" mode) each entry adds code *
// scale[id], its scale loaded beside its row; with none ("table" mode) the
// caller multiplies the pooled output by the table's scale.  A lane takes 8
// codes (two float4 stores) where the bags are short and 4 (one float4)
// where they are long (C / B entries a bag fill a tile of the 8-byte group
// past 32), as gather_pool.cu says.  On an H100 80GB HBM3 at 700 W (the
// int8 redesign's results in PERF_APPENDIX.md, every path timed in turns in
// one run), against 16 codes a lane: the int8 Kaggle CSR "table" 7.93 ->
// 6.99 us, 32 tables x 64 bags of 120 at d=64 41.97 -> 27.85 us.
// ptxas registers, unmasked "table" / "row", by window then by group:
// 8-byte 57/64, 64/64 (24-byte spills in "row"); 4-byte 40/48, 62/62.  int8
// storage has no backward: the capacity mode serves, it does not train.
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
// The MASKED instances take the compacted walk (pool_common.cuh) on both
// walks: a row shard's dropped entries leave the walk before any row load. On
// an H100 80GB HBM3 at 700 W (PERF.md at 81231e4, section 6, the masked rows:
// a walk that carried each mask as a flag through the batches and the
// compacted one in turns; the bound counts each distinct kept row once),
// shard 0 of a ROW_HASH cut into 4, fixed-L bags: 32 x 500k x 64 bf16,
// B=8192, L=120 0.517 -> 0.414 ms, 38 -> 48 % of the bound; 8 x 2M x 128
// bf16, L=32 (K3's width) 0.0778 -> 0.0709 ms, 65 -> 72 %; by window, 8 x 2M
// x 128 f32 at L=8 and L=32 0.0464 -> 0.0433 and 0.1227 -> 0.1143 ms;
// Kaggle's pooling-1 mixture 7.48 -> 7.29 us; all kept within 2.6 %
// (compacted faster).  ptxas of the MASKED instances, by window / by group:
// f32 vector 60 / 76, bf16 vector 60 / 80, f32 scalar 40 / 64, bf16 scalar 48
// / 64; int8 "table" / "row", by window then by group: 8-byte 59/62, 64/76;
// 4-byte 40/48, 62/62; scalar 40/40, 64/48 (spills of 12-28 bytes in the
// scalar "table" by window and "row" by group instances).
//
// csr_grad_kernel (K4's backward) keeps the first design: one thread per
// (bag, lane), one f32 atomicAdd of g[bag, lane] per (entry, lane), so rows
// shared by several bags sum in an order that changes from run to run.  It
// reaches 96 % of its bound (writing the dense gradient, which the caller
// zeroes).  Its MASKED instance loads each entry's mask byte first and skips
// the entry where it is 0: a row shard's gradient, whose bound is the same
// dense write of the shard's rows.
//
// Plain C interface, loaded with ctypes.  Each launch function returns
// cudaGetLastError() after the launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

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

template <typename T, int LOAD, bool BY_GROUP, bool MASKED, bool SCALED>
__global__ void __launch_bounds__(pel::kBlock)
csr_pool_kernel(const T* __restrict__ storage, const float* __restrict__ scale,
                const int* __restrict__ indices,
                const int* __restrict__ offsets, const unsigned char* __restrict__ mask,
                float* __restrict__ out, int tables, int batch, long long capacity,
                int d, int group) {
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
    tile.mask = MASKED ? mask + t * capacity : nullptr;
    tile.dst = bag ? out + (t * batch + b0 + g) * (long long)d : nullptr;
    constexpr pel::Mask kMask = MASKED ? pel::Mask::kDrop : pel::Mask::kNone;
    pel::pool_tile<T, LOAD, kMask, kUnroll, BY_GROUP, SCALED>(storage, scale, d, group, tile);
  }
}

template <bool MASKED>
__global__ void csr_grad_kernel(const float* __restrict__ g,
                                const int* __restrict__ indices,
                                const int* __restrict__ offsets,
                                const unsigned char* __restrict__ mask,
                                float* __restrict__ dtable, int tables,
                                int batch, long long capacity, int d) {
  const long long bag = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const int lane = threadIdx.x;
  if (bag >= (long long)tables * batch) return;
  const long long t = bag / batch;
  const int b = (int)(bag - t * batch);
  const int* idx = indices + t * capacity;
  const unsigned char* keep = MASKED ? mask + t * capacity : nullptr;
  long long start, end;
  bag_range(offsets + t * (batch + 1), b, capacity, &start, &end);
  const float gv = g[bag * d + lane];
  for (long long e = start; e < end; ++e) {
    if (MASKED && !keep[e]) continue;  // dropped: its id is never loaded
    const long long row = idx[e];
    atomicAdd(dtable + row * d + lane, gv);
  }
}

// (d, bags_per_block) threads: 256 a block for d <= 256
dim3 block_of(int d) { return dim3(d, d >= 256 ? 1 : 256 / d); }

unsigned int grid_of(long long bags, const dim3& block) {
  return (unsigned int)((bags + block.y - 1) / block.y);
}

template <typename T, bool SCALED, int LOAD, bool BY_GROUP, bool MASKED>
int launch_pool(const void* storage, const void* scale, const void* indices,
                const void* offsets, const void* mask, void* out, int tables, int batch,
                long long capacity, int d, int group, int device, void* stream) {
  if (!pel::geometry_ok<T, LOAD>(storage, d, group)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int bags_per_tile = 32 / group;
  const long long tiles = (long long)tables * ((batch + bags_per_tile - 1) / bags_per_tile);
  const int warps_per_block = pel::kBlock / 32;
  const int grid =
      pel::wave_blocks<&csr_pool_kernel<T, LOAD, BY_GROUP, MASKED, SCALED>>(
          device, (tiles + warps_per_block - 1) / warps_per_block);
  if (grid < 0) return -grid;
  csr_pool_kernel<T, LOAD, BY_GROUP, MASKED, SCALED>
      <<<grid, pel::kBlock, 0, (cudaStream_t)stream>>>(
          (const T*)storage, (const float*)scale, (const int*)indices, (const int*)offsets,
          (const unsigned char*)mask, (float*)out, tables, batch, capacity, d, group);
  return (int)cudaGetLastError();
}

template <typename T, bool SCALED, int LOAD, bool MASKED>
int launch_pool(const void* storage, const void* scale, const void* indices,
                const void* offsets, const void* mask, void* out, int tables, int batch,
                long long capacity, int d, int group, int by_group, int device,
                void* stream) {
  const auto launch = by_group ? launch_pool<T, SCALED, LOAD, true, MASKED>
                               : launch_pool<T, SCALED, LOAD, false, MASKED>;
  return launch(storage, scale, indices, offsets, mask, out, tables, batch, capacity, d,
                group, device, stream);
}

// load: the bytes a lane loads from a row at once (16 for f32 and bf16 rows,
// 8 or 4 for int8 rows), or 0 for one element
template <typename T, bool SCALED, bool MASKED>
int launch_pool(const void* storage, const void* scale, const void* indices,
                const void* offsets, const void* mask, void* out, int tables, int batch,
                long long capacity, int d, int load, int group, int by_group, int device,
                void* stream) {
  using Launch = int (*)(const void*, const void*, const void*, const void*, const void*,
                         void*, int, int, long long, int, int, int, int, void*);
  Launch chosen = nullptr;
  if (load == 0) chosen = launch_pool<T, SCALED, 0, MASKED>;
  if constexpr (std::is_same_v<T, int8_t>) {
    if (load == 8) chosen = launch_pool<T, SCALED, 8, MASKED>;
    if (load == 4) chosen = launch_pool<T, SCALED, 4, MASKED>;
  } else {
    if (load == 16) chosen = launch_pool<T, SCALED, 16, MASKED>;
  }
  if (chosen == nullptr) return (int)cudaErrorInvalidValue;
  return chosen(storage, scale, indices, offsets, mask, out, tables, batch, capacity, d,
                group, by_group, device, stream);
}

// The MASKED instances run where the caller gives a mask ([T, C] bytes, an
// entry kept where its byte is set); the others take no per-entry load.
template <typename T, bool SCALED>
int launch_pool(const void* storage, const void* scale, const void* indices,
                const void* offsets, const void* mask, void* out, int tables, int batch,
                long long capacity, int d, int load, int group, int by_group, int device,
                void* stream) {
  const auto launch =
      mask == nullptr ? launch_pool<T, SCALED, false> : launch_pool<T, SCALED, true>;
  return launch(storage, scale, indices, offsets, mask, out, tables, batch, capacity, d,
                load, group, by_group, device, stream);
}

}  // namespace

extern "C" {

int pel_csr_pool_f32(const void* storage, const void* indices,
                     const void* offsets, const void* mask, void* out, int tables,
                     int batch, long long capacity, int d, int load, int group,
                     int by_group, int device, void* stream) {
  return launch_pool<float, false>(storage, nullptr, indices, offsets, mask, out, tables,
                                   batch, capacity, d, load, group, by_group, device, stream);
}

int pel_csr_pool_bf16(const void* storage, const void* indices,
                      const void* offsets, const void* mask, void* out, int tables,
                      int batch, long long capacity, int d, int load, int group,
                      int by_group, int device, void* stream) {
  return launch_pool<__nv_bfloat16, false>(storage, nullptr, indices, offsets, mask, out,
                                           tables, batch, capacity, d, load, group, by_group,
                                           device, stream);
}

// int8 codes; scale: one f32 a row ("row" mode), or NULL ("table" mode: the
// codes are pooled as they are)
int pel_csr_pool_i8(const void* storage, const void* scale, const void* indices,
                    const void* offsets, const void* mask, void* out, int tables,
                    int batch, long long capacity, int d, int load, int group,
                    int by_group, int device, void* stream) {
  const auto launch =
      scale != nullptr ? launch_pool<int8_t, true> : launch_pool<int8_t, false>;
  return launch(storage, scale, indices, offsets, mask, out, tables, batch, capacity, d,
                load, group, by_group, device, stream);
}

// mask: [T, C] bytes, an entry kept where its byte is set; NULL: none (the
// unmasked instance, which takes no per-entry load)
int pel_csr_grad_f32(const void* g, const void* indices, const void* offsets,
                     const void* mask, void* dtable, int tables, int batch,
                     long long capacity, int d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block = block_of(d);
  const auto kernel = mask != nullptr ? csr_grad_kernel<true> : csr_grad_kernel<false>;
  kernel<<<grid_of((long long)tables * batch, block), block, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const int*)indices, (const int*)offsets,
      (const unsigned char*)mask, (float*)dtable, tables, batch, capacity, d);
  return (int)cudaGetLastError();
}

const char* pel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
