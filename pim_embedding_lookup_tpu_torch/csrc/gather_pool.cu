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
// f32, 16 B at d=16 int8) plus 4 B of id and 1 B of mask, and in the "row"
// scale mode of int8 storage 4 B of scale; there is one add per loaded value.
//
// int8 storage (the capacity mode: int8 codes, the JAX package's int8 dict
// storage, which it gathers with XLA) has its own instances: the codes are
// pooled in f32.  With a scale array ("row" mode) each entry adds code *
// scale[id], its scale loaded in the same batch as its row; with none
// ("table" mode) the caller multiplies the pooled output by the table's
// scale.  Bound: bytes, and at d=16 mostly the f32 output (64 B a bag
// against 16 B of codes), so a lane is chosen by its output:
// - short bags (a tile of the 8-byte group walks by window): 8 codes a lane
//   (one 8-byte load, two float4 stores), G = d/8;
// - long bags: 4 codes a lane (one 32-bit load, one float4 store), G = d/4,
//   twice the threads on each bag's chain of loads.
// A group's lanes read consecutive words of a row, so a warp instruction
// asks for the same sectors as a 16-byte load.  16 codes a lane (four
// float4 stores 64 B apart) gave a group of one thread a bag at d=16, a
// quarter of the f32 path's warps, and at L=120, d=64 a grid on 32 of the
// 132 SMs.  On an H100 80GB HBM3 at 700 W (the int8 redesign's results,
// word for word in PERF_APPENDIX.md, every path timed in turns in one run)
// the 8-byte loads were the fastest int8 path at L=1 (Kaggle "table": 16
// codes a lane 7.25 us, 8 codes 5.97, under f32 K1's 6.47 in the same
// turns) and the 4-byte ones at L=120 (42.20 -> 26.76 us); between them (L
// = 2, 3, 4, 8, 16 at d = 16 and 64, the crossover table there) the
// wrapper's pick was within 2.4 % of the faster of the two.  Transposed
// stores (16-byte loads whose sums four lanes exchange by shuffles) and the
// scale loaded by a group's first lane and shuffled were measured too and
// lost.  ptxas registers of the int8 instances, "table" / "row", U = 1 / 2 / 4
// / 8 by window, then U = 2 / 4 by group: 8-byte 40/40, 48/48, 48/60, 64/71,
// 55/62, 64/64; 4-byte 36/40, 40/48, 40/48, 56/64, 52/52, 62/54; scalar 40/32,
// 40/40, 48/40, 48/48, 48/39, 48/56 (spills of 16-20 bytes in "row" scalar U=1,
// and U=2 by group).
//
// The hybrid's small set has an f32 instance of its own (ROUND_BF16,
// pel_gather_pool_f32_bf16r): each loaded element is rounded to bf16
// (nearest, ties to even) and widened before its add, so an entry adds
// f32(bf16(w[id])), what the TPU design's bf16 one-hot product gives; at L=1
// the pooled row is that product's row bit for bit.  It replaces the one-hot
// product, which on the H100 wrote a zeroed [G, B, rows] bf16 operand (2.1 GB
// at Kaggle's B=65536) to pool rows that a gather reads in 64 bytes each. The
// walk and the loads are the f32 instance's; off, the flag compiles to the
// same code.  ptxas (CUDA 12.8, sm_90a), registers of its instances at U = 1 /
// 2 / 4 / 8 by window, then U = 2 / 4 by group: vector 39 / 48 / 60 / 80, 58
// / 63; scalar 40 / 40 / 40 / 40, 40 / 48.  Spills of 16-32 bytes at vector U
// = 8 and U = 4 by group, scalar U = 8 and U = 2 by group; none on the
// single-hot path (the unflagged f32 instance spills 16 bytes there).
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
// needs no shared memory.  ptxas (CUDA 12.8, sm_90a, -O3), registers at U = 1 /
// 2 / 4 / 8 by window, then U = 2 / 4 by group: f32 vector 40 / 60 / 63 / 80,
// 64 / 74; bf16 vector 40 / 48 / 60 / 80, 58 / 80; f32 scalar 32 / 40 / 48 /
// 48, 48 / 48; bf16 scalar 40 / 40 / 48 / 48, 56 / 56.  Spills of 16-36 bytes
// in f32 vector U=1 (the single-hot main path) and U=2 by group, f32 scalar U=1
// and bf16 scalar U=2 by window; none elsewhere.
//
// The masked walk.  K1 always takes a mask (a row shard's ownership, or the
// dense wire's padding), and "K1" and "K1 masked" in PERF.md are this one
// kernel.  By group it runs the compacted walk (pool_common.cuh), which drops
// masked entries before any row load; a walk that carried each entry's mask
// as a flag through the batches left a bag of 120 on a row shard of 4 waiting
// on 30 batches of about one row load each.  On an H100 80GB HBM3 at 700 W
// (PERF.md at 81231e4, section 6, the masked rows, flags and compacted in
// turns; the bound counts each distinct kept row once), shard 0 of a ROW_HASH
// cut into 4 (1 in 4 kept): cli bench's random shape (32 x 500k x 64 bf16,
// B=8192, L=120) 0.590 -> 0.414 ms, 34 -> 48 % of the bound; bigtable's (8 x
// 2M x 128 bf16, L=32) 0.0858 -> 0.0704 ms, 59 -> 72 %; all kept within 0.3 %
// (random 43 %, bigtable 79 %).  By window it runs the flags walk (launch
// below says why).
//
// Plain C interface, loaded with ctypes.  Each launch function returns
// cudaGetLastError() after the launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "pool_common.cuh"

namespace {

template <typename T, int LOAD, int U, bool BY_GROUP, bool SCALED, bool ROUND>
__global__ void __launch_bounds__(pel::kBlock)
fixedl_pool_kernel(const T* __restrict__ storage, const float* __restrict__ scale,
                   const int* __restrict__ indices, const unsigned char* __restrict__ mask,
                   float* __restrict__ out, long long bags, int pooling, int d, int group) {
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
    constexpr pel::Mask kMask = BY_GROUP ? pel::Mask::kDrop : pel::Mask::kFlags;
    pel::pool_tile<T, LOAD, kMask, U, BY_GROUP, SCALED, ROUND>(storage, scale, d, group, tile);
  }
}

template <typename T, bool SCALED, bool ROUND, int LOAD, int U, bool BY_GROUP>
int launch(const void* storage, const void* scale, const void* indices, const void* mask,
           void* out, long long bags, int pooling, int d, int group, int device,
           void* stream) {
  if (!pel::geometry_ok<T, LOAD>(storage, d, group)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int bags_per_tile = 32 / group;
  const long long tiles = (bags + bags_per_tile - 1) / bags_per_tile;
  const int warps_per_block = pel::kBlock / 32;
  const int grid =
      pel::wave_blocks<&fixedl_pool_kernel<T, LOAD, U, BY_GROUP, SCALED, ROUND>>(
          device, (tiles + warps_per_block - 1) / warps_per_block);
  if (grid < 0) return -grid;
  fixedl_pool_kernel<T, LOAD, U, BY_GROUP, SCALED, ROUND>
      <<<grid, pel::kBlock, 0, (cudaStream_t)stream>>>(
          (const T*)storage, (const float*)scale, (const int*)indices,
          (const unsigned char*)mask, (float*)out, bags, pooling, d, group);
  return (int)cudaGetLastError();
}

// U: the row loads of min(L, 8) entries of a bag (rounded up to a power of
// two; at most 4 by group) go out before their adds.  By window K1 runs the
// flags walk.  Its bags are fixed-length and at most 32 entries there (a
// tile fits a window), so compaction saves a batch only at L > U = 8, which
// needs G >= 16; and the compacted U=8 instance took 88 registers against
// 80 (2 blocks an SM against 3).  On an H100 (PERF.md at 81231e4) it was
// 1.38x slower than the flags walk at f32 d=128, L=8, 1 entry in 4 kept,
// and 2-3 % slower at L=32; nothing measured gained.  The compacted
// by-window walk serves masked K2, whose bags vary.
template <typename T, bool SCALED, bool ROUND, int LOAD>
int launch(const void* storage, const void* scale, const void* indices, const void* mask,
           void* out, long long bags, int pooling, int d, int group, int by_group,
           int device, void* stream) {
  using Launch = int (*)(const void*, const void*, const void*, const void*, void*,
                         long long, int, int, int, int, void*);
  const Launch chosen =
      pooling == 1   ? launch<T, SCALED, ROUND, LOAD, 1, false>
      : pooling == 2 ? (by_group ? launch<T, SCALED, ROUND, LOAD, 2, true>
                                 : launch<T, SCALED, ROUND, LOAD, 2, false>)
      : by_group     ? launch<T, SCALED, ROUND, LOAD, 4, true>
      : pooling <= 4 ? launch<T, SCALED, ROUND, LOAD, 4, false>
                     : launch<T, SCALED, ROUND, LOAD, 8, false>;
  return chosen(storage, scale, indices, mask, out, bags, pooling, d, group, device, stream);
}

// load: the bytes a lane loads from a row at once (16 for f32 and bf16 rows,
// 8 or 4 for int8 rows), or 0 for one element
template <typename T, bool SCALED, bool ROUND = false>
int launch(const void* storage, const void* scale, const void* indices, const void* mask,
           void* out, long long bags, int pooling, int d, int load, int group,
           int by_group, int device, void* stream) {
  using Launch = int (*)(const void*, const void*, const void*, const void*, void*,
                         long long, int, int, int, int, int, void*);
  Launch chosen = nullptr;
  if (load == 0) chosen = launch<T, SCALED, ROUND, 0>;
  if constexpr (std::is_same_v<T, int8_t>) {
    if (load == 8) chosen = launch<T, SCALED, ROUND, 8>;
    if (load == 4) chosen = launch<T, SCALED, ROUND, 4>;
  } else {
    if (load == 16) chosen = launch<T, SCALED, ROUND, 16>;
  }
  if (chosen == nullptr) return (int)cudaErrorInvalidValue;
  return chosen(storage, scale, indices, mask, out, bags, pooling, d, group, by_group, device,
                stream);
}

}  // namespace

extern "C" {

int pel_gather_pool_f32(const void* storage, const void* indices,
                        const void* mask, void* out, long long bags,
                        int pooling, int d, int load, int group, int by_group,
                        int device, void* stream) {
  return launch<float, false>(storage, nullptr, indices, mask, out, bags, pooling, d, load,
                              group, by_group, device, stream);
}

// f32 rows, each element rounded to bf16 (nearest, ties to even) and
// widened before it is added: the hybrid's small set
int pel_gather_pool_f32_bf16r(const void* storage, const void* indices,
                              const void* mask, void* out, long long bags,
                              int pooling, int d, int load, int group, int by_group,
                              int device, void* stream) {
  return launch<float, false, true>(storage, nullptr, indices, mask, out, bags, pooling, d,
                                    load, group, by_group, device, stream);
}

int pel_gather_pool_bf16(const void* storage, const void* indices,
                         const void* mask, void* out, long long bags,
                         int pooling, int d, int load, int group, int by_group,
                         int device, void* stream) {
  return launch<__nv_bfloat16, false>(storage, nullptr, indices, mask, out, bags, pooling,
                                      d, load, group, by_group, device, stream);
}

// int8 codes; scale: one f32 a row ("row" mode), or NULL ("table" mode: the
// codes are pooled as they are)
int pel_gather_pool_i8(const void* storage, const void* scale, const void* indices,
                       const void* mask, void* out, long long bags, int pooling, int d,
                       int load, int group, int by_group, int device, void* stream) {
  const auto chosen = scale != nullptr ? launch<int8_t, true> : launch<int8_t, false>;
  return chosen(storage, scale, indices, mask, out, bags, pooling, d, load, group, by_group,
                device, stream);
}

const char* pel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
