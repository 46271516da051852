// The warp-tile walk shared by the SUM gather+pool kernels: csr_pool_kernel
// (csr_pool.cu: K2, K3 and K4's forward) and fixedl_pool_kernel
// (gather_pool.cu: K1).
//
// A bag is pooled by a group of G threads (G a power of two, at most 32), so
// a warp pools W = 32/G bags at once: its "tile".  The bags of a tile are
// consecutive, so their entries form one contiguous range [S, E) of the ids.
// The caller gives each lane its bag's entry range [s, e) and output row.
//
// A row is read in chunks of LOAD bytes a lane: 16 for f32 and bf16 rows (one
// vector load; 4 f32 or 8 bf16 lanes), 8 or 4 for int8 rows (8 or 4 codes);
// LOAD = 0 is the scalar path, one element a lane.  int8 rows (the capacity
// mode's codes) are converted to f32 as they are added; where a 1-D f32
// scale array is given (SCALED, the "row" scale mode), each entry adds code *
// scale[id], its scale loaded beside its row, in the same batch of U loads,
// so that it puts no second dependent load on the chain.  f32 rows may be
// rounded to bf16 as they are added (ROUND_BF16, K1's instance for the
// hybrid's small set, Bf16Rounded).  Thread g of a group
// reads chunks g, g+G, g+2G, ... of each row; a row of more than 32 chunks
// takes several rounds, each walking the bag's entries again.  A lane writes
// its chunk's f32 sums as float4 stores: one at LOAD = 16 f32 and at LOAD =
// 4 int8, two at 16 bf16 and at 8 int8 (the wrapper gives int8 rows 8 where
// bags are short, 4 where they are long).
//
// Ids reach the groups in one of two walks, chosen per launch from the mean
// entries of a tile (the wrapper's choice):
// - by window (short bags, the main path): the warp goes through [S, E) in
//   windows of 32 entries, one id (and mask byte) a lane, coalesced, and
//   each group takes its bag's ids from the window by __shfl_sync;
// - by group (long bags): every group walks its own bag at the same time, in
//   rounds of G*U entries: each lane of the group loads U ids, and the group
//   shuffles them among its lanes.  A window shared by the warp would leave
//   the groups whose bags lie outside it idle: at 32 ids a bag, one group in
//   eight would work.  (Callers keep U <= 4 here: at U = 8, ids and rows
//   took 118-124 registers a lane and ran slower on an H100.)
// Either way a group issues the row loads of U entries of its bag before it
// adds any of them, so up to U independent row loads per thread are in
// flight.  Each bag is summed in entry order in f32 registers and written
// once: deterministic, no atomics.  Entries outside a lane's [s, e)
// (padding, other bags) and masked entries are never read, nor their scales.
//
// A mask (a row shard's ownership, or the dense wire's padding) drops
// entries.  How a walk treats it (Mask) follows from the kernel and walk:
// - kDrop, the compacted walk (masked K2 on both walks, K1 by group): the
//   masked entries leave the walk before any row load, so that each batch
//   of U loads is U kept entries:
//   - by window: one __ballot_sync of the window's keep flags; each group
//     takes its bag's bits of it and walks the set ones, lowest first
//     (__ffs, then clear it), so a window takes the warp's most kept
//     entries of a bag in steps, not its most entries;
//   - by group: a round's ids are loaded so that lane g of a group holds
//     entries v*G + g (v < U), so the ballot of slot v holds G consecutive
//     entries in order; each kept entry's rank is the kept count of the
//     slots before it plus a popcount of the lanes before it, and the group
//     writes its kept ids at their ranks into its span of a per-warp buffer
//     in shared memory, then reads them back U at a time: ceil(kept / U)
//     batches a round, not ceil(entries / U);
// - kFlags (K1 by window; gather_pool.cu says why): each entry's mask rides
//   through the walk as a flag, and a batch issues only its kept loads (on
//   a row shard of 4, about one load of U).
// Both sum a bag's kept entries in entry order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace pel {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 256;  // threads a block: 8 warps

// Rows are read once and never reused: read-only loads that do not
// allocate in L1.
__device__ __forceinline__ uint4 ld_row(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ uint2 ld_row8(const void* p) {
  uint2 v;
  asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned ld_row4(const void* p) {
  unsigned v;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float ld_elem(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float ld_elem(const __nv_bfloat16* p) {
  unsigned short v;
  asm("ld.global.nc.L1::no_allocate.u16 %0, [%1];" : "=h"(v) : "l"(p));
  return __uint_as_float((unsigned)v << 16);  // bf16 -> f32 is exact
}

__device__ __forceinline__ float ld_elem(const int8_t* p) {
  short v;  // sign-extended
  asm("ld.global.nc.L1::no_allocate.s8 %0, [%1];" : "=h"(v) : "l"(p));
  return (float)v;  // an int8 code is exact in f32
}

// code * scale, rounded once and never fused into the add, so that a
// bag of one entry equals the plain version's product bitwise
__device__ __forceinline__ float scaled(float code, float s) { return __fmul_rn(code, s); }

// One chunk of a row: its lanes (P), how it is loaded and added.  LOAD:
// the bytes a lane loads at once, 0 for one element.
template <typename T, int LOAD>
struct Chunk {  // scalar path (LOAD = 0): one element
  static_assert(LOAD == 0, "no chunk of LOAD bytes for this storage type");
  static constexpr int P = 1;
  using Raw = float;
  __device__ static Raw load(const T* p) { return ld_elem(p); }
  __device__ static void add(float (&acc)[P], Raw v) { acc[0] += v; }
  __device__ static void add(float (&acc)[P], Raw v, float s) { acc[0] += scaled(v, s); }
};

template <>
struct Chunk<float, 16> {
  static constexpr int P = 4;
  using Raw = uint4;
  __device__ static Raw load(const float* p) { return ld_row(p); }
  __device__ static void add(float (&acc)[P], const Raw& v) {
    acc[0] += __uint_as_float(v.x);
    acc[1] += __uint_as_float(v.y);
    acc[2] += __uint_as_float(v.z);
    acc[3] += __uint_as_float(v.w);
  }
};

template <>
struct Chunk<__nv_bfloat16, 16> {
  static constexpr int P = 8;
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) { return ld_row(p); }
  __device__ static void add2(float* acc, unsigned w) {
    acc[0] += __uint_as_float(w << 16);          // element 2i: low half
    acc[1] += __uint_as_float(w & 0xffff0000u);  // element 2i+1: high half
  }
  __device__ static void add(float (&acc)[P], const Raw& v) {
    add2(acc, v.x);
    add2(acc + 2, v.y);
    add2(acc + 4, v.z);
    add2(acc + 6, v.w);
  }
};

// Byte k of an int8 row's word w, as the signed code's f32 value.
__device__ __forceinline__ float code(unsigned w, int k) {
  return (float)(signed char)(w >> (8 * k));
}

// int8: 4 codes a lane, loaded as one 32-bit word: a lane owns 4 outputs
// and writes them with one float4 store, so a group of d/4 lanes reads
// consecutive words of a row and writes its output row in one instruction.
template <>
struct Chunk<int8_t, 4> {
  static constexpr int P = 4;
  using Raw = unsigned;
  __device__ static Raw load(const int8_t* p) { return ld_row4(p); }
  __device__ static void add(float (&acc)[P], Raw w) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += code(w, i);
  }
  __device__ static void add(float (&acc)[P], Raw w, float s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += scaled(code(w, i), s);
  }
};

// int8: 8 codes a lane (one 8-byte load, two float4 stores)
template <>
struct Chunk<int8_t, 8> {
  static constexpr int P = 8;
  using Raw = uint2;
  __device__ static Raw load(const int8_t* p) { return ld_row8(p); }
  __device__ static void add(float (&acc)[P], const Raw& v) {
    const unsigned w[2] = {v.x, v.y};
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += code(w[i / 4], i % 4);
  }
  __device__ static void add(float (&acc)[P], const Raw& v, float s) {
    const unsigned w[2] = {v.x, v.y};
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += scaled(code(w[i / 4], i % 4), s);
  }
};

// f32 rows rounded to bf16 as they are added (ROUND_BF16, K1's instance
// for the hybrid's small set): each element is rounded to the nearest bf16,
// ties to even, then widened and added in f32, so that an entry adds
// f32(bf16(w)), the value of the TPU design's one-hot product over bf16
// weights, whose output row has one nonzero term.  Loads as Chunk<float>.
template <int LOAD>
struct Bf16Rounded : Chunk<float, LOAD> {
  using Base = Chunk<float, LOAD>;
  __device__ static float rn(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
  __device__ static void add(float (&acc)[Base::P], const typename Base::Raw& v) {
    if constexpr (LOAD == 0) {
      acc[0] += rn(v);
    } else {
      acc[0] += rn(__uint_as_float(v.x));
      acc[1] += rn(__uint_as_float(v.y));
      acc[2] += rn(__uint_as_float(v.z));
      acc[3] += rn(__uint_as_float(v.w));
    }
  }
};

// Adds one loaded chunk, times its entry's scale where SCALED.
template <typename C, bool SCALED>
__device__ __forceinline__ void add_chunk(float (&acc)[C::P], const typename C::Raw& raw,
                                          float s) {
  if constexpr (SCALED)
    C::add(acc, raw, s);
  else
    C::add(acc, raw);
}

template <int P>
__device__ __forceinline__ void store_chunk(float* p, const float (&acc)[P]) {
  if constexpr (P == 1) {
    *p = acc[0];
  } else {
#pragma unroll
    for (int q = 0; q < P / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  }
}

// How a walk treats a mask (the head of this file): none (no mask, no
// per-entry load), flags through the walk (by window only), or dropped
// before the row loads (the compacted walk).
enum class Mask { kNone, kFlags, kDrop };

// One warp tile as one lane sees it.  Positions count entries from ids
// (and mask); S and E are the same in every lane.
struct Tile {
  const int* ids;             // entry e's id is ids[e]
  const unsigned char* mask;  // entry e kept where mask[e] != 0; nullptr: all (kNone: unread)
  int S, E;                   // entries of the tile's bags; E <= S: none
  int s, e;                   // this lane's bag; s == e where it has no entries
  float* dst;                 // this lane's output row; nullptr: write nothing
};

// Issues the U row loads (and where SCALED their scale loads) whose ``take``
// is set, then adds them in order.
template <typename C, int U, bool SCALED, typename T>
__device__ __forceinline__ void gather_add(float (&acc)[C::P], const T* column,
                                           const float* scale, int d, const int (&id)[U],
                                           const bool (&take)[U]) {
  typename C::Raw raw[U];
  float sc[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (take[u]) {
      raw[u] = C::load(column + (long long)id[u] * d);
      if constexpr (SCALED) sc[u] = ld_elem(scale + id[u]);
    }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (take[u]) add_chunk<C, SCALED>(acc, raw[u], SCALED ? sc[u] : 1.0f);
}

// Bits lo .. lo+n-1 of a word; none where n <= 0 (then lo may be anything).
__device__ __forceinline__ unsigned bit_span(int lo, int n) {
  return n <= 0 ? 0u : (n >= 32 ? kFull : (1u << n) - 1u) << lo;
}

// The compacted by-group walk's buffer: U ids a lane, one span of G*U a
// group, so a warp holds 32*U; 16-byte aligned for the vector reads.
template <int U>
__device__ __forceinline__ int* kept_ids() {
  __shared__ __align__(16) int slots[kBlock / 32][32 * U];
  return slots[threadIdx.x >> 5];
}

// ids[0..U-1] from U consecutive ints of shared memory, aligned to U*4
// bytes: one vector read (the by-group walk runs U = 2 or 4).
template <int U>
__device__ __forceinline__ void read_ids(const int* p, int (&id)[U]) {
  static_assert(U == 2 || U == 4, "the by-group walk reads 2 or 4 ids a batch");
  if constexpr (U == 4) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    id[0] = v.x, id[1] = v.y, id[2] = v.z, id[3] = v.w;
  } else {
    const int2 v = *reinterpret_cast<const int2*>(p);
    id[0] = v.x, id[1] = v.y;
  }
}

// SCALED: ``scale`` holds one f32 a row, indexed by the row's id.
// ROUND_BF16 (f32 rows only): each element is added as f32(bf16(w))
// (Bf16Rounded); off, the walk is the same code as without the flag.
template <typename T, int LOAD, Mask MASK, int U, bool BY_GROUP, bool SCALED,
          bool ROUND_BF16 = false>
__device__ __forceinline__ void pool_tile(const T* __restrict__ storage,
                                          const float* __restrict__ scale, int d,
                                          int group, const Tile& tile) {
  static_assert(!ROUND_BF16 || (std::is_same_v<T, float> && !SCALED),
                "bf16 rounding is an instance of unscaled f32 rows");
  static_assert(!BY_GROUP || MASK != Mask::kFlags, "by group a mask is dropped, not flagged");
  using C = std::conditional_t<ROUND_BF16, Bf16Rounded<LOAD>, Chunk<T, LOAD>>;
  constexpr int P = C::P;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (group - 1);  // this lane's place in its group
  const int first = lane - gl;        // its group's first lane
  const int chunks = d / P;

  for (int c0 = 0; c0 < chunks; c0 += group) {  // the same rounds in every lane
    const int c = c0 + gl;
    const bool on = c < chunks;
    const T* column = storage + (long long)c * P;
    float acc[P];
#pragma unroll
    for (int q = 0; q < P; ++q) acc[q] = 0.0f;

    if constexpr (!BY_GROUP && MASK == Mask::kDrop) {
      for (int base = tile.S; base < tile.E; base += 32) {  // windows of 32 entries
        const int pos = base + lane;
        const bool in = pos < tile.E;
        const int ids = in ? __ldg(tile.ids + pos) : 0;
        const bool keep = in && (tile.mask == nullptr || __ldg(tile.mask + pos) != 0);
        const int lo = max(tile.s, base) - base;           // this bag's first entry here
        const int n = min(tile.e, base + 32) - base - lo;  // its entries here (<= 0: none)
        unsigned left = __ballot_sync(kFull, keep) & bit_span(lo, n);  // its kept ones
        const int steps = (int)__reduce_max_sync(kFull, (unsigned)__popc(left));
        for (int k = 0; k < steps; k += U) {
          typename C::Raw raw[U];
          float sc[U];
          bool ok[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {  // every lane shuffles, whatever it takes
            const int id = __shfl_sync(kFull, ids, (__ffs(left) - 1) & 31);
            ok[u] = on && left != 0u;
            left &= left - 1u;  // the next kept entry
            if (ok[u]) {
              raw[u] = C::load(column + (long long)id * d);
              if constexpr (SCALED) sc[u] = ld_elem(scale + id);
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (ok[u]) add_chunk<C, SCALED>(acc, raw[u], SCALED ? sc[u] : 1.0f);
        }
      }
    } else if constexpr (BY_GROUP && MASK == Mask::kDrop) {
      int* const kept = kept_ids<U>() + first * U;  // this group's span
      const unsigned mine = group == 32 ? kFull : ((1u << group) - 1u) << first;
      const unsigned before_me = mine & ((1u << lane) - 1u);  // its lanes before this one
      const int span = group * U;  // entries of a round: U ids a lane
      const int len = tile.e - tile.s;
      const int rounds = (int)__reduce_max_sync(
          kFull, len > 0 ? (unsigned)((len + span - 1) / span) : 0u);
      for (int r = 0; r < rounds; ++r) {
        const int cursor = tile.s + r * span;
        const int n = min(tile.e - cursor, span);  // entries this round (<= 0: none)
        int ids[U];
        bool keep[U];
#pragma unroll
        for (int v = 0; v < U; ++v) {  // lane gl holds entries v*G + gl
          const int j = v * group + gl;
          ids[v] = j < n ? __ldg(tile.ids + cursor + j) : 0;
          keep[v] = j < n && (tile.mask == nullptr || __ldg(tile.mask + cursor + j) != 0);
        }
        int kept_n = 0;  // kept entries of the slots before v: the rank of the next
#pragma unroll
        for (int v = 0; v < U; ++v) {
          const unsigned bits = __ballot_sync(kFull, keep[v]) & mine;
          if (keep[v]) kept[kept_n + __popc(bits & before_me)] = ids[v];
          kept_n += __popc(bits);
        }
        __syncwarp();
        const int batches = (int)__reduce_max_sync(kFull, (unsigned)((kept_n + U - 1) / U));
        for (int q = 0; q < batches; ++q) {  // kept entries q*U .. q*U+U-1
          int id[U];
          bool take[U];
          read_ids<U>(kept + q * U, id);
#pragma unroll
          for (int v = 0; v < U; ++v) take[v] = on && q * U + v < kept_n;
          gather_add<C, U, SCALED>(acc, column, scale, d, id, take);
        }
        __syncwarp();  // every read of this round before the next round's writes
      }
    } else if constexpr (!BY_GROUP) {
      for (int base = tile.S; base < tile.E; base += 32) {  // windows of 32 entries
        const int pos = base + lane;
        const bool in = pos < tile.E;
        const int ids = in ? __ldg(tile.ids + pos) : 0;
        unsigned keep = 1u;
        if constexpr (MASK == Mask::kFlags)
          keep = in && (tile.mask == nullptr || __ldg(tile.mask + pos) != 0);
        const int lo = max(tile.s, base) - base;           // this bag's first entry here
        const int n = min(tile.e, base + 32) - base - lo;  // its entries here (<= 0: none)
        const int steps = (int)__reduce_max_sync(kFull, n > 0 ? (unsigned)n : 0u);
        for (int k = 0; k < steps; k += U) {
          typename C::Raw raw[U];
          float sc[U];
          bool ok[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {  // every lane shuffles, whatever it takes
            const int src = (lo + k + u) & 31;
            const int id = __shfl_sync(kFull, ids, src);
            bool take = on && k + u < n;
            if constexpr (MASK == Mask::kFlags) take = __shfl_sync(kFull, keep, src) != 0u && take;
            ok[u] = take;
            if (take) {
              raw[u] = C::load(column + (long long)id * d);
              if constexpr (SCALED) sc[u] = ld_elem(scale + id);
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (ok[u]) add_chunk<C, SCALED>(acc, raw[u], SCALED ? sc[u] : 1.0f);
        }
      }
    } else {
      const int span = group * U;  // entries of a round: U ids a lane
      const int len = tile.e - tile.s;
      const int rounds = (int)__reduce_max_sync(
          kFull, len > 0 ? (unsigned)((len + span - 1) / span) : 0u);
      for (int r = 0; r < rounds; ++r) {
        const int cursor = tile.s + r * span;
        const int n = min(tile.e - cursor, span);  // entries this round (<= 0: none)
        int ids[U];
#pragma unroll
        for (int v = 0; v < U; ++v) {  // lane gl holds entries gl*U .. gl*U+U-1
          const int j = gl * U + v;
          ids[v] = j < n ? __ldg(tile.ids + cursor + j) : 0;
        }
        const int batches =
            (int)__reduce_max_sync(kFull, n > 0 ? (unsigned)((n + U - 1) / U) : 0u);
        for (int q = 0; q < batches; ++q) {  // entries q*U .. q*U+U-1: lane first+q
          int id[U];
          bool take[U];
#pragma unroll
          for (int v = 0; v < U; ++v) {
            id[v] = __shfl_sync(kFull, ids[v], first + q);
            take[v] = on && q * U + v < n;
          }
          gather_add<C, U, SCALED>(acc, column, scale, d, id, take);
        }
      }
    }
    if (on && tile.dst != nullptr) store_chunk<P>(tile.dst + c * P, acc);
  }
}

// Blocks for about one wave: as many as fit on the card at once (by the
// kernel's registers), and no more than the work needs.  Cached per device.
// A negative value is minus the CUDA error of the query.
template <auto kernel>
int wave_blocks(int device, long long blocks_needed) {
  static int per_device[64] = {};
  int& cached = per_device[device & 63];
  if (cached == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return -(int)err;
    cached = (per_sm > 0 ? per_sm : 1) * sms;
  }
  return (int)(blocks_needed < cached ? blocks_needed : cached);
}

// The path and group the wrapper chose fit the storage and d.
template <typename T, int LOAD>
bool geometry_ok(const void* storage, int d, int group) {
  constexpr int P = Chunk<T, LOAD>::P;
  return d >= 1 && d % P == 0 && group >= 1 && group <= 32 &&
         (group & (group - 1)) == 0 &&
         reinterpret_cast<unsigned long long>(storage) % (LOAD > 0 ? LOAD : 1) == 0;
}

}  // namespace pel
