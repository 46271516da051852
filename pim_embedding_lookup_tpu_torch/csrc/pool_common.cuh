// The warp-tile walk shared by the SUM gather+pool kernels: csr_pool_kernel
// (csr_pool.cu: K2, K3 and K4's forward) and fixedl_pool_kernel
// (gather_pool.cu: K1).
//
// A bag is pooled by a group of G threads (G a power of two, at most 32), so
// a warp pools W = 32/G bags at once: its "tile".  The bags of a tile are
// consecutive, so their entries form one contiguous range [S, E) of the ids.
// The caller gives each lane its bag's entry range [s, e) and output row.
//
// A row is read in chunks: 16 bytes (one vector load; 4 f32 or 8 bf16 lanes)
// on the vector path, one element on the scalar path.  Thread g of a group
// reads chunks g, g+G, g+2G, ... of each row; a row of more than 32 chunks
// takes several rounds, each walking the bag's entries again.
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
// (padding, other bags) and masked entries are never read.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

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

// One chunk of a row: its lanes (P), how it is loaded and added.
template <typename T, bool VEC>
struct Chunk {  // scalar path: one element
  static constexpr int P = 1;
  using Raw = float;
  __device__ static Raw load(const T* p) { return ld_elem(p); }
  __device__ static void add(float (&acc)[P], Raw v) { acc[0] += v; }
};

template <>
struct Chunk<float, true> {
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
struct Chunk<__nv_bfloat16, true> {
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

// One warp tile as one lane sees it.  Positions count entries from ids
// (and mask); S and E are the same in every lane.
struct Tile {
  const int* ids;             // entry e's id is ids[e]
  const unsigned char* mask;  // MASKED: entry e is kept where mask[e] != 0; nullptr: all
  int S, E;                   // entries of the tile's bags; E <= S: none
  int s, e;                   // this lane's bag; s == e where it has no entries
  float* dst;                 // this lane's output row; nullptr: write nothing
};

// Issues the U row loads whose ``take`` is set, then adds them in order.
template <typename C, int U, typename T>
__device__ __forceinline__ void gather_add(float (&acc)[C::P], const T* column, int d,
                                           const int (&id)[U], const bool (&take)[U]) {
  typename C::Raw raw[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (take[u]) raw[u] = C::load(column + (long long)id[u] * d);
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (take[u]) C::add(acc, raw[u]);
}

template <typename T, bool VEC, bool MASKED, int U, bool BY_GROUP>
__device__ __forceinline__ void pool_tile(const T* __restrict__ storage, int d,
                                          int group, const Tile& tile) {
  using C = Chunk<T, VEC>;
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

    if constexpr (!BY_GROUP) {
      for (int base = tile.S; base < tile.E; base += 32) {  // windows of 32 entries
        const int pos = base + lane;
        const bool in = pos < tile.E;
        const int ids = in ? __ldg(tile.ids + pos) : 0;
        unsigned keep = 1u;
        if constexpr (MASKED)
          keep = in && (tile.mask == nullptr || __ldg(tile.mask + pos) != 0);
        const int lo = max(tile.s, base) - base;           // this bag's first entry here
        const int n = min(tile.e, base + 32) - base - lo;  // its entries here (<= 0: none)
        const int steps = (int)__reduce_max_sync(kFull, n > 0 ? (unsigned)n : 0u);
        for (int k = 0; k < steps; k += U) {
          typename C::Raw raw[U];
          bool ok[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {  // every lane shuffles, whatever it takes
            const int src = (lo + k + u) & 31;
            const int id = __shfl_sync(kFull, ids, src);
            bool take = on && k + u < n;
            if constexpr (MASKED) take = __shfl_sync(kFull, keep, src) != 0u && take;
            ok[u] = take;
            if (take) raw[u] = C::load(column + (long long)id * d);
          }
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (ok[u]) C::add(acc, raw[u]);
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
        unsigned keep[U];
#pragma unroll
        for (int v = 0; v < U; ++v) {  // lane gl holds entries gl*U .. gl*U+U-1
          const int j = gl * U + v;
          ids[v] = j < n ? __ldg(tile.ids + cursor + j) : 0;
          keep[v] = 1u;
          if constexpr (MASKED)
            keep[v] = j < n && (tile.mask == nullptr || __ldg(tile.mask + cursor + j) != 0);
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
            if constexpr (MASKED)
              take[v] = __shfl_sync(kFull, keep[v], first + q) != 0u && take[v];
          }
          gather_add<C, U>(acc, column, d, id, take);
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
template <typename T, bool VEC>
bool geometry_ok(const void* storage, int d, int group) {
  constexpr int P = Chunk<T, VEC>::P;
  return d >= 1 && d % P == 0 && group >= 1 && group <= 32 &&
         (group & (group - 1)) == 0 &&
         (!VEC || (reinterpret_cast<unsigned long long>(storage) & 15) == 0);
}

}  // namespace pel
