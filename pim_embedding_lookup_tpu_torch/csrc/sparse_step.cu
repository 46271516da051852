// The sparse optimizer step of an embedding collection on the dense wire
// (row-wise AdaGrad or SGD), both sets of the hybrid in two launches.
//
// Replaces the eager PyTorch step (ops/sparse_step.py's plain version, the
// JAX package's XLA scatters): per bucket of the small set ~20 operations,
// and per set copies of the selected ids, mask and cotangents and a
// [T*B*L, D] expansion of every entry's cotangent.  Here an entry (t, c) of
// the caller's [T, B*L] ids reads its bag's cotangent row g[c / L, t, :] of
// the [B, T, D] f32 cotangent in place; nothing is copied or expanded.  On
// a mesh the caller passes the whole batch, gathered over the data axis,
// and each process steps what it holds: the replicated small set whole,
// and of the big set the rows its row shard owns (SHARDED, below).
//
// Each table belongs to one of two sets, and the set decides its step:
// - the small set (the hybrid's bucketed tables; their rows lie in a
//   storage of their own) takes the densified step: every row's cotangents
//   are summed first, then every row of the set steps once,
//     acc[r] += sum_e mean_d(g_e^2);  w[r] = (f32(w[r]) - lr * rsqrt(acc[r] + eps) * sum_e g_e).to(dtype)
//   (SGD: w[r] - lr * sum_e g_e), which is the JAX package's one-hot
//   product step;
// - the big set takes the entry-wise step: every entry first adds
//   mean_d(g_e^2) to acc[row], then adds -lr * rsqrt(acc[row] + eps) * g_e
//   (SGD: -lr * g_e) to its row.
// Every entry's square must have landed in acc before any entry reads it
// (a row of the big set's tables of 12-15k rows is hit about 5 times at
// B=65536): the boundary between the two launches guarantees that.
//
// Launch 1 (accumulate), after one memset of the small set's f32 workspace
// [rows, D] of cotangent sums and [rows] of square means:
// - small tables whose sums fit shared memory (the wrapper's rule: at d=16
//   those of at most 32 padded rows, a copy a warp in 32 KiB; at d=128
//   those of at most 64, one copy a block in 48 KiB) are summed there.  With
//   a copy a warp (COPIES = kWarps) a block takes 2048 entries of one table,
//   each warp adds into its own copy, the groups of a warp one after
//   another (so no two lanes add to one word at once, and nothing spins).
//   With one copy a block (COPIES = 1; rows a warp wide, so a warp holds
//   only 2 entries at once) a block takes 512 entries and its warps add by
//   shared atomics: at terabyte-train-2x2's shape 512 took the first launch
//   to 0.317 ms, 2048 to 0.454, 8192 to 1.57, global atomics to 0.663 (an
//   H100 at 700 W).  The block then adds the sum of its copies to the
//   workspace, one f32 atomic per (row, column).  Kaggle's 3-row table
//   would otherwise take its 65,536 entries into 3 rows by global atomics
//   that serialise there;
// - the other small tables add each entry's cotangent to the workspace row
//   with one float4 atomic a lane (red.global.add.v4.f32), and its square
//   mean with one f32 atomic (4096- and 8192-row tables see 8-16 entries a
//   row at B=65536);
// - with row AdaGrad the big set's entries add their square means to acc.
// Launch 2 (apply): every small-set row steps once from the workspace, and
// every big-set entry adds its step to its row with vector atomics (f32:
// float4; bf16: two bf16x2, each add rounded to bf16 as the eager step's
// bf16 index_add_ rounds it).  Rows of the small set no entry touched
// subtract an exact zero and keep their bits; rows of the big set no entry
// touched are not written.
//
// A group of G lanes (G = the row's 4-float chunks rounded up to a power of
// two, at most 32; 4 at d=16) takes a row, or 2 entries at once, each lane
// its chunks k, k + G, ...  The 2 entries' cotangent rows and mask bytes
// are loaded together, then their ids.  A masked entry is skipped before
// its id is read (on the dense wire a masked id may hold anything), and an
// entry whose row lies outside its table's padded rows (small set) or the
// set's storage (big set) is dropped, as the eager step drops it.  On a
// mesh (the SHARDED instance) a big entry's fused row g = first + id is
// kept only where the big set's row shard owns it, by the rule of
// parallel/collection.py's _owner_local: ROW_HASH owner g % M, local row
// g / M; ROW and TABLE_WISE owner g / rows, local row g % rows (rows of a
// shard); kept where the owner is this shard and the local row lies in its
// storage.  There a big entry's id is read before its cotangent row: the
// other shards' entries (half of them over 2) are dropped unread.  Rows
// are d-wide in both storages: lane-packed [S, 128] storage has the bytes
// of [rows, d].  The f32 sums run in another order than the eager step's
// (atomics, which also vary from run to run, as CUDA's index_add_'s do),
// so the two agree within the bound of recursive summation, not bit for
// bit; so do the data replicas of a shard on a mesh.
//
// Bound: bytes.  At Kaggle's B=65536, L=1, d=16: the cotangent (109 MB) read
// once by each launch where a big table's entry needs it again, ids and
// mask (7 MB) twice, the small set's rows, workspace and accumulator (7 MB),
// and each big entry's row of w (64 B) and acc read and written: 0.24 GB,
// 0.072 ms.  On an H100 80GB HBM3 at 700 W the two launches take 0.21 ms.
// The timings point at the f32 adds in L2 more than at the bytes: the
// second launch takes about as long as the big set's entries alone (each
// adds 16 floats), and the first launch's small tables take 0.07 ms each
// way, in shared memory or by 17 global adds an entry; the 7 privatized
// tables by global atomics took the first launch from 0.16 to 0.35 ms.
// Entries in flight (1, 2 or 4 a group) and the privatized block's entries
// (512, 2048) moved it by under 15 %: 2 and 2048 were the fastest (0.136 +
// 0.074 ms).
//
// Plain C interface, loaded with ctypes.  pel_sparse_step returns the first
// CUDA error of the memset and the two launches (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 2;    // entries a group has in flight at once
// entries of one table a privatized block sums, with COPIES copies
template <int COPIES>
constexpr int kChunk = COPIES == kWarps ? 2048 : 512;
constexpr int kMaxShared = 48 << 10;  // dynamic shared memory without an opt-in

// a table's kind (the wrapper's table, column 0)
constexpr int kPrivate = 0;  // small set, summed in shared memory
constexpr int kSmall = 1;    // small set, summed by global atomics
constexpr int kBig = 2;      // big set, stepped entry by entry

struct Step {
  const int* indices;         // [T, C] per-table ids
  const unsigned char* mask;  // [T, C]
  const float* g;             // [B, T, D] d(loss)/d(pooled)
  const int* table;           // [T, 3]: kind, first row in its set, padded rows (small set)
  const int* order;           // privatized tables, the other small ones, then the big ones
  int n_private, n_small, n_big;
  int T, L, D, group, chunks;  // chunks: D / VEC
  long long C;                 // B * L entries a table
  void* small_w;
  float* small_acc;
  long long small_rows;
  void* big_w;
  float* big_acc;
  long long big_rows;
  float* ws_g;   // [small_rows, D] cotangent sums
  float* ws_sq;  // [small_rows] sums of square means
  float lr, eps;
  int private_rows;  // the largest privatized table's padded rows
  // the big set's row shard (SHARDED): shards M, this shard; big_rows are
  // its rows
  int num_shards, shard;
  bool strided;  // ROW_HASH
};

// -- rows of VEC floats ---------------------------------------------------------

template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    v[0] = *p;
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void load_w(const T* p, float (&v)[VEC]) {
  if constexpr (std::is_same_v<T, float>) {
    load_f32<VEC>(p, v);
  } else if constexpr (VEC == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_w(T* p, const float (&v)[VEC]) {
  if constexpr (std::is_same_v<T, float>) {
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      *p = v[0];
    }
  } else if constexpr (VEC == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 x;
    x.x = *reinterpret_cast<const unsigned*>(&a);
    x.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = x;
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// p[i] += v[i] by atomics: f32 four at once, bf16 two at once, each sum
// rounded to the storage (v is rounded to it first, as the eager step casts
// its step before index_add_)
template <typename T, int VEC>
__device__ __forceinline__ void atomic_add(T* p, const float (&v)[VEC]) {
  if constexpr (std::is_same_v<T, float>) {
    if constexpr (VEC == 4) {
      atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    } else {
      atomicAdd(p, v[0]);
    }
  } else if constexpr (VEC == 4) {
    atomicAdd(reinterpret_cast<__nv_bfloat162*>(p), __floats2bfloat162_rn(v[0], v[1]));
    atomicAdd(reinterpret_cast<__nv_bfloat162*>(p) + 1, __floats2bfloat162_rn(v[2], v[3]));
  } else {
    atomicAdd(p, __float2bfloat16_rn(v[0]));
  }
}

__device__ __forceinline__ float step_scale(float lr, float acc, float eps) {
  return __fmul_rn(lr, __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(acc, eps))));
}

// -- entries ---------------------------------------------------------------------

struct Entry {
  bool keep = false;
  int kind = kBig;
  long long row = 0;         // in its set's storage
  const float* g = nullptr;  // its bag's cotangent row, g[c / L, t, :]
};

// Whether big-set fused row `row` is this process's, and its row in the
// set's storage (written to `row`): on one card every row inside the
// storage; on a row shard (SHARDED) the rows the shard owns.  A fused row
// (first row + id, each below 2^31) fits 32 unsigned bits.
template <bool SHARDED>
__device__ __forceinline__ bool own_row(const Step& s, long long& row) {
  if constexpr (!SHARDED) {
    return row >= 0 && row < s.big_rows;
  } else {
    if (row < 0) return false;
    const unsigned g = (unsigned)row, m = s.num_shards, per = (unsigned)s.big_rows;
    const unsigned owner = s.strided ? g % m : g / per;
    const unsigned local = s.strided ? g / m : g - owner * per;
    row = local;
    return owner == (unsigned)s.shard && local < per;
  }
}

// A group's U entries: items j0 + u * step (u < U; items from `end` on are
// dropped), item j being entry j % C of table order[from + j / C].  The
// cotangent rows' first chunks (a lane's chunk k0) and the mask bytes of
// all U go out first, then the ids of the kept ones, so that the loads of U
// entries are in flight at once: a cotangent row exists whatever its mask,
// and a masked id is never read.  An entry outside its table's padded rows
// (small set) or the set's storage (big set) is dropped.  SHARDED: a big
// entry's cotangent row is loaded after its id, and only where it is kept.
template <bool SHARDED, int U, int VEC>
__device__ __forceinline__ void load_entries(const Step& s, int from, long long j0,
                                             long long step, long long end, int k0,
                                             Entry (&e)[U], float (&v)[U][VEC]) {
  long long at[U];
  int t[U];
  bool kept[U];
  long long q = j0 / s.C, c = j0 - q * s.C;  // one division; the U items follow on
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long j = j0 + u * step;
    if (u > 0) c += step;
    while (c >= s.C) c -= s.C, ++q;
    e[u] = Entry();
    kept[u] = false;
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[u][i] = 0.f;
    if (j < end) {
      t[u] = s.order[from + (int)q];
      at[u] = (long long)t[u] * s.C + c;
      const long long bag = s.L == 1 ? c : c / s.L;
      e[u].g = s.g + (bag * s.T + t[u]) * (long long)s.D;
      const bool later = SHARDED && s.table[3 * t[u]] == kBig;
      if (!later && k0 < s.chunks) load_f32<VEC>(e[u].g + k0 * VEC, v[u]);
      kept[u] = s.mask[at[u]] != 0;
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (!kept[u]) continue;
    const int id = s.indices[at[u]];
    const int* tb = s.table + 3 * t[u];
    e[u].kind = tb[0];
    e[u].row = (long long)tb[1] + id;
    e[u].keep = e[u].kind == kBig ? own_row<SHARDED>(s, e[u].row)
                                  : id >= 0 && id < tb[2];
  }
  if constexpr (SHARDED) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (e[u].keep && e[u].kind == kBig && k0 < s.chunks)
        load_f32<VEC>(e[u].g + k0 * VEC, v[u]);
    }
  }
}

template <int VEC>
__device__ __forceinline__ float square_sum(const float (&v)[VEC], float acc) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc = __fmaf_rn(v[j], v[j], acc);
  return acc;
}

// The sum of squares of entry e's row over the lane's chunks: the first
// (held in v), then the rest, loaded
template <int VEC>
__device__ __forceinline__ float row_squares(const Step& s, const Entry& e, int k0,
                                             const float (&v)[VEC]) {
  float sq = square_sum<VEC>(v, 0.f);
  for (int k = k0 + s.group; k < s.chunks; k += s.group) {
    float u[VEC];
    load_f32<VEC>(e.g + k * VEC, u);
    sq = square_sum<VEC>(u, sq);
  }
  return sq;
}

// The group's sum over its lanes (G a power of two, groups aligned in the
// warp); every lane of the warp calls it
__device__ __forceinline__ float group_sum(float x, int group) {
  for (int o = group >> 1; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// -- launch 1: cotangent sums and squares ---------------------------------------

// p[0] += x into a privatized copy: by the warp alone (a copy a warp, its
// groups in turn) or by a shared atomic (one copy a block)
template <int COPIES>
__device__ __forceinline__ void private_add(float* p, float x) {
  if constexpr (COPIES == kWarps) {
    *p += x;
  } else {
    atomicAdd(p, x);
  }
}

// A privatized block: entries [c0, c1) of the small table at position pos
// of the order, summed in shared memory (COPIES copies), then added to the
// workspace.
template <bool ADAGRAD, int VEC, int COPIES>
__device__ void private_block(const Step& s, float* copies, int pos, long long c0,
                              long long c1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gpw = 32 / s.group, grp = lane / s.group, k0 = lane % s.group;
  const int t = s.order[pos];
  const int width = s.D + 1;  // D cotangent sums, then the square means
  const int npad = s.table[3 * t + 2];
  const long long first = s.table[3 * t + 1];
  const int n = npad * width;
  for (int i = threadIdx.x; i < COPIES * n; i += kBlock) copies[i] = 0.f;
  __syncthreads();
  float* mine = copies + (COPIES == kWarps ? warp : 0) * n;
  const long long window = (long long)gpw * kUnroll;  // a warp's entries at once
  for (long long base = c0 + warp * window; base < c1; base += kWarps * window) {
    Entry e[kUnroll];
    float v[kUnroll][VEC];
    load_entries<false, kUnroll, VEC>(s, pos, base + grp, gpw, c1, k0, e, v);  // small set
    float sq[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      sq[u] = ADAGRAD && e[u].keep ? row_squares<VEC>(s, e[u], k0, v[u]) : 0.f;
      if (ADAGRAD) sq[u] = group_sum(sq[u], s.group);
    }
    for (int turn = 0; turn < gpw; ++turn) {  // the warp's groups one at a time
      if (turn == grp) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (!e[u].keep) continue;
          float* r = mine + (e[u].row - first) * width;
          if (k0 < s.chunks) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) private_add<COPIES>(r + k0 * VEC + j, v[u][j]);
          }
          for (int k = k0 + s.group; k < s.chunks; k += s.group) {
            float x[VEC];
            load_f32<VEC>(e[u].g + k * VEC, x);
#pragma unroll
            for (int j = 0; j < VEC; ++j) private_add<COPIES>(r + k * VEC + j, x[j]);
          }
          if (ADAGRAD && k0 == 0) private_add<COPIES>(r + s.D, __fdiv_rn(sq[u], (float)s.D));
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kBlock) {
    float x = 0.f;
    for (int w = 0; w < COPIES; ++w) x += copies[w * n + i];
    if (x == 0.f) continue;  // a zero adds nothing
    const long long r = first + i / width;
    const int col = i % width;
    if (col < s.D) {
      atomicAdd(s.ws_g + r * s.D + col, x);
    } else {
      atomicAdd(s.ws_sq + r, x);
    }
  }
}

template <bool ADAGRAD, int VEC, bool SHARDED, int COPIES>
__global__ void __launch_bounds__(kBlock)
accumulate_kernel(Step s, int private_blocks) {
  extern __shared__ float copies[];  // [COPIES][private_rows][D + 1]
  if ((int)blockIdx.x < private_blocks) {
    constexpr int chunk = kChunk<COPIES>;
    const int per_table = (int)((s.C + chunk - 1) / chunk);
    const long long c0 = (long long)(blockIdx.x % per_table) * chunk;
    private_block<ADAGRAD, VEC, COPIES>(s, copies, blockIdx.x / per_table, c0,
                                        min(s.C, c0 + chunk));
    return;
  }
  // the other small tables, then (row AdaGrad) the big ones, a group an entry
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gpw = 32 / s.group, grp = lane / s.group, k0 = lane % s.group;
  const long long items = (long long)(s.n_small + (ADAGRAD ? s.n_big : 0)) * s.C;
  const long long window = (long long)gpw * kUnroll;
  const long long stride = (long long)(gridDim.x - private_blocks) * kWarps * window;
  for (long long base = ((long long)(blockIdx.x - private_blocks) * kWarps + warp) * window;
       base < items; base += stride) {  // uniform over the warp
    Entry e[kUnroll];
    float v[kUnroll][VEC];
    load_entries<SHARDED, kUnroll, VEC>(s, s.n_private, base + grp, gpw, items, k0, e, v);
    float sq[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      sq[u] = 0.f;
      if (!e[u].keep) continue;
      const bool small = e[u].kind != kBig;
      float* sums = s.ws_g + e[u].row * s.D;
      if (k0 < s.chunks) {
        sq[u] = square_sum<VEC>(v[u], 0.f);
        if (small) atomic_add<float, VEC>(sums + k0 * VEC, v[u]);
      }
      for (int k = k0 + s.group; k < s.chunks; k += s.group) {
        float x[VEC];
        load_f32<VEC>(e[u].g + k * VEC, x);
        sq[u] = square_sum<VEC>(x, sq[u]);
        if (small) atomic_add<float, VEC>(sums + k * VEC, x);
      }
    }
    if (!ADAGRAD) continue;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      sq[u] = group_sum(sq[u], s.group);
      if (e[u].keep && k0 == 0) {
        atomicAdd((e[u].kind == kBig ? s.big_acc : s.ws_sq) + e[u].row,
                  __fdiv_rn(sq[u], (float)s.D));
      }
    }
  }
}

// -- launch 2: the steps ----------------------------------------------------------

template <typename TS, typename TB, bool ADAGRAD, int VEC, bool SHARDED>
__global__ void __launch_bounds__(kBlock) apply_kernel(Step s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gpw = 32 / s.group, grp = lane / s.group, k0 = lane % s.group;
  // every small-set row steps once, a group a row
  const long long groups = (long long)gridDim.x * (kBlock / s.group);
  for (long long r = ((long long)blockIdx.x * kBlock + threadIdx.x) / s.group;
       r < s.small_rows; r += groups) {
    float scale = s.lr;
    if (ADAGRAD) {
      const float a = __fadd_rn(s.small_acc[r], s.ws_sq[r]);
      if (k0 == 0) s.small_acc[r] = a;
      scale = step_scale(s.lr, a, s.eps);
    }
    TS* w = static_cast<TS*>(s.small_w) + r * s.D;
    const float* sum = s.ws_g + r * s.D;
    for (int k = k0; k < s.chunks; k += s.group) {
      float x[VEC], gs[VEC];
      load_w<TS, VEC>(w + k * VEC, x);
      load_f32<VEC>(sum + k * VEC, gs);
#pragma unroll
      for (int i = 0; i < VEC; ++i) x[i] = __fsub_rn(x[i], __fmul_rn(scale, gs[i]));
      store_w<TS, VEC>(w + k * VEC, x);
    }
  }
  // every big-set entry adds its step, kUnroll entries a group at once
  const long long items = (long long)s.n_big * s.C;
  const long long window = (long long)gpw * kUnroll;
  const long long stride = (long long)gridDim.x * kWarps * window;
  for (long long base = ((long long)blockIdx.x * kWarps + warp) * window; base < items;
       base += stride) {
    Entry e[kUnroll];
    float v[kUnroll][VEC];
    load_entries<SHARDED, kUnroll, VEC>(s, s.n_private + s.n_small, base + grp, gpw, items,
                                        k0, e, v);
    float neg[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      neg[u] = -s.lr;
      if (ADAGRAD && e[u].keep) neg[u] = -step_scale(s.lr, s.big_acc[e[u].row], s.eps);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!e[u].keep) continue;
      TB* w = static_cast<TB*>(s.big_w) + e[u].row * s.D;
      for (int k = k0; k < s.chunks; k += s.group) {
        float x[VEC];
        if (k == k0) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) x[i] = v[u][i];
        } else {
          load_f32<VEC>(e[u].g + k * VEC, x);
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) x[i] = __fmul_rn(neg[u], x[i]);
        atomic_add<TB, VEC>(w + k * VEC, x);
      }
    }
  }
}

// -- launches --------------------------------------------------------------------

// Blocks for about one wave of ``kernel`` with ``shared`` bytes a block,
// and no more than ``needed``; cached per device for the last size asked.
// A negative value is minus the CUDA error of the query.
template <auto kernel>
long long wave_blocks(int device, int shared, long long needed) {
  static int sizes[64], blocks[64];
  static bool known[64];
  const int d = device & 63;
  if (!known[d] || sizes[d] != shared) {
    int per_sm = 0, sms = 0;
    cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, shared);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return -(long long)err;
    sizes[d] = shared, blocks[d] = (per_sm > 0 ? per_sm : 1) * sms, known[d] = true;
  }
  return needed < blocks[d] ? needed : blocks[d];
}

template <bool ADAGRAD, int VEC, bool SHARDED, int COPIES>
int accumulate(const Step& s, int device, cudaStream_t stream) {
  const int shared =
      s.n_private > 0 ? COPIES * s.private_rows * (s.D + 1) * (int)sizeof(float) : 0;
  if (shared > kMaxShared) return (int)cudaErrorInvalidValue;
  constexpr int chunk = kChunk<COPIES>;
  const long long private_blocks = (long long)s.n_private * ((s.C + chunk - 1) / chunk);
  const long long items = (long long)(s.n_small + (ADAGRAD ? s.n_big : 0)) * s.C;
  const long long per_block = (long long)kWarps * (32 / s.group) * kUnroll;
  const long long direct = wave_blocks<&accumulate_kernel<ADAGRAD, VEC, SHARDED, COPIES>>(
      device, shared, (items + per_block - 1) / per_block);
  if (direct < 0) return (int)-direct;
  const long long grid = private_blocks + direct;
  if (grid == 0) return 0;
  if (grid > INT32_MAX) return (int)cudaErrorInvalidValue;
  accumulate_kernel<ADAGRAD, VEC, SHARDED, COPIES>
      <<<(unsigned)grid, kBlock, shared, stream>>>(s, (int)private_blocks);
  return (int)cudaGetLastError();
}

template <typename TS, typename TB, bool ADAGRAD, int VEC, bool SHARDED>
int apply(const Step& s, int device, cudaStream_t stream) {
  const long long rows_per_block = kBlock / s.group;
  const long long entries_per_block = (long long)kWarps * (32 / s.group) * kUnroll;
  const long long needed =
      std::max((s.small_rows + rows_per_block - 1) / rows_per_block,
               ((long long)s.n_big * s.C + entries_per_block - 1) / entries_per_block);
  const long long grid =
      wave_blocks<&apply_kernel<TS, TB, ADAGRAD, VEC, SHARDED>>(device, 0, needed);
  if (grid < 0) return (int)-grid;
  if (grid == 0) return 0;
  apply_kernel<TS, TB, ADAGRAD, VEC, SHARDED><<<(unsigned)grid, kBlock, 0, stream>>>(s);
  return (int)cudaGetLastError();
}

// A privatized block keeps a copy of its table's sums a warp below d=128
// (rows a few lanes wide, a warp's groups adding in turn) and one copy a
// block from d=128 on (rows a warp wide, shared atomics): the rule of
// ops/sparse_step.py's private_copies, which the two must agree on.
template <bool ADAGRAD, int VEC, bool SHARDED>
int run(const Step& s, bool small_bf16, bool big_bf16, int device, cudaStream_t stream) {
  using Apply = int (*)(const Step&, int, cudaStream_t);
  const Apply chosen =
      small_bf16 ? (big_bf16 ? apply<__nv_bfloat16, __nv_bfloat16, ADAGRAD, VEC, SHARDED>
                             : apply<__nv_bfloat16, float, ADAGRAD, VEC, SHARDED>)
                 : (big_bf16 ? apply<float, __nv_bfloat16, ADAGRAD, VEC, SHARDED>
                             : apply<float, float, ADAGRAD, VEC, SHARDED>);
  const int err = s.D < 128 ? accumulate<ADAGRAD, VEC, SHARDED, kWarps>(s, device, stream)
                            : accumulate<ADAGRAD, VEC, SHARDED, 1>(s, device, stream);
  return err != 0 ? err : chosen(s, device, stream);
}

template <bool SHARDED>
int dispatch(const Step& s, bool adagrad, int vec, bool small_bf16, bool big_bf16, int device,
             cudaStream_t stream) {
  if (adagrad) {
    return vec == 4 ? run<true, 4, SHARDED>(s, small_bf16, big_bf16, device, stream)
                    : run<true, 1, SHARDED>(s, small_bf16, big_bf16, device, stream);
  }
  return vec == 4 ? run<false, 4, SHARDED>(s, small_bf16, big_bf16, device, stream)
                  : run<false, 1, SHARDED>(s, small_bf16, big_bf16, device, stream);
}

}  // namespace

extern "C" {

// vec: 4 where d % 4 == 0 and every row pointer is 16-byte aligned, else 1.
// ws: small_rows * (d + 1) f32, zeroed here.  A set that is absent has no
// rows and no tables.  num_shards: 0 on one card, else the big set's row
// shards (big_rows its shard's rows, below 2^32), of which this process
// holds `shard`; strided: ROW_HASH.
int pel_sparse_step(const void* indices, const void* mask, const void* g, const void* table,
                    const void* order, int n_private, int n_small, int n_big, long long c,
                    int t, int pooling, int d, void* small_w, int small_bf16, void* small_acc,
                    long long small_rows, void* big_w, int big_bf16, void* big_acc,
                    long long big_rows, void* ws, float lr, float eps, int adagrad, int vec,
                    int private_rows, int num_shards, int shard, int strided, int device,
                    void* stream) {
  if (d < 1 || pooling < 1 || (vec != 1 && vec != 4) || d % vec != 0 || num_shards < 0 ||
      (num_shards > 0 && (shard < 0 || shard >= num_shards || big_rows > 0xffffffffLL)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s_ = (cudaStream_t)stream;
  Step s;
  s.indices = (const int*)indices;
  s.mask = (const unsigned char*)mask;
  s.g = (const float*)g;
  s.table = (const int*)table;
  s.order = (const int*)order;
  s.n_private = n_private, s.n_small = n_small, s.n_big = n_big;
  s.T = t, s.L = pooling, s.D = d, s.C = c;
  s.chunks = d / vec;
  s.group = 1;
  while (s.group < s.chunks && s.group < 32) s.group <<= 1;
  s.small_w = small_w, s.small_acc = (float*)small_acc, s.small_rows = small_rows;
  s.big_w = big_w, s.big_acc = (float*)big_acc, s.big_rows = big_rows;
  s.ws_g = (float*)ws;
  s.ws_sq = s.ws_g + small_rows * d;
  s.lr = lr, s.eps = eps;
  s.private_rows = private_rows;
  s.num_shards = num_shards, s.shard = shard, s.strided = strided != 0;
  if (small_rows > 0) {
    err = cudaMemsetAsync(ws, 0, (size_t)small_rows * (d + 1) * sizeof(float), s_);
    if (err != cudaSuccess) return (int)err;
  }
  const bool sb = small_bf16 != 0, bb = big_bf16 != 0;
  return num_shards > 0 ? dispatch<true>(s, adagrad != 0, vec, sb, bb, device, s_)
                        : dispatch<false>(s, adagrad != 0, vec, sb, bb, device, s_);
}

const char* pel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
