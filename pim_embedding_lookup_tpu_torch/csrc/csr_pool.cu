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
// Design: one thread per (bag, lane), bags_per_block bags a block, so a
// warp's loads of one row are neighbouring addresses.  The forward has no
// atomics and sums each bag in entry order, so it is deterministic; padding
// entries are never read.  Bags of different lengths leave some threads of
// a warp walking longer than others; that imbalance is accepted here.  The
// backward adds g[bag, lane] into dtable[idx, lane] with one f32 atomicAdd
// per (entry, lane), so rows shared by several bags sum in an order that
// changes from run to run.
//
// Plain C interface, loaded with ctypes.  Each launch function returns
// cudaGetLastError() after the launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

template <typename T>
__global__ void csr_pool_kernel(const T* __restrict__ storage,
                                const int* __restrict__ indices,
                                const int* __restrict__ offsets,
                                float* __restrict__ out, int tables, int batch,
                                long long capacity, int d) {
  const long long bag = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const int lane = threadIdx.x;
  if (bag >= (long long)tables * batch) return;
  const long long t = bag / batch;
  const int b = (int)(bag - t * batch);
  const int* idx = indices + t * capacity;
  long long start, end;
  bag_range(offsets + t * (batch + 1), b, capacity, &start, &end);
  float acc = 0.0f;
  for (long long e = start; e < end; ++e) {
    const long long row = idx[e];
    acc += to_f32(storage[row * d + lane]);
  }
  out[bag * d + lane] = acc;
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

template <typename T>
int launch_pool(const void* storage, const void* indices, const void* offsets,
                void* out, int tables, int batch, long long capacity, int d,
                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block = block_of(d);
  csr_pool_kernel<T><<<grid_of((long long)tables * batch, block), block, 0,
                       (cudaStream_t)stream>>>(
      (const T*)storage, (const int*)indices, (const int*)offsets, (float*)out,
      tables, batch, capacity, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pel_csr_pool_f32(const void* storage, const void* indices,
                     const void* offsets, void* out, int tables, int batch,
                     long long capacity, int d, int device, void* stream) {
  return launch_pool<float>(storage, indices, offsets, out, tables, batch,
                            capacity, d, device, stream);
}

int pel_csr_pool_bf16(const void* storage, const void* indices,
                      const void* offsets, void* out, int tables, int batch,
                      long long capacity, int d, int device, void* stream) {
  return launch_pool<__nv_bfloat16>(storage, indices, offsets, out, tables,
                                    batch, capacity, d, device, stream);
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
