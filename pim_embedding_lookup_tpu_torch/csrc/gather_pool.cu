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
// Design: one thread per (bag, lane), so a warp's loads of one row are
// neighbouring addresses; masked entries are skipped, so padding ids are
// never read.  Vector loads and more bags in flight per warp are left for
// later work.
//
// Plain C interface, loaded with ctypes.  Each launch function returns
// cudaGetLastError() after the launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void fixedl_pool_kernel(const T* __restrict__ storage,
                                   const int* __restrict__ indices,
                                   const unsigned char* __restrict__ mask,
                                   float* __restrict__ out, long long bags,
                                   int pooling, int d) {
  const long long bag = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const int lane = threadIdx.x;
  if (bag >= bags) return;
  const long long e0 = bag * pooling;
  float acc = 0.0f;
  for (int j = 0; j < pooling; ++j) {
    if (mask != nullptr && mask[e0 + j] == 0) continue;
    const long long row = indices[e0 + j];
    acc += to_f32(storage[row * d + lane]);
  }
  out[bag * d + lane] = acc;
}

template <typename T>
int launch(const void* storage, const void* indices, const void* mask,
           void* out, long long bags, int pooling, int d, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // (d, bags_per_block) threads: 256 a block for d <= 256
  const int bags_per_block = d >= 256 ? 1 : 256 / d;
  const dim3 block(d, bags_per_block);
  const long long grid = (bags + bags_per_block - 1) / bags_per_block;
  fixedl_pool_kernel<T><<<(unsigned int)grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)storage, (const int*)indices, (const unsigned char*)mask,
      (float*)out, bags, pooling, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pel_gather_pool_f32(const void* storage, const void* indices,
                        const void* mask, void* out, long long bags,
                        int pooling, int d, int device, void* stream) {
  return launch<float>(storage, indices, mask, out, bags, pooling, d, device,
                       stream);
}

int pel_gather_pool_bf16(const void* storage, const void* indices,
                         const void* mask, void* out, long long bags,
                         int pooling, int d, int device, void* stream) {
  return launch<__nv_bfloat16>(storage, indices, mask, out, bags, pooling, d,
                               device, stream);
}

const char* pel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
