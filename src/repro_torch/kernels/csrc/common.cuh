// Helpers shared by the port's CUDA kernels (csrc/*.cu).  Each kernel
// source includes this header once and is built into its own shared
// library, so the C functions at the end exist once per library.
//
// kernels/build.py hashes this header into every library's name: an edit
// here rebuilds every kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The reference kernels' masked score: finite, so a row whose every key
// is masked inside a reachable tile keeps exp(s - m) = 1 terms that the
// next real score's alpha = exp(m_old - m_new) = 0 wipes out.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void store_f32(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

template <int BYTES>
struct Raw;
template <>
struct Raw<2> { using type = unsigned short; };
template <>
struct Raw<4> { using type = unsigned int; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<16> { using type = uint4; };

// N consecutive elements at src (aligned to min(16, N * sizeof(T)) bytes)
// as f32, in vector loads of at most 16 bytes.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ src,
                                         float (&dst)[N]) {
  constexpr int kBytes = int(sizeof(T)) * N;
  constexpr int kChunk = kBytes < 16 ? kBytes : 16;
  constexpr int kPer = kChunk / int(sizeof(T));
  using V = typename Raw<kChunk>::type;
#pragma unroll
  for (int c = 0; c < N / kPer; ++c) {
    V raw = reinterpret_cast<const V*>(src)[c];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kPer; ++i) dst[c * kPer + i] = to_f32(e[i]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The most warps (a power of two, at most max_warps) that one block of
// `kernel` can launch with the registers it was compiled to use.
template <typename K>
cudaError_t max_launchable_warps(K kernel, int max_warps, int* warps) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int w = 1;
  while (w * 2 <= max_warps && w * 2 * 32 <= attr.maxThreadsPerBlock) w *= 2;
  *warps = w;
  return cudaSuccess;
}

// Static shared memory of a compiled kernel, in bytes.
template <typename K>
int static_smem_bytes(K kernel) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return -1;
  return (int)attr.sharedSizeBytes;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The opt-in maximum of shared memory one block may use on `device`
// (cudaDevAttrMaxSharedMemoryPerBlockOptin), or -1 when it cannot be read.
extern "C" int repro_max_smem_per_block(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}
