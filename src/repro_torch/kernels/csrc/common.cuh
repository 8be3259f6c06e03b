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

// ---------------------------------------------------------------------------
// Decode kernels (paged_attention.cu, decode_attention.cu): one warp's
// lanes split the head dim, VEC elements a lane, and a block scores the
// query heads of one KV head together, GQ at a time.
// ---------------------------------------------------------------------------
namespace {

constexpr int kMaxHeadTile = 8;

// VEC (head-dim elements per lane) and the head tile GQ (a power of two
// >= the query heads per KV head, at most kMaxHeadTile) for a layout;
// false for one the decode kernels do not take.
inline bool decode_plan(int heads, int kv_heads, int head_dim, int* vec,
                        int* tile) {
  if (kv_heads < 1 || heads < kv_heads || heads % kv_heads != 0)
    return false;
  switch (head_dim) {
    case 8: case 16: case 32: *vec = 1; break;
    case 64: *vec = 2; break;
    case 128: *vec = 4; break;
    case 256: *vec = 8; break;
    default: return false;
  }
  const int gq = heads / kv_heads;
  int t = 1;
  while (t < gq && t < kMaxHeadTile) t <<= 1;
  *tile = t;
  return true;
}

// f.template run<T, VEC, GQ>() for the instantiation (dtype, vec, tile)
// names (dtype 0 = float32, 1 = bfloat16); `bad` when none does.
template <typename T, int VEC, typename F, typename R>
R dispatch_gq(int tile, const F& f, R bad) {
  switch (tile) {
    case 1: return f.template run<T, VEC, 1>();
    case 2: return f.template run<T, VEC, 2>();
    case 4: return f.template run<T, VEC, 4>();
    case 8: return f.template run<T, VEC, 8>();
  }
  return bad;
}

template <typename T, typename F, typename R>
R dispatch_vec(int vec, int tile, const F& f, R bad) {
  switch (vec) {
    case 1: return dispatch_gq<T, 1>(tile, f, bad);
    case 2: return dispatch_gq<T, 2>(tile, f, bad);
    case 4: return dispatch_gq<T, 4>(tile, f, bad);
    case 8: return dispatch_gq<T, 8>(tile, f, bad);
  }
  return bad;
}

template <typename F, typename R>
R dispatch_decode(int dtype, int vec, int tile, const F& f, R bad) {
  if (dtype == 0) return dispatch_vec<float>(vec, tile, f, bad);
  if (dtype == 1) return dispatch_vec<__nv_bfloat16>(vec, tile, f, bad);
  return bad;
}

}  // namespace
