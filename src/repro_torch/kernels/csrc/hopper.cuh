// Hopper plumbing shared by the kernels that stage tiles with the Tensor
// Memory Accelerator (flash_attention.cu, decode_core.cuh): shared memory
// addresses, mbarriers, one TMA box copy, and the tensor map of a
// (B, S, heads, D) tensor, encoded anew or taken from a small cache.
//
// kernels/build.py hashes every header of csrc/ into every library's name:
// an edit here rebuilds every kernel.

#pragma once

#include <cuda.h>  // CUtensorMap; the encoder is reached through the runtime
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 4-d tensor map into shared memory, its bytes counted on
// `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (no
// -lcuda at build time); null when it cannot be had.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;  // a race only stores the same pointer
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a (B, S, heads, D) tensor of `esize`-byte elements as
// (D, heads, S, B), boxes of box_w columns by `rows` rows of one head,
// written to shared memory under `swizzle`.  Rows past S arrive as zeros.
inline bool tensor_map_4d(CUtensorMap* map, CUtensorMapDataType dtype,
                          int esize, const void* ptr, int D, int heads, int S,
                          int B, int box_w, int rows,
                          CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * esize,
                                 (cuuint64_t)heads * D * esize,
                                 (cuuint64_t)S * heads * D * esize};
  const cuuint32_t box[4] = {(cuuint32_t)box_w, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, dtype, 4, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// tensor_map_4d's map, from a cache of the last kMapCache maps encoded:
// encoding costs host time on every launch, and a caller whose tensors
// keep their addresses from call to call (the serve engine's KV caches,
// dense or paged, two a layer) encodes each map once.  The key is every argument, so a hit is
// the map an encode would give.
constexpr int kMapCache = 256;

inline bool cached_tensor_map_4d(CUtensorMap* map, CUtensorMapDataType dtype,
                                 int esize, const void* ptr, int D,
                                 int heads, int S, int B, int box_w,
                                 int rows, CUtensorMapSwizzle swizzle) {
  struct Entry {
    const void* ptr;
    int key[9];
    CUtensorMap map;
  };
  static Entry cache[kMapCache];
  static int n_used = 0, next = 0;
  static std::mutex mu;
  const int key[9] = {(int)dtype, esize, D,    heads,        S,
                      B,          box_w, rows, (int)swizzle};
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_used; ++i)
    if (cache[i].ptr == ptr && !memcmp(cache[i].key, key, sizeof key)) {
      *map = cache[i].map;
      return true;
    }
  if (!tensor_map_4d(map, dtype, esize, ptr, D, heads, S, B, box_w, rows,
                     swizzle))
    return false;
  Entry& e = cache[next];
  e.ptr = ptr;
  memcpy(e.key, key, sizeof key);
  e.map = *map;
  next = (next + 1) % kMapCache;
  if (n_used < kMapCache) ++n_used;
  return true;
}

}  // namespace
