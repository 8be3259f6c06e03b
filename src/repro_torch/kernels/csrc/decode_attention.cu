// Flash-decode attention over a dense KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_decode_pallas`
// (src/repro/kernels/decode_attention.py).  It computes the same function:
// one new query token per sequence attends to the first kv_len entries of
// a dense cache; kv_len is one scalar for the whole batch, clamped to S.
// Online softmax in f32, scale 1/sqrt(D), denominator clamped at 1e-30;
// cache entries at or past kv_len are never scored, so a cache filled to
// 2k of 32k streams 2k.  At kv_len == 0 it writes zeros, as the Pallas
// kernel does.
//
//   q       (B, H, D)        bf16 or f32
//   k, v    (B, S, KV, D)    q's dtype
//   kv_len  int32 scalar: read on the device from a pointer (a 0-d tensor)
//           so the host never waits on it, or passed by value
//   out     (B, H, D)        q's dtype
//
// Bound.  The kernel must read the K and V rows of the first kv_len
// entries: 2 * B * kv_len * KV * D * sizeof(T) bytes, at most 3.35 TB/s on
// an H100 SXM; its 4 * B * H * kv_len * D flops are far below the ridge
// point, so it is bound by bytes.  What matters is how many bytes each SM
// keeps in flight.
//
// Design.  The TPU kernel walks a sequential grid axis over blocks of
// block_kv cache entries and carries the softmax state in VMEM scratch.
// Here the cache axis is split across blocks (flash-decoding): one block
// of 256 threads owns (split, KV head, head tile, batch row), the block_kv
// entries of its split and all query heads of the tile (GQA), so each K/V
// byte is read from device memory once for up to 8 query heads.  The
// block's work, which the paged kernel shares, is `decode_split` of
// csrc/decode_core.cuh: K and V stream through a four-stage TMA ring, a
// tile is scored at once with one max and sum a tile and head, and the
// last split to finish merges the partial states in split order in the
// same launch.  Here a tile is one TMA box of whole cache rows of one KV
// head (tokens x D, row stride KV * D).
//
// The grid runs the KV heads of a split side by side, so the blocks in
// flight read whole cache rows (KV * D elements) together.  block_kv
// trades parallelism (B * KV * head tiles * ceil(S / block_kv) blocks)
// against the partial states written and merged: B * H * ceil(kv_len /
// block_kv) * (D + 2) * 4 bytes each way, through the L2.  The wrapper's
// default (block_kv 0) takes the most splits that keep the grid at two
// blocks an SM: block_kv 1024 at Gemma-7B's engine shape (B=8, S=2048,
// 256 blocks) and 256 at B=1, S=4096 (256 blocks), one wave of the 396
// (three an SM) the card holds at once.

#include "decode_core.cuh"

namespace {

template <typename T, int D, int GQ>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const T* __restrict__ q,
    const int* __restrict__ kv_len_ptr, int kv_len_value,
    float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc, int* __restrict__ counters,
    T* __restrict__ out, int seq, int kv_heads, int gq, int n_tiles,
    int block_kv, int tk, int n_split, float scale) {
  using C = DecShape<T, D>;
  // the KV heads of a split side by side: whole cache rows together
  const int split = blockIdx.y, head_block = blockIdx.x;
  const int kvh = head_block / n_tiles;
  const int h0 = (head_block - kvh * n_tiles) * GQ;
  const int b = blockIdx.z;
  const int n_heads = min(GQ, gq - h0);
  const size_t row0 = ((size_t)b * kv_heads + kvh) * gq + h0;  // query row

  const int kv_len =
      min(max(kv_len_ptr ? *kv_len_ptr : kv_len_value, 0), seq);
  if (kv_len == 0) {  // nothing to attend to: zeros, as the TPU kernel
    if (split == 0)
      for (int i = threadIdx.x; i < n_heads * D; i += kThreads)
        store_f32(0.f, out + row0 * D + i);
    return;
  }
  const int n_active = (kv_len + block_kv - 1) / block_kv;
  if (split >= n_active) return;  // past kv_len: not part of the merge
  const int t0 = split * block_kv;
  const SplitWork w{row0, n_heads, t0, min(t0 + block_kv, kv_len), tk,
                    split, n_active, n_split,
                    counters + (size_t)b * kv_heads * n_tiles + head_block,
                    0};
  // a tile: one box of tk whole cache rows of KV head kvh
  auto issue = [&](int i, uint32_t bar, uint32_t dst) {
    mbar_expect_tx(bar, 2 * tk * C::kRow);
    tma_load(dst, &tm_k, bar, 0, kvh, t0 + i * tk, b);
    tma_load(dst + C::kTile, &tm_v, bar, 0, kvh, t0 + i * tk, b);
  };
  decode_split<T, D, GQ>(q, w, issue, part_m, part_l, part_acc, out, scale);
}

struct DecodeLaunch {
  const void *q, *k, *v;
  const int* kv_len_ptr;
  int kv_len_value;
  float *part_m, *part_l, *part_acc;
  int* counters;
  void* out;
  int batch, seq, kv_heads, head_dim, gq, block_kv;
  cudaStream_t stream;

  template <typename T, int D, int GQ>
  cudaError_t run() const {
    using C = DecShape<T, D>;
    // tokens a copy brings: the tile, or the split rounded up to 8 rows
    const int tk = min(C::kTK, (min(block_kv, seq) + 7) / 8 * 8);
    const CUtensorMapDataType dt = sizeof(T) == 2
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    // a box: tk whole cache rows of one KV head, laid out unswizzled
    CUtensorMap tm_k, tm_v;
    if (!cached_tensor_map_4d(&tm_k, dt, C::kSize, k, D, kv_heads, seq,
                              batch, D, tk, CU_TENSOR_MAP_SWIZZLE_NONE) ||
        !cached_tensor_map_4d(&tm_v, dt, C::kSize, v, D, kv_heads, seq,
                              batch, D, tk, CU_TENSOR_MAP_SWIZZLE_NONE))
      return cudaErrorInvalidValue;
    auto* kernel = decode_kernel<T, D, GQ>;
    constexpr int bytes = smem_bytes<T, D, GQ>();
    const cudaError_t err = allow_smem<T, D, GQ>(kernel);
    if (err != cudaSuccess) return err;
    const int n_tiles = (gq + GQ - 1) / GQ;
    const int n_split = (seq + block_kv - 1) / block_kv;
    const dim3 grid(kv_heads * n_tiles, n_split, batch);
    kernel<<<grid, kThreads, bytes, stream>>>(
        tm_k, tm_v, static_cast<const T*>(q), kv_len_ptr, kv_len_value,
        part_m, part_l, part_acc, counters, static_cast<T*>(out), seq,
        kv_heads, gq, n_tiles, block_kv, tk, n_split,
        1.0f / sqrtf((float)head_dim));
    return cudaGetLastError();
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  kv_len_ptr: a device int32, or null
// to use kv_len_value.  part_m, part_l: (B, H, ceil(S / block_kv)) f32
// scratch; part_acc: the same with a trailing D.  counters: at least
// B * KV * ceil(H / KV / tile) int32, zero before the first launch; the
// kernel leaves them at zero.  Returns 0 on success, else a cudaError_t
// code (cudaErrorInvalidValue for a shape the kernel does not take).
// Launches on `stream`, does not synchronise.
extern "C" int repro_flash_decode(
    const void* q, const void* k, const void* v, const int* kv_len_ptr,
    int kv_len_value, float* part_m, float* part_l, float* part_acc,
    int* counters, void* out, int batch, int seq, int heads, int kv_heads,
    int head_dim, int dtype, int block_kv, void* stream) {
  int tile;
  if (batch < 1 || seq < 1 || block_kv < 1 ||
      !decode_plan(heads, kv_heads, head_dim, &tile))
    return (int)cudaErrorInvalidValue;
  const DecodeLaunch launch{q,        k,         v,        kv_len_ptr,
                            kv_len_value, part_m, part_l, part_acc,
                            counters, out,       batch,    seq,
                            kv_heads, head_dim,  heads / kv_heads,
                            block_kv, static_cast<cudaStream_t>(stream)};
  return (int)dispatch(dtype, head_dim, tile, launch, cudaErrorInvalidValue);
}

// The dynamic shared memory (bytes) one block asks for at this head
// layout and dtype; the kernel has no static shared memory.  -1 for a
// layout the kernel does not take.  The tuning space's smem_footprint
// must give the same number (chip_smoke.py checks it).
extern "C" int repro_flash_decode_smem_bytes(int heads, int kv_heads,
                                             int head_dim, int dtype) {
  int tile;
  if (!decode_plan(heads, kv_heads, head_dim, &tile)) return -1;
  return dispatch(dtype, head_dim, tile, DecodeSmem{}, -1);
}
