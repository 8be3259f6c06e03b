// Paged flash-decode attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `paged_flash_decode_pallas`
// (src/repro/kernels/paged_attention.py).  It computes the same function:
// one new query token per sequence attends to that sequence's KV cache,
// which lives in a pool of fixed-size token groups addressed through a page
// table.  Online softmax in f32 over the sequence's tokens, scale
// 1/sqrt(D), denominator clamped at 1e-30; tokens at or past lengths[b]
// are never scored, so a sequence streams only its own valid K/V.  At
// lengths[b] == 0 it writes zeros, as the Pallas kernel does.
//
//   q          (B, H, D)          bf16 or f32
//   k_pages    (G, T, KV, D)      same dtype as q; T tokens per group
//   v_pages    (G, T, KV, D)
//   page_table (B, MAXG) int32    logical group -> physical group
//   lengths    (B,) int32         valid tokens per sequence
//   out        (B, H, D)          q's dtype
//
// Bound.  The kernel must read the K and V rows of the valid tokens:
// 2 * sum(lengths) * KV * D * sizeof(T) bytes, at most 3.35 TB/s on an
// H100 SXM.  Its arithmetic (4 * H * D flops a token) is far below the
// card's ridge point, so it is bound by bytes: what matters is that every
// SM keeps enough bytes in flight, whatever the lengths.
//
// Design.  The TPU kernel walks a sequential grid axis over the logical
// groups and carries the softmax state in VMEM scratch.  Here the token
// axis is split across blocks (flash-decoding): one block of 256 threads
// owns (split, KV head, head tile, batch row): split_tokens tokens (a
// multiple of T and of the tile) of one sequence for all query heads of
// the tile (GQA), so each K/V byte is read from device memory once for up
// to 8 query heads.  Lengths are ragged, so the split is a fixed number of
// tokens, not a fixed split count: a row of 2048 tokens is cut into many
// splits, a row of 1 token is one.  The host never reads `lengths` (that
// would cost a device sync), so the grid covers the pool's capacity
// MAXG * T, and a block whose split starts at or past lengths[b] exits at
// once, with no write and no counter touched.  The wrapper picks
// split_tokens (`auto_split_tokens`) from the batch, heads, capacity and
// SM count.
//
// The block's work is `decode_split` of csrc/decode_core.cuh, which the
// dense decode kernel shares: K and V stream through a four-stage ring of
// TMA tiles (kTK cache rows, 8 KB of K and of V), a tile is scored at once
// with one max and sum a tile and head, and the last live split of a
// (row, KV head, head tile) to finish merges the partial states in split
// order in the same launch and resets its counter.  What is paged here is
// the copy: thread 0 reads page_table[b, g] and issues the tile as TMA
// boxes of whole rows of one KV head from one 4-d map of the pool, seen as
// (1, G * T, KV, D), at token coordinate phys * T + t.  A box is
// min(kTK, the largest power of two dividing T) rows, so it never crosses
// a group: a tile wider than a group (bf16 at D <= 128 with T = 16) is
// several boxes, one a group, all counted by one expect_tx.  Boxes past
// the length are not issued.  The launcher takes the pool's two maps from
// a cache of encoded maps (hopper.cuh): the engine's pools keep their
// addresses, so a decode step encodes none after its first.
//
// A page-table entry outside [0, G) or a length outside [0, MAXG * T]
// cannot be checked on the host without a device round trip, and TMA
// would fill an out-of-range box with zeros silently.  So before any copy
// the block checks every entry its split reads (its threads at once); a
// bad one sends the block straight to its end, where it writes NaN, or a
// partial that makes the merged row NaN.  A bad length gives a NaN row.

#include "decode_core.cuh"

namespace {

// Thread 0's copies of tile i of a split: a box of box_rows whole pool rows
// of KV head kvh for each box_rows of the tile's tokens below the split's
// end, at the physical group the page table gives.  A functor of values
// (no references to the kernel's locals), so it inlines whole.
template <typename T, int D>
struct PagedIssue {
  const CUtensorMap *tm_k, *tm_v;
  const int* table;  // the row's page-table entries
  int t0, t1, group_tokens, box_rows, kvh;

  __device__ __forceinline__ void operator()(int i, uint32_t bar,
                                             uint32_t dst) const {
    using C = DecShape<T, D>;
    const int p0 = t0 + i * C::kTK;
    const int boxes = (min(C::kTK, t1 - p0) + box_rows - 1) / box_rows;
    mbar_expect_tx(bar, 2 * boxes * box_rows * C::kRow);
    for (int r = 0; r < boxes; ++r) {
      const int p = p0 + r * box_rows;
      const int g = p / group_tokens;
      const int row = __ldg(table + g) * group_tokens + (p - g * group_tokens);
      const uint32_t at = dst + r * box_rows * C::kRow;
      tma_load(at, tm_k, bar, 0, kvh, row, 0);
      tma_load(at + C::kTile, tm_v, bar, 0, kvh, row, 0);
    }
  }
};

template <typename T, int D, int GQ>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const T* __restrict__ q,
    const int* __restrict__ page_table, const int* __restrict__ lengths,
    float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc, int* __restrict__ counters,
    T* __restrict__ out, int n_groups, int group_tokens, int box_rows,
    int maxg, int kv_heads, int gq, int n_tiles, int split_tokens,
    int n_split, float scale) {
  using C = DecShape<T, D>;
  // the KV heads of a split side by side: whole cache rows together
  const int split = blockIdx.y, head_block = blockIdx.x;
  const int kvh = head_block / n_tiles;
  const int h0 = (head_block - kvh * n_tiles) * GQ;
  const int b = blockIdx.z;
  const int n_heads = min(GQ, gq - h0);
  const size_t row0 = ((size_t)b * kv_heads + kvh) * gq + h0;  // query row

  const int length = lengths[b];
  if (length <= 0 || length > maxg * group_tokens) {
    // nothing to attend to (zeros, as the TPU kernel), or a length out
    // of range (NaN)
    if (split == 0) {
      const float y = length == 0 ? 0.f : __int_as_float(0x7fc00000);
      for (int i = threadIdx.x; i < n_heads * D; i += kThreads)
        store_f32(y, out + row0 * D + i);
    }
    return;
  }
  const int n_active = (length + split_tokens - 1) / split_tokens;
  if (split >= n_active) return;  // past the length: not in the merge
  const int t0 = split * split_tokens;
  const int t1 = min(t0 + split_tokens, length);
  // every page-table entry of the split, checked by the block at once
  const int* const table = page_table + (size_t)b * maxg;
  int bad = 0;
  for (int g = t0 / group_tokens + (int)threadIdx.x; g * group_tokens < t1;
       g += kThreads) {
    const int phys = table[g];
    bad |= phys < 0 || phys >= n_groups;
  }
  const SplitWork w{row0, n_heads, t0, t1, C::kTK, split, n_active, n_split,
                    counters + (size_t)b * kv_heads * n_tiles + head_block,
                    bad};
  const PagedIssue<T, D> issue{&tm_k, &tm_v, table, t0, t1, group_tokens,
                               box_rows, kvh};
  decode_split<T, D, GQ>(q, w, issue, part_m, part_l, part_acc, out, scale);
}

// One launch, for the instantiation `dispatch` picks.
struct PagedLaunch {
  const void *q, *kp, *vp;
  const int *pt, *len;
  float *part_m, *part_l, *part_acc;
  int* counters;
  void* out;
  int batch, kv_heads, head_dim, gq, n_groups, group_tokens, maxg,
      split_tokens;
  cudaStream_t stream;

  template <typename T, int D, int GQ>
  cudaError_t run() const {
    using C = DecShape<T, D>;
    if (split_tokens % C::kTK != 0) return cudaErrorInvalidValue;
    // boxes of whole rows that never cross a group
    const int box_rows = min(C::kTK, group_tokens & -group_tokens);
    const CUtensorMapDataType dt = sizeof(T) == 2
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    const int rows = n_groups * group_tokens;
    CUtensorMap tm_k, tm_v;
    if (!cached_tensor_map_4d(&tm_k, dt, C::kSize, kp, D, kv_heads, rows, 1,
                              D, box_rows, CU_TENSOR_MAP_SWIZZLE_NONE) ||
        !cached_tensor_map_4d(&tm_v, dt, C::kSize, vp, D, kv_heads, rows, 1,
                              D, box_rows, CU_TENSOR_MAP_SWIZZLE_NONE))
      return cudaErrorInvalidValue;
    auto* kernel = paged_decode_kernel<T, D, GQ>;
    constexpr int bytes = smem_bytes<T, D, GQ>();
    const cudaError_t err = allow_smem<T, D, GQ>(kernel);
    if (err != cudaSuccess) return err;
    const int n_tiles = (gq + GQ - 1) / GQ;
    const int n_split =
        (maxg * group_tokens + split_tokens - 1) / split_tokens;
    const dim3 grid(kv_heads * n_tiles, n_split, batch);
    kernel<<<grid, kThreads, bytes, stream>>>(
        tm_k, tm_v, static_cast<const T*>(q), pt, len, part_m, part_l,
        part_acc, counters, static_cast<T*>(out), n_groups, group_tokens,
        box_rows, maxg, kv_heads, gq, n_tiles, split_tokens, n_split,
        1.0f / sqrtf((float)head_dim));
    return cudaGetLastError();
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  split_tokens: the tokens a block
// owns, a multiple of group_tokens and of the instantiation's tile (the
// wrapper's `tile_tokens`).  part_m, part_l: (B, H, ceil(MAXG * T /
// split_tokens)) f32 scratch; part_acc: the same with a trailing D.
// counters: at least B * KV * ceil(H / KV / tile) int32, zero before the
// first launch; the kernel leaves them at zero.  Returns 0 on success,
// else a cudaError_t code (cudaErrorInvalidValue for a shape the kernel
// does not take).  Launches on `stream` and does not synchronise.
extern "C" int repro_paged_flash_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const int* page_table, const int* lengths, float* part_m, float* part_l,
    float* part_acc, int* counters, void* out, int batch, int heads,
    int kv_heads, int head_dim, int n_groups, int group_tokens, int maxg,
    int dtype, int split_tokens, void* stream) {
  int tile;
  if (batch < 1 || n_groups < 1 || maxg < 1 || group_tokens < 16 ||
      group_tokens % 16 != 0 || split_tokens < 1 ||
      split_tokens % group_tokens != 0 ||
      !decode_plan(heads, kv_heads, head_dim, &tile))
    return (int)cudaErrorInvalidValue;
  const PagedLaunch launch{q,        k_pages,  v_pages,  page_table,
                           lengths,  part_m,   part_l,   part_acc,
                           counters, out,      batch,    kv_heads,
                           head_dim, heads / kv_heads,   n_groups,
                           group_tokens,       maxg,     split_tokens,
                           static_cast<cudaStream_t>(stream)};
  return (int)dispatch(dtype, head_dim, tile, launch, cudaErrorInvalidValue);
}

// The dynamic shared memory (bytes) one block asks for at this head layout
// and dtype (the kernel has no static shared memory: the same figure as
// the dense decode kernel's); -1 for a layout the kernel does not take.
// The tuning space's smem_footprint must give the same number
// (chip_smoke.py checks it).
extern "C" int repro_paged_smem_bytes(int heads, int kv_heads, int head_dim,
                                      int dtype) {
  int tile;
  if (!decode_plan(heads, kv_heads, head_dim, &tile)) return -1;
  return dispatch(dtype, head_dim, tile, DecodeSmem{}, -1);
}
