// Paged flash-decode attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `paged_flash_decode_pallas`
// (src/repro/kernels/paged_attention.py).  It computes the same function:
// one new query token per sequence attends to that sequence's KV cache,
// which lives in a pool of fixed-size token groups addressed through a page
// table.  Online softmax in f32 over the sequence's tokens, scale
// 1/sqrt(D), denominator clamped at 1e-30; tokens at or past lengths[b]
// are never read, so a sequence streams only its own valid K/V.
//
//   q          (B, H, D)          bf16 or f32
//   k_pages    (G, T, KV, D)      same dtype as q; T tokens per group
//   v_pages    (G, T, KV, D)
//   page_table (B, MAXG) int32    logical group -> physical group
//   lengths    (B,) int32         valid tokens per sequence
//   out        (B, H, D)          q's dtype
//
// Design.  The TPU kernel walks a sequential grid axis over the logical
// groups and carries the softmax state in VMEM scratch from one grid step
// to the next.  Blocks on Hopper run in no order, so here one block owns
// one (batch row, KV head) pair (grid z tiles the query heads of a KV head
// when there are more than 8 of them) and loops over the tokens itself.
// The block reads page_table[b, g] itself (the TPU kernel's scalar
// prefetch + index_map).  Each of the block's NW warps takes every NW-th
// token of the sequence (NW: the most the instantiation's registers allow,
// up to 32, unless the caller sets it); its lanes split the head
// dimension, so one token's K or V row is a single coalesced read
// (16 bytes a lane for bf16 at D=256).  All query heads that share the
// KV head (GQA) are scored against the row while it sits in registers, so
// each K/V byte is read from device memory once.  Each warp keeps its own online-softmax state (m, l, acc) in
// registers; the warps' states are merged through shared memory at the
// end, in a fixed order, so the result does not change from run to run.
//
// Bound.  The kernel must read the K and V rows of the valid tokens:
// 2 * sum(lengths) * KV * D * sizeof(T) bytes, at most 3.35 TB/s on an
// H100 SXM.  Its arithmetic (4 * H * D flops a token) is far below the
// card's ridge point, so it is bound by bytes.
//
// This first version is simple and correct.  At serve batch sizes
// B * KV blocks can leave SMs idle; splitting the token axis across blocks
// with a second combine pass (flash-decoding), and staging K/V through
// shared memory with cp.async or TMA, are later changes.
//
// A page-table entry outside [0, G) or a length outside [0, MAXG * T]
// cannot be checked on the host without a device round trip; the kernel
// writes NaN for that row instead of reading out of bounds.

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 32;

// VEC: head-dim elements per lane (D / 32, at least 1: for D < 32 the
// lanes past D idle).  GQ: query heads per block (a power of two >= the
// heads this block owns).
template <typename T, int VEC, int GQ>
__global__ void paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ page_table,
    const int* __restrict__ lengths, T* __restrict__ out, int n_groups,
    int group_tokens, int kv_heads, int head_dim, int gq, int maxg,
    float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int h0 = blockIdx.z * GQ;  // first head of this tile within the group
  const int n_heads = min(GQ, gq - h0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int d0 = lane * VEC;
  const bool lane_on = d0 < head_dim;
  const int H = kv_heads * gq;

  __shared__ float s_m[kMaxWarps][GQ];
  __shared__ float s_l[kMaxWarps][GQ];
  __shared__ float s_acc[GQ][VEC * 32];

  float qv[GQ][VEC];
#pragma unroll
  for (int h = 0; h < GQ; ++h) {
    if (h < n_heads && lane_on) {
      const size_t row = (size_t)b * H + (size_t)kvh * gq + h0 + h;
      load_f32<T, VEC>(q + row * head_dim + d0, qv[h]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) qv[h][i] *= scale;
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) qv[h][i] = 0.f;
    }
  }

  float m[GQ], l[GQ], acc[GQ][VEC];
#pragma unroll
  for (int h = 0; h < GQ; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[h][i] = 0.f;
  }

  const int length = lengths[b];
  int bad = length < 0 || length > maxg * group_tokens;
  const size_t tok_stride = (size_t)kv_heads * head_dim;
  const int* row_table = page_table + (size_t)b * maxg;
  for (int tok = warp; !bad && tok < length; tok += n_warps) {
    const int g = tok / group_tokens;
    const int t = tok - g * group_tokens;
    const int phys = row_table[g];
    if (phys < 0 || phys >= n_groups) {
      bad = 1;  // warp-uniform: every lane read the same entry
      break;
    }
    const size_t off = ((size_t)phys * group_tokens + t) * tok_stride +
                       (size_t)kvh * head_dim + d0;
    float kr[VEC], vr[VEC];
    if (lane_on) {
      load_f32<T, VEC>(k_pages + off, kr);
      load_f32<T, VEC>(v_pages + off, vr);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) kr[i] = vr[i] = 0.f;
    }
#pragma unroll
    for (int h = 0; h < GQ; ++h) {
      if (h >= n_heads) break;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) s += qv[h][i] * kr[i];
      s = warp_sum(s);
      const float m_new = fmaxf(m[h], s);
      const float alpha = expf(m[h] - m_new);
      const float p = expf(s - m_new);
      l[h] = l[h] * alpha + p;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[h][i] = acc[h][i] * alpha + p * vr[i];
      m[h] = m_new;
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < GQ; ++h) {
      s_m[warp][h] = m[h];
      s_l[warp][h] = l[h];
    }
  }
  for (int i = threadIdx.x; i < GQ * VEC * 32; i += blockDim.x)
    (&s_acc[0][0])[i] = 0.f;
  bad = __syncthreads_or(bad);

  // Merge the warps' partial states in warp order (deterministic).
  __shared__ float s_mx[GQ];
  __shared__ float s_den[GQ];
  if (threadIdx.x < GQ) {
    const int h = threadIdx.x;
    float mx = kNegInf;
    for (int w = 0; w < n_warps; ++w) mx = fmaxf(mx, s_m[w][h]);
    float den = 0.f;
    for (int w = 0; w < n_warps; ++w) den += s_l[w][h] * expf(s_m[w][h] - mx);
    s_mx[h] = mx;
    s_den[h] = den;
  }
  __syncthreads();
  for (int w = 0; w < n_warps; ++w) {
    if (warp == w && lane_on) {
#pragma unroll
      for (int h = 0; h < GQ; ++h) {
        const float c = expf(m[h] - s_mx[h]);
#pragma unroll
        for (int i = 0; i < VEC; ++i) s_acc[h][d0 + i] += acc[h][i] * c;
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n_heads * head_dim; i += blockDim.x) {
    const int h = i / head_dim;
    const int d = i - h * head_dim;
    const float y = bad ? __int_as_float(0x7fc00000)
                        : s_acc[h][d] / fmaxf(s_den[h], 1e-30f);
    const size_t row = (size_t)b * H + (size_t)kvh * gq + h0 + h;
    store_f32(y, out + row * head_dim + d);
  }
}

// The block size of an instantiation when the caller leaves it open: the
// most warps (a power of two, at most kMaxWarps) that one block can launch
// with the registers the instantiation uses.  More warps keep more K/V
// loads in flight per block, which is what sets the time while B * KV
// blocks are about one per SM.
template <typename T, int VEC, int GQ>
cudaError_t auto_warps(int* warps) {
  static int cached = 0;  // a race only writes the same value twice
  if (cached == 0) {
    const cudaError_t err = max_launchable_warps(
        paged_decode_kernel<T, VEC, GQ>, kMaxWarps, &cached);
    if (err != cudaSuccess) return err;
  }
  *warps = cached;
  return cudaSuccess;
}

// One launch, for the instantiation dispatch_decode picks.
struct PagedLaunch {
  const void *q, *kp, *vp, *pt, *len;
  void* out;
  int batch, kv_heads, head_dim, gq, n_groups, group_tokens, maxg, num_warps;
  cudaStream_t stream;

  template <typename T, int VEC, int GQ>
  cudaError_t run() const {
    int warps = num_warps;
    if (warps == 0) {
      const cudaError_t err = auto_warps<T, VEC, GQ>(&warps);
      if (err != cudaSuccess) return err;
    }
    const dim3 grid(kv_heads, batch, (gq + GQ - 1) / GQ);
    const float scale = 1.0f / sqrtf((float)head_dim);
    paged_decode_kernel<T, VEC, GQ><<<grid, warps * 32, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp),
        static_cast<const T*>(vp), static_cast<const int*>(pt),
        static_cast<const int*>(len), static_cast<T*>(out), n_groups,
        group_tokens, kv_heads, head_dim, gq, maxg, scale);
    return cudaGetLastError();
  }
};

struct PagedSmem {
  template <typename T, int VEC, int GQ>
  int run() const {
    return static_smem_bytes(paged_decode_kernel<T, VEC, GQ>);
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  num_warps: the block size in warps
// (a power of two up to kMaxWarps), or 0 to take the largest the
// instantiation can launch.  Returns 0 on success, else a cudaError_t
// code (cudaErrorInvalidValue for a shape the kernel does not take).
// Launches on `stream` and does not synchronise.
extern "C" int repro_paged_flash_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out, int batch,
    int heads, int kv_heads, int head_dim, int n_groups, int group_tokens,
    int maxg, int dtype, int num_warps, void* stream) {
  int vec, tile;
  if (batch < 1 || n_groups < 1 || maxg < 1 || group_tokens < 16 ||
      group_tokens % 16 != 0 || num_warps < 0 || num_warps > kMaxWarps ||
      (num_warps & (num_warps - 1)) != 0 ||
      !decode_plan(heads, kv_heads, head_dim, &vec, &tile))
    return (int)cudaErrorInvalidValue;
  const PagedLaunch launch{q, k_pages, v_pages, page_table, lengths, out,
                           batch, kv_heads, head_dim, heads / kv_heads,
                           n_groups, group_tokens, maxg, num_warps,
                           static_cast<cudaStream_t>(stream)};
  return (int)dispatch_decode(dtype, vec, tile, launch, cudaErrorInvalidValue);
}

// The shared memory (bytes, all of it static) of one block of the
// instantiation that serves this head layout and dtype, as compiled; -1
// for a layout the kernel does not take.  The tuning space's
// smem_footprint must give the same number (chip_smoke.py checks it).
extern "C" int repro_paged_smem_bytes(int heads, int kv_heads, int head_dim,
                                      int dtype) {
  int vec, tile;
  if (!decode_plan(heads, kv_heads, head_dim, &vec, &tile)) return -1;
  return dispatch_decode(dtype, vec, tile, PagedSmem{}, -1);
}
