// Flash-decode attention over a dense KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_decode_pallas`
// (src/repro/kernels/decode_attention.py).  It computes the same function:
// one new query token per sequence attends to the first kv_len entries of
// a dense cache; kv_len is one scalar for the whole batch.  Online softmax
// in f32, scale 1/sqrt(D), denominator clamped at 1e-30; cache entries at
// or past kv_len are never read, so a cache filled to 2k of 32k streams 2k.
// At kv_len == 0 it writes zeros, as the Pallas kernel does.
//
//   q       (B, H, D)        bf16 or f32
//   k, v    (B, S, KV, D)    q's dtype
//   kv_len  int32 scalar: read on the device from a pointer (a 0-d tensor)
//           so the host never waits on it, or passed by value
//   out     (B, H, D)        q's dtype
//
// Design.  The TPU kernel walks a sequential grid axis over blocks of
// block_kv cache entries and carries the softmax state in VMEM scratch.
// Here the cache axis is split across blocks instead (flash-decoding): one
// block owns (split, KV head, batch row) and the block_kv entries of its
// split, and a second small kernel merges the splits' partial states
// (m, l, acc) in split order, so results do not change from run to run.
// block_kv thus trades parallelism (B * KV * ceil(S / block_kv) blocks
// fill the 132 SMs even at B = 1) against the partial states written and
// merged.  Inside a block the code follows paged_attention.cu's kernel,
// with dense addressing, a token range and a partial state for output (a
// copy of its loop; the helpers, the head-tile plan and the instantiation
// dispatch are shared through common.cuh): each warp takes every NW-th
// entry of the split, its lanes split the head dim (one coalesced 16-byte
// load a lane for bf16 at D=256), and all query heads of the KV head (GQA)
// are scored against the row while it sits in registers, so each K/V byte
// is read once.  The warps' states merge through shared memory in warp
// order.
//
// Bound.  The kernel must read the K and V rows of the first kv_len
// entries: 2 * B * kv_len * KV * D * sizeof(T) bytes, at most 3.35 TB/s on
// an H100 SXM; its 4 * B * H * kv_len * D flops are far below the ridge
// point, so it is bound by bytes.  The partial states add
// B * H * ceil(S / block_kv) * (D + 2) * 4 bytes each way.

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 32;

// One (split, KV head, head tile, batch row): the partial softmax state
// of the split's entries for each of the tile's query heads.  VEC and GQ
// as in paged_attention.cu.
template <typename T, int VEC, int GQ>
__global__ void decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ kv_len_ptr,
    int kv_len_value, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc, int seq,
    int kv_heads, int head_dim, int gq, int n_tiles, int block_kv,
    int n_split, float scale) {
  const int split = blockIdx.x;
  const int kvh = blockIdx.y / n_tiles;
  const int h0 = (blockIdx.y - kvh * n_tiles) * GQ;
  const int b = blockIdx.z;
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
  __shared__ float s_mx[GQ];
  __shared__ float s_den[GQ];

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

  const int kv_len =
      min(max(kv_len_ptr ? *kv_len_ptr : kv_len_value, 0), seq);
  const int t0 = split * block_kv;
  const int t1 = min(t0 + block_kv, kv_len);
  const size_t tok_stride = (size_t)kv_heads * head_dim;
  const T* k_row = k + (size_t)b * seq * tok_stride + (size_t)kvh * head_dim;
  const T* v_row = v + (size_t)b * seq * tok_stride + (size_t)kvh * head_dim;
  for (int tok = t0 + warp; tok < t1; tok += n_warps) {
    const size_t off = (size_t)tok * tok_stride + d0;
    float kr[VEC], vr[VEC];
    if (lane_on) {
      load_f32<T, VEC>(k_row + off, kr);
      load_f32<T, VEC>(v_row + off, vr);
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
  __syncthreads();

  // Merge the warps' states in warp order (deterministic).
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
    const size_t row = (size_t)b * H + (size_t)kvh * gq + h0 + h;
    const size_t slot = row * n_split + split;
    if (d == 0) {
      part_m[slot] = s_mx[h];
      part_l[slot] = s_den[h];
    }
    part_acc[slot * head_dim + d] = s_acc[h][d];
  }
}

// One (query head, batch row): merge the splits' partial states in split
// order.  A split past kv_len holds m = -1e30, l = 0, acc = 0 and adds
// nothing; when every split is empty (kv_len == 0) the output is 0.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      T* __restrict__ out, int head_dim,
                                      int n_split) {
  const size_t row = blockIdx.x;
  const float* pm = part_m + row * n_split;
  const float* pl = part_l + row * n_split;
  float mx = kNegInf;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, pm[s]);
  float den = 0.f;
  for (int s = 0; s < n_split; ++s) den += pl[s] * expf(pm[s] - mx);
  const float inv = 1.f / fmaxf(den, 1e-30f);
  for (int d = threadIdx.x; d < head_dim; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < n_split; ++s)
      a += part_acc[(row * n_split + s) * head_dim + d] * expf(pm[s] - mx);
    store_f32(a * inv, out + row * head_dim + d);
  }
}

struct DecodeLaunch {
  const void *q, *k, *v;
  const int* kv_len_ptr;
  int kv_len_value;
  float *part_m, *part_l, *part_acc;
  void* out;
  int batch, seq, kv_heads, head_dim, gq, block_kv, num_warps;
  cudaStream_t stream;

  template <typename T, int VEC, int GQ>
  cudaError_t run() const {
    int warps = num_warps;
    if (warps == 0) {
      // the most warps the registers allow, but at least 8 entries a warp
      static int reg_warps = 0;  // a race only writes the same value twice
      if (reg_warps == 0) {
        const cudaError_t err = max_launchable_warps(
            decode_split_kernel<T, VEC, GQ>, kMaxWarps, &reg_warps);
        if (err != cudaSuccess) return err;
      }
      warps = reg_warps;
      while (warps > 1 && warps * 8 > block_kv) warps >>= 1;
    }
    const int n_tiles = (gq + GQ - 1) / GQ;
    const int n_split = (seq + block_kv - 1) / block_kv;
    const dim3 grid(n_split, kv_heads * n_tiles, batch);
    decode_split_kernel<T, VEC, GQ><<<grid, warps * 32, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), kv_len_ptr, kv_len_value, part_m, part_l,
        part_acc, seq, kv_heads, head_dim, gq, n_tiles, block_kv, n_split,
        1.0f / sqrtf((float)head_dim));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int threads = head_dim < 32 ? 32 : head_dim;
    decode_combine_kernel<T><<<batch * kv_heads * gq, threads, 0, stream>>>(
        part_m, part_l, part_acc, static_cast<T*>(out), head_dim, n_split);
    return cudaGetLastError();
  }
};

struct DecodeSmem {
  template <typename T, int VEC, int GQ>
  int run() const {
    return static_smem_bytes(decode_split_kernel<T, VEC, GQ>);
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  kv_len_ptr: a device int32, or null
// to use kv_len_value.  part_m, part_l: (B, H, ceil(S / block_kv)) f32
// scratch; part_acc: the same with a trailing D.  num_warps: the block
// size of the split kernel in warps (a power of two up to kMaxWarps), or
// 0 for the most its registers allow, at least 8 entries a warp.  Returns
// 0 on success, else a cudaError_t code (cudaErrorInvalidValue for a shape
// the kernel does not take).  Launches on `stream`, does not synchronise.
extern "C" int repro_flash_decode(
    const void* q, const void* k, const void* v, const int* kv_len_ptr,
    int kv_len_value, float* part_m, float* part_l, float* part_acc,
    void* out, int batch, int seq, int heads, int kv_heads, int head_dim,
    int dtype, int block_kv, int num_warps, void* stream) {
  int vec, tile;
  if (batch < 1 || seq < 1 || block_kv < 1 || num_warps < 0 ||
      num_warps > kMaxWarps || (num_warps & (num_warps - 1)) != 0 ||
      !decode_plan(heads, kv_heads, head_dim, &vec, &tile))
    return (int)cudaErrorInvalidValue;
  const DecodeLaunch launch{q, k, v, kv_len_ptr, kv_len_value, part_m,
                            part_l, part_acc, out, batch, seq, kv_heads,
                            head_dim, heads / kv_heads, block_kv, num_warps,
                            static_cast<cudaStream_t>(stream)};
  return (int)dispatch_decode(dtype, vec, tile, launch, cudaErrorInvalidValue);
}

// The shared memory (bytes, all of it static) of one split-kernel block
// for this head layout and dtype, as compiled; -1 for a layout the kernel
// does not take.  The tuning space's smem_footprint must give the same
// number (chip_smoke.py checks it).
extern "C" int repro_flash_decode_smem_bytes(int heads, int kv_heads,
                                             int head_dim, int dtype) {
  int vec, tile;
  if (!decode_plan(heads, kv_heads, head_dim, &vec, &tile)) return -1;
  return dispatch_decode(dtype, vec, tile, DecodeSmem{}, -1);
}
