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
// byte is read from device memory once for up to 8 query heads.
//
// - Staging.  The split's K and V stream through a ring of 4 stages in
//   shared memory, a tile of TK tokens (8 KB of K and 8 KB of V: 16 tokens
//   at D=256 bf16) a stage, copied by the Tensor Memory Accelerator: one
//   thread issues each tile as one 2-d box of whole cache rows of one KV
//   head (tokens x D, row stride KV * D), which completes on the stage's
//   mbarrier, so up to 64 KB a block, three blocks an SM, are in flight
//   while the blocks compute.  The next tile's copy starts when the block
//   is done with the stage.
// - Scores of a whole tile at once: a token is scored by kP neighbouring
//   threads that split D in interleaved 16-byte chunks (so a warp's loads
//   of unswizzled rows hit distinct bank groups; their partial dot
//   products meet in shuffles), each scoring every query head of the tile
//   from the K chunk it loaded, against the scaled query held in shared
//   memory as f32.
// - One max and one sum a tile and head (a warp a head), so the output
//   accumulator is rescaled once a tile, not once a token.
// - P.V: each thread owns two columns of D over a fixed set of the tile's
//   tokens (every second one at D = 256), in two accumulator chains, so
//   no accumulator is merged across warps inside the loop; at the end the
//   token groups' sums meet in shared memory in a fixed order.
// - The split merge is fused: each block writes its partial state
//   (m, l, acc) to wrapper-owned scratch, and the last block of a (batch
//   row, KV head, head tile) to finish, as an int32 counter in wrapper-
//   owned scratch says, merges the partials in split order and resets the
//   counter to 0, so the next launch (or replay of a captured graph)
//   finds it at 0.  Results do not change from run to run.  A cache whose
//   valid entries fit one split needs no merge: that block writes the
//   output itself.
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

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;        // K/V tiles in flight a block
constexpr int kTileBytes = 8192;  // the most bytes of a K (V) tile
constexpr int kAlign = 128;       // of a TMA box's shared-memory destination

// Compile-time geometry of one (dtype, head dim) instantiation.
template <typename T, int D>
struct DecShape {
  static constexpr int kSize = int(sizeof(T));
  static constexpr int kRow = D * kSize;  // bytes of a cache row
  static constexpr int kTK =
      kTileBytes / kRow < 128 ? kTileBytes / kRow : 128;  // tokens a tile
  static constexpr int kTile = kTK * kRow;  // bytes of a K or V tile
  static constexpr int kCE = 16 / kSize;    // elements of a 16-byte chunk
  static constexpr int kChunks = D / kCE;   // chunks of a row
  static constexpr int kP =                 // threads scoring one token
      kThreads / kTK < kChunks ? kThreads / kTK : kChunks;
  static constexpr int kScorers = kTK * kP;     // whole warps
  static constexpr int kNC = D / 2;             // column pairs in P.V
  static constexpr int kNTG = kThreads / kNC;   // token groups in P.V
  static_assert(kScorers <= kThreads && kScorers % 32 == 0, "warps");
  static_assert(kTK % 8 == 0 && kTile % kAlign == 0, "aligned stages");
};

// Bytes of the ring, which at the end also holds the token groups' sums.
template <typename T, int D, int GQ>
__host__ __device__ constexpr int ring_bytes() {
  return kStages * 2 * DecShape<T, D>::kTile > 2 * kThreads * GQ * 4
             ? kStages * 2 * DecShape<T, D>::kTile
             : 2 * kThreads * GQ * 4;
}

// Dynamic shared memory of one block (the kernel has no static shared
// memory): alignment slack, the K/V ring, the scaled query (f32), the
// tile's scores, the softmax state (m, l, alpha, spare) a head, the
// stages' barriers and the last-block flag.
template <typename T, int D, int GQ>
constexpr int smem_bytes() {
  using C = DecShape<T, D>;
  return kAlign + ring_bytes<T, D, GQ>() + GQ * D * 4 + GQ * C::kTK * 4 +
         4 * GQ * 4 + kStages * 8 + 8;
}

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
  const int tid = threadIdx.x;

  const int kv_len =
      min(max(kv_len_ptr ? *kv_len_ptr : kv_len_value, 0), seq);
  if (kv_len == 0) {  // nothing to attend to: zeros, as the TPU kernel
    if (split == 0)
      for (int i = tid; i < n_heads * D; i += kThreads)
        store_f32(0.f, out + row0 * D + i);
    return;
  }
  const int n_active = (kv_len + block_kv - 1) / block_kv;
  if (split >= n_active) return;  // past kv_len: not part of the merge
  const int t0 = split * block_kv;
  const int t1 = min(t0 + block_kv, kv_len);
  const int n_tile = (t1 - t0 + tk - 1) / tk;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* const stages =
      smem_raw + ((kAlign - (smem_addr(smem_raw) & (kAlign - 1))) &
                  (kAlign - 1));
  float* const qs = reinterpret_cast<float*>(stages + ring_bytes<T, D, GQ>());
  float* const ps = qs + GQ * D;          // [GQ][kTK] scores, then p
  float* const st = ps + GQ * C::kTK;     // [4][GQ]: m, l, alpha, spare
  const uint32_t bar0 = smem_addr(st + 4 * GQ);
  int* const flag = reinterpret_cast<int*>(st + 4 * GQ + 2 * kStages);
  const uint32_t ring = smem_addr(stages);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // one thread issues every copy: tile i of the split into stage i % kStages
  auto load = [&](int i) {
    const int s = i % kStages;
    const uint32_t bar = bar0 + 8 * s;
    const uint32_t kdst = ring + s * 2 * C::kTile;
    mbar_expect_tx(bar, 2 * tk * C::kRow);
    tma_load(kdst, &tm_k, bar, 0, kvh, t0 + i * tk, b);
    tma_load(kdst + C::kTile, &tm_v, bar, 0, kvh, t0 + i * tk, b);
  };
  if (tid == 0)
    for (int i = 0; i < kStages && i < n_tile; ++i) load(i);

  for (int i = tid; i < GQ * D; i += kThreads) {
    const int h = i / D;
    qs[i] = h < n_heads ? to_f32(q[row0 * D + i]) * scale : 0.f;
  }
  if (tid < GQ) {
    st[tid] = kNegInf;
    st[GQ + tid] = 0.f;
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int sc_t = tid / C::kP;  // the token this thread scores
  const int sc_p = tid % C::kP;  // its part of D
  const int cp = tid % C::kNC;   // its column pair in P.V
  const int tg = tid / C::kNC;   // its token group in P.V
  float acc[2][GQ][2];  // even and odd tokens of the group: two chains
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int h = 0; h < GQ; ++h) acc[u][h][0] = acc[u][h][1] = 0.f;

  for (int i = 0; i < n_tile; ++i) {
    const int s = i % kStages;
    const uint8_t* const kt = stages + s * 2 * C::kTile;
    const uint8_t* const vt = kt + C::kTile;
    const int valid = min(tk, t1 - (t0 + i * tk));
    mbar_wait(bar0 + 8 * s, (i / kStages) & 1);

    // scores of the tile's tokens for every head of the tile
    float sc[GQ];
#pragma unroll
    for (int h = 0; h < GQ; ++h) sc[h] = 0.f;
    if (tid < C::kScorers) {  // whole warps
#pragma unroll
      for (int c = 0; c < C::kChunks / C::kP; ++c) {
        const int chunk = c * C::kP + sc_p;
        float kf[C::kCE];
        load_f32<T, C::kCE>(
            reinterpret_cast<const T*>(kt + sc_t * C::kRow + chunk * 16),
            kf);
#pragma unroll
        for (int h = 0; h < GQ; ++h) {
          const float4* qh =
              reinterpret_cast<const float4*>(qs + h * D + chunk * C::kCE);
#pragma unroll
          for (int e = 0; e < C::kCE / 4; ++e) {
            const float4 qv = qh[e];
            sc[h] += qv.x * kf[4 * e] + qv.y * kf[4 * e + 1] +
                     qv.z * kf[4 * e + 2] + qv.w * kf[4 * e + 3];
          }
        }
      }
    }
#pragma unroll
    for (int o = C::kP / 2; o > 0; o >>= 1)
#pragma unroll
      for (int h = 0; h < GQ; ++h)
        sc[h] += __shfl_xor_sync(0xffffffffu, sc[h], o);
    if (sc_p == 0 && tid < C::kScorers)
#pragma unroll
      for (int h = 0; h < GQ; ++h)
        ps[h * C::kTK + sc_t] = sc_t < valid ? sc[h] : -INFINITY;
    __syncthreads();

    // one max and one sum a head: p = exp(s - m_new), alpha for the rescale
    for (int h = warp; h < GQ; h += kThreads / 32) {
      float* const ph = ps + h * C::kTK;
      float mx = -INFINITY;
      for (int t = lane; t < C::kTK; t += 32) mx = fmaxf(mx, ph[t]);
      mx = warp_max(mx);
      const float m_old = st[h];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < C::kTK; t += 32) {
        const float p = expf(ph[t] - m_new);
        ph[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        st[h] = m_new;
        st[GQ + h] = st[GQ + h] * alpha + sum;
        st[2 * GQ + h] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P.V over this thread's tokens and column pair
#pragma unroll
    for (int h = 0; h < GQ; ++h) {
      const float alpha = st[2 * GQ + h];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        acc[u][h][0] *= alpha;
        acc[u][h][1] *= alpha;
      }
    }
#pragma unroll 2
    for (int t0_ = tg; t0_ < valid; t0_ += 2 * C::kNTG) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = t0_ + u * C::kNTG;
        if (t >= valid) break;
        float vf[2];
        load_f32<T, 2>(reinterpret_cast<const T*>(
                           vt + t * C::kRow + cp * 2 * C::kSize),
                       vf);
#pragma unroll
        for (int h = 0; h < GQ; ++h) {
          const float p = ps[h * C::kTK + t];
          acc[u][h][0] += p * vf[0];
          acc[u][h][1] += p * vf[1];
        }
      }
    }
    __syncthreads();  // the block is done with stage s and the scores
    if (tid == 0 && i + kStages < n_tile) load(i + kStages);
  }

  // the token groups' sums, in group order (every copy has landed and been
  // read: the ring is free)
  float* const red = reinterpret_cast<float*>(stages);  // [kNTG][GQ][D]
#pragma unroll
  for (int h = 0; h < GQ; ++h) {
    red[(tg * GQ + h) * D + 2 * cp] = acc[0][h][0] + acc[1][h][0];
    red[(tg * GQ + h) * D + 2 * cp + 1] = acc[0][h][1] + acc[1][h][1];
  }
  __syncthreads();
  auto summed = [&](int i) {  // element i = h * D + d of the split's acc
    float a = 0.f;
    for (int g = 0; g < C::kNTG; ++g) a += red[g * GQ * D + i];
    return a;
  };

  if (n_active == 1) {  // the only split: normalize and write
    for (int i = tid; i < n_heads * D; i += kThreads)
      store_f32(summed(i) / fmaxf(st[GQ + i / D], 1e-30f),
                out + row0 * D + i);
    return;
  }

  // the partial state (m, l, acc) of this split
  for (int i = tid; i < n_heads * D; i += kThreads) {
    const int h = i / D;
    part_acc[((row0 + h) * n_split + split) * D + (i - h * D)] = summed(i);
  }
  if (tid < n_heads) {
    part_m[(row0 + tid) * n_split + split] = st[tid];
    part_l[(row0 + tid) * n_split + split] = st[GQ + tid];
  }
  __threadfence();  // the partials are visible device-wide ...
  __syncthreads();
  if (tid == 0) {   // ... before this split counts itself done
    int* const ctr = counters + (size_t)b * kv_heads * n_tiles + head_block;
    const bool last = atomicAdd(ctr, 1) == n_active - 1;
    if (last) atomicExch(ctr, 0);  // ready for the next launch
    *flag = last;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();

  // the last split to finish merges all of them, in split order
  if (tid < n_heads) {
    const float* pm = part_m + (row0 + tid) * n_split;
    const float* pl = part_l + (row0 + tid) * n_split;
    float mx = kNegInf;
    for (int s = 0; s < n_active; ++s) mx = fmaxf(mx, __ldcg(pm + s));
    float den = 0.f;
    for (int s = 0; s < n_active; ++s)
      den += __ldcg(pl + s) * expf(__ldcg(pm + s) - mx);
    st[tid] = mx;
    st[GQ + tid] = 1.f / fmaxf(den, 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < n_heads * D; i += kThreads) {
    const int h = i / D;
    const size_t row = row0 + h;
    const float* pm = part_m + row * n_split;
    const float* pa = part_acc + row * n_split * D + (i - h * D);
    float a = 0.f;
    for (int s = 0; s < n_active; ++s)
      a += __ldcg(pa + (size_t)s * D) * expf(__ldcg(pm + s) - st[h]);
    store_f32(a * st[GQ + h], out + row0 * D + i);
  }
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
    if (!tensor_map_4d(&tm_k, dt, C::kSize, k, D, kv_heads, seq, batch, D,
                       tk, CU_TENSOR_MAP_SWIZZLE_NONE) ||
        !tensor_map_4d(&tm_v, dt, C::kSize, v, D, kv_heads, seq, batch, D,
                       tk, CU_TENSOR_MAP_SWIZZLE_NONE))
      return cudaErrorInvalidValue;
    auto* kernel = decode_kernel<T, D, GQ>;
    constexpr int bytes = smem_bytes<T, D, GQ>();
    if (bytes > 48 * 1024) {  // above 48 KB a kernel must opt in
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return err;
    }
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

struct DecodeSmem {
  template <typename T, int D, int GQ>
  int run() const {
    return smem_bytes<T, D, GQ>();
  }
};

// f.template run<T, D, GQ>() for (dtype, head_dim, tile); `bad` when no
// instantiation matches.
template <typename T, int D, typename F, typename R>
R dispatch_tile(int tile, const F& f, R bad) {
  switch (tile) {
    case 1: return f.template run<T, D, 1>();
    case 2: return f.template run<T, D, 2>();
    case 4: return f.template run<T, D, 4>();
    case 8: return f.template run<T, D, 8>();
  }
  return bad;
}

template <typename T, typename F, typename R>
R dispatch_dim(int head_dim, int tile, const F& f, R bad) {
  switch (head_dim) {
    case 8: return dispatch_tile<T, 8>(tile, f, bad);
    case 16: return dispatch_tile<T, 16>(tile, f, bad);
    case 32: return dispatch_tile<T, 32>(tile, f, bad);
    case 64: return dispatch_tile<T, 64>(tile, f, bad);
    case 128: return dispatch_tile<T, 128>(tile, f, bad);
    case 256: return dispatch_tile<T, 256>(tile, f, bad);
  }
  return bad;
}

template <typename F, typename R>
R dispatch(int dtype, int head_dim, int tile, const F& f, R bad) {
  if (dtype == 0) return dispatch_dim<float>(head_dim, tile, f, bad);
  if (dtype == 1) return dispatch_dim<__nv_bfloat16>(head_dim, tile, f, bad);
  return bad;
}

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
  int vec, tile;
  if (batch < 1 || seq < 1 || block_kv < 1 ||
      !decode_plan(heads, kv_heads, head_dim, &vec, &tile))
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
  int vec, tile;
  if (!decode_plan(heads, kv_heads, head_dim, &vec, &tile)) return -1;
  return dispatch(dtype, head_dim, tile, DecodeSmem{}, -1);
}
