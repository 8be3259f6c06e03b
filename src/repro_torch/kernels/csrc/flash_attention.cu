// Flash attention (prefill / train) for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py).  It computes the same function:
// GQA attention (query head h reads KV head h / (H / KV)) with a causal
// mask, a sliding window and a query offset as runtime arguments, online
// softmax in f32 over tiles of block_kv keys, scale 1/sqrt(D), output
// acc / max(l, 1e-30) cast to the input dtype.  The tile geometry and the
// numerics are the reference's: a tile wholly above the causal diagonal or
// wholly left of the window is skipped; inside a reachable tile a masked
// score is -1e30, not -inf, so a row whose keys are all masked there keeps
// exp(0) = 1 terms until a real score's alpha wipes them out; key rows past
// Sk are zero (the reference pads K and V with zeros) and masked.
//
//   q    (B, Sq, H, D)    bf16 or f32
//   k, v (B, Sk, KV, D)   q's dtype
//   out  (B, Sq, H, D)    q's dtype
//
// Design.  The TPU kernel keeps one (block_q x D) query tile and its
// (m, l, acc) state in VMEM and walks the key tiles on a sequential grid
// axis.  Here one block owns one (query tile, head, batch row) and loops
// over the key tiles itself.  A block's warps share each K/V tile through
// shared memory and split the tile's query rows between them.  The f32
// accumulator of a tile (block_q x D, 64 KB at block_q = 64, D = 256) does
// not fit registers, so it lives in shared memory beside the scaled query
// tile; a warp reads and writes its row's slice once per key tile.  For
// one row, each lane scores block_kv / 32 keys (the key tile is stored
// with rows padded by 4 bytes, so the lanes' column reads hit distinct
// banks), the row max and sum are warp reductions, and the P.V product
// hands each probability from its lane to the warp by shuffle while each
// lane accumulates D / 32 output columns.  block_q, block_kv and num_warps
// are runtime values with dynamic shared memory; only the dtype and the
// head dim (8 to 256) are template arguments, 12 instantiations in all.
//
// Bound.  Causal attention at B=1, S=4096, H=16, D=256 does about 1.4e11
// flops of Q.K and P.V (989 TFLOP/s dense bf16 on the tensor cores: 0.14
// ms) and must move q, k, v and the output once (134 MB, 0.04 ms), so it is
// bound by operations.  This first version computes on the CUDA cores in
// f32, without wgmma or TMA: it is far from that bound (PERF.md).

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 16;
constexpr int kMaxKeysPerLane = 4;  // block_kv <= 128

// Key-tile row stride in elements: D plus 4 bytes, so lane j's read of
// column d of row j lands on bank (j * stride_words + d') % 32, distinct
// across the warp for every D this kernel takes.
template <typename T, int D>
__host__ __device__ constexpr int kv_stride() {
  return D + 4 / int(sizeof(T));
}

// Dynamic shared memory of one block: the scaled query tile and the
// accumulator (f32), the row state m and l, and the K and V tiles.
template <typename T, int D>
size_t smem_bytes(int block_q, int block_kv) {
  return (size_t)(2 * block_q * D + 2 * block_q) * sizeof(float) +
         (size_t)2 * block_kv * kv_stride<T, D>() * sizeof(T);
}

// s[jj] += q_row . k_s[lane + 32 * jj] for the N key rows a lane owns
// (rows past the tile read its last row; the caller drops them).
template <typename T, int D, int N>
__device__ __forceinline__ void score_keys(const float* q_row, const T* k_s,
                                           int lane, int block_kv,
                                           float (&s)[kMaxKeysPerLane]) {
  const T* k_row[N];
#pragma unroll
  for (int jj = 0; jj < N; ++jj)
    k_row[jj] = k_s + min(lane + 32 * jj, block_kv - 1) * kv_stride<T, D>();
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float qd = q_row[d];
#pragma unroll
    for (int jj = 0; jj < N; ++jj) s[jj] += qd * to_f32(k_row[jj][d]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kMaxWarps * 32) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk, int H,
    int KV, int causal, int window, int q_offset, int block_q,
    int block_kv, float scale) {
  constexpr int DPL = D < 32 ? 1 : D / 32;  // output columns per lane
  constexpr int KS = kv_stride<T, D>();
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [block_q][D], scaled
  float* acc_s = q_s + block_q * D;               // [block_q][D]
  float* m_s = acc_s + block_q * D;               // [block_q]
  float* l_s = m_s + block_q;                     // [block_q]
  T* k_s = reinterpret_cast<T*>(l_s + block_q);   // [block_kv][KS]
  T* v_s = k_s + block_kv * KS;                   // [block_kv][KS]

  const int iq = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int q_start = iq * block_q;
  const int q_abs = q_offset + q_start;  // absolute position of row 0
  const int rows = min(block_q, Sq - q_start);

  for (int i = threadIdx.x; i < block_q * D; i += blockDim.x) {
    const int r = i / D;
    const int d = i - r * D;
    float x = 0.f;
    if (r < rows)
      x = to_f32(q[(((size_t)b * Sq + q_start + r) * H + h) * D + d]) * scale;
    q_s[i] = x;
    acc_s[i] = 0.f;
  }
  for (int r = threadIdx.x; r < block_q; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int n_kv = (Sk + block_kv - 1) / block_kv;
  for (int ik = 0; ik < n_kv; ++ik) {
    const int k_start = ik * block_kv;
    if (causal && k_start > q_abs + block_q - 1) break;  // above the diagonal
    if (window && k_start + block_kv - 1 <= q_abs - window) continue;
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < block_kv * D; i += blockDim.x) {
      const int j = i / D;
      const int d = i - j * D;
      T kx, vx;
      if (k_start + j < Sk) {
        const size_t off = (((size_t)b * Sk + k_start + j) * KV + kvh) * D + d;
        kx = k[off];
        vx = v[off];
      } else {
        store_f32(0.f, &kx);
        store_f32(0.f, &vx);
      }
      k_s[j * KS + d] = kx;
      v_s[j * KS + d] = vx;
    }
    __syncthreads();

    for (int r = warp; r < rows; r += n_warps) {
      const int qpos = q_abs + r;
      const float* q_row = q_s + r * D;
      // scores: lane owns keys j = lane + 32 * jj of the tile
      float s[kMaxKeysPerLane] = {0.f, 0.f, 0.f, 0.f};
      if (block_kv <= 32)
        score_keys<T, D, 1>(q_row, k_s, lane, block_kv, s);
      else if (block_kv <= 64)
        score_keys<T, D, 2>(q_row, k_s, lane, block_kv, s);
      else
        score_keys<T, D, 4>(q_row, k_s, lane, block_kv, s);
      float mt = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kMaxKeysPerLane; ++jj) {
        const int j = lane + 32 * jj;
        const int kpos = k_start + j;
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window) ok = ok && kpos > qpos - window;
        s[jj] = ok ? s[jj] : kNegInf;
        if (j < block_kv) mt = fmaxf(mt, s[jj]);
      }
      mt = warp_max(mt);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mt);
      const float alpha = expf(m_prev - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kMaxKeysPerLane; ++jj) {
        const float p =
            lane + 32 * jj < block_kv ? expf(s[jj] - m_new) : 0.f;
        s[jj] = p;
        psum += p;
      }
      psum = warp_sum(psum);

      float a[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        a[i] = d < D ? acc_s[r * D + d] * alpha : 0.f;
      }
#pragma unroll
      for (int jj = 0; jj < kMaxKeysPerLane; ++jj) {
        const int j0 = 32 * jj;
        // a guard, not a break, keeps s[jj] a register (no local memory)
        const int n = max(0, min(32, block_kv - j0));
        for (int t = 0; t < n; ++t) {
          const float p = __shfl_sync(0xffffffffu, s[jj], t);
          const T* v_row = v_s + (j0 + t) * KS;
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int d = lane + 32 * i;
            if (d < D) a[i] += p * to_f32(v_row[d]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc_s[r * D + d] = a[i];
      }
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + psum;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  for (int r = warp; r < rows; r += n_warps) {
    const float denom = fmaxf(l_s[r], 1e-30f);
    T* o_row = out + (((size_t)b * Sq + q_start + r) * H + h) * D;
    for (int d = lane; d < D; d += 32) store_f32(acc_s[r * D + d] / denom,
                                                 o_row + d);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int H, int KV, int causal,
                   int window, int q_offset, int block_q, int block_kv,
                   int num_warps, cudaStream_t stream) {
  auto* kernel = flash_attention_kernel<T, D>;
  if (num_warps == 0) {
    // the most warps the registers allow, but no more than the tile's rows
    static int reg_warps = 0;  // a race only writes the same value twice
    if (reg_warps == 0) {
      const cudaError_t err =
          max_launchable_warps(kernel, kMaxWarps, &reg_warps);
      if (err != cudaSuccess) return err;
    }
    num_warps = reg_warps;
    while (num_warps > 1 && num_warps > block_q) num_warps >>= 1;
  }
  const size_t bytes = smem_bytes<T, D>(block_q, block_kv);
  if (bytes > 48 * 1024) {  // above 48 KB a kernel must opt in, per device
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Sq + block_q - 1) / block_q, H, B);
  kernel<<<grid, num_warps * 32, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, KV, causal,
      window, q_offset, block_q, block_kv, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* out, int B, int Sq, int Sk, int H, int KV,
                     int causal, int window, int q_offset, int block_q,
                     int block_kv, int num_warps, cudaStream_t stream) {
#define REPRO_D_CASE(N)                                                      \
  case N:                                                                    \
    return launch<T, N>(q, k, v, out, B, Sq, Sk, H, KV, causal, window,     \
                        q_offset, block_q, block_kv, num_warps, stream);
  switch (D) {
    REPRO_D_CASE(8)
    REPRO_D_CASE(16)
    REPRO_D_CASE(32)
    REPRO_D_CASE(64)
    REPRO_D_CASE(128)
    REPRO_D_CASE(256)
  }
#undef REPRO_D_CASE
  return cudaErrorInvalidValue;
}

template <typename T>
long long smem_d(int D, int block_q, int block_kv) {
  switch (D) {
    case 8: return (long long)smem_bytes<T, 8>(block_q, block_kv);
    case 16: return (long long)smem_bytes<T, 16>(block_q, block_kv);
    case 32: return (long long)smem_bytes<T, 32>(block_q, block_kv);
    case 64: return (long long)smem_bytes<T, 64>(block_q, block_kv);
    case 128: return (long long)smem_bytes<T, 128>(block_q, block_kv);
    case 256: return (long long)smem_bytes<T, 256>(block_q, block_kv);
  }
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  block_q and block_kv are the tile
// sizes the reference's geometry uses (already clamped to Sq and Sk by the
// caller); block_kv <= 128.  num_warps: the block size in warps (a power
// of two up to kMaxWarps), or 0 for the most the registers allow, at most
// block_q.  Returns 0 on success, else a cudaError_t code
// (cudaErrorInvalidValue for a shape the kernel does not take).  Launches
// on `stream` and does not synchronise.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Sk, int H, int KV, int D, int dtype, int causal, int window,
    int q_offset, int block_q, int block_kv, int num_warps, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || block_q < 1 ||
      block_kv < 1 || block_kv > 32 * kMaxKeysPerLane || num_warps < 0 ||
      num_warps > kMaxWarps || (num_warps & (num_warps - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_d<float>(D, q, k, v, out, B, Sq, Sk, H, KV, causal,
                                window, q_offset, block_q, block_kv,
                                num_warps, s);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(D, q, k, v, out, B, Sq, Sk, H, KV,
                                        causal, window, q_offset, block_q,
                                        block_kv, num_warps, s);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory (bytes) one block asks for at these tiles;
// the kernel has no static shared memory.  -1 for a head dim or dtype the
// kernel does not take.  The tuning space's smem_footprint must give the
// same number (chip_smoke.py checks it).
extern "C" long long repro_flash_attention_smem_bytes(int D, int dtype,
                                                      int block_q,
                                                      int block_kv) {
  if (dtype == 0) return smem_d<float>(D, block_q, block_kv);
  if (dtype == 1) return smem_d<__nv_bfloat16>(D, block_q, block_kv);
  return -1;
}
