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
// Bound.  Causal attention at B=1, S=4096, H=16, D=256 does about 1.4e11
// flops of Q.K and P.V (989 TFLOP/s dense bf16 on the tensor cores: 0.14
// ms) and must move q, k, v and the output once (134 MB, 0.04 ms), so it is
// bound by operations: only the tensor cores come near it.
//
// Two kernels, picked by dtype.
//
// bf16 (every path on the card): the tensor-core kernel, flash_tc_kernel.
// One block owns one query tile of block_q rows (the reference's tile) of
// one head, with one consumer warpgroup per 64 rows (block_q <= 64: one,
// a smaller tile masks the spare rows; 128: two).  Its K/V tiles arrive by
// TMA (cp.async.bulk.tensor, one thread issuing, an mbarrier a stage
// counting the bytes) into a ring of two stages in shared memory, so the
// copy of key tile j+1 runs while the warpgroups compute on tile j.  The
// tensor map spans (D, heads, S, B) with the (B, S, heads, D) strides; a
// box is 64 columns at most, so the 128-byte swizzle holds (a D=256 row
// tile is four boxes), rows past S arrive as zeros, and D=8 is read as a
// 16-column box whose columns 8-15 arrive as zeros.  The score product
// S = Q.K^T is wgmma m64n{BKV}k16 with Q and K K-major in shared memory
// (no transpose); its f32 accumulator stays in registers, where the online
// softmax runs on each thread's two rows (exp2 with log2(e) folded into the
// scale, the row max and sum over the 4 lanes of a quad).  The output
// product O += P.V is wgmma with P as the A operand from registers (the S
// accumulator converts pairwise into the bf16 A fragment, as in
// FlashAttention-3) and V, MN-major in shared memory, read through the
// instruction's transpose bit, 64 output columns an instruction.  The O
// accumulator lives in registers: 128 floats a thread at D=256.  block_kv
// (rounded up to 16, 32, 64 or 128 for the instruction's N; keys of the
// next tile in the rounded box are dropped, not masked) and D are template
// arguments; D=256 with block_kv 128 needs 256 KB of shared memory and is
// not built.  Blocks start with the query tiles that have the most live
// key tiles, so a causal grid's long tiles do not run last.
//
// f32 (the exact path, which TF32 could not hold to its 2e-5 tolerance):
// the CUDA-core kernel, flash_attention_kernel.  One block owns one
// (query tile, head, batch row); its warps share each K/V tile through
// shared memory and split the tile's query rows.  The f32 accumulator
// (block_q x D) lives in shared memory beside the scaled query tile; for
// one row each lane scores block_kv / 32 keys, the row max and sum are
// warp reductions, and P.V hands each probability from its lane to the
// warp by shuffle.  block_q and block_kv are runtime values, the block is
// the most warps the registers allow (at most block_q), and the head dim
// (8 to 256) is a template argument.

#include "common.cuh"

#include <cuda.h>  // CUtensorMap; the encoder is reached through the runtime

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
                   cudaStream_t stream) {
  auto* kernel = flash_attention_kernel<T, D>;
  // the most warps the registers allow, but no more than the tile's rows
  static int reg_warps = 0;  // a race only writes the same value twice
  if (reg_warps == 0) {
    const cudaError_t err =
        max_launchable_warps(kernel, kMaxWarps, &reg_warps);
    if (err != cudaSuccess) return err;
  }
  int num_warps = reg_warps;
  while (num_warps > 1 && num_warps > block_q) num_warps >>= 1;
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
                     int block_kv, cudaStream_t stream) {
#define REPRO_D_CASE(N)                                                      \
  case N:                                                                    \
    return launch<T, N>(q, k, v, out, B, Sq, Sk, H, KV, causal, window,     \
                        q_offset, block_q, block_kv, stream);
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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------
namespace {

constexpr int kAlign = 1024;   // the 128-byte swizzle's atom: 8 rows of 128 B
constexpr int kBarBytes = 64;  // 5 mbarriers: Q, K stages 0-1, V stages 0-1
constexpr int kMaxBlockQ = 128;

// The instruction's N for a tile of block_kv keys: 16, 32, 64 or 128.
inline int tile_keys(int block_kv) {
  int n = 16;
  while (n < block_kv) n <<= 1;
  return n;
}

// Dynamic shared memory of one block (the kernel has no static shared
// memory): alignment slack, the Q tile (64 rows a warpgroup), two K and
// two V stages of tile_keys(block_kv) rows, the barriers; the head dim is
// padded to 16 columns.
long long tc_smem_bytes(int D, int block_q, int block_kv) {
  const long long dp = D < 16 ? 16 : D;
  const long long rows_q = block_q > 64 ? 128 : 64;
  return kAlign + rows_q * dp * 2 + 4LL * tile_keys(block_kv) * dp * 2 +
         kBarBytes;
}

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

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), and the swizzle of rows of
// ROW_BYTES (128, 64 or 32: layout types 1, 2, 3).
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  constexpr uint64_t kLayout = ROW_BYTES == 128 ? 1 : ROW_BYTES == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (kLayout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads of an accumulator across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (m64n16, f32) = [d +] A (64 x 16, shared, K-major) . B (16 x 16,
// shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (m64n32, f32) = [d +] A (64 x 16, shared, K-major) . B (16 x 32,
// shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (m64n64, f32) = [d +] A (64 x 16, shared, K-major) . B (16 x 64,
// shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (m64n128, f32) = [d +] A (64 x 16, shared, K-major) . B (16 x 128,
// shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (m64n16, f32) += A (64 x 16, registers) . B (16 x 16, shared,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64n32, f32) += A (64 x 16, registers) . B (16 x 32, shared,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64n64, f32) += A (64 x 16, registers) . B (16 x 64, shared,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D, int BKV>
struct TcShape {
  static constexpr int kDp = D < 16 ? 16 : D;       // head dim in shared mem
  static constexpr int kW = kDp < 64 ? kDp : 64;    // columns of a row block
  static constexpr int kBlocks = kDp / kW;          // row blocks across D
  static constexpr int kRow = kW * 2;               // bytes: the swizzle span
  static constexpr int kTile = BKV * kDp * 2;       // bytes of a K or V tile
  static constexpr int kS = BKV / 2;                // score floats a thread
  static constexpr int kO = kW / 2;                 // output floats a block
};

template <int D, int BKV>
__global__ void __launch_bounds__(2 * 128, 1) flash_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    __nv_bfloat16* __restrict__ out, int B, int Sq, int Sk, int H, int KV,
    int causal, int window, int q_offset, int block_q, int block_kv,
    float scale_log2) {
  using C = TcShape<D, BKV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (smem_addr(smem_raw) + (kAlign - 1)) & ~uint32_t(kAlign - 1);
  const int n_wg = blockDim.x >> 7;
  const int rows_q = 64 * n_wg;
  const uint32_t q_s = base;                       // [kBlocks][rows_q][kW]
  const uint32_t k_s = q_s + rows_q * C::kDp * 2;  // [2][kBlocks][BKV][kW]
  const uint32_t v_s = k_s + 2 * C::kTile;         // [2][kBlocks][BKV][kW]
  const uint32_t bar = v_s + 2 * C::kTile;         // Q, K0, K1, V0, V1

  // the query tiles with the most key tiles to visit first
  const int n_q = (Sq + block_q - 1) / block_q;
  const int hb = H * B;
  const int iq = n_q - 1 - (int)(blockIdx.x / hb);
  const int h = (int)(blockIdx.x % hb) % H;
  const int b = (int)(blockIdx.x % hb) / H;
  const int kvh = h / (H / KV);
  const int q_start = iq * block_q;
  const int q_abs = q_offset + q_start;  // absolute position of row 0

  // the key tiles the reference visits, [lo, hi): not wholly above the
  // diagonal, not wholly left of the window
  const int n_k = (Sk + block_kv - 1) / block_kv;
  int hi = n_k;
  if (causal) hi = min(n_k, (q_abs + block_q - 1) / block_kv + 1);
  int lo = 0;
  if (window) {
    const int t = q_abs - window - (block_kv - 1);
    if (t >= 0) lo = t / block_kv + 1;
  }
  const int n = hi - lo;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(bar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one thread issues every copy: key tile j into stage j % 2
  auto load_kv = [&](int j) {
    const int s = j & 1;
    const int k0 = (lo + j) * block_kv;
    mbar_expect_tx(bar + 8 * (1 + s), C::kTile);
    mbar_expect_tx(bar + 8 * (3 + s), C::kTile);
#pragma unroll
    for (int c = 0; c < C::kBlocks; ++c) {
      const uint32_t off = s * C::kTile + c * BKV * C::kRow;
      tma_load(k_s + off, &tm_k, bar + 8 * (1 + s), c * C::kW, kvh, k0, b);
      tma_load(v_s + off, &tm_v, bar + 8 * (3 + s), c * C::kW, kvh, k0, b);
    }
  };
  if (tid == 0 && n > 0) {
    mbar_expect_tx(bar, rows_q * C::kDp * 2);
    for (int c = 0; c < C::kBlocks; ++c)
      for (int g = 0; g < n_wg; ++g)
        tma_load(q_s + (c * rows_q + g * 64) * C::kRow, &tm_q, bar,
                 c * C::kW, h, q_start + 64 * g, b);
    load_kv(0);
    if (n > 1) load_kv(1);
  }

  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int r0 = 64 * wg + 16 * warp + (lane >> 2);  // rows r0 and r0 + 8
  const int cq = 2 * (lane & 3);  // first column in each 8-column group

  float o[C::kBlocks][C::kO];
#pragma unroll
  for (int c = 0; c < C::kBlocks; ++c)
#pragma unroll
    for (int i = 0; i < C::kO; ++i) o[c][i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  if (n > 0) mbar_wait(bar, 0);

  for (int j = 0; j < n; ++j) {
    const int s = j & 1;
    const uint32_t parity = (j >> 1) & 1;
    const int k0 = (lo + j) * block_kv;

    // S = Q.K^T, f32 in registers
    float sc[C::kS];
#pragma unroll
    for (int i = 0; i < C::kS; ++i) sc[i] = 0.f;
    mbar_wait(bar + 8 * (1 + s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kDp / 16; ++kk) {
      const int c = kk * 16 / C::kW;
      const uint32_t col = (kk * 16 % C::kW) * 2;  // bytes into the row
      const uint64_t da = smem_desc<C::kRow>(
          q_s + (c * rows_q + 64 * wg) * C::kRow + col, 16, 8 * C::kRow);
      const uint64_t db = smem_desc<C::kRow>(
          k_s + s * C::kTile + c * BKV * C::kRow + col, 16, 8 * C::kRow);
      wgmma_ss(sc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // online softmax on rows r0 (even pairs) and r0 + 8 (odd pairs); score
    // i sits at column 8 * (i / 4) + cq + (i % 2) of the tile
    const bool edge = block_kv < BKV || k0 + block_kv > Sk ||
                      (causal && k0 + block_kv - 1 > q_abs) ||
                      (window && k0 <= q_abs + block_q - 1 - window);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < C::kS; ++i) {
      float x = sc[i] * scale_log2;
      if (edge) {
        const int col = 8 * (i >> 2) + cq + (i & 1);
        const int kpos = k0 + col;
        const int qpos = q_abs + r0 + ((i & 2) ? 8 : 0);
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window) ok = ok && kpos > qpos - window;
        // a key of the next tile (in the rounded-up box) is not in this
        // one: it adds nothing, even to a row whose keys are all masked
        x = col >= block_kv ? -INFINITY : (ok ? x : kNegInf);
      }
      sc[i] = x;
      if (i & 2)
        mx1 = fmaxf(mx1, x);
      else
        mx0 = fmaxf(mx0, x);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < C::kS; ++i) {
      const float p = exp2f(sc[i] - ((i & 2) ? mx1 : mx0));
      sc[i] = p;
      if (i & 2)
        ps1 += p;
      else
        ps0 += p;
    }
    l0 = l0 * a0 + ps0;  // this thread's columns; the quad sums at the end
    l1 = l1 * a1 + ps1;
    // once the row maxima settle, alpha is 1 for a whole warp: the
    // rescale (128 multiplies a thread at D=256) would change nothing
    if (!__all_sync(0xffffffffu, a0 == 1.f && a1 == 1.f)) {
#pragma unroll
      for (int c = 0; c < C::kBlocks; ++c)
#pragma unroll
        for (int i = 0; i < C::kO; ++i) o[c][i] *= (i & 2) ? a1 : a0;
    }

    // P as the A fragment of 16-key steps: scores 8t .. 8t + 7 in order
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int t = 0; t < BKV / 16; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[t][r] = pack_bf16(sc[8 * t + 2 * r], sc[8 * t + 2 * r + 1]);

    // O += P.V, 64 output columns an instruction
    mbar_wait(bar + 8 * (3 + s), parity);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BKV / 16; ++t)
#pragma unroll
      for (int c = 0; c < C::kBlocks; ++c) {
        const uint64_t dv = smem_desc<C::kRow>(
            v_s + s * C::kTile + (c * BKV + 16 * t) * C::kRow, 8 * C::kRow,
            8 * C::kRow);
        wgmma_rs(o[c], pa[t], dv);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < C::kBlocks; ++c) fence_regs(o[c]);

    __syncthreads();  // every warpgroup is done with stage s
    if (tid == 0 && j + 2 < n) load_kv(j + 2);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv[2] = {1.f / fmaxf(l0, 1e-30f), 1.f / fmaxf(l1, 1e-30f)};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + 8 * hf;
    if (r >= block_q || q_start + r >= Sq) continue;
    __nv_bfloat16* orow = out + (((size_t)b * Sq + q_start + r) * H + h) * D;
#pragma unroll
    for (int c = 0; c < C::kBlocks; ++c)
#pragma unroll
      for (int g = 0; g < C::kO / 4; ++g) {
        const int col = c * C::kW + 8 * g + cq;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[c][4 * g + 2 * hf] * inv[hf],
                                    o[c][4 * g + 2 * hf + 1] * inv[hf]);
      }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (no
// -lcuda at build time); null when it cannot be had.
EncodeTiled encode_tiled() {
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

// The map of a (B, S, heads, D) bf16 tensor as (D, heads, S, B), boxes of
// box_w columns (the swizzle span) by `rows` rows of one head.
bool tensor_map(CUtensorMap* map, const void* ptr, int D, int heads, int S,
                int B, int box_w, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_w, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = box_w == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_w == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct TcLaunch {
  const void *q, *k, *v;
  void* out;
  int B, Sq, Sk, H, KV, D, causal, window, q_offset, block_q, block_kv;
  cudaStream_t stream;

  template <int DT, int BKV>
  cudaError_t run() const {
    using C = TcShape<DT, BKV>;
    CUtensorMap tq, tk, tv;
    if (!tensor_map(&tq, q, D, H, Sq, B, C::kW, 64) ||
        !tensor_map(&tk, k, D, KV, Sk, B, C::kW, BKV) ||
        !tensor_map(&tv, v, D, KV, Sk, B, C::kW, BKV))
      return cudaErrorInvalidValue;
    auto* kernel = flash_tc_kernel<DT, BKV>;
    const long long bytes = tc_smem_bytes(D, block_q, block_kv);
    if (bytes > 48 * 1024) {  // above 48 KB a kernel must opt in
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return err;
    }
    const int n_q = (Sq + block_q - 1) / block_q;
    const int threads = block_q > 64 ? 256 : 128;
    kernel<<<n_q * H * B, threads, bytes, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(out), B, Sq, Sk, H, KV,
        causal, window, q_offset, block_q, block_kv,
        1.4426950408889634f / sqrtf((float)D));
    return cudaGetLastError();
  }
};

// f.template run<D, BKV>() for the instantiation (D, tile_keys(block_kv));
// cudaErrorInvalidValue for one not built (D=256 with 128 keys: 256 KB).
template <int DT>
cudaError_t dispatch_keys(int bkv, const TcLaunch& f) {
  switch (bkv) {
    case 16: return f.template run<DT, 16>();
    case 32: return f.template run<DT, 32>();
    case 64: return f.template run<DT, 64>();
    case 128:
      if constexpr (DT < 256) return f.template run<DT, 128>();
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_tc(const TcLaunch& f) {
  const int bkv = tile_keys(f.block_kv);
  switch (f.D) {
    case 8: return dispatch_keys<8>(bkv, f);
    case 16: return dispatch_keys<16>(bkv, f);
    case 32: return dispatch_keys<32>(bkv, f);
    case 64: return dispatch_keys<64>(bkv, f);
    case 128: return dispatch_keys<128>(bkv, f);
    case 256: return dispatch_keys<256>(bkv, f);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernel).  block_q and block_kv are the tile sizes the reference's
// geometry uses (already clamped to Sq and Sk by the caller); block_kv <=
// 128, and block_q <= 128 in bf16.  The f32 kernel's block is the most
// warps its registers allow, at most block_q; the bf16 kernel's warps are
// its warpgroups.  q, k and v must be 16-byte aligned in
// bf16 (TMA).  Returns 0 on success, else a cudaError_t code
// (cudaErrorInvalidValue for a shape the kernel does not take).  Launches
// on `stream` and does not synchronise.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Sk, int H, int KV, int D, int dtype, int causal, int window,
    int q_offset, int block_q, int block_kv, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || block_q < 1 ||
      block_kv < 1 || block_kv > 32 * kMaxKeysPerLane)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_d<float>(D, q, k, v, out, B, Sq, Sk, H, KV, causal,
                                window, q_offset, block_q, block_kv, s);
  if (dtype == 1) {
    if (block_q > kMaxBlockQ ||
        ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return (int)launch_tc(TcLaunch{q, k, v, out, B, Sq, Sk, H, KV, D,
                                   causal, window, q_offset, block_q,
                                   block_kv, s});
  }
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory (bytes) one block asks for at these tiles;
// neither kernel has static shared memory.  -1 for a head dim or dtype the
// kernels do not take.  The tuning space's smem_footprint must give the
// same number (chip_smoke.py checks it).
extern "C" long long repro_flash_attention_smem_bytes(int D, int dtype,
                                                      int block_q,
                                                      int block_kv) {
  if (dtype == 0) return smem_d<float>(D, block_q, block_kv);
  if (dtype == 1) {
    if (D != 8 && D != 16 && D != 32 && D != 64 && D != 128 && D != 256)
      return -1;
    return tc_smem_bytes(D, block_q, block_kv);
  }
  return -1;
}
