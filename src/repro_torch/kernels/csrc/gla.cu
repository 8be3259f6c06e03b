// Chunked gated linear attention (GLA) for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `gla_pallas` (src/repro/kernels/gla.py).
// It computes the same function: per (batch row, head), with a zero initial
// state and chunks of L steps, c = the inclusive cumsum of the log-gates g
// inside the chunk,
//
//   y_t = exp(c_t) q_t S + sum_{s <= t} exp(c_t - c_s) (q_t . k_s) v_s
//   S  <- exp(c_L) S + sum_s exp(c_L - c_s) k_s v_s^T
//
// all in f32 whatever the input dtype; a decay is the exponent of a
// difference taken only where s <= t (every exponent is <= 0, since g <= 0).
// Steps past S are padding: zero gate, zero q, k and v, never read from
// memory and never written.
//
//   q, k  (B, S, H, dk)  bf16 or f32, any element strides but a unit one on
//                        dk (Mamba2 passes one (B, S, dk) row broadcast over
//                        the heads: head stride 0, nothing materialized)
//   v     (B, S, H, dv)  q's dtype, element strides as q
//   g     (B, S, H)      f32, contiguous
//   y     (B, S, H, dv)  q's dtype, contiguous
//   state (B, H, dk, dv) f32, contiguous: the final state
//
// Bound.  At Zamba2-1.2B's shape (B=1, S=4096, H=64, dk=dv=64, f32, q and k
// broadcast over heads) the kernel must read v and g, the broadcast q and k
// rows once and write y and the state: about 138 MB, 0.041 ms at 3.35 TB/s.
// The causal work is about 8.7e9 flops: 0.130 ms at the 67 TFLOP/s of f32
// outside the tensor cores, 0.053 ms at 495 TFLOP/s of TF32 on the tensor
// cores for the three products a 3xTF32 product takes.
//
// Design: the chunk-parallel form, three kernels a call.  The TPU kernel
// walks the chunks on a sequential grid axis with the (dk x dv) state in
// VMEM; a block a (head, batch row) walking its chunks in order would give
// Zamba2's B=1 only 64 blocks for the 132 SMs.  Here the sequence is split
// across blocks:
//
//  1. chunk states (gla_state_kernel), one block a (chunk, dv tile, head,
//     batch row): the chunk's own contribution dS_c = sum_s exp(c_L - c_s)
//     k_s v_s^T and its decay exp(c_L), into wrapper-owned scratch
//     (B, H, n_chunks, dk, dv) f32: 16.8 MB at Zamba2's shape, which the
//     50 MB L2 holds between the kernels;
//  2. the scan (gla_scan_kernel), a thread a state element: S_0 = 0,
//     S_{c+1} = exp(c_L) S_c + dS_c in chunk order, each S_c written over
//     dS_c; the last is the final state;
//  3. outputs (gla_out_kernel), one block a (64-row query tile, chunk,
//     head group, dv tile, batch row), the longest tiles first:
//     y = exp(c_t) (q_t S_c) + ((q k^T) o masked decay) v, walking the
//     chunk's 64-key tiles up to the diagonal.
//
// Every product runs on the tensor cores (mma.sync m16n8k8, TF32 in, f32
// accumulated) as 3xTF32: x = hi + lo, hi its top 10 mantissa bits, lo
// those of the rest, and a.b = hi.lo + lo.hi + hi.hi, which keeps about 21
// bits of each operand (single-pass TF32 keeps 10: too few for the f32
// tolerance).  The score tile never leaves registers: its accumulator
// fragment is the A fragment of the P.V product, the keys of each 8-key
// step taken in the order (0, 2, 4, 6, 1, 3, 5, 7), and V's fragment read
// in that order.  Operand tiles sit in shared memory as f32 with rows
// padded so each warp's fragment loads hit 32 distinct banks.  When q and k
// are broadcast over the heads (both head strides 0) a block takes two
// heads and computes q k^T once for both, applying each head's decay.  The
// chunk cumsum is an in-block scan (a shuffle scan per warp over 32-step
// segments, then one warp adds the segments' offsets), the same in the
// first and the third kernel.  dk and dv are runtime values up to 128 (dv
// in tiles of 64): the state of a larger head (xLSTM's mLSTM, dk = 512) is
// not ported.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;    // 4 warps
constexpr int kMaxDim = 128;     // dk and dv
constexpr int kMaxChunk = 1024;  // the scan covers 32 segments of 32
constexpr int kTile = 64;        // query rows, key rows and dv columns

struct GlaArgs {
  const void *q, *k, *v;
  const float* g;
  void* y;
  float* state;
  float* chunk_state;  // (B, H, n_chunks, dk, dv): dS_c, then S_c
  float* decay;        // (B, H, n_chunks): exp(c_L)
  int B, S, H, dk, dv, L, n_chunks;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
};

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
// The smallest row stride >= x (in floats) that is 4 (8) modulo 32: a
// fragment load of rows g and columns t (rows t and columns g) then hits
// 32 distinct banks.
__host__ __device__ constexpr int stride4(int x) {
  return (x + 27) / 32 * 32 + 4;
}
__host__ __device__ constexpr int stride8(int x) {
  return (x + 23) / 32 * 32 + 8;
}

// f32 words of shared memory of each kernel's block (all dynamic); a
// cumsum spans the chunk rounded up to whole tiles.
__host__ __device__ inline int state_words(int dk, int L) {
  return round_up(L, kTile) + kTile * stride8(round_up(dk, 16)) +
         kTile * stride8(kTile);
}
__host__ __device__ inline int out_words(int dk, int L, int hg) {
  const int dkp = round_up(dk, 8);
  const int vs = hg * kTile * stride4(kTile);                // the V tiles
  const int ss = round_up(dkp, kTile) * stride8(kTile);  // or one S_c
  return hg * round_up(L, kTile) + 2 * kTile * stride4(dkp) +
         (vs > ss ? vs : ss);
}

// ---------------------------------------------------------------------------
// the products: d (16 x 8, f32) += a (16 x 8) . b (8 x 8), m16n8k8 fragments
// (lane = 4 * g + t: a = rows g, g + 8 at columns t, t + 4; b = rows t,
// t + 4 at column g; d = rows g, g + 8 at columns 2t, 2t + 1)
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t tf32_hi(float x) {
  return __float_as_uint(x) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An operand split for 3xTF32: its top 10 mantissa bits and those of the
// rest (the hardware reads only those bits of a TF32 operand).
template <int N>
struct Split {
  uint32_t hi[N], lo[N];
  __device__ __forceinline__ explicit Split(const float (&x)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      hi[i] = tf32_hi(x[i]);
      lo[i] = tf32_hi(x[i] - __uint_as_float(hi[i]));
    }
  }
};

__device__ __forceinline__ void mma3(float (&d)[4], const Split<4>& a,
                                     const Split<2>& b) {
  mma_tf32(d, a.lo, b.hi);  // the small cross terms first
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// In-place inclusive scan of c[0, L) (L <= kMaxChunk) by the whole block.
__device__ void block_inclusive_scan(float* c, int L) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int n_seg = (L + 31) / 32;
  for (int seg = warp; seg < n_seg; seg += n_warps) {
    const int i = seg * 32 + lane;
    float x = i < L ? c[i] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += up;
    }
    if (i < L) c[i] = x;
  }
  __syncthreads();
  if (warp == 0 && n_seg > 1) {
    // segment totals -> exclusive offsets, one lane a segment
    const float tot = lane < n_seg ? c[min(lane * 32 + 31, L - 1)] : 0.f;
    float x = tot;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += up;
    }
    const float excl = x - tot;
    for (int seg = 1; seg < n_seg; ++seg) {
      const float off = __shfl_sync(0xffffffffu, excl, seg);
      const int i = seg * 32 + lane;
      if (i < L) c[i] += off;
    }
  }
  __syncthreads();
}

// The chunk's cumsum of head h's gates into c[0, Lp), Lp the chunk rounded
// up to whole tiles: steps past the chunk's n valid ones add 0.
__device__ void chunk_cumsum(const GlaArgs& a, int b, int h, int t0, int n,
                             float* c) {
  const int Lp = round_up(a.L, kTile);
  const float* g = a.g + ((size_t)b * a.S + t0) * a.H + h;
  for (int i = threadIdx.x; i < Lp; i += kThreads)
    c[i] = i < n ? g[(size_t)i * a.H] : 0.f;
  __syncthreads();
  block_inclusive_scan(c, Lp);
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           int src_bytes) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
      "l"(src), "r"(src_bytes)
      : "memory");
}

// Waits for this thread's cp.async copies; a __syncthreads must follow
// before other threads read them.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The first kTile rows of a (rows, cols) slab with row stride `ss` into dst
// (row stride `stride`, a multiple of 4) as f32, zeros past `rows` valid
// rows and `cols` valid columns, up to `width` columns (a multiple of 4).
// An f32 slab whose rows and columns are 16-byte aligned is copied by
// 16-byte cp.async copies (complete at cp_async_wait_all); any other goes
// through registers, eight 4-column pieces a thread in flight at once.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int stride, const T* src,
                                          long long ss, int rows, int cols,
                                          int width) {
  const int vw = width / 4;  // 4-column pieces a row
  const int n = kTile * vw;
  if (sizeof(T) == 4 && cols % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(src) | (uintptr_t)(ss * 4)) & 15) == 0) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int r = i / vw;
      const int d = (i - r * vw) * 4;
      const bool ok = r < rows && d < cols;
      cp_async16(dst + r * stride + d, ok ? src + r * ss + d : src,
                 ok ? 16 : 0);
    }
    return;
  }
  for (int i0 = threadIdx.x; i0 < n; i0 += 8 * kThreads) {
    float x[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * kThreads;
      const int r = i / vw;
      const int d = (i - r * vw) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[j][e] = i < n && r < rows && d + e < cols
                      ? to_f32(src[r * ss + d + e])
                      : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * kThreads;
      if (i >= n) break;
      const int r = i / vw;
      const int d = (i - r * vw) * 4;
      *reinterpret_cast<float4*>(dst + r * stride + d) =
          make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 1. chunk states: dS_c (dk x dv tile) = sum_s exp(c_L - c_s) k_s v_s^T
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) gla_state_kernel(GlaArgs a) {
  const int ic = blockIdx.x;
  const int n_dvt = (a.dv + kTile - 1) / kTile;
  const int h = blockIdx.y / n_dvt;
  const int e0 = (blockIdx.y - h * n_dvt) * kTile;  // first dv column
  const int b = blockIdx.z;
  const int t0 = ic * a.L;
  const int n = min(a.L, a.S - t0);
  const int dkm = round_up(a.dk, 16);
  const int KS = stride8(dkm), VS = stride8(kTile);
  const int ecols = min(kTile, a.dv - e0);

  extern __shared__ float4 smem4[];
  float* c = reinterpret_cast<float*>(smem4);  // [Lp]
  float* kd = c + round_up(a.L, kTile);        // [kTile][KS] k
  float* vs = kd + kTile * KS;                 // [kTile][VS]

  chunk_cumsum(a, b, h, t0, n, c);
  const float cL = c[a.L - 1];
  const size_t bhc = ((size_t)b * a.H + h) * a.n_chunks + ic;
  if (e0 == 0 && threadIdx.x == 0) a.decay[bhc] = expf(cL);
  __syncthreads();  // every thread has read c_L
  // the keys' weights exp(c_L - c_s), over the cumsum
  for (int i = threadIdx.x; i < round_up(a.L, kTile); i += kThreads)
    c[i] = expf(cL - c[i]);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_nt = (ecols + 7) / 8;  // 8-column tiles of the dv tile
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][nt][i] = 0.f;

  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + t0 * a.k_ss +
                h * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + t0 * a.v_ss +
                h * a.v_sh + e0;
  for (int j0 = 0; j0 < n; j0 += kTile) {
    const int rows = min(kTile, n - j0);
    __syncthreads();  // the last piece's readers are done
    load_tile(kd, KS, kp + j0 * a.k_ss, a.k_ss, rows, a.dk, dkm);
    load_tile(vs, VS, vp + j0 * a.v_ss, a.v_ss, rows, ecols, kTile);
    cp_async_wait_all();
    __syncthreads();
    for (int ks = 0; ks < (rows + 7) / 8; ++ks) {
      const float* kr = kd + (ks * 8 + t) * KS;  // A = (w k)^T: rows of dk
      const float* vr = vs + (ks * 8 + t) * VS;
      const float w0 = c[j0 + ks * 8 + t], w1 = c[j0 + ks * 8 + t + 4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {  // 16-row tiles of dk, a warp two
        const int m0 = (warp + 4 * mi) * 16;
        if (m0 >= dkm) break;
        const float af[4] = {kr[m0 + g] * w0, kr[m0 + g + 8] * w0,
                             kr[4 * KS + m0 + g] * w1,
                             kr[4 * KS + m0 + g + 8] * w1};
        const Split<4> as(af);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt >= n_nt) break;
          const float bf[2] = {vr[nt * 8 + g], vr[4 * VS + nt * 8 + g]};
          mma3(acc[mi][nt], as, Split<2>(bf));
        }
      }
    }
  }

  float* out = a.chunk_state + bhc * a.dk * a.dv;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int m0 = (warp + 4 * mi) * 16;
    if (m0 >= dkm) break;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt >= n_nt) break;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m0 + g + (i & 2 ? 8 : 0);
        const int col = nt * 8 + 2 * t + (i & 1);
        if (r < a.dk && col < ecols) out[r * a.dv + e0 + col] = acc[mi][nt][i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. the scan over chunks, a thread a state element
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) gla_scan_kernel(GlaArgs a) {
  const long long per = (long long)a.dk * a.dv;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)a.B * a.H * per) return;
  const long long bh = i / per;
  float* cs = a.chunk_state + bh * a.n_chunks * per + (i - bh * per);
  const float* decay = a.decay + bh * a.n_chunks;
  float s = 0.f;
  for (int c0 = 0; c0 < a.n_chunks; c0 += 8) {  // eight loads in flight
    float d[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      d[j] = c0 + j < a.n_chunks ? cs[(c0 + j) * per] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (c0 + j >= a.n_chunks) break;
      cs[(c0 + j) * per] = s;  // the state entering chunk c0 + j
      s = decay[c0 + j] * s + d[j];
    }
  }
  a.state[i] = s;
}

// ---------------------------------------------------------------------------
// 3. outputs of one 64-row query tile of one chunk, for HG heads
// ---------------------------------------------------------------------------
template <typename T, int HG>
__global__ void __launch_bounds__(kThreads) gla_out_kernel(GlaArgs a) {
  const int n_qt = (a.L + kTile - 1) / kTile;
  const int qt = n_qt - 1 - (int)blockIdx.x / a.n_chunks;  // longest first
  const int ic = (int)blockIdx.x % a.n_chunks;
  const int n_dvt = (a.dv + kTile - 1) / kTile;
  const int h0 = (blockIdx.y / n_dvt) * HG;
  const int e0 = (blockIdx.y % n_dvt) * kTile;
  const int b = blockIdx.z;
  const int t0 = ic * a.L;
  const int n = min(a.L, a.S - t0);
  const int r0 = qt * kTile;
  if (r0 >= n) return;  // a ragged last chunk has fewer query tiles
  const int rows = min(kTile, n - r0);
  const int dkp = round_up(a.dk, 8);
  const int Lp = round_up(a.L, kTile);
  const int QS = stride4(dkp), VS = stride4(kTile), SS = stride8(kTile);
  const int ecols = min(kTile, a.dv - e0);

  extern __shared__ float4 smem4[];
  float* c = reinterpret_cast<float*>(smem4);  // [HG][Lp] cumsums
  float* qs = c + HG * Lp;                     // [kTile][QS]
  float* ks = qs + kTile * QS;                 // [kTile][QS]
  float* vs = ks + kTile * QS;                 // [HG][kTile][VS], or S_c

  for (int hh = 0; hh < HG; ++hh)
    chunk_cumsum(a, b, h0 + hh, t0, n, c + hh * Lp);
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb +
                (t0 + r0) * a.q_ss + h0 * a.q_sh;
  load_tile(qs, QS, qp, a.q_ss, rows, a.dk, dkp);  // waited for below

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_nt = (ecols + 7) / 8;
  const int rw = 16 * warp + g;  // this lane's tile rows: rw and rw + 8
  float acc[HG][8][4];
#pragma unroll
  for (int hh = 0; hh < HG; ++hh)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[hh][nt][i] = 0.f;

  // inter-chunk term: exp(c_t) (q_t . S_c), S_c from the scan
  if (ic > 0) {
#pragma unroll  // acc[hh] must stay in registers
    for (int hh = 0; hh < HG; ++hh) {
      const float* sp = a.chunk_state +
                        (((size_t)b * a.H + h0 + hh) * a.n_chunks + ic) *
                            a.dk * a.dv + e0;
      __syncthreads();  // qs is loaded; the last head's S_c is read
      load_tile(vs, SS, sp, a.dv, a.dk, ecols, kTile);
      if (dkp > kTile)  // rows kTile .. dk of S_c
        load_tile(vs + kTile * SS, SS, sp + (size_t)kTile * a.dv, a.dv,
                  a.dk - kTile, ecols, kTile);
      cp_async_wait_all();
      __syncthreads();
      for (int kk = 0; kk < dkp / 8; ++kk) {
        const float* qr = qs + rw * QS + kk * 8 + t;
        const float af[4] = {qr[0], qr[8 * QS], qr[4], qr[8 * QS + 4]};
        const Split<4> as(af);
        const float* sr = vs + (kk * 8 + t) * SS + g;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt >= n_nt) break;
          const float bf[2] = {sr[nt * 8], sr[4 * SS + nt * 8]};
          mma3(acc[hh][nt], as, Split<2>(bf));
        }
      }
      const float d0 = expf(c[hh * Lp + r0 + rw]);
      const float d1 = expf(c[hh * Lp + r0 + rw + 8]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[hh][nt][0] *= d0;
        acc[hh][nt][1] *= d0;
        acc[hh][nt][2] *= d1;
        acc[hh][nt][3] *= d1;
      }
    }
  }

  // intra-chunk: the key tiles up to the diagonal
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + t0 * a.k_ss +
                h0 * a.k_sh;
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    const int krows = min(kTile, n - k0);
    __syncthreads();  // the last tile's (or S_c's) readers are done
    load_tile(ks, QS, kp + k0 * a.k_ss, a.k_ss, krows, a.dk, dkp);
    for (int hh = 0; hh < HG; ++hh) {
      const T* vp = static_cast<const T*>(a.v) + b * a.v_sb +
                    (t0 + k0) * a.v_ss + (h0 + hh) * a.v_sh + e0;
      load_tile(vs + hh * kTile * VS, VS, vp, a.v_ss, krows, ecols, kTile);
    }
    cp_async_wait_all();
    __syncthreads();

    // scores q . k of rows rw, rw + 8 and the tile's 64 keys, once for
    // the head group
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = 0.f;
    for (int kk = 0; kk < dkp / 8; ++kk) {
      const float* qr = qs + rw * QS + kk * 8 + t;
      const float af[4] = {qr[0], qr[8 * QS], qr[4], qr[8 * QS + 4]};
      const Split<4> as(af);
      const float* kr = ks + g * QS + kk * 8 + t;  // B = k^T
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float bf[2] = {kr[j * 8 * QS], kr[j * 8 * QS + 4]};
        mma3(sc[j], as, Split<2>(bf));
      }
    }

    // y += (scores o decay) . v, a head at a time; the score fragment of
    // keys 8j .. 8j + 7 is the A fragment of key step j with its keys in
    // the order (0, 2, 4, 6, 1, 3, 5, 7)
    const bool diag = kt == qt;
#pragma unroll  // acc[hh] must stay in registers
    for (int hh = 0; hh < HG; ++hh) {
      const float* ch = c + hh * Lp;
      const float c0 = ch[r0 + rw], c1 = ch[r0 + rw + 8];
      const float* vh = vs + hh * kTile * VS;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s0 = k0 + 8 * j + 2 * t;  // keys s0 and s0 + 1
        const float cs0 = ch[s0], cs1 = ch[s0 + 1];
        float p[4] = {sc[j][0] * expf(c0 - cs0), sc[j][1] * expf(c0 - cs1),
                      sc[j][2] * expf(c1 - cs0), sc[j][3] * expf(c1 - cs1)};
        if (diag) {
          const int q0 = r0 + rw;
          if (s0 > q0) p[0] = 0.f;
          if (s0 + 1 > q0) p[1] = 0.f;
          if (s0 > q0 + 8) p[2] = 0.f;
          if (s0 + 1 > q0 + 8) p[3] = 0.f;
        }
        const float af[4] = {p[0], p[2], p[1], p[3]};
        const Split<4> as(af);
        const float* vr = vh + (8 * j + 2 * t) * VS + g;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt >= n_nt) break;
          const float bf[2] = {vr[nt * 8], vr[VS + nt * 8]};
          mma3(acc[hh][nt], as, Split<2>(bf));
        }
      }
    }
  }

  T* yp = static_cast<T*>(a.y) + (((size_t)b * a.S + t0 + r0) * a.H + h0) *
                                     a.dv + e0;
#pragma unroll
  for (int hh = 0; hh < HG; ++hh)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt >= n_nt) break;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rw + (i & 2 ? 8 : 0);
        const int col = nt * 8 + 2 * t + (i & 1);
        if (r < rows && col < ecols)
          store_f32(acc[hh][nt][i],
                    yp + ((size_t)r * a.H + hh) * a.dv + col);
      }
    }
}

template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;  // above 48 KB: opt in
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
cudaError_t launch(const GlaArgs& a, int hg, cudaStream_t stream) {
  const int n_dvt = (a.dv + kTile - 1) / kTile;
  cudaError_t err;

  auto* state_kernel = gla_state_kernel<T>;
  const int s_bytes = state_words(a.dk, a.L) * 4;
  if ((err = opt_in(state_kernel, s_bytes)) != cudaSuccess) return err;
  state_kernel<<<dim3(a.n_chunks, a.H * n_dvt, a.B), kThreads, s_bytes,
                 stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long elems = (long long)a.B * a.H * a.dk * a.dv;
  gla_scan_kernel<<<(unsigned)((elems + kThreads - 1) / kThreads), kThreads,
                    0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  void (*out_kernel)(GlaArgs) =
      hg == 2 ? &gla_out_kernel<T, 2> : &gla_out_kernel<T, 1>;
  const int o_bytes = out_words(a.dk, a.L, hg) * 4;
  if ((err = opt_in(out_kernel, o_bytes)) != cudaSuccess) return err;
  const int n_qt = (a.L + kTile - 1) / kTile;
  out_kernel<<<dim3(n_qt * a.n_chunks, (a.H / hg) * n_dvt, a.B), kThreads,
               o_bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and y share it).  chunk is the
// chunk length L, already clamped to S by the caller, at most kMaxChunk;
// dk and dv at most kMaxDim.  The strides are in elements (batch, step,
// head) for q, k and v; their last dimension is contiguous.  chunk_state:
// (B, H, ceil(S / chunk), dk, dv) f32 scratch, decay: (B, H, ceil(S /
// chunk)) f32 scratch.  head_group: 2 takes two heads a block, computing
// q k^T once for both (only when q and k are broadcast over the heads: both
// head strides 0, H even), else 1.  Returns 0 on success, else a
// cudaError_t code (cudaErrorInvalidValue for a shape the kernel does not
// take).  Launches three kernels on `stream` and does not synchronise.
extern "C" int repro_gla(const void* q, const void* k, const void* v,
                         const float* g, void* y, float* state,
                         float* chunk_state, float* decay, int B, int S,
                         int H, int dk, int dv, int dtype, int chunk,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         int head_group, void* stream) {
  if (B < 1 || S < 1 || H < 1 || dk < 1 || dk > kMaxDim || dv < 1 ||
      dv > kMaxDim || chunk < 1 || chunk > kMaxChunk || chunk > S ||
      (head_group != 1 && head_group != 2) ||
      (head_group == 2 && (H % 2 || q_sh != 0 || k_sh != 0)))
    return (int)cudaErrorInvalidValue;
  const GlaArgs a{q,    k,    v,    g,    y,    state, chunk_state,
                  decay, B,   S,    H,    dk,   dv,    chunk,
                  (S + chunk - 1) / chunk,    q_sb, q_ss, q_sh,
                  k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(a, head_group, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, head_group, s);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory (bytes) of the largest block a call launches
// at chunk length L (already clamped to S): the output kernel's at a head
// group of two, which is at least the chunk-state kernel's; the kernels
// have no static shared memory.  -1 for dims the kernel does not take.
// The tuning space's smem_footprint must give the same number
// (chip_smoke.py checks it).
extern "C" long long repro_gla_smem_bytes(int dk, int dv, int chunk) {
  if (dk < 1 || dk > kMaxDim || dv < 1 || dv > kMaxDim || chunk < 1 ||
      chunk > kMaxChunk)
    return -1;
  const int s = state_words(dk, chunk), o = out_words(dk, chunk, 2);
  return (long long)(s > o ? s : o) * (long long)sizeof(float);
}
