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
// Design.  The TPU kernel walks the chunks on a sequential grid axis with
// the (dk x dv) state in VMEM and the whole chunk's (L x L) scores in one
// tile.  Here one block owns one (head, batch row) and walks the chunks in a
// loop, the f32 state in shared memory.  An (L x L) f32 score tile does not
// fit shared memory at L = 256 (256 KB), so a chunk is cut into sub-tiles of
// TS = min(64, L) steps: for each query sub-tile the block loads its q rows,
// starts the f32 accumulator with the inter-chunk term from the state, then
// walks the key sub-tiles up to the diagonal, each a (TS x TS) score tile
// (q . k times the masked decay) and its product with the v tile.  After all
// of the chunk's outputs, the state is decayed and the key sub-tiles are
// walked once more, k scaled by exp(c_L - c_s), for the rank-TS updates.
// The cumsum is an in-block scan: a shuffle scan per warp over 32-step
// segments, then one warp adds the segments' offsets.  Every product is an
// f32 FMA on the CUDA cores, one thread an output element, operands from
// shared memory (the key tile's rows padded by one word, so a warp's column
// reads hit distinct banks).  dk and dv are runtime values up to 128: the
// state of a larger head (xLSTM's mLSTM, dk = 512) does not fit one block.
//
// Bound.  At Zamba2-1.2B's shape (B=1, S=4096, H=64, dk=dv=64, f32, q and k
// broadcast over heads) the kernel must read v and g, the broadcast q and k
// rows once and write y and the state: about 138 MB, 0.04 ms at 3.35 TB/s.
// The causal work is about 1.3e10 flops (scores, the products with v, the
// inter-chunk term and the state update), 0.19 ms at the 67 TFLOP/s of f32
// outside the tensor cores: it is bound by operations.  At B=1 the grid has
// only 64 blocks for 132 SMs, and every operand comes from shared memory:
// this first version is far from its bound (PERF.md).

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 16;
constexpr int kMaxDim = 128;     // dk and dv
constexpr int kMaxChunk = 1024;  // the scan covers 32 segments of 32
constexpr int kSubTile = 64;

struct GlaArgs {
  const void *q, *k, *v;
  const float* g;
  void* y;
  float* state;
  int S, H, dk, dv, L;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
};

__host__ __device__ inline int sub_tile(int L) {
  return L < kSubTile ? L : kSubTile;
}

// f32 words of one block's shared memory: the state, the cumsum, the q, k
// (rows padded by one word) and v sub-tiles, the score tile and the output
// accumulator.
__host__ __device__ inline long long smem_words(int dk, int dv, int L) {
  const long long ts = sub_tile(L);
  return (long long)dk * dv + L + ts * dk + ts * (dk + 1) + ts * dv +
         ts * ts + ts * dv;
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

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32) gla_kernel(GlaArgs a) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int S = a.S, H = a.H, dk = a.dk, dv = a.dv, L = a.L;
  const int TS = sub_tile(L);
  const int KS = dk + 1;  // padded key-row stride
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  extern __shared__ float4 smem4[];
  float* st = reinterpret_cast<float*>(smem4);  // [dk][dv]
  float* c = st + dk * dv;                      // [L]
  float* qs = c + L;                            // [TS][dk]
  float* ks = qs + TS * dk;                     // [TS][dk + 1]
  float* vs = ks + TS * KS;                     // [TS][dv]
  float* ps = vs + TS * dv;                     // [TS][TS]
  float* acc = ps + TS * TS;                    // [TS][dv]

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* g = a.g + (size_t)b * S * H + h;
  T* y = static_cast<T*>(a.y) + ((size_t)b * S * H + h) * dv;

  for (int i = tid; i < dk * dv; i += nthr) st[i] = 0.f;

  const int n_chunks = (S + L - 1) / L;
  for (int ic = 0; ic < n_chunks; ++ic) {
    const int t0 = ic * L;
    const int n = min(L, S - t0);  // valid steps of this chunk
    __syncthreads();  // the last chunk's state update is done
    for (int i = tid; i < L; i += nthr)
      c[i] = i < n ? g[(size_t)(t0 + i) * H] : 0.f;
    __syncthreads();
    block_inclusive_scan(c, L);
    const float cL = c[L - 1];

    // ---- outputs, one query sub-tile at a time ----
    const int n_sub = (n + TS - 1) / TS;
    for (int qt = 0; qt < n_sub; ++qt) {
      const int r0 = qt * TS;
      const int rows = min(TS, n - r0);
      __syncthreads();  // the last sub-tile's readers are done
      for (int i = tid; i < TS * dk; i += nthr) {
        const int r = i / dk;
        const int d = i - r * dk;
        qs[i] = r < rows ? to_f32(q[(t0 + r0 + r) * a.q_ss + d]) : 0.f;
      }
      __syncthreads();
      // inter-chunk term: exp(c_t) q_t . S
      for (int i = tid; i < TS * dv; i += nthr) {
        const int r = i / dv;
        const int e = i - r * dv;
        float s = 0.f;
        if (r < rows) {
          const float* qr = qs + r * dk;
          for (int d = 0; d < dk; ++d) s += qr[d] * st[d * dv + e];
          s *= expf(c[r0 + r]);
        }
        acc[i] = s;
      }
      for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * TS;
        const int krows = min(TS, n - k0);
        __syncthreads();  // the last key tile's readers are done
        for (int i = tid; i < TS * dk; i += nthr) {
          const int j = i / dk;
          const int d = i - j * dk;
          ks[j * KS + d] = j < krows ? to_f32(k[(t0 + k0 + j) * a.k_ss + d])
                                     : 0.f;
        }
        for (int i = tid; i < TS * dv; i += nthr) {
          const int j = i / dv;
          const int e = i - j * dv;
          vs[i] = j < krows ? to_f32(v[(t0 + k0 + j) * a.v_ss + e]) : 0.f;
        }
        __syncthreads();
        // scores: (q_t . k_s) exp(c_t - c_s), zero unless s <= t
        for (int i = tid; i < TS * TS; i += nthr) {
          const int r = i / TS;
          const int j = i - r * TS;
          const int tq = r0 + r;
          const int ts = k0 + j;
          float p = 0.f;
          if (r < rows && j < krows && ts <= tq) {
            const float* qr = qs + r * dk;
            const float* kr = ks + j * KS;
            for (int d = 0; d < dk; ++d) p += qr[d] * kr[d];
            p *= expf(c[tq] - c[ts]);
          }
          ps[i] = p;
        }
        __syncthreads();
        // acc += P . V (each thread keeps the acc elements it started)
        for (int i = tid; i < TS * dv; i += nthr) {
          const int r = i / dv;
          const int e = i - r * dv;
          if (r < rows) {
            const float* pr = ps + r * TS;
            float s = acc[i];
            for (int j = 0; j < krows; ++j) s += pr[j] * vs[j * dv + e];
            acc[i] = s;
          }
        }
      }
      for (int i = tid; i < rows * dv; i += nthr) {
        const int r = i / dv;
        const int e = i - r * dv;
        store_f32(acc[i], y + (size_t)(t0 + r0 + r) * H * dv + e);
      }
    }

    // ---- state update: S = exp(c_L) S + sum_s exp(c_L - c_s) k_s v_s^T ----
    __syncthreads();  // every inter-chunk read of S is done
    const float decay = expf(cL);
    for (int i = tid; i < dk * dv; i += nthr) st[i] *= decay;
    for (int kt = 0; kt < n_sub; ++kt) {
      const int k0 = kt * TS;
      const int krows = min(TS, n - k0);
      __syncthreads();
      for (int i = tid; i < TS * dk; i += nthr) {
        const int j = i / dk;
        const int d = i - j * dk;
        ks[j * KS + d] =
            j < krows ? to_f32(k[(t0 + k0 + j) * a.k_ss + d]) *
                            expf(cL - c[k0 + j])
                      : 0.f;
      }
      for (int i = tid; i < TS * dv; i += nthr) {
        const int j = i / dv;
        const int e = i - j * dv;
        vs[i] = j < krows ? to_f32(v[(t0 + k0 + j) * a.v_ss + e]) : 0.f;
      }
      __syncthreads();
      for (int i = tid; i < dk * dv; i += nthr) {
        const int d = i / dv;
        const int e = i - d * dv;
        float s = st[i];
        for (int j = 0; j < krows; ++j) s += ks[j * KS + d] * vs[j * dv + e];
        st[i] = s;
      }
    }
  }
  __syncthreads();
  float* so = a.state + ((size_t)b * H + h) * dk * dv;
  for (int i = tid; i < dk * dv; i += nthr) so[i] = st[i];
}

template <typename T>
cudaError_t launch(const GlaArgs& a, int B, int num_warps,
                   cudaStream_t stream) {
  auto* kernel = gla_kernel<T>;
  if (num_warps == 0) {
    // the most warps the registers allow
    static int reg_warps = 0;  // a race only writes the same value twice
    if (reg_warps == 0) {
      const cudaError_t err =
          max_launchable_warps(kernel, kMaxWarps, &reg_warps);
      if (err != cudaSuccess) return err;
    }
    num_warps = reg_warps;
  }
  const size_t bytes = (size_t)smem_words(a.dk, a.dv, a.L) * sizeof(float);
  if (bytes > 48 * 1024) {  // above 48 KB a kernel must opt in, per device
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.H, B);
  kernel<<<grid, num_warps * 32, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and y share it).  chunk is the
// chunk length L, already clamped to S by the caller, at most kMaxChunk;
// dk and dv at most kMaxDim.  The strides are in elements (batch, step,
// head) for q, k and v; their last dimension is contiguous.  num_warps: the
// block size in warps (a power of two up to kMaxWarps), or 0 for the most
// the registers allow.  Returns 0 on success, else a cudaError_t code
// (cudaErrorInvalidValue for a shape the kernel does not take).  Launches
// on `stream` and does not synchronise.
extern "C" int repro_gla(const void* q, const void* k, const void* v,
                         const float* g, void* y, float* state, int B, int S,
                         int H, int dk, int dv, int dtype, int chunk,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         int num_warps, void* stream) {
  if (B < 1 || S < 1 || H < 1 || dk < 1 || dk > kMaxDim || dv < 1 ||
      dv > kMaxDim || chunk < 1 || chunk > kMaxChunk || chunk > S ||
      num_warps < 0 || num_warps > kMaxWarps ||
      (num_warps & (num_warps - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const GlaArgs a{q,    k,    v,    g,    y,    state, S,    H,
                  dk,   dv,   chunk, q_sb, q_ss, q_sh,  k_sb, k_ss,
                  k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(a, B, num_warps, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, B, num_warps, s);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory (bytes) one block asks for at chunk length L
// (already clamped to S); the kernel has no static shared memory.  -1 for
// dims the kernel does not take.  The tuning space's smem_footprint must
// give the same number (chip_smoke.py checks it).
extern "C" long long repro_gla_smem_bytes(int dk, int dv, int chunk) {
  if (dk < 1 || dk > kMaxDim || dv < 1 || dv > kMaxDim || chunk < 1 ||
      chunk > kMaxChunk)
    return -1;
  return smem_words(dk, dv, chunk) * (long long)sizeof(float);
}
