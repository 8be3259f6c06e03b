// The block of the two flash-decode kernels (decode_attention.cu over a
// dense cache, paged_attention.cu through a page table): one block of 256
// threads owns one split of a sequence's tokens for the query heads of one
// head tile of one KV head, streams the split's K and V rows through a ring
// of TMA tiles in shared memory, and writes its output, or its partial
// softmax state for the last split to finish to merge.  The kernels differ
// only in where a tile's rows lie, which the caller's `issue` says.
//
// - Staging.  A ring of kStages stages, a tile of kTK cache rows of one KV
//   head (8 KB of K and 8 KB of V: 16 rows at D=256 bf16) a stage, each
//   copied by the Tensor Memory Accelerator and completed on the stage's
//   mbarrier: up to 64 KB a block, three blocks an SM, in flight while the
//   blocks compute.  The next tile's copy starts when the block is done
//   with the stage.
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
//   finds it at 0.  Results do not change from run to run.  A sequence
//   whose tokens fit one split needs no merge: that block writes the
//   output itself.  A block whose inputs are out of range writes NaN, or
//   a partial whose l is -1, which makes the merged row NaN.
//
// kernels/build.py hashes every header of csrc/ into every library's name:
// an edit here rebuilds every kernel.

#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;        // K/V tiles in flight a block
constexpr int kTileBytes = 8192;  // the most bytes of a K (V) tile
constexpr int kAlign = 128;       // of a TMA box's shared-memory destination
constexpr int kMaxHeadTile = 8;   // query heads a block scores a K/V tile for

// The head tile GQ (a power of two >= the query heads per KV head, at most
// kMaxHeadTile) for a layout; false for one the decode kernels do not take.
inline bool decode_plan(int heads, int kv_heads, int head_dim, int* tile) {
  if (kv_heads < 1 || heads < kv_heads || heads % kv_heads != 0)
    return false;
  switch (head_dim) {
    case 8: case 16: case 32: case 64: case 128: case 256: break;
    default: return false;
  }
  const int gq = heads / kv_heads;
  int t = 1;
  while (t < gq && t < kMaxHeadTile) t <<= 1;
  *tile = t;
  return true;
}

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

// Dynamic shared memory of one block (the kernels have no static shared
// memory): alignment slack, the K/V ring, the scaled query (f32), the
// tile's scores, the softmax state (m, l, alpha, spare) a head, the
// stages' barriers and the last-block flag.
template <typename T, int D, int GQ>
constexpr int smem_bytes() {
  using C = DecShape<T, D>;
  return kAlign + ring_bytes<T, D, GQ>() + GQ * D * 4 + GQ * C::kTK * 4 +
         4 * GQ * 4 + kStages * 8 + 8;
}

// What one block owns.
struct SplitWork {
  size_t row0;   // the tile's first query row, (b * KV + kvh) * gq + h0
  int n_heads;   // query heads of the tile (<= GQ)
  int t0, t1;    // the split's tokens [t0, t1), t0 < t1
  int tk;        // tokens a tile (<= kTK)
  int split;     // this split
  int n_active;  // live splits of the (row, head tile): the merge waits
                 // for this many
  int n_split;   // splits of the grid: the partials' row stride
  int* counter;  // the merge counter of the (row, head tile)
  int bad;       // this thread found the block's inputs out of range
};

// The block's work.  `issue(i, bar, dst)`, called by thread 0, copies tile
// i of the split (tokens t0 + i * tk on) into shared memory: its K rows at
// `dst`, its V rows at `dst + kTile`, all counted on mbarrier `bar` by one
// expect_tx.  part_m, part_l: [rows][n_split] f32; part_acc:
// [rows][n_split][D].
template <typename T, int D, int GQ, typename Issue>
__device__ __forceinline__ void decode_split(
    const T* __restrict__ q, const SplitWork& w, const Issue& issue,
    float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc, T* __restrict__ out, float scale) {
  using C = DecShape<T, D>;
  const int tid = threadIdx.x;
  const size_t row0 = w.row0;
  const int n_heads = w.n_heads, tk = w.tk, split = w.split;

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
  const bool bad = __syncthreads_or(w.bad);
  // nothing is copied for a bad block: it goes straight to its NaN
  const int n_tile = bad ? 0 : (w.t1 - w.t0 + tk - 1) / tk;
  // tile i of the split into stage i % kStages
  auto load = [&](int i) {
    const int s = i % kStages;
    issue(i, bar0 + 8 * s, ring + s * 2 * C::kTile);
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
    const int valid = min(tk, w.t1 - (w.t0 + i * tk));
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
    // rows past `valid` hold what the ring last held: never scored
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
  const float nan = __int_as_float(0x7fc00000);

  if (w.n_active == 1) {  // the only split: normalize and write
    for (int i = tid; i < n_heads * D; i += kThreads)
      store_f32(bad ? nan : summed(i) / fmaxf(st[GQ + i / D], 1e-30f),
                out + row0 * D + i);
    return;
  }

  // the partial state (m, l, acc) of this split; l = -1 marks a bad one
  const int n_split = w.n_split;
  for (int i = tid; i < n_heads * D; i += kThreads) {
    const int h = i / D;
    part_acc[((row0 + h) * n_split + split) * D + (i - h * D)] = summed(i);
  }
  if (tid < n_heads) {
    part_m[(row0 + tid) * n_split + split] = st[tid];
    part_l[(row0 + tid) * n_split + split] = bad ? -1.f : st[GQ + tid];
  }
  __threadfence();  // the partials are visible device-wide ...
  __syncthreads();
  if (tid == 0) {   // ... before this split counts itself done
    const bool last = atomicAdd(w.counter, 1) == w.n_active - 1;
    if (last) atomicExch(w.counter, 0);  // ready for the next launch
    *flag = last;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();

  // the last split to finish merges all of them, in split order
  const int n_active = w.n_active;
  if (tid < n_heads) {
    const float* pm = part_m + (row0 + tid) * n_split;
    const float* pl = part_l + (row0 + tid) * n_split;
    float mx = kNegInf;
    bool any_bad = false;
    for (int s = 0; s < n_active; ++s) {
      mx = fmaxf(mx, __ldcg(pm + s));
      any_bad |= __ldcg(pl + s) < 0.f;
    }
    float den = 0.f;
    for (int s = 0; s < n_active; ++s)
      den += __ldcg(pl + s) * expf(__ldcg(pm + s) - mx);
    st[tid] = mx;
    st[GQ + tid] = any_bad ? nan : 1.f / fmaxf(den, 1e-30f);
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

// Opts `kernel`, the (T, D, GQ) instantiation of a decode kernel, in to
// its dynamic shared memory on the current device (above 48 KB a kernel
// must ask, on each device it runs on), once a device: after the first
// launch the attribute costs no runtime call.
template <typename T, int D, int GQ, typename K>
cudaError_t allow_smem(K kernel) {
  constexpr int bytes = smem_bytes<T, D, GQ>();
  if (bytes <= 48 * 1024) return cudaSuccess;
  static unsigned long long opted = 0;  // a bit a device; a race asks twice
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (opted >> dev & 1)) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) opted |= 1ull << dev;
  return err;
}

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

// dtype 0 = float32, 1 = bfloat16.
template <typename F, typename R>
R dispatch(int dtype, int head_dim, int tile, const F& f, R bad) {
  if (dtype == 0) return dispatch_dim<float>(head_dim, tile, f, bad);
  if (dtype == 1) return dispatch_dim<__nv_bfloat16>(head_dim, tile, f, bad);
  return bad;
}

}  // namespace

// A key of the CUDA-graph capture under way on `stream`: its id plus one,
// or 0 when the stream is not capturing.  The wrappers give each capture
// scratch of its own (kernels/decode_attention.py::_scratch), so a graph
// holds no pointer into the scratch of eager launches.
extern "C" unsigned long long repro_decode_capture(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status,
                               &id) != cudaSuccess ||
      status != cudaStreamCaptureStatusActive)
    return 0;
  return id + 1;
}
