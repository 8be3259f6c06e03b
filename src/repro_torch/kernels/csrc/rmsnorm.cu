// Fused RMSNorm for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `rmsnorm_pallas`
// (src/repro/kernels/rmsnorm.py).  It computes the same function over the
// rows of an (rows, d) tensor: the mean of squares in f32, then
// x * rsqrt(mean + eps) * scale in f32, cast back to x's dtype.
//
//   x      (rows, d)   bf16 or f32
//   scale  (d,)        f32, or x's dtype
//   out    (rows, d)   x's dtype
//
// Bound.  The kernel must read x and scale and write out once:
// (2 * rows * d) * sizeof(T) + d * sizeof(scale) bytes, at most 3.35 TB/s
// on an H100 SXM; about 4 flops an element put it far below the ridge
// point, so it is bound by bytes: the loads in flight decide its speed.
//
// Design.  The TPU kernel keeps a (block_rows x d) tile resident in VMEM.
// On Hopper a row is one warp's work.  When d is a multiple of a 16-byte
// vector and every pointer is 16-byte aligned (every model shape), the
// row kernel holds the row in registers: lane l owns the vectors l,
// l + 32, ..., a compile-time count NCH of them (12 at d = 3072 in bf16:
// 48 registers), and issues all NCH loads before the warp's sum of
// squares, so a lane keeps NCH 16-byte loads in flight and x is read from
// device memory once.  The output is then written from those registers;
// the scale is read as 16-byte vectors through L1 (a block's rows share
// it), each element converted to f32 once.  Any other d takes the loop
// kernel: a lane walks its vectors (or elements) and reads the row a
// second time, from L1 or L2, to write it.  A block of num_warps warps
// owns block_rows consecutive rows, warp w taking rows w, w + num_warps,
// ...; block_rows sets how many blocks the grid has, and a block is never
// wider than its kernel's registers allow.  Nothing goes through shared
// memory.

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 32;
// the row kernel's vectors a lane (NCH): a row of up to 32 * 32 16-byte
// vectors (8192 bf16 or 4096 f32 elements) stays in registers
constexpr int kRowChunks[] = {1, 2, 3, 4, 6, 8, 12, 16, 24, 32};
constexpr int kNumRowChunks = sizeof(kRowChunks) / sizeof(int);

// The loop kernel.  VEC: 16-byte vector accesses (d a multiple of
// 16 / sizeof(T), every pointer 16-byte aligned) or one element at a time.
template <typename T, typename S, bool VEC>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const S* __restrict__ scale,
                               T* __restrict__ out, int rows, int d,
                               int block_rows, float eps) {
  constexpr int kPer = VEC ? 16 / int(sizeof(T)) : 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int row0 = blockIdx.x * block_rows;
  const int row1 = min(row0 + block_rows, rows);
  const int n_chunks = d / kPer;
  for (int r = row0 + warp; r < row1; r += n_warps) {
    const T* xr = x + (size_t)r * d;
    float ss = 0.f;
    for (int c = lane; c < n_chunks; c += 32) {
      float e[kPer];
      load_f32<T, kPer>(xr + c * kPer, e);
#pragma unroll
      for (int i = 0; i < kPer; ++i) ss += e[i] * e[i];
    }
    ss = warp_sum(ss);
    const float inv = rsqrtf(ss / (float)d + eps);
    T* orow = out + (size_t)r * d;
    for (int c = lane; c < n_chunks; c += 32) {
      float e[kPer], s[kPer];
      load_f32<T, kPer>(xr + c * kPer, e);
      load_f32<S, kPer>(scale + c * kPer, s);
      if (VEC) {
        alignas(16) T y[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) store_f32(e[i] * inv * s[i], &y[i]);
        *reinterpret_cast<uint4*>(orow + c * kPer) =
            *reinterpret_cast<const uint4*>(y);
      } else {
        store_f32(e[0] * inv * s[0], orow + c);
      }
    }
  }
}

// The row kernel: lane l holds vectors l + 32 * i (i < NCH, those below
// d / kPer) of its row in registers between the read and the write.
template <typename T, typename S, int NCH>
__global__ void rmsnorm_row_kernel(const T* __restrict__ x,
                                   const S* __restrict__ scale,
                                   T* __restrict__ out, int rows, int d,
                                   int block_rows, float eps) {
  constexpr int kPer = 16 / int(sizeof(T));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int row0 = blockIdx.x * block_rows;
  const int row1 = min(row0 + block_rows, rows);
  const int n_chunks = d / kPer;
  for (int r = row0 + warp; r < row1; r += n_warps) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)r * d);
    uint4 raw[NCH];
#pragma unroll
    for (int i = 0; i < NCH; ++i)  // every load issued before any use
      if (lane + 32 * i < n_chunks) raw[i] = __ldcs(xr + lane + 32 * i);
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NCH; ++i)
      if (lane + 32 * i < n_chunks) {
        const T* e = reinterpret_cast<const T*>(&raw[i]);
#pragma unroll
        for (int j = 0; j < kPer; ++j) ss += to_f32(e[j]) * to_f32(e[j]);
      }
    ss = warp_sum(ss);
    const float inv = rsqrtf(ss / (float)d + eps);
    uint4* orow = reinterpret_cast<uint4*>(out + (size_t)r * d);
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = lane + 32 * i;
      if (c < n_chunks) {
        float s[kPer];
        load_f32<S, kPer>(scale + c * kPer, s);
        const T* e = reinterpret_cast<const T*>(&raw[i]);
        alignas(16) T y[kPer];
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          store_f32(to_f32(e[j]) * inv * s[j], &y[j]);
        __stcs(orow + c, *reinterpret_cast<const uint4*>(y));
      }
    }
  }
}

// The row kernel's NCH for a row of n_chunks vectors, or 0 when the row
// does not fit its registers.
inline int row_chunks(int n_chunks) {
  for (int nch : kRowChunks)
    if (32 * nch >= n_chunks) return nch;
  return 0;
}

// f(kernel) for the row kernel at nch vectors a lane, or for the loop
// kernel when nch is 0 or the accesses are not 16-byte vectors.
template <typename T, typename S, bool VEC, typename F>
auto with_kernel(int nch, const F& f) {
  if (VEC) {
    switch (nch) {
      case 1: return f(rmsnorm_row_kernel<T, S, 1>);
      case 2: return f(rmsnorm_row_kernel<T, S, 2>);
      case 3: return f(rmsnorm_row_kernel<T, S, 3>);
      case 4: return f(rmsnorm_row_kernel<T, S, 4>);
      case 6: return f(rmsnorm_row_kernel<T, S, 6>);
      case 8: return f(rmsnorm_row_kernel<T, S, 8>);
      case 12: return f(rmsnorm_row_kernel<T, S, 12>);
      case 16: return f(rmsnorm_row_kernel<T, S, 16>);
      case 24: return f(rmsnorm_row_kernel<T, S, 24>);
      case 32: return f(rmsnorm_row_kernel<T, S, 32>);
    }
  }
  return f(rmsnorm_kernel<T, S, VEC>);
}

// The most warps (a power of two) one block of the row kernel at nch, or
// of the loop kernel (nch 0), can launch with its registers; read once a
// kernel (a race only writes the same value twice).
template <typename T, typename S, bool VEC>
cudaError_t most_warps(int nch, int* warps) {
  static int cached[1 + kNumRowChunks] = {};
  int slot = 0;
  for (int i = 0; i < kNumRowChunks; ++i)
    if (kRowChunks[i] == nch) slot = i + 1;
  if (cached[slot] == 0) {
    const cudaError_t err = with_kernel<T, S, VEC>(nch, [&](auto kernel) {
      return max_launchable_warps(kernel, kMaxWarps, &cached[slot]);
    });
    if (err != cudaSuccess) return err;
  }
  *warps = cached[slot];
  return cudaSuccess;
}

struct RmsnormLaunch {
  const void *x, *scale;
  void* out;
  int rows, d, block_rows, num_warps;
  float eps;
  cudaStream_t stream;

  template <typename T, typename S, bool VEC>
  cudaError_t run() const {
    const int nch = VEC ? row_chunks(d / (16 / int(sizeof(T)))) : 0;
    int most = 0;
    const cudaError_t err = most_warps<T, S, VEC>(nch, &most);
    if (err != cudaSuccess) return err;
    // num_warps, at most what the registers allow; 0: that most, at most
    // the rows
    int warps = num_warps ? min(num_warps, most) : most;
    if (num_warps == 0)
      while (warps > 1 && warps > block_rows) warps >>= 1;
    const int blocks = (rows + block_rows - 1) / block_rows;
    return with_kernel<T, S, VEC>(nch, [&](auto kernel) {
      kernel<<<blocks, warps * 32, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const S*>(scale),
          static_cast<T*>(out), rows, d, block_rows, eps);
      return cudaGetLastError();
    });
  }
};

struct RmsnormSmem {
  // the most any kernel of this dtype pair uses
  template <typename T, typename S, bool VEC>
  int run() const {
    const auto smem = [](auto kernel) { return static_smem_bytes(kernel); };
    int most = with_kernel<T, S, VEC>(0, smem);
    if (VEC)
      for (int nch : kRowChunks)
        most = max(most, with_kernel<T, S, VEC>(nch, smem));
    return most;
  }
};

// f.template run<T, S, VEC>() for x's dtype (0 = float32, 1 = bfloat16)
// and scale's (0 = float32, or x's dtype); `bad` for any other pair.
template <typename F, typename R>
R dispatch(int dtype, int scale_dtype, bool vec, const F& f, R bad) {
  if (dtype == 0 && scale_dtype == 0)
    return vec ? f.template run<float, float, true>()
               : f.template run<float, float, false>();
  if (dtype == 1 && scale_dtype == 0)
    return vec ? f.template run<__nv_bfloat16, float, true>()
               : f.template run<__nv_bfloat16, float, false>();
  if (dtype == 1 && scale_dtype == 1)
    return vec ? f.template run<__nv_bfloat16, __nv_bfloat16, true>()
               : f.template run<__nv_bfloat16, __nv_bfloat16, false>();
  return bad;
}

}  // namespace

// dtype, scale_dtype: 0 = float32, 1 = bfloat16 (scale is f32 or x's
// dtype).  vec: 1 when d is a multiple of 16 / sizeof(x) elements and x,
// scale and out are 16-byte aligned.  num_warps: the block size in warps
// (a power of two up to kMaxWarps; above what the kernel's registers
// allow it launches that most), or 0 for the most the registers allow,
// at most block_rows.  Returns 0 on success, else a cudaError_t code
// (cudaErrorInvalidValue for an argument the kernel does not take).
// Launches on `stream` and does not synchronise.
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* out,
                             int rows, int d, int dtype, int scale_dtype,
                             int vec, float eps, int block_rows,
                             int num_warps, void* stream) {
  if (rows < 1 || d < 1 || block_rows < 1 || num_warps < 0 ||
      num_warps > kMaxWarps || (num_warps & (num_warps - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const RmsnormLaunch launch{x, scale, out, rows, d, block_rows, num_warps,
                             eps, static_cast<cudaStream_t>(stream)};
  return (int)dispatch(dtype, scale_dtype, vec != 0, launch,
                       cudaErrorInvalidValue);
}

// The shared memory (bytes, static; the kernels ask for no dynamic
// shared memory) of one block, the most of any kernel the pair launches,
// as compiled: 0.  -1 for a dtype pair the kernels do not take.  The tuning space's smem_footprint must give the
// same number (chip_smoke.py checks it).
extern "C" int repro_rmsnorm_smem_bytes(int dtype, int scale_dtype,
                                        int vec) {
  return dispatch(dtype, scale_dtype, vec != 0, RmsnormSmem{}, -1);
}
