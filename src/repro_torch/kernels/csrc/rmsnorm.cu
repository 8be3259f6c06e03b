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
// Design.  The TPU kernel keeps a (block_rows x d) tile resident in VMEM.
// On Hopper a row is one warp's work: its lanes read the row in 16-byte
// vectors (when d and the pointers allow, else element by element), the
// sum of squares is a warp reduction, and the second pass reads the row
// again, from L1 or L2 (a row is 6 KB at d = 3072 in bf16), to write the
// output; nothing goes through shared memory.  A block of num_warps warps
// owns block_rows consecutive rows, warp w taking rows w, w + num_warps,
// ...; block_rows sets how many blocks the grid has.
//
// Bound.  The kernel must read x and scale and write out once:
// (2 * rows * d) * sizeof(T) + d * sizeof(scale) bytes, at most 3.35 TB/s
// on an H100 SXM; about 4 flops an element put it far below the ridge
// point, so it is bound by bytes.

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 32;

// VEC: 16-byte vector accesses (d a multiple of 16 / sizeof(T), every
// pointer 16-byte aligned) or one element at a time.
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

struct RmsnormLaunch {
  const void *x, *scale;
  void* out;
  int rows, d, block_rows, num_warps;
  float eps;
  cudaStream_t stream;

  template <typename T, typename S, bool VEC>
  cudaError_t run() const {
    int warps = num_warps;
    if (warps == 0) {
      // the most warps the registers allow, but no more than the rows
      static int reg_warps = 0;  // a race only writes the same value twice
      if (reg_warps == 0) {
        const cudaError_t err = max_launchable_warps(
            rmsnorm_kernel<T, S, VEC>, kMaxWarps, &reg_warps);
        if (err != cudaSuccess) return err;
      }
      warps = reg_warps;
      while (warps > 1 && warps > block_rows) warps >>= 1;
    }
    const int blocks = (rows + block_rows - 1) / block_rows;
    rmsnorm_kernel<T, S, VEC><<<blocks, warps * 32, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale),
        static_cast<T*>(out), rows, d, block_rows, eps);
    return cudaGetLastError();
  }
};

struct RmsnormSmem {
  template <typename T, typename S, bool VEC>
  int run() const {
    return static_smem_bytes(rmsnorm_kernel<T, S, VEC>);
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
// (a power of two up to kMaxWarps), or 0 for the most the registers allow,
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

// The shared memory (bytes, static; the kernel asks for no dynamic
// shared memory) of one block, as compiled: 0.  -1 for a dtype pair the
// kernel does not take.  The tuning space's smem_footprint must give the
// same number (chip_smoke.py checks it).
extern "C" int repro_rmsnorm_smem_bytes(int dtype, int scale_dtype,
                                        int vec) {
  return dispatch(dtype, scale_dtype, vec != 0, RmsnormSmem{}, -1);
}
