// Two elementwise kernels for Hopper (sm_90a): one hierarchical-surplus
// lifting level (hier_level_surplus) and the fused Vtotal value + error bound
// (qoi_vtotal), each in float32 and float64.  Plain C interface, no PyTorch
// headers: the Python wrappers in kernels/hier_level.py and
// kernels/qoi_vtotal.py pass raw device pointers, host scalars and the
// current stream through ctypes.
//
// Every floating-point operation is a round-to-nearest intrinsic
// (__dadd_rn, __dmul_rn, ... and their __f*_rn forms), which nvcc never
// contracts into an FMA, in the order of the reference
// (repro/kernels/ref.py).  So each result is correctly rounded one operation
// at a time, exactly as the plain PyTorch versions compute it.
//
// Both kernels are one thread per output element over a flat 1-D grid with
// 64-bit indices, so a single long row (B = 1, M = 2^23) and many short
// rows (B = 2^15, M = 256) fill the card alike; there is no grid.y.
//
// Each entry point returns cudaGetLastError() after its launch; it never
// synchronises and never allocates.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct F64Ops {
  using T = double;
  static __device__ T add(T a, T b) { return __dadd_rn(a, b); }
  static __device__ T sub(T a, T b) { return __dsub_rn(a, b); }
  static __device__ T mul(T a, T b) { return __dmul_rn(a, b); }
  static __device__ T div(T a, T b) { return __ddiv_rn(a, b); }
  static __device__ T sqrt(T a) { return __dsqrt_rn(a); }
  static __device__ T abs(T a) { return fabs(a); }
  static __device__ T inf() { return __longlong_as_double(0x7ff0000000000000ll); }
};

struct F32Ops {
  using T = float;
  static __device__ T add(T a, T b) { return __fadd_rn(a, b); }
  static __device__ T sub(T a, T b) { return __fsub_rn(a, b); }
  static __device__ T mul(T a, T b) { return __fmul_rn(a, b); }
  static __device__ T div(T a, T b) { return __fdiv_rn(a, b); }
  static __device__ T sqrt(T a) { return __fsqrt_rn(a); }
  static __device__ T abs(T a) { return fabsf(a); }
  static __device__ T inf() { return __int_as_float(0x7f800000); }
};

// max(a, 0) as jnp.maximum / torch.maximum compute it: a NaN stays NaN
// (CUDA's fmax would return 0).
template <class O>
__device__ typename O::T max0(typename O::T a) {
  return (a != a || a > typename O::T(0)) ? a : typename O::T(0);
}

// hier_level_surplus replaces repro/kernels/hier_level.py::_kernel (entered
// through hier_level_surplus and repro/kernels/ops.py::level_surplus):
//
//   out[r, c] = x_odd[r, c] - 0.5 * (x_even[r, c] + x_even[r, c + 1])
//
// Bound on this card: bytes.  Per output it reads one odd and (about) one
// even value and writes one value, 3 x sizeof(T) B; one add, one multiply
// and one subtract.  0.5 * s is exact, so the result is bit-exact however
// it is compiled; the intrinsics keep the reference's order anyway.
//
// Design: the TPU kernel tiled rows into VMEM with M padded to 128 lanes;
// here each thread finds its row with one 64-bit division and reads its two
// even neighbours straight from device memory (neighbouring threads share
// them through L1).  The even row stride is M + 1, so rows are not 16-byte
// aligned and the loads stay scalar.  No padding of rows or columns.
template <class O>
__device__ void hier_level_body(const typename O::T* __restrict__ even,
                                const typename O::T* __restrict__ odd,
                                int64_t rows, int64_t m,
                                typename O::T* __restrict__ out) {
  using T = typename O::T;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows * m) return;
  const int64_t r = i / m;
  const T* e = even + i + r;          // = even + r * (m + 1) + (i - r * m)
  const T pred = O::mul(T(0.5), O::add(e[0], e[1]));
  out[i] = O::sub(odd[i], pred);
}

__global__ void hier_level_f64_kernel(const double* __restrict__ even,
                                      const double* __restrict__ odd,
                                      int64_t rows, int64_t m,
                                      double* __restrict__ out) {
  hier_level_body<F64Ops>(even, odd, rows, m, out);
}

__global__ void hier_level_f32_kernel(const float* __restrict__ even,
                                      const float* __restrict__ odd,
                                      int64_t rows, int64_t m,
                                      float* __restrict__ out) {
  hier_level_body<F32Ops>(even, odd, rows, m, out);
}

// qoi_vtotal replaces repro/kernels/qoi_vtotal.py::_kernel (entered through
// qoi_vtotal_fused and repro/kernels/ops.py::vtotal_with_bound):
//
//   s     = (vx*vx + vy*vy) + vz*vz
//   eps_s = 2|vx|ex + ex*ex + 2|vy|ey + ey*ey + 2|vz|ez + ez*ez  (left to right)
//   val   = sqrt(max(s, 0))
//   den   = sqrt(max(s - eps_s, 0)) + val
//   bound = den > 0 ? eps_s / den : +inf                 (paper Thm 2)
//
// Bound on this card: bytes.  Per element it reads three values and writes
// two, 5 x sizeof(T) B.  The arithmetic is 14 multiplies and adds, two
// square roots and one division; in float64 each of the last three is a
// multi-instruction FMA sequence on this card, which chip_smoke.py counts
// from the SASS when it reckons the operations bound.
//
// Design: one thread per element, the three epsilons passed by value (the
// TPU kernel prefetched them as a (1, 3) block); no padding of N.
template <class O>
__device__ void qoi_vtotal_body(const typename O::T* __restrict__ vx,
                                const typename O::T* __restrict__ vy,
                                const typename O::T* __restrict__ vz,
                                typename O::T ex, typename O::T ey,
                                typename O::T ez, int64_t n,
                                typename O::T* __restrict__ val,
                                typename O::T* __restrict__ bound) {
  using T = typename O::T;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T x = vx[i], y = vy[i], z = vz[i];
  const T two = T(2);
  T s = O::add(O::add(O::mul(x, x), O::mul(y, y)), O::mul(z, z));
  T e = O::mul(O::mul(two, O::abs(x)), ex);
  e = O::add(e, O::mul(ex, ex));
  e = O::add(e, O::mul(O::mul(two, O::abs(y)), ey));
  e = O::add(e, O::mul(ey, ey));
  e = O::add(e, O::mul(O::mul(two, O::abs(z)), ez));
  e = O::add(e, O::mul(ez, ez));
  s = max0<O>(s);
  const T v = O::sqrt(s);
  const T den = O::add(O::sqrt(max0<O>(O::sub(s, e))), v);
  val[i] = v;
  bound[i] = den > T(0) ? O::div(e, den) : O::inf();
}

__global__ void qoi_vtotal_f64_kernel(const double* __restrict__ vx,
                                      const double* __restrict__ vy,
                                      const double* __restrict__ vz,
                                      double ex, double ey, double ez,
                                      int64_t n, double* __restrict__ val,
                                      double* __restrict__ bound) {
  qoi_vtotal_body<F64Ops>(vx, vy, vz, ex, ey, ez, n, val, bound);
}

__global__ void qoi_vtotal_f32_kernel(const float* __restrict__ vx,
                                      const float* __restrict__ vy,
                                      const float* __restrict__ vz,
                                      float ex, float ey, float ez,
                                      int64_t n, float* __restrict__ val,
                                      float* __restrict__ bound) {
  qoi_vtotal_body<F32Ops>(vx, vy, vz, ex, ey, ez, n, val, bound);
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// dtype: 0 = float32, 1 = float64.
extern "C" int hier_level_surplus(const void* even, const void* odd,
                                  long long rows, long long m, int dtype,
                                  void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    hier_level_f64_kernel<<<blocks_for(rows * m), kThreads, 0, s>>>(
        static_cast<const double*>(even), static_cast<const double*>(odd),
        rows, m, static_cast<double*>(out));
  } else {
    hier_level_f32_kernel<<<blocks_for(rows * m), kThreads, 0, s>>>(
        static_cast<const float*>(even), static_cast<const float*>(odd),
        rows, m, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// The epsilons arrive as doubles; the float32 kernel takes them as floats.
// The wrapper has already rounded them to float32, so that cast is exact.
extern "C" int qoi_vtotal(const void* vx, const void* vy, const void* vz,
                          double ex, double ey, double ez, long long n,
                          int dtype, void* val, void* bound, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    qoi_vtotal_f64_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const double*>(vx), static_cast<const double*>(vy),
        static_cast<const double*>(vz), ex, ey, ez, n,
        static_cast<double*>(val), static_cast<double*>(bound));
  } else {
    qoi_vtotal_f32_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const float*>(vx), static_cast<const float*>(vy),
        static_cast<const float*>(vz), static_cast<float>(ex),
        static_cast<float>(ey), static_cast<float>(ez), n,
        static_cast<float*>(val), static_cast<float*>(bound));
  }
  return static_cast<int>(cudaGetLastError());
}
