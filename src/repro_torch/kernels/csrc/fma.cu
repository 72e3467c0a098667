// Fused multiply-add with one rounding, float64, for Hopper (sm_90a).
// Plain C interface, no PyTorch headers: the wrapper in kernels/fma.py
// passes raw device pointers, the element count and the current stream
// through ctypes.
//
// fma_rn replaces no Pallas kernel.  It exists because the reference
// evaluates its QoI bounds, its L2 load vector and its Thomas solve under
// jax.jit, where XLA's CPU backend contracts a multiply feeding an add into
// one fused multiply-add (ROADMAP C3).  The port places an fma exactly
// there; on the card that is this kernel:
//
//   out[i] = __fma_rn(a[i], b[i], c[i])      (a*b + c, rounded once)
//
// An operand is either a full array (stride 1), one value in device memory
// broadcast over the output (stride 0: a 0-d tensor or an expanded view),
// or a value passed by argument (null pointer: a Python float).  So the
// wrapper never materialises a broadcast operand, and a constant such as
// 1/12 costs no copy to the card.
//
// Bound on this card: bytes.  Per element it reads each full operand and
// writes one value, at most 32 B, for one fma; 2 flops per 32 B is far
// below the H100's float64 rate of 34 TFLOP/s against 3.35 TB/s.  One
// thread per element over a flat 1-D grid with 64-bit indices, consecutive
// threads on consecutive addresses; nothing else to design.  __fma_rn is
// the IEEE fused operation in round-to-nearest-even, including inf, NaN and
// signed zeros.
//
// The entry point returns cudaGetLastError() after its launch; it never
// synchronises and never allocates.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ double operand(const double* __restrict__ p,
                                          double v, int64_t stride,
                                          int64_t i) {
  return p == nullptr ? v : p[i * stride];
}

__global__ void fma_rn_kernel(const double* __restrict__ a, double av,
                              int64_t sa, const double* __restrict__ b,
                              double bv, int64_t sb,
                              const double* __restrict__ c, double cv,
                              int64_t sc, int64_t n,
                              double* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n)
    out[i] = __fma_rn(operand(a, av, sa, i), operand(b, bv, sb, i),
                      operand(c, cv, sc, i));
}

}  // namespace

extern "C" int fma_rn(const void* a, double av, int64_t sa, const void* b,
                      double bv, int64_t sb, const void* c, double cv,
                      int64_t sc, int64_t n, void* out, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  fma_rn_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(a), av, sa, static_cast<const double*>(b),
      bv, sb, static_cast<const double*>(c), cv, sc, n,
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
