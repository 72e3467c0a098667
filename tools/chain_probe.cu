// Latency probes for the dependent-chain bound of the Thomas solve
// (src/repro_torch/kernels/csrc/thomas.cu), float64, for Hopper (sm_90a).
// chip_smoke.py compiles this file with the port's nvcc flags and times
// each probe with CUDA events.  One thread runs a chain of dependent steps
// shaped like the solve's steps, built from the same intrinsics:
//
//   chain_fma_div   x = __ddiv_rn(__fma_rn(-1/3, x, 1), 4/3)  (forward, by
//                   the division: the earlier kernel's step)
//   chain_fma_quot  x = quotient(__fma_rn(-1/3, x, 1), d, y)  (forward)
//   chain_fma       x = __fma_rn(-1/4, x, 1)                  (backward)
//
// quotient is the kernel's steady forward step (csrc/thomas.cu::
// forward_run, copied here): Markstein's sequence from y = RN(1/d), a
// multiply then two fma, with the exponent guard's verdicts gathered beside
// the chain per group of 8 steps and __ddiv_rn in a rerun of any group that
// met an x outside the guard (none does here).  So the bound each probe
// gives is that of its instruction sequence.
//
// Plain C interface: steps, seed, out (one double on the card), stream;
// chain_fma_quot also takes d and y.  Each entry point returns
// cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void chain_fma_div_kernel(int64_t steps, double seed,
                                     double* __restrict__ out) {
  double x = seed;
  for (int64_t i = 0; i < steps; ++i)
    x = __ddiv_rn(__fma_rn(-1.0 / 3.0, x, 1.0), 4.0 / 3.0);
  out[0] = x;
}

__device__ __forceinline__ unsigned guard_fails(double x) {
  const unsigned e = (static_cast<unsigned>(__double2hiint(x)) >> 20) & 0x7ffu;
  return e - 54u > 2044u - 54u ? 1u : 0u;
}

__device__ __forceinline__ double markstein(double x, double d, double y) {
  const double q = __dmul_rn(x, y);
  const double r = __fma_rn(-d, q, x);
  return __fma_rn(r, y, q);
}

// groups of 8 steps as the kernel's steady forward sweep runs them: the
// sequence for every step, the guard's verdicts gathered beside the chain,
// the group run again with the division where any x fell outside
__global__ void chain_fma_quot_kernel(int64_t steps, double seed, double d,
                                      double y, double* __restrict__ out) {
  double x = seed;
  for (int64_t i = 0; i < steps; i += 8) {
    const double x0 = x;
    unsigned outside = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const double v = __fma_rn(-1.0 / 3.0, x, 1.0);
      outside |= guard_fails(v);
      x = markstein(v, d, y);
    }
    if (__builtin_expect(outside != 0, 0)) {
      x = x0;
#pragma unroll 1
      for (int j = 0; j < 8; ++j) {
        const double v = __fma_rn(-1.0 / 3.0, x, 1.0);
        x = guard_fails(v) ? __ddiv_rn(v, d) : markstein(v, d, y);
      }
    }
  }
  out[0] = x;
}

__global__ void chain_fma_kernel(int64_t steps, double seed,
                                 double* __restrict__ out) {
  double x = seed;
  for (int64_t i = 0; i < steps; ++i) x = __fma_rn(-0.25, x, 1.0);
  out[0] = x;
}

}  // namespace

extern "C" int chain_fma_div(int64_t steps, double seed, void* out,
                             void* stream) {
  chain_fma_div_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, seed, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int chain_fma_quot(int64_t steps, double seed, double d, double y,
                              void* out, void* stream) {
  chain_fma_quot_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, seed, d, y, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int chain_fma(int64_t steps, double seed, void* out, void* stream) {
  chain_fma_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, seed, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
