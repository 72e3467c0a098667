// Latency probes for the dependent-chain bound of the Thomas solve
// (src/repro_torch/kernels/csrc/thomas.cu), float64, for Hopper (sm_90a).
// chip_smoke.py compiles this file with the port's nvcc flags and times
// each probe with CUDA events.  One thread runs a chain of dependent steps
// shaped like the solve's steps, built from the same intrinsics:
//
//   chain_fma_div  x = __ddiv_rn(__fma_rn(-1/3, x, 1), 4/3)   (forward)
//   chain_fma      x = __fma_rn(-1/4, x, 1)                   (backward)
//
// So the bound they give is that of this instruction sequence: a solve
// that replaced the division by another sequence rounding the same way
// would have another bound.
//
// Plain C interface: steps, seed, out (one double on the card), stream.
// Each entry point returns cudaGetLastError() after its launch.

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

extern "C" int chain_fma(int64_t steps, double seed, void* out, void* stream) {
  chain_fma_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, seed, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
