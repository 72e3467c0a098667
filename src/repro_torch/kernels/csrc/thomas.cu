// Batched Thomas solve of the ob transform's L2 projection, float64, for
// Hopper (sm_90a).  Plain C interface, no PyTorch headers: the wrapper in
// kernels/thomas.py passes raw device pointers, sizes and the current stream
// through ctypes.
//
// thomas_solve replaces no Pallas kernel: it is the jnp graph
// repro/transform/orthogonal.py::_thomas_axis (two lax.scan), which solves
// M z = b along one axis for every line of a field, with
// M = tridiag(1/3, d, 1/3), d = 2/3 at both ends and 4/3 inside.  Under
// jax.jit, XLA's CPU backend contracts each multiply feeding a subtract of
// the scan bodies into a fused multiply-add, so the reference computes
//
//   denom_0 = d_0                       cp_0 = off / denom_0
//   denom_i = fma(-off, cp_{i-1}, d_i)  cp_i = off / denom_i
//   dp_0    = b_0 / denom_0
//   dp_i    = fma(-off, dp_{i-1}, b_i) / denom_i
//   z_{n-1} = dp_{n-1}
//   z_i     = fma(-cp_i, z_{i+1}, dp_i)
//
// with off = 1/3 rounded, and a line of one node is b / (2/3).  Every
// operation here is an explicit __fma_rn / __ddiv_rn, in that order:
// nvcc's default -fmad=true would contract other products on its own, and a
// reciprocal in place of a division would round differently.
//
// cp and denom depend only on n.  thomas_factors computes them once per
// length (one thread: the chain is sequential); the wrapper caches them on
// the device.  thomas_solve then runs one thread per line: it reads its line
// once forward, writes dp into out, and walks back over out writing z.  A
// step's load does not depend on the chain, so each sweep loads 16 nodes
// ahead into registers: without that, a load's latency (a few hundred ns)
// sat on every step and the 2^23+1-node line took 3.8x its chain bound.
//
// Bound on this card: for short lines and many of them, bytes (each value
// of b read once, out written once, the factors read once): 16 B per node.
// For few long lines, the dependent chain: each forward step waits for the
// previous fma and division, each backward step for the previous fma, and
// nothing else overlaps them within a line.  A 1-D field of 2^24 points has
// one line of 2^23 + 1 nodes at its finest level, so there the chain is the
// bound; tools/chain_probe.cu measures its step latencies on the card.
//
// Layout: the field is contiguous as (pre, n, post) around the solve axis.
// Thread t owns line (t / post, t % post); neighbouring threads take
// neighbouring q, so for post > 1 each step's loads and stores are
// coalesced.  For the last axis (post = 1) each thread walks its own
// contiguous line.
//
// Each entry point returns cudaGetLastError() after its launch; none
// synchronises or allocates.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;
constexpr double kOff = 1.0 / 3.0;

__global__ void factors_kernel(int64_t n, double* __restrict__ cp,
                               double* __restrict__ denom) {
  if (n == 1) {
    denom[0] = 2.0 / 3.0;
    cp[0] = __ddiv_rn(kOff, 2.0 / 3.0);
    return;
  }
  double c = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    const double d = (i == 0 || i == n - 1) ? 2.0 / 3.0 : 4.0 / 3.0;
    const double den = __fma_rn(-kOff, c, d);
    c = __ddiv_rn(kOff, den);
    denom[i] = den;
    cp[i] = c;
  }
}

__global__ void solve_kernel(const double* __restrict__ b,
                             const double* __restrict__ cp,
                             const double* __restrict__ denom, int64_t pre,
                             int64_t n, int64_t post,
                             double* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= pre * post) return;
  const int64_t p = t / post;
  const int64_t q = t - p * post;
  const double* __restrict__ bl = b + p * n * post + q;
  double* __restrict__ ol = out + p * n * post + q;
  // Forward sweep, kChunk nodes at a time: the next chunk's loads are
  // issued before this chunk's dependent steps, so their latency hides
  // behind the chain.  dp starts at +0: fma(-off, +0, b_0) = b_0 exactly,
  // the reference scan's first step.
  double bc[kChunk], dc[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    bc[j] = j < n ? bl[j * post] : 0.0;
    dc[j] = j < n ? denom[j] : 1.0;
  }
  double dp = 0.0;
  for (int64_t s = 0; s < n; s += kChunk) {
    double bn[kChunk], dn[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int64_t i = s + kChunk + j;
      bn[j] = i < n ? bl[i * post] : 0.0;
      dn[j] = i < n ? denom[i] : 1.0;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (s + j < n) {
        dp = __ddiv_rn(__fma_rn(-kOff, dp, bc[j]), dc[j]);
        ol[(s + j) * post] = dp;
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      bc[j] = bn[j];
      dc[j] = dn[j];
    }
  }
  // Backward sweep from node n-2 down, prefetched the same way; each node
  // reads the dp this thread wrote.
  double z = dp;
  double oc[kChunk], cc[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int64_t i = n - 2 - j;
    oc[j] = i >= 0 ? ol[i * post] : 0.0;
    cc[j] = i >= 0 ? cp[i] : 0.0;
  }
  for (int64_t s = n - 2; s >= 0; s -= kChunk) {
    double on[kChunk], cn[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int64_t i = s - kChunk - j;
      on[j] = i >= 0 ? ol[i * post] : 0.0;
      cn[j] = i >= 0 ? cp[i] : 0.0;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (s - j >= 0) {
        z = __fma_rn(-cc[j], z, oc[j]);
        ol[(s - j) * post] = z;
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      oc[j] = on[j];
      cc[j] = cn[j];
    }
  }
}

}  // namespace

extern "C" int thomas_factors(int64_t n, void* cp, void* denom, void* stream) {
  if (n <= 0) return 0;
  factors_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<double*>(cp), static_cast<double*>(denom));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int thomas_solve(const void* b, const void* cp, const void* denom,
                            int64_t pre, int64_t n, int64_t post, void* out,
                            void* stream) {
  const int64_t lines = pre * post;
  if (lines <= 0 || n <= 0) return 0;
  const int64_t blocks = (lines + kThreads - 1) / kThreads;
  solve_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(b), static_cast<const double*>(cp),
      static_cast<const double*>(denom), pre, n, post,
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
