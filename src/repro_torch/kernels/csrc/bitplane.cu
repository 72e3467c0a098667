// Bitplane codec kernels for Hopper (sm_90a): encode (quantize + pack every
// magnitude plane) and decode (OR planes into the magnitude state, then sign
// and scale).  Plain C interface, no PyTorch headers: the Python wrappers in
// kernels/bitplane_pack.py and kernels/bitplane_unpack.py pass raw device
// pointers and the current stream through ctypes.
//
// Word layout (shared with the JAX package's archives): plane b holds bit
// nbits-1-b of every magnitude (MSB plane first); bit i of 32-bit word w is
// coefficient 32*w + i.  Sign bytes are packbits order (big-endian within a
// byte: coefficient i is bit 7 - i%8 of byte i/8).
//
// Both kernels are integer-exact, and the only float operations are a
// multiplication by a power of two, floor, a rounding int->double conversion
// and a negation, none of which nvcc can contract.  So every result is
// bit-equal to the plain PyTorch versions and to the JAX package.
//
// Each entry point returns cudaGetLastError() after its launch; it never
// synchronises and never allocates.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPlanes = 64;
constexpr int kEncodeWarps = 32;     // packed words (one per warp) per block
constexpr int kDecodeThreads = 256;

// bitplane_encode replaces repro/kernels/bitplane_pack.py::_kernel (driven
// by pack_planes_traced and fused with the quantization in
// repro/kernels/ops.py::_encode_planes_fused).
//
// Bound on this card: bytes.  It reads 8 B of float64 per coefficient and
// writes nbits/8 B of plane words (6 B at nbits=48); the arithmetic is a
// few integer operations per bit.
//
// Design: one warp per 32 coefficients, one lane per coefficient.  The lane
// quantizes its coefficient to a 64-bit magnitude once; __ballot_sync of bit
// nbits-1-b across the warp is exactly word w of plane b, so all planes come
// from one register with no hi/lo split (the TPU's 32-bit lanes needed two
// passes).  The block stages its 32 words of every plane in shared memory
// and writes each plane's 32 consecutive words (128 B) together, so the
// stores are coalesced instead of one 4-byte store per warp and plane.
// Lanes past n quantize to 0.
__global__ void bitplane_encode_kernel(const double* __restrict__ c,
                                       double scale, double max_mag,
                                       int64_t n, int64_t nwords, int nbits,
                                       uint32_t* __restrict__ out) {
  __shared__ uint32_t tile[kMaxPlanes][kEncodeWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t word0 = static_cast<int64_t>(blockIdx.x) * kEncodeWarps;
  const int64_t i = (word0 + warp) * 32 + lane;
  unsigned long long mag = 0ull;
  if (i < n) {
    double m = floor(fabs(c[i]) * scale);
    m = fmin(m, max_mag);
    mag = static_cast<unsigned long long>(m);
  }
  for (int b = 0; b < nbits; ++b) {
    const unsigned word =
        __ballot_sync(0xffffffffu, (mag >> (nbits - 1 - b)) & 1ull);
    if (lane == 0) tile[b][warp] = word;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nbits * kEncodeWarps; k += blockDim.x) {
    const int b = k / kEncodeWarps;
    const int j = k % kEncodeWarps;
    const int64_t w = word0 + j;
    if (w < nwords) out[static_cast<int64_t>(b) * nwords + w] = tile[b][j];
  }
}

// bitplane_decode replaces repro/kernels/bitplane_unpack.py::_kernel (driven
// by repro/kernels/ops.py::_unpack_kernel_u64 with a hi/lo split for shifts
// >= 32) together with the fused jnp graph ops.py::_decode_fused_body
// (magnitude carry-in, sign, scale) that the JAX reader runs per flush.
//
// Bound on this card: bytes.  Per coefficient it reads P/8 B of plane words,
// 8 B of magnitude state and 1/8 B of sign bits, and writes 8 B of
// magnitude and 8 B of value.
//
// Design: one thread per coefficient, looping over the run-time plane count
// P with 64-bit shifts, so no plane padding and no hi/lo split.  The 32
// threads of a warp read the same word of each plane (one broadcast load);
// the shifts sit in shared memory.  P = 0 copies the state unchanged.
__global__ void bitplane_decode_kernel(const uint32_t* __restrict__ words,
                                       const int64_t* __restrict__ shifts,
                                       int nplanes, int64_t nwords,
                                       const unsigned long long* __restrict__ state,
                                       unsigned long long* __restrict__ mag_out,
                                       const uint8_t* __restrict__ sign_bytes,
                                       double scale,
                                       double* __restrict__ vals_out) {
  __shared__ int sh[kMaxPlanes];
  for (int j = threadIdx.x; j < nplanes; j += blockDim.x)
    sh[j] = static_cast<int>(shifts[j]);
  __syncthreads();
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nwords * 32) return;
  const int64_t w = i >> 5;
  const unsigned bit = static_cast<unsigned>(i & 31);
  unsigned long long m = state != nullptr ? state[i] : 0ull;
  for (int j = 0; j < nplanes; ++j) {
    const unsigned word = words[static_cast<int64_t>(j) * nwords + w];
    m |= static_cast<unsigned long long>((word >> bit) & 1u) << sh[j];
  }
  mag_out[i] = m;
  if (vals_out != nullptr) {
    const double v = static_cast<double>(m) * scale;
    const bool neg = (sign_bytes[i >> 3] >> (7 - (i & 7))) & 1u;
    vals_out[i] = neg ? -v : v;
  }
}

}  // namespace

extern "C" int bitplane_encode(const void* c, double scale, long long n,
                               long long nwords, int nbits, void* out,
                               void* stream) {
  const double max_mag = ldexp(1.0, nbits) - 1.0;
  const unsigned blocks =
      static_cast<unsigned>((nwords + kEncodeWarps - 1) / kEncodeWarps);
  bitplane_encode_kernel<<<blocks, kEncodeWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(c), scale, max_mag, n, nwords, nbits,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bitplane_decode(const void* words, const void* shifts,
                               int nplanes, long long nwords,
                               const void* state, void* mag_out,
                               const void* sign_bytes, double scale,
                               void* vals_out, void* stream) {
  const long long n = nwords * 32;
  const unsigned blocks =
      static_cast<unsigned>((n + kDecodeThreads - 1) / kDecodeThreads);
  bitplane_decode_kernel<<<blocks, kDecodeThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const int64_t*>(shifts), nplanes, nwords,
      static_cast<const unsigned long long*>(state),
      static_cast<unsigned long long*>(mag_out),
      static_cast<const uint8_t*>(sign_bytes), scale,
      static_cast<double*>(vals_out));
  return static_cast<int>(cudaGetLastError());
}
