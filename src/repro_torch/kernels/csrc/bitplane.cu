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
constexpr int kMaxNbits = 53;        // 2^nbits - 1 is exact in float64
constexpr int kThreads = 256;        // both kernels: 8 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;            // packed words per block (2048 values)
constexpr int kWordsPerWarp = kTile / kWarps;
constexpr unsigned kFull = 0xffffffffu;

// 32 x 32 bit transpose across a warp.  Lane j passes row j of a bit matrix
// (bit i of x = element (j, i)) and gets back column j (bit i of the result
// = element (i, j)).  Stage s swaps the off-diagonal s x s blocks of every
// 2s x 2s block between lanes j and j^s: the lower lane keeps the bit
// positions whose bit s is clear and takes its partner's word rotated left
// by s at the others; the upper lane keeps those with bit s set and takes
// its partner's word rotated right by s.  A stage is a shuffle, a funnel
// rotate and a bit-select (the rotate amounts and masks are per-lane
// constants), so 15 instructions per lane move 1024 bits, where extracting
// them one at a time costs ~8 per bit.
__device__ __forceinline__ uint32_t warp_transpose(uint32_t x, int lane) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    // bit positions with bit s clear: 0x0000ffff, 0x00ff00ff, ... 0x55555555
    const uint32_t low = 0xffffffffu / ((1u << s) + 1u);
    const bool upper = lane & s;
    const uint32_t y = __shfl_xor_sync(kFull, x, s);
    const uint32_t r = __funnelshift_l(y, y, upper ? 32 - s : s);
    const uint32_t keep = upper ? ~low : low;
    x = (x & keep) | (r & ~keep);
  }
  return x;
}

// 4-byte asynchronous copy global -> shared (Ampere's cp.async, kept on
// Hopper): the block puts its whole plane tile in flight without a
// register round trip, then waits once.
__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// bitplane_encode replaces repro/kernels/bitplane_pack.py::_kernel (driven
// by pack_planes_traced and fused with the quantization in
// repro/kernels/ops.py::_encode_planes_fused).
//
// Bound on this card: bytes.  It reads 8 B of float64 per coefficient and
// writes nbits/8 B of plane words (6 B at nbits=48): 117.4 MB at N = 2^23,
// 0.035 ms at 3.35 TB/s.  The work is about 60 warp instructions per packed
// word at nbits = 48 (quantization, two transposes, staging, row stores),
// under 2 per coefficient; PERF.md has what holds it below the bound.
//
// Design: a block of 8 warps owns a tile of 64 packed words (2048
// coefficients); each warp loads its 8 words' coefficients first (one 8-B
// load per lane, 256 contiguous bytes per word, all in flight together).
// Lane i quantizes coefficient 32w+i once (fabs, multiply, floor, fmin, as
// the plain version) and splits the magnitude into lo and hi 32-bit words.
// A warp transpose of lo leaves in lane j the packed word of bit position j,
// i.e. plane nbits-1-j; the hi word (positions 32..nbits-1) is transposed
// only when nbits > 32.  Lanes store their plane words into a shared tile
// whose rows are padded to 65 words, so 32 lanes writing 32 different rows
// of one column hit 32 different banks.  After one barrier each warp writes
// whole plane rows: 64 consecutive words (256 B) per plane, no division.
// Coefficients past n quantize to 0.
__global__ void __launch_bounds__(kThreads)
bitplane_encode_kernel(const double* __restrict__ c, double scale,
                       double max_mag, int64_t n, int64_t nwords, int nbits,
                       uint32_t* __restrict__ out) {
  __shared__ uint32_t tile[kMaxNbits][kTile + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int tile_words = static_cast<int>(
      nwords - w0 < kTile ? nwords - w0 : static_cast<int64_t>(kTile));
  double v[kWordsPerWarp];
#pragma unroll
  for (int u = 0; u < kWordsPerWarp; ++u) {
    const int col = warp * kWordsPerWarp + u;
    const int64_t i = (w0 + col) * 32 + lane;
    v[u] = col < tile_words && i < n ? c[i] : 0.0;
  }
#pragma unroll
  for (int u = 0; u < kWordsPerWarp; ++u) {
    const int col = warp * kWordsPerWarp + u;
    if (col >= tile_words) break;                  // warp-uniform
    const int64_t i = (w0 + col) * 32 + lane;
    unsigned long long mag = 0ull;
    if (i < n) {
      double m = floor(fabs(v[u]) * scale);
      m = fmin(m, max_mag);
      mag = static_cast<unsigned long long>(m);
    }
    const uint32_t lo = warp_transpose(static_cast<uint32_t>(mag), lane);
    if (lane < nbits) tile[nbits - 1 - lane][col] = lo;
    if (nbits > 32) {                              // block-uniform
      const uint32_t hi =
          warp_transpose(static_cast<uint32_t>(mag >> 32), lane);
      if (lane + 32 < nbits) tile[nbits - 33 - lane][col] = hi;
    }
  }
  __syncthreads();
  for (int b = warp; b < nbits; b += kWarps) {
    uint32_t* row = out + static_cast<int64_t>(b) * nwords + w0;
    for (int col = lane; col < tile_words; col += 32) row[col] = tile[b][col];
  }
}

// bitplane_decode replaces repro/kernels/bitplane_unpack.py::_kernel (driven
// by repro/kernels/ops.py::_unpack_kernel_u64 with a hi/lo split for shifts
// >= 32) together with the fused jnp graph ops.py::_decode_fused_body
// (magnitude carry-in, sign, scale) that the JAX reader runs per flush.
//
// Bound on this card: bytes.  Per coefficient it reads P/8 B of plane words,
// 8 B of magnitude state and 1/8 B of sign bits, and writes 8 B of
// magnitude and 8 B of value: 252.7 MB at N = 2^23 and P = 48 (0.075 ms at
// 3.35 TB/s), 203.4 MB at P = 1.  On the run path the work is about 25
// warp instructions per packed word and 32-plane half, under 2 per
// coefficient; the general path adds ~4 per plane slot.
//
// Design: a block of 8 warps owns a tile of 64 packed words.  It copies the
// tile's P x 64 plane words into shared memory with cp.async (each warp
// moves 128 contiguous bytes of one plane row), rows padded to 65 words;
// while those are in flight each warp loads the magnitude state and sign
// bytes of its 8 words into registers.  Then, per word, lane j reads plane
// j's word from the tile's column (conflict-free thanks to the padding) and
// the warp transposes: lane i now holds one word whose bit j is plane j's
// bit of coefficient 32w+i.  P > 32 takes a second round for planes 32..63.
//
// Shifts: the main path's are one descending run s0, s0-1, ... (the
// encoder's planes, concatenated flush by flush).  The block checks that
// from the shifts it stages in shared memory (a block-uniform branch, no
// host read-back), and then a half's new magnitude bits are one bit
// reversal and two shifts: (brev(t) >> (32 - P_h)) << (lowest shift of the
// half).  Any other shifts (holes, duplicates, any order, values up to 63)
// take an unrolled loop over the 32 transposed bits that ORs, for each set
// bit j, plane j's one-bit mask 1 << shift (staged in shared memory; zero
// past P), with the same result.  Then sign and scale as the plain version,
// and lane i writes coefficient 32w+i, so every store is coalesced.  P = 0
// copies the state; a null state means zeros, and a null vals_out
// magnitudes only.
//
// decode_tile is the whole body for the tile ``block`` of one group; the
// solo kernel and the batched one below both inline it, so the solo
// kernel compiles as it did before the batched one existed.
__device__ __forceinline__ void
decode_tile(const uint32_t* __restrict__ words,
            const int64_t* __restrict__ shifts, int nplanes, int64_t nwords,
            const unsigned long long* __restrict__ state,
            unsigned long long* __restrict__ mag_out,
            const uint8_t* __restrict__ sign_bytes, double scale,
            double* __restrict__ vals_out, int64_t block) {
  __shared__ uint32_t tile[kMaxPlanes][kTile + 1];
  __shared__ int sh[kMaxPlanes];
  __shared__ unsigned long long bitmask[kMaxPlanes];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t w0 = block * kTile;
  const int tile_words = static_cast<int>(
      nwords - w0 < kTile ? nwords - w0 : static_cast<int64_t>(kTile));
  for (unsigned k = threadIdx.x; k < static_cast<unsigned>(nplanes) * kTile;
       k += kThreads) {
    const int j = k / kTile;
    const int col = k % kTile;
    if (col < tile_words)
      cp_async4(&tile[j][col], words + j * nwords + w0 + col);
  }
  const int tid = threadIdx.x;
  bool run = true;
  if (tid < kMaxPlanes) bitmask[tid] = 0ull;
  if (tid < nplanes) {
    sh[tid] = static_cast<int>(shifts[tid]);
    bitmask[tid] = 1ull << shifts[tid];
    run = shifts[tid] == shifts[0] - tid;
  }
  unsigned long long st[kWordsPerWarp];
  unsigned sbyte[kWordsPerWarp];
#pragma unroll
  for (int u = 0; u < kWordsPerWarp; ++u) {
    const int col = warp * kWordsPerWarp + u;
    const int64_t i = (w0 + col) * 32 + lane;
    st[u] = 0ull;
    sbyte[u] = 0u;
    if (col < tile_words) {
      if (state != nullptr) st[u] = state[i];
      if (vals_out != nullptr) sbyte[u] = sign_bytes[i >> 3];
    }
  }
  cp_async_wait_all();
  run = __syncthreads_and(run);
#pragma unroll
  for (int u = 0; u < kWordsPerWarp; ++u) {
    const int col = warp * kWordsPerWarp + u;
    if (col >= tile_words) break;                  // warp-uniform
    const int64_t i = (w0 + col) * 32 + lane;
    unsigned long long m = st[u];
    for (int base = 0; base < nplanes; base += 32) {
      const int ph = nplanes - base < 32 ? nplanes - base : 32;
      const uint32_t t =
          warp_transpose(lane < ph ? tile[base + lane][col] : 0u, lane);
      if (run) {
        m |= static_cast<unsigned long long>(__brev(t) >> (32 - ph))
             << sh[base + ph - 1];
      } else {
#pragma unroll
        for (int j = 0; j < 32; ++j)
          if (t & (1u << j)) m |= bitmask[base + j];
      }
    }
    mag_out[i] = m;
    if (vals_out != nullptr) {
      const double v = static_cast<double>(m) * scale;
      const bool neg = (sbyte[u] >> (7 - (lane & 7))) & 1u;
      vals_out[i] = neg ? -v : v;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bitplane_decode_kernel(const uint32_t* __restrict__ words,
                       const int64_t* __restrict__ shifts, int nplanes,
                       int64_t nwords,
                       const unsigned long long* __restrict__ state,
                       unsigned long long* __restrict__ mag_out,
                       const uint8_t* __restrict__ sign_bytes, double scale,
                       double* __restrict__ vals_out) {
  decode_tile(words, shifts, nplanes, nwords, state, mag_out, sign_bytes,
              scale, vals_out, blockIdx.x);
}

// bitplane_decode_batch replaces repro/kernels/ops.py::_decode_fused_batch,
// the jax.vmap of _decode_fused_body over a (B, P, W) stack of groups of
// one word width that the serve plane's decode batcher dispatches once per
// shape bucket and tick.
//
// Bound on this card: bytes, the sum of its B groups' solo bounds (each
// item's own plane count, not the bucket's 64 plane slots: the kernel never
// reads a slot past an item's planes).
//
// Design: one launch over a grid of (ceil(W/64), B) blocks; block (x, b)
// runs the solo kernel's body on tile x of group b.  The groups are not
// stacked: ``table`` is a (7, B) int64 array on the card whose column b
// holds group b's words, shifts, plane count, state (0 = zeros), sign bytes
// (0 = magnitudes only), magnitude output and value output (0 likewise),
// and ``scales`` its (B,) float64 scales, so each group keeps its own
// tensors and plane count and nothing is copied to batch them.  A block
// reads its column once (uniform loads), then decodes exactly as the solo
// kernel: bit-equal to B solo launches.
enum : int { kWords, kShifts, kPlanes, kState, kSigns, kMag, kVals };

__global__ void __launch_bounds__(kThreads)
bitplane_decode_batch_kernel(const long long* __restrict__ table,
                             const double* __restrict__ scales,
                             int64_t nwords) {
  const int b = blockIdx.y;
  const int nb = gridDim.y;
  const long long* col = table + b;
  decode_tile(reinterpret_cast<const uint32_t*>(col[kWords * nb]),
              reinterpret_cast<const int64_t*>(col[kShifts * nb]),
              static_cast<int>(col[kPlanes * nb]), nwords,
              reinterpret_cast<const unsigned long long*>(col[kState * nb]),
              reinterpret_cast<unsigned long long*>(col[kMag * nb]),
              reinterpret_cast<const uint8_t*>(col[kSigns * nb]), scales[b],
              reinterpret_cast<double*>(col[kVals * nb]), blockIdx.x);
}

}  // namespace

extern "C" int bitplane_encode(const void* c, double scale, long long n,
                               long long nwords, int nbits, void* out,
                               void* stream) {
  const double max_mag = ldexp(1.0, nbits) - 1.0;
  const unsigned blocks = static_cast<unsigned>((nwords + kTile - 1) / kTile);
  bitplane_encode_kernel<<<blocks, kThreads, 0,
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
  const unsigned blocks = static_cast<unsigned>((nwords + kTile - 1) / kTile);
  bitplane_decode_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const int64_t*>(shifts), nplanes, nwords,
      static_cast<const unsigned long long*>(state),
      static_cast<unsigned long long*>(mag_out),
      static_cast<const uint8_t*>(sign_bytes), scale,
      static_cast<double*>(vals_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bitplane_decode_batch(const void* table, const void* scales,
                                     int nbatch, long long nwords,
                                     void* stream) {
  const dim3 blocks(static_cast<unsigned>((nwords + kTile - 1) / kTile),
                    static_cast<unsigned>(nbatch));
  bitplane_decode_batch_kernel<<<blocks, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table),
      static_cast<const double*>(scales), nwords);
  return static_cast<int>(cudaGetLastError());
}
