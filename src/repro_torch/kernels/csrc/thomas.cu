// Batched Thomas solve of the ob transform's L2 projection, float64, for
// Hopper (sm_90a).  Plain C interface, no PyTorch headers: the wrapper in
// kernels/thomas.py passes raw device pointers, sizes, the factor table and
// the current stream through ctypes.
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
// operation here is an explicit _rn intrinsic: nvcc's default -fmad=true
// would contract other products on its own.
//
// The factor table.  For interior nodes cp_i depends only on cp_{i-1}, so
// once two consecutive interior entries are equal, every later interior
// entry equals them (index 14 in float64).  The wrapper runs the recurrence
// on the host until that happens and passes rows (denom, RN(1/denom), cp):
// rows 0..h-1 for nodes 0..h-1, row h for every node h..n-2, row h+1 for
// node n-1 (h = min(K, n - 1)).  Expanded to n entries it equals the plain
// factors bit for bit; the kernel holds it in shared memory.
//
// The quotient.  x / denom_i is computed from the cached y = RN(1/denom)
// by Markstein's sequence (Markstein 1990; Handbook of Floating-Point
// Arithmetic, division with an fma):
//
//   q = RN(x y);  r = fma(-denom, q, x) (exact);  q' = fma(r, y, q) = RN(x/denom)
//
// four dependent roundings instead of __ddiv_rn's longer software
// sequence.  It holds when q is finite and r is exact.  The denominators
// lie in [1/2, 4/3], so y lies in [3/4, 2]:
//  - overflow: |x| < 2^1022 gives |x y| < 2^1023 and |x / denom| < 2^1023,
//    so q, r y and q' are finite;
//  - underflow: r is a multiple of ulp(denom) ulp(q) >= 2^(-53) ulp(q), and
//    of ulp(x) >= that; |x| >= 2^-969 gives |q| >= 2^-970 (y >= 3/4, and
//    q >= |x| when denom < 1, where ulp(denom) = 2^-53), so that grain is
//    at least 2^-1074 and r, under 2^53 grains, is a float64 exactly.
// The guard is the biased exponent of x in [54, 2044], 2^-969 <= |x| <
// 2^1022, read from its high word on the integer pipe.  Every other x
// (signed zeros, subnormals, near-overflow values, inf, NaN) takes
// __ddiv_rn: the same division, inside the kernel.  The tests hold the
// guarded sequence to float64 division on 10^5 seeded x per table
// denominator and on the guard's edges (tests/test_torch_thomas.py).  A
// branch on the guard at every node would sit in the chain (a guarded step
// measured 30.1 ns, the sequence alone about 18), so steady runs take it
// off: a group of 8 nodes runs the sequence while the verdicts are
// gathered beside it, and a group that met any x outside the guard runs
// again from its first node with the guarded step.
//
// Bound on this card: for short lines and many of them, bytes (b read
// once, z written once: 16 B per node).  For few long lines, the dependent
// chain: each forward step is fma, multiply, fma, fma, each backward step
// one fma, and nothing else overlaps them within a line.  A 1-D field of
// 2^24 points has one line of 2^23 + 1 nodes at its finest level, so there
// the chain is the bound; tools/chain_probe.cu measures both steps as the
// steady runs take them.
//
// Four kernels, chosen by layout (pre, n, post) around the solve axis and
// the alignment of b and out; all run the same steps in the same order, so
// they agree bit for bit:
//
// line_kernel, one line (pre * post == 1).  One lane runs the chain and
// never waits on device memory: another warp's lane is the producer, which
// keeps 1-D TMA bulk copies (cp.async.bulk, completion on an mbarrier) of
// b (forward) and dp (backward) in flight into a ring of kStages chunks of
// kChunk doubles.  The chain lane reads each chunk from shared memory a
// group of nodes ahead into registers, writes its results back in place
// and sends the chunk out with one bulk store.  The lead is kStages - 1
// chunks of 1024 nodes, tens of microseconds forward and several backward,
// against a device-memory latency under 1 us.  The last chunk stays in
// shared memory from the forward to the backward sweep, so a line of at
// most kChunk nodes never touches device memory between the two.
//
// Many lines: a warp takes 32 lines, one per lane, each lane walking its
// own row of a [32 lines x n] block in shared memory (rows an odd number of
// doubles apart, so that the lanes' reads hit distinct banks).  Where the
// block fits in shared memory (n up to 901) it stays there for both
// sweeps, so the device sees 16 B per node:
//  - block_kernel: contiguous lines (post == 1, the last axis) of odd n
//    with 16-B aligned b and out.  The warp's lines are one contiguous
//    stretch of device memory laid out as the block, so one TMA bulk copy
//    brings it in and one sends it out.
//  - resident_kernel: the other layouts.  Tiles of [32 lines x kTile
//    nodes] come in by cp.async, kAhead ahead of the forward sweep:
//    contiguous lines node-major (each copy instruction coalesced along a
//    line), strided lines (post > 1) line-major (coalesced across
//    neighbouring lines); each tile of z goes out once the backward sweep
//    has passed it.  Its many small copies are what hold it below
//    block_kernel: with more of them in flight (kAhead 4 or 8, or loads
//    staged in registers) it ran slower, not faster.
// Longer lines stream through a double-buffered tile pair (stream_kernel)
// and send dp through device memory and back.
//
// Each entry point returns cudaGetLastError() after its launch; none
// synchronises or allocates.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr double kOff = 1.0 / 3.0;
constexpr int kMaxRows = 64;      // table rows the kernels take (h + 2)
constexpr int kGroup = 8;         // nodes per group of a steady run

// ---- the steps -------------------------------------------------------------

// 1 where x is outside Markstein's guard: biased exponent not in [54, 2044]
__device__ __forceinline__ unsigned guard_fails(double x) {
  const unsigned e = (static_cast<unsigned>(__double2hiint(x)) >> 20) & 0x7ffu;
  return e - 54u > 2044u - 54u ? 1u : 0u;
}

// RN(x / d) from y = RN(1 / d), d in [1/2, 4/3], for x inside the guard
__device__ __forceinline__ double markstein(double x, double d, double y) {
  const double q = __dmul_rn(x, y);
  const double r = __fma_rn(-d, q, x);
  return __fma_rn(r, y, q);
}

// RN(x / d): Markstein's sequence inside the guard, the division outside
__device__ __forceinline__ double quotient(double x, double d, double y) {
  return guard_fails(x) ? __ddiv_rn(x, d) : markstein(x, d, y);
}

__device__ __forceinline__ double forward_step(double dp, double b, double d,
                                               double y) {
  return quotient(__fma_rn(-kOff, dp, b), d, y);
}

__device__ __forceinline__ double backward_step(double z, double dp,
                                                double c) {
  return __fma_rn(-c, z, dp);
}

// table row of node i of an n-node line: 0..h-1, h for h..n-2, h+1 for n-1
__device__ __forceinline__ const double* row_of(const double* tab, int h,
                                                int64_t n, int64_t i) {
  const int64_t r = (i == n - 1) ? h + 1 : (i < h ? i : h);
  return tab + 3 * r;
}

// The steady runs below read groups of kGroup nodes from shared memory
// into three rotating register buffers, two groups ahead of the chain, so
// no load latency and no register copy sits between two groups.

__device__ __forceinline__ void load_group(double (&r)[kGroup],
                                           const double* v) {
#pragma unroll
  for (int k = 0; k < kGroup; ++k) r[k] = v[k];
}

// kGroup forward steps on row (d, y) from b[], results to out[0..kGroup).
// Markstein's sequence runs for every node while the guard's verdicts are
// gathered beside the chain; a group that met any x outside the guard runs
// again from its first node with the guarded step.
__device__ __forceinline__ double forward_group(const double (&b)[kGroup],
                                                double* out, double dp,
                                                double d, double y) {
  const double dp0 = dp;
  unsigned outside = 0;
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    const double x = __fma_rn(-kOff, dp, b[k]);
    outside |= guard_fails(x);
    dp = markstein(x, d, y);
    out[k] = dp;
  }
  if (__builtin_expect(outside != 0, 0)) {
    dp = dp0;
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      dp = forward_step(dp, b[k], d, y);
      out[k] = dp;
    }
  }
  return dp;
}

// kGroup backward steps on c from dp[] (nodes top, top-1, ...), results to
// out[0], out[-1], ...
__device__ __forceinline__ double backward_group(const double (&dp)[kGroup],
                                                 double* out, double z,
                                                 double c) {
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    z = backward_step(z, dp[k], c);
    out[-k] = z;
  }
  return z;
}

__device__ __forceinline__ void load_group_down(double (&r)[kGroup],
                                                const double* v) {
#pragma unroll
  for (int k = 0; k < kGroup; ++k) r[k] = v[-k];
}

// Forward sweep over v[0..len) in shared memory (nodes i0..i0+len-1), dp
// carried in and out, results written over v.  Nodes past h and before
// n-1 all take row h: the run's whole groups of them are steady, with the
// row in registers.  The other nodes (the head below h, the tail, node
// n-1) take the guarded step one by one.
__device__ __forceinline__ double forward_run(double* v, int len, int64_t i0,
                                              double dp, const double* tab,
                                              int h, int64_t n) {
  int j = 0;
  for (; j < len && i0 + j < h; ++j) {
    const double* row = row_of(tab, h, n, i0 + j);
    dp = forward_step(dp, v[j], row[0], row[1]);
    v[j] = dp;
  }
  const int stop = n - 1 - i0 < len ? static_cast<int>(n - 1 - i0) : len;
  const int groups = stop > j ? (stop - j) / kGroup : 0;
  if (groups > 0) {
    const double d = tab[3 * h], y = tab[3 * h + 1];
    double* w = v + j;
    double r0[kGroup], r1[kGroup], r2[kGroup];
    load_group(r0, w);
    if (groups > 1) load_group(r1, w + kGroup);
    for (int g = 0;;) {
      if (g + 2 < groups) load_group(r2, w + (g + 2) * kGroup);
      dp = forward_group(r0, w + g * kGroup, dp, d, y);
      if (++g == groups) break;
      if (g + 2 < groups) load_group(r0, w + (g + 2) * kGroup);
      dp = forward_group(r1, w + g * kGroup, dp, d, y);
      if (++g == groups) break;
      if (g + 2 < groups) load_group(r1, w + (g + 2) * kGroup);
      dp = forward_group(r2, w + g * kGroup, dp, d, y);
      if (++g == groups) break;
    }
  }
  for (j += groups * kGroup; j < len; ++j) {
    const double* row = row_of(tab, h, n, i0 + j);
    dp = forward_step(dp, v[j], row[0], row[1]);
    v[j] = dp;
  }
  return dp;
}

// Backward sweep over v[0..len) from the top down (nodes i0+len-1..i0,
// every one at most n-2), z carried in and out, results written over v:
// whole groups of nodes at or past h steady (row h in registers), the rest
// one by one.
__device__ __forceinline__ double backward_run(double* v, int len, int64_t i0,
                                               double z, const double* tab,
                                               int h) {
  const int low = h - i0 > 0 ? static_cast<int>(h - i0 < len ? h - i0 : len)
                             : 0;
  const int groups = (len - low) / kGroup;
  if (groups > 0) {
    const double c = tab[3 * h + 2];
    double* w = v + len - 1;
    double r0[kGroup], r1[kGroup], r2[kGroup];
    load_group_down(r0, w);
    if (groups > 1) load_group_down(r1, w - kGroup);
    for (int g = 0;;) {
      if (g + 2 < groups) load_group_down(r2, w - (g + 2) * kGroup);
      z = backward_group(r0, w - g * kGroup, z, c);
      if (++g == groups) break;
      if (g + 2 < groups) load_group_down(r0, w - (g + 2) * kGroup);
      z = backward_group(r1, w - g * kGroup, z, c);
      if (++g == groups) break;
      if (g + 2 < groups) load_group_down(r1, w - (g + 2) * kGroup);
      z = backward_group(r2, w - g * kGroup, z, c);
      if (++g == groups) break;
    }
  }
  for (int j = len - groups * kGroup - 1; j >= 0; --j) {
    const int64_t i = i0 + j;
    z = backward_step(z, v[j], tab[3 * (i < h ? i : h) + 2]);
    v[j] = z;
  }
  return z;
}

// ---- shared-memory barriers and bulk copies (PTX) --------------------------

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem(bar)),
      "r"(bytes)
      : "memory");
}

// global -> shared, `bytes` a multiple of 16, both addresses 16-B aligned
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem(dst)),
      "l"(src), "r"(bytes), "r"(smem(bar))
      : "memory");
}

// shared -> global, one bulk group per call
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::
                   "l"(dst),
               "r"(smem(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kPending)
               : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// ---- one line: chain lane + TMA producer -----------------------------------

constexpr int kChunk = 1024;      // doubles per stage (8 KB)
constexpr int kStages = 4;
constexpr int kLineThreads = 64;  // warp 0 lane 0: chain; warp 1 lane 0: producer

struct LineSmem {
  alignas(128) double buf[kStages][kChunk];
  double tab[3 * kMaxRows];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t turn;
};

// chunk c of a line into `dst`, completing on `bar`: a bulk copy of its even
// part; an odd last node (only the last chunk can have one) by a plain load
__device__ __forceinline__ void load_chunk(const double* src, int64_t c,
                                           int64_t n, double* dst,
                                           uint64_t* bar) {
  const int64_t i0 = c * kChunk;
  const int len = static_cast<int>(n - i0 < kChunk ? n - i0 : kChunk);
  const int even = len & ~1;
  if (len & 1) dst[len - 1] = src[i0 + len - 1];
  if (even) {
    mbar_arrive_tx(bar, static_cast<unsigned>(even * 8));
    bulk_load(dst, src + i0, static_cast<unsigned>(even * 8), bar);
  } else {
    mbar_arrive(bar);
  }
}

__global__ void __launch_bounds__(kLineThreads)
    line_kernel(const double* __restrict__ b, const double* __restrict__ table,
                int h, int64_t n, double* __restrict__ out) {
  __shared__ LineSmem sm;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 1);
    }
    mbar_init(&sm.turn, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int t = tid; t < 3 * (h + 2); t += kLineThreads) sm.tab[t] = table[t];
  __syncthreads();
  const int64_t chunks = (n + kChunk - 1) / kChunk;

  if (tid == 32) {
    // producer.  Tickets number the chunks in the order the chain takes
    // them: forward 0..chunks-1, then backward chunks-2..0 as tickets
    // chunks..2*chunks-2 (the last chunk is kept, not reloaded).
    for (int64_t k = 0; k < chunks; ++k) {
      const int s = static_cast<int>(k % kStages);
      mbar_wait(&sm.empty[s], static_cast<unsigned>((k / kStages) & 1) ^ 1u);
      load_chunk(b, k, n, sm.buf[s], &sm.full[s]);
    }
    if (chunks < 2) return;
    mbar_wait(&sm.turn, 0);            // dp of chunks 0..chunks-2 is out
    asm volatile("fence.proxy.async.global;" ::: "memory");
    for (int64_t k = chunks; k <= 2 * chunks - 2; ++k) {
      const int s = static_cast<int>(k % kStages);
      mbar_wait(&sm.empty[s], static_cast<unsigned>((k / kStages) & 1) ^ 1u);
      load_chunk(out, 2 * chunks - 2 - k, n, sm.buf[s], &sm.full[s]);
    }
    return;
  }
  if (tid != 0) return;

  // the chain.  A ticket's stage is released (empty) once its results have
  // been read out of shared memory by its bulk store.
  const double* tab = sm.tab;
  double dp = 0.0;  // fma(-off, +0, b_0) = b_0 exactly: the first step
  for (int64_t k = 0; k < chunks; ++k) {
    const int s = static_cast<int>(k % kStages);
    const int64_t i0 = k * kChunk;
    const int len = static_cast<int>(n - i0 < kChunk ? n - i0 : kChunk);
    mbar_wait(&sm.full[s], static_cast<unsigned>((k / kStages) & 1));
    dp = forward_run(sm.buf[s], len, i0, dp, tab, h, n);
    if (k < chunks - 1) {
      bulk_store(out + i0, sm.buf[s], kChunk * 8);
      bulk_wait_read<1>();
    } else {
      bulk_wait_read<0>();
    }
    if (k > 0) mbar_arrive(&sm.empty[(k - 1) % kStages]);
  }
  // every forward store has landed before the producer reads dp back
  bulk_wait_all();
  asm volatile("fence.proxy.async.global;" ::: "memory");
  mbar_arrive(&sm.turn);

  double z = dp;  // z_{n-1} = dp_{n-1}
  int64_t prev = chunks - 1;
  for (int64_t k = chunks - 1; k <= 2 * chunks - 2; ++k) {
    const int64_t c = 2 * chunks - 2 - k;   // k = chunks-1: the kept chunk
    const int s = static_cast<int>(k % kStages);
    if (k >= chunks)
      mbar_wait(&sm.full[s], static_cast<unsigned>((k / kStages) & 1));
    const int64_t i0 = c * kChunk;
    const int len = static_cast<int>(n - i0 < kChunk ? n - i0 : kChunk);
    // nodes up to n-2 step; node n-1 keeps dp_{n-1}
    const int top = static_cast<int>(i0 + len < n ? len : len - 1);
    z = backward_run(sm.buf[s], top, i0, z, tab, h);
    const int even = len & ~1;
    if (len & 1) out[i0 + len - 1] = sm.buf[s][len - 1];
    if (even) bulk_store(out + i0, sm.buf[s], static_cast<unsigned>(even * 8));
    bulk_wait_read<1>();
    if (k > chunks - 1) mbar_arrive(&sm.empty[prev % kStages]);
    prev = k;
  }
  bulk_wait_all();
}

// ---- many lines: a warp per 32 lines, tiles through shared memory ----------

constexpr int kTile = 32;           // nodes per tile
constexpr int kAhead = 2;           // resident kernel: tiles in flight ahead
constexpr int kPitch = kTile + 1;   // streaming kernel: doubles per row
constexpr int kStreamWarps = 2;
constexpr int kMaxSmem = 232448;    // shared memory one block may have

// bytes of shared memory the resident kernel takes for n-node lines: the
// table and 32 rows of n doubles, the pitch odd so that lanes walking
// their rows, and lanes copying a column, hit distinct banks
int64_t resident_bytes(int64_t n) { return (3 * kMaxRows + 32 * (n | 1)) * 8; }

// Copy tile t of a warp's lines between device memory (line r of the warp
// starts at g + base of lane r and steps by `stride`) and shared memory
// (node i0 + j of line r at cols[r * pitch + j]): load = true issues
// cp.async, false stores.  `valid` lines only.  Unrolled, so the copies of
// a tile are independent instructions in flight together.
template <bool kContiguous>
__device__ __forceinline__ void move_tile(double* cols, int pitch, double* g,
                                          int64_t my_base, int64_t stride,
                                          int64_t t, int64_t n, int lane,
                                          unsigned valid, bool load) {
  const int64_t i0 = t * kTile;
  const int len = static_cast<int>(n - i0 < kTile ? n - i0 : kTile);
  if (kContiguous) {
    // lane = node: line r's row is contiguous (lines are consecutive, n
    // apart), copied by the whole warp
    const int64_t base0 = my_base - lane * n;
    if (lane >= len) return;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      if (!((valid >> r) & 1u)) continue;
      double* gp = g + base0 + r * n + (i0 + lane);
      double* sp = cols + r * pitch + lane;
      if (load) cp_async8(sp, gp); else *gp = *sp;
    }
  } else {
    // lane = line: node j of 32 neighbouring lines is contiguous
    if (!((valid >> lane) & 1u)) return;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j >= len) break;
      double* gp = g + my_base + (i0 + j) * stride;
      double* sp = cols + lane * pitch + j;
      if (load) cp_async8(sp, gp); else *gp = *sp;
    }
  }
}

struct Lines {
  int64_t base, stride;
  unsigned valid;
  bool mine;
};

template <bool kContiguous>
__device__ __forceinline__ Lines warp_lines(int64_t first, int lane,
                                            int64_t pre, int64_t n,
                                            int64_t post) {
  const int64_t line = first + lane;
  const int64_t lines = pre * post;
  const int64_t p = line / post, q = line - p * post;
  Lines l;
  l.valid = __ballot_sync(0xffffffffu, line < lines);
  l.mine = line < lines;
  l.base = p * n * post + q;  // also past the last line: never read there
  l.stride = kContiguous ? 1 : post;
  return l;
}

// Lines short enough that 32 of them fit in shared memory: each block is
// one warp, which keeps its lines there from the first load to the last
// store, so dp never leaves the SM; tiles of b stream in kAhead ahead of
// the forward sweep, and each tile of z goes out once the backward sweep
// has passed it.
template <bool kContiguous>
__global__ void __launch_bounds__(32)
    resident_kernel(const double* __restrict__ b,
                    const double* __restrict__ table, int h, int64_t pre,
                    int64_t n, int64_t post, double* __restrict__ out) {
  extern __shared__ double dyn[];
  double* const tab = dyn;
  double* const rows = dyn + 3 * kMaxRows;
  const int pitch = static_cast<int>(n | 1);
  const int lane = threadIdx.x;
  for (int t = lane; t < 3 * (h + 2); t += 32) tab[t] = table[t];
  const Lines l = warp_lines<kContiguous>(
      static_cast<int64_t>(blockIdx.x) * 32, lane, pre, n, post);
  double* const bg = const_cast<double*>(b);
  double* const row = rows + lane * pitch;
  const int64_t tiles = (n + kTile - 1) / kTile;
  for (int64_t t = 0; t < kAhead; ++t) {
    if (t < tiles)
      move_tile<kContiguous>(rows + t * kTile, pitch, bg, l.base, l.stride,
                             t, n, lane, l.valid, true);
    cp_async_commit();
  }
  double dp = 0.0;  // fma(-off, +0, b_0) = b_0 exactly: the first step
  for (int64_t t = 0; t < tiles; ++t) {
    cp_async_wait<kAhead - 1>();
    __syncwarp();
    const int64_t i0 = t * kTile;
    const int len = static_cast<int>(n - i0 < kTile ? n - i0 : kTile);
    if (l.mine)
      dp = forward_run(row + i0, len, i0, dp, tab, h, n);
    if (t + kAhead < tiles)
      move_tile<kContiguous>(rows + (t + kAhead) * kTile, pitch, bg, l.base,
                             l.stride, t + kAhead, n, lane, l.valid, true);
    cp_async_commit();
  }
  double z = dp;  // z_{n-1} = dp_{n-1}
  for (int64_t t = tiles - 1; t >= 0; --t) {
    const int64_t i0 = t * kTile;
    const int len = static_cast<int>(n - i0 < kTile ? n - i0 : kTile);
    const int top = static_cast<int>(i0 + len < n ? len : len - 1);
    if (l.mine)
      z = backward_run(row + i0, top, i0, z, tab, h);
    __syncwarp();
    move_tile<kContiguous>(rows + i0, pitch, out, l.base, l.stride, t, n,
                           lane, l.valid, false);
  }
}

// Contiguous lines of odd length (post == 1, n odd, b and out 16-B
// aligned): a warp's 32 lines are one contiguous block of device memory,
// and with n odd its rows, n doubles apart, are also the resident layout.
// One bulk copy (TMA, completion on an mbarrier) brings the block in, the
// lanes run both sweeps on their rows, and one bulk copy sends it out: no
// per-tile copy instructions, and nothing of it through L1.
__global__ void __launch_bounds__(32)
    block_kernel(const double* __restrict__ b,
                 const double* __restrict__ table, int h, int64_t lines,
                 int64_t n, double* __restrict__ out) {
  extern __shared__ __align__(16) double blk[];
  __shared__ uint64_t bar;
  double* const tab = blk;
  double* const rows = blk + 3 * kMaxRows;
  const int lane = threadIdx.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * 32;
  const int nrows = static_cast<int>(lines - first < 32 ? lines - first : 32);
  const int64_t count = nrows * n;            // doubles of the block
  const int64_t even = count & ~int64_t{1};
  if (lane == 0) {
    mbar_init(&bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (count & 1) rows[count - 1] = b[first * n + count - 1];
    if (even) {
      mbar_arrive_tx(&bar, static_cast<unsigned>(even * 8));
      bulk_load(rows, b + first * n, static_cast<unsigned>(even * 8), &bar);
    } else {
      mbar_arrive(&bar);
    }
  }
  for (int t = lane; t < 3 * (h + 2); t += 32) tab[t] = table[t];
  __syncwarp();
  mbar_wait(&bar, 0);
  if (lane < nrows) {
    double* const row = rows + lane * n;
    const double dp = forward_run(row, static_cast<int>(n), 0, 0.0, tab, h, n);
    backward_run(row, static_cast<int>(n - 1), 0, dp, tab, h);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncwarp();
  if (lane == 0) {
    if (count & 1) out[first * n + count - 1] = rows[count - 1];
    if (even) {
      bulk_store(out + first * n, rows, static_cast<unsigned>(even * 8));
      bulk_wait_read<0>();
    }
  }
}

// Longer lines: each warp streams its lines through a double-buffered pair
// of [32 x kTile] tiles; dp goes out after the forward sweep and comes back
// for the backward one.
struct StreamSmem {
  double buf[kStreamWarps][2][32 * kPitch];
  double tab[3 * kMaxRows];
};

template <bool kContiguous>
__global__ void __launch_bounds__(32 * kStreamWarps)
    stream_kernel(const double* __restrict__ b,
                  const double* __restrict__ table, int h, int64_t pre,
                  int64_t n, int64_t post, double* __restrict__ out) {
  __shared__ StreamSmem sm;
  for (int t = threadIdx.x; t < 3 * (h + 2); t += blockDim.x)
    sm.tab[t] = table[t];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Lines l = warp_lines<kContiguous>(
      (static_cast<int64_t>(blockIdx.x) * kStreamWarps + warp) * 32, lane,
      pre, n, post);
  if (l.valid == 0) return;
  double* const buf0 = sm.buf[warp][0];
  double* const buf1 = sm.buf[warp][1];
  double* const bg = const_cast<double*>(b);
  const int64_t tiles = (n + kTile - 1) / kTile;
  const double* tab = sm.tab;

  // forward: tile t lives in buffer t & 1; the next one is in flight
  move_tile<kContiguous>(buf0, kPitch, bg, l.base, l.stride, 0, n, lane,
                         l.valid, true);
  cp_async_commit();
  if (tiles > 1)
    move_tile<kContiguous>(buf1, kPitch, bg, l.base, l.stride, 1, n, lane,
                           l.valid, true);
  cp_async_commit();
  double dp = 0.0;
  for (int64_t t = 0; t < tiles; ++t) {
    cp_async_wait<1>();
    __syncwarp();
    double* const tile = (t & 1) ? buf1 : buf0;
    const int64_t i0 = t * kTile;
    const int len = static_cast<int>(n - i0 < kTile ? n - i0 : kTile);
    if (l.mine)
      dp = forward_run(tile + lane * kPitch, len, i0, dp, tab, h,
                                   n);
    __syncwarp();
    if (t < tiles - 1) {
      move_tile<kContiguous>(tile, kPitch, out, l.base, l.stride, t, n, lane,
                             l.valid, false);
      __syncwarp();
      if (t + 2 < tiles)
        move_tile<kContiguous>(tile, kPitch, bg, l.base, l.stride, t + 2, n,
                               lane, l.valid, true);
    }
    cp_async_commit();
  }
  // each lane reads back what it stored itself (the same copy pattern both
  // ways); the fence orders those stores before the copies that read them
  __threadfence_block();
  __syncwarp();

  // backward: the last tile is still here; tile t-1 is in flight
  if (tiles > 1)
    move_tile<kContiguous>((tiles & 1) ? buf1 : buf0, kPitch, out, l.base,
                           l.stride, tiles - 2, n, lane, l.valid, true);
  cp_async_commit();
  double z = dp;  // z_{n-1} = dp_{n-1}
  for (int64_t t = tiles - 1; t >= 0; --t) {
    cp_async_wait<1>();
    __syncwarp();
    double* const tile = (t & 1) ? buf1 : buf0;
    const int64_t i0 = t * kTile;
    const int len = static_cast<int>(n - i0 < kTile ? n - i0 : kTile);
    const int top = static_cast<int>(i0 + len < n ? len : len - 1);
    if (l.mine)
      z = backward_run(tile + lane * kPitch, top, i0, z, tab, h);
    __syncwarp();
    move_tile<kContiguous>(tile, kPitch, out, l.base, l.stride, t, n, lane,
                           l.valid, false);
    __syncwarp();
    if (t >= 2)
      move_tile<kContiguous>(tile, kPitch, out, l.base, l.stride, t - 2, n,
                             lane, l.valid, true);
    cp_async_commit();
  }
}

template <bool kContiguous>
cudaError_t launch_lines(const double* b, const double* table, int h,
                         int64_t pre, int64_t n, int64_t post, double* out,
                         cudaStream_t st) {
  const int64_t lines = pre * post;
  const int64_t bytes = resident_bytes(n);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(out)) &
       15u) == 0;
  if (kContiguous && (n & 1) && aligned && bytes + 64 <= kMaxSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(block_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    block_kernel<<<static_cast<unsigned>((lines + 31) / 32), 32,
                   static_cast<size_t>(bytes), st>>>(b, table, h, lines, n,
                                                     out);
  } else if (bytes <= kMaxSmem) {
    // room for the bytes, and the largest shared-memory carveout, so that
    // as many blocks as fit share each SM
    cudaError_t err = cudaFuncSetAttribute(
        resident_kernel<kContiguous>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(resident_kernel<kContiguous>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    resident_kernel<kContiguous>
        <<<static_cast<unsigned>((lines + 31) / 32), 32,
           static_cast<size_t>(bytes), st>>>(b, table, h, pre, n, post, out);
  } else {
    const int64_t per_block = 32 * kStreamWarps;
    stream_kernel<kContiguous>
        <<<static_cast<unsigned>((lines + per_block - 1) / per_block),
           32 * kStreamWarps, 0, st>>>(b, table, h, pre, n, post, out);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int thomas_solve(const void* b, const void* table, int h,
                            int64_t pre, int64_t n, int64_t post, void* out,
                            void* stream) {
  const int64_t lines = pre * post;
  if (lines <= 0 || n <= 0) return 0;
  if (h < 0 || h + 2 > kMaxRows || h > n - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* bp = static_cast<const double*>(b);
  const double* tp = static_cast<const double*>(table);
  double* op = static_cast<double*>(out);
  if (lines == 1) {
    // bulk copies need 16-B aligned addresses
    if ((reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(out)) &
        15u)
      return static_cast<int>(cudaErrorMisalignedAddress);
    line_kernel<<<1, kLineThreads, 0, st>>>(bp, tp, h, n, op);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(
      post == 1 ? launch_lines<true>(bp, tp, h, pre, n, post, op, st)
                : launch_lines<false>(bp, tp, h, pre, n, post, op, st));
}
