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
// Each operand arrives as (pointer, value, stride in elements): a null
// pointer means the value itself (a Python float), stride 0 one value in
// device memory broadcast over the output (a 0-d tensor or an expanded
// view), any other stride an array whose element i is at p[i*stride] (a
// contiguous tensor, or a 1-D view such as even[1:] at stride 2).  So the
// wrapper never materialises a broadcast or a 1-D strided view.
//
// Bound on this card: bytes.  Per element it reads each array operand once
// and writes one value, 32 B with three arrays and 24 B with one constant,
// for one fma: far below the H100's float64 rate of 34 TFLOP/s against
// 3.35 TB/s.  At 2^24 elements a plain one-thread-per-element kernel,
// torch.addcmul and this kernel all stream at ~91 % of that rate, which is
// what this card's memory gives (tools/time_fma.py, PERF.md).  So the
// design moves those bytes with the fewest instructions and no select:
//
//  - Each operand's kind is a template parameter: vector (stride 1, at the
//    same address mod 16 as out), strided (any other stride, a stride-1
//    operand off out's alignment included) or constant (a value, or one
//    value in memory, read once per thread).  The entry point picks one of
//    the 27 instances per call from the pointers, strides and addresses.
//  - One thread per pair of elements: a vector operand is one 16-B double2
//    load, a strided one two 8-B loads, and out one 16-B store.  Timed in
//    turns on the H100, 4 or 8 elements per thread, a grid-stride loop
//    over a resident grid, loads that skip L1 or stream, and streaming
//    stores were each 0.5-7 % slower.
//  - If out lies 8 B off a 16-B boundary, element 0 is peeled so that the
//    rest is aligned.  The peeled element and an odd last one are computed
//    by the first block's first threads, so n = 1 takes only that path.
//
// __fma_rn is the IEEE fused operation in round-to-nearest-even, including
// inf, NaN and signed zeros, whatever the width of the loads; the product
// and sum are never spelled out, which nvcc would contract on its own.
//
// The entry point returns cudaGetLastError() after its launch; it never
// synchronises and never allocates.

#include <array>
#include <cstdint>
#include <utility>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

enum Kind : int { kVector = 0, kStrided = 1, kConstant = 2 };

struct Operand {
  const double* p;
  double v;
  int64_t s;
};

// Elements j and j + 1 of an operand; j + head is even for a vector one.
template <int K>
__device__ __forceinline__ double2 pair(const Operand& o, int64_t j) {
  if constexpr (K == kVector) {
    return *reinterpret_cast<const double2*>(o.p + j);
  } else if constexpr (K == kStrided) {
    const double* q = o.p + j * o.s;
    return make_double2(q[0], q[o.s]);
  } else {
    const double v = o.p == nullptr ? o.v : o.p[0];
    return make_double2(v, v);
  }
}

// Element j of an operand, for the scalar head and tail.
template <int K>
__device__ __forceinline__ double element(const Operand& o, int64_t j) {
  if constexpr (K == kVector) return o.p[j];
  if constexpr (K == kStrided) return o.p[j * o.s];
  return o.p == nullptr ? o.v : o.p[0];
}

// Thread q < pairs computes elements head + 2q and head + 2q + 1 (out +
// head is 16-B aligned, and so is every vector operand + head); the first
// block's first threads compute the at most two elements left, element 0
// when head is 1 and element n - 1 when n - head is odd.
template <int KA, int KB, int KC>
__global__ void __launch_bounds__(kThreads)
    fma_rn_kernel(Operand a, Operand b, Operand c, int64_t head,
                  int64_t pairs, int64_t n, double* __restrict__ out) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q < pairs) {
    const int64_t j = head + 2 * q;
    const double2 x = pair<KA>(a, j), y = pair<KB>(b, j), z = pair<KC>(c, j);
    *reinterpret_cast<double2*>(out + j) =
        make_double2(__fma_rn(x.x, y.x, z.x), __fma_rn(x.y, y.y, z.y));
  }
  if (blockIdx.x == 0) {
    const int64_t tail = head + 2 * pairs;
    const int t = threadIdx.x;
    if (t < head + (n - tail)) {
      const int64_t j = t < head ? t : tail + (t - head);
      out[j] = __fma_rn(element<KA>(a, j), element<KB>(b, j),
                        element<KC>(c, j));
    }
  }
}

using Launch = void (*)(const Operand&, const Operand&, const Operand&,
                        int64_t, int64_t, int64_t, double*, cudaStream_t);

template <int KA, int KB, int KC>
void launch(const Operand& a, const Operand& b, const Operand& c,
            int64_t head, int64_t pairs, int64_t n, double* out,
            cudaStream_t stream) {
  const int64_t blocks = pairs > 0 ? (pairs + kThreads - 1) / kThreads : 1;
  fma_rn_kernel<KA, KB, KC><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(a, b, c, head, pairs, n, out);
}

template <std::size_t... I>
constexpr std::array<Launch, sizeof...(I)> launches(
    std::index_sequence<I...>) {
  return {{&launch<static_cast<int>(I / 9), static_cast<int>(I / 3 % 3),
                   static_cast<int>(I % 3)>...}};
}

// Indexed by kind(a) * 9 + kind(b) * 3 + kind(c).
constexpr std::array<Launch, 27> kLaunch =
    launches(std::make_index_sequence<27>());

int kind(const void* p, int64_t s, std::uintptr_t align) {
  if (p == nullptr || s == 0) return kConstant;
  if (s == 1 && (reinterpret_cast<std::uintptr_t>(p) & 15) == align)
    return kVector;
  return kStrided;
}

}  // namespace

extern "C" int fma_rn(const void* a, double av, int64_t sa, const void* b,
                      double bv, int64_t sb, const void* c, double cv,
                      int64_t sc, int64_t n, void* out, void* stream) {
  if (n <= 0) return 0;
  const std::uintptr_t align = reinterpret_cast<std::uintptr_t>(out) & 15;
  const int64_t head = align != 0 ? 1 : 0;
  const Operand oa{static_cast<const double*>(a), av, sa};
  const Operand ob{static_cast<const double*>(b), bv, sb};
  const Operand oc{static_cast<const double*>(c), cv, sc};
  kLaunch[kind(a, sa, align) * 9 + kind(b, sb, align) * 3 +
          kind(c, sc, align)](oa, ob, oc, head, (n - head) / 2, n,
                              static_cast<double*>(out),
                              static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
