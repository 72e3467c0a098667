// Single-token decode attention over a KV cache, split over the cache's
// slots ("flash-decoding"), for Hopper (sm_90a).  Plain C interface, no
// PyTorch headers: the wrapper in kernels/decode_attn.py passes raw device
// pointers, the shapes and the current stream through ctypes.
//
// It replaces no Pallas kernel.  The reference's decode attention is a jnp
// graph (repro/models/layers.py:127, gqa_attend), which the port ran as
// torch's two einsums over the cache (models/layers.py, _gqa_attend).
// Those read the cache (B, T, K, hd) as a (b, k) batch whose strides do
// not flatten into one, so torch copied every layer's whole K and V, all T
// slots, to a contiguous layout at every step, then wrote and re-read
// float64 scores over all T slots, masked ones included.
//
// Bound on this card: bytes.  A step reads each valid K and V slot once,
// 2 * hd * 2 B per slot and KV head, for 4 * G * hd FLOPs: G FLOPs a byte,
// far below the H100's ~295 for bf16.  So the design reads each valid slot
// once, where it lies, and keeps everything else out of device memory:
//
//  - Grid (n_split, B * K).  A block takes one KV head of one row and one
//    contiguous range of slots, loads the G query rows of that head once,
//    and streams the range's K and V rows through a ring of kStages tiles
//    in shared memory with cp.async (16-B copies, a row's 16-B chunks on
//    neighbouring threads; rows padded by 16 B so that a warp's reads of
//    one chunk of eight rows hit eight different bank groups).  Every query
//    head of the group uses each tile.
//  - The valid slots [lo, hi) come from pos in device memory: hi =
//    min(pos + 1, T), lo = max(0, pos - window + 1) on a local layer and 0
//    otherwise.  A block whose range lies outside them returns at once, so
//    the grid depends only on shapes and the host never reads pos.  Masked
//    slots are never read: the plain path gave them exp(-1e30 - max),
//    which is exactly 0.  A window left empty (a local layer far past the
//    cache's end) masks every slot, where the plain path's softmax is
//    uniform over all T slots: the kernel then gives every slot the plain
//    path's score of -1e30.
//  - n_split is the wrapper's, from B * K and T alone, so that the live
//    blocks fill the 132 SMs many times over: 32 splits at B * K = 128 and
//    T = 32,768, 4 at B * K = 1,024 and T = 4,096.
//  - Arithmetic, no less precise than the einsums: q . k in float32 and
//    not rounded to the cache's type; each score widened to float64 and
//    divided by sqrt(hd) in float64; the running max, the exponentials and
//    the running sum in float64 (an online softmax, one rescale a tile);
//    P . V in float32 with each probability rounded once to float32.  Each
//    block writes its partial (max, sum in float64, unnormalised output in
//    float32); a combine pass, one block per (row, query head), merges the
//    live splits in float64 and rounds the output once to the cache's type.
//  - The work a slot needs is small enough for CUDA cores: G * hd FMAs for
//    the scores and G * hd for P . V against 4 * hd bytes, with the group
//    size G a template parameter so that every loop over it unrolls.
//
// Instances: the (element type, hd, G) triples of the registry's full-size
// configurations, listed at the end (the wrapper's INSTANCES must match,
// which a CPU test checks).  decode_attn_setup allows an instance its
// shared memory, once per device; decode_attn takes one struct of
// arguments, so that the launch costs the host little, and returns
// cudaGetLastError() after its two launches, or -1 where no instance
// matches.  Neither synchronises or allocates.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

// One call's arguments, filled by the wrapper (kernels/decode_attn.py,
// _Params): part_ml (B * H, n_split, 2) float64 scratch (max, sum),
// part_acc (B * H, n_split, hd) float32 scratch, out (B, 1, H, hd) in the
// cache's type; dtype 0 bfloat16 (the only type instanced); window the
// sliding window of a local layer, 0 for a global one.
struct Params {
  const void* q;
  const void* ck;
  const void* cv;
  const void* pos;
  void* part_ml;
  void* part_acc;
  void* out;
  double sqrt_hd;
  int batch, nslots, kv_heads, group, hd, dtype, window, n_split, chunk;
};

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;
constexpr int kChunks = 8;   // per-warp partials a query head keeps a tile
// the plain path's masked score: float32 -1e30, widened
constexpr double kNeg = static_cast<double>(-1e30f);

template <int HD, int G>
struct Shape {
  static constexpr int TS = HD <= 128 ? 64 : 32;  // slots a tile
  static constexpr int ROW = HD + 8;              // a tile's row, elements
  static constexpr int CH = HD / 8;               // 16-B chunks a row
  static constexpr int P = G * TS;                // (head, slot) scores a tile
  // lanes that share one score's dot product: more than one where a tile
  // has fewer scores than the block has threads
  static constexpr int LP = P >= kThreads ? 1 : (2 * P <= kThreads / 2 ? 4 : 2);
  static constexpr int DP = HD / 2;               // element pairs a row
  static constexpr int SPL = kThreads / DP;       // slot groups in P . V
  static constexpr size_t TILES = size_t(kStages) * 2 * TS * ROW;
  static_assert(HD % 8 == 0 && SPL >= 1, "hd");
  static_assert(TS % 32 == 0 && TS * LP / 32 <= kChunks && CH % LP == 0,
                "tile");
};

template <typename E>
__device__ __forceinline__ float2 pair_to_float2(uint32_t w);
template <>
__device__ __forceinline__ float2 pair_to_float2<__nv_bfloat16>(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename E>
__device__ __forceinline__ E from_double(double x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_double<__nv_bfloat16>(double x) {
  return __double2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The slots that the mask admits, [lo, hi), from pos in device memory.
struct Window {
  long long lo, hi;
  bool uniform;   // the mask admits none: every slot at the masked score
};

__device__ __forceinline__ Window window_of(const int* pos, long long nslots,
                                            int window) {
  const long long p = *pos;
  Window w{window > 0 ? max(0LL, p - window + 1) : 0LL, min(p + 1, nslots),
           false};
  if (w.lo >= w.hi) {
    w.lo = 0;
    w.hi = nslots;
    w.uniform = true;
  }
  return w;
}

template <typename E, int HD, int G>
size_t split_smem_bytes() {
  using S = Shape<HD, G>;
  return S::TILES * sizeof(E) + size_t(G) * HD * sizeof(float) +
         size_t(S::P) * (sizeof(double) + sizeof(float)) +
         size_t(G) * (2 * kChunks + 4) * sizeof(double);
}

template <typename E, int HD, int G>
__global__ void __launch_bounds__(kThreads)
decode_attn_split(const E* __restrict__ q, const E* __restrict__ ck,
                  const E* __restrict__ cv, const int* __restrict__ pos,
                  int nslots, int kv_heads, int window, double sqrt_hd,
                  int n_split, int chunk, double* __restrict__ part_ml,
                  float* __restrict__ part_acc) {
  using S = Shape<HD, G>;
  constexpr int TS = S::TS, ROW = S::ROW, CH = S::CH, P = S::P, LP = S::LP;
  constexpr int DP = S::DP, SPL = S::SPL, PW = 32 / LP;
  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  const int b = blockIdx.y / kv_heads, k = blockIdx.y % kv_heads;
  const Window w = window_of(pos, nslots, window);
  const long long first = static_cast<long long>(split) * chunk;
  const long long a = max(first, w.lo);
  const long long end = min(first + chunk, w.hi);
  if (a >= end) return;
  const int ntiles = static_cast<int>((end - a + TS - 1) / TS);

  extern __shared__ __align__(16) unsigned char smem[];
  E* tiles = reinterpret_cast<E*>(smem);          // [kStages][K, V][TS][ROW]
  float* qs = reinterpret_cast<float*>(smem + S::TILES * sizeof(E));  // [G][HD]
  double* ss = reinterpret_cast<double*>(qs + G * HD);   // scores [G][TS]
  float* ps = reinterpret_cast<float*>(ss + P);          // exp(s - m) [G][TS]
  double* wmax = reinterpret_cast<double*>(ps + P);      // [G][kChunks]
  double* wsum = wmax + G * kChunks;                     // [G][kChunks]
  double* mrun = wsum + G * kChunks;                     // running max [G]
  double* lrun = mrun + G;                               // running sum [G]
  double* mnew = lrun + G;                               // this tile's max [G]
  double* corr = mnew + G;                               // exp(m_old - m_new)

  const long long head0 = static_cast<long long>(b) * kv_heads * G +
                          static_cast<long long>(k) * G;   // first query head
  for (int e = tid; e < G * HD; e += kThreads) qs[e] = to_float(q[head0 * HD + e]);
  if (tid < G) {
    mrun[tid] = -CUDART_INF;
    lrun[tid] = 0.0;
  }

  const long long row0 = static_cast<long long>(b) * nslots;
  auto load_tile = [&](int it) {
    E* dk = tiles + (it % kStages) * 2 * TS * ROW;
    E* dv = dk + TS * ROW;
    const long long t0 = a + static_cast<long long>(it) * TS;
#pragma unroll 4
    for (int e = tid; e < TS * CH; e += kThreads) {
      const int r = e / CH, c = e - r * CH;
      const long long slot = t0 + r;
      const bool in = slot < end;
      const long long off =
          in ? ((row0 + slot) * kv_heads + k) * HD + c * 8 : 0;
      cp_async16(dk + r * ROW + c * 8, ck + off, in ? 16 : 0);
      cp_async16(dv + r * ROW + c * 8, cv + off, in ? 16 : 0);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_tile(s);
    cp_async_commit();
  }

  // P . V: thread (sg, dp) owns element pair dp of every query head, over
  // the tile's slots sg, sg + SPL, ...
  const int dp = tid % DP, sg = tid / DP;
  const bool pv = tid < SPL * DP;
  float acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < ntiles) load_tile(it + kStages - 1);
    cp_async_commit();
    const E* tk = tiles + (it % kStages) * 2 * TS * ROW;
    const E* tv = tk + TS * ROW;
    const long long t0 = a + static_cast<long long>(it) * TS;

    // scores: LP lanes per (head, slot), 32 / LP apart, so that the eight
    // lanes of each quarter warp read eight different rows; a warp's
    // scores all belong to one head, so its max is one entry of wmax
#pragma unroll
    for (int base = 0; base < P; base += kThreads / LP) {
      const int i = base + (tid / 32) * PW + (tid & 31) % PW;
      if (base + (tid / 32) * PW < P) {  // uniform over each warp
        const int j = (tid & 31) / PW;
        const int g = i / TS, t = i - g * TS;
        const E* kr = tk + t * ROW;
        const float* qr = qs + g * HD;
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int cc = 0; cc < CH / LP; ++cc) {
          const int c = cc * LP + j;
          const uint4 raw = *reinterpret_cast<const uint4*>(kr + c * 8);
          const float4 qa = *reinterpret_cast<const float4*>(qr + c * 8);
          const float4 qb = *reinterpret_cast<const float4*>(qr + c * 8 + 4);
          const float2 k0 = pair_to_float2<E>(raw.x);
          const float2 k1 = pair_to_float2<E>(raw.y);
          const float2 k2 = pair_to_float2<E>(raw.z);
          const float2 k3 = pair_to_float2<E>(raw.w);
          d0 = fmaf(qa.x, k0.x, d0);
          d1 = fmaf(qa.y, k0.y, d1);
          d0 = fmaf(qa.z, k1.x, d0);
          d1 = fmaf(qa.w, k1.y, d1);
          d0 = fmaf(qb.x, k2.x, d0);
          d1 = fmaf(qb.y, k2.y, d1);
          d0 = fmaf(qb.z, k3.x, d0);
          d1 = fmaf(qb.w, k3.y, d1);
        }
        float dot = d0 + d1;
#pragma unroll
        for (int o = 16; o >= PW; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        double sd = w.uniform ? kNeg : static_cast<double>(dot) / sqrt_hd;
        if (t0 + t >= end) sd = -CUDART_INF;
        if (j == 0) ss[i] = sd;
        double mx = sd;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        if ((tid & 31) == 0) wmax[g * kChunks + t / PW] = mx;
      }
    }
    __syncthreads();

    // the tile's max per head, exp(s - m_new) in float64, and its sum
#pragma unroll
    for (int i0 = 0; i0 < P; i0 += kThreads) {
      const int i = i0 + tid;
      if (i < P) {                       // uniform over each warp
        const int g = i / TS, t = i - g * TS;
        double tm = wmax[g * kChunks];
#pragma unroll
        for (int c = 1; c < TS * LP / 32; ++c)
          tm = fmax(tm, wmax[g * kChunks + c]);
        const double mo = mrun[g];
        const double mn = fmax(mo, tm);
        const double p = exp(ss[i] - mn);
        ps[i] = static_cast<float>(p);
        double sum = p;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if ((tid & 31) == 0) wsum[g * kChunks + t / 32] = sum;
        if (t == 0) {
          mnew[g] = mn;
          corr[g] = exp(mo - mn);
        }
      }
    }
    __syncthreads();

    if (tid < G) {
      double sum = 0.0;
#pragma unroll
      for (int c = 0; c < TS / 32; ++c) sum += wsum[tid * kChunks + c];
      lrun[tid] = lrun[tid] * corr[tid] + sum;
      mrun[tid] = mnew[tid];
    }
    if (pv) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float c = static_cast<float>(corr[g]);
        acc[g][0] *= c;
        acc[g][1] *= c;
      }
#pragma unroll 4
      for (int t = sg; t < TS; t += SPL) {
        const float2 v = pair_to_float2<E>(
            *reinterpret_cast<const uint32_t*>(tv + t * ROW + 2 * dp));
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = ps[g * TS + t];
          acc[g][0] = fmaf(p, v.x, acc[g][0]);
          acc[g][1] = fmaf(p, v.y, acc[g][1]);
        }
      }
    }
  }

  // the slot groups' sums through shared memory, then the partials
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);   // [SPL][G][HD]
  if (pv) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      red[(sg * G + g) * HD + 2 * dp] = acc[g][0];
      red[(sg * G + g) * HD + 2 * dp + 1] = acc[g][1];
    }
  }
  __syncthreads();
  for (int e = tid; e < G * HD; e += kThreads) {
    float s = red[e];
#pragma unroll
    for (int r = 1; r < SPL; ++r) s += red[r * G * HD + e];
    const int g = e / HD;
    part_acc[((head0 + g) * n_split + split) * HD + (e - g * HD)] = s;
  }
  if (tid < G) {
    double* ml = part_ml + ((head0 + tid) * n_split + split) * 2;
    ml[0] = mrun[tid];
    ml[1] = lrun[tid];
  }
}

// max (is_max) or sum of v over the block, the same value in every thread
__device__ double block_reduce(double v, bool is_max, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double u = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmax(v, u) : v + u;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  double r = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) r = is_max ? fmax(r, red[i]) : r + red[i];
  __syncthreads();
  return r;
}

// One block per (row, query head): the live splits' partials merged in
// float64, the output rounded once to the cache's type.
template <typename E, int HD>
__global__ void __launch_bounds__(kThreads)
decode_attn_combine(const int* __restrict__ pos, int nslots, int window,
                    int n_split, int chunk,
                    const double* __restrict__ part_ml,
                    const float* __restrict__ part_acc, E* __restrict__ out) {
  extern __shared__ double weights[];   // [live splits]
  __shared__ double red[kWarps];
  const long long head = blockIdx.x;
  const Window w = window_of(pos, nslots, window);
  const int s_lo = static_cast<int>(w.lo / chunk);
  const int s_hi = static_cast<int>((w.hi - 1) / chunk);
  const double* ml = part_ml + head * n_split * 2;
  double m = -CUDART_INF;
  for (int s = s_lo + threadIdx.x; s <= s_hi; s += kThreads)
    m = fmax(m, ml[2 * s]);
  m = block_reduce(m, true, red);
  double l = 0.0;
  for (int s = s_lo + threadIdx.x; s <= s_hi; s += kThreads) {
    const double ws = exp(ml[2 * s] - m);
    weights[s - s_lo] = ws;
    l += ml[2 * s + 1] * ws;
  }
  l = block_reduce(l, false, red);       // its barrier publishes weights
  const float* acc = part_acc + head * n_split * HD;
  for (int d = threadIdx.x; d < HD; d += kThreads) {
    double o = 0.0;
    for (int s = s_lo; s <= s_hi; ++s)
      o += weights[s - s_lo] * static_cast<double>(acc[s * HD + d]);
    out[head * HD + d] = from_double<E>(o / l);
  }
}

template <typename E, int HD, int G>
int setup() {
  return static_cast<int>(cudaFuncSetAttribute(
      decode_attn_split<E, HD, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(split_smem_bytes<E, HD, G>())));
}

template <typename E, int HD, int G>
int launch(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.n_split, p.batch * p.kv_heads);
  decode_attn_split<E, HD, G>
      <<<grid, kThreads, split_smem_bytes<E, HD, G>(), stream>>>(
          static_cast<const E*>(p.q), static_cast<const E*>(p.ck),
          static_cast<const E*>(p.cv), static_cast<const int*>(p.pos),
          p.nslots, p.kv_heads, p.window, p.sqrt_hd, p.n_split, p.chunk,
          static_cast<double*>(p.part_ml), static_cast<float*>(p.part_acc));
  decode_attn_combine<E, HD>
      <<<p.batch * p.kv_heads * G, kThreads, p.n_split * sizeof(double),
         stream>>>(static_cast<const int*>(p.pos), p.nslots, p.window,
                   p.n_split, p.chunk, static_cast<const double*>(p.part_ml),
                   static_cast<const float*>(p.part_acc),
                   static_cast<E*>(p.out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define DECODE_ATTN_INSTANCES(X)   \
  X(__nv_bfloat16, 0, 64, 1)       \
  X(__nv_bfloat16, 0, 80, 1)       \
  X(__nv_bfloat16, 0, 96, 1)       \
  X(__nv_bfloat16, 0, 128, 1)      \
  X(__nv_bfloat16, 0, 128, 2)      \
  X(__nv_bfloat16, 0, 128, 5)      \
  X(__nv_bfloat16, 0, 128, 16)     \
  X(__nv_bfloat16, 0, 256, 4)

// Allows an instance its shared memory on the current device: once per
// device and instance, before its first launch there.  -1 where no
// instance matches.
extern "C" int decode_attn_setup(int dtype, int hd, int group) {
#define DECODE_ATTN_SETUP(E, CODE, HD, G) \
  if (dtype == CODE && hd == HD && group == G) return setup<E, HD, G>();
  DECODE_ATTN_INSTANCES(DECODE_ATTN_SETUP)
#undef DECODE_ATTN_SETUP
  return -1;
}

// Enqueues the kernel and its combine pass on the stream.
extern "C" int decode_attn(const Params* p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DECODE_ATTN_LAUNCH(E, CODE, HD, G)                      \
  if (p->dtype == CODE && p->hd == HD && p->group == G) \
    return launch<E, HD, G>(*p, s);
  DECODE_ATTN_INSTANCES(DECODE_ATTN_LAUNCH)
#undef DECODE_ATTN_LAUNCH
  return -1;
}
