// K2: flash-attention forward (online softmax over KV tiles).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py
// flash_attention_fwd (body _flash_fwd_kernel).  Same function: the logits
// are scaled in float32, the tanh softcap comes before the masks, the
// masks are causal, sliding window and k_pos < Tk, a masked logit is
// NEG_INF = -1e30 (not -inf: exp(-inf - -inf) is NaN), the state
// m / l / acc is float32, and the output is acc / max(l, 1e-30) in q's
// dtype.  On request (a non-null lse pointer) both variants also write
// the float32 log-sum-exp of each query row, laid out (B, H, Tq): the
// natural log of the sum of exp over the scaled, capped, masked logits,
// m + log(max(l, 1e-30)) as the reference's _fa_forward keeps it for the
// backward pass (src/repro/models/layers.py:129-155).  A null pointer
// writes nothing: the prefill's launches are the same as before.
//
// Bound on Hopper: at the zamba2-7b prefill shape (B 1, T 4096, 32 heads,
// Dh 112, bf16, causal) one call does about 1.2e11 operations (half of
// 4*T^2*Dh*H) and moves 117 MB (q, k, v, o once each).  At an H100 SXM's
// data-sheet rates (700 W: 989 TFLOP/s bf16 on the tensor cores, 3.35
// TB/s) that is 0.12 ms against 0.035 ms for the bytes, so the work
// bounds it, and only the tensor cores come near it.
//
// Two variants.  The wrapper (kernels/flash_attention.py) picks one by
// dtype and head width alone, never by a failure:
//
// * flash_attention_fwd_tc, the tensor-core kernel, for bf16 q / k / v
//   with Dh a multiple of 16 in 16..128.  TMA reads its operands, so their
//   bases and (B, T, head) strides must be positive multiples of 16
//   bytes; the wrapper raises on any other layout.
// * flash_attention_fwd, the SIMT kernel, for float32 and for the other
//   head widths (Dh 256, Dh not a multiple of 16).
//
// Tensor-core design (FlashAttention-3 style, sm_90a).  One block per
// (head, batch, 128-query tile), the heaviest causal tiles of all heads
// launched first (grid z runs backwards over the query tiles).  Warp 8 is
// the producer: one lane loads the Q tile once and keeps TMA loads of the
// K and V tiles (128 keys each) in flight in a three-stage ring, with a
// full and an empty mbarrier per stage and operand, so the next K tile
// can land while the current V tile is still read.  Warps 0-7 are two
// consumer warpgroups of 64 query rows each.  Per key tile a warpgroup
// runs S = Q K^T as wgmma m64n128k16 (bf16 operands from shared memory,
// float32 accumulators, Dh / 16 steps of depth 16), then the online
// softmax on the accumulator registers: the scale times log2(e) is folded
// into one multiply so that exp is one ex2; the softcap and the masks are
// applied there, the masks only on tiles that cross Tk, the diagonal or
// the window edge; wholly masked tiles are never loaded.  P is rounded to
// bf16 in registers, where the accumulator layout of the first product is
// already the A-fragment layout of the second, and O += P V runs as wgmma
// m64n64k16 with A from registers and V from shared memory (MN-major B).
// The reference's float32 einsum ran at the TPU's default matmul
// precision, one bf16 pass, so bf16 P against float32 accumulation is what
// it computed there.  Dh 112 bf16 is 224 bytes a row, wider than the
// 128-byte swizzle span: every tile is loaded as boxes of 64 columns
// (128-byte swizzle) and the tensor map's inner extent is Dh, so TMA fills
// the columns past Dh with zeros: the pad to 128 lives in the tile, never
// in memory.  S skips those columns (Dh / 16 steps); P V runs 64 columns
// per box and the epilogue drops the padded ones.  Rows past Tq or Tk are
// zero-filled the same way; the output store is masked.  The tensor maps
// are encoded on the host per call over the 4-d (Dh, heads, T, B) view
// with the strides as given, with cuTensorMapEncodeTiled looked up
// through the CUDA runtime (no -lcuda), and passed as __grid_constant__
// parameters.  Every mbarrier wait traps after 4 s of wall time, so a
// transaction that never arrives faults the launch instead of hanging the
// card.
//
// SIMT design: the TPU walks the KV blocks as a sequential grid axis and
// keeps m / l / acc in VMEM between steps.  Blocks here run in no order, so
// each block owns one (batch, head, 64-query tile) and walks the KV tiles
// itself, in a loop, with the state in registers.  256 threads as 16 x 16:
// thread (ty, tx) computes the 4 x 4 logits of query rows ty*4.. and key
// columns tx*4.. from float4 reads of the transposed Q and K tiles in
// shared memory (q scaled first); a row's max and sum are folded over its
// 16 threads with shuffles; P goes back to shared memory (transposed) and
// each thread adds P·V into its 4 rows x NJ columns (columns tx + 16 j, so
// any Dh up to 256 is covered: Dh 112 is 7 columns per thread, with no
// power-of-two assumption; columns past Dh are zero padding in shared
// memory).
//
// Both variants skip tiles wholly above the diagonal or wholly before the
// window: for a row that has a legal key, a wholly masked tile's weight is
// exactly 0 once a legal tile has been seen, so skipping it is exact.
// Both read the (B, T, H, Dh) strides themselves (head h reads kv head
// h / (H / KV)), so the wrapper makes no transposed or repeated copy.
// They allocate nothing and never synchronise; the C entry points return
// cudaGetLastError().

#include <cuda.h>  // CUtensorMap and its enums only: nothing links -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kPad = 4;          // keeps float4 alignment, spreads banks
constexpr int kSQ = kBQ + kPad;  // row stride of Qt and Pt
constexpr int kSK = kBK + kPad;  // row stride of Kt
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, Tq), or null
  int B, Tq, Tk, H, KV, Dh;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh;
  float scale;
  int causal;
  int window;  // 1 << 30 for none
  int has_cap;
  float cap;
};

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Dh = p.Dh;
  constexpr int VS = NJ * 16;           // row stride of Vs (>= Dh)
  float* Qt = smem;                     // [Dh][kSQ]  q * scale, transposed
  float* Kt = Qt + Dh * kSQ;            // [Dh][kSK]  k tile, transposed
  float* Vs = Kt + Dh * kSK;            // [kBK][VS]  v tile, zero padded
  float* Pt = Vs + kBK * VS;            // [kBK][kSQ] probabilities, transposed

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  // the heaviest causal tiles (late queries) start first
  const int qtile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q0 = qtile * kBQ;

  const T* q = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* k = static_cast<const T*>(p.k) + b * p.skb + kvh * p.skh;
  const T* v = static_cast<const T*>(p.v) + b * p.svb + kvh * p.svh;

  for (int e = tid; e < kBQ * Dh; e += kThreads) {
    const int r = e / Dh, d = e - r * Dh;
    const int t = q0 + r;
    Qt[d * kSQ + r] = t < p.Tq ? to_f(q[t * p.sqt + d]) * p.scale : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // keys past the block's last query row are never legal (causal); keys at
  // or before q0 - window are illegal for every row of the block
  const int k_hi = p.causal ? min(p.Tk, q0 + kBQ) : p.Tk;
  const int k_lo = max(0, q0 - p.window + 1);
  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * VS; e += kThreads) {
      const int u = e / VS, d = e - u * VS;
      const int t = k0 + u;
      const bool ok = t < p.Tk && d < Dh;
      Vs[u * VS + d] = ok ? to_f(v[t * p.svt + d]) : 0.f;
      if (d < Dh) Kt[d * kSK + u] = ok ? to_f(k[t * p.skt + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < Dh; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * kSQ + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Kt[d * kSK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        float x = s[i][j];
        if (p.has_cap) x = p.cap * tanhf(x / p.cap);
        const bool ok = kpos < p.Tk && (!p.causal || kpos <= qpos) &&
                        kpos > qpos - p.window;
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * kSQ + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    for (int u = 0; u < kBK; ++u) {
      const float4 a = *reinterpret_cast<const float4*>(&Pt[u * kSQ + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float c = Vs[u * VS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(av[i], c, acc[i][j]);
      }
    }
  }

  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= p.Tq) continue;
    // every thread of the row holds its m and l (the folds above)
    if (p.lse != nullptr && tx == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Tq + t] =
          m[i] + logf(fmaxf(l[i], 1e-30f));
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * p.Tq + t) * p.H + h) * Dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < Dh) orow[c] = from_f<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int NJ>
int launch(const Params& p, cudaStream_t stream) {
  const size_t floats = static_cast<size_t>(p.Dh) * (kSQ + kSK) +
                        static_cast<size_t>(kBK) * (NJ * 16 + kSQ);
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Tq + kBQ - 1) / kBQ, p.H, p.B);
  flash_fwd_kernel<T, NJ><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// columns per thread: the smallest instantiated NJ with 16 * NJ >= Dh
template <typename T>
int dispatch(const Params& p, cudaStream_t stream) {
  const int nj = (p.Dh + 15) / 16;
  if (nj <= 2) return launch<T, 2>(p, stream);
  if (nj <= 4) return launch<T, 4>(p, stream);
  if (nj <= 6) return launch<T, 6>(p, stream);
  if (nj <= 7) return launch<T, 7>(p, stream);
  if (nj <= 8) return launch<T, 8>(p, stream);
  if (nj <= 12) return launch<T, 12>(p, stream);
  if (nj <= 16) return launch<T, 16>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}


// ---------------------------------------------------------------------------
// Tensor-core variant (bf16, Dh a multiple of 16 in 16..128)

namespace tc {

#include "hopper.cuh"

constexpr int kBQ = 128;                   // query rows per block
constexpr int kBK = 128;                   // keys per tile
constexpr int kStages = 3;                 // depth of the K / V ring
constexpr int kConsumers = 256;            // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr float kLn2 = 0.6931471805599453f;

// NB boxes of 64 columns cover Dh; Q, and each stage of K and of V, is
// NB boxes of [rows][64] bf16 with the 128-byte swizzle, 1024-aligned
template <int NB>
struct Layout {
  static constexpr int kQBytes = NB * kBQ * kRowBytes;
  static constexpr int kTileBytes = NB * kBK * kRowBytes;
  static constexpr int kBarBytes = 8 * (1 + 4 * kStages);
  static constexpr int kBytes =
      1024 + kQBytes + 2 * kStages * kTileBytes + kBarBytes;
};
static_assert(Layout<2>::kBytes <= 232448, "shared memory of one block");

struct Params {
  void* o;
  float* lse;  // (B, H, Tq), or null
  int Tq, Tk, H, KV, Dh;
  float scale;
  int causal;
  int window;  // 1 << 30 for none
  int has_cap;
  float cap;
};

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// S (64 x 128 keys) += Q (64 x 16, shared) K^T (16 x 128, shared), both
// K-major; accumulate = 0 overwrites
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O (64 x 64) += P (64 x 16, registers) V (16 keys x 64, shared, MN-major
// B: the 64 columns are the contiguous axis)
__device__ __forceinline__ void wgmma_pv(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// DSTEPS = Dh / 16 product steps of depth 16; NB = ceil(DSTEPS / 4) boxes
template <int DSTEPS>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel_tc(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const Params p) {
  constexpr int NB = (DSTEPS + 3) / 4;
  using L = Layout<NB>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + L::kQBytes;  // stage s at + s * kTileBytes
  const uint32_t sv = sk + kStages * L::kTileBytes;
  const uint32_t bars = sv + kStages * L::kTileBytes;
  const uint32_t q_full = bars;
  // k_full(s), v_full(s): the stage's K or V tile landed; k_empty(s),
  // v_empty(s): both consumer warpgroups are done with it (K after S =
  // Q K^T, V after O += P V)
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto k_empty = [&](int s) { return bars + 8u * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8u * (1 + 3 * kStages + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heaviest first
  const int kvh = h / (p.H / p.KV);
  // keys past the block's last row are never legal (causal); keys at or
  // before q0 - window are illegal for every row of the block
  const int k_hi = p.causal ? min(p.Tk, q0 + kBQ) : p.Tk;
  const int k_lo = max(0, q0 - p.window + 1);
  const int first = k_lo / kBK;
  const int ntiles = max(0, (k_hi + kBK - 1) / kBK - first);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumers);
      mbar_init(v_empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        tma_load(sq + nb * kBQ * kRowBytes, &tm_q, q_full, nb * kBoxCols, h,
                 q0, b);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kStages;
        const uint32_t free_parity = ((j / kStages) & 1) ^ 1;
        const int k0 = (first + j) * kBK;
        const uint32_t tile = s * L::kTileBytes;
        mbar_wait(k_empty(s), free_parity);
        mbar_expect_tx(k_full(s), L::kTileBytes);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          tma_load(sk + tile + nb * kBK * kRowBytes, &tm_k, k_full(s),
                   nb * kBoxCols, kvh, k0, b);
        mbar_wait(v_empty(s), free_parity);
        mbar_expect_tx(v_full(s), L::kTileBytes);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          tma_load(sv + tile + nb * kBK * kRowBytes, &tm_v, v_full(s),
                   nb * kBoxCols, kvh, k0, b);
      }
    }
    return;
  }

  // a consumer: warpgroup wg owns query rows r0 .. r0 + 63; this thread
  // holds rows row_a and row_b = row_a + 8 of the accumulator fragments
  const int wg = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = q0 + 64 * wg;
  const int row_a = r0 + 16 * (warp & 3) + g, row_b = row_a + 8;
  const float scale2 = p.scale * kLog2e;  // logits in log2 units
  float o[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[nb][i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  mbar_wait(q_full, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % kStages;
    const uint32_t phase = (j / kStages) & 1;
    const int k0 = (first + j) * kBK;
    const uint32_t tile = s * L::kTileBytes;

    float sc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    mbar_wait(k_full(s), phase);
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DSTEPS; ++kk) {
      const uint32_t col = (kk & 3) * 32;  // 16 bf16 inside the box row
      const uint32_t box = kk >> 2;
      wgmma_qk(sc,
               sw128_desc(sq + box * kBQ * kRowBytes + wg * 64 * kRowBytes +
                              col, 16),
               sw128_desc(sk + tile + box * kBK * kRowBytes + col, 16),
               kk > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(sc);
    mbar_arrive(k_empty(s));

    // sc[4 jn + e]: row (e < 2 ? row_a : row_b), key k0 + 8 jn + 2 t4 +
    // (e & 1).  Masks only where the tile crosses Tk, the diagonal or the
    // window edge for some row of this warpgroup.
    const bool edge = k0 + kBK > p.Tk || (p.causal && k0 + kBK - 1 > r0) ||
                      k0 <= r0 + 63 - p.window;
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float x = sc[i];
      if (p.has_cap)
        x = p.cap * tanhf(x * p.scale / p.cap) * kLog2e;
      else
        x *= scale2;
      if (edge) {
        const int kpos = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int qpos = (i & 2) ? row_b : row_a;
        const bool ok = kpos < p.Tk && (!p.causal || kpos <= qpos) &&
                        kpos > qpos - p.window;
        if (!ok) x = kNegInf;
      }
      sc[i] = x;
      if (i & 2)
        mx_b = fmaxf(mx_b, x);
      else
        mx_a = fmaxf(mx_a, x);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the row's four threads
      mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = ex2(m_a - mn_a), al_b = ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    // P in bf16: pk[2 i' + f] packs sc[4 i' + 2 f], sc[4 i' + 2 f + 1], so
    // pk[4 kk .. 4 kk + 3] is the A fragment of key step kk (keys
    // 16 kk .. 16 kk + 15)
    uint32_t pk[32];
    float s_a = 0.f, s_b = 0.f;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const float mrow = (i & 2) ? mn_b : mn_a;
      const float e0 = ex2(sc[i] - mrow), e1 = ex2(sc[i + 1] - mrow);
      if (i & 2)
        s_b += e0 + e1;
      else
        s_a += e0 + e1;
      pk[i >> 1] = pack_bf16(e0, e1);
    }
    l_a = l_a * al_a + s_a;  // this thread's share of the row sum
    l_b = l_b * al_b + s_b;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[nb][i] *= (i & 2) ? al_b : al_a;

    mbar_wait(v_full(s), phase);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(o[nb]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2],
                             pk[4 * kk + 3]};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        wgmma_pv(o[nb], a,
                 sw128_desc(sv + tile + nb * kBK * kRowBytes +
                                kk * 16 * kRowBytes, 1024));
    }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(o[nb]);
    mbar_arrive(v_empty(s));
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(kFull, l_a, off);
    l_b += __shfl_xor_sync(kFull, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  // m is in log2 units (scale2): the natural log-sum-exp is m ln 2 + ln l.
  // The row's four threads hold the same m and, after the folds above, l.
  if (p.lse != nullptr && t4 == 0) {
    float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Tq;
    if (row_a < p.Tq) lse[row_a] = m_a * kLn2 + logf(fmaxf(l_a, 1e-30f));
    if (row_b < p.Tq) lse[row_b] = m_b * kLn2 + logf(fmaxf(l_b, 1e-30f));
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o);
  const long long orow_a =
      ((static_cast<long long>(b) * p.Tq + row_a) * p.H + h) * p.Dh;
  const long long orow_b =
      ((static_cast<long long>(b) * p.Tq + row_b) * p.H + h) * p.Dh;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const int col = nb * kBoxCols + 8 * jn + 2 * t4;
      if (col >= p.Dh) continue;  // the zero padding past Dh
      if (row_a < p.Tq)
        *reinterpret_cast<uint32_t*>(out + orow_a + col) = pack_bf16(
            o[nb][4 * jn] * inv_a, o[nb][4 * jn + 1] * inv_a);
      if (row_b < p.Tq)
        *reinterpret_cast<uint32_t*>(out + orow_b + col) = pack_bf16(
            o[nb][4 * jn + 2] * inv_b, o[nb][4 * jn + 3] * inv_b);
    }
}

template <int DSTEPS>
int launch(const CUtensorMap& mq, const CUtensorMap& mk,
           const CUtensorMap& mv, const Params& p, int B,
           cudaStream_t stream) {
  constexpr int bytes = Layout<(DSTEPS + 3) / 4>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel_tc<DSTEPS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.H, B, (p.Tq + kBQ - 1) / kBQ);
  flash_fwd_kernel_tc<DSTEPS><<<grid, kThreads, bytes, stream>>>(mq, mk, mv,
                                                                 p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  q (B, Tq, H, Dh) and k / v (B, Tk, KV,
// Dh) with the given strides and unit stride over Dh; o (B, Tq, H, Dh)
// contiguous; lse (B, H, Tq) float32 contiguous, or null for none.
// window is 1 << 30 for none; cap is read when has_cap.
int flash_attention_fwd(int dtype, const void* q, const void* k,
                        const void* v, void* o, float* lse, int B, int Tq,
                        int Tk, int H, int KV, int Dh, long long sqb,
                        long long sqt, long long sqh, long long skb,
                        long long skt, long long skh, long long svb,
                        long long svt, long long svh, float scale,
                        int causal, int window, int has_cap, float cap,
                        void* stream) {
  if (B <= 0 || Tq <= 0) return 0;
  const Params p{q,   k,   v,   o,   lse,   B,      Tq,     Tk,      H,
                 KV,  Dh,  sqb, sqt, sqh,   skb,    skt,    skh,     svb,
                 svt, svh, scale, causal, window, has_cap, cap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core variant, with flash_attention_fwd's arguments: dtype 1
// (bfloat16) only, Dh a multiple of 16 in 16..128, bases and strides
// positive multiples of 16 bytes (the wrapper checks all of it first).
// Returns cudaErrorInvalidValue for a call outside that rule and
// cudaErrorNotSupported if a tensor map cannot be encoded.
int flash_attention_fwd_tc(int dtype, const void* q, const void* k,
                           const void* v, void* o, float* lse, int B,
                           int Tq, int Tk, int H, int KV, int Dh,
                           long long sqb, long long sqt, long long sqh,
                           long long skb, long long skt, long long skh,
                           long long svb, long long svt, long long svh,
                           float scale, int causal, int window,
                           int has_cap, float cap, void* stream) {
  if (B <= 0 || Tq <= 0) return 0;
  if (dtype != 1 || Dh < 16 || Dh > 128 || Dh % 16 || KV < 1 || H % KV ||
      Tk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  if (!tc::encode(&mq, q, Dh, H, Tq, B, sqh, sqt, sqb, tc::kBQ) ||
      !tc::encode(&mk, k, Dh, KV, Tk, B, skh, skt, skb, tc::kBK) ||
      !tc::encode(&mv, v, Dh, KV, Tk, B, svh, svt, svb, tc::kBK))
    return static_cast<int>(cudaErrorNotSupported);
  const tc::Params p{o,     lse,    Tq,     Tk,      H,  KV,
                     Dh,    scale,  causal, window, has_cap, cap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh / 16) {
    case 1: return tc::launch<1>(mq, mk, mv, p, B, s);
    case 2: return tc::launch<2>(mq, mk, mv, p, B, s);
    case 3: return tc::launch<3>(mq, mk, mv, p, B, s);
    case 4: return tc::launch<4>(mq, mk, mv, p, B, s);
    case 5: return tc::launch<5>(mq, mk, mv, p, B, s);
    case 6: return tc::launch<6>(mq, mk, mv, p, B, s);
    case 7: return tc::launch<7>(mq, mk, mv, p, B, s);
    default: return tc::launch<8>(mq, mk, mv, p, B, s);
  }
}

}  // extern "C"
