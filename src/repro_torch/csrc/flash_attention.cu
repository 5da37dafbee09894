// K2: flash-attention forward (online softmax over KV tiles).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py
// flash_attention_fwd (body _flash_fwd_kernel).  Same function: q is
// scaled in float32 before the product, the tanh softcap comes before the
// masks, the masks are causal, sliding window and k_pos < Tk, a masked
// logit is NEG_INF = -1e30 (not -inf: exp(-inf - -inf) is NaN), the state
// m / l / acc is float32, and the output is acc / max(l, 1e-30) in q's
// dtype.
//
// Bound on Hopper: at the zamba2-7b prefill shape (B 1, T 4096, 32 heads,
// Dh 112, bf16, causal) one call does about 1.2e11 operations (half of
// 4*T^2*Dh*H) and moves 117 MB (q, k, v, o once each).  At an H100 SXM's
// data-sheet rates (700 W: 989 TFLOP/s bf16 on the tensor cores, 3.35
// TB/s) that is 0.12 ms against 0.035 ms for the bytes, so the work
// bounds it.  This first kernel stays off the tensor cores: it is a
// float32 SIMT kernel, tens of times slower than that bound (PERF.md has
// its time), and wgmma is work for a later change.
//
// Design: the TPU walks the KV blocks as a sequential grid axis and keeps
// m / l / acc in VMEM between steps.  Blocks here run in no order, so each
// block owns one (batch, head, 64-query tile) and walks the KV tiles
// itself, in a loop, with the state in registers.  256 threads as 16 x 16:
// thread (ty, tx) computes the 4 x 4 logits of query rows ty*4.. and key
// columns tx*4.. from float4 reads of the transposed Q and K tiles in
// shared memory; a row's max and sum are folded over its 16 threads with
// shuffles; P goes back to shared memory (transposed) and each thread adds
// P·V into its 4 rows x NJ columns (columns tx + 16 j, so any Dh up to 256
// is covered: Dh 112 is 7 columns per thread, with no power-of-two
// assumption; columns past Dh are zero padding in shared memory).  Tiles
// wholly above the diagonal or wholly before the window are skipped: for a
// row that has a legal key, a wholly masked tile's weight is exactly 0 once
// a legal tile has been seen, so skipping it is exact.  The kernel reads
// the (B, T, H, Dh) strides itself (head h reads kv head h / (H / KV)), so
// the wrapper makes no transposed or repeated copy.  It allocates nothing
// and never synchronises; the C entry point returns cudaGetLastError().

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

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  q (B, Tq, H, Dh) and k / v (B, Tk, KV,
// Dh) with the given strides and unit stride over Dh; o (B, Tq, H, Dh)
// contiguous.  window is 1 << 30 for none; cap is read when has_cap.
int flash_attention_fwd(int dtype, const void* q, const void* k,
                        const void* v, void* o, int B, int Tq, int Tk, int H,
                        int KV, int Dh, long long sqb, long long sqt,
                        long long sqh, long long skb, long long skt,
                        long long skh, long long svb, long long svt,
                        long long svh, float scale, int causal, int window,
                        int has_cap, float cap, void* stream) {
  if (B <= 0 || Tq <= 0) return 0;
  const Params p{q,   k,   v,   o,   B,   Tq,    Tk,     H,      KV,
                 Dh,  sqb, sqt, sqh, skb, skt,   skh,    svb,    svt,
                 svh, scale, causal, window, has_cap, cap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
