// K3: Mamba-2 SSD chunked scan, forward.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py ssd_scan_fwd
// (body _ssd_kernel).  Per (batch, head) and per chunk of Q tokens, with
// acum the inclusive cumsum of dt * A over the chunk:
//   y[t]   = sum_{u <= t} (C[t]·B[u]) exp(acum[t] - acum[u]) dt[u] x[u]
//            + exp(acum[t]) C[t]·state
//   state <- state exp(acum[Q-1]) + sum_u x[u] (B[u] dt[u] exp(acum[Q-1] - acum[u]))
// in float32, with y stored in x's dtype.  Only y is returned, as there.
//
// Bound on Hopper: at the zamba2-7b prefill shape (B 1, T 4096, 112 heads,
// P 64, N 64, Q 128; x, B, C bf16, dt f32) one call does about 1.5e10
// operations (the scores and y_intra over the lower triangle, y_inter, the
// state update) and moves about 120 MB (x and y in bf16, dt, and B and C
// at group width).  At an H100 SXM's data-sheet rates (700 W: 3.35 TB/s,
// 989 TFLOP/s bf16) the bytes bound it: 0.036 ms against 0.015 ms.  This
// first kernel is a float32 SIMT kernel and is far from that bound
// (PERF.md has its time): at batch 1 it has only 112 blocks for 132 SMs,
// one chunk after another in each.
//
// Design: the TPU carries the (P, N) state in VMEM across a sequential
// chunk axis of its grid.  Here one block owns one (batch, head) and loops
// over the chunks itself, with the state in shared memory (16 KB at
// P = N = 64) for the whole sequence.  Each chunk stages C and B
// (transposed), x, dt and the cumsum in shared memory, and runs three
// products as 64 x 64 output tiles, each thread a 4 x 4 sub-tile from
// float4 reads: the decay-masked scores (lower triangle only), then y
// (intra-chunk part plus the carried state's), then the state update.
// The decay is selected, not multiplied: exp(acum[t] - acum[u]) is
// evaluated only for u <= t, where the exponent is <= 0; above the
// diagonal it is positive, could overflow, and inf * 0 is NaN.  B and C
// are read by group (head h reads group h / (H / G)) at the strides given,
// so the 112-fold head repeat of the reference wrapper is never written.
// Splitting P across blocks (more blocks at batch 1, at the cost of
// recomputing the Q x Q scores) is left for a later change.  The kernel
// allocates nothing and never synchronises; the C entry point returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // output tile edge; 16 x 16 threads of 4 x 4
constexpr int kPad = 4;    // keeps float4 alignment, spreads banks

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

__device__ __forceinline__ void unpack(const float4 a, float (&v)[4]) {
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  void* y;
  int B, T, H, G, P, N, Q;
  long long sxb, sxt, sxh, sdb, sdt, sdh, sbb, sbt, sbg, scb, sct, scg;
};

__host__ __device__ inline size_t smem_floats(int Q, int P, int N) {
  const int sQ = Q + kPad, sP = P + kPad, sN = N + kPad;
  const int sS = sQ > sN ? sQ : sN;
  return static_cast<size_t>(N) * sQ * 2       // Ct, Bt
         + static_cast<size_t>(Q) * sP         // X
         + static_cast<size_t>(Q) * sS         // St, then W
         + static_cast<size_t>(N) * sP         // state, transposed
         + static_cast<size_t>(Q) * 3;         // dt, acum, w factor
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Q = p.Q, P = p.P, N = p.N;
  const int sQ = Q + kPad, sP = P + kPad, sN = N + kPad;
  const int sS = sQ > sN ? sQ : sN;
  float* Ct = smem;              // [N][sQ]  C[t][n] at Ct[n][t]
  float* Bt = Ct + N * sQ;       // [N][sQ]  B[u][n] at Bt[n][u]
  float* X = Bt + N * sQ;        // [Q][sP]
  float* S = X + Q * sP;         // St[u][t] (stride sQ), then W[u][n] (sN)
  float* St = S + Q * sS;        // state[p][n] at St[n][p], stride sP
  float* dtv = St + N * sP;      // [Q]
  float* acum = dtv + Q;         // [Q]
  float* wfac = acum + Q;        // [Q]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (p.H / p.G);
  const float A = p.A[h];

  const T* x = static_cast<const T*>(p.x) + b * p.sxb + h * p.sxh;
  const float* dt = p.dt + b * p.sdb + h * p.sdh;
  const T* Bm = static_cast<const T*>(p.Bm) + b * p.sbb + g * p.sbg;
  const T* Cm = static_cast<const T*>(p.Cm) + b * p.scb + g * p.scg;
  T* y = static_cast<T*>(p.y) +
         (static_cast<long long>(b) * p.T * p.H + h) * P;
  const long long syt = static_cast<long long>(p.H) * P;

  for (int e = tid; e < N * sP; e += kThreads) St[e] = 0.f;

  for (int t0 = 0; t0 < p.T; t0 += Q) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < Q; i += kThreads) dtv[i] = dt[(t0 + i) * p.sdt];
    for (int e = tid; e < Q * N; e += kThreads) {
      const int u = e / N, n = e - u * N;
      Bt[n * sQ + u] = to_f(Bm[(t0 + u) * p.sbt + n]);
      Ct[n * sQ + u] = to_f(Cm[(t0 + u) * p.sct + n]);
    }
    for (int e = tid; e < Q * P; e += kThreads) {
      const int u = e / P, q = e - u * P;
      X[u * sP + q] = to_f(x[(t0 + u) * p.sxt + q]);
    }
    __syncthreads();
    if (tid == 0) {  // inclusive cumsum of dt * A, in token order
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run += dtv[i] * A;
        acum[i] = run;
      }
    }
    __syncthreads();

    // scores St[u][t] = (C[t]·B[u]) exp(acum[t] - acum[u]) dt[u], u <= t
    for (int tm = 0; tm < Q; tm += kTile) {
      for (int un = 0; un <= tm; un += kTile) {
        const int t0l = tm + ty * 4, u0 = un + tx * 4;
        // a sub-tile wholly above the diagonal is never read
        if (t0l >= Q || u0 >= Q || u0 > t0l + 3) continue;
        float acc[4][4] = {};
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
          unpack(*reinterpret_cast<const float4*>(&Ct[n * sQ + t0l]), cv);
          unpack(*reinterpret_cast<const float4*>(&Bt[n * sQ + u0]), bv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int u = u0 + j;
          float out[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = t0l + i;
            out[i] = u <= t ? acc[i][j] * expf(acum[t] - acum[u]) * dtv[u]
                            : 0.f;
          }
          *reinterpret_cast<float4*>(&S[u * sQ + t0l]) =
              make_float4(out[0], out[1], out[2], out[3]);
        }
      }
    }
    __syncthreads();

    // y[t][p] = sum_{u <= t} St[u][t] x[u][p] + exp(acum[t]) C[t]·state[p]
    for (int tm = 0; tm < Q; tm += kTile) {
      for (int pn = 0; pn < P; pn += kTile) {
        const int t0l = tm + ty * 4, p0 = pn + tx * 4;
        if (t0l >= Q || p0 >= P) continue;
        float intra[4][4] = {}, inter[4][4] = {};
        const int u_end = min(Q, t0l + 4);  // St[u][t] = 0 for u > t
        for (int u = 0; u < u_end; ++u) {
          float sv[4], xv[4];
          unpack(*reinterpret_cast<const float4*>(&S[u * sQ + t0l]), sv);
          unpack(*reinterpret_cast<const float4*>(&X[u * sP + p0]), xv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              intra[i][j] = fmaf(sv[i], xv[j], intra[i][j]);
        }
        for (int n = 0; n < N; ++n) {
          float cv[4], hv[4];
          unpack(*reinterpret_cast<const float4*>(&Ct[n * sQ + t0l]), cv);
          unpack(*reinterpret_cast<const float4*>(&St[n * sP + p0]), hv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              inter[i][j] = fmaf(cv[i], hv[j], inter[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0l + i;
          const float decay = expf(acum[t]);
          T* yrow = y + (t0 + t) * syt + p0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            yrow[j] = from_f<T>(intra[i][j] + inter[i][j] * decay);
        }
      }
    }
    __syncthreads();  // St and the old state are read; S is free

    const float total = acum[Q - 1];
    for (int i = tid; i < Q; i += kThreads)
      wfac[i] = dtv[i] * expf(total - acum[i]);
    __syncthreads();
    for (int e = tid; e < Q * N; e += kThreads) {
      const int u = e / N, n = e - u * N;
      S[u * sN + n] = Bt[n * sQ + u] * wfac[u];  // W[u][n]
    }
    __syncthreads();

    // state[p][n] <- state[p][n] exp(total) + sum_u x[u][p] W[u][n]
    const float chunk_decay = expf(total);
    for (int nm = 0; nm < N; nm += kTile) {
      for (int pn = 0; pn < P; pn += kTile) {
        const int n0 = nm + ty * 4, p0 = pn + tx * 4;
        if (n0 >= N || p0 >= P) continue;
        float acc[4][4] = {};
        for (int u = 0; u < Q; ++u) {
          float wv[4], xv[4];
          unpack(*reinterpret_cast<const float4*>(&S[u * sN + n0]), wv);
          unpack(*reinterpret_cast<const float4*>(&X[u * sP + p0]), xv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* row = &St[(n0 + i) * sP + p0];
#pragma unroll
          for (int j = 0; j < 4; ++j) row[j] = row[j] * chunk_decay + acc[i][j];
        }
      }
    }
  }
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = smem_floats(p.Q, p.P, p.N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.H, p.B);
  ssd_scan_kernel<T><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, that a launch with these sizes needs;
// the wrapper refuses sizes above the card's per-block limit.
long long ssd_scan_smem_bytes(int Q, int P, int N) {
  return static_cast<long long>(smem_floats(Q, P, N) * sizeof(float));
}

// dtype: 0 float32, 1 bfloat16 (x, B, C and y); dt and A are float32.
// x (B, T, H, P), dt (B, T, H), B / C (B, T, G, N) at the given strides
// with unit stride over the last axis; A (H,) contiguous; y (B, T, H, P)
// contiguous.  Q divides T; Q, P and N are multiples of 4.
int ssd_scan_fwd(int dtype, const void* x, const void* dt, const void* A,
                 const void* Bm, const void* Cm, void* y, int B, int T, int H,
                 int G, int P, int N, int Q, long long sxb, long long sxt,
                 long long sxh, long long sdb, long long sdt, long long sdh,
                 long long sbb, long long sbt, long long sbg, long long scb,
                 long long sct, long long scg, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const Params p{x, static_cast<const float*>(dt),
                 static_cast<const float*>(A), Bm, Cm, y, B, T, H, G, P, N,
                 Q, sxb, sxt, sxh, sdb, sdt, sdh, sbb, sbt, sbg, scb, sct,
                 scg};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
