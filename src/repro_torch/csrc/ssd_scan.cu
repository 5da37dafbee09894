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
// 989 TFLOP/s bf16) the bytes bound it: 0.036 ms against 0.015 ms.
//
// Two variants.  The wrapper (kernels/ssd_scan.py) picks one by dtype, P,
// N and the chunk alone, never by a failure:
//
// * ssd_scan_fwd_tc, the tensor-core kernel, for bf16 x / B / C with
//   P = N = 64 and Q in {64, 128}.  TMA reads x, B and C, so their bases
//   and (B, T, head or group) strides must be positive multiples of 16
//   bytes; the wrapper raises on any other layout.
// * ssd_scan_fwd, the SIMT kernel, for float32 and every other shape.
//
// Tensor-core design: chunk-parallel, one block per (head, chunk, batch),
// with the state handed on from chunk to chunk through the L2 (a chained
// scan, as in a decoupled look-back).  Mamba-2's own SSD kernels run the
// same work in three passes (chunk states; the state pass over chunks;
// the outputs), which at zamba2 moves the 58.7 MB float32 state
// workspace four times; on an H100 that schedule took 1.47 x this
// kernel's device time (PERF.md).  One block, two warpgroups of 64 rows t:
//
// 1. TMA loads the chunk's C, B and x tiles ([Q][64] bf16, 128-byte
//    swizzle) while a warp scan takes acum; W = B dt exp(total - acum) is
//    written over the B tile's layout as bf16 hi and lo tiles.
// 2. Warpgroup 0 takes S_c = x^T W (64 x 64, depth Q) on wgmma, both
//    operands MN-major from shared memory; waits on the chunk's flag for
//    s_in[c], which chunk c - 1 published (0 for the first chunk); writes
//    s_in[c + 1] = s_in[c] exp(total) + S_c (the reference's expression,
//    in that order, no FMA contraction) to the workspace and publishes
//    it (stores, a barrier, then one st.release of the flag: the CUTLASS
//    semaphore's pattern); then s_in[c] as bf16 hi, lo tiles.
// 3. Each warpgroup, for its rows t and each 64-key half at or below the
//    diagonal: the scores C B^T (wgmma), times the decay and dt_u in
//    registers, packed as the A fragment of y += S x (wgmma, A from
//    registers, x the MN-major B operand).  Warpgroup 1 does this while
//    warpgroup 0 is on the chain.  Halves wholly above the diagonal are
//    skipped.
// 4. y += exp(acum[t]) C s_in[c]^T (wgmma, K-major operands), and y goes
//    through shared memory (swizzled, no bank conflicts) to 128-byte row
//    stores.
//
// The chain cannot deadlock, whatever order the card starts blocks in:
// a block does not take its (head, chunk, batch) from its block index but
// from a ticket it draws with one atomic as it starts, heads fastest.  So
// chunk c - 1 of a head went to a block that had started before, and a
// block waits only on such a predecessor, which waits only on its own.
// The flags and the ticket counter are zeroed by the wrapper for every
// call.  Every
// wait (the TMA's mbarrier, a chunk's flag) traps after 4 s of wall
// time, so a lost transaction or hand-off faults the launch instead of
// hanging the card.
//
// Precision: x, B and C are bf16 and go to the tensor cores as they are;
// the float32 operands (W, the decayed scores, s_in) go as two bf16 terms,
// hi = bf16(v) and lo = bf16(v - hi), each multiplied and summed into the
// float32 accumulators: about 16 bits of mantissa, where one bf16 pass
// lost a factor of ten in the worst row's error on a CPU model of this
// schedule (PERF.md).  The decay is selected, not multiplied: exp of
// acum[t] - acum[u] is taken only for u <= t (the exponent there is
// <= 0); above the diagonal it is positive, could overflow, and inf * 0 is
// NaN.  exp is one ex2 of acum in log2 units.
//
// SIMT design: the TPU carries the (P, N) state in VMEM across a sequential
// chunk axis of its grid.  Here one block owns one (batch, head) and loops
// over the chunks itself, with the state in shared memory (16 KB at
// P = N = 64) for the whole sequence.  Each chunk stages C and B
// (transposed), x, dt and the cumsum in shared memory, and runs three
// products as 64 x 64 output tiles, each thread a 4 x 4 sub-tile from
// float4 reads: the decay-masked scores (lower triangle only), then y
// (intra-chunk part plus the carried state's), then the state update.
// The decay is selected, not multiplied, as above.  B and C
// are read by group (head h reads group h / (H / G)) at the strides given,
// so the 112-fold head repeat of the reference wrapper is never written.
// At batch 1 it has only 112 blocks for 132 SMs, one chunk after another
// in each (PERF.md has its time).  The kernels allocate nothing and never
// synchronise; the C entry points return cudaGetLastError().

#include <cuda.h>  // CUtensorMap and its enums only: nothing links -lcuda
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


// ---------------------------------------------------------------------------
// Tensor-core variant (bf16, P = N = 64, Q in {64, 128})

namespace tc {

#include "hopper.cuh"

constexpr int kDim = 64;                      // P and N: one TMA box
constexpr int kStateTile = kDim * kRowBytes;  // one [64][64] bf16 tile
constexpr int kStateElems = kDim * kDim;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* dt;
  const float* A;
  float* states;  // (B, H, nc, P, N) float32: s_in[c] for c >= 1
  int* flags;     // (B, H, nc), zero at launch: s_in[c] published
  int* tickets;   // one counter, zero at launch: blocks draw (h, c, b)
  void* y;        // (B, T, H, P) bf16, contiguous
  int T, H, G, nc;
  long long sdb, sdt, sdh;
};

// shared memory of the kernel: bf16 tiles (1024-aligned for the swizzle)
// C, B, x, W hi (then y), W lo, s_in hi, s_in lo; then acum2[Q], dt[Q],
// fac[Q], warp sums[8], the mbarrier and the block's ticket
template <int Q>
struct Layout {
  static constexpr int kTile = Q * kRowBytes;  // one [Q][64] bf16 tile
  static constexpr int kBytes =
      1024 + 5 * kTile + 2 * kStateTile + 4 * (3 * Q + 8) + 16;
};
static_assert(Layout<128>::kBytes <= 232448 / 2, "two blocks per SM");

// the generic proxy's shared-memory writes become visible to wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// leading byte offsets of sw128_desc
constexpr uint32_t kKMajor = 16, kMNMajor = 1024;

// (v0, v1) as two bf16 pairs: hi = bf16(v), lo = bf16(v - hi); v - hi is
// exact in float32
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  const float2 h =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = pack_bf16(v0 - h.x, v1 - h.y);
}

// eight floats as the hi and lo 16-byte chunks of a bf16 tile
__device__ __forceinline__ void split8(const float (&v)[8], uint4& hi,
                                       uint4& lo) {
  split2(v[0], v[1], hi.x, lo.x);
  split2(v[2], v[3], hi.y, lo.y);
  split2(v[4], v[5], hi.z, lo.z);
  split2(v[6], v[7], hi.w, lo.w);
}

// D (64 x 64) (+)= A (64 x 16) B (16 x 64), both from shared memory;
// TA, TB: 0 K-major, 1 MN-major; accumulate = 0 overwrites
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// D (64 x 64) (+)= A (64 x 16, registers) B (16 x 64, shared, MN-major);
// accumulate = 0 overwrites
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// inclusive cumsum of dt * A over the chunk, in token order per warp and
// warp sums added in order: thread u < Q gets acum[u]; every thread of the
// block calls it (it synchronises)
template <int Q>
__device__ __forceinline__ float chunk_cumsum(const Params& p, int b, int h,
                                              int c, float* warp_sum,
                                              float& dtv) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  dtv = 0.f;
  if (tid < Q)
    dtv = p.dt[b * p.sdb + static_cast<long long>(c * Q + tid) * p.sdt +
               h * p.sdh];
  float v = dtv * p.A[h];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += n;
  }
  if (lane == 31) warp_sum[warp] = v;
  __syncthreads();
  float before = 0.f;
  for (int w = 0; w < warp && w < Q / 32; ++w) before += warp_sum[w];
  return v + before;
}

// release / acquire of a chunk's flag at device scope (the CUTLASS
// semaphore's pattern: the block's stores, a barrier, then one release)
__device__ __forceinline__ void flag_release(int* flag) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(flag), "r"(1)
               : "memory");
}
__device__ __forceinline__ int flag_acquire(const int* flag) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(flag)
               : "memory");
  return v;
}
// until the flag is set; traps after kWaitLimitNs
__device__ __forceinline__ void flag_wait(const int* flag) {
  if (flag_acquire(flag)) return;
  const unsigned long long t0 = global_ns();
  while (!flag_acquire(flag))
    if (global_ns() - t0 > kWaitLimitNs) __trap();
}
// bar.sync over the first warpgroup alone (barrier 0 is __syncthreads)
__device__ __forceinline__ void wg0_sync() {
  asm volatile("bar.sync 1, 128;" ::: "memory");
}

// One block per (head, chunk, batch), drawn from a ticket as the block
// starts, heads fastest, so that a chunk's predecessor has started
// before it; one warpgroup per 64 rows t.
//   1. all threads: acum, W = B dt exp(total - acum) (bf16 hi, lo);
//   2. warpgroup 0: S_c = x^T W; waits for s_in[c] (the chain's flag,
//      published by chunk c - 1), publishes s_in[c + 1] = s_in[c]
//      exp(total) + S_c (the reference's expression, in that order, no
//      FMA contraction) and writes s_in[c] as bf16 hi, lo tiles; then
//      its own rows' y_intra;
//   3. warpgroup 1 meanwhile: its rows' y_intra over both 64-key halves;
//   4. both: y += exp(acum[t]) C s_in[c]^T; y through shared memory to
//      128-byte row stores.
template <int Q>
__global__ void __launch_bounds__(2 * Q, 2)
ssd_scan_kernel_tc(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_b,
                   const __grid_constant__ CUtensorMap tm_c,
                   const Params p) {
  using L = Layout<Q>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sc = (raw + 1023u) & ~1023u;
  uint8_t* base = smem_raw + (sc - raw);
  const uint32_t sb = sc + L::kTile, sx = sb + L::kTile,
                 swh = sx + L::kTile, swl = swh + L::kTile,
                 shi = swl + L::kTile, slo = shi + kStateTile;
  uint8_t* ybuf = base + 3 * L::kTile;  // W hi, once S_c is taken
  float* acum2 = reinterpret_cast<float*>(base + 5 * L::kTile +
                                          2 * kStateTile);  // [Q], log2
  float* dts = acum2 + Q;                                   // [Q]
  float* fac = dts + Q;                                     // [Q]
  float* warp_sum = fac + Q;                                // [8]
  const uint32_t bar = smem_u32(warp_sum + 8);
  int* ticket = reinterpret_cast<int*>(warp_sum + 10);

  const int tid = threadIdx.x;
  if (tid == 0) {
    *ticket = atomicAdd(p.tickets, 1);
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int h = *ticket % p.H, c = *ticket / p.H % p.nc,
            b = *ticket / (p.H * p.nc);
  if (tid == 0) {
    const int g = h / (p.H / p.G);
    mbar_expect_tx(bar, 3 * L::kTile);
    tma_load(sc, &tm_c, bar, 0, g, c * Q, b);
    tma_load(sb, &tm_b, bar, 0, g, c * Q, b);
    tma_load(sx, &tm_x, bar, 0, h, c * Q, b);
  }
  float dtv;
  const float acum = chunk_cumsum<Q>(p, b, h, c, warp_sum, dtv);
  if (tid == Q - 1) fac[Q - 1] = acum;  // total
  __syncthreads();
  const float total = fac[Q - 1];
  __syncthreads();
  if (tid < Q) {
    acum2[tid] = acum * kLog2e;
    dts[tid] = dtv;
    fac[tid] = dtv * expf(total - acum);
  }
  __syncthreads();
  mbar_wait(bar, 0);

  // W over the B tile's (swizzled) layout: a 128-byte row is one token,
  // whatever the order of its 16-byte chunks
  for (int e = tid; e < Q * 8; e += 2 * Q) {
    const uint4 raw8 = *reinterpret_cast<const uint4*>(base + L::kTile +
                                                       e * 16);
    const float w = fac[e >> 3];
    const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&raw8);
    float v[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(pr[i]);
      v[2 * i] = f.x * w;
      v[2 * i + 1] = f.y * w;
    }
    uint4 hi, lo;
    split8(v, hi, lo);
    *reinterpret_cast<uint4*>(base + 3 * L::kTile + e * 16) = hi;
    *reinterpret_cast<uint4*>(base + 4 * L::kTile + e * 16) = lo;
  }
  fence_async_smem();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int ra = 16 * warp + g, rb = ra + 8;  // this thread's rows t (wg 0:
                                              // its rows p of S_c)
  const uint32_t c_rows = sc + wg * 64 * kRowBytes;
  const long long bh = static_cast<long long>(b) * p.H + h;

  if (wg == 0) {
    float d[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = 0.f;
    fence_regs(d);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      const uint32_t k_off = kk * 16 * kRowBytes;  // 16 tokens
      const uint64_t da = sw128_desc(sx + k_off, kMNMajor);
      wgmma_ss<1, 1>(d, da, sw128_desc(swh + k_off, kMNMajor), kk > 0);
      wgmma_ss<1, 1>(d, da, sw128_desc(swl + k_off, kMNMajor), 1);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(d);

    // d[4 jn + e]: p = ra or rb (e >> 1), n = 8 jn + 2 t4 + (e & 1).
    // s_in[c] (0 for the first chunk) in the same layout, all loads in
    // flight at once; s_in[c + 1] = s_in[c] exp(total) + S_c to the
    // workspace, then the flag publishes it; only then s_in[c] as bf16 hi,
    // lo tiles [p][n] for C s_in^T (K-major, 128-byte swizzle: the pair
    // (n, n + 1) in chunk jn ^ (p & 7) of row p), so that the hand-off
    // waits for nothing else and the packed pairs are never live with d
    float v[32];
    if (c > 0) {
      if (tid == 0) flag_wait(p.flags + bh * p.nc + c);
      wg0_sync();
      const float* src = p.states + (bh * p.nc + c) * kStateElems;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = (i & 2) ? rb : ra;
        const float2 a = __ldcg(reinterpret_cast<const float2*>(
            src + row * kDim + 8 * (i >> 2) + 2 * t4));
        v[i] = a.x;
        v[i + 1] = a.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) v[i] = 0.f;
    }
    if (c + 1 < p.nc) {
      const float decay = expf(total);
      float* dst = p.states + (bh * p.nc + c + 1) * kStateElems;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = (i & 2) ? rb : ra;
        __stcg(reinterpret_cast<float2*>(dst + row * kDim + 8 * (i >> 2) +
                                         2 * t4),
               make_float2(__fadd_rn(__fmul_rn(v[i], decay), d[i]),
                           __fadd_rn(__fmul_rn(v[i + 1], decay), d[i + 1])));
      }
      wg0_sync();
      if (tid == 0) flag_release(p.flags + bh * p.nc + c + 1);
    }
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = (i & 2) ? rb : ra, jn = i >> 2;
      uint32_t hi, lo;
      split2(v[i], v[i + 1], hi, lo);
      const int off = row * kRowBytes + ((jn ^ (row & 7)) << 4) + 4 * t4;
      *reinterpret_cast<uint32_t*>(base + 5 * L::kTile + off) = hi;
      *reinterpret_cast<uint32_t*>(base + 5 * L::kTile + kStateTile + off) =
          lo;
    }
    fence_async_smem();
  }

  // y_intra: y = (C B^T * decay * dt) x over the 64-key halves at or below
  // the diagonal (half hf holds keys 64 hf .. 64 hf + 63)
  const float at = acum2[ra], bt = acum2[rb];
  float y[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) y[i] = 0.f;
  for (int hf = 0; hf <= wg; ++hf) {
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kDim / 16; ++kk)
      wgmma_ss<0, 0>(s, sw128_desc(c_rows + kk * 32, kKMajor),
                     sw128_desc(sb + hf * 64 * kRowBytes + kk * 32, kKMajor),
                     kk > 0);
    wg_commit();
    wg_wait_all();
    fence_regs(s);
    // s[4 jn + e]: row (e < 2 ? ra : rb), key 64 hf + 8 jn + 2 t4 + (e & 1);
    // ph / pl [2 jn + (e >> 1)] pack the pair, so ph[4 kk .. 4 kk + 3] is
    // the A fragment of key step kk
    uint32_t ph[16], pl[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int t = (i & 2) ? rb : ra;
      const float a_t = (i & 2) ? bt : at;
      const int u = 64 * hf + 8 * (i >> 2) + 2 * t4;
      const float v0 =
          u <= t ? s[i] * ex2(a_t - acum2[u]) * dts[u] : 0.f;
      const float v1 =
          u + 1 <= t ? s[i + 1] * ex2(a_t - acum2[u + 1]) * dts[u + 1] : 0.f;
      split2(v0, v1, ph[i >> 1], pl[i >> 1]);
    }
    fence_regs(y);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db =
          sw128_desc(sx + (hf * 64 + kk * 16) * kRowBytes, kMNMajor);
      const uint32_t ah[4] = {ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2],
                              ph[4 * kk + 3]};
      const uint32_t al[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2],
                              pl[4 * kk + 3]};
      wgmma_rs(y, ah, db, hf > 0 || kk > 0);
      wgmma_rs(y, al, db, 1);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(y);
  }
  __syncthreads();  // s_in tiles written; W read by every product

  // y += exp(acum[t]) C s_in^T
  {
    float z[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) z[i] = 0.f;
    fence_regs(z);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kDim / 16; ++kk) {
      const uint64_t da = sw128_desc(c_rows + kk * 32, kKMajor);
      wgmma_ss<0, 0>(z, da, sw128_desc(shi + kk * 32, kKMajor), kk > 0);
      wgmma_ss<0, 0>(z, da, sw128_desc(slo + kk * 32, kKMajor), 1);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(z);
    const float ea = ex2(at), eb = ex2(bt);
#pragma unroll
    for (int i = 0; i < 32; ++i) y[i] += z[i] * ((i & 2) ? eb : ea);
  }

  // y (t, p = 8 jn + 2 t4 + (e & 1)) as bf16 into this warp's 16 rows of
  // the staging tile (chunk jn of row t at jn ^ (t & 7)), then 16-byte
  // stores of whole 128-byte rows
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
    *reinterpret_cast<uint32_t*>(ybuf + ra * kRowBytes +
                                 ((jn ^ (ra & 7)) << 4) + 4 * t4) =
        pack_bf16(y[4 * jn], y[4 * jn + 1]);
    *reinterpret_cast<uint32_t*>(ybuf + rb * kRowBytes +
                                 ((jn ^ (rb & 7)) << 4) + 4 * t4) =
        pack_bf16(y[4 * jn + 2], y[4 * jn + 3]);
  }
  __syncwarp();
  __nv_bfloat16* yg = static_cast<__nv_bfloat16*>(p.y);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int e = lane + 32 * k;
    const int t = 16 * warp + (e >> 3), j = e & 7;
    const uint4 v = *reinterpret_cast<const uint4*>(
        ybuf + t * kRowBytes + ((j ^ (t & 7)) << 4));
    *reinterpret_cast<uint4*>(
        yg + ((static_cast<long long>(b) * p.T + c * Q + t) * p.H + h) *
                 kDim +
        8 * j) = v;
  }
}

template <int Q>
int launch(const CUtensorMap& mx, const CUtensorMap& mb,
           const CUtensorMap& mc, const Params& p, int B,
           cudaStream_t stream) {
  constexpr int bytes = Layout<Q>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel_tc<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.H, p.nc, B);  // one block per ticket
  ssd_scan_kernel_tc<Q><<<grid, 2 * Q, bytes, stream>>>(mx, mb, mc, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

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

// The tensor-core variant: bf16 x, B, C and y; P = N = 64; Q 64 or 128
// dividing T; H a multiple of G; bases and (B, T, head or group) strides of
// x, B and C positive multiples of 16 bytes (the wrapper checks all of it
// first).  dt (B, T, H) float32 at the given strides, A (H,) contiguous,
// y (B, T, H, P) contiguous; states (B, H, T / Q, P, N) float32 and flags
// (B, H, T / Q) int32 workspaces, the flags followed by one more int32,
// the ticket counter, all zero.  Returns
// cudaErrorInvalidValue for a
// call outside that rule and cudaErrorNotSupported if a tensor map cannot
// be encoded.
int ssd_scan_fwd_tc(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, void* y, void* states,
                    void* flags, int B, int T, int H, int G, int P, int N,
                    int Q, long long sxb, long long sxt, long long sxh,
                    long long sdb, long long sdt, long long sdh,
                    long long sbb, long long sbt, long long sbg,
                    long long scb, long long sct, long long scg,
                    void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const long long blocks = static_cast<long long>(B) * H * (T / Q);
  if (P != tc::kDim || N != tc::kDim || (Q != 64 && Q != 128) || T % Q ||
      T / Q > 65535 || G < 1 || H % G || blocks >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mb, mc;
  if (!tc::encode(&mx, x, tc::kDim, H, T, B, sxh, sxt, sxb, Q) ||
      !tc::encode(&mb, Bm, tc::kDim, G, T, B, sbg, sbt, sbb, Q) ||
      !tc::encode(&mc, Cm, tc::kDim, G, T, B, scg, sct, scb, Q))
    return static_cast<int>(cudaErrorNotSupported);
  const tc::Params p{static_cast<const float*>(dt),
                     static_cast<const float*>(A),
                     static_cast<float*>(states),
                     static_cast<int*>(flags),
                     static_cast<int*>(flags) + blocks,
                     y, T, H, G, T / Q, sdb, sdt, sdh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return Q == 128 ? tc::launch<128>(mx, mb, mc, p, B, s)
                  : tc::launch<64>(mx, mb, mc, p, B, s);
}

}  // extern "C"
