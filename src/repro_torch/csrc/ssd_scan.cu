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
// 989 TFLOP/s bf16) the bytes bound it: 0.036 ms against 0.015 ms.  At the
// mamba2-2.7b prefill shape (80 heads, P 64, N 128, the rest the same) it
// moves 87.3 MB: 0.026 ms.
//
// Two variants.  The wrapper (kernels/ssd_scan.py) picks one by dtype, P,
// N and the chunk alone, never by a failure:
//
// * ssd_scan_fwd_tc, the tensor-core kernel, for bf16 x / B / C with
//   P 64, N 64 or 128 and Q in {64, 128}: zamba2-7b's calls (N 64) and
//   mamba2-2.7b's (N 128).  TMA reads x, B and C, so their bases and (B,
//   T, head or group) strides must be positive multiples of 16 bytes; the
//   wrapper raises on any other layout.
// * ssd_scan_fwd, the SIMT kernel, for float32 and every other shape
//   (N 256, P 128, other chunks).
//
// Tensor-core design: chunk-parallel, one block per (head, chunk, batch),
// with the state handed on from chunk to chunk through the L2 (a chained
// scan, as in a decoupled look-back).  Mamba-2's own SSD kernels run the
// same work in three passes (chunk states; the state pass over chunks;
// the outputs), which at zamba2 moves the 58.7 MB float32 state
// workspace four times; on an H100 that schedule took 1.47 x this
// kernel's device time (PERF.md).  One block, two warpgroups of 64 rows t;
// one template over N, whose C, B, W and state tiles are N / 64 boxes of
// 64 columns:
//
// 1. TMA loads the chunk's C, B and x tiles ([Q][64] bf16 boxes, 128-byte
//    swizzle) while a warp scan takes acum; W = B dt exp(total - acum) is
//    written over the B tile's layout as bf16 hi and lo tiles.
// 2. Warpgroup 0 takes S_c = x^T W (64 x N, depth Q; one 64 x 64
//    accumulator per box) on wgmma, both operands MN-major from shared
//    memory; waits on its head's counter for s_in[c], which chunk c - 1
//    published (0 for the first chunk); writes s_in[c + 1] = s_in[c]
//    exp(total) + S_c (the reference's expression, in that order, no FMA
//    contraction) to the next slot of the head's ring (Params::ring below
//    says why two slots are enough) and publishes it (stores, a barrier,
//    then one st.release of the counter: the CUTLASS semaphore's
//    pattern); then s_in[c] as bf16 hi, lo tiles.  The ring
//    and the counters are the whole workspace: 2 x 64 x N x 4 bytes (32 KB
//    at N 64) and 4 bytes per (batch, head), whatever T.
// 3. Each warpgroup, for its rows t and each 64-key half at or below the
//    diagonal: the scores C B^T (wgmma, depth N), times the decay and dt_u
//    in registers, packed as the A fragment of y += S x (wgmma, A from
//    registers, x the MN-major B operand).  Warpgroup 1 does this while
//    warpgroup 0 is on the chain.  Halves wholly above the diagonal are
//    skipped.
// 4. y += exp(acum[t]) C s_in[c]^T (wgmma, K-major operands, depth N), and
//    y goes through shared memory (swizzled, no bank conflicts) to
//    128-byte row stores.
//
// The chain cannot deadlock, whatever order the card starts blocks in:
// a block does not take its (head, chunk, batch) from its block index but
// from a ticket it draws with one atomic as it starts, heads fastest.  So
// chunk c - 1 of a head went to a block that had started before, and a
// block waits only on such a predecessor, which waits only on its own.
// The counters and the ticket counter are zeroed by the wrapper for every
// call.  Every wait (the TMA's mbarrier, a head's counter) traps after 4 s
// of wall time, so a lost transaction or hand-off faults the launch
// instead of hanging the card.
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
// chunk axis of its grid.  Here one block owns one (batch, head) and up to
// 64 columns of P (a second block takes P 65 .. 128), loops over the
// chunks itself, and keeps its columns of the state in shared memory for
// the whole sequence (64 KB at N 256).  Each chunk stages x, dt and the
// cumsum, then C and B 32 state columns at a time: each such N tile adds
// its part of the scores C B^T, adds C state^T to y's state term, and
// then updates its own columns of the state, which no other tile reads.
// y's intra-chunk part follows once the scores are whole.  Every product
// is 64-wide output tiles of 4 x 4 (2 x 4 for the state) sub-tiles per
// thread from float4 reads; y stays in registers across the N tiles.
// Tiling N keeps shared memory at most 225,792 bytes for every chunk up
// to 128, P and N multiples of 4 (N up to 256).  The decay is selected,
// not multiplied, as above.  B and C are read by group (head h reads
// group h / (H / G)) at the strides given, so the head repeat of the
// reference wrapper is never written.  At batch 1 it has only H blocks
// for 132 SMs, one chunk after another in each (PERF.md has its time at
// mamba2-2.7b's shape in float32).  The kernels allocate nothing and never synchronise; the C entry
// points return cudaGetLastError().

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

constexpr int kPSlice = 64;  // columns of P one block owns (grid z: P / 64)
constexpr int kNTile = 32;   // state columns staged at once
constexpr int kTTiles = 2;   // 64-row tiles of y a thread owns: Q <= 128

// shared memory of one block, in floats: one N tile's Ct, Bt and W, the
// block's x columns, the scores, the block's columns of the state
// (transposed), dt, acum and the w factor
__host__ __device__ inline size_t smem_floats(int Q, int P, int N) {
  const int pt = P < kPSlice ? P : kPSlice, nt = N < kNTile ? N : kNTile;
  const int sQ = Q + kPad, sP = pt + kPad, sN = nt + kPad;
  return static_cast<size_t>(nt) * sQ * 2      // Ct, Bt
         + static_cast<size_t>(Q) * sN         // W
         + static_cast<size_t>(Q) * sP         // X
         + static_cast<size_t>(Q) * sQ         // St
         + static_cast<size_t>(N) * sP         // state, transposed
         + static_cast<size_t>(Q) * 3;         // dt, acum, w factor
}

// One block per (head, batch, 64 columns of P), looping over the chunks
// with its columns of the state in shared memory.  Per chunk, for each
// tile of kNTile state columns n:
//   (a) the scores St[u][t] += C[t, tile]·B[u, tile] (u <= t), the last
//       tile times exp(acum[t] - acum[u]) dt[u];
//   (b) y's state term, inter[t][p] += C[t, tile]·state[p, tile], from
//       the state entering the chunk;
//   (c) after a barrier, the tile's columns of the state:
//       state[p][n] <- state[p][n] exp(total) + sum_u x[u][p] W[u][n].
// Then y = St x + exp(acum[t]) inter.  State columns are independent, so
// (b) and (c) need only their own tile; the scores, summed over every
// tile, wait for the last.  Each thread keeps its y rows in registers.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Q = p.Q, N = p.N;
  const int pb = blockIdx.z * kPSlice;
  const int P = min(kPSlice, p.P - pb);  // this block's columns
  const int NT = min(kNTile, N);
  const int sQ = Q + kPad, sP = min(kPSlice, p.P) + kPad, sN = NT + kPad;
  float* Ct = smem;              // [NT][sQ]  C[t][n0 + n] at Ct[n][t]
  float* Bt = Ct + NT * sQ;      // [NT][sQ]  B[u][n0 + n] at Bt[n][u]
  float* W = Bt + NT * sQ;       // [Q][sN]   B[u][n0 + n] dt[u] exp(total - acum[u])
  float* X = W + Q * sN;         // [Q][sP]
  float* S = X + Q * sP;         // St[u][t], stride sQ
  float* St = S + Q * sQ;        // state[p][n] at St[n][p], stride sP
  float* dtv = St + N * sP;      // [Q]
  float* acum = dtv + Q;         // [Q]
  float* wfac = acum + Q;        // [Q]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (p.H / p.G);
  const float A = p.A[h];

  const T* x = static_cast<const T*>(p.x) + b * p.sxb + h * p.sxh + pb;
  const float* dt = p.dt + b * p.sdb + h * p.sdh;
  const T* Bm = static_cast<const T*>(p.Bm) + b * p.sbb + g * p.sbg;
  const T* Cm = static_cast<const T*>(p.Cm) + b * p.scb + g * p.scg;
  T* y = static_cast<T*>(p.y) +
         (static_cast<long long>(b) * p.T * p.H + h) * p.P + pb;
  const long long syt = static_cast<long long>(p.H) * p.P;
  const int p0 = tx * 4;  // this thread's columns of y and of the state

  for (int e = tid; e < N * sP; e += kThreads) St[e] = 0.f;

  for (int t0 = 0; t0 < p.T; t0 += Q) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < Q; i += kThreads) dtv[i] = dt[(t0 + i) * p.sdt];
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
    const float total = acum[Q - 1];
    const float chunk_decay = expf(total);
    for (int i = tid; i < Q; i += kThreads)
      wfac[i] = dtv[i] * expf(total - acum[i]);

    float inter[kTTiles][4][4] = {};
    for (int n0 = 0; n0 < N; n0 += NT) {
      const int nt = min(NT, N - n0);
      const bool last = n0 + nt >= N;
      __syncthreads();  // wfac written; the last tile's readers are done
      for (int e = tid; e < Q * nt; e += kThreads) {
        const int u = e / nt, n = e - u * nt;
        const float bv = to_f(Bm[(t0 + u) * p.sbt + n0 + n]);
        Bt[n * sQ + u] = bv;
        W[u * sN + n] = bv * wfac[u];
        Ct[n * sQ + u] = to_f(Cm[(t0 + u) * p.sct + n0 + n]);
      }
      __syncthreads();

      // (a) this tile's part of the scores; every tile adds to the same
      // elements of St, which only this thread touches until the barrier
      // after the last tile
      for (int tm = 0; tm < Q; tm += kTile) {
        for (int un = 0; un <= tm; un += kTile) {
          const int t0l = tm + ty * 4, u0 = un + tx * 4;
          // a sub-tile wholly above the diagonal is never read
          if (t0l >= Q || u0 >= Q || u0 > t0l + 3) continue;
          float acc[4][4] = {};
          for (int n = 0; n < nt; ++n) {
            float cv[4], bv[4];
            unpack(*reinterpret_cast<const float4*>(&Ct[n * sQ + t0l]), cv);
            unpack(*reinterpret_cast<const float4*>(&Bt[n * sQ + u0]), bv);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int u = u0 + j;
            float4* dst = reinterpret_cast<float4*>(&S[u * sQ + t0l]);
            float out[4];
            if (n0 > 0) {
              unpack(*dst, out);
            } else {
#pragma unroll
              for (int i = 0; i < 4; ++i) out[i] = 0.f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int t = t0l + i;
              out[i] += acc[i][j];
              if (last)
                out[i] = u <= t ? out[i] * expf(acum[t] - acum[u]) * dtv[u]
                                : 0.f;
            }
            *dst = make_float4(out[0], out[1], out[2], out[3]);
          }
        }
      }

      // (b) y's state term over this tile, from the entering state
      if (p0 < P) {
#pragma unroll
        for (int tt = 0; tt < kTTiles; ++tt) {
          const int t0l = tt * kTile + ty * 4;
          if (t0l >= Q) continue;
          for (int n = 0; n < nt; ++n) {
            float cv[4], hv[4];
            unpack(*reinterpret_cast<const float4*>(&Ct[n * sQ + t0l]), cv);
            unpack(*reinterpret_cast<const float4*>(&St[(n0 + n) * sP + p0]),
                   hv);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                inter[tt][i][j] = fmaf(cv[i], hv[j], inter[tt][i][j]);
          }
        }
      }
      __syncthreads();  // the tile's entering state is read

      // (c) the tile's state columns, two n by four p a thread
      const int nl = ty * 2;
      if (nl < nt && p0 < P) {
        float acc[2][4] = {};
        for (int u = 0; u < Q; ++u) {
          const float2 wv = *reinterpret_cast<const float2*>(&W[u * sN + nl]);
          float xv[4];
          unpack(*reinterpret_cast<const float4*>(&X[u * sP + p0]), xv);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[0][j] = fmaf(wv.x, xv[j], acc[0][j]);
            acc[1][j] = fmaf(wv.y, xv[j], acc[1][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float* row = &St[(n0 + nl + i) * sP + p0];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            row[j] = row[j] * chunk_decay + acc[i][j];
        }
      }
    }
    __syncthreads();  // the scores are complete

    // y[t][p] = sum_{u <= t} St[u][t] x[u][p] + exp(acum[t]) inter[t][p]
    if (p0 < P) {
#pragma unroll
      for (int tt = 0; tt < kTTiles; ++tt) {
        const int t0l = tt * kTile + ty * 4;
        if (t0l >= Q) continue;
        float intra[4][4] = {};
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
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0l + i;
          const float decay = expf(acum[t]);
          T* yrow = y + (t0 + t) * syt + p0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            yrow[j] = from_f<T>(intra[i][j] + inter[tt][i][j] * decay);
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
  const dim3 grid(p.H, p.B, (p.P + kPSlice - 1) / kPSlice);
  ssd_scan_kernel<T><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// Tensor-core variant (bf16, P 64, N 64 or 128, Q in {64, 128})

namespace tc {

#include "hopper.cuh"

constexpr int kDim = 64;                      // P: one TMA box
constexpr int kStateTile = kDim * kRowBytes;  // one [64][64] bf16 box
constexpr unsigned kFull = 0xffffffffu;
struct Params {
  const float* dt;
  const float* A;
  // The state hand-off ring, (B, H, ring, P, N) float32; the wrapper
  // chooses ring (kernels/ssd_scan.py::K3_RING, 2) and the entry refuses
  // fewer than two.  The block of chunk c reads s_in[c] from slot
  // c % ring and writes s_in[c + 1] to slot (c + 1) % ring.  Only
  // warpgroup 0 reads a slot, into registers, and it does so before it
  // writes or publishes anything.  So the slot that chunk c overwrites
  // last held s_in[c + 1 - ring], whose one reader (chunk c + 1 - ring)
  // finished loading it before it published the state that chunk c
  // acquired: two slots are enough.  A slot is never re-read.
  float* states;
  int ring;
  int* flags;     // (B, H), zero at launch: s_in[c] published at >= c
  int* tickets;   // one counter, zero at launch: blocks draw (h, c, b)
  void* y;        // (B, T, H, P) bf16, contiguous
  int T, H, G, nc;
  long long sdb, sdt, sdh;
};

// shared memory of the kernel: bf16 tiles (1024-aligned for the swizzle)
// C, B, x, W hi (then y), W lo, s_in hi, s_in lo, each of C, B, W and
// s_in as N / 64 boxes of 64 columns one after another; then acum2[Q],
// dt[Q], fac[Q], warp sums[8], the mbarrier and the block's ticket
template <int Q, int N>
struct Layout {
  static constexpr int kBoxes = N / kBoxCols;
  static constexpr int kTile = Q * kRowBytes;  // one [Q][64] bf16 box
  static constexpr int kBytes = 1024 + (4 * kBoxes + 1) * kTile +
                                2 * kBoxes * kStateTile + 4 * (3 * Q + 8) +
                                16;
};
static_assert(Layout<128, 64>::kBytes <= 232448 / 2, "two blocks per SM");
static_assert(Layout<128, 128>::kBytes <= 232448, "one block per SM");

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

// release / acquire of a (batch, head)'s counter at device scope (the
// CUTLASS semaphore's pattern: the block's stores, a barrier, then one
// release); the counter counts the states published, so it only grows
// and a value cannot be mistaken for an earlier round's
__device__ __forceinline__ void flag_release(int* flag, int value) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(flag), "r"(value)
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
// until the counter reaches value; traps after kWaitLimitNs
__device__ __forceinline__ void flag_wait(const int* flag, int value) {
  if (flag_acquire(flag) >= value) return;
  const unsigned long long t0 = global_ns();
  while (flag_acquire(flag) < value)
    if (global_ns() - t0 > kWaitLimitNs) __trap();
}
// bar.sync over the first warpgroup alone (barrier 0 is __syncthreads)
__device__ __forceinline__ void wg0_sync() {
  asm volatile("bar.sync 1, 128;" ::: "memory");
}

// One block per (head, chunk, batch), drawn from a ticket as the block
// starts, heads fastest, so that a chunk's predecessor has started
// before it; one warpgroup per 64 rows t.  Every product over N walks
// its 64-column boxes: the state's as one 64 x 64 accumulator per box,
// the others as K steps of 16 columns, four to a box.
//   1. all threads: acum, W = B dt exp(total - acum) (bf16 hi, lo);
//   2. warpgroup 0: S_c = x^T W; waits for s_in[c] (the head's counter
//      at c, published by chunk c - 1), publishes s_in[c + 1] = s_in[c]
//      exp(total) + S_c (the reference's expression, in that order, no
//      FMA contraction) and writes s_in[c] as bf16 hi, lo tiles; then
//      its own rows' y_intra;
//   3. warpgroup 1 meanwhile: its rows' y_intra over both 64-key halves;
//   4. both: y += exp(acum[t]) C s_in[c]^T; y through shared memory to
//      128-byte row stores.
// At N 64 two blocks share an SM (at most 128 registers a thread); at N
// 128 the block takes 178.5 KB of shared memory at Q 128, so one does,
// and the state's 64 accumulators and 64 loaded floats a thread of
// warpgroup 0 fit the 255 registers that leaves.
template <int Q, int N>
__global__ void __launch_bounds__(2 * Q, N == kDim ? 2 : 1)
ssd_scan_kernel_tc(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_b,
                   const __grid_constant__ CUtensorMap tm_c,
                   const Params p) {
  using L = Layout<Q, N>;
  constexpr int NB = L::kBoxes;
  constexpr int kStateElems = kDim * N;  // one ring slot
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sc = (raw + 1023u) & ~1023u;
  uint8_t* base = smem_raw + (sc - raw);
  const uint32_t sb = sc + NB * L::kTile, sx = sb + NB * L::kTile,
                 swh = sx + L::kTile, swl = swh + NB * L::kTile,
                 shi = swl + NB * L::kTile, slo = shi + NB * kStateTile;
  uint8_t* ybuf = base + (2 * NB + 1) * L::kTile;  // W hi, once S_c is taken
  float* acum2 = reinterpret_cast<float*>(
      base + (4 * NB + 1) * L::kTile + 2 * NB * kStateTile);  // [Q], log2
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
    mbar_expect_tx(bar, (2 * NB + 1) * L::kTile);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_load(sc + nb * L::kTile, &tm_c, bar, nb * kBoxCols, g, c * Q, b);
      tma_load(sb + nb * L::kTile, &tm_b, bar, nb * kBoxCols, g, c * Q, b);
    }
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

  // W over the B tile's (swizzled) layout, box by box: a 128-byte row of
  // a box is one token, whatever the order of its 16-byte chunks
  for (int e = tid; e < Q * 8; e += 2 * Q) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int off = nb * L::kTile + e * 16;
      const uint4 raw8 =
          *reinterpret_cast<const uint4*>(base + NB * L::kTile + off);
      const float w = fac[e >> 3];
      const __nv_bfloat162* pr =
          reinterpret_cast<const __nv_bfloat162*>(&raw8);
      float v[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(pr[i]);
        v[2 * i] = f.x * w;
        v[2 * i + 1] = f.y * w;
      }
      uint4 hi, lo;
      split8(v, hi, lo);
      *reinterpret_cast<uint4*>(base + (2 * NB + 1) * L::kTile + off) = hi;
      *reinterpret_cast<uint4*>(base + (3 * NB + 1) * L::kTile + off) = lo;
    }
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
    float d[NB][32];  // S_c, one 64 x 64 accumulator per box of N
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) d[nb][i] = 0.f;
      fence_regs(d[nb]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      const uint32_t k_off = kk * 16 * kRowBytes;  // 16 tokens
      const uint64_t da = sw128_desc(sx + k_off, kMNMajor);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const uint32_t w_off = nb * L::kTile + k_off;
        wgmma_ss<1, 1>(d[nb], da, sw128_desc(swh + w_off, kMNMajor), kk > 0);
        wgmma_ss<1, 1>(d[nb], da, sw128_desc(swl + w_off, kMNMajor), 1);
      }
    }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(d[nb]);

    // d[nb][4 jn + e]: p = ra or rb (e >> 1), n = 64 nb + 8 jn + 2 t4 +
    // (e & 1).  s_in[c] (0 for the first chunk) in the same layout, all
    // loads in flight at once; s_in[c + 1] = s_in[c] exp(total) + S_c to
    // the ring, then the counter publishes it; only then s_in[c] as bf16
    // hi, lo tiles [p][n], box by box, for C s_in^T (K-major, 128-byte
    // swizzle: the pair (n, n + 1) in chunk jn ^ (p & 7) of row p of box
    // nb), so that the hand-off waits for nothing else and the packed
    // pairs are never live with d
    float v[NB][32];
    if (c > 0) {
      if (tid == 0) flag_wait(p.flags + bh, c);
      wg0_sync();
      const float* src =
          p.states + (bh * p.ring + c % p.ring) * kStateElems;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int row = (i & 2) ? rb : ra;
          const float2 a = __ldcg(reinterpret_cast<const float2*>(
              src + row * N + nb * kBoxCols + 8 * (i >> 2) + 2 * t4));
          v[nb][i] = a.x;
          v[nb][i + 1] = a.y;
        }
      }
    } else {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int i = 0; i < 32; ++i) v[nb][i] = 0.f;
      }
    }
    if (c + 1 < p.nc) {
      const float decay = expf(total);
      float* dst =
          p.states + (bh * p.ring + (c + 1) % p.ring) * kStateElems;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int row = (i & 2) ? rb : ra;
          __stcg(reinterpret_cast<float2*>(dst + row * N + nb * kBoxCols +
                                           8 * (i >> 2) + 2 * t4),
                 make_float2(
                     __fadd_rn(__fmul_rn(v[nb][i], decay), d[nb][i]),
                     __fadd_rn(__fmul_rn(v[nb][i + 1], decay),
                               d[nb][i + 1])));
        }
      }
      wg0_sync();
      if (tid == 0) flag_release(p.flags + bh, c + 1);
    }
    uint8_t* s_tiles = base + (4 * NB + 1) * L::kTile;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = (i & 2) ? rb : ra, jn = i >> 2;
        uint32_t hi, lo;
        split2(v[nb][i], v[nb][i + 1], hi, lo);
        const int off = nb * kStateTile + row * kRowBytes +
                        ((jn ^ (row & 7)) << 4) + 4 * t4;
        *reinterpret_cast<uint32_t*>(s_tiles + off) = hi;
        *reinterpret_cast<uint32_t*>(s_tiles + NB * kStateTile + off) = lo;
      }
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
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t k_off = (kk >> 2) * L::kTile + (kk & 3) * 32;
      wgmma_ss<0, 0>(s, sw128_desc(c_rows + k_off, kKMajor),
                     sw128_desc(sb + hf * 64 * kRowBytes + k_off, kKMajor),
                     kk > 0);
    }
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
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t col = (kk & 3) * 32;  // 16 columns inside box kk / 4
      const uint64_t da =
          sw128_desc(c_rows + (kk >> 2) * L::kTile + col, kKMajor);
      const uint32_t s_off = (kk >> 2) * kStateTile + col;
      wgmma_ss<0, 0>(z, da, sw128_desc(shi + s_off, kKMajor), kk > 0);
      wgmma_ss<0, 0>(z, da, sw128_desc(slo + s_off, kKMajor), 1);
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

template <int Q, int N>
int launch(const CUtensorMap& mx, const CUtensorMap& mb,
           const CUtensorMap& mc, const Params& p, int B,
           cudaStream_t stream) {
  constexpr int bytes = Layout<Q, N>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel_tc<Q, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.H, p.nc, B);  // one block per ticket
  ssd_scan_kernel_tc<Q, N><<<grid, 2 * Q, bytes, stream>>>(mx, mb, mc, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, that a SIMT launch with these sizes
// needs; the wrapper refuses a call that needs more than a block has.
long long ssd_scan_smem_bytes(int Q, int P, int N) {
  return static_cast<long long>(smem_floats(Q, P, N) * sizeof(float));
}

// dtype: 0 float32, 1 bfloat16 (x, B, C and y); dt and A are float32.
// x (B, T, H, P), dt (B, T, H), B / C (B, T, G, N) at the given strides
// with unit stride over the last axis; A (H,) contiguous; y (B, T, H, P)
// contiguous.  Q divides T and is at most 128; Q, P and N are multiples
// of 4.
int ssd_scan_fwd(int dtype, const void* x, const void* dt, const void* A,
                 const void* Bm, const void* Cm, void* y, int B, int T, int H,
                 int G, int P, int N, int Q, long long sxb, long long sxt,
                 long long sxh, long long sdb, long long sdt, long long sdh,
                 long long sbb, long long sbt, long long sbg, long long scb,
                 long long sct, long long scg, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (Q > kTTiles * kTile || T % Q || Q % 4 || P % 4 || N % 4 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x, static_cast<const float*>(dt),
                 static_cast<const float*>(A), Bm, Cm, y, B, T, H, G, P, N,
                 Q, sxb, sxt, sxh, sdb, sdt, sdh, sbb, sbt, sbg, scb, sct,
                 scg};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core variant: bf16 x, B, C and y; P 64; N 64 or 128; Q 64
// or 128 dividing T; H a multiple of G; bases and (B, T, head or group)
// strides of x, B and C positive multiples of 16 bytes (the wrapper
// checks all of it first).  dt (B, T, H) float32 at the given strides, A (H,) contiguous,
// y (B, T, H, P) contiguous; states (B, H, ring, P, N) float32 (the
// ring, ring >= 2) and flags (B, H) int32 (one counter per head)
// workspaces, the flags followed by one more int32, the ticket counter,
// the flags and the ticket zero.  Returns cudaErrorInvalidValue for a
// call outside that rule and cudaErrorNotSupported if a tensor map cannot
// be encoded.
int ssd_scan_fwd_tc(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, void* y, void* states,
                    int ring, void* flags, int B, int T, int H, int G, int P,
                    int N, int Q, long long sxb, long long sxt, long long sxh,
                    long long sdb, long long sdt, long long sdh,
                    long long sbb, long long sbt, long long sbg,
                    long long scb, long long sct, long long scg,
                    void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const long long blocks = static_cast<long long>(B) * H * (T / Q);
  if (P != tc::kDim || (N != 64 && N != 128) || (Q != 64 && Q != 128) ||
      T % Q || T / Q > 65535 || G < 1 || H % G || blocks >= (1LL << 31) ||
      ring < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mb, mc;
  if (!tc::encode(&mx, x, tc::kDim, H, T, B, sxh, sxt, sxb, Q) ||
      !tc::encode(&mb, Bm, N, G, T, B, sbg, sbt, sbb, Q) ||
      !tc::encode(&mc, Cm, N, G, T, B, scg, sct, scb, Q))
    return static_cast<int>(cudaErrorNotSupported);
  const tc::Params p{static_cast<const float*>(dt),
                     static_cast<const float*>(A),
                     static_cast<float*>(states), ring,
                     static_cast<int*>(flags),
                     static_cast<int*>(flags) +
                         static_cast<long long>(B) * H,
                     y, T, H, G, T / Q, sdb, sdt, sdh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 64)
    return Q == 128 ? tc::launch<128, 64>(mx, mb, mc, p, B, s)
                    : tc::launch<64, 64>(mx, mb, mc, p, B, s);
  return Q == 128 ? tc::launch<128, 128>(mx, mb, mc, p, B, s)
                  : tc::launch<64, 128>(mx, mb, mc, p, B, s);
}

}  // extern "C"
