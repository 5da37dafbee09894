// K1: masked move-selection reduction for the batched Equilibrium planner.
//
// Replaces the Pallas kernel src/repro/kernels/select_move.py
// masked_select_fwd (body _select_kernel).  For each row m of a (M, D)
// legality matrix it returns
//   any[m] = the row has a legal destination,
//   dst[m] = argmin over d of (valid[m,d] ? util[d] : +inf), first
//            occurrence on ties (the lowest device index), which is 0 for a
//            row with no legal destination.
// That is the lexicographic minimum of (masked util, index), the order
// legality.shard_winner_better folds in the JAX package.
//
// Bound on Hopper: the kernel reads M*D bytes of mask plus D*sizeof(T) of
// util and writes 5*M bytes; it does one comparison per element, so it is
// memory-bound (3.35 TB/s on an H100 SXM): the cluster-B step,
// M = 25*184 = 4600 rows by D = 995 devices, moves about 4.6 MB.
//
// Design: one warp per row, lanes striding over D so a warp reads 32
// neighbouring mask bytes per iteration; each lane keeps its running
// (value, index) minimum, visiting its indices in ascending order, and the
// warp folds the 32 candidates with __shfl_down_sync under the same
// lexicographic order.  util stays in its own type (float64 on the planner
// path).  The kernel only compares values, with no float arithmetic, so
// FMA contraction cannot change a result.  It allocates nothing and never
// synchronises: outputs come from the caller, the launch goes on the
// caller's stream, and the C entry points return cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ T pos_inf();
template <>
__device__ __forceinline__ float pos_inf<float>() { return CUDART_INF_F; }
template <>
__device__ __forceinline__ double pos_inf<double>() { return CUDART_INF; }

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_select_kernel(const uint8_t* __restrict__ valid, long long row_stride,
                     const T* __restrict__ util, int M, int D,
                     uint8_t* __restrict__ any_out,
                     int32_t* __restrict__ dst_out) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  if (row >= M) return;  // whole warps exit together: M rows, 1 warp each
  const uint8_t* v = valid + row * row_stride;

  bool found = false;
  T best = pos_inf<T>();
  int best_idx = lane < D ? lane : INT32_MAX;  // first index this lane sees
  for (int d = lane; d < D; d += kWarp) {
    const bool ok = v[d] != 0;
    const T m = ok ? util[d] : pos_inf<T>();
    found |= ok;
    if (m < best) {  // ascending d: a tie keeps the lower index
      best = m;
      best_idx = d;
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const T ob = __shfl_down_sync(kFull, best, off);
    const int oi = __shfl_down_sync(kFull, best_idx, off);
    const int of = __shfl_down_sync(kFull, static_cast<int>(found), off);
    found |= (of != 0);
    if (ob < best || (ob == best && oi < best_idx)) {
      best = ob;
      best_idx = oi;
    }
  }
  if (lane == 0) {
    any_out[row] = found ? 1 : 0;
    dst_out[row] = best_idx;
  }
}

template <typename T>
int launch(const void* valid, long long row_stride, const void* util, int M,
           int D, void* any_out, void* dst_out, void* stream) {
  if (M > 0 && D > 0) {
    const long long threads = static_cast<long long>(M) * kWarp;
    const unsigned blocks =
        static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    masked_select_kernel<T><<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(valid), row_stride,
        static_cast<const T*>(util), M, D, static_cast<uint8_t*>(any_out),
        static_cast<int32_t*>(dst_out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int masked_select_f32(const void* valid, long long row_stride,
                      const void* util, int M, int D, void* any_out,
                      void* dst_out, void* stream) {
  return launch<float>(valid, row_stride, util, M, D, any_out, dst_out,
                       stream);
}

int masked_select_f64(const void* valid, long long row_stride,
                      const void* util, int M, int D, void* any_out,
                      void* dst_out, void* stream) {
  return launch<double>(valid, row_stride, util, M, D, any_out, dst_out,
                        stream);
}

}  // extern "C"
