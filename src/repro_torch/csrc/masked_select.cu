// K1: move selection for the batched Equilibrium planner, two kernels.
//
// Both replace the Pallas kernel src/repro/kernels/select_move.py
// masked_select_fwd (body _select_kernel), which reduces a (M, D) legality
// matrix per row to
//   any[m] = the row has a legal destination,
//   dst[m] = argmin over d of (valid[m,d] ? util[d] : +inf), first
//            occurrence on ties (the lowest device index), which is 0 for a
//            row with no legal destination.
// That is the lexicographic minimum of (masked util, index), the order
// legality.shard_winner_better folds in the JAX package.  Both kernels fold
// it the same way (warp_fold_min): one warp per row, lanes striding over
// the devices in ascending order, each lane keeping its running (value,
// index) minimum, then a __shfl_down_sync fold under the same order.
//
// masked_select_kernel is that reduction over a mask in device memory, the
// port's counterpart of the JAX package's public masked_select_fwd.  It
// reads M*D bytes of mask and does one comparison per element, so it is
// memory-bound (3.35 TB/s on an H100 SXM).  It compares values only, so
// FMA contraction cannot change a result.
//
// select_rows_kernel is the planner step's selection fused into one
// launch: it evaluates every criterion of a candidate move for the k
// sources' shard rows against every device, and reduces as above, so the
// (k, R, n) legality mask and the (k, R, S, n) member and domain tests
// never reach device memory (on the TPU the Pallas step kept them in
// VMEM).  Per (source s, row r, device d):
//   static     class match, d not a member of the row's PG, d's failure
//              domain at the row's level held by no other slot of the
//              row's rule step (acting table, padded slots -1);
//   candidate  static, capacity (used[d] + size <= cap_lim[d]), the
//              destination-count criterion dst_ok[pool, d], the source-count
//              criterion, a real row (rows_on >= 0), d != src, d "in", and
//              the emptiest-first cutoff (d strictly before src in the
//              stable (util, index) order);
//   valid      candidate and the exact float64 variance test.
// Outputs: any and dst per (s, r) as above (any only for the available
// sources, s < n_avail), and cand_src[s]: some row of s has a candidate.
// The expressions are those of repro_torch/core/legality.py in its operand
// order, each float64 add, subtract, multiply and divide written as the
// _rn intrinsic: the build's flags leave FMA contraction on, and the
// intrinsics are never contracted, so every result is bit-identical to the
// plain PyTorch version.  x ** 2 is x * x there too, and / n_dev is a true
// division by the device tensor n_f.
//
// Bound on Hopper: operations.  At cluster B's step (k 25, R 184, n 995,
// S 11) the kernel reads under 1 MB, but evaluates 4.58 M (row, device)
// pairs: a handful of predicates each, 2 S integer compares for those that
// pass them, and about 14 float64 operations and three divisions for each
// candidate.  Design: one block of 8 warps per (source, tile of rows), the
// blocks of one source forming a thread-block cluster; each block stages
// the (n,) device vectors (util, used, cap, cap_lim, class, in, and the
// failure-domain ids of every level) in shared memory once; a warp takes
// one row at a time, puts the row's acting slots and peer domains in
// shared memory, and strides its lanes over the devices in ascending
// order.  The source's cand_src bit is the OR of its blocks' flags, which
// each block writes into the cluster's first block through distributed
// shared memory, so no output needs zeroing before the launch.  Where the
// staged vectors do not fit a block's shared memory (n above about 4,370
// at L 4) a second instantiation reads them from device memory instead;
// at cluster B's first step it takes 0.098 ms on the device against the
// staged one's 0.057 (chip_smoke.py phase 1, H100 SXM at 700 W), which
// is why the staged one is the rule.
//
// Neither kernel allocates or synchronises: outputs come from the caller,
// the launch goes on the caller's stream, and each C entry point returns
// the launch's CUDA error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

namespace cg = cooperative_groups;

// The carry as the planner keeps it, every field 8 bytes wide, as one
// list of (type, name): the struct below and the names that
// select_rows_fields() gives the wrapper (kernels/select_move.py) both
// come from it, and the wrapper fills each field by name.  Integer
// tensors are int64, masks bool (one byte), the rest float64; every
// tensor is contiguous; scalars are 1-element device tensors.
#define SELECT_ROWS_FIELDS(X)                                               \
  X(const long long*, src_order)   /* (k,) the step's source order */       \
  X(const long long*, n_avail)     /* () sources not parked */              \
  X(const long long*, rows_on)     /* (n, R) shard rows, -1 padded */       \
  X(const long long*, acting)      /* (n_pg, S) acting, -1 padded */        \
  X(const uint8_t*, dst_ok)        /* (P, n) destination-count test */      \
  X(const double*, pool_counts)    /* (P, n) */                             \
  X(const double*, ideal)          /* (P, n) */                             \
  X(const double*, used)           /* (n,) */                               \
  X(const double*, util)           /* (n,) */                               \
  X(const double*, cap)            /* (n,) */                               \
  X(const double*, cap_lim)        /* (n,) capacity under the headroom */   \
  X(const long long*, dev_class)   /* (n,) */                               \
  X(const uint8_t*, dev_in)        /* (n,) */                               \
  X(const long long*, dev_domain)  /* (L, n) failure-domain ids */          \
  X(const long long*, sh_pg)       /* per shard row: its PG, */             \
  X(const long long*, sh_pool)     /*   pool, */                            \
  X(const long long*, sh_class)    /*   rule step's class (-1: any), */     \
  X(const long long*, sh_level)    /*   failure-domain level, */            \
  X(const long long*, sh_slot)     /*   slot in the acting set, */          \
  X(const long long*, sh_sbase)    /*   rule step's first slot */           \
  X(const long long*, sh_scnt)     /*   and slot count, */                  \
  X(const double*, sh_size)        /*   and bytes */                        \
  X(const double*, us)             /* (1,) sum of util */                   \
  X(const double*, usq)            /* (1,) sum of util squared */           \
  X(const double*, n_f)            /* () n as float64 */                    \
  X(const double*, slack)          /* () count slack */                     \
  X(const double*, min_dvar)       /* () least variance decrease */         \
  X(uint8_t*, any_out)             /* (k, R) */                             \
  X(int32_t*, dst_out)             /* (k, R) */                             \
  X(uint8_t*, cand_src)            /* (k,) */                               \
  X(long long, k)                                                           \
  X(long long, R)                                                           \
  X(long long, n)                                                           \
  X(long long, S)                                                           \
  X(long long, L)

struct SelectRowsArgs {
#define SELECT_ROWS_FIELD(type, name) type name;
  SELECT_ROWS_FIELDS(SELECT_ROWS_FIELD)
#undef SELECT_ROWS_FIELD
};

#define SELECT_ROWS_ONE(type, name) +1
static_assert(sizeof(SelectRowsArgs) == 8 * (0 SELECT_ROWS_FIELDS(
                                                 SELECT_ROWS_ONE)),
              "every field of SelectRowsArgs is 8 bytes");
#undef SELECT_ROWS_ONE

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

// The warp's lexicographic minimum of (value, index) over its lanes, and
// whether any lane found a legal destination; lane 0 holds the result.
template <typename T>
__device__ __forceinline__ void warp_fold_min(bool& found, T& best,
                                              int& best_idx) {
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
}

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
  warp_fold_min(found, best, best_idx);
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

// ---------------------------------------------------------------------------
// select_rows

// float64 arithmetic that the compiler may not contract into an FMA.
__device__ __forceinline__ double dadd(double x, double y) {
  return __dadd_rn(x, y);
}
__device__ __forceinline__ double dsub(double x, double y) {
  return __dsub_rn(x, y);
}
__device__ __forceinline__ double dmul(double x, double y) {
  return __dmul_rn(x, y);
}
__device__ __forceinline__ double ddiv(double x, double y) {
  return __ddiv_rn(x, y);
}

constexpr int kSelWarps = 8;
constexpr int kSelThreads = kSelWarps * kWarp;
constexpr int kMaxCluster = 8;  // the portable cluster size

// Shared memory of the staged (n,) device vectors: four float64 vectors,
// then class and the L levels' domain ids as int32, then the in flags.
__host__ __device__ constexpr long long staged_bytes(long long n,
                                                     long long L) {
  return (4 * 8 * n + 4 * (L + 1) * n + n + 15) / 16 * 16;
}

// Each warp's acting slots and peer domains for its current row.
__host__ __device__ constexpr long long slot_bytes(long long S) {
  return kSelWarps * 2 * S * 4;
}

template <bool kStaged>
__global__ void __launch_bounds__(kSelThreads)
select_rows_kernel(const SelectRowsArgs a) {
  // int32 ids in shared memory, the carry's int64 ones in device memory
  using Id = typename std::conditional<kStaged, int, long long>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int block_flags[kMaxCluster];  // read in the cluster's block 0
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(a.n);
  const int R = static_cast<int>(a.R);
  const int S = static_cast<int>(a.S);
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;

  const double *util = a.util, *used = a.used, *cap = a.cap,
               *cap_lim = a.cap_lim;
  const Id *dev_class, *dev_domain;
  const uint8_t* dev_in = a.dev_in;
  int* slots;
  if constexpr (kStaged) {
    const int L = static_cast<int>(a.L);
    double* f = reinterpret_cast<double*>(smem);
    int* ids = reinterpret_cast<int*>(f + 4 * n);
    uint8_t* in = reinterpret_cast<uint8_t*>(ids + (L + 1) * n);
    for (int i = threadIdx.x; i < n; i += kSelThreads) {
      f[i] = a.util[i];
      f[n + i] = a.used[i];
      f[2 * n + i] = a.cap[i];
      f[3 * n + i] = a.cap_lim[i];
      ids[i] = static_cast<int>(a.dev_class[i]);
      for (int l = 0; l < L; ++l)
        ids[(l + 1) * n + i] =
            static_cast<int>(a.dev_domain[static_cast<long long>(l) * n + i]);
      in[i] = a.dev_in[i];
    }
    util = f;
    used = f + n;
    cap = f + 2 * n;
    cap_lim = f + 3 * n;
    dev_class = ids;
    dev_domain = ids + n;
    dev_in = in;
    slots = reinterpret_cast<int*>(smem + staged_bytes(a.n, a.L));
  } else {
    dev_class = a.dev_class;
    dev_domain = a.dev_domain;
    slots = reinterpret_cast<int*>(smem);
  }
  // the staged vectors are visible to the block, and every block of the
  // cluster has started (so block 0's flags may be written)
  cluster.sync();

  // the source, and what depends on it alone
  const int js = blockIdx.y;
  const long long src = a.src_order[js];
  const bool avail = js < *a.n_avail;
  const double u_s = util[src], used_s = used[src], cap_s = cap[src];
  const double us = *a.us, usq = *a.usq, nf = *a.n_f, slack = *a.slack;
  const double neg_min = -*a.min_dvar;
  const double mean = ddiv(us, nf);
  const double old_var = dsub(ddiv(usq, nf), dmul(mean, mean));
  const double usq_src = dmul(u_s, u_s);
  int* w_act = slots + warp * 2 * S;
  int* w_peer = w_act + S;

  bool any_cand = false;
  for (int r = blockIdx.x * kSelWarps + warp; r < R;
       r += gridDim.x * kSelWarps) {
    const long long row = a.rows_on[src * R + r];  // warp-uniform
    long long pool = 0;
    bool live = false;  // a real row whose source-count criterion holds
    if (row >= 0) {
      pool = a.sh_pool[row];
      const double cnt = a.pool_counts[pool * n + src];
      const double idl = a.ideal[pool * n + src];
      live = fabs(dsub(dsub(cnt, 1.0), idl)) <=
             dadd(fabs(dsub(cnt, idl)), slack);
    }
    bool found = false;
    double best = CUDART_INF;
    int best_idx = lane < n ? lane : INT32_MAX;
    if (live) {
      const long long pg = a.sh_pg[row], slot = a.sh_slot[row];
      const long long sbase = a.sh_sbase[row], scnt = a.sh_scnt[row];
      const long long cls = a.sh_class[row];
      const double size = a.sh_size[row];
      const Id* dom = dev_domain + a.sh_level[row] * n;
      __syncwarp();  // every lane is done with the previous row's slots
      for (int j = lane; j < S; j += kWarp) {
        const long long act = a.acting[pg * S + j];
        const bool in_step = sbase <= j && sbase + scnt > j && slot != j;
        w_act[j] = static_cast<int>(act);
        // domain ids are >= 0; a padded slot clamps to device 0
        w_peer[j] = in_step ? static_cast<int>(dom[act < 0 ? 0 : act]) : -1;
      }
      __syncwarp();
      const double v_s = ddiv(dsub(used_s, size), cap_s);
      const double dsum_s = dsub(v_s, u_s);
      const double dsq_s = dsub(dmul(v_s, v_s), usq_src);
      const uint8_t* crit = a.dst_ok + pool * n;
      for (int d = lane; d < n; d += kWarp) {
        const double ud = util[d];
        const double fill = dadd(used[d], size);
        if (!(dev_in[d] && d != src && (ud < u_s || (ud == u_s && d < src)) &&
              (cls < 0 || dev_class[d] == cls) && crit[d] &&
              fill <= cap_lim[d]))
          continue;
        const int dom_d = static_cast<int>(dom[d]);
        bool taken = false;
        for (int j = 0; j < S; ++j)
          taken |= (w_act[j] == d) | (w_peer[j] == dom_d);
        if (taken) continue;
        any_cand = true;
        // legality.variance_improves
        const double v_d = ddiv(fill, cap[d]);
        const double dsum = dadd(dsum_s, dsub(v_d, ud));
        const double dsq = dadd(dsq_s, dsub(dmul(v_d, v_d), dmul(ud, ud)));
        const double m = ddiv(dadd(us, dsum), nf);
        const double new_var = dsub(ddiv(dadd(usq, dsq), nf), dmul(m, m));
        if (!(dsub(new_var, old_var) < neg_min)) continue;
        found = true;
        if (ud < best) {  // ascending d: a tie keeps the lower index
          best = ud;
          best_idx = d;
        }
      }
    }
    warp_fold_min(found, best, best_idx);
    if (lane == 0) {
      const long long out = static_cast<long long>(js) * R + r;
      a.any_out[out] = found && avail ? 1 : 0;
      a.dst_out[out] = best_idx;
    }
  }

  const int block_any = __syncthreads_or(any_cand);
  if (threadIdx.x == 0)
    cluster.map_shared_rank(block_flags, 0)[cluster.block_rank()] = block_any;
  cluster.sync();  // block 0 holds every flag; no block reads another after
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    int any = 0;
    for (unsigned b = 0; b < cluster.num_blocks(); ++b) any |= block_flags[b];
    a.cand_src[js] = any ? 1 : 0;
  }
}

constexpr int kMaxDevices = 64;

template <bool kStaged>
int launch_select_rows(const SelectRowsArgs& a, long long smem,
                       cudaStream_t stream) {
  // the dynamic shared memory each device already allows the kernel: the
  // attribute is set when a launch needs more, not on every launch
  static std::atomic<long long> allowed[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices || smem > allowed[device].load()) {
    err = cudaFuncSetAttribute(select_rows_kernel<kStaged>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kMaxDevices) allowed[device].store(smem);
  }
  // one cluster per source, as many blocks as cover R rows at 8 a block
  const unsigned width = static_cast<unsigned>(
      std::min<long long>(kMaxCluster, (a.R + kSelWarps - 1) / kSelWarps));
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = width;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(width, static_cast<unsigned>(a.k), 1);
  cfg.blockDim = dim3(kSelThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, select_rows_kernel<kStaged>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
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

// The names of SelectRowsArgs's fields in order, space-separated, and
// its size: the wrapper builds its copy of the struct from these.
const char* select_rows_fields() {
#define SELECT_ROWS_NAME(type, name) #name " "
  return SELECT_ROWS_FIELDS(SELECT_ROWS_NAME);
#undef SELECT_ROWS_NAME
}

long long select_rows_args_bytes() { return sizeof(SelectRowsArgs); }

// One launch over the carry in ``a``; stages the device vectors in shared
// memory when they fit in ``smem_limit`` bytes (a negative limit: the
// most a block of the current device may opt in to), else reads them
// from device memory.  k < 65536, R >= 1.
int select_rows(const SelectRowsArgs* a, long long smem_limit, void* stream) {
  if (a->k <= 0) return 0;
  if (a->R <= 0 || a->k > 65535 || a->n <= 0 || a->n >= INT32_MAX ||
      a->R * a->k >= INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_limit < 0) {
    int device = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_limit = optin;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long staged = staged_bytes(a->n, a->L) + slot_bytes(a->S);
  const long long static_bytes = sizeof(int) * kMaxCluster;  // block_flags
  if (staged + static_bytes <= smem_limit)
    return launch_select_rows<true>(*a, staged, s);
  return launch_select_rows<false>(*a, slot_bytes(a->S), s);
}

}  // extern "C"
