// Per-block MSCM products of the online path, for Hopper.
//
// Two entry points, one device routine:
//
//   mscm_fused_launch      replaces src/repro/kernels/mscm_kernel.py::mscm_fused
//                          (body _fused_body). For every block a:
//                            xg[r]  = x_dense[bq[a], clip(rows[bc[a], r], 0, Dp-1)]
//                            out[a] = xg [1, R] @ vals[bc[a]] [R, B]
//                          The gather from the dense query row happens here.
//   mscm_pregather_launch  replaces src/repro/kernels/mscm_kernel.py::mscm_pregather
//                          (body _pregather_body). For every block a:
//                            out[a] = xg[a] [1, R] @ vals[bc[a]] [R, B]
//                          with xg gathered beforehand (gather_query_rows).
//
// x_dense / xg and vals are float or bf16 (one type for both); the products
// accumulate in f32 and the output [A, B] is f32.
//
// What bounds it on an H100. One block reads a chunk tile of R*B values
// (63.5 KB in f32 at R = 496, B = 32) and R query values, and does 2*R*B
// flops: half a flop per byte, far under the ~20 FLOP/B at which f32 FMA on
// the CUDA cores would be the limit. At the batch shape (A = 640 blocks)
// bytes bound it. At the online shape (A = 10) the ~0.5 MB would move in
// ~0.14 us at 3.35 TB/s, so latency and the launch bound it: a trivial
// kernel already takes ~2.2 us a launch (chip_smoke.py's launch floor), and
// the rest is a chain of dependent round trips (the block ids, the tile,
// for fused the rows and then the gather, the cluster sum). One thread
// block per block, as before, put 10 SMs of 132 to work, each walking its
// 63.5 KB tile one 128-byte row a warp at a time.
//
// Design (the launch plan comes from repro_torch/kernels/mscm_kernel.py::
// block_launch_plan, which the CPU tests check):
//
// - R is split over a thread-block cluster of S CTAs (S <= 8, the portable
//   cluster size): CTA `rank` of cluster a takes rows [rank*rps, (rank+1)*rps)
//   of block a's chunk. At A = 10 that is S = 8: 80 SMs pull 8 KB each
//   instead of 10 pulling 63.5 KB; at A >= 132, S = 1.
// - Each CTA puts its whole slice in flight before it waits on anything: one
//   thread issues 1-D bulk copies (cp.async.bulk ... mbarrier::complete_tx)
//   of the slice of vals[c] and of its head (the slice of xg[a] for
//   pregather, of rows[c] for fused) into shared memory, each on its own
//   mbarrier. For fused the threads issue every x_dense[q, clip(rows)]
//   gather of the slice as soon as the rows have landed, while the tile is
//   still arriving. A slice too large for the shared-memory budget streams
//   through a ring of two slabs, each refilled as soon as it is consumed.
// - Bulk copies need 16-byte-aligned addresses and sizes. A plan whose
//   slices are not (R = 1037 in f32, odd R in bf16, a misaligned view) takes
//   the second staging path of the same kernel: ordinary loads, slab by slab.
// - Lanes run over the B columns (groups of 32 when B > 32), warps split the
//   slab's rows, each thread carries its column's sum with fmaf in f32 (bf16
//   is widened on use; no TF32). The warps' sums are added in warp order;
//   the other ranks of the cluster st.async their [B] partials into rank 0's
//   shared memory, counted in bytes by an mbarrier there, and exit; rank 0
//   adds the partials in rank order and stores the output. Only the one
//   cluster barrier that makes rank 0's mbarrier visible is paid, its
//   arrival early, behind the loads. No atomics, no second launch: for one
//   plan, two launches are bitwise equal.
//
// Any B: columns go in windows of `cols` columns (one window of all B
// whenever its buffers fit), cluster u = a * windows + w serving window w
// of block a with its own partials. A window splits columns, never R, so
// each output is summed in the same order as without windows. A window's
// tile rows lie at stride B, so they arrive one bulk copy a row, spread
// over warp 0's lanes.
//
// Chunk and query ids are clamped into range and rows clipped to
// [0, Dp-1], as the reference's gathers clamp. Padding rows hold the
// sentinel, whose query value is 0. The block list arrives sorted by chunk,
// so the clusters of neighbouring blocks read the same tile and L2 serves
// the repeats.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bulkcopy;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kMaxStages = 8;
constexpr size_t kMaxSmem = 232448;  // 227 KB, an H100 block's opt-in limit

enum DType { kF32 = 0, kBF16 = 1 };

// The launch plan (block_launch_plan): S CTAs a block and window, `rps`
// rows a slice, streamed in slabs of `slab` rows through `stages` buffers;
// `bulk` picks the staging path; windows of `cols` columns.
struct Plan {
  int S, rps, slab, stages, bulk, cols;
};

struct Args {
  const void* x;            // x_dense [n, Dp] (fused) or xg [A, R]
  const int32_t* rows;      // [C, R] (fused only)
  const void* vals;         // [C, R, B]
  const int64_t* block_q;   // [A] (fused only)
  const int64_t* block_c;   // [A]
  float* out;               // [A, B]
  int R, B, C, n;
  int64_t Dp;
  Plan p;
};

// Shared memory, in order: 2*stages + 1 mbarriers (head, tile, cluster
// sum), the warps' partials [kWarps, B], the cluster's partials
// [kMaxCluster, B] (filled in rank 0 only), then `stages` buffers, each a
// tile slab [slab, B], its query values [slab] and its rows [slab], where B
// is a window's (cols). block_smem_bytes in mscm_kernel.py repeats this sum.
struct Layout {
  size_t part, red, stage0, stage, xs, rows, total;  // the tile slab is at 0
  __host__ __device__ Layout(const Plan& p, int B, int es) {
    part = align16(8 * static_cast<size_t>(2 * p.stages + 1));
    red = part + align16(4 * static_cast<size_t>(kWarps) * B);
    stage0 = red + align16(4 * static_cast<size_t>(kMaxCluster) * B);
    xs = align16(static_cast<size_t>(p.slab) * B * es);
    rows = xs + align16(static_cast<size_t>(p.slab) * es);
    stage = rows + align16(4 * static_cast<size_t>(p.slab));
    total = stage0 + stage * p.stages;
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// The address of `p` (in this CTA's shared memory) at the same offset in
// CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(p)), "r"(rank));
  return remote;
}

// Stores `v` at `p` in CTA `rank`'s shared memory; the store completes 4
// bytes of the transaction count of `bar` there.
__device__ __forceinline__ void st_async_remote(float* p, float v, uint64_t* bar,
                                                uint32_t rank) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(
          cluster_addr(p, rank)),
      "f"(v), "r"(cluster_addr(bar, rank))
      : "memory");
}

// part_w[b] += sum over this warp's rows k of xs[k] * tile[k, b], for every
// column b of this lane, in row order (one fmaf chain per column); eight
// rows' loads are issued before their eight fmafs.
template <typename T>
__device__ __forceinline__ void slab_product(const T* tile, const T* xs, int n, int B,
                                             float* part_w, int warp, int lane) {
  constexpr int kIlp = 8;
  for (int b = lane; b < B; b += 32) {
    float acc = part_w[b];
    int k = warp;
    for (; k + (kIlp - 1) * kWarps < n; k += kIlp * kWarps) {
      float xv[kIlp], tv[kIlp];
#pragma unroll
      for (int i = 0; i < kIlp; ++i) {
        xv[i] = to_f32(xs[k + i * kWarps]);
        tv[i] = to_f32(tile[static_cast<size_t>(k + i * kWarps) * B + b]);
      }
#pragma unroll
      for (int i = 0; i < kIlp; ++i) acc = fmaf(xv[i], tv[i], acc);
    }
    for (; k < n; k += kWarps) {
      acc = fmaf(to_f32(xs[k]), to_f32(tile[static_cast<size_t>(k) * B + b]), acc);
    }
    part_w[b] = acc;
  }
}

// kFused: x is x_dense [n, Dp] and rows [C, R] gives the gather positions.
// Otherwise x is xg [A, R] and rows / block_q are unused. kWindowed: the
// plan cuts B into windows; without them a cluster serves a block, whole,
// and thread 0 issues the copies.
template <typename T, bool kFused, bool kWindowed>
__global__ void __launch_bounds__(kThreads) mscm_block_kernel(const Args args) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan p = args.p;
  const int R = args.R, B = args.B;
  const Layout lay(p, kWindowed ? p.cols : B, static_cast<int>(sizeof(T)));
  const int windows = kWindowed ? (B + p.cols - 1) / p.cols : 1;
  const int unit = static_cast<int>(blockIdx.x / p.S);  // this cluster: block a, window w
  const int a = kWindowed ? unit / windows : unit;
  const int b0 = kWindowed ? (unit - a * windows) * p.cols : 0;  // this window's first column
  const int Bw = kWindowed ? min(p.cols, B - b0) : B;
  uint64_t* hbar = reinterpret_cast<uint64_t*>(smem);  // [stages] head landed
  uint64_t* tbar = hbar + p.stages;                     // [stages] tile landed
  uint64_t* rbar = tbar + p.stages;                     // the other ranks' partials landed
  float* part = reinterpret_cast<float*>(smem + lay.part);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  auto stage = [&](int s) { return smem + lay.stage0 + s * lay.stage; };
  auto tile_of = [&](int s) { return reinterpret_cast<T*>(stage(s)); };
  auto xs_of = [&](int s) { return reinterpret_cast<T*>(stage(s) + lay.xs); };
  auto rows_of = [&](int s) { return reinterpret_cast<int32_t*>(stage(s) + lay.rows); };

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = rank * p.rps;
  const int nrows = min(R, row0 + p.rps) - row0;  // >= 1: the plan leaves no slice empty
  const int n_slabs = (nrows + p.slab - 1) / p.slab;

  const int64_t c = clamp64(args.block_c[a], args.C - 1);
  const T* vt = static_cast<const T*>(args.vals) + (static_cast<size_t>(c) * R + row0) * B + b0;
  const T* xrow;  // fused: the query's dense row; pregather: the slice of xg[a]
  const int32_t* rsl = nullptr;
  if constexpr (kFused) {
    xrow = static_cast<const T*>(args.x) +
           static_cast<size_t>(clamp64(args.block_q[a], args.n - 1)) * args.Dp;
    rsl = args.rows + static_cast<size_t>(c) * R + row0;
  } else {
    xrow = static_cast<const T*>(args.x) + static_cast<size_t>(a) * R + row0;
  }
  const int64_t dmax = args.Dp - 1;

  float* part_w = part + warp * Bw;
  for (int b = lane; b < Bw; b += 32) part_w[b] = 0.0f;

  auto slab_rows = [&](int j) { return min(p.slab, nrows - j * p.slab); };
  // Bulk path: thread 0 (kWindowed: warp 0) puts slab j of the slice in
  // flight into buffer s. Thread 0 arms both barriers and copies the head;
  // a window's tile rows go one copy a row, over warp 0's lanes.
  auto issue = [&](int j, int s) {
    const int r0 = j * p.slab, nr = slab_rows(j);
    const uint32_t row_bytes = static_cast<uint32_t>(Bw) * sizeof(T);
    if (lane == 0) {
      if constexpr (kFused) {
        mbar_expect(&hbar[s], nr * 4u);
        bulk_load(rows_of(s), rsl + r0, nr * 4u, &hbar[s]);
      } else {
        mbar_expect(&hbar[s], nr * static_cast<uint32_t>(sizeof(T)));
        bulk_load(xs_of(s), xrow + r0, nr * static_cast<uint32_t>(sizeof(T)), &hbar[s]);
      }
      mbar_expect(&tbar[s], nr * row_bytes);
    }
    if constexpr (!kWindowed) {
      bulk_load(tile_of(s), vt + static_cast<size_t>(r0) * B, nr * row_bytes, &tbar[s]);
    } else {
      __syncwarp();
      for (int k = lane; k < nr; k += 32) {
        bulk_load(tile_of(s) + static_cast<size_t>(k) * Bw, vt + static_cast<size_t>(r0 + k) * B,
                  row_bytes, &tbar[s]);
      }
    }
  };
  // Fused: the query values of slab j from its rows in buffer s.
  auto gather = [&](int j, int s) {
    const int nr = slab_rows(j);
    const int32_t* rs = rows_of(s);
    T* xs = xs_of(s);
#pragma unroll 4
    for (int k = tid; k < nr; k += kThreads) xs[k] = xrow[clamp64(rs[k], dmax)];
  };

  const int first = min(p.stages, n_slabs);
  if (tid == 0) {
    if (p.bulk) {
      for (int s = 0; s < p.stages; ++s) {
        mbar_init(&hbar[s], 1);
        mbar_init(&tbar[s], 1);
      }
    }
    if (rank == 0 && p.S > 1) {
      mbar_init(rbar, 1);  // one arrival, and the other ranks' partials as bytes
      mbar_expect(rbar, static_cast<uint32_t>(p.S - 1) * Bw * 4u);
    }
    fence_mbar_init();
    if (!kWindowed && p.bulk) {
      for (int j = 0; j < first; ++j) issue(j, j);
    }
  }
  if (kWindowed && warp == 0 && p.bulk) {
    __syncwarp();
    for (int j = 0; j < first; ++j) issue(j, j);
  }
  __syncthreads();  // the barriers are initialised before anyone waits
  // Rank 0's barrier is initialised before another rank stores to it: this
  // arrival pairs with the wait before the cluster sum, so the loads hide it.
  if (p.S > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  if (p.bulk) {
    if constexpr (kFused) {
      // Every gather of the slabs in flight, while their tiles still arrive.
      for (int j = 0; j < first; ++j) {
        mbar_wait(&hbar[j], 0);
        gather(j, j);
      }
      __syncthreads();
    }
    for (int j = 0; j < n_slabs; ++j) {
      const int s = j % p.stages;
      const uint32_t parity = (j / p.stages) & 1;
      if (kFused && j >= first) {
        mbar_wait(&hbar[s], parity);
        gather(j, s);
        __syncthreads();
      }
      if (!kFused) mbar_wait(&hbar[s], parity);
      mbar_wait(&tbar[s], parity);
      slab_product(tile_of(s), xs_of(s), slab_rows(j), Bw, part_w, warp, lane);
      if (j + p.stages < n_slabs) {
        __syncthreads();  // buffer s is consumed: refill it
        if (kWindowed ? warp == 0 : tid == 0) {
          fence_proxy_async();
          issue(j + p.stages, s);
        }
      }
    }
  } else {
    // Ordinary loads, slab by slab, through buffer 0.
    T* tile = tile_of(0);
    T* xs = xs_of(0);
    for (int j = 0; j < n_slabs; ++j) {
      const int r0 = j * p.slab, nr = slab_rows(j);
      const T* src = vt + static_cast<size_t>(r0) * B;
      for (int i = tid; i < nr * Bw; i += kThreads) {
        if constexpr (kWindowed) {
          const int k = i / Bw;
          tile[i] = src[static_cast<size_t>(k) * B + (i - k * Bw)];
        } else {
          tile[i] = src[i];
        }
      }
      for (int k = tid; k < nr; k += kThreads) {
        if constexpr (kFused) {
          xs[k] = xrow[clamp64(rsl[r0 + k], dmax)];
        } else {
          xs[k] = xrow[r0 + k];
        }
      }
      __syncthreads();
      slab_product(tile, xs, nr, Bw, part_w, warp, lane);
      __syncthreads();  // the slab is consumed before the next overwrites it
    }
  }

  __syncthreads();  // every warp's partial is in shared memory
  if (p.S > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // The CTA's partial, warps in order, into row `rank` of rank 0's partials:
  // the other ranks store theirs asynchronously, counted by rank 0's barrier,
  // and exit; rank 0 outlives them, since it waits for their bytes.
  for (int b = tid; b < Bw; b += kThreads) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w * Bw + b];
    if (rank == 0) {
      red[b] = s;
    } else {
      st_async_remote(red + rank * Bw + b, s, rbar, 0);
    }
  }
  if (rank != 0) return;
  if (p.S > 1) mbar_wait(rbar, 0);  // each thread reads back its own red[b]
  for (int b = tid; b < Bw; b += kThreads) {
    float s = 0.0f;
    for (int r = 0; r < p.S; ++r) s += red[r * Bw + b];
    args.out[static_cast<size_t>(a) * B + b0 + b] = s;
  }
}

template <typename T, bool kFused>
int launch_typed(const Args& args, int A, cudaStream_t stream) {
  const Plan& p = args.p;
  const size_t smem = Layout(p, p.cols, static_cast<int>(sizeof(T))).total;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = p.cols < args.B ? mscm_block_kernel<T, kFused, true>
                                : mscm_block_kernel<T, kFused, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  const int64_t grid = static_cast<int64_t>(A) * p.S * ((args.B + p.cols - 1) / p.cols);
  if (grid > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Rejects a plan the kernel cannot run: slices that miss rows or leave one
// empty, windows that miss columns, and, for the bulk
// path, a slab, a window's row or an address off 16 bytes.
bool plan_ok(const Args& args, int es, bool fused) {
  const Plan& p = args.p;
  if (p.S < 1 || p.S > kMaxCluster || p.rps < 1 || p.slab < 1 || p.stages < 1 ||
      p.stages > kMaxStages || static_cast<int64_t>(p.S - 1) * p.rps >= args.R ||
      static_cast<int64_t>(p.S) * p.rps < args.R || p.cols < 1 || p.cols > args.B ||
      (p.cols < args.B && p.cols % 16 != 0)) {
    return false;
  }
  if (!p.bulk) return true;
  const int head = fused ? 4 : es;  // bytes a row of the slice's head
  // A window's tile rows go one copy a row: only B's rows need 16 bytes.
  const int64_t tile_row = p.cols < args.B ? 0 : static_cast<int64_t>(args.B) * es;
  auto rows16 = [&](int64_t rows) {
    return (rows * tile_row) % 16 == 0 && (rows * head) % 16 == 0;
  };
  return rows16(args.R) && rows16(p.rps) && rows16(p.slab) &&
         (p.cols == args.B || (static_cast<int64_t>(args.B) * es) % 16 == 0) &&
         aligned16(args.vals) && aligned16(fused ? static_cast<const void*>(args.rows) : args.x);
}

template <bool kFused>
int launch(const Args& args, int A, int dtype, void* stream) {
  if (A < 0 || args.R <= 0 || args.B <= 0 || args.C <= 0 ||
      (kFused && (args.n <= 0 || args.Dp <= 0)) || (dtype != kF32 && dtype != kBF16) ||
      !plan_ok(args, dtype == kF32 ? 4 : 2, kFused)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (A == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == kF32 ? launch_typed<float, kFused>(args, A, s)
                       : launch_typed<__nv_bfloat16, kFused>(args, A, s);
}

}  // namespace

// Both launch on `stream` and return the launch's CUDA error (0 on
// success). The plan (S, rps, slab, stages, bulk, cols) is
// block_launch_plan's.
// The caller allocates `out`; nothing here allocates or synchronises.
extern "C" int mscm_fused_launch(const void* x_dense, const int32_t* rows, const void* vals,
                                 const int64_t* block_q, const int64_t* block_c, float* out,
                                 int A, int64_t Dp, int R, int B, int C, int n, int dtype, int S,
                                 int rps, int slab, int stages, int bulk, int cols,
                                 void* stream) {
  if (rows == nullptr || block_q == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args args{x_dense, rows, vals, block_q, block_c, out, R, B, C, n, Dp,
                  Plan{S, rps, slab, stages, bulk, cols}};
  return launch<true>(args, A, dtype, stream);
}

extern "C" int mscm_pregather_launch(const void* xg, const void* vals, const int64_t* block_c,
                                     float* out, int A, int R, int B, int C, int dtype, int S,
                                     int rps, int slab, int stages, int bulk, int cols,
                                     void* stream) {
  const Args args{xg, nullptr, vals, nullptr, block_c, out, R, B, C, 1, 1,
                  Plan{S, rps, slab, stages, bulk, cols}};
  return launch<false>(args, A, dtype, stream);
}
