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
// What bounds it on an H100: memory bandwidth. One block reads a chunk tile
// of R*B values (63.5 KB in f32 at R = 496, B = 32) and R query values, and
// does 2*R*B flops: about half a flop per byte, far under the ~20 FLOP/B at
// which f32 FMA on the CUDA cores (67 TFLOP/s over 3.35 TB/s) would be the
// limit. At the online shape (10 blocks a level) the launch itself costs
// more than the bytes.
//
// Design: one thread block per block a, which reads its own chunk and query
// ids (the TPU kernel had them scalar-prefetched) and clamps them into
// range, as the reference's gathers clamp. The R query values go through
// shared memory in slabs: `fused` gathers them from the dense row at the
// chunk's (clipped) rows, `pregather` copies them from xg[a]. Lanes run over
// the B columns (a loop over groups of 32 when B > 32), so each row of the
// chunk tile is one coalesced load a warp; the 8 warps split the rows, each
// thread accumulates its column with fmaf (no TF32), and a fixed-order sum
// over the warps' partials in shared memory gives the output. The block
// list arrives sorted by chunk, so consecutive blocks read the same chunk
// tile and L2 serves the repeats. Padding rows hold the sentinel, whose
// query value is 0, and ragged slab edges are masked. cp.async/TMA staging
// and several blocks of one chunk per thread block are later work: this
// version is the simple, exact one.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = 1024;  // query values staged per pass (4 KB)

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// kFused: x is x_dense [n, Dp] and rows [C, R] gives the gather positions.
// Otherwise x is xg [A, R] and rows / block_q are unused.
template <typename T, bool kFused>
__global__ void __launch_bounds__(kThreads)
mscm_block_kernel(const T* __restrict__ x,
                  const int32_t* __restrict__ rows,
                  const T* __restrict__ vals,          // [C, R, B]
                  const int64_t* __restrict__ block_q,  // [A]
                  const int64_t* __restrict__ block_c,  // [A]
                  float* __restrict__ out,              // [A, B]
                  int R, int B, int C, int n, int64_t Dp) {
  __shared__ float xs[kSlab];
  __shared__ float part[kWarps][32];

  const int a = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t c = clamp64(block_c[a], C - 1);
  const T* vt = vals + static_cast<size_t>(c) * R * B;
  const T* xrow;
  const int32_t* rrow = nullptr;
  if constexpr (kFused) {
    xrow = x + static_cast<size_t>(clamp64(block_q[a], n - 1)) * Dp;
    rrow = rows + static_cast<size_t>(c) * R;
  } else {
    xrow = x + static_cast<size_t>(a) * R;
  }

  for (int b0 = 0; b0 < B; b0 += 32) {
    const int b = b0 + lane;
    float acc = 0.0f;
    for (int r0 = 0; r0 < R; r0 += kSlab) {
      const int depth = min(kSlab, R - r0);
      __syncthreads();  // the previous slab is fully consumed
      for (int k = threadIdx.x; k < depth; k += kThreads) {
        if constexpr (kFused) {
          xs[k] = to_f32(xrow[clamp64(rrow[r0 + k], Dp - 1)]);
        } else {
          xs[k] = to_f32(xrow[r0 + k]);
        }
      }
      __syncthreads();
      if (b < B) {
        const T* vcol = vt + static_cast<size_t>(r0) * B + b;
        for (int k = warp; k < depth; k += kWarps) {
          acc = fmaf(xs[k], to_f32(vcol[static_cast<size_t>(k) * B]), acc);
        }
      }
    }
    part[warp][lane] = acc;
    __syncthreads();
    if (warp == 0 && b < B) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += part[w][lane];
      out[static_cast<size_t>(a) * B + b] = s;
    }
    // The next column group's first __syncthreads orders these reads before
    // part is written again.
  }
}

template <bool kFused>
int launch(const void* x, const int32_t* rows, const void* vals,
           const int64_t* block_q, const int64_t* block_c, float* out, int A,
           int R, int B, int C, int n, int64_t Dp, int dtype, void* stream) {
  if (A < 0 || R <= 0 || B <= 0 || C <= 0 || (kFused && (n <= 0 || Dp <= 0)) ||
      (dtype != kF32 && dtype != kBF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (A == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    mscm_block_kernel<float, kFused><<<A, kThreads, 0, s>>>(
        static_cast<const float*>(x), rows, static_cast<const float*>(vals),
        block_q, block_c, out, R, B, C, n, Dp);
  } else {
    mscm_block_kernel<__nv_bfloat16, kFused><<<A, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), rows,
        static_cast<const __nv_bfloat16*>(vals), block_q, block_c, out, R, B, C,
        n, Dp);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 on success).
// The caller allocates `out`; nothing here allocates or synchronises.
extern "C" int mscm_fused_launch(const void* x_dense, const int32_t* rows,
                                 const void* vals, const int64_t* block_q,
                                 const int64_t* block_c, float* out, int A,
                                 int64_t Dp, int R, int B, int C, int n,
                                 int dtype, void* stream) {
  if (rows == nullptr || block_q == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<true>(x_dense, rows, vals, block_q, block_c, out, A, R, B, C,
                      n, Dp, dtype, stream);
}

extern "C" int mscm_pregather_launch(const void* xg, const void* vals,
                                     const int64_t* block_c, float* out, int A,
                                     int R, int B, int C, int dtype,
                                     void* stream) {
  return launch<false>(xg, nullptr, vals, nullptr, block_c, out, A, R, B, C,
                       1, 1, dtype, stream);
}
