// Grouped MSCM tile product with the beam-search epilogue fused, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mscm_kernel.py::mscm_grouped
// (body _grouped_body). For every tile t of QT (query, parent-chunk) blocks
// that share one chunk:
//
//     out[t] = ep(xg_tiles[t] [QT, R] @ vals[tile_chunk[t]] [R, B])
//
//     ep = none    acc
//          prod    sigmoid(acc) * ps[t][:, None]
//          logsum  logsigmoid(acc) + ps[t][:, None]
//
// What bounds it on an H100: memory bandwidth. At the main path's shapes
// (QT = 8, R = 496, B = 32) one tile reads 15.9 KB of gathered query rows
// and 63.5 KB of chunk tile and writes 1 KB, for 254 kFLOP: about 3 FLOP per
// byte, far under the ~20 FLOP/B at which f32 FMA on the CUDA cores
// (67 TFLOP/s over 3.35 TB/s) would be the limit.
//
// Design: one thread block per tile, which reads its own tile_chunk[t] (the
// TPU kernel had it scalar-prefetched). Slabs of xg_tiles[t] [QT, rs] and
// vals[c] [rs, B] are staged in shared memory with coalesced loads; each
// thread keeps up to kOutPerThread of the QT*B outputs in registers and
// accumulates them in f32 with fmaf (no TF32), in row order. The epilogue
// runs on the accumulator before the single store, so logits never reach
// device memory. The grouping upstream is chunk-major, so consecutive tiles
// of one chunk read the same chunk tile and L2 serves the repeats. QT, R, B
// are runtime values and ragged slab edges are masked. A TMA/wgmma pipeline
// is later work: this version is the simple, exact one.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOutPerThread = 4;
constexpr int kMaxSlabRows = 64;
constexpr int kSmemLimit = 48 * 1024;  // static launch limit, no opt-in

enum Mode { kNone = 0, kProd = 1, kLogsum = 2 };

__device__ __forceinline__ float apply_epilogue(float acc, float ps, int mode) {
  if (mode == kProd) {
    const float s = 1.0f / (1.0f + expf(-acc));
    return s * ps;
  }
  if (mode == kLogsum) {
    // Stable log-sigmoid: min(x, 0) - log1p(exp(-|x|)).
    const float ls = fminf(acc, 0.0f) - log1pf(expf(-fabsf(acc)));
    return ls + ps;
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
mscm_grouped_kernel(const float* __restrict__ xg,          // [T, QT, R]
                    const float* __restrict__ vals,        // [C, R, B]
                    const int64_t* __restrict__ tile_chunk,  // [T]
                    const float* __restrict__ ps,          // [T, QT] or null
                    float* __restrict__ out,               // [T, QT, B]
                    int QT, int R, int B, int C, int rs, int mode) {
  extern __shared__ float smem[];
  const int xs_stride = rs + 1;           // pad: rows of xs in distinct banks
  float* xs = smem;                       // [QT][rs + 1]
  float* vs = smem + QT * xs_stride;      // [rs][B]

  const int t = blockIdx.x;
  int64_t c = tile_chunk[t];
  // The reference's gather clamps an out-of-range chunk id; so does this.
  c = c < 0 ? 0 : (c >= C ? C - 1 : c);
  const float* xt = xg + static_cast<size_t>(t) * QT * R;
  const float* vt = vals + static_cast<size_t>(c) * R * B;
  const int n_out = QT * B;

  for (int o0 = 0; o0 < n_out; o0 += kThreads * kOutPerThread) {
    float acc[kOutPerThread];
#pragma unroll
    for (int j = 0; j < kOutPerThread; ++j) acc[j] = 0.0f;

    for (int r0 = 0; r0 < R; r0 += rs) {
      const int depth = min(rs, R - r0);
      __syncthreads();  // the previous slab is fully consumed
      for (int i = threadIdx.x; i < QT * rs; i += kThreads) {
        const int q = i / rs, k = i - q * rs;
        xs[q * xs_stride + k] =
            k < depth ? xt[static_cast<size_t>(q) * R + r0 + k] : 0.0f;
      }
      for (int i = threadIdx.x; i < rs * B; i += kThreads) {
        vs[i] = i < depth * B ? vt[static_cast<size_t>(r0) * B + i] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kOutPerThread; ++j) {
        const int o = o0 + j * kThreads + threadIdx.x;
        if (o < n_out) {
          const int q = o / B, b = o - q * B;
          const float* xrow = xs + q * xs_stride;
          float a = acc[j];
          for (int k = 0; k < depth; ++k) a = fmaf(xrow[k], vs[k * B + b], a);
          acc[j] = a;
        }
      }
    }

#pragma unroll
    for (int j = 0; j < kOutPerThread; ++j) {
      const int o = o0 + j * kThreads + threadIdx.x;
      if (o < n_out) {
        const int q = o / B;
        const float p = mode == kNone ? 0.0f : ps[static_cast<size_t>(t) * QT + q];
        out[static_cast<size_t>(t) * n_out + o] = apply_epilogue(acc[j], p, mode);
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates `out`; nothing here allocates or synchronises.
extern "C" int mscm_grouped_launch(const float* xg, const float* vals,
                                   const int64_t* tile_chunk, const float* ps,
                                   float* out, int T, int QT, int R, int B,
                                   int C, int mode, void* stream) {
  if (T < 0 || QT <= 0 || R <= 0 || B <= 0 || C <= 0 || mode < kNone ||
      mode > kLogsum || (mode != kNone && ps == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (T == 0) return 0;
  int rs = kMaxSlabRows;
  auto smem_bytes = [&](int r) {
    return static_cast<size_t>(QT * (r + 1) + r * B) * sizeof(float);
  };
  while (rs > 1 && smem_bytes(rs) > kSmemLimit) rs /= 2;
  if (smem_bytes(rs) > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  mscm_grouped_kernel<<<T, kThreads, smem_bytes(rs),
                        static_cast<cudaStream_t>(stream)>>>(
      xg, vals, tile_chunk, ps, out, QT, R, B, C, rs, mode);
  return static_cast<int>(cudaGetLastError());
}
