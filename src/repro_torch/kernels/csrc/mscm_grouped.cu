// Grouped MSCM tile product with the beam-search epilogue fused, for Hopper,
// over f32 chunk tiles or over int8 / fp8-e4m3 tiles with a scale row.
//
// Replaces two Pallas TPU kernels:
//   mscm_grouped_launch    src/repro/kernels/mscm_kernel.py::mscm_grouped
//                          (body _grouped_body), f32 tiles;
//   mscm_grouped_q_launch  src/repro/quant/kernels.py::mscm_grouped_q
//                          (body _grouped_q_body), quantized tiles.
// For every tile t of QT (query, parent-chunk) blocks that share one chunk c:
//
//     out[t] = ep(xg_tiles[t] [QT, R] @ W [R, B])
//
//     W      = vals[c]                               (f32 tiles)
//              float(vals[c]) * scales[c][None, :]   (int8 / fp8 tiles)
//     ep     = none    acc
//              prod    sigmoid(acc) * ps[t][:, None]
//              logsum  logsigmoid(acc) + ps[t][:, None]
//
// What bounds it on an H100: memory bandwidth. At the main path's shapes
// (QT = 8, R = 496, B = 32) one tile reads 15.9 KB of gathered query rows
// and 63.5 KB of f32 chunk tile (15.9 KB in int8 or fp8) and writes 1 KB,
// for 254 kFLOP: about 3 FLOP per byte in f32 (8 quantized), under the
// ~20 FLOP/B at which f32 FMA on the CUDA cores (67 TFLOP/s over
// 3.35 TB/s) would be the limit.
//
// Design: one thread block per tile, which reads its own tile_chunk[t] (the
// TPU kernel had it scalar-prefetched). Slabs of xg_tiles[t] [QT, rs] and
// the chunk tile [rs, B] are staged in shared memory with coalesced loads;
// a quantized weight is widened to f32 and multiplied by its column's scale
// (__fmul_rn, so it cannot be contracted into an FMA) as it is staged, so
// device memory carries one byte per weight and everything after the
// staging is the f32 kernel's. Each thread keeps up to kOutPerThread of the
// QT*B outputs in registers and accumulates them in f32 with fmaf (no
// TF32), in row order. One routine serves both entry points, so the
// quantized kernel is bitwise the f32 kernel run on the dequantized tiles
// (float(q) * scale, as repro_torch.quant.storage.dequantize_layer computes
// them). The epilogue runs on the accumulator before the single store, so
// logits never reach device memory. The grouping upstream is chunk-major,
// so consecutive tiles of one chunk read the same chunk tile and L2 serves
// the repeats. QT, R, B are runtime values and ragged slab edges are
// masked. A TMA/wgmma pipeline is later work: this version is the simple,
// exact one.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kOutPerThread = 4;
constexpr int kMaxSlabRows = 64;
constexpr int kSmemLimit = 48 * 1024;  // static launch limit, no opt-in

enum Mode { kNone = 0, kProd = 1, kLogsum = 2 };
enum QDtype { kInt8 = 0, kFp8E4M3 = 1 };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float widen(__nv_fp8_e4m3 v) { return static_cast<float>(v); }

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

// W is float (scales is null), int8_t or __nv_fp8_e4m3.
template <typename W>
__global__ void __launch_bounds__(kThreads)
mscm_grouped_kernel(const float* __restrict__ xg,          // [T, QT, R]
                    const W* __restrict__ vals,            // [C, R, B]
                    const float* __restrict__ scales,      // [C, B] or null
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
  const W* vt = vals + static_cast<size_t>(c) * R * B;
  const float* st = scales == nullptr ? nullptr : scales + static_cast<size_t>(c) * B;
  const int n_out = QT * B;
  const int b_step = kThreads % B;

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
      // b = i % B, kept by increments: slab rows start at column 0.
      for (int i = threadIdx.x, b = threadIdx.x % B; i < rs * B; i += kThreads) {
        float v = 0.0f;
        if (i < depth * B) {
          v = widen(vt[static_cast<size_t>(r0) * B + i]);
          if constexpr (!std::is_same<W, float>::value) v = __fmul_rn(v, st[b]);
        }
        vs[i] = v;
        b += b_step;
        if (b >= B) b -= B;
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

template <typename W>
int launch(const float* xg, const W* vals, const float* scales,
           const int64_t* tile_chunk, const float* ps, float* out, int T, int QT,
           int R, int B, int C, int mode, void* stream) {
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
  mscm_grouped_kernel<W><<<T, kThreads, smem_bytes(rs),
                           static_cast<cudaStream_t>(stream)>>>(
      xg, vals, scales, tile_chunk, ps, out, QT, R, B, C, rs, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() (0 on
// success). The caller allocates `out`; nothing here allocates or
// synchronises.
extern "C" int mscm_grouped_launch(const float* xg, const float* vals,
                                   const int64_t* tile_chunk, const float* ps,
                                   float* out, int T, int QT, int R, int B,
                                   int C, int mode, void* stream) {
  return launch<float>(xg, vals, nullptr, tile_chunk, ps, out, T, QT, R, B, C,
                       mode, stream);
}

// vals holds int8 (dtype kInt8) or fp8-e4m3 (kFp8E4M3) codes [C, R, B];
// scales the f32 scale of each (chunk, column) [C, B].
extern "C" int mscm_grouped_q_launch(const float* xg, const void* vals,
                                     const float* scales,
                                     const int64_t* tile_chunk, const float* ps,
                                     float* out, int T, int QT, int R, int B,
                                     int C, int mode, int dtype, void* stream) {
  if (scales == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kInt8) {
    return launch<int8_t>(xg, static_cast<const int8_t*>(vals), scales,
                          tile_chunk, ps, out, T, QT, R, B, C, mode, stream);
  }
  if (dtype == kFp8E4M3) {
    return launch<__nv_fp8_e4m3>(xg, static_cast<const __nv_fp8_e4m3*>(vals),
                                 scales, tile_chunk, ps, out, T, QT, R, B, C,
                                 mode, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
