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
// and out[t] = 0 for a padding tile (tile_src[t, 0] < 0), whose outputs
// no block reads.
//
// What bounds it on an H100. At the batch path's shapes (QT = 8, R = 496,
// B = 32) one tile reads 15.9 KB of gathered query rows and 63.5 KB of f32
// chunk tile (15.9 KB in int8 or fp8) and writes 1 KB, for 254 kFLOP: about
// 3 FLOP per byte in f32 (8 with codes), under the ~20 FLOP/B at which f32
// FMA on the CUDA cores (67 TFLOP/s over 3.35 TB/s) would be the limit, so
// bytes bound it. What keeps a simple routine far from that bound is not
// the FMAs but what surrounds them: a thread per output spends two
// shared-memory loads a fmaf, each waited for; slabs staged by ordinary
// loads wait on each other; each CTA runs its own chain of latencies (ids,
// copies, product, epilogue) with little to overlap it; and padding tiles
// cost as much as live ones.
//
// Design (the launch plan comes from repro_torch/kernels/mscm_kernel.py::
// grouped_launch_plan, which the CPU tests check; launch() checks it again):
//
// - Persistent CTAs of 8 warps: CTA g walks tiles g, g + grid, ... Warp 0
//   reads their ids in one round trip; padding tiles (tile_src[t, 0] < 0)
//   get their zeros and are never copied or computed. Each pass of each
//   live tile is a unit; units go through a ring of two shared-memory stages
//   (one when a stage would not fit), so one unit's copies are in flight
//   while the one before is computed.
// - Operands arrive by 1-D bulk copies (cp.async.bulk ... complete_tx) on
//   mbarriers: the query rows (one copy when contiguous) and, for codes, the
//   scale row on the stage's head barrier; the tile rows in up to 4 slabs,
//   each on its own barrier. Lane 0 of warp j issues slab j of the next unit
//   as soon as its slab of this unit has landed. The warps split R into
//   fixed contiguous ranges (a multiple of 4 rows), two warps a slab, so a
//   warp starts when its own slab is in. A tile too large for one stage goes
//   in passes of `pass_rows` rows. An operand whose copies would not be 16-
//   byte aligned (int8 / fp8 at R = 100, B = 70, f32 at R % 4 != 0, a
//   misaligned view) is staged with ordinary loads in the same kernel.
// - Register tiling: a lane holds an 8 x 4 block of the tile's outputs (8
//   rows q, 4 columns); a warp's 32 lanes are 4 row groups by 8 column
//   groups. A step takes 16 rows of R, 4 per row group: four weight loads
//   and eight 16-byte loads of query values feed 128 fmaf a lane. Codes are
//   widened with integer and full-rate float operations (exact) and
//   multiplied by their column's scale with __fmul_rn, which cannot be
//   contracted into an FMA. True f32 fmaf, no TF32.
// - Sums in a fixed order, no atomics, so two launches are bitwise equal:
//   each output is one fmaf chain a row group, in row order; the four row
//   groups' chains are added as (g0 + g2) + (g1 + g3) by two shuffle
//   exchanges; the warps' partials go through shared memory and are added
//   in warp order; the epilogue runs on the sum before the single store, so
//   logits never reach device memory. The quantized entry point runs the
//   same routine with the same passes as f32 tiles, so it is bitwise the f32
//   entry point on the dequantized tiles (float(q) * scale, as
//   repro_torch.quant.storage.dequantize_layer computes them).
//
// The grouping upstream is chunk-major, so tiles of one chunk are adjacent
// and run at about the same time on neighbouring CTAs; L2 serves the
// repeats. Chunk ids are clamped into range, as the reference's gather
// clamps them.
//
// Any QT and B. A tile runs as items: row groups of up to kMaxQT rows (the
// last one short) by windows of `window_cols` columns (the last one
// narrower), item v = (t * windows + w) * row_groups + g, each with its own
// partials and stages. Below QT = 16 and the widest B whose partials and a
// pass of 32 rows fit, a tile is one item, as before. An item is live when
// its tile is (tile_src[t, 0] >= 0), whatever its rows hold, so a row group
// of padding slots in a live tile computes what the plain version does. A
// window splits columns, never R: each output is summed in the same order
// as without windows. A window's tile rows lie at stride B in vals, so they
// arrive one bulk copy a row, spread over a warp's lanes.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "bulk_copy.cuh"

namespace {

using namespace bulkcopy;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpsPerSlab = 2;
constexpr int kMaxSlabs = kWarps / kWarpsPerSlab;
constexpr int kMaxQT = 16;
constexpr int kMaxStages = 2;
constexpr int kMaxTiles = 32;  // tiles a CTA walks: one warp's lanes hold their ids
// A lane's register tile: kQ rows of the tile by kCols columns. The 32 lanes
// of a warp are kRowGroups row groups (which split the warp's rows) by
// kColGroups column groups (which cover 32 columns).
constexpr int kQ = 8;
constexpr int kCols = 4;
constexpr int kColGroups = 8;
constexpr int kRowGroups = 32 / kColGroups;
constexpr int kRowsPerLane = 4;                       // rows of a step in one row group
constexpr int kStepRows = kRowGroups * kRowsPerLane;  // rows of a step in a warp
constexpr size_t kMaxSmem = 232448;  // 227 KB, an H100 block's opt-in limit

enum Mode { kNone = 0, kProd = 1, kLogsum = 2 };
enum QDtype { kInt8 = 0, kFp8E4M3 = 1 };
// Bits of Plan::bulk: which operands arrive by bulk copies.
enum BulkOperand { kBulkXg = 1, kBulkTile = 2, kBulkScales = 4 };

// The launch plan (grouped_launch_plan): items of `group_rows` rows by
// `window_cols` columns; `grid` CTAs, CTA g taking items g, g + grid, ...
// (at most kMaxTiles); R in passes of `pass_rows` rows, each pass of each
// live item a unit that goes through a ring of `stages` shared-memory
// stages; warp w takes rows [w * warp_rows, (w + 1) * warp_rows) of a
// pass; the tile rows of a pass arrive in slabs of `slab_rows` = 2 *
// warp_rows rows.
struct Plan {
  int pass_rows, warp_rows, slab_rows, bulk, stages, grid, group_rows, window_cols;
};

// Shared memory, in order: the mbarriers (kMaxSlabs + 1 a stage: the head,
// query rows and scales, then one a slab), the chunk ids of the CTA's live
// items [kMaxTiles], their indices among its items [kMaxTiles] with the
// padding items' mask and the live count, its parent scores
// [kMaxTiles, QT], the warps' partials
// [kWarps, QT, B], then `stages` stages, each the scale row [B], the query
// rows [QT, xr] (xr = pass_rows rounded up to 4) and the tile rows
// [pass_rows, B] of W, where QT and B are an item's (group_rows and
// window_cols). grouped_smem_bytes in mscm_kernel.py repeats this sum.
struct Layout {
  size_t chunks, idx, ps, part, stage0, stage, xs, tile, total;
  int xr;
  __host__ __device__ Layout(const Plan& p, int QT, int B, int es) {
    xr = (p.pass_rows + 3) & ~3;
    chunks = align16(8 * static_cast<size_t>(kMaxStages * (kMaxSlabs + 1)));
    idx = chunks + 8 * static_cast<size_t>(kMaxTiles);
    ps = idx + align16(4 * static_cast<size_t>(kMaxTiles + 2));
    part = ps + align16(4 * static_cast<size_t>(kMaxTiles) * QT);
    stage0 = part + align16(4 * static_cast<size_t>(kWarps) * QT * B);
    xs = align16(4 * static_cast<size_t>(B));  // offsets within a stage
    tile = xs + align16(4 * static_cast<size_t>(QT) * xr);
    stage = tile + align16(static_cast<size_t>(p.pass_rows) * B * es);
    total = stage0 + stage * p.stages;
  }
};

__device__ __forceinline__ float apply_epilogue(float acc, float ps, int mode) {
  if (mode == kProd) {
    const float s = __frcp_rn(1.0f + expf(-acc));  // == 1.0f / (...), correctly rounded
    return s * ps;
  }
  if (mode == kLogsum) {
    // Stable log-sigmoid: min(x, 0) - log1p(exp(-|x|)).
    const float ls = fminf(acc, 0.0f) - log1pf(expf(-fabsf(acc)));
    return ls + ps;
  }
  return acc;
}

struct Args {
  const float* xg;            // [T, QT, R]
  const void* vals;           // [C, R, B] of W
  const float* scales;        // [C, B], or null for f32 tiles
  const int64_t* tile_chunk;  // [T]
  const int64_t* tile_src;    // [T, QT], or null: every tile live
  const float* ps;            // [T, QT], or null when mode is none
  float* out;                 // [T, QT, B]
  int T, QT, R, B, C, mode;
  Plan p;
};

// One item of the launch: tile t's rows [row0, row0 + h) and columns
// [b0, b0 + bw). grouped_item in mscm_kernel.py repeats this decode.
// Without row groups or windows (kSplit false) item v is tile v, whole,
// and the decode folds away.
struct Item {
  int t, row0, h, b0, bw;
};

template <bool kSplit>
__device__ __forceinline__ Item item_of(const Args& a, int v) {
  if constexpr (!kSplit) return Item{v, 0, a.QT, 0, a.B};
  const int groups = (a.QT + a.p.group_rows - 1) / a.p.group_rows;
  const int windows = (a.B + a.p.window_cols - 1) / a.p.window_cols;
  const int g = v % groups, rest = v / groups;
  const int w = rest % windows;
  Item it;
  it.t = rest / windows;
  it.row0 = g * a.p.group_rows;
  it.h = min(a.p.group_rows, a.QT - it.row0);
  it.b0 = w * a.p.window_cols;
  it.bw = min(a.p.window_cols, a.B - it.b0);
  return it;
}

// Code j of the four int8 or fp8-e4m3 codes in v, as f32, exactly (the
// value static_cast<float> gives), with integer and full-rate float
// operations rather than the conversion unit.
template <typename W>
__device__ __forceinline__ float widen_code(uint32_t v, int j) {
  if constexpr (std::is_same<W, int8_t>::value) {
    // 2^23 + 128 + code, with code + 128 = code ^ 0x80 as the low mantissa
    // byte, minus 2^23 + 128.
    const uint32_t bits = __byte_perm(v ^ 0x80808080u, 0x4B000000u, 0x7440 + j);
    return __fsub_rn(__uint_as_float(bits), 8388736.0f);
  } else {
    // e4m3 (bias 7): exponent and mantissa into an f32's, then times 2^120
    // (exact, subnormal codes included); 0x7f is NaN; the sign bit last.
    const uint32_t b = (v >> (8 * j)) & 0xffu;
    const uint32_t mag = b & 0x7fu;
    float f = __fmul_rn(__uint_as_float(mag << 20), 0x1p120f);
    if (mag == 0x7fu) f = __uint_as_float(0x7fc00000u);
    return __uint_as_float(__float_as_uint(f) | ((b & 0x80u) << 24));
  }
}

// W[i] as f32: itself, or the code widened and multiplied by its scale.
template <typename W>
__device__ __forceinline__ float weight(const W* tile, int i, float scale) {
  if constexpr (std::is_same<W, float>::value) {
    return tile[i];
  } else if constexpr (std::is_same<W, int8_t>::value) {
    return __fmul_rn(widen_code<W>(static_cast<uint8_t>(tile[i]), 0), scale);
  } else {
    return __fmul_rn(widen_code<W>(tile[i].__x, 0), scale);
  }
}

// The lane's kCols weights of tile row k from column c0, as f32. When B % 4
// == 0 that is one 16-byte (f32) or 4-byte (int8 / fp8) load, and a lane
// whose columns start past B loads nothing; otherwise one load a column,
// columns past B reading column B - 1 (never stored).
template <typename W>
__device__ __forceinline__ void load_weights(const W* tile, int k, int c0, int B, bool vec,
                                             const float* scale, float* w) {
  if (vec) {
    if (c0 >= B) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) w[j] = 0.0f;
      return;
    }
    const int i = k * B + c0;
    if constexpr (std::is_same<W, float>::value) {
      const float4 v = *reinterpret_cast<const float4*>(tile + i);
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(tile + i);
#pragma unroll
      for (int j = 0; j < kCols; ++j) w[j] = __fmul_rn(widen_code<W>(v, j), scale[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) w[j] = weight(tile, k * B + min(c0 + j, B - 1), scale[j]);
  }
}

// acc[q][j] += x[q][rr] * w[j] for row rr of a step, one fmaf each.
__device__ __forceinline__ void fma_row(float (&acc)[kQ][kCols], const float* w, const float4* x,
                                        int rr) {
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const float xv = rr == 0 ? x[q].x : (rr == 1 ? x[q].y : (rr == 2 ? x[q].z : x[q].w));
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[q][j] = fmaf(xv, w[j], acc[q][j]);
  }
}

// Warp `warp`'s rows [w0, k1) of one pass of one tile, from the stage's
// query rows xs and tile rows, into its partials part_w [QT, B]: written at
// the tile's first pass, added to at the others.
template <typename W>
__device__ __forceinline__ void warp_product(const W* tile, const float* xs, const float* ss,
                                             float* part_w, int w0, int k1, int xr, int QT,
                                             int B, bool first_pass, int lane) {
  constexpr bool kQuant = !std::is_same<W, float>::value;
  const bool vec = B % 4 == 0;
  const int kg = lane / kColGroups;  // the lane's row group
  const int cg = lane % kColGroups;  // the lane's column group
  for (int q0 = 0; q0 < QT; q0 += kQ) {
    // Rows of xs this block reads; rows past QT read row QT - 1 (their sums
    // are never stored), so every load is unconditional.
    int xoff[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) xoff[q] = min(q0 + q, QT - 1) * xr;
    for (int b0 = 0; b0 < B; b0 += kColGroups * kCols) {
      const int c0 = b0 + cg * kCols;  // the lane's first column
      float scale[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) scale[j] = kQuant ? ss[min(c0 + j, B - 1)] : 1.0f;
      float acc[kQ][kCols];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[q][j] = 0.0f;
      }
      // Row group kg takes rows k0 + 4kg .. k0 + 4kg + 3 of every step of
      // kStepRows rows: one fmaf chain an output, in row order. A step's
      // operands are kRowsPerLane weight loads and kQ 16-byte loads of the
      // query values, then kQ * kCols * kRowsPerLane fmafs. Rows past the
      // warp's last row are loaded clamped into its range (in xs, into the
      // padding of a row of xr) and add nothing.
      for (int k0 = w0; k0 < k1; k0 += kStepRows) {
        const int r = k0 + kRowsPerLane * kg;
        float w[kRowsPerLane][kCols];
        float4 x[kQ];
#pragma unroll
        for (int rr = 0; rr < kRowsPerLane; ++rr) {
          load_weights(tile, min(r + rr, k1 - 1), c0, B, vec, scale, w[rr]);
        }
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          x[q] = *reinterpret_cast<const float4*>(xs + xoff[q] + min(r, (k1 - 1) & ~3));
        }
        if (r + kRowsPerLane <= k1) {
#pragma unroll
          for (int rr = 0; rr < kRowsPerLane; ++rr) fma_row(acc, w[rr], x, rr);
        } else {
#pragma unroll
          for (int rr = 0; rr < kRowsPerLane; ++rr) {
            if (r + rr < k1) fma_row(acc, w[rr], x, rr);
          }
        }
      }
      // The four row groups' chains added, (g0 + g2) + (g1 + g3) for every
      // output: each exchange hands the partner the half of the rows it
      // keeps, so row group kg ends with rows 2kg and 2kg + 1 of the block.
      const bool hi = (kg >> 1) & 1, odd = kg & 1;
      float half[kQ / 2][kCols], pair[2][kCols];
#pragma unroll
      for (int r = 0; r < kQ / 2; ++r) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float keep = hi ? acc[r + kQ / 2][j] : acc[r][j];
          const float give = hi ? acc[r][j] : acc[r + kQ / 2][j];
          half[r][j] = keep + __shfl_xor_sync(0xffffffffu, give, 2 * kColGroups);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float keep = odd ? half[r + 2][j] : half[r][j];
          const float give = odd ? half[r][j] : half[r + 2][j];
          pair[r][j] = keep + __shfl_xor_sync(0xffffffffu, give, kColGroups);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = q0 + 2 * kg + r;
        if (q < QT) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            if (c0 + j < B) {
              float* dst = part_w + q * B + c0 + j;
              *dst = (first_pass ? 0.0f : *dst) + pair[r][j];
            }
          }
        }
      }
    }
  }
}

// W is float (scales unused), int8_t or __nv_fp8_e4m3. One CTA walks its
// items; each pass of each live item is a unit. With two stages unit u + 1
// is put in flight as each warp's part of unit u lands, with one stage once
// unit u is consumed. kSplit: the plan has row groups or windows; without
// them an item is a tile and the kernel keeps QT and B in its parameters,
// as the registers of the product need.
template <typename W, bool kSplit>
__global__ void __launch_bounds__(kThreads) mscm_grouped_kernel(const Args args) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kQuant = !std::is_same<W, float>::value;
  const Plan p = args.p;
  const int QT = args.QT, R = args.R, B = args.B, G = p.grid;
  const int GR = kSplit ? p.group_rows : QT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_items =
      kSplit ? args.T * ((QT + GR - 1) / GR) * ((B + p.window_cols - 1) / p.window_cols)
             : args.T;
  const int n_mine = (n_items - static_cast<int>(blockIdx.x) + G - 1) / G;  // <= kMaxTiles
  auto item_at = [&](int i) {
    return item_of<kSplit>(args, static_cast<int>(blockIdx.x) + i * G);
  };

  const Layout lay(p, GR, kSplit ? p.window_cols : B, static_cast<int>(sizeof(W)));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [stages][head, kMaxSlabs slabs]
  int64_t* chunk_s = reinterpret_cast<int64_t*>(smem + lay.chunks);
  float* ps_s = reinterpret_cast<float*>(smem + lay.ps);
  float* part = reinterpret_cast<float*>(smem + lay.part);
  auto stage = [&](int s) { return smem + lay.stage0 + s * lay.stage; };
  const int xr = lay.xr;
  const bool bx = p.bulk & kBulkXg, bw = p.bulk & kBulkTile;
  const bool bs = kQuant && (p.bulk & kBulkScales);
  const int n_pass = (R + p.pass_rows - 1) / p.pass_rows;
  const int w0 = warp * p.warp_rows;  // this warp's first row of a pass
  const int slab = w0 / p.slab_rows;  // the slab that holds its rows

  // Warp 0: lane i reads the ids of the CTA's item i (those of its tile), and
  // the live items' chunks are packed in order into chunk_s; live_idx[j] is
  // the j-th live item's index among the CTA's items.
  int* live_idx = reinterpret_cast<int*>(smem + lay.idx);
  uint32_t& dead_mask = reinterpret_cast<uint32_t*>(live_idx)[kMaxTiles];
  int& n_live = live_idx[kMaxTiles + 1];
  if (warp == 0) {
    bool live = false;
    int64_t c = 0;
    if (lane < n_mine) {
      const int t = item_at(lane).t;
      live = args.tile_src == nullptr || args.tile_src[static_cast<size_t>(t) * QT] >= 0;
      c = args.tile_chunk[t];
      c = c < 0 ? 0 : (c >= args.C ? args.C - 1 : c);
    }
    const uint32_t mask = __ballot_sync(0xffffffffu, live);
    const uint32_t mine = __ballot_sync(0xffffffffu, lane < n_mine);
    if (live) {
      const int j = __popc(mask & ((1u << lane) - 1));
      live_idx[j] = lane;
      chunk_s[j] = c;
    }
    if (lane == 0) {
      dead_mask = mine & ~mask;
      n_live = __popc(mask);
      for (int j = 0; j < kMaxStages * (kMaxSlabs + 1); ++j) mbar_init(&bars[j], 1);
      fence_mbar_init();
    }
  }
  // The CTA's parent scores, [item, row of its group], for the epilogues.
  if (args.mode != kNone) {
    for (int e = tid; e < n_mine * GR; e += kThreads) {
      const Item it = item_at(e / GR);
      const int q = e % GR;
      ps_s[e] = q < it.h ? args.ps[static_cast<size_t>(it.t) * QT + it.row0 + q] : 0.0f;
    }
  }
  __syncthreads();
  const int n_units = n_live * n_pass;

  // Warp j (all its lanes) puts slab j of unit u in flight; warp 0 also the
  // head (the query rows, one copy when they are contiguous as in xg, and
  // the scale row). Lane 0 arms each barrier before any copy to it is
  // issued; a window's tile rows go one copy a row, over the warp's lanes.
  auto issue = [&](int u) {
    const int s = u % p.stages, pass = u % n_pass;
    const Item it = item_at(live_idx[u / n_pass]);
    const int r0 = pass * p.pass_rows, nr = min(p.pass_rows, R - r0);
    unsigned char* st = stage(s);
    uint64_t* hbar = bars + s * (kMaxSlabs + 1);
    const int64_t c = chunk_s[u / n_pass];
    if (warp == 0 && (bx || bs)) {
      const float* xt = args.xg + (static_cast<size_t>(it.t) * QT + it.row0) * R;
      float* xs = reinterpret_cast<float*>(st + lay.xs);
      if (lane == 0) mbar_expect(hbar, (bx ? it.h * nr * 4u : 0u) + (bs ? it.bw * 4u : 0u));
      __syncwarp();
      if (bx && xr == R) {
        if (lane == 0) bulk_load(xs, xt, it.h * nr * 4u, hbar);
      } else if (bx) {
        for (int q = lane; q < it.h; q += 32) {
          bulk_load(xs + q * xr, xt + static_cast<size_t>(q) * R + r0, nr * 4u, hbar);
        }
      }
      if (bs && lane == 0) {
        bulk_load(st, args.scales + static_cast<size_t>(c) * B + it.b0, it.bw * 4u, hbar);
      }
    }
    // Every slab barrier completes one phase a unit, so that the waiters'
    // parity (u / stages) & 1 holds for each of them: a slab this pass does
    // not have (a short last pass) gets an arrival that expects no bytes.
    const int j = warp;
    if (bw && j < kMaxSlabs) {
      const int rows = max(0, min(p.slab_rows, nr - j * p.slab_rows));
      const uint32_t row_bytes = static_cast<uint32_t>(it.bw) * sizeof(W);
      const W* vt = static_cast<const W*>(args.vals) +
                    (static_cast<size_t>(c) * R + r0 + j * p.slab_rows) * B + it.b0;
      W* dst = reinterpret_cast<W*>(st + lay.tile) + static_cast<size_t>(j) * p.slab_rows * it.bw;
      if (lane == 0) mbar_expect(&hbar[1 + j], rows * row_bytes);
      __syncwarp();
      if (!kSplit || it.bw == B) {  // the slab's rows are contiguous: one copy
        if (lane == 0 && rows > 0) bulk_load(dst, vt, rows * row_bytes, &hbar[1 + j]);
      } else {
        for (int k = lane; k < rows; k += 32) {
          bulk_load(dst + static_cast<size_t>(k) * it.bw, vt + static_cast<size_t>(k) * B,
                    row_bytes, &hbar[1 + j]);
        }
      }
    }
  };
  if (n_units > 0) issue(0);

  // Padding items: zeros, while the first units arrive.
  for (uint32_t m = dead_mask; m != 0; m &= m - 1) {
    const Item it = item_at(__ffs(m) - 1);
    float* o = args.out + (static_cast<size_t>(it.t) * QT + it.row0) * B + it.b0;
    for (int e = tid; e < it.h * it.bw; e += kThreads) {
      o[kSplit ? (e / it.bw) * B + e % it.bw : e] = 0.0f;
    }
  }

  for (int u = 0; u < n_units; ++u) {
    const int s = u % p.stages, pass = u % n_pass, i = live_idx[u / n_pass];
    const uint32_t parity = (u / p.stages) & 1;
    const Item it = item_at(i);
    const int h = it.h, ib = it.bw, n_out = h * ib;
    const int r0 = pass * p.pass_rows, nr = min(p.pass_rows, R - r0);
    unsigned char* st = stage(s);
    uint64_t* hbar = bars + s * (kMaxSlabs + 1);
    float* ss = reinterpret_cast<float*>(st);
    float* xs = reinterpret_cast<float*>(st + lay.xs);
    W* tile = reinterpret_cast<W*>(st + lay.tile);
    float* part_w = part + static_cast<size_t>(warp) * n_out;
    // Ordinary loads, by every thread, for the operands the plan does not
    // bulk-copy; the same condition on every thread, so the barrier is safe.
    if (!bx || !bw || (kQuant && !bs)) {
      const int64_t c = chunk_s[u / n_pass];
      if (!bx) {
        const float* xt = args.xg + (static_cast<size_t>(it.t) * QT + it.row0) * R;
        for (int e = tid; e < h * nr; e += kThreads) {
          const int q = e / nr, k = e - q * nr;
          xs[q * xr + k] = xt[static_cast<size_t>(q) * R + r0 + k];
        }
      }
      if (kQuant && !bs) {
        for (int b = tid; b < ib; b += kThreads) {
          ss[b] = args.scales[static_cast<size_t>(c) * B + it.b0 + b];
        }
      }
      if (!bw) {
        const W* src = static_cast<const W*>(args.vals) + (static_cast<size_t>(c) * R + r0) * B +
                       it.b0;
        for (int e = tid; e < nr * ib; e += kThreads) {
          const int k = e / ib;
          tile[e] = src[static_cast<size_t>(k) * B + (e - k * ib)];
        }
      }
      __syncthreads();
    }

    const int k1 = min(nr, w0 + p.warp_rows);
    if (w0 < k1) {  // warp-uniform
      if (bx || bs) mbar_wait(hbar, parity);
      if (bw) mbar_wait(&hbar[1 + slab], parity);
    }
    // With two stages, unit u + 1 goes in flight as soon as this warp's part
    // of unit u has landed: its stage was consumed by unit u - 1, before the
    // last barrier.
    if (p.stages == 2 && u + 1 < n_units) {
      fence_proxy_async();
      issue(u + 1);
    }
    if (w0 < k1) {
      warp_product(tile, xs, ss, part_w, w0, k1, xr, h, ib, pass == 0, lane);
    } else if (pass == 0) {
      for (int e = lane; e < n_out; e += 32) part_w[e] = 0.0f;
    }
    __syncthreads();  // the stage is consumed; every warp's partial is in place
    if (p.stages == 1 && u + 1 < n_units) {
      fence_proxy_async();
      issue(u + 1);
    }
    if (pass == n_pass - 1) {
      float* o = args.out + (static_cast<size_t>(it.t) * QT + it.row0) * B + it.b0;
      for (int e = tid; e < n_out; e += kThreads) {
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += part[static_cast<size_t>(w) * n_out + e];
        const int q = e / ib;
        o[kSplit ? q * B + (e - q * ib) : e] =
            apply_epilogue(sum, args.mode == kNone ? 0.0f : ps_s[i * GR + q], args.mode);
      }
      __syncthreads();  // the partials are read before the next item writes them
    }
  }
}

// Rejects a plan the kernel cannot run: passes or warp ranges that miss
// rows, row groups or windows that miss rows or columns, a CTA with more
// items than kMaxTiles, more stages than barriers, and bulk copies off 16
// bytes.
bool plan_ok(const Args& a, int es) {
  const Plan& p = a.p;
  if (p.pass_rows < 1 || p.pass_rows > a.R || p.warp_rows < 4 || p.warp_rows % 4 != 0 ||
      static_cast<int64_t>(kWarps) * p.warp_rows < p.pass_rows ||
      p.slab_rows != kWarpsPerSlab * p.warp_rows || (p.bulk & ~7) != 0 ||
      (p.pass_rows < a.R && p.pass_rows % 4 != 0) || p.stages < 1 || p.stages > kMaxStages ||
      p.group_rows < 1 || p.group_rows > kMaxQT || p.group_rows > a.QT ||
      (p.group_rows < a.QT && p.group_rows != kMaxQT) || p.window_cols < 1 ||
      p.window_cols > a.B || (p.window_cols < a.B && p.window_cols % 16 != 0)) {
    return false;
  }
  const int64_t items = static_cast<int64_t>(a.T) * ((a.QT + p.group_rows - 1) / p.group_rows) *
                        ((a.B + p.window_cols - 1) / p.window_cols);
  if (items > INT32_MAX || p.grid < 1 || p.grid > items ||
      static_cast<int64_t>(p.grid) * kMaxTiles < items) {
    return false;
  }
  if ((p.bulk & kBulkXg) && (a.R % 4 != 0 || !aligned16(a.xg))) return false;
  const int64_t row = static_cast<int64_t>(a.B) * es;
  if (p.bulk & kBulkTile) {
    const bool rows_ok = p.window_cols < a.B
                             ? row % 16 == 0  // one copy a row of a window
                             : (a.R * row) % 16 == 0 && (p.pass_rows * row) % 16 == 0 &&
                                   (p.slab_rows * row) % 16 == 0;
    if (!rows_ok || !aligned16(a.vals)) return false;
  }
  if ((p.bulk & kBulkScales) && (a.scales == nullptr || a.B % 4 != 0 || !aligned16(a.scales))) {
    return false;
  }
  return true;
}

template <typename W>
int launch(const Args& a, void* stream) {
  if (a.T < 0 || a.QT <= 0 || a.R <= 0 || a.B <= 0 || a.C <= 0 || a.mode < kNone ||
      a.mode > kLogsum || (a.mode != kNone && a.ps == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.T == 0) return 0;
  if (!plan_ok(a, static_cast<int>(sizeof(W)))) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      Layout(a.p, a.p.group_rows, a.p.window_cols, static_cast<int>(sizeof(W))).total;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const bool split = a.p.group_rows < a.QT || a.p.window_cols < a.B;
  auto kernel = split ? mscm_grouped_kernel<W, true> : mscm_grouped_kernel<W, false>;
  // Raise the kernel's dynamic shared-memory limit only when a launch needs
  // more than this device already allows it: the call costs host time, which
  // the batch path is short of.
  constexpr int kMaxDevices = 64;
  static std::atomic<int> allowed[2][kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  std::atomic<int>& have = allowed[split][dev % kMaxDevices];
  if (smem > 48 * 1024 && static_cast<int>(smem) > have.load()) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    have.store(static_cast<int>(smem));
  }
  kernel<<<a.p.grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point launches on `stream` and returns the launch's CUDA error
// (0 on success). tile_src may be null (every tile live); the plan
// (pass_rows, warp_rows, slab_rows, bulk, stages, grid, group_rows,
// window_cols) is grouped_launch_plan's. The caller allocates `out`; nothing here allocates
// or synchronises.
extern "C" int mscm_grouped_launch(const float* xg, const float* vals,
                                   const int64_t* tile_chunk, const int64_t* tile_src,
                                   const float* ps, float* out, int T, int QT, int R, int B,
                                   int C, int mode, int pass_rows, int warp_rows,
                                   int slab_rows, int bulk, int stages, int grid,
                                   int group_rows, int window_cols, void* stream) {
  const Args a{xg, vals, nullptr, tile_chunk, tile_src, ps, out, T, QT, R, B, C, mode,
               Plan{pass_rows, warp_rows, slab_rows, bulk & ~kBulkScales, stages, grid,
                    group_rows, window_cols}};
  return launch<float>(a, stream);
}

// vals holds int8 (dtype kInt8) or fp8-e4m3 (kFp8E4M3) codes [C, R, B];
// scales the f32 scale of each (chunk, column) [C, B].
extern "C" int mscm_grouped_q_launch(const float* xg, const void* vals, const float* scales,
                                     const int64_t* tile_chunk, const int64_t* tile_src,
                                     const float* ps, float* out, int T, int QT, int R, int B,
                                     int C, int mode, int dtype, int pass_rows, int warp_rows,
                                     int slab_rows, int bulk, int stages, int grid,
                                     int group_rows, int window_cols, void* stream) {
  if (scales == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{xg, vals, scales, tile_chunk, tile_src, ps, out, T, QT, R, B, C, mode,
               Plan{pass_rows, warp_rows, slab_rows, bulk, stages, grid, group_rows,
                    window_cols}};
  if (dtype == kInt8) return launch<int8_t>(a, stream);
  if (dtype == kFp8E4M3) return launch<__nv_fp8_e4m3>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
