// K2 `fused_conv_chain`: N consecutive conv stages on one lane-packed grid
// in ONE launch.
//
// Replaces the TPU kernel robocupvision_tpu/ops/pallas_packed.py
// `fused_conv_chain` (body `_chain_kernel`), for its plain stages (KxK/s1
// conv, optionally dilated, bias, folded-BN affine in either order or a bare
// ReLU, identity skip), its conv'd skip (`skip_w`), its folded
// space-to-depth stem (`stem_f`), its packed 2x2 max pool (`pool`) and its
// fused argmax head, and its int8 stages (`x_scale`/`w_scale`, static
// post-training quantization).
//
// Stage k of a chain: y = conv(in) [+ conv(skip, skip_w)] + b; then rbb ?
// relu(y)*scale + shift : relu(y*scale + shift) when the stage has an
// affine, else relu(y) for a `relu_only` stage; then y += skip for an
// identity skip (a `skip_w` stage takes its skip through the conv instead,
// before the bias: the second half of a conv split over a concat); rows
// outside the image are zero (they are the next stage's padding; the
// columns are bounds-checked instead); y is rounded to the chain dtype. A
// conv tap (dy, dx) of a `dil`-dilated stage reads input row
// g + dil*(dy - KH/2) and column c + dil*(dx - KW/2).
// A `stem_f` stage (stage 0 only) reads the raw (N, f*H, f*W, cin) image as
// its free grouped view (N, f*H, W, f*cin): output row g, tap dy in
// [0, f+2) reads raw row f*g + dy - 1 and tap dx in [0, 3) reads group
// c + dx - 1, i.e. the (f, 1)-strided, padding-1 conv of the JAX package's
// chain_reference (the TPU kernel's f row-phase buffers exist only for
// Mosaic's static strided reads and are not needed here). A `skip_w` stage's
// (K, K, Cskip, Cout) skip kernel (K in {1, 3}, padding K/2) reads the skip
// tensor straight from device memory at row g + dy - K/2 and column c + dx -
// K/2, both bounds-checked, so it deepens no halo (the TPU kernel pads the
// skips instead).
// A `pool` stage (the --UNet downs' packed 2x2/s2 max pool) reads only its
// input's centre (reach 0): output lane l of pixel (g, c) is the max of
// input lanes src[t][l], t in [0, 4), of the same pixel -- a pure lane
// gather (the wrapper turns the TPU kernel's four 0/1 lane-selection
// matrices into that (4, cout) table; the selection dots exist there only
// because Mosaic has no minor-dim reshape). No bias, no epilogue, and the
// values stay in the chain dtype, so the result is bit-identical to
// packed_max_pool.
// An int8 chain (every stage quantized, `quant` set; the wrapper quantizes
// the chain input, the stem's raw image too, to s8 at stage 0's x_scale):
// a conv stage reads s8 inputs and s8 per-output-channel weights and sums
// the products in int32 (exact: 127^2 * Cin * taps passes 2^24 already at
// 128 lanes, so f32 sums would not be); the dequant is (float)acc *
// (w_scale[co] * x_scale), that product taken in f32 first; a `skip_w`
// stage's float skip conv is summed apart from 0 and added after the
// dequant; bias, epilogue and identity skip follow in f32 as for a float
// stage. The strip the next stage reads is stored as s8, requantized
// from the f32 y with round-half-even (rintf, never roundf) at the host's
// f32(1 / next x_scale) and clipped to +-127; emitted outputs and the
// argmax head's logits strip stay the chain dtype. A pool stage takes the
// max of its four s8 lanes and dequantizes at its own x_scale. The f32
// steps after the integer sum are written with __fmul_rn / __fadd_rn so
// that no multiply-add is contracted: chain_reference rounds each of them
// apart, and a one-ulp difference would move a requantization tie.
//
// Bound on the H100: bytes. At the flagship's VGA shapes the packed taps
// are mostly structural zeros (each original weight lands in one output
// phase), and the unpacked convolutions' work over the tensor cores' bf16
// rate takes less time than reading the chain input and skips and writing
// the emitted maps once over the memory rate (chip_smoke.py's chain_work
// computes both). The kernel skips those zeros: the wrapper hands each
// conv stage lists of the weight blocks that are not all zero
// (ops/cuda_packed.tap_blocks), and the tap loops walk only those. It
// still recomputes halo rows and runs 30-row deep chains on few blocks.
//
// Design, following the TPU kernel: grid (H/band, N); block (band, n) owns
// `band` output rows of image n. Stage k produces a strip of band +
// 2*depth[k] rows (depth[k] = the halo the later stages' taps need, reach
// dil*(K/2) each), recomputing halo rows instead of exchanging them between
// blocks -- blocks of a grid cannot wait for each other. Each strip is
// written to a per-block slice of a device workspace (in place of the TPU
// kernel's VMEM scratch), and __syncthreads() separates the stages. Only
// `emit` stages write the (N, H, W, C) outputs. The argmax head
// writes its rounded logits to the workspace and a last pass picks per
// group the first maximum (jnp.argmax / torch.argmax tie rule), so labels
// equal argmax(logits) exactly. Strips are stored at byte offsets in the
// workspace: s8 in an int8 chain, the chain dtype otherwise (and for the
// argmax head's logits).
//
// The tap loops. A bf16 float chain's conv stages run on the tensor cores
// (conv_stage_mma, the tap loop of mma_taps.cuh): each warp on its own
// takes 64 consecutive pixels of the stage's strip (rows flattened, so
// narrow grids waste no lanes) x one 16- or 8-wide output-channel tile,
// and walks that tile's list of (tap, 16-channel chunk) blocks, the stage's
// own kernel first, then a skip_w stage's skip kernel; rows outside the
// strip, columns outside the image and channels past Cin or Cout are zero
// fills. f32 and int8 stages stay on the CUDA cores, where a thread
// computes kPix adjacent pixels x COB adjacent output channels, so each
// loaded input value feeds COB multiply-adds and each loaded weight kPix;
// with a (tap, input channel) list per COB-wide channel group they walk
// only the listed rows, in the order of the dense loop (so every element
// sums the same products in the same order less exact zeros: f32 results
// stay bit-identical), with a warp's threads on one group (one list). A
// chain none of whose lists skips a row (the deep and mid chains) runs a
// kernel of its own that walks every tap.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_taps.cuh"

#define RCV_MAX_STAGES 16
#define RCV_MAX_SKIPS 4

// Mirrored by ctypes structures in ops/cuda_packed.py: keep the field
// order and types in step.
struct RcvStage {
  const void* w;       // (kh, kw, cin, cout) chain dtype, 16-byte aligned
  const float* b;      // (cout,) f32
  const float* scale;  // (cout,) f32, or null: no affine (the head)
  const float* shift;  // (cout,) f32
  const void* skip_w;  // (skip_k, skip_k, skip_cin, cout) chain dtype, 16-byte
                       // aligned, or null: skips[skip_idx] is an identity skip
  const int* table;    // device int32: a pool stage's (4, cout) source
                       // lanes; a conv stage's tap block lists (below)
  void* out;           // emitted (N, H, W, cout) chain dtype, (N, H, W, G)
                       // int32 for the argmax head, or null
  long long ws_off;    // byte offset of the strip in a block's workspace,
                       // or -1: no strip
  int kh, kw, cin, cout, rbb, skip_idx, argmax_groups, depth;
  int dil;             // tap spacing (1: a plain conv)
  int stem_f;          // stage 0 only: the folded stem's factor f, else 0
  int relu_only;       // no affine: y = relu(conv + b)
  int skip_k, skip_cin;  // the skip kernel's K and Cskip (skip_w only)
  int pool;            // a packed 2x2 max pool: out[l] = max_t in[table[t][l]]
  const float* w_scale;  // int8 conv stages: (cout,) f32 dequant row, else null
                         // (w is then (kh, kw, cin, cout) s8)
  float x_scale;       // int8 stages: the static input scale (> 0), else 0
  float requant;       // int8 chains: f32(1 / next stage's x_scale), else 0
};

// A conv stage's tap table (ops/cuda_packed.tap_blocks): [0] the MMA
// lists' output-channel tile (16 or 8), [1] the CUDA-core lists' group
// width COB, [2] where the CUDA-core offsets start, [3] 1 when the
// CUDA-core lists hold every row (a dense stage), else 0; from [4] the MMA
// offsets. An offsets array of n tiles (groups) holds 2n + 1 indices into
// the table: list (t, s) is [off[2t + s], off[2t + s + 1]), source s 0 the
// stage's kernel and 1 a skip_w kernel. Entries are (tap << 16) | k, tap =
// dy * kw + dx of the source's kernel, k a 16-channel chunk (MMA) or an
// input channel.
struct RcvChain {
  const void* x;                     // (N, H, W, cin0) chain dtype, s8 when
                                     // `quant`
  const void* skips[RCV_MAX_SKIPS];  // (N, H, W, C): C is the consumer's
                                     // cout, or its skip_cin for skip_w
  void* ws;                          // workspace, ws_per_block bytes per
  long long ws_per_block;            // block
  int n, h, w, band, n_stages, bf16, quant;
  int listed;  // f32 / int8 chains: some conv stage's lists skip rows: the
               // CUDA-core stages walk their lists (else every tap densely)
  RcvStage st[RCV_MAX_STAGES];
};

namespace {

constexpr int kThreads = 256;
// Two blocks per SM: caps a thread at 128 registers, so a grid of up to
// 264 blocks (b8, or the 30-row deep chains' 240) runs in one wave.
// Without the cap ptxas may take more (164 for an f32 build, seen on an
// H100) and halve the occupancy: f32 chains ran ~25% slower at b8.
constexpr int kMinBlocksPerSm = 2;
constexpr int kPix = 4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// COB adjacent output channels' weights, widened to f32. With COB % 4 == 0
// the loads are vectors of 4 (16 bytes in f32, 8 in bf16): aligned because
// the wrapper passes 16-byte aligned weights and co0 is a multiple of COB.
template <int COB>
__device__ __forceinline__ void load_w(const float* __restrict__ p,
                                       float (&wv)[COB]) {
  if constexpr (COB % 4 == 0) {
#pragma unroll
    for (int q = 0; q < COB; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + q);
      wv[q] = v.x; wv[q + 1] = v.y; wv[q + 2] = v.z; wv[q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < COB; ++q) wv[q] = p[q];
  }
}
template <int COB>
__device__ __forceinline__ void load_w(const __nv_bfloat16* __restrict__ p,
                                       float (&wv)[COB]) {
  if constexpr (COB % 4 == 0) {
#pragma unroll
    for (int q = 0; q < COB; q += 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(p + q);
      const float2 lo =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
      const float2 hi =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
      wv[q] = lo.x; wv[q + 1] = lo.y; wv[q + 2] = hi.x; wv[q + 3] = hi.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < COB; ++q) wv[q] = __bfloat162float(p[q]);
  }
}

// COB adjacent output channels' s8 weights, sign-extended to int. With COB
// % 4 == 0 the loads are words of 4 (aligned as the float loads are).
template <int COB>
__device__ __forceinline__ void load_w8(const int8_t* __restrict__ p,
                                        int (&wv)[COB]) {
  if constexpr (COB % 4 == 0) {
#pragma unroll
    for (int q = 0; q < COB; q += 4) {
      const unsigned v = *reinterpret_cast<const unsigned*>(p + q);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wv[q + j] = static_cast<int>(v << (24 - 8 * j)) >> 24;
    }
  } else {
#pragma unroll
    for (int q = 0; q < COB; ++q) wv[q] = p[q];
  }
}

// y requantized for the next int8 stage: round half to even, clip to +-127.
__device__ __forceinline__ int8_t requant(float y, float r) {
  const float v = fminf(fmaxf(rintf(__fmul_rn(y, r)), -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(v));
}

// Work item `it` of a conv stage's strip: COB output channels from co0 at
// kPix columns from col0 of strip row r, which is image row g.
struct Item {
  int co0, col0, r, g;
  bool in_image;
};
template <int COB>
__device__ __forceinline__ Item item_of(int it, int ncog, int npg, int row0,
                                        int H) {
  const int rest = it / ncog;
  const int r = rest / npg;
  return {(it % ncog) * COB, (rest % npg) * kPix, r, row0 + r,
          row0 + r >= 0 && row0 + r < H};
}
// The same items with the channel group outermost (`per` = items of one
// group), so that the threads of a warp share one group, and one tap list.
template <int COB>
__device__ __forceinline__ Item item_grouped(int it, int per, int npg,
                                             int row0, int H) {
  const int grp = it / per;
  const int rest = it - grp * per;
  const int r = rest / npg;
  return {grp * COB, (rest - r * npg) * kPix, r, row0 + r,
          row0 + r >= 0 && row0 + r < H};
}

// The columns the kPix outputs from col0 read at tap column dx (c + dil*dx
// - px), and whether each read is inside the image (an output past W reads
// nothing).
__device__ __forceinline__ void tap_cols(int col0, int dil, int dx, int px,
                                         int W, int (&col)[kPix],
                                         bool (&ok)[kPix]) {
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    col[p] = col0 + p + dil * dx - px;
    ok[p] = col0 + p < W && col[p] >= 0 && col[p] < W;
  }
}

// The float taps of one source into acc, for item m: the (kh, kw, scin,
// cout) kernel `wsrc` over `src`, whose rows [srow0, srow0 + srows) exist,
// each W * scin wide; tap (dy, dx) reads row sy*g + dil*dy - py - srow0 and
// column c + dil*dx - px. A float stage's own conv and its skip_w conv, and
// an int8 stage's skip_w conv, all run here.
template <typename T, int COB>
__device__ __forceinline__ void float_taps(
    float (&acc)[kPix][COB], const Item& m, const T* src, int srow0,
    int srows, int scin, const T* wsrc, int kh, int kw, int sy, int dil,
    int py, int px, int cout, int W) {
  for (int dy = 0; dy < kh; ++dy) {
    const int lr = sy * m.g + dil * dy - py - srow0;
    if (lr < 0 || lr >= srows) continue;
    const T* in_row = src + (long long)lr * W * scin;
    for (int dx = 0; dx < kw; ++dx) {
      const T* wt = wsrc + (long long)(dy * kw + dx) * scin * cout + m.co0;
      int col[kPix];
      bool ok[kPix];
      tap_cols(m.col0, dil, dx, px, W, col, ok);
      for (int ci = 0; ci < scin; ++ci) {
        float wv[COB];
        load_w<COB>(wt + (long long)ci * cout, wv);
#pragma unroll
        for (int p = 0; p < kPix; ++p) {
          const float xv =
              ok[p] ? to_f(in_row[(long long)col[p] * scin + ci]) : 0.f;
#pragma unroll
          for (int q = 0; q < COB; ++q) acc[p][q] = fmaf(xv, wv[q], acc[p][q]);
        }
      }
    }
  }
}

// float_taps over the listed rows [j0, j1) of `blk` only: (tap, input
// channel) entries in the dense loop's order, so each element sums the same
// products in the same order, less rows whose COB weights are all zero.
template <typename T, int COB>
__device__ __forceinline__ void float_taps_listed(
    float (&acc)[kPix][COB], const Item& m, const T* src, int srow0,
    int srows, int scin, const T* wsrc, int kw, int sy, int dil, int py,
    int px, int cout, int W, const int* __restrict__ blk, int j0, int j1) {
  int cur = -1;
  bool row_ok = false;
  const T* in_row = src;
  const T* wt = wsrc;
  int col[kPix];
  bool ok[kPix];
  for (int j = j0; j < j1; ++j) {
    const int e = __ldg(blk + j);
    const int tap = e >> 16, ci = e & 0xffff;
    if (tap != cur) {
      cur = tap;
      const int dy = tap / kw, dx = tap - dy * kw;
      const int lr = sy * m.g + dil * dy - py - srow0;
      row_ok = lr >= 0 && lr < srows;
      in_row = src + (long long)lr * W * scin;
      wt = wsrc + (long long)tap * scin * cout + m.co0;
      tap_cols(m.col0, dil, dx, px, W, col, ok);
    }
    if (!row_ok) continue;
    float wv[COB];
    load_w<COB>(wt + (long long)ci * cout, wv);
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const float xv = ok[p] ? to_f(in_row[(long long)col[p] * scin + ci]) : 0.f;
#pragma unroll
      for (int q = 0; q < COB; ++q) acc[p][q] = fmaf(xv, wv[q], acc[p][q]);
    }
  }
}

// The int8 taps over the listed rows [j0, j1) of `blk` only, as
// float_taps_listed: s8 x s8 products summed in int32.
template <int COB>
__device__ __forceinline__ void int8_taps_listed(
    int (&acc)[kPix][COB], const Item& m, const int8_t* in, int in_row0,
    int in_rows, int cin, const int8_t* w8, int kw, int sy, int dil, int py,
    int px, int cout, int W, const int* __restrict__ blk, int j0, int j1) {
  int cur = -1;
  bool row_ok = false;
  const int8_t* in_row = in;
  const int8_t* wt = w8;
  int col[kPix];
  bool ok[kPix];
  for (int j = j0; j < j1; ++j) {
    const int e = __ldg(blk + j);
    const int tap = e >> 16, ci = e & 0xffff;
    if (tap != cur) {
      cur = tap;
      const int dy = tap / kw, dx = tap - dy * kw;
      const int lr = sy * m.g + dil * dy - py - in_row0;
      row_ok = lr >= 0 && lr < in_rows;
      in_row = in + (long long)lr * W * cin;
      wt = w8 + (long long)tap * cin * cout + m.co0;
      tap_cols(m.col0, dil, dx, px, W, col, ok);
    }
    if (!row_ok) continue;
    int wv[COB];
    load_w8<COB>(wt + (long long)ci * cout, wv);
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const int xv = ok[p] ? (int)in_row[(long long)col[p] * cin + ci] : 0;
#pragma unroll
      for (int q = 0; q < COB; ++q) acc[p][q] += xv * wv[q];
    }
  }
}

// One stage over this block's strip. `in` holds rows [in_row0, in_row0 +
// in_rows) of the stage input (the image itself for stage 0, the previous
// strip otherwise), each W * cin wide; rows outside it read as zero.
template <typename T, int COB, bool LISTED>
__device__ void conv_stage(const RcvChain& c, const RcvStage& st, int img,
                           int off, const T* __restrict__ in, int in_row0,
                           int in_rows, T* __restrict__ strip_out) {
  const int W = c.w, H = c.h, cin = st.cin, cout = st.cout;
  const int KH = st.kh, KW = st.kw, dil = st.dil;
  // input row of tap dy for output row g: sy*g + dil*dy - py (a stem reads
  // its raw image's rows at stride f, padding 1); column of tap dx: c +
  // dil*dx - px. Each stage spells these three out: a helper returning
  // them as a struct changed the float builds' code, and their short f32
  // chains ran up to 7% slower on an H100.
  const int sy = st.stem_f ? st.stem_f : 1;
  const int py = st.stem_f ? 1 : dil * (KH / 2);
  const int px = dil * (KW / 2);
  const int d = st.depth;
  const int row0 = off - d;
  const int ncog = cout / COB;
  const int npg = (W + kPix - 1) / kPix;
  const int items = (c.band + 2 * d) * npg * ncog;
  // the identity skip added after the epilogue (a skip_w stage convolves
  // its skip instead)
  const T* skip = st.skip_idx >= 0 && st.skip_w == nullptr
      ? static_cast<const T*>(c.skips[st.skip_idx]) : nullptr;
  T* out = (st.out != nullptr && st.argmax_groups == 0)
      ? static_cast<T*>(st.out) : nullptr;
  const int n_src = st.skip_w != nullptr ? 2 : 1;
  const int* tab = st.table;
  const int per = (c.band + 2 * d) * npg;

  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const Item m = LISTED ? item_grouped<COB>(it, per, npg, row0, H)
                          : item_of<COB>(it, ncog, npg, row0, H);

    float acc[kPix][COB];
#pragma unroll
    for (int p = 0; p < kPix; ++p)
#pragma unroll
      for (int q = 0; q < COB; ++q) acc[p][q] = 0.f;

    // rows outside the image end as zero: skip their math. Source 0 is the
    // stage's own conv over its input; source 1, on a skip_w stage, the
    // skip kernel's conv over the skip image (K x K, padding K/2, all H
    // rows there), summed into the same accumulator (one loop over both
    // sources keeps the float builds at 128 registers)
    for (int s = 0; m.in_image && s < n_src; ++s) {
      const bool sk = s == 1;
      const int scin = sk ? st.skip_cin : cin;
      const int skh = sk ? st.skip_k : KH, skw = sk ? st.skip_k : KW;
      const int sdil = sk ? 1 : dil, ssy = sk ? 1 : sy;
      const int spy = sk ? st.skip_k / 2 : py, spx = sk ? st.skip_k / 2 : px;
      const int srow0 = sk ? 0 : in_row0, srows = sk ? H : in_rows;
      const T* src = sk ? static_cast<const T*>(c.skips[st.skip_idx]) +
                              (long long)img * H * W * scin
                        : in;
      const T* wsrc = static_cast<const T*>(sk ? st.skip_w : st.w);
      if constexpr (LISTED) {
        const int* lo = tab + tab[2] + 2 * (m.co0 / COB) + s;
        float_taps_listed<T, COB>(acc, m, src, srow0, srows, scin, wsrc, skw,
                                  ssy, sdil, spy, spx, cout, W, tab, lo[0],
                                  lo[1]);
      } else {
        float_taps<T, COB>(acc, m, src, srow0, srows, scin, wsrc, skh, skw,
                           ssy, sdil, spy, spx, cout, W);
      }
    }

    const int r = m.r, g = m.g;
    const bool emit_row = out != nullptr && r >= d && r < d + c.band;
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const int cc = m.col0 + p;
      if (cc >= W) continue;
#pragma unroll
      for (int q = 0; q < COB; ++q) {
        const int co = m.co0 + q;
        float y = 0.f;
        if (m.in_image) {
          y = acc[p][q] + st.b[co];
          if (st.scale != nullptr) {
            const float s = st.scale[co], sh = st.shift[co];
            y = st.rbb ? fmaxf(y, 0.f) * s + sh : fmaxf(y * s + sh, 0.f);
          } else if (st.relu_only) {
            y = fmaxf(y, 0.f);
          }
          if (skip != nullptr)
            y += to_f(skip[(((long long)img * H + g) * W + cc) * cout + co]);
        }
        const T yt = from_f<T>(y);
        if (strip_out != nullptr)
          strip_out[((long long)r * W + cc) * cout + co] = yt;
        if (emit_row) out[(((long long)img * H + g) * W + cc) * cout + co] = yt;
      }
    }
  }
}

// kChainMT m16 tiles (64 strip pixels) a warp item in conv_stage_mma; the
// ring of each warp is sized for the wider (16-channel) tile.
constexpr int kChainMT = 4;
constexpr int kChainRing = rcv_mma::Tile<kChainMT, 2>::kRing;
constexpr int kChainSmem = kThreads / 32 * kChainRing * 2;  // bytes

// A bf16 stage of a float chain on the tensor cores: the epilogue of
// conv_stage on the accumulators of rcv_mma::tap_loop. A warp item is 64
// consecutive pixels of the strip (flattened (row, column) order) x one
// NT8*8-wide output-channel tile t, whose K blocks are the listed
// (tap, chunk) pairs of the stage's kernel over `in`, then of the skip_w
// kernel over the skip image. `ring`: this warp's kChainRing bf16.
template <int NT8>
__device__ void conv_stage_mma(const RcvChain& c, const RcvStage& st, int img,
                               int off, const __nv_bfloat16* __restrict__ in,
                               int in_row0, int in_rows,
                               __nv_bfloat16* __restrict__ strip_out,
                               __nv_bfloat16* ring) {
  using T = __nv_bfloat16;
  constexpr int NT = NT8 * 8;
  constexpr int kBS = rcv_mma::Tile<kChainMT, NT8>::kBStride;
  const int W = c.w, H = c.h, cin = st.cin, cout = st.cout;
  const int KW = st.kw, dil = st.dil;
  // as in conv_stage: input row sy*g + dil*dy - py, column c + dil*dx - px
  const int sy = st.stem_f ? st.stem_f : 1;
  const int py = st.stem_f ? 1 : dil * (st.kh / 2);
  const int px = dil * (KW / 2);
  const int d = st.depth;
  const int row0 = off - d;
  const int npix = (c.band + 2 * d) * W;
  const int n_t = (cout + NT - 1) / NT;
  const int items = (npix + 63) / 64 * n_t;
  const T* skip = st.skip_idx >= 0 && st.skip_w == nullptr
      ? static_cast<const T*>(c.skips[st.skip_idx]) : nullptr;
  const T* skip_img = st.skip_w != nullptr
      ? static_cast<const T*>(c.skips[st.skip_idx]) +
            (long long)img * H * W * st.skip_cin
      : nullptr;
  T* out = (st.out != nullptr && st.argmax_groups == 0)
      ? static_cast<T*>(st.out) : nullptr;
  const T* w = static_cast<const T*>(st.w);
  const T* skw = static_cast<const T*>(st.skip_w);
  // 16-byte pieces: the strips and (by the wrapper) the chain input, the
  // skips and the kernels are 16-byte aligned
  const bool vec_in = cin % 8 == 0, vec_skip = st.skip_cin % 8 == 0;
  const bool vec_w = cout % 8 == 0;
  const int lane = threadIdx.x & 31;
  const int half = lane & 1;

  for (int it = threadIdx.x >> 5; it < items; it += blockDim.x >> 5) {
    const int mb = it / n_t, t = it - mb * n_t;
    const int co0 = t * NT;
    // this lane's four A pieces: pixel (lane >> 1) + 16 i, channels half*8..
    int pg[4], pc[4];
    bool pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = mb * 64 + (lane >> 1) + 16 * i;
      const int r = q / W;
      pg[i] = row0 + r;
      pc[i] = q - r * W;
      pv[i] = q < npix && pg[i] >= 0 && pg[i] < H;
    }
    const int* lo = st.table + 4 + 2 * t;
    const int b0 = lo[0], b1 = lo[1];

    float acc[kChainMT][NT8][4];
#pragma unroll
    for (int i = 0; i < kChainMT; ++i)
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    auto stage = [&](int j, T* a, T* b) {
      const int e = __ldg(st.table + b0 + j);
      const bool sk = b0 + j >= b1;
      const int tap = e >> 16, chunk = e & 0xffff;
      const int kw = sk ? st.skip_k : KW;
      const int dy = tap / kw, dx = tap - dy * kw;
      const int scin = sk ? st.skip_cin : cin;
      const int ssy = sk ? 1 : sy;
      const int ry = sk ? dy - st.skip_k / 2 : dil * dy - py;
      const int rx = sk ? dx - st.skip_k / 2 : dil * dx - px;
      const int srow0 = sk ? 0 : in_row0, srows = sk ? H : in_rows;
      const T* src = sk ? skip_img : in;
      const bool vec = sk ? vec_skip : vec_in;
      const int ch = chunk * 16 + half * 8;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int lr = ssy * pg[i] + ry - srow0, col = pc[i] + rx;
        const bool ok = pv[i] && lr >= 0 && lr < srows && col >= 0 &&
                        col < W && ch < scin;
        const T* p = ok ? src + ((long long)lr * W + col) * scin + ch : in;
        T* dst = a + ((lane >> 1) + 16 * i) * rcv_mma::kAStride + half * 8;
        if (vec)
          rcv_mma::cp_async16(dst, p, ok);
        else
          rcv_mma::store8(dst, p, ok ? min(8, scin - ch) : 0);
      }
      // B: 16 input channels x NT output channels, NT8 pieces a row
      if (lane < 16 * NT8) {
        const int k = lane / NT8, q = lane - k * NT8;
        const int ci = chunk * 16 + k, co = co0 + q * 8;
        const bool ok = ci < scin && co < cout;
        const T* ws = sk ? skw : w;
        const T* p = ok ? ws + ((long long)tap * scin + ci) * cout + co : ws;
        T* dst = b + k * kBS + q * 8;
        if (vec_w)
          rcv_mma::cp_async16(dst, p, ok);
        else
          rcv_mma::store8(dst, p, ok ? min(8, cout - co) : 0);
      }
    };
    rcv_mma::tap_loop<kChainMT, NT8>(acc, lo[2] - b0, ring, stage);

    // the epilogue of conv_stage, element by element
#pragma unroll
    for (int mt = 0; mt < kChainMT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = mb * 64 + mt * 16 + rcv_mma::acc_row(lane, e);
        if (q >= npix) continue;
        const int r = q / W, cc = q - r * W, g = row0 + r;
        const bool in_image = g >= 0 && g < H;
        const bool emit_row = out != nullptr && r >= d && r < d + c.band;
#pragma unroll
        for (int nt = 0; nt < NT8; ++nt) {
          const int co = co0 + nt * 8 + rcv_mma::acc_col(lane, e);
          if (co >= cout) continue;
          float y = 0.f;
          if (in_image) {
            y = acc[mt][nt][e] + st.b[co];
            if (st.scale != nullptr) {
              const float s = st.scale[co], sh = st.shift[co];
              y = st.rbb ? fmaxf(y, 0.f) * s + sh : fmaxf(y * s + sh, 0.f);
            } else if (st.relu_only) {
              y = fmaxf(y, 0.f);
            }
            if (skip != nullptr)
              y += to_f(skip[(((long long)img * H + g) * W + cc) * cout + co]);
          }
          const T yt = from_f<T>(y);
          if (strip_out != nullptr)
            strip_out[((long long)r * W + cc) * cout + co] = yt;
          if (emit_row)
            out[(((long long)img * H + g) * W + cc) * cout + co] = yt;
        }
      }
  }
}

// One stage of an int8 chain over this block's strip: the s8 x s8 taps
// summed in int32, the f32 dequant, then (SKW) the float skip conv summed
// apart and added, bias, epilogue and identity skip, every f32 step
// rounded on its own. The strip is written as s8 requantized for the next
// stage, or, for the argmax head, as its logits in the chain dtype. `in`
// as for conv_stage, in s8.
template <typename T, int COB, bool SKW, bool LISTED>
__device__ void conv_stage_q(const RcvChain& c, const RcvStage& st, int img,
                             int off, const int8_t* __restrict__ in,
                             int in_row0, int in_rows, void* strip_out) {
  const int W = c.w, H = c.h, cin = st.cin, cout = st.cout;
  const int KH = st.kh, KW = st.kw, dil = st.dil;
  // as in conv_stage
  const int sy = st.stem_f ? st.stem_f : 1;
  const int py = st.stem_f ? 1 : dil * (KH / 2);
  const int px = dil * (KW / 2);
  const int d = st.depth;
  const int row0 = off - d;
  const int ncog = cout / COB;
  const int npg = (W + kPix - 1) / kPix;
  const int items = (c.band + 2 * d) * npg * ncog;
  const int8_t* __restrict__ w8 = static_cast<const int8_t*>(st.w);
  const T* skip = st.skip_idx >= 0 && !SKW
      ? static_cast<const T*>(c.skips[st.skip_idx]) : nullptr;
  T* out = (st.out != nullptr && st.argmax_groups == 0)
      ? static_cast<T*>(st.out) : nullptr;
  const int* tab = st.table;
  const int per = (c.band + 2 * d) * npg;

  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const Item m = LISTED ? item_grouped<COB>(it, per, npg, row0, H)
                          : item_of<COB>(it, ncog, npg, row0, H);

    int acc[kPix][COB];
#pragma unroll
    for (int p = 0; p < kPix; ++p)
#pragma unroll
      for (int q = 0; q < COB; ++q) acc[p][q] = 0;
    if constexpr (LISTED) {
      const int* lo = tab + tab[2] + 2 * (m.co0 / COB);
      if (m.in_image)
        int8_taps_listed<COB>(acc, m, in, in_row0, in_rows, cin, w8, KW, sy,
                              dil, py, px, cout, W, tab, lo[0], lo[1]);
    } else {
      for (int dy = 0; m.in_image && dy < KH; ++dy) {
        const int lr = sy * m.g + dil * dy - py - in_row0;
        if (lr < 0 || lr >= in_rows) continue;
        const int8_t* in_row = in + (long long)lr * W * cin;
        for (int dx = 0; dx < KW; ++dx) {
          const int8_t* wt =
              w8 + (long long)(dy * KW + dx) * cin * cout + m.co0;
          int col[kPix];
          bool ok[kPix];
          tap_cols(m.col0, dil, dx, px, W, col, ok);
          for (int ci = 0; ci < cin; ++ci) {
            int wv[COB];
            load_w8<COB>(wt + (long long)ci * cout, wv);
#pragma unroll
            for (int p = 0; p < kPix; ++p) {
              const int xv =
                  ok[p] ? (int)in_row[(long long)col[p] * cin + ci] : 0;
#pragma unroll
              for (int q = 0; q < COB; ++q) acc[p][q] += xv * wv[q];
            }
          }
        }
      }
    }

    // the skip kernel's conv (K x K, padding K/2) over the float skip
    float sacc[kPix][SKW ? COB : 1];
    if constexpr (SKW) {
#pragma unroll
      for (int p = 0; p < kPix; ++p)
#pragma unroll
        for (int q = 0; q < COB; ++q) sacc[p][q] = 0.f;
      const int sk = st.skip_k, scin = st.skip_cin, sp = sk / 2;
      if constexpr (LISTED) {
        const int* lo = tab + tab[2] + 2 * (m.co0 / COB);
        if (m.in_image)
          float_taps_listed<T, COB>(
              sacc, m,
              static_cast<const T*>(c.skips[st.skip_idx]) +
                  (long long)img * H * W * scin,
              0, H, scin, static_cast<const T*>(st.skip_w), sk, 1, 1, sp, sp,
              cout, W, tab, lo[1], lo[2]);
      } else {
        if (m.in_image)
          float_taps<T, COB>(sacc, m,
                             static_cast<const T*>(c.skips[st.skip_idx]) +
                                 (long long)img * H * W * scin,
                             0, H, scin, static_cast<const T*>(st.skip_w), sk,
                             sk, 1, 1, sp, sp, cout, W);
      }
    }

    // channel-outer: one channel's vectors are live at a time while the
    // accumulators drain
    const int r = m.r, g = m.g;
    const bool emit_row = out != nullptr && r >= d && r < d + c.band;
#pragma unroll
    for (int q = 0; q < COB; ++q) {
      const int co = m.co0 + q;
      const float dq = __fmul_rn(st.w_scale[co], st.x_scale), bias = st.b[co];
      const float s = st.scale != nullptr ? st.scale[co] : 0.f;
      const float sh = st.scale != nullptr ? st.shift[co] : 0.f;
#pragma unroll
      for (int p = 0; p < kPix; ++p) {
        const int cc = m.col0 + p;
        if (cc >= W) continue;
        float y = 0.f;
        if (m.in_image) {
          y = __fmul_rn((float)acc[p][q], dq);
          if constexpr (SKW) y = __fadd_rn(y, sacc[p][q]);
          y = __fadd_rn(y, bias);
          if (st.scale != nullptr) {
            y = st.rbb ? __fadd_rn(__fmul_rn(fmaxf(y, 0.f), s), sh)
                       : fmaxf(__fadd_rn(__fmul_rn(y, s), sh), 0.f);
          } else if (st.relu_only) {
            y = fmaxf(y, 0.f);
          }
          if (skip != nullptr)
            y = __fadd_rn(
                y, to_f(skip[(((long long)img * H + g) * W + cc) * cout + co]));
        }
        const T yt = from_f<T>(y);
        const long long si = ((long long)r * W + cc) * cout + co;
        if (strip_out != nullptr) {
          if (st.argmax_groups)
            static_cast<T*>(strip_out)[si] = yt;
          else
            static_cast<int8_t*>(strip_out)[si] = requant(y, st.requant);
        }
        if (emit_row) out[(((long long)img * H + g) * W + cc) * cout + co] = yt;
      }
    }
  }
}

// Packed 2x2 max pool over this block's strip: every output lane is the max
// of four lanes of the same input pixel (reach 0: input row g is output row
// g). `in` as for conv_stage.
template <typename T>
__device__ void pool_stage(const RcvChain& c, const RcvStage& st, int img,
                           int off, const T* __restrict__ in, int in_row0,
                           T* __restrict__ strip_out) {
  const int W = c.w, H = c.h, cin = st.cin, cout = st.cout;
  const int d = st.depth;
  const int row0 = off - d;
  const int items = (c.band + 2 * d) * W * cout;
  const int* __restrict__ src = st.table;
  T* out = static_cast<T*>(st.out);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int co = it % cout;
    const int rest = it / cout;
    const int cc = rest % W;
    const int r = rest / W;
    const int g = row0 + r;  // image row of this output
    T yt = from_f<T>(0.f);   // rows outside the image are zero
    if (g >= 0 && g < H) {
      const T* px = in + ((long long)(g - in_row0) * W + cc) * cin;
      float y = to_f(px[src[co]]);
#pragma unroll
      for (int t = 1; t < 4; ++t) y = fmaxf(y, to_f(px[src[t * cout + co]]));
      yt = from_f<T>(y);  // exact: y is one of the inputs
    }
    if (strip_out != nullptr) strip_out[((long long)r * W + cc) * cout + co] = yt;
    if (out != nullptr && r >= d && r < d + c.band)
      out[(((long long)img * H + g) * W + cc) * cout + co] = yt;
  }
}

// A pool stage of an int8 chain: the max of the four s8 lanes, dequantized
// at the stage's x_scale; the strip requantized for the next stage.
template <typename T>
__device__ void pool_stage_q(const RcvChain& c, const RcvStage& st, int img,
                             int off, const int8_t* __restrict__ in,
                             int in_row0, int8_t* __restrict__ strip_out) {
  const int W = c.w, H = c.h, cin = st.cin, cout = st.cout;
  const int d = st.depth;
  const int row0 = off - d;
  const int items = (c.band + 2 * d) * W * cout;
  const int* __restrict__ src = st.table;
  T* out = static_cast<T*>(st.out);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int co = it % cout;
    const int rest = it / cout;
    const int cc = rest % W;
    const int r = rest / W;
    const int g = row0 + r;  // image row of this output
    float y = 0.f;           // rows outside the image are zero
    if (g >= 0 && g < H) {
      const int8_t* px = in + ((long long)(g - in_row0) * W + cc) * cin;
      int m = px[src[co]];
#pragma unroll
      for (int t = 1; t < 4; ++t) m = max(m, (int)px[src[t * cout + co]]);
      y = __fmul_rn((float)m, st.x_scale);
    }
    if (strip_out != nullptr)
      strip_out[((long long)r * W + cc) * cout + co] = requant(y, st.requant);
    if (out != nullptr && r >= d && r < d + c.band)
      out[(((long long)img * H + g) * W + cc) * cout + co] = from_f<T>(y);
  }
}

// Fused serving head: per output pixel and group, the index of the first
// maximum over the group's cout/G adjacent (already rounded) logits.
template <typename T>
__device__ void argmax_stage(const RcvChain& c, const RcvStage& st, int img,
                             int off, const T* __restrict__ logits) {
  const int W = c.w, H = c.h, G = st.argmax_groups, cout = st.cout;
  const int ncls = cout / G;
  const int d = st.depth;
  int* out = static_cast<int*>(st.out);
  const int items = c.band * W * G;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int grp = it % G;
    const int rest = it / G;
    const int cc = rest % W;
    const int r = rest / W;
    const T* v = logits + ((long long)(r + d) * W + cc) * cout + grp * ncls;
    float best = to_f(v[0]);
    int idx = 0;
    for (int k = 1; k < ncls; ++k) {
      const float val = to_f(v[k]);
      if (val > best) {
        best = val;
        idx = k;
      }
    }
    out[(((long long)img * H + off + r) * W + cc) * G + grp] = idx;
  }
}

// LISTED: the CUDA-core stages walk their tap lists (a chain where some
// list skips rows), else every tap (a chain of dense stages). Two kernels:
// one holding both loops spilled at the 128-register cap and ran dense f32
// chains 3-10% slower (ptxas and the profiler on an H100).
// Q: an int8 chain, whose stage inputs (the chain input and the strips the
// next stage reads) are s8 and whose argmax head keeps its logits strip in
// the chain dtype. A float chain runs the loop of the float-only kernel
// unchanged.
template <typename T, bool Q, bool LISTED>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
    chain_kernel(const RcvChain c) {
  using In = typename std::conditional<Q, int8_t, T>::type;
  const int band_i = blockIdx.x;
  const int img = blockIdx.y;
  const int off = band_i * c.band;
  char* ws = static_cast<char*>(c.ws) +
             ((long long)img * gridDim.x + band_i) * c.ws_per_block;

  for (int s = 0; s < c.n_stages; ++s) {
    const RcvStage& st = c.st[s];
    const In* in;
    int in_row0, in_rows;
    if (s == 0) {
      // a stem reads the raw image: f*H rows of W groups of f*cin values
      in_rows = st.stem_f ? st.stem_f * c.h : c.h;
      in = static_cast<const In*>(c.x) + (long long)img * in_rows * c.w * st.cin;
      in_row0 = 0;
    } else {
      const RcvStage& prev = c.st[s - 1];
      in = reinterpret_cast<const In*>(ws + prev.ws_off);
      in_row0 = off - prev.depth;
      in_rows = c.band + 2 * prev.depth;
    }
    char* strip = st.ws_off >= 0 ? ws + st.ws_off : nullptr;
    if constexpr (Q) {
      int8_t* strip8 = reinterpret_cast<int8_t*>(strip);
      // at most 8 output channels a thread, 4 beside a skip_w stage's second
      // accumulator: with 16 and 8 both int8 builds spilled at the
      // 128-register cap (ptxas on an H100)
      if (st.pool)
        pool_stage_q<T>(c, st, img, off, in, in_row0, strip8);
      else if (st.skip_w != nullptr && st.cout % 4 == 0)
        conv_stage_q<T, 4, true, LISTED>(c, st, img, off, in, in_row0,
                                         in_rows, strip);
      else if (st.skip_w != nullptr)
        conv_stage_q<T, 1, true, LISTED>(c, st, img, off, in, in_row0,
                                         in_rows, strip);
      else if (st.cout % 8 == 0)
        conv_stage_q<T, 8, false, LISTED>(c, st, img, off, in, in_row0,
                                         in_rows, strip);
      else if (st.cout % 4 == 0)
        conv_stage_q<T, 4, false, LISTED>(c, st, img, off, in, in_row0,
                                         in_rows, strip);
      else
        conv_stage_q<T, 1, false, LISTED>(c, st, img, off, in, in_row0,
                                         in_rows, strip);
    } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      // a bf16 float chain: every conv stage on the tensor cores
      T* strip_out = reinterpret_cast<T*>(strip);
      extern __shared__ __align__(16) unsigned char chain_smem[];
      T* ring = reinterpret_cast<T*>(chain_smem) +
                (threadIdx.x >> 5) * kChainRing;
      if (st.pool)
        pool_stage<T>(c, st, img, off, in, in_row0, strip_out);
      else if (st.table[0] == 16)
        conv_stage_mma<2>(c, st, img, off, in, in_row0, in_rows, strip_out,
                          ring);
      else
        conv_stage_mma<1>(c, st, img, off, in, in_row0, in_rows, strip_out,
                          ring);
    } else {
      T* strip_out = reinterpret_cast<T*>(strip);
      if (st.pool)
        pool_stage<T>(c, st, img, off, in, in_row0, strip_out);
      else if (st.cout % 16 == 0)
        conv_stage<T, 16, LISTED>(c, st, img, off, in, in_row0, in_rows,
                                  strip_out);
      else if (st.cout % 8 == 0)
        conv_stage<T, 8, LISTED>(c, st, img, off, in, in_row0, in_rows,
                                  strip_out);
      else if (st.cout % 4 == 0)
        conv_stage<T, 4, LISTED>(c, st, img, off, in, in_row0, in_rows,
                                  strip_out);
      else
        conv_stage<T, 1, LISTED>(c, st, img, off, in, in_row0, in_rows,
                                  strip_out);
    }
    __syncthreads();
    if (st.argmax_groups) {
      argmax_stage<T>(c, st, img, off, reinterpret_cast<const T*>(strip));
      __syncthreads();
    }
  }
}

template <typename T, bool LISTED>
cudaError_t launch(const RcvChain& c, dim3 grid, cudaStream_t stream) {
  if (c.quant) {
    chain_kernel<T, true, LISTED><<<grid, kThreads, 0, stream>>>(c);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // the warps' cp.async rings: dynamic shared memory past 48 KB
    static bool attr_set = false;
    if (!attr_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          chain_kernel<T, false, false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kChainSmem);
      if (e != cudaSuccess) return e;
      attr_set = true;
    }
    chain_kernel<T, false, false><<<grid, kThreads, kChainSmem, stream>>>(c);
  } else {
    chain_kernel<T, false, LISTED><<<grid, kThreads, 0, stream>>>(c);
  }
  return cudaSuccess;
}

}  // namespace

// Launch one chain on `stream`. Returns cudaGetLastError() after the launch.
extern "C" int rcv_conv_chain(const RcvChain* chain, void* stream) {
  const RcvChain& c = *chain;
  if (c.n_stages < 1 || c.n_stages > RCV_MAX_STAGES || c.band < 1 ||
      c.h % c.band != 0 || c.n < 1 || c.n > 65535 || c.w < 1)
    return (int)cudaErrorInvalidValue;
  // a bf16 float chain's conv stages walk their tap tables' MMA lists, a
  // listed chain's their CUDA-core lists
  for (int i = 0; (c.listed || (c.bf16 && !c.quant)) && i < c.n_stages; ++i)
    if (c.st[i].table == nullptr) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(c.h / c.band), (unsigned)c.n);
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      c.bf16 ? (c.listed ? launch<__nv_bfloat16, true>(c, grid, s)
                         : launch<__nv_bfloat16, false>(c, grid, s))
             : (c.listed ? launch<float, true>(c, grid, s)
                         : launch<float, false>(c, grid, s));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
