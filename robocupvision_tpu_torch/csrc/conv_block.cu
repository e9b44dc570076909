// K3 `fused_conv3x3_block`: a batch-1 NHWC conv3x3 (stride 1, pad 1) with
// its bias and the block's ReLU / BN-affine epilogue in one kernel.
//
// Replaces the TPU kernel robocupvision_tpu/ops/pallas_kernels.py
// `fused_conv3x3_block` (body `_conv_block_kernel`): x (1, H, W, C) and an
// HWIO kernel (3, 3, C, Co) at x's dtype, the nine taps summed with f32
// accumulation, then in f32 `+ b` and either relu(y) * scale + shift
// (`relu_before_bn`, the reference's Conv block) or relu(y * scale + shift)
// (its up-sampling block), stored at x's dtype.
//
// Bound on the H100: in bf16, bytes at C = Co = 64 (2 * 9 * C * Co FLOP a
// pixel over the tensor cores' rate take less time than 2 * (C + Co) bytes
// over the memory rate) and operations from about C = Co = 128; in f32,
// operations (every multiply-add on the CUDA cores). chip_smoke.py
// computes both.
//
// Design. A block owns `tile` output rows (the TPU kernel's row tile),
// walked eight at a time, x 32 columns x a tile of output channels.
// - bf16: an implicit GEMM on the tensor cores through the tap loop of
//   mma_taps.cuh. Four warps; warp w owns two output rows of the pass (64
//   pixels, four m16 tiles) x 32 output channels (four n8 tiles), 64 f32
//   accumulators a thread. K = 9 x C is walked as (tap row, 16-channel
//   chunk) blocks, chunk outer: a block stages the strip of the warp's two
//   rows at that tap row (2 x 34 pixels, the column halo included) once,
//   with the weights of its three taps, and the loop reads the strip at
//   the three column offsets (one staged pixel a tap staged 64 pixels for
//   each tap: 0.266 ms at VGA 64->64 on an H100). Pixels outside the image
//   and channels past C or Co are zero fills (the padding).
// - f32: the CUDA cores (TF32 would miss the 1e-5 gate). 256 threads, a
//   register-blocked outer product of 4 adjacent pixels x CO output
//   channels a thread (CO = NB / 4, NB the block's channel tile, 32, or 16
//   where 32 would leave the card with under two blocks an SM; 64 took 211
//   registers, 32 at 128 registers spilled with the channel loop unrolled). The input strip (10 x 34
//   pixels, channel major, column fastest) and the weights (channel, tap,
//   NB) of eight input channels are staged with cp.async, two chunks in
//   flight; per channel and tap row a thread loads six strip values and
//   per tap CO / 4 float4 weight vectors, 8-11 FMAs a shared load.
// The epilogue rounds each f32 step on its own (__fmul_rn / __fadd_rn), as
// the plain version computes it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_taps.cuh"

namespace {

constexpr int kCols = 32;      // output columns a block
constexpr int kRows = 8;       // output rows a pass

__device__ __forceinline__ float epilogue(float acc, int co, const float* bias,
                                          const float* scale,
                                          const float* shift,
                                          int relu_before_bn) {
  const float y = __fadd_rn(acc, bias[co]);
  return relu_before_bn
             ? __fadd_rn(__fmul_rn(fmaxf(y, 0.f), scale[co]), shift[co])
             : fmaxf(__fadd_rn(__fmul_rn(y, scale[co]), shift[co]), 0.f);
}

// ---- bf16: tensor cores ----------------------------------------------------

constexpr int kMmaWarps = 4;   // two pass rows each
constexpr int kMmaMT = 4;      // 64 pixels a warp
constexpr int kMmaNT8 = 4;     // 32 output channels a block
constexpr int kStripCols = kCols + 2;      // a row's 32 pixels and halo
constexpr int kStripRows = 2 * kStripCols;  // a warp's two rows
using MmaTile = rcv_mma::Tile<kMmaMT, kMmaNT8, 3, kStripRows>;
constexpr int kMmaSmem = kMmaWarps * MmaTile::kRing * 2;  // bytes

// GEMM row r (pixel r & 31 of the warp's row r >> 5) at tap column dx
// reads strip row (r >> 5) * kStripCols + (r & 31) + dx.
struct StripRows {
  __device__ __forceinline__ int operator()(int dx, int r) const {
    return (r >> 5) * kStripCols + (r & 31) + dx;
  }
};

__global__ void __launch_bounds__(32 * kMmaWarps)
conv_block_mma(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ bias, const float* __restrict__ scale,
               const float* __restrict__ shift, __nv_bfloat16* __restrict__ out,
               int H, int W, int C, int Co, int tile, int relu_before_bn,
               int vec_x, int vec_w) {
  extern __shared__ __align__(16) __nv_bfloat16 mma_smem[];
  __nv_bfloat16* ring = mma_smem + (threadIdx.x >> 5) * MmaTile::kRing;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = blockIdx.x * kCols;
  const int co0 = blockIdx.z * (kMmaNT8 * 8);
  const int tile_row0 = blockIdx.y * tile;
  // K blocks: (tap row dy, 16-channel chunk), chunk outer; the three tap
  // columns dx are the sub-blocks of a block
  const int n_blocks = 3 * ((C + 15) / 16);
  constexpr int kBS = MmaTile::kBStride;

  for (int pass = 0; pass < tile; pass += kRows) {
    // this warp's 64 pixels: pass rows 2*warp, 2*warp + 1, 32 columns each
    const int prow0 = pass + 2 * warp;
    const int orow0 = tile_row0 + prow0;
    float acc[kMmaMT][kMmaNT8][4];
#pragma unroll
    for (int i = 0; i < kMmaMT; ++i)
#pragma unroll
      for (int j = 0; j < kMmaNT8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    auto stage = [&](int j, __nv_bfloat16* a, __nv_bfloat16* b) {
      const int chunk = j / 3, dy = j - chunk * 3;
      // A: the strip of the warp's two rows at tap row dy, columns col0-1
      // .. col0+32, 16 channels, 8 a piece: 136 pieces, up to 5 a lane
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const int piece = lane + 32 * i;
        if (piece >= 2 * kStripRows) break;
        const int p = piece >> 1, half = piece & 1;
        const int ir = orow0 + p / kStripCols + dy - 1;
        const int ic = col0 + p % kStripCols - 1;
        const int ch = chunk * 16 + half * 8;
        const bool ok = ir >= 0 && ir < H && ic >= 0 && ic < W && ch < C;
        const __nv_bfloat16* src =
            ok ? x + ((long long)ir * W + ic) * C + ch : x;
        __nv_bfloat16* dst = a + p * rcv_mma::kAStride + half * 8;
        if (vec_x)
          rcv_mma::cp_async16(dst, src, ok);
        else
          rcv_mma::store8(dst, src, ok ? min(8, C - ch) : 0);
      }
      // B: taps (dy, 0..2) x 16 input channels x 32 output channels, 6
      // pieces a lane
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int piece = lane + 32 * i;
        const int dx = piece >> 6, k = (piece >> 2) & 15, q = piece & 3;
        const int ci = chunk * 16 + k, co = co0 + q * 8;
        const bool ok = ci < C && co < Co;
        const __nv_bfloat16* src =
            ok ? w + ((long long)(dy * 3 + dx) * C + ci) * Co + co : w;
        __nv_bfloat16* dst = b + (dx * 16 + k) * kBS + q * 8;
        if (vec_w)
          rcv_mma::cp_async16(dst, src, ok);
        else
          rcv_mma::store8(dst, src, ok ? min(8, Co - co) : 0);
      }
    };
    rcv_mma::tap_loop<kMmaMT, kMmaNT8, 3, kStripRows>(acc, n_blocks, ring,
                                                      stage, StripRows());

#pragma unroll
    for (int mt = 0; mt < kMmaMT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = mt * 16 + rcv_mma::acc_row(lane, e);
        const int col = col0 + (p & 31);
        if (prow0 + (p >> 5) >= tile || col >= W) continue;
        __nv_bfloat16* o =
            out + ((long long)(orow0 + (p >> 5)) * W + col) * Co;
#pragma unroll
        for (int nt = 0; nt < kMmaNT8; ++nt) {
          // elements e and e + 1 are channels co and co + 1 of one pixel
          const int co = co0 + nt * 8 + rcv_mma::acc_col(lane, e);
          if (e & 1 || co >= Co) continue;
          const float v0 = epilogue(acc[mt][nt][e], co, bias, scale, shift,
                                    relu_before_bn);
          if (co + 1 < Co && Co % 2 == 0) {
            *reinterpret_cast<__nv_bfloat162*>(o + co) = __floats2bfloat162_rn(
                v0, epilogue(acc[mt][nt][e + 1], co + 1, bias, scale, shift,
                             relu_before_bn));
          } else {
            o[co] = __float2bfloat16_rn(v0);
            if (co + 1 < Co)
              o[co + 1] = __float2bfloat16_rn(epilogue(
                  acc[mt][nt][e + 1], co + 1, bias, scale, shift,
                  relu_before_bn));
          }
        }
      }
  }
}

// ---- f32: CUDA cores -------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kCk = 8;                 // input channels a stage
constexpr int kSRows = kRows + 2;
constexpr int kSCols = kCols + 4;      // 34 used; even, so float2 loads align

template <int NB>
constexpr int f32_smem_bytes() {
  return 2 * (kCk * kSRows * kSCols + kCk * 9 * NB) * 4;
}

// Two blocks an SM: at most 128 registers a thread
template <int NB>
__global__ void __launch_bounds__(kF32Threads, 2)
conv_block_f32(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, const float* __restrict__ scale,
               const float* __restrict__ shift, float* __restrict__ out, int H,
               int W, int C, int Co, int tile, int relu_before_bn, int vec_w) {
  constexpr int CO = NB / 4;
  constexpr int kXs = kCk * kSRows * kSCols;
  constexpr int kWs = kCk * 9 * NB;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int ty = tid >> 5, lane = tid & 31;
  const int cg = lane & 7, og = lane >> 3;   // 4-column group, channel group
  const int col0 = blockIdx.x * kCols;
  const int co0 = blockIdx.z * NB;
  const int tile_row0 = blockIdx.y * tile;
  const int n_chunks = (C + kCk - 1) / kCk;

  for (int pass = 0; pass < tile; pass += kRows) {
    const int row0 = tile_row0 + pass;
    auto stage = [&](int k, int buf) {
      float* xs = smem + buf * (kXs + kWs);
      float* ws = xs + kXs;
      const int c0 = k * kCk;
      // the strip, rows row0-1 .. row0+8, cols col0-1 .. col0+32: channel
      // fastest in the loop, so a warp reads whole pixels
      for (int i = tid; i < kCk * kSRows * (kCols + 2); i += kF32Threads) {
        const int ci = i % kCk;
        const int pix = i / kCk;
        const int sc = pix % (kCols + 2), sr = pix / (kCols + 2);
        const int gr = row0 - 1 + sr, gc = col0 - 1 + sc, gch = c0 + ci;
        const bool ok = gr >= 0 && gr < H && gc >= 0 && gc < W && gch < C;
        rcv_mma::cp_async4(&xs[(ci * kSRows + sr) * kSCols + sc],
                           ok ? x + ((long long)gr * W + gc) * C + gch : x, ok);
      }
      // the weights, ws[ci][tap][co]
      if (vec_w) {
        for (int i = tid; i < kCk * 9 * NB / 4; i += kF32Threads) {
          const int q = i % (NB / 4), rest = i / (NB / 4);
          const int tap = rest % 9, ci = rest / 9;
          const int gch = c0 + ci, gco = co0 + 4 * q;
          const bool ok = gch < C && gco < Co;
          rcv_mma::cp_async16(&ws[(ci * 9 + tap) * NB + 4 * q],
                              ok ? w + ((long long)tap * C + gch) * Co + gco : w,
                              ok);
        }
      } else {
        for (int i = tid; i < kWs; i += kF32Threads) {
          const int co = i % NB, rest = i / NB;
          const int tap = rest % 9, ci = rest / 9;
          const int gch = c0 + ci, gco = co0 + co;
          const bool ok = gch < C && gco < Co;
          rcv_mma::cp_async4(&ws[i],
                             ok ? w + ((long long)tap * C + gch) * Co + gco : w,
                             ok);
        }
      }
    };

    float acc[4][CO];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < CO; ++q) acc[p][q] = 0.f;

    stage(0, 0);
    rcv_mma::cp_async_commit();
    for (int k = 0; k < n_chunks; ++k) {
      if (k + 1 < n_chunks) stage(k + 1, (k + 1) & 1);
      rcv_mma::cp_async_commit();
      rcv_mma::cp_async_wait<1>();
      __syncthreads();
      const float* xs = smem + (k & 1) * (kXs + kWs);
      const float* ws = xs + kXs;
#pragma unroll 1
      for (int ci = 0; ci < kCk; ++ci) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          float xv[6];
          const float2* xr = reinterpret_cast<const float2*>(
              &xs[(ci * kSRows + ty + dy) * kSCols + 4 * cg]);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const float2 v = xr[i];
            xv[2 * i] = v.x;
            xv[2 * i + 1] = v.y;
          }
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float4* wv = reinterpret_cast<const float4*>(
                &ws[(ci * 9 + dy * 3 + dx) * NB + og * CO]);
#pragma unroll
            for (int j = 0; j < CO / 4; ++j) {
              const float4 q = wv[j];
#pragma unroll
              for (int p = 0; p < 4; ++p) {
                const float xp = xv[p + dx];
                acc[p][4 * j + 0] = fmaf(xp, q.x, acc[p][4 * j + 0]);
                acc[p][4 * j + 1] = fmaf(xp, q.y, acc[p][4 * j + 1]);
                acc[p][4 * j + 2] = fmaf(xp, q.z, acc[p][4 * j + 2]);
                acc[p][4 * j + 3] = fmaf(xp, q.w, acc[p][4 * j + 3]);
              }
            }
          }
        }
      }
      __syncthreads();  // everyone is done with this buffer before refill
    }

    const int row = row0 + ty;
    if (pass + ty < tile) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int col = col0 + 4 * cg + p;
        if (col >= W) continue;
        float* o = out + ((long long)row * W + col) * Co;
#pragma unroll
        for (int q = 0; q < CO; ++q) {
          const int co = co0 + og * CO + q;
          if (co < Co)
            o[co] = epilogue(acc[p][q], co, bias, scale, shift,
                             relu_before_bn);
        }
      }
    }
  }
}

template <int NB>
cudaError_t launch_f32(const float* x, const float* w, const float* bias,
                       const float* scale, const float* shift, float* out,
                       int H, int W, int C, int Co, int tile,
                       int relu_before_bn, int vec_w, cudaStream_t s) {
  constexpr int bytes = f32_smem_bytes<NB>();
  static bool attr_set = false;  // once per process and instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_block_f32<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((W + kCols - 1) / kCols, H / tile, (Co + NB - 1) / NB);
  conv_block_f32<NB><<<grid, kF32Threads, bytes, s>>>(
      x, w, bias, scale, shift, out, H, W, C, Co, tile, relu_before_bn, vec_w);
  return cudaSuccess;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n < 1) n = 1;
  }
  return n;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

}  // namespace

// x: (H, W, C) and w: (3, 3, C, Co) at the same dtype (is_bf16: bf16, else
// f32), bias/scale/shift: (Co,) f32, out: (H, W, Co) at x's dtype; all
// contiguous device pointers. tile divides H. Returns cudaGetLastError()
// after the launch.
extern "C" int rcv_conv3x3_block(const void* x, const void* w,
                                 const void* bias, const void* scale,
                                 const void* shift, void* out, int H, int W,
                                 int C, int Co, int tile, int relu_before_bn,
                                 int is_bf16, void* stream) {
  if (H < 1 || W < 1 || C < 1 || Co < 1 || tile < 1 || H % tile != 0 ||
      H / tile > 65535 || (Co + 15) / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int col_blocks = (W + kCols - 1) / kCols;
  if (is_bf16) {
    // the warps' rings: 56 KB, dynamic shared memory past 48 KB
    static bool attr_set = false;
    if (!attr_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          conv_block_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMmaSmem);
      if (e != cudaSuccess) return (int)e;
      attr_set = true;
    }
    dim3 grid(col_blocks, H / tile, (Co + kMmaNT8 * 8 - 1) / (kMmaNT8 * 8));
    conv_block_mma<<<grid, 32 * kMmaWarps, kMmaSmem, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)bias,
        (const float*)scale, (const float*)shift, (__nv_bfloat16*)out, H, W, C,
        Co, tile, relu_before_bn, C % 8 == 0 && aligned16(x),
        Co % 8 == 0 && aligned16(w));
    return (int)cudaGetLastError();
  }
  // the wider channel tile where its grid still gives two blocks an SM
  const long long rows = (long long)col_blocks * (H / tile);
  const int vec_w = Co % 4 == 0 && aligned16(w);
  cudaError_t e;
  const float *xf = (const float*)x, *wf = (const float*)w;
  const float *bf = (const float*)bias, *sc = (const float*)scale,
              *sh = (const float*)shift;
  float* of = (float*)out;
  if (rows * ((Co + 31) / 32) >= 2 * sm_count())
    e = launch_f32<32>(xf, wf, bf, sc, sh, of, H, W, C, Co, tile,
                       relu_before_bn, vec_w, s);
  else
    e = launch_f32<16>(xf, wf, bf, sc, sh, of, H, W, C, Co, tile,
                       relu_before_bn, vec_w, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
