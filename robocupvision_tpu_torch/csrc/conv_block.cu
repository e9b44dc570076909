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
// Bound on the H100: operations for C = Co >= 64 in f32 (every multiply-add
// runs on the CUDA cores: 2 * 9 * C * Co FLOP a pixel against 4 * (C + Co)
// bytes), bytes or operations in bf16 depending on the width (chip_smoke.py
// computes both). This first kernel does not use the tensor cores.
//
// Design: a block owns `tile` output rows (the TPU kernel's row tile; it
// walks them eight at a time) x 32 columns x 32 output channels; 256
// threads, one output pixel each, 32 f32 accumulators a thread. The input
// strip with its one-pixel halo (10 x 34 pixels) and the matching weights
// are staged in shared memory 16 input channels at a time, converted to
// f32 (bf16 x bf16 products are exact in f32). The strip is stored channel
// major, column fastest, so the 32 lanes of a warp read 32 consecutive
// words; the weights of one (channel, tap) are the same for the whole block
// and read as broadcasts. Outside the image the strip holds zeros: the
// padding of the convolution. The epilogue rounds each f32 step on its own
// (__fmul_rn / __fadd_rn), as the plain version computes it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;      // output columns a block (threadIdx.x)
constexpr int kRows = 8;       // output rows a pass (threadIdx.y)
constexpr int kCoBlk = 32;     // output channels a block, a thread
constexpr int kCk = 16;        // input channels staged at a time
constexpr int kSRows = kRows + 2;
constexpr int kSCols = kCols + 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kCols * kRows)
conv_block_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ bias,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift, T* __restrict__ out,
                  int H, int W, int C, int Co, int tile, int relu_before_bn) {
  __shared__ float xs[kCk][kSRows][kSCols];
  __shared__ __align__(16) float ws[kCk][9][kCoBlk];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kCols + tx;
  const int col0 = blockIdx.x * kCols;
  const int co0 = blockIdx.z * kCoBlk;
  const int tile_row0 = blockIdx.y * tile;

  for (int pass = 0; pass < tile; pass += kRows) {
    const int row0 = tile_row0 + pass;
    float acc[kCoBlk];
#pragma unroll
    for (int j = 0; j < kCoBlk; ++j) acc[j] = 0.f;

    for (int c0 = 0; c0 < C; c0 += kCk) {
      // the input strip: rows row0-1 .. row0+8, cols col0-1 .. col0+32
      for (int i = tid; i < kCk * kSRows * kSCols; i += kCols * kRows) {
        const int ci = i % kCk;
        const int pix = i / kCk;
        const int sc = pix % kSCols;
        const int sr = pix / kSCols;
        const int gr = row0 - 1 + sr, gc = col0 - 1 + sc, gch = c0 + ci;
        float v = 0.f;
        if (gr >= 0 && gr < H && gc >= 0 && gc < W && gch < C)
          v = to_f32(x[((long long)gr * W + gc) * C + gch]);
        xs[ci][sr][sc] = v;
      }
      // the weights of these channels: ws[ci][tap][co]
      for (int i = tid; i < kCk * 9 * kCoBlk; i += kCols * kRows) {
        const int co = i % kCoBlk;
        const int tap = (i / kCoBlk) % 9;
        const int ci = i / (kCoBlk * 9);
        const int gch = c0 + ci, gco = co0 + co;
        float v = 0.f;
        if (gch < C && gco < Co)
          v = to_f32(w[((long long)tap * C + gch) * Co + gco]);
        ws[ci][tap][co] = v;
      }
      __syncthreads();
#pragma unroll 2
      for (int ci = 0; ci < kCk; ++ci) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float xv = xs[ci][ty + dy][tx + dx];
            const float4* wv =
                reinterpret_cast<const float4*>(&ws[ci][dy * 3 + dx][0]);
#pragma unroll
            for (int j = 0; j < kCoBlk / 4; ++j) {
              const float4 q = wv[j];
              acc[4 * j + 0] = fmaf(xv, q.x, acc[4 * j + 0]);
              acc[4 * j + 1] = fmaf(xv, q.y, acc[4 * j + 1]);
              acc[4 * j + 2] = fmaf(xv, q.z, acc[4 * j + 2]);
              acc[4 * j + 3] = fmaf(xv, q.w, acc[4 * j + 3]);
            }
          }
        }
      }
      __syncthreads();
    }

    const int row = row0 + ty, col = col0 + tx;
    if (pass + ty < tile && row < H && col < W) {
      T* o = out + ((long long)row * W + col) * Co;
#pragma unroll
      for (int j = 0; j < kCoBlk; ++j) {
        const int co = co0 + j;
        if (co < Co) {
          const float y = __fadd_rn(acc[j], bias[co]);
          const float v =
              relu_before_bn
                  ? __fadd_rn(__fmul_rn(fmaxf(y, 0.f), scale[co]), shift[co])
                  : fmaxf(__fadd_rn(__fmul_rn(y, scale[co]), shift[co]), 0.f);
          store(o + co, v);
        }
      }
    }
  }
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
      H / tile > 65535 || (Co + kCoBlk - 1) / kCoBlk > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((W + kCols - 1) / kCols, H / tile, (Co + kCoBlk - 1) / kCoBlk);
  dim3 block(kCols, kRows);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    conv_block_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)bias,
        (const float*)scale, (const float*)shift, (__nv_bfloat16*)out, H, W, C,
        Co, tile, relu_before_bn);
  else
    conv_block_kernel<float><<<grid, block, 0, s>>>(
        (const float*)x, (const float*)w, (const float*)bias,
        (const float*)scale, (const float*)shift, (float*)out, H, W, C, Co,
        tile, relu_before_bn);
  return (int)cudaGetLastError();
}
