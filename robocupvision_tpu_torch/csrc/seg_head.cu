// K5 `seg_head`: the SegFormer's folded decoder head
// (models/segformer.py `fold_head`) gathered at 1/4 of the frame, one pass
// a pixel:
//
//   logits[n, y, x] = W_pred ReLU(y_1[n, y, x] + b'
//                          + sum_{i = 2..4} up_i(y_i)[n, y, x]) + b_pred
//
// up_i is PyTorch's bilinear resize to y_1's (H, W) with align_corners
// False: source index scale * (dst + 0.5) - 0.5 with scale = in / out in
// f32, clamped at 0, its second tap clamped at the last row or column. The
// sums run at f32 from f32 or bf16 maps; the logits are stored at the maps'
// dtype.
//
// Replaces no TPU kernel: the JAX package has no SegFormer. Unfolded, the
// decoder was PyTorch's ops, each a pass over device memory: three 768-
// channel maps resized to 1/4 of the frame, a 3072-channel concat, the
// 3072 -> 768 fuse, BN, ReLU and the 768 -> K pred conv.
//
// Bound on the H100: bytes. A pixel takes ~15 flops a channel, against the
// reads of y_1 (D values a pixel) and of the low-resolution maps: at b32
// VGA f32 (y_1 120 x 160 x 768) 1.89 + 0.47 + 0.12 + 0.03 GB read and the
// logits written, ~2.5 GB, ~0.75 ms at 3.35 TB/s.
//
// Design:
// - a block: `tile` output pixels of one row of one image (32, fewer where
//   the staged columns would not fit two blocks an SM), all D channels; a
//   thread a channel quad (D / 4 threads, rounded up to a warp), its 4
//   channels of b' and of the K rows of W_pred in registers.
// - the low-resolution maps: every pixel of the block's row takes the same
//   two source rows of a stage, so a stage's vertical taps are the
//   block's. First each thread reads its quad of every source column the
//   tile needs from those two rows (16-B loads, eight columns' loads in
//   flight, through L2: a column is read by the few blocks whose rows and
//   tiles take it), interpolates it vertically and keeps it in shared
//   memory. Each thread reads back only its own quads, so the stages need
//   no barrier; the tile's horizontal taps are computed once, into shared
//   memory, before them.
// - y_1 read once, 16 B a thread (8 B in bf16) with streaming loads, a
//   group of P pixels at a time, the next group's loads issued before the
//   current group is computed (the first group's before the staging).
// - each pixel's K partial logits (over the thread's 4 channels) stay in
//   registers for a group of P pixels; the warp sums them by recursive
//   halving (P K values in K (P - 1 + log2(32 / P)) shuffles), the warps
//   through shared memory once a tile, where b_pred is added and the
//   logits are stored coalesced.
// - up to kMaxK classes a launch; the C entry launches once more for each
//   further kMaxK, the output strided by K.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kMaxTile = 32;       // output pixels a block, along a row
constexpr int kMaxThreads = 256;   // a thread a channel quad: D <= 1024
constexpr int kMaxK = 8;           // classes a launch
constexpr int kMaxGrid = 65535;    // gridDim.y (rows), gridDim.z (images)
constexpr int kUnroll = 8;         // source columns in flight a thread
// shared memory a block may take: two blocks an SM
constexpr int kSmemBudget = 113 * 1024;

struct Stage {
  const void* ptr;  // (N, h, w, D)
  int h, w;
  float sh, sw;     // in / out, as PyTorch computes a resize's scale
  int col_off;      // first of its column slots in shared memory
};

struct Args {
  const void* y1;       // (N, H, W, D)
  Stage st[3];          // y_2, y_3, y_4
  const float* bias;    // (D,) b'
  const float* w_pred;  // (K, D), this launch's first class
  const float* b_pred;  // (K,), the same
  void* out;            // (N, H, W, k_stride), this launch's first class
  int n, h, w, d, d4, k_stride, tile, part_quads;
};

// the tile's horizontal tap of a stage: columns relative to the tile's
// first source column
struct __align__(16) TileTap {
  int i0, i1;
  float l0, l1;
};

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

template <typename T>
struct Quad;

template <>
struct Quad<float> {
  static __device__ __forceinline__ float4 load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float4 stream(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

__device__ __forceinline__ float4 bf16x4(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

template <>
struct Quad<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load(const __nv_bfloat16* p) {
    return bf16x4(__ldg(reinterpret_cast<const uint2*>(p)));
  }
  static __device__ __forceinline__ float4 stream(const __nv_bfloat16* p) {
    return bf16x4(__ldcs(reinterpret_cast<const uint2*>(p)));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// a bilinear tap along one axis, as PyTorch's upsample_bilinear2d takes it;
// the source index with one rounding (an fma), as the host computes it too
struct Tap {
  int i0, i1;
  float l0, l1;
};

__host__ __device__ __forceinline__ float source_index(float scale, int dst) {
#ifdef __CUDA_ARCH__
  const float s = __fmaf_rn(scale, (float)dst + 0.5f, -0.5f);
#else
  const float s = std::fmaf(scale, (float)dst + 0.5f, -0.5f);
#endif
  return s < 0.f ? 0.f : s;
}

__host__ __device__ __forceinline__ Tap tap(float scale, int dst, int in) {
  const float s = source_index(scale, dst);
  Tap t;
  t.i0 = (int)s;
  t.i1 = t.i0 + (t.i0 < in - 1 ? 1 : 0);
  t.l1 = s - (float)t.i0;
  t.l0 = 1.f - t.l1;
  return t;
}

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z),
                     fmaf(a, x.w, y.w));
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

// v[j]: this lane's partial of pixel j. Leaves in v[0] the warp's sum of
// pixel lane / (32 / P): log2(P) halving steps (the lane whose bit is set
// keeps the upper half of its values, the other the lower, each adding
// its partner's), then a butterfly over the lanes that share a pixel.
template <int P>
__device__ __forceinline__ void warp_sum_pixels(float (&v)[P], int lane) {
#pragma unroll
  for (int step = 0; (P >> (step + 1)) >= 1; ++step) {
    const int half = P >> (step + 1), off = 16 >> step;
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float send = upper ? v[j] : v[j + half];
      const float keep = upper ? v[j + half] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
#pragma unroll
  for (int off = 16 / P; off >= 1; off /= 2)
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
}

template <typename T, int P>
__device__ __forceinline__ void load_group(float4 (&x)[P], const T* row,
                                           long long D, int g, int x_end) {
#pragma unroll
  for (int j = 0; j < P; ++j)
    x[j] = g + j < x_end ? Quad<T>::stream(row + (g + j) * D) : zero4();
}

template <typename T, int K>
__global__ void __launch_bounds__(kMaxThreads)
    seg_head_kernel(const Args a) {
  constexpr int P = K <= 5 ? 8 : 4;   // pixels a group: P K sums in registers
  constexpr int kLanesPerPixel = 32 / P;
  extern __shared__ float4 smem[];
  const int tile = a.tile, threads = blockDim.x;
  TileTap* taps = reinterpret_cast<TileTap*>(smem);         // [3][tile]
  float* part = reinterpret_cast<float*>(smem + 3 * tile);  // [warp][tile][K]
  float4* cols = smem + 3 * tile + a.part_quads;            // [slot][thread]

  const int q = threadIdx.x, lane = q & 31, warp = q >> 5;
  const bool active = q < a.d4;
  const long long D = a.d;
  const int c = 4 * (active ? q : 0);   // idle lanes read quad 0, add 0
  const int n = blockIdx.z, oy = blockIdx.y;
  const int x_begin = blockIdx.x * tile;
  const int x_end = min(x_begin + tile, a.w);

  // the tile's horizontal taps, once a block
  for (int t = q; t < 3 * tile; t += threads) {
    const int s = t / tile, ox = x_begin + t % tile;
    const Stage& st = s == 0 ? a.st[0] : s == 1 ? a.st[1] : a.st[2];
    if (ox < x_end) {
      const int lo = tap(st.sw, x_begin, st.w).i0;
      const Tap tx = tap(st.sw, ox, st.w);
      taps[t] = TileTap{tx.i0 - lo, tx.i1 - lo, tx.l0, tx.l1};
    }
  }

  const T* row =
      static_cast<const T*>(a.y1) + ((long long)n * a.h + oy) * a.w * D + c;
  float4 next[P];
  load_group<T, P>(next, row, D, x_begin, x_end);

  float4 wq[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    wq[k] = __ldg(reinterpret_cast<const float4*>(a.w_pred + k * D + c));
  const float4 bq = __ldg(reinterpret_cast<const float4*>(a.bias + c));

  // each stage's source columns under the tile, vertically interpolated,
  // into this thread's slots
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const Stage& st = a.st[s];
    const Tap ty = tap(st.sh, oy, st.h);
    const T* base =
        static_cast<const T*>(st.ptr) + (long long)n * st.h * st.w * D + c;
    const T* r0 = base + (long long)ty.i0 * st.w * D;
    const T* r1 = base + (long long)ty.i1 * st.w * D;
    const int lo = tap(st.sw, x_begin, st.w).i0;
    const int hi = tap(st.sw, x_end - 1, st.w).i1;
    float4* slot = cols + (long long)st.col_off * threads + q;
    for (int col = lo; col <= hi; col += kUnroll) {
      float4 u0[kUnroll], u1[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long x = min(col + u, hi) * D;   // past hi: a repeat
        u0[u] = Quad<T>::load(r0 + x);
        u1[u] = Quad<T>::load(r1 + x);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (col + u <= hi)
          slot[(col + u - lo) * threads] =
              fma4(ty.l1, u1[u], fma4(ty.l0, u0[u], zero4()));
    }
  }
  __syncthreads();   // the taps

  for (int g = x_begin; g < x_end; g += P) {
    float4 x1v[P];
#pragma unroll
    for (int j = 0; j < P; ++j) x1v[j] = next[j];
    if (g + P < x_end) load_group<T, P>(next, row, D, g + P, x_end);
    float acc[K][P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int ox = g + j;
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k][j] = 0.f;
      if (ox >= x_end) continue;   // the same for the whole block
      float4 h = make_float4(x1v[j].x + bq.x, x1v[j].y + bq.y,
                             x1v[j].z + bq.z, x1v[j].w + bq.w);
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const TileTap tp = taps[s * tile + ox - x_begin];
        const float4* slot = cols + (long long)a.st[s].col_off * threads + q;
        h = fma4(tp.l1, slot[tp.i1 * threads],
                 fma4(tp.l0, slot[tp.i0 * threads], h));
      }
      h = make_float4(fmaxf(h.x, 0.f), fmaxf(h.y, 0.f), fmaxf(h.z, 0.f),
                      fmaxf(h.w, 0.f));
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k][j] = active ? dot4(wq[k], h) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) warp_sum_pixels<P>(acc[k], lane);
    const int p = g - x_begin + lane / kLanesPerPixel;
    if (lane % kLanesPerPixel == 0 && p < x_end - x_begin) {   // tile < P
#pragma unroll
      for (int k = 0; k < K; ++k) part[(warp * tile + p) * K + k] = acc[k][0];
    }
  }
  __syncthreads();
  const int warps = threads / 32;
  T* out = static_cast<T*>(a.out) +
           (((long long)n * a.h + oy) * a.w + x_begin) * a.k_stride;
  for (int t = q; t < (x_end - x_begin) * K; t += threads) {
    const int p = t / K, k = t % K;
    float sum = a.b_pred[k];
    for (int w = 0; w < warps; ++w) sum += part[(w * tile + p) * K + k];
    Quad<T>::store(out + (long long)p * a.k_stride + k, sum);
  }
}

// the most source columns of a stage that a tile of `tile` pixels takes
int columns(const Stage& st, int w, int tile) {
  int most = 0;
  for (int x0 = 0; x0 < w; x0 += tile) {
    const int x1 = (x0 + tile < w ? x0 + tile : w) - 1;
    const int n = tap(st.sw, x1, st.w).i1 - tap(st.sw, x0, st.w).i0 + 1;
    most = n > most ? n : most;
  }
  return most;
}

template <typename T, int K>
cudaError_t launch(Args a, cudaStream_t stream) {
  const int threads = (a.d4 + 31) / 32 * 32;
  const int warps = threads / 32;
  // the widest tile whose staged columns fit the budget
  size_t bytes = 0;
  for (a.tile = kMaxTile;; a.tile /= 2) {
    a.part_quads = (warps * a.tile * K + 3) / 4;
    int slots = 0;
    for (int s = 0; s < 3; ++s) {
      a.st[s].col_off = slots;
      slots += columns(a.st[s], a.w, a.tile);
    }
    bytes = 16 * ((size_t)3 * a.tile + a.part_quads + (size_t)slots * threads);
    if (bytes <= kSmemBudget || a.tile == 1) break;
  }
  auto kernel = seg_head_kernel<T, K>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.w + a.tile - 1) / a.tile, a.h, a.n);
  kernel<<<grid, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_classes(const Args& a, int k, cudaStream_t stream) {
  for (int k0 = 0; k0 < k; k0 += kMaxK) {
    Args b = a;
    b.w_pred = a.w_pred + (long long)k0 * a.d;
    b.b_pred = a.b_pred + k0;
    b.out = static_cast<T*>(a.out) + k0;
    cudaError_t e = cudaErrorInvalidValue;
    switch (k - k0 < kMaxK ? k - k0 : kMaxK) {
      case 1: e = launch<T, 1>(b, stream); break;
      case 2: e = launch<T, 2>(b, stream); break;
      case 3: e = launch<T, 3>(b, stream); break;
      case 4: e = launch<T, 4>(b, stream); break;
      case 5: e = launch<T, 5>(b, stream); break;
      case 6: e = launch<T, 6>(b, stream); break;
      case 7: e = launch<T, 7>(b, stream); break;
      case 8: e = launch<T, 8>(b, stream); break;
    }
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// y1..y4: (N, h_i, w_i, D) f32 (bf16 = 0) or bf16 (bf16 = 1), contiguous,
// each starting on a 4-channel boundary's alignment, on the current
// device; bias: (D,) f32; w_pred: (K, D) f32; b_pred: (K,) f32; out:
// (N, h1, w1, K) of the maps' dtype. D a multiple of 4 up to 1024, N and
// h1 at most 65535, every h_i, w_i at least 1. Launches on `stream`, one
// launch for each 8 classes, and returns the first error of a launch (or
// of setting its shared memory), else cudaGetLastError() after them.
extern "C" int rcv_seg_head(const void* y1, const void* y2, const void* y3,
                            const void* y4, const void* bias,
                            const void* w_pred, const void* b_pred, void* out,
                            int h1, int w1, int h2, int w2, int h3, int w3,
                            int h4, int w4, int N, int D, int K, int bf16,
                            void* stream) {
  if (N < 0 || N > kMaxGrid || K < 0 || D <= 0 || D % 4 ||
      D > 4 * kMaxThreads || h1 < 1 || h1 > kMaxGrid || w1 < 1 || h2 < 1 ||
      w2 < 1 || h3 < 1 || w3 < 1 || h4 < 1 || w4 < 1)
    return (int)cudaErrorInvalidValue;
  if (N == 0 || K == 0) return (int)cudaSuccess;
  Args a{};
  a.y1 = y1;
  const void* maps[3] = {y2, y3, y4};
  const int hs[3] = {h2, h3, h4}, ws[3] = {w2, w3, w4};
  for (int s = 0; s < 3; ++s)
    a.st[s] = Stage{maps[s], hs[s], ws[s], (float)hs[s] / (float)h1,
                    (float)ws[s] / (float)w1, 0};
  a.bias = static_cast<const float*>(bias);
  a.w_pred = static_cast<const float*>(w_pred);
  a.b_pred = static_cast<const float*>(b_pred);
  a.out = out;
  a.n = N;
  a.h = h1;
  a.w = w1;
  a.d = D;
  a.d4 = D / 4;
  a.k_stride = K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? by_classes<__nv_bfloat16>(a, K, st)
                    : by_classes<float>(a, K, st));
}
