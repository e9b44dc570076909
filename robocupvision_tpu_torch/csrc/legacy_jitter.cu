// K4 `legacy_jitter`: the legacy pipeline's augmentation of a batch of
// YUV-normalized NHWC f32 images and their labels -- each sample's
// horizontal and vertical flips, then torchvision's ColorJitter (brightness,
// contrast, saturation, hue) in RGB with the sample's own op order -- each
// op run once per pixel, in registers.
//
// Replaces no TPU kernel: the JAX package's `legacy_augment_batch`
// (robocupvision_tpu/ops/color.py) is plain jnp, which XLA fuses on the TPU.
// Its plain PyTorch form (ops/color.py `legacy_augment_batch_plain`) has to
// support a per-sample op order in one batch, so at each of the four
// positions it computes all four ops on the whole batch and picks one per
// sample with `torch.where`: sixteen op evaluations, four of them the HSV
// round trip with its stacks, a few hundred launches and tens of GB moved a
// b32 VGA batch.
//
// Bound on the H100: bytes. The arithmetic is tens of operations a pixel;
// the least traffic is pass 1's read of the image, pass 2's read and write
// of it and the labels' read and write: at b32 x 480 x 640 x 3 f32 with
// int32 labels 0.43 GB, 0.13 ms at 3.35 TB/s (int64: 0.51 GB, 0.15 ms;
// chip_smoke.py computes it).
//
// Design:
// - pass 1 (jitter only): contrast blends toward the mean grey of the image
//   as it stands when contrast's turn comes, so each sample needs one mean:
//   that of the grey after the ops before contrast in its order. A mean over
//   the whole image does not change under a flip, so pass 1 reads the input
//   unflipped and in order, runs those ops, and sums the grey in double per
//   thread, then per block in a fixed order (shuffles, then the warps in
//   turn) into one partial a block: `parts` partials a sample. No atomics:
//   the sum repeats bit for bit on a card.
// - pass 2: each block first sums its sample's partials in a fixed order
//   (one warp, xor shuffles: every lane holds the same sum). Then a thread
//   takes one output group: four pixels of a row (three float4 loads and
//   stores, where C = 3 and W % 4 == 0) or one pixel. It reads the source
//   pixels at the flipped coordinates (a flipped group of four is the
//   mirrored group, read whole and reversed in registers), undoes the
//   normalization and the YUV transform, clamps to [0, 1], runs the four
//   ops in the sample's order, converts back and writes; the labels at the
//   same coordinates are copied in the same thread, four at a time as one
//   load of their own width where the group is four pixels.
// - without the jitter, pass 2 alone is a gather of any channel count (the
//   LabelProp inputs' 8 channels), float4 a pixel where C % 4 == 0.
// - grid (blocks a sample, samples), so a block's sample, draws and op
//   order are uniform: the op switch never diverges inside a warp.
// - the draws (flips, factors, order) are read on the card: no host sync.
//
// Semantics as the plain version, in form: colorsys's `r == max`, then
// `g == max` branch chain, a grey pixel has h = s = 0, `x % 1.0` with
// Python's sign rule (x - floor(x)), the sector floor(6h) mod 6, each op
// clamped to [0, 1]; the colour matrices and grey weights are the plain
// version's f32 values, passed in by the wrapper.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxParts = 64;            // pass 1's blocks (partials) a sample
constexpr long long kMaxBatch = 65535;   // gridDim.y

// Normalize([.5, 0, 0], [.5, .5, .5]) of the legacy datasets:
// yuv = x * 0.5 + (0.5, 0, 0); its inverse x = (yuv - (0.5, 0, 0)) / 0.5
struct Consts {
  float rgb_from_yuv[9];  // row-major [d][c]: rgb_d = sum_c yuv_c m[d][c]
  float yuv_from_rgb[9];
  float gray[3];          // PIL's convert("L") weights
};

struct Draws {
  const uint8_t* hflip;     // (N,) bool
  const uint8_t* vflip;     // (N,) bool
  const float* b;           // (N,) brightness factor
  const float* c;           // (N,) contrast factor
  const float* s;           // (N,) saturation factor
  const float* h;           // (N,) hue shift, turns
  const long long* order;   // (N, 4): the op at each position
};

// one sample's draws, as a block reads them
struct Sample {
  bool hflip, vflip;
  float b, c, s, h;
  int order[4];
  int before_contrast;      // positions before contrast's
};

template <bool kJitter>
__device__ __forceinline__ Sample load_sample(const Draws& d, int n) {
  Sample q;
  q.hflip = d.hflip[n] != 0;
  q.vflip = d.vflip[n] != 0;
  q.b = q.c = q.s = q.h = 0.f;
  q.before_contrast = 4;
  q.order[0] = q.order[1] = q.order[2] = q.order[3] = 0;
  if (kJitter) {
    q.b = d.b[n];
    q.c = d.c[n];
    q.s = d.s[n];
    q.h = d.h[n];
#pragma unroll
    for (int k = 0; k < 4; ++k) q.order[k] = (int)d.order[4 * n + k];
#pragma unroll
    for (int k = 3; k >= 0; --k)
      if (q.order[k] == 1) q.before_contrast = k;
  }
  return q;
}

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.f), 1.f);
}

// x % 1.0 with Python's sign rule
__device__ __forceinline__ float mod1(float x) { return x - floorf(x); }

__device__ __forceinline__ float gray_of(const Consts& k, const float* p) {
  return p[0] * k.gray[0] + p[1] * k.gray[1] + p[2] * k.gray[2];
}

// normalized YUV -> RGB in [0, 1]
__device__ __forceinline__ void to_rgb(const Consts& k, const float* x,
                                       float* p) {
  const float y = x[0] * 0.5f + 0.5f, u = x[1] * 0.5f, v = x[2] * 0.5f;
#pragma unroll
  for (int d = 0; d < 3; ++d)
    p[d] = clamp01(y * k.rgb_from_yuv[3 * d] + u * k.rgb_from_yuv[3 * d + 1] +
                   v * k.rgb_from_yuv[3 * d + 2]);
}

// RGB -> normalized YUV
__device__ __forceinline__ void to_yuv(const Consts& k, const float* p,
                                       float* x) {
  float yuv[3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
    yuv[d] = p[0] * k.yuv_from_rgb[3 * d] + p[1] * k.yuv_from_rgb[3 * d + 1] +
             p[2] * k.yuv_from_rgb[3 * d + 2];
  x[0] = (yuv[0] - 0.5f) * 2.f;
  x[1] = yuv[1] * 2.f;
  x[2] = yuv[2] * 2.f;
}

// the hue op: RGB -> HSV (colorsys), hue shifted by `shift` turns, -> RGB
__device__ __forceinline__ void hue_op(float* p, float shift) {
  const float r = p[0], g = p[1], b = p[2];
  const float maxc = fmaxf(r, fmaxf(g, b)), minc = fminf(r, fminf(g, b));
  const float v = maxc, rng = maxc - minc;
  const float s = maxc > 0.f ? rng / fmaxf(maxc, 1e-12f) : 0.f;
  const float safe = fmaxf(rng, 1e-12f);
  const float rc = (maxc - r) / safe, gc = (maxc - g) / safe,
              bc = (maxc - b) / safe;
  float h = r == maxc ? bc - gc : (g == maxc ? 2.f + rc - bc : 4.f + gc - rc);
  h = rng > 0.f ? mod1(h / 6.f) : 0.f;
  h = mod1(h + shift);
  const float i = floorf(h * 6.f);
  const float f = h * 6.f - i;
  const float pp = v * (1.f - s), qq = v * (1.f - s * f),
              tt = v * (1.f - s * (1.f - f));
  int sector = (int)i % 6;
  if (sector < 0) sector += 6;
  float o0, o1, o2;
  switch (sector) {
    case 0: o0 = v; o1 = tt; o2 = pp; break;
    case 1: o0 = qq; o1 = v; o2 = pp; break;
    case 2: o0 = pp; o1 = v; o2 = tt; break;
    case 3: o0 = pp; o1 = qq; o2 = v; break;
    case 4: o0 = tt; o1 = pp; o2 = v; break;
    default: o0 = v; o1 = pp; o2 = qq; break;
  }
  p[0] = clamp01(o0);
  p[1] = clamp01(o1);
  p[2] = clamp01(o2);
}

// op `op` (0 brightness, 1 contrast, 2 saturation, else hue) on one pixel
__device__ __forceinline__ void apply_op(int op, const Consts& k,
                                         const Sample& q, float mean,
                                         float* p) {
  if (op == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) p[i] = clamp01(p[i] * q.b);
  } else if (op == 1) {
    const float m = (1.f - q.c) * mean;
#pragma unroll
    for (int i = 0; i < 3; ++i) p[i] = clamp01(q.c * p[i] + m);
  } else if (op == 2) {
    const float m = (1.f - q.s) * gray_of(k, p);
#pragma unroll
    for (int i = 0; i < 3; ++i) p[i] = clamp01(q.s * p[i] + m);
  } else {
    hue_op(p, q.h);
  }
}

// kPix pixels of 3 f32 from `src` (16-byte aligned where kPix == 4)
template <int kPix>
__device__ __forceinline__ void load_rgb_group(const float* src,
                                               float (*px)[3]) {
  if constexpr (kPix == 4) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    const float4 a = s4[0], b = s4[1], c = s4[2];
    const float f[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                         b.z, b.w, c.x, c.y, c.z, c.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 3; ++i) px[j][i] = f[3 * j + i];
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) px[0][i] = src[i];
  }
}

template <int kPix>
__device__ __forceinline__ void store_rgb_group(float* dst,
                                                const float (*px)[3]) {
  if constexpr (kPix == 4) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    d4[0] = make_float4(px[0][0], px[0][1], px[0][2], px[1][0]);
    d4[1] = make_float4(px[1][1], px[1][2], px[2][0], px[2][1]);
    d4[2] = make_float4(px[2][2], px[3][0], px[3][1], px[3][2]);
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) dst[i] = px[0][i];
  }
}

// four labels of type L from an address aligned to 4 * sizeof(L)
template <typename L>
__device__ __forceinline__ void load_labels4(const L* src, L* v) {
  if constexpr (sizeof(L) == 1) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(src);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (L)((w >> (8 * j)) & 0xffu);
  } else if constexpr (sizeof(L) == 4) {
    const uint4 w = *reinterpret_cast<const uint4*>(src);
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (L)u[j];
  } else {
    static_assert(sizeof(L) == 8, "labels of 1, 4 or 8 bytes");
    const ulonglong2* s2 = reinterpret_cast<const ulonglong2*>(src);
    const ulonglong2 a = s2[0], b = s2[1];
    v[0] = (L)a.x; v[1] = (L)a.y; v[2] = (L)b.x; v[3] = (L)b.y;
  }
}

template <typename L>
__device__ __forceinline__ void store_labels4(L* dst, const L* v) {
  if constexpr (sizeof(L) == 1) {
    uint32_t w = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) w |= (uint32_t)(uint8_t)v[j] << (8 * j);
    *reinterpret_cast<uint32_t*>(dst) = w;
  } else if constexpr (sizeof(L) == 4) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4((uint32_t)v[0], (uint32_t)v[1], (uint32_t)v[2],
                   (uint32_t)v[3]);
  } else {
    ulonglong2* d2 = reinterpret_cast<ulonglong2*>(dst);
    d2[0] = make_ulonglong2((unsigned long long)v[0],
                            (unsigned long long)v[1]);
    d2[1] = make_ulonglong2((unsigned long long)v[2],
                            (unsigned long long)v[3]);
  }
}

// the block's sum of `v` in a fixed order; valid in thread 0
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sums[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) t += warp_sums[w];
  return t;
}

// Pass 1: partials[n * parts + blockIdx.x], the block's share of sample n's
// sum of grey after the ops before contrast, over the unflipped image.
template <int kPix>
__global__ void __launch_bounds__(kThreads)
    contrast_partials(const float* __restrict__ img, Draws d, Consts k,
                      long long hw, int parts, double* __restrict__ partials) {
  const int n = blockIdx.y;
  const Sample q = load_sample<true>(d, n);
  const float* base = img + (long long)n * hw * 3;
  const long long groups = hw / kPix;
  double acc = 0.0;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
       g < groups; g += (long long)parts * kThreads) {
    float x[kPix][3];
    load_rgb_group<kPix>(base + g * kPix * 3, x);
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      float p[3];
      to_rgb(k, x[j], p);
#pragma unroll
      for (int pos = 0; pos < 4; ++pos)
        if (pos < q.before_contrast) apply_op(q.order[pos], k, q, 0.f, p);
      acc += (double)gray_of(k, p);
    }
  }
  const double t = block_sum(acc);
  if (threadIdx.x == 0) partials[(long long)n * parts + blockIdx.x] = t;
}

struct NoLabel {};

// Pass 2: one output group (kPix pixels of a row) a thread. kPix == 4 needs
// C == 3, W % 4 == 0 and aligned tensors; kJitter needs C == 3.
template <typename L, bool kJitter, int kPix>
__global__ void __launch_bounds__(kThreads)
    augment_pixels(const float* __restrict__ img, float* __restrict__ out,
                   const L* __restrict__ lab, L* __restrict__ lab_out, Draws d,
                   Consts k, const double* __restrict__ partials, int parts,
                   int H, int W, int C, int vec4) {
  constexpr bool kLabels = !std::is_same<L, NoLabel>::value;
  const int n = blockIdx.y;
  const Sample q = load_sample<kJitter>(d, n);
  const long long hw = (long long)H * W;
  float mean = 0.f;
  if constexpr (kJitter) {
    __shared__ float s_mean;
    if (threadIdx.x < 32) {
      double v = 0.0;
      for (int i = threadIdx.x; i < parts; i += 32)
        v += partials[(long long)n * parts + i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (threadIdx.x == 0) s_mean = (float)(v / (double)hw);
    }
    __syncthreads();
    mean = s_mean;
  }
  const long long u = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int per_row = W / kPix;
  if (u >= (long long)H * per_row) return;
  const int h = (int)(u / per_row), w = (int)(u % per_row) * kPix;
  const int sh = q.vflip ? H - 1 - h : h;
  const int sw = q.hflip ? W - kPix - w : w;  // the mirrored group's first
  const long long dst_px = (long long)n * hw + (long long)h * W + w;
  const long long src_px = (long long)n * hw + (long long)sh * W + sw;

  if constexpr (kJitter || kPix == 4) {  // C == 3
    float px[kPix][3];
    load_rgb_group<kPix>(img + src_px * 3, px);
    if (kPix == 4 && q.hflip) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float t = px[0][i]; px[0][i] = px[3][i]; px[3][i] = t;
        t = px[1][i]; px[1][i] = px[2][i]; px[2][i] = t;
      }
    }
    if constexpr (kJitter) {
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        float p[3];
        to_rgb(k, px[j], p);
#pragma unroll
        for (int pos = 0; pos < 4; ++pos)
          apply_op(q.order[pos], k, q, mean, p);
        to_yuv(k, p, px[j]);
      }
    }
    store_rgb_group<kPix>(out + dst_px * 3, px);
  } else if (vec4) {  // one pixel of C % 4 == 0 channels
    const float4* s4 = reinterpret_cast<const float4*>(img + src_px * C);
    float4* d4 = reinterpret_cast<float4*>(out + dst_px * C);
    for (int i = 0; i < C / 4; ++i) d4[i] = s4[i];
  } else {
    const float* s = img + src_px * C;
    float* o = out + dst_px * C;
    for (int i = 0; i < C; ++i) o[i] = s[i];
  }

  if constexpr (kLabels) {
    if constexpr (kPix == 4) {
      L v[4];
      load_labels4(lab + src_px, v);
      if (q.hflip) {
        L t = v[0]; v[0] = v[3]; v[3] = t;
        t = v[1]; v[1] = v[2]; v[2] = t;
      }
      store_labels4(lab_out + dst_px, v);
    } else {
      lab_out[dst_px] = lab[src_px];
    }
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename L, bool kJitter>
cudaError_t launch(const float* img, float* out, const void* lab,
                   void* lab_out, const Draws& d, const Consts& k,
                   double* partials, int N, int H, int W, int C,
                   cudaStream_t stream) {
  constexpr int kLabelBytes = sizeof(L);  // NoLabel: 1
  const bool four = C == 3 && W % 4 == 0 && aligned(img, 16) &&
                    aligned(out, 16) && aligned(lab, 4 * kLabelBytes) &&
                    aligned(lab_out, 4 * kLabelBytes);
  const int pix = four ? 4 : 1;
  const long long hw = (long long)H * W;
  const long long groups = hw / pix;
  int parts = 0;
  if (kJitter) {
    // about one wave of 256-thread blocks (8 an SM), and no block without
    // a group
    const int sms = sm_count();
    if (sms == 0) return cudaErrorInvalidDevice;
    long long p = ((long long)sms * 8 + N - 1) / N;
    const long long most = (groups + kThreads - 1) / kThreads;
    if (p > most) p = most;
    if (p > kMaxParts) p = kMaxParts;
    if (p < 1) p = 1;
    parts = (int)p;
    dim3 grid1(parts, N);
    if (four)
      contrast_partials<4><<<grid1, kThreads, 0, stream>>>(img, d, k, hw,
                                                           parts, partials);
    else
      contrast_partials<1><<<grid1, kThreads, 0, stream>>>(img, d, k, hw,
                                                           parts, partials);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dim3 grid2((unsigned)blocks, N);
  const int vec4 = C % 4 == 0 && aligned(img, 16) && aligned(out, 16);
  const L* l = static_cast<const L*>(lab);
  L* lo = static_cast<L*>(lab_out);
  if (four)
    augment_pixels<L, kJitter, 4><<<grid2, kThreads, 0, stream>>>(
        img, out, l, lo, d, k, partials, parts, H, W, C, vec4);
  else
    augment_pixels<L, kJitter, 1><<<grid2, kThreads, 0, stream>>>(
        img, out, l, lo, d, k, partials, parts, H, W, C, vec4);
  return cudaGetLastError();
}

template <typename L>
cudaError_t by_jitter(int jitter, const float* img, float* out,
                      const void* lab, void* lab_out, const Draws& d,
                      const Consts& k, double* partials, int N, int H, int W,
                      int C, cudaStream_t stream) {
  if (jitter)
    return launch<L, true>(img, out, lab, lab_out, d, k, partials, N, H, W, C,
                           stream);
  return launch<L, false>(img, out, lab, lab_out, d, k, partials, N, H, W, C,
                          stream);
}

}  // namespace

// img, out: (N, H, W, C) f32, contiguous, on the current device; labels,
// labels_out: (N, H, W) of `label_size` bytes (1: uint8, 4: int32, 8: int64;
// 0: no labels, both null); hflip, vflip: (N,) bool; with `jitter`: C == 3,
// b, c, s, h: (N,) f32, order: (N, 4) int64 (a permutation of 0..3 a
// sample), partials: at least N * 64 doubles, and consts: 21 host floats,
// rgb_from_yuv and yuv_from_rgb (row-major) and the grey weights. Without
// `jitter` those may be null. Launches on `stream` (pass 1 with `jitter`,
// then pass 2) and returns cudaGetLastError() after the launches.
extern "C" int rcv_legacy_jitter(const void* img, void* out, const void* labels,
                                 void* labels_out, int label_size,
                                 const void* hflip, const void* vflip,
                                 const void* b, const void* c, const void* s,
                                 const void* h, const void* order,
                                 void* partials, const float* consts, int N,
                                 int H, int W, int C, int jitter,
                                 void* stream) {
  if (N < 0 || N > kMaxBatch || H < 0 || W < 0 || C < 1 ||
      (jitter && (C != 3 || consts == nullptr || partials == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (N == 0 || H == 0 || W == 0) return (int)cudaSuccess;
  Draws d{static_cast<const uint8_t*>(hflip), static_cast<const uint8_t*>(vflip),
          static_cast<const float*>(b),      static_cast<const float*>(c),
          static_cast<const float*>(s),      static_cast<const float*>(h),
          static_cast<const long long*>(order)};
  Consts k{};
  if (consts != nullptr) {
    for (int i = 0; i < 9; ++i) {
      k.rgb_from_yuv[i] = consts[i];
      k.yuv_from_rgb[i] = consts[9 + i];
    }
    for (int i = 0; i < 3; ++i) k.gray[i] = consts[18 + i];
  }
  const float* x = static_cast<const float*>(img);
  float* o = static_cast<float*>(out);
  double* p = static_cast<double*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (label_size) {
    case 0:
      return (int)by_jitter<NoLabel>(jitter, x, o, nullptr, nullptr, d, k, p,
                                     N, H, W, C, st);
    case 1:
      return (int)by_jitter<uint8_t>(jitter, x, o, labels, labels_out, d, k, p,
                                     N, H, W, C, st);
    case 4:
      return (int)by_jitter<int32_t>(jitter, x, o, labels, labels_out, d, k,
                                     p, N, H, W, C, st);
    case 8:
      return (int)by_jitter<int64_t>(jitter, x, o, labels, labels_out, d, k,
                                     p, N, H, W, C, st);
  }
  return (int)cudaErrorInvalidValue;
}
