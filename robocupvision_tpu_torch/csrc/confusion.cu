// K1 `confusion_count`: per-image confusion counts conf[b, pred, tgt] as
// f32, counted straight from two integer label maps (no one-hots), in one
// launch a call.
//
// Replaces the TPU kernel robocupvision_tpu/ops/pallas_kernels.py
// `confusion_matrix_pallas` (body `_conf_kernel`), which streams each image's
// maps through VMEM and does C*C masked reductions on the VPU.
//
// Labels: each map is read in the type it arrives in (uint8, int32 or
// int64; no copy in between). A label counts by its value cast to int32, as
// the JAX package's `astype(jnp.int32)` casts: an int64 label by its low 32
// bits taken as a signed int32. Labels outside [0, C) are skipped, as both
// JAX paths skip them, and never index memory.
//
// Bound on the H100: bytes. The work is one compare-and-count per pixel;
// each map is read once at its own width and C*C f32 counts are written, so
// the least time is those bytes over the memory rate (chip_smoke.py
// computes it) -- at one serving frame the launch itself costs more.
//
// Design:
// - grid (blocks per image, images), 256 threads a block, one wave on the
//   card. A warp takes 512-pixel chunks: each lane 16 pixels, as kSteps
//   loads of kVec pixels, 16 bytes of the wider map (one uint4 of 16 uint8,
//   4 int32 or 2 int64 labels) and kVec labels of the other, so that every
//   load instruction of the warp reads one contiguous span. A lane issues
//   the loads of its next chunk before it counts the current one.
// - where a map's base or its per-image offset is not 16-byte aligned
//   (offset views), or hw leaves a part chunk, the pixels before the first
//   point where both maps are aligned and after the last whole chunk are
//   read one at a time, in the same launch.
// - counting (`Counting`, picked by C): for C <= 5 each thread owns its
//   C*C counters in shared memory, bin-major, so that the 32 lanes of a
//   warp always hit 32 banks: no atomics and no conflicts, whatever the
//   labels. For larger C each warp owns a histogram that its lanes update
//   with shared atomics (merging the lanes that hit one bin with
//   __match_any_sync first was slower on the card at both label
//   distributions). Skipped labels count into one spare bin.
// - reduction, last-block-done per bin: a block sums its counts per bin
//   and adds them, together with a ticket of 1 << 40, into the bin's 64-bit
//   word of a (B, C*C) workspace with one returning atomic, all bins at
//   once; the block whose add brings the ticket to the image's block count
//   holds the bin's total, writes it as f32 and zeroes the word. No fence
//   and no second pass: one atomic round trip after the count. The
//   workspace is zero between launches, so the caller allocates it once;
//   launches on one stream are ordered, so the next launch sees it zeroed.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanePixels = 16;              // pixels a lane takes a chunk
constexpr int kChunk = 32 * kLanePixels;     // pixels a warp takes a chunk
constexpr int kMaxClasses = 16;              // C*C bins in a warp's histogram
constexpr int kPrivateMaxClasses = 5;        // per-thread counters: (C*C + 1) * 256
constexpr int kMaxDevices = 64;
constexpr long long kMaxBatch = 65535;       // gridDim.y
constexpr int kTicketShift = 40;             // a bin word: ticket << 40 | count
constexpr unsigned long long kCountMask = (1ull << kTicketShift) - 1;

// how a block counts: per-thread counters (C <= kPrivateMaxClasses) or a
// histogram a warp
enum Counting { kPrivate, kWarp };
static_assert(kPrivateMaxClasses * kPrivateMaxClasses <= kThreads / 8,
              "the reduction takes 8 threads a bin");

// N labels of type T in one load, from an address aligned to N * sizeof(T)
// bytes: `load` fetches the raw words (not waiting for them), `label` takes
// the low 32 bits of label i, as uint32
template <typename T, int N>
struct Vec {
  static constexpr int kBytes = N * (int)sizeof(T);
  static constexpr int kWords = kBytes >= 4 ? kBytes / 4 : 1;

  static __device__ __forceinline__ void load(const T* p, uint32_t* w) {
    if constexpr (kBytes == 16) {
      const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
      w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    } else if constexpr (kBytes == 8) {
      const uint2 q = __ldcs(reinterpret_cast<const uint2*>(p));
      w[0] = q.x; w[1] = q.y;
    } else if constexpr (kBytes == 4) {
      w[0] = __ldcs(reinterpret_cast<const unsigned int*>(p));
    } else {
      static_assert(kBytes == 2, "2, 4, 8 or 16 bytes a load");
      w[0] = __ldcs(reinterpret_cast<const unsigned short*>(p));
    }
  }
  static __device__ __forceinline__ uint32_t label(const uint32_t* w, int i) {
    if constexpr (sizeof(T) == 1) return (w[i / 4] >> (8 * (i % 4))) & 0xffu;
    else if constexpr (sizeof(T) == 4) return w[i];
    else return w[2 * i];  // little-endian: the low word of each int64
  }
};

// One lane's 16 pixels of a warp chunk, as raw loaded words: kSteps loads
// of kVec labels from each map, each step's 32 lanes on one contiguous span
template <typename P, typename T>
struct LaneChunk {
  static constexpr int kVec =
      16 / (int)(sizeof(P) > sizeof(T) ? sizeof(P) : sizeof(T));
  static constexpr int kSteps = kLanePixels / kVec;
  using VP = Vec<P, kVec>;
  using VT = Vec<T, kVec>;
  uint32_t pw[kSteps * VP::kWords], tw[kSteps * VT::kWords];

  // `p0`, `t0`: the chunk's first pixel of each map, 16-byte aligned
  __device__ __forceinline__ void load(const P* p0, const T* t0, int lane) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int off = s * 32 * kVec + lane * kVec;
      VP::load(p0 + off, pw + s * VP::kWords);
      VT::load(t0 + off, tw + s * VT::kWords);
    }
  }
  template <int kMode>
  __device__ __forceinline__ void count_into(int* hist, uint32_t C,
                                             uint32_t skip) const;
};

// the bin of a (pred, tgt) pair, or `skip` (== C*C) when either label lies
// outside [0, C): negative int32 values wrap to >= 2**31 as uint32
__device__ __forceinline__ uint32_t bin_of(uint32_t p, uint32_t t, uint32_t C,
                                           uint32_t skip) {
  return (p < C && t < C) ? p * C + t : skip;
}

// Count one pixel into `hist`: the block's per-thread counters (kPrivate) or
// the calling warp's histogram (kWarp)
template <int kMode>
__device__ __forceinline__ void count(int* hist, uint32_t bin, uint32_t skip) {
  if (kMode == kPrivate) {
    hist[bin * kThreads + threadIdx.x] += 1;
  } else if (bin != skip) {
    atomicAdd(&hist[bin], 1);
  }
}

template <typename P, typename T>
template <int kMode>
__device__ __forceinline__ void LaneChunk<P, T>::count_into(
    int* hist, uint32_t C, uint32_t skip) const {
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      count<kMode>(hist, bin_of(VP::label(pw + s * VP::kWords, i),
                                VT::label(tw + s * VT::kWords, i), C, skip),
                   skip);
}

// Add a block's count `s` of bin b of image img, with a ticket, into the
// bin's workspace word; the block whose add brings the ticket to gridDim.x
// (every block is in) writes the total as f32 and zeroes the word
__device__ __forceinline__ void finish_bin(unsigned long long* ws, float* out,
                                           long long img, uint32_t nbins,
                                           int b, int s) {
  const unsigned long long add =
      (1ull << kTicketShift) | (unsigned long long)(unsigned)s;
  unsigned long long* word = ws + img * nbins + b;
  const unsigned long long old = atomicAdd(word, add);
  if ((old >> kTicketShift) == gridDim.x - 1) {
    out[img * nbins + b] = (float)((old + add) & kCountMask);
    *word = 0;
  }
}

template <typename P, typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
confusion_kernel(const P* __restrict__ pred, const T* __restrict__ tgt,
                 float* __restrict__ out, unsigned long long* __restrict__ ws,
                 long long hw, int num_classes) {
  extern __shared__ int hist[];
  const uint32_t C = (uint32_t)num_classes;
  const uint32_t nbins = C * C;
  const int rows = (int)nbins + 1;  // + the bin of skipped pixels
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long img = blockIdx.y;
  const P* p = pred + img * hw;
  const T* t = tgt + img * hw;

  // the first pixel at which both maps are 16-byte aligned; hw if none
  // (then every pixel is read one at a time)
  long long head = hw;
  for (int j = 0; j < 16 && j < hw; ++j) {
    if (((reinterpret_cast<uintptr_t>(p + j) |
          reinterpret_cast<uintptr_t>(t + j)) & 15) == 0) {
      head = j;
      break;
    }
  }
  const long long chunks = (hw - head) / kChunk;
  const long long body_end = head + chunks * kChunk;
  // the head and the tail, read one pixel a thread; the first such pixel's
  // loads are issued now, ahead of the chunks and the zeroing
  const long long scalars = head + (hw - body_end);
  const long long sstride = (long long)gridDim.x * kThreads;
  long long s0 = (long long)blockIdx.x * kThreads;  // block-uniform
  uint32_t sp = C, st = C;  // a skipped pixel
  if (s0 + threadIdx.x < scalars) {
    const long long s = s0 + threadIdx.x;
    const long long i = s < head ? s : body_end + (s - head);
    sp = static_cast<uint32_t>(p[i]);
    st = static_cast<uint32_t>(t[i]);
  }

  // the chunks, a warp at a time. Two buffers take turns: the next chunk's
  // loads are in flight while the current one is counted; the first
  // chunk's while the histogram is zeroed.
  const long long stride = (long long)gridDim.x * kWarps;
  long long c = (long long)blockIdx.x * kWarps + warp;
  const P* pc = p + head;
  const T* tc = t + head;
  LaneChunk<P, T> ping, pong;
  if (c < chunks) ping.load(pc + c * kChunk, tc + c * kChunk, lane);
  const int cells = kMode == kPrivate ? rows * kThreads : rows * kWarps;
  for (int i = threadIdx.x; i < cells; i += kThreads) hist[i] = 0;
  __syncthreads();
  int* mine = kMode == kPrivate ? hist : hist + warp * rows;
  while (c < chunks) {
    if (c + stride < chunks)
      pong.load(pc + (c + stride) * kChunk, tc + (c + stride) * kChunk, lane);
    ping.template count_into<kMode>(mine, C, nbins);
    c += stride;
    if (c >= chunks) break;
    if (c + stride < chunks)
      ping.load(pc + (c + stride) * kChunk, tc + (c + stride) * kChunk, lane);
    pong.template count_into<kMode>(mine, C, nbins);
    c += stride;
  }
  // the head and the tail: count a pixel, read the thread's next
  for (; s0 < scalars; s0 += sstride) {
    const uint32_t bin = bin_of(sp, st, C, nbins);
    sp = st = C;
    const long long s = s0 + sstride + threadIdx.x;
    if (s < scalars) {
      const long long i = s < head ? s : body_end + (s - head);
      sp = static_cast<uint32_t>(p[i]);
      st = static_cast<uint32_t>(t[i]);
    }
    count<kMode>(mine, bin, nbins);
  }
  __syncthreads();

  // the block's count of each bin, then its ticket: for per-thread
  // counters 8 threads a bin, each summing 32 counters (rotated by lane, so
  // no bank is hit twice), then 3 shuffles; all bins at once
  if (kMode == kPrivate) {
    const int b = threadIdx.x >> 3, part = threadIdx.x & 7;
    int s = 0;
    if (b < (int)nbins) {
#pragma unroll 8
      for (int k = 0; k < 32; ++k)
        s += hist[b * kThreads + part * 32 + ((k + lane) & 31)];
    }
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (b < (int)nbins && part == 0) finish_bin(ws, out, img, nbins, b, s);
  } else {
    for (int b = threadIdx.x; b < (int)nbins; b += kThreads) {
      int s = 0;
      for (int w = 0; w < kWarps; ++w) s += hist[w * rows + b];
      finish_bin(ws, out, img, nbins, b, s);
    }
  }
}

int sm_count(int device) {
  static int cache[kMaxDevices];
  if (cache[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
        cudaSuccess)
      return 0;
    cache[device] = n;
  }
  return cache[device];
}

template <typename P, typename T, int kMode>
cudaError_t launch(const void* pred, const void* tgt, float* out,
                   unsigned long long* ws, long long batch, long long hw,
                   int C, int device, cudaStream_t stream) {
  auto kernel = confusion_kernel<P, T, kMode>;
  const int rows = C * C + 1;
  const size_t smem =
      sizeof(int) * (size_t)rows * (kMode == kPrivate ? kThreads : kWarps);
  // blocks an SM holds at once, per device and C (the shared memory moves
  // with C); 0 until asked
  static int resident[kMaxDevices][kMaxClasses + 1];
  int& per_sm = resident[device][C];
  if (per_sm == 0) {
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    per_sm = n > 0 ? n : 1;
  }
  const int sms = sm_count(device);
  if (sms == 0) return cudaErrorInvalidDevice;
  // a chunk a warp where the card holds that many blocks at once; else one
  // wave, each warp walking several chunks
  const long long chunks = (hw + kChunk - 1) / kChunk;
  long long per_image = (chunks + kWarps - 1) / kWarps;
  const long long wave = (long long)sms * per_sm / batch;
  if (per_image > wave) per_image = wave;
  if (per_image < 1) per_image = 1;
  dim3 grid((unsigned)per_image, (unsigned)batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const P*>(pred), static_cast<const T*>(tgt), out, ws, hw, C);
  return cudaGetLastError();
}

template <typename P, typename T>
cudaError_t by_classes(const void* pred, const void* tgt, float* out,
                       unsigned long long* ws, long long batch, long long hw,
                       int C, int device, cudaStream_t stream) {
  if (C <= kPrivateMaxClasses)
    return launch<P, T, kPrivate>(pred, tgt, out, ws, batch, hw, C, device,
                                  stream);
  return launch<P, T, kWarp>(pred, tgt, out, ws, batch, hw, C, device, stream);
}

template <typename P>
cudaError_t by_tgt(int tgt_size, const void* pred, const void* tgt,
                   float* out, unsigned long long* ws, long long batch,
                   long long hw, int C, int device, cudaStream_t stream) {
  switch (tgt_size) {
    case 1:
      return by_classes<P, uint8_t>(pred, tgt, out, ws, batch, hw, C, device,
                                    stream);
    case 4:
      return by_classes<P, int32_t>(pred, tgt, out, ws, batch, hw, C, device,
                                    stream);
    case 8:
      return by_classes<P, int64_t>(pred, tgt, out, ws, batch, hw, C, device,
                                    stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// pred, tgt: (batch, hw) device pointers to labels of `pred_size` and
// `tgt_size` bytes each (1: uint8, 4: int32, 8: int64); out: (batch, C, C)
// f32, written whole; workspace: at least batch * C*C 64-bit words, all zero
// (they are zero again when the launch ends), used by one stream at a time.
// `device` is the card the pointers and the stream live on. Returns
// cudaGetLastError() after the launch.
extern "C" int rcv_confusion_count(const void* pred, int pred_size,
                                   const void* tgt, int tgt_size, void* out,
                                   void* workspace, long long batch,
                                   long long hw, int num_classes, int device,
                                   void* stream) {
  if (num_classes < 1 || num_classes > kMaxClasses || batch < 0 ||
      batch > kMaxBatch || hw < 0 || hw > 0x7fffffffLL || device < 0 ||
      device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  float* o = static_cast<float*>(out);
  auto* ws = static_cast<unsigned long long*>(workspace);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pred_size) {
    case 1:
      err = by_tgt<uint8_t>(tgt_size, pred, tgt, o, ws, batch, hw, num_classes,
                            device, st);
      break;
    case 4:
      err = by_tgt<int32_t>(tgt_size, pred, tgt, o, ws, batch, hw, num_classes,
                            device, st);
      break;
    case 8:
      err = by_tgt<int64_t>(tgt_size, pred, tgt, o, ws, batch, hw, num_classes,
                            device, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (current != device) cudaSetDevice(current);
  return (int)err;
}
