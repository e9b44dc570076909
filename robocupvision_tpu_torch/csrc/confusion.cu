// K1 `confusion_count`: per-image confusion counts conf[b, pred, tgt],
// counted straight from two int32 label maps (no one-hots).
//
// Replaces the TPU kernel robocupvision_tpu/ops/pallas_kernels.py
// `confusion_matrix_pallas` (body `_conf_kernel`), which streams each image's
// maps through VMEM and does C*C masked reductions on the VPU.
//
// Bound on the H100: bytes. The work is one compare-and-count per pixel;
// the maps are read once (8 bytes a pixel) and C*C counters are written,
// so the least time is those bytes over the memory rate (chip_smoke.py
// computes it) -- at one serving frame the launch itself costs more.
//
// Design: grid (pixel tiles, images). Each block keeps a C*C int32
// histogram in shared memory. Most pixels of a label map share a few bins,
// so lanes of a warp that hit the same bin are merged first
// (__match_any_sync: one shared atomic per distinct bin and warp, not per
// pixel); at the end each block adds its histogram atomically into the
// (B, C, C) int32 output, which the caller zero-fills. Labels outside
// [0, C) are skipped, as both JAX paths skip them, and never index memory.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixelsPerThread = 8;  // pixels a thread visits per tile pass
constexpr int kMaxClasses = 16;      // C*C bins must fit the shared array

__global__ void __launch_bounds__(kThreads)
confusion_kernel(const int* __restrict__ pred, const int* __restrict__ tgt,
                 int* __restrict__ out, long long hw, int C) {
  __shared__ int hist[kMaxClasses * kMaxClasses];
  const int nbins = C * C;
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  const long long img = blockIdx.y;
  const int* p = pred + img * hw;
  const int* t = tgt + img * hw;
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * blockDim.x;
  // `base` is the same for every thread of the block, so all 32 lanes of a
  // warp take every trip and the full-mask __match_any_sync is legal
  for (long long base = (long long)blockIdx.x * blockDim.x; base < hw;
       base += step) {
    const long long i = base + threadIdx.x;
    int bin = -1;
    if (i < hw) {
      const int pv = p[i];
      const int tv = t[i];
      if (pv >= 0 && pv < C && tv >= 0 && tv < C) bin = pv * C + tv;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    if (bin >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&hist[bin], __popc(peers));
  }
  __syncthreads();

  int* o = out + img * nbins;
  for (int i = threadIdx.x; i < nbins; i += blockDim.x)
    if (hist[i]) atomicAdd(&o[i], hist[i]);
}

}  // namespace

// pred, tgt: (batch, hw) int32 device pointers; out: (batch, C, C) int32,
// zero-filled by the caller. Returns cudaGetLastError() after the launch.
extern "C" int rcv_confusion_count(const void* pred, const void* tgt,
                                   void* out, long long batch, long long hw,
                                   int num_classes, void* stream) {
  if (num_classes < 1 || num_classes > kMaxClasses || batch < 0 ||
      batch > 65535 || hw < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || hw == 0) return (int)cudaSuccess;
  const long long per_block = (long long)kThreads * kPixelsPerThread;
  const long long tiles = (hw + per_block - 1) / per_block;
  dim3 grid((unsigned)tiles, (unsigned)batch);
  confusion_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)pred, (const int*)tgt, (int*)out, hw, num_classes);
  return (int)cudaGetLastError();
}
