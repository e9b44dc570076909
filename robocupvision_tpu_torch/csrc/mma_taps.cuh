// The bf16 tensor-core tap loop shared by K3 (conv_block.cu) and K2's bf16
// conv stages (conv_chain.cu).
//
// One warp computes an implicit-GEMM tile on its own: M = MT * 16 output
// pixels (any pixels: the caller's stager decides which input pixel each
// row reads at each tap), N = NT8 * 8 output channels, K walked as a LIST
// of K blocks, each one (tap, 16-input-channel chunk) pair. The loop never
// walks the full taps x Cin: the caller hands it the blocks whose weights
// are not all zero (K2's packed kernels are mostly structural zeros), or
// every block (K3).
//
// Per K block the caller's stager fills one buffer of the warp's
// shared-memory ring: A as MT*16 rows of 16 bf16 (a pixel's 16 input
// channels at the block's tap) and B as 16 rows of NT8*8 bf16 (the block's
// 16 input channels x the tile's output channels), with 16-byte cp.async
// copies. A copy whose source is outside the image, past Cin or past Cout
// is a zero fill (src-size 0): that zero is the convolution's padding, and
// it pads Cin to a multiple of 16 and Cout to a multiple of 8. Where a
// 16-byte piece is not aligned in device memory (Cin or Cout not a
// multiple of 8), the stager stores it from eight plain loads instead.
// Two buffers: block j+1's copies are in flight while block j's
// fragments are loaded with ldmatrix (A as is, B transposed, since the
// kernels keep B's output channels contiguous) and multiplied with
// mma.sync m16n8k16 (bf16 in, f32 accumulators in registers). Only
// __syncwarp orders a warp's copies and reads: warps never wait for each
// other inside the loop.
//
// Row strides are padded to 24 bf16 (48 bytes) for A and to NT8*8 + 8 for
// B, so the eight 16-byte row addresses of each ldmatrix fall in distinct
// bank groups.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace rcv_mma {

constexpr int kAStride = 24;  // bf16 per A row in shared memory (16 + 8 pad)

// Shared-memory sizes, in bf16 elements, of a warp's two-buffer ring for
// MT m16 tiles x NT8 n8 tiles, K blocks of NSUB sub-blocks (16 input
// channels each) that share an A buffer of AROWS rows.
template <int MT, int NT8, int NSUB = 1, int AROWS = MT * 16>
struct Tile {
  // bf16 per B row (one n-tile: 24, since 16 would put two of ldmatrix's
  // eight rows in one bank group)
  static constexpr int kBStride = NT8 == 1 ? 24 : NT8 * 8 + 8;
  static constexpr int kA = AROWS * kAStride;    // A of one buffer
  static constexpr int kB = NSUB * 16 * kBStride;  // B of one buffer
  static constexpr int kBuf = kA + kB;           // one buffer, A then B
  static constexpr int kRing = 2 * kBuf;         // the ring
};

// The identity A-row map: GEMM row r of every sub-block is A row r.
struct SameRows {
  __device__ __forceinline__ int operator()(int, int r) const { return r; }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global `src` to shared `dst`, or 16 zero bytes when
// !valid (src is then not read, but must be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes, likewise (the f32 paths, whose shared layouts transpose)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Eight bf16 from `src[0..n)` (n <= 8; the rest zero), stored as one
// 16-byte word: the path for pieces that cp.async cannot take.
__device__ __forceinline__ void store8(__nv_bfloat16* dst,
                                       const __nv_bfloat16* src, int n,
                                       int stride = 1) {
  __align__(16) __nv_bfloat16 v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v[i] = i < n ? src[(long long)i * stride] : __float2bfloat16_rn(0.f);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where accumulator element e (0..3) of m-tile mt, n-tile nt sits in the
// warp's tile: row mt*16 + acc_row(lane, e), column nt*8 + acc_col(lane, e).
__device__ __forceinline__ int acc_row(int lane, int e) {
  return (lane >> 2) + ((e >> 1) << 3);
}
__device__ __forceinline__ int acc_col(int lane, int e) {
  return ((lane & 3) << 1) + (e & 1);
}

// The tap loop. `ring` is this warp's Tile<MT, NT8, NSUB, AROWS>::kRing
// bf16 of shared memory, 16-byte aligned. `stage(j, a, b)` issues block
// j's copies into A buffer `a` (AROWS rows, kAStride apart) and B buffer
// `b` (NSUB x 16 rows, kBStride apart); it may also store plainly. Sub-block
// u of block j multiplies A rows arow(u, r), r the GEMM row, by B rows
// u*16 .. u*16 + 15: K3 stages one input strip for the three dx taps of a
// row and reads it at three column offsets. acc += sum over the n_blocks
// blocks and their sub-blocks. (A third buffer, two blocks in flight, made
// K3 slower on an H100: 0.356 against 0.266 ms at VGA 64->64.)
template <int MT, int NT8, int NSUB = 1, int AROWS = MT * 16,
          typename Stager, typename ARow = SameRows>
__device__ __forceinline__ void tap_loop(float (&acc)[MT][NT8][4],
                                         int n_blocks, __nv_bfloat16* ring,
                                         const Stager& stage,
                                         const ARow& arow = ARow()) {
  using TL = Tile<MT, NT8, NSUB, AROWS>;
  constexpr int kBS = TL::kBStride;
  const int lane = threadIdx.x & 31;
  if (n_blocks <= 0) return;
  stage(0, ring, ring + TL::kA);
  cp_async_commit();
  for (int j = 0; j < n_blocks; ++j) {
    const __nv_bfloat16* a = ring + (j & 1) * TL::kBuf;
    if (j + 1 < n_blocks) {
      __nv_bfloat16* nxt = ring + ((j + 1) & 1) * TL::kBuf;
      stage(j + 1, nxt, nxt + TL::kA);
    }
    cp_async_commit();  // an empty group on the last block keeps the count
    cp_async_wait<1>();  // block j has landed
    __syncwarp();
#pragma unroll
    for (int u = 0; u < NSUB; ++u) {
      const __nv_bfloat16* b = a + TL::kA + u * 16 * kBS;
      // B fragments: rows k = lane % 16 (x4: lanes 16..31 the next 8
      // columns)
      uint32_t bf[NT8][2];
#pragma unroll
      for (int nt = 0; nt + 1 < NT8; nt += 2) {
        uint32_t r[4];
        ldsm_x4_t(r, b + (lane & 15) * kBS + nt * 8 + ((lane >> 4) << 3));
        bf[nt][0] = r[0];
        bf[nt][1] = r[1];
        bf[nt + 1][0] = r[2];
        bf[nt + 1][1] = r[3];
      }
      if constexpr (NT8 & 1) {
        uint32_t r[2];
        ldsm_x2_t(r, b + (lane & 15) * kBS + (NT8 - 1) * 8);
        bf[NT8 - 1][0] = r[0];
        bf[NT8 - 1][1] = r[1];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t af[4];
        ldsm_x4(af, a + arow(u, mt * 16 + (lane & 15)) * kAStride +
                        ((lane >> 4) << 3));
#pragma unroll
        for (int nt = 0; nt < NT8; ++nt)
          mma16816(acc[mt][nt], af, bf[nt][0], bf[nt][1]);
      }
    }
    __syncwarp();  // every lane is done with block j's buffer
  }
}

}  // namespace rcv_mma
