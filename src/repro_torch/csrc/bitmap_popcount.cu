// AND + popcount over pairs of adjacency-bitmap rows, for Hopper (sm_90a).
//
// One source serves two kernels of the port:
//   K1 peel_wave       replaces repro/kernels/peel_wave.py::peel_wave_kernel
//                      sup[i] = sum_w popc(A[ra_i, w] & B[rb_i, w]), 0 where
//                      !alive[i]; kill[i] = alive[i] && sup[i] < k - 2
//   K2 bitmap_support  replaces repro/kernels/bitmap_support.py::
//                      bitmap_support_kernel: the same sum, no mask, no
//                      threshold, optionally over a word slab (partial sum)
//
// Rows are addressed either directly (row i of A and of B) or gathered by
// endpoint ids (row ia[i] of A, row ib[i] of B).  The gathered form reads
// both rows of an edge straight out of the [N, W] bitmap, so the [E, W]
// row copies that the TPU path builds before each call never exist.
//
// What bounds it on an H100: device-memory bytes.  Each word pair costs
// one AND, one POPC and one add, i.e. under one integer operation per byte
// loaded, far below the card's operations-per-byte balance.  The least
// traffic is the bitmap read once plus ~14 B of per-slot index, mask and
// output; this simple design instead streams both rows of every alive edge
// from device memory or L2 (rows of hub nodes are re-read by many edges).
// What the design does about it: one warp per row, lanes striding the
// row's words so each load instruction of a warp is one coalesced 128-byte
// segment, four independent load pairs in flight per lane, int32
// accumulation and a shuffle reduction; a dead row (K1) loads nothing.
// Reusing the shared u row across consecutive edges, wider loads and TMA
// are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libbitmap_popcount.so bitmap_popcount.cu
// Every entry launches on the given stream, allocates nothing, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxBlocks = 65535;

template <bool kThreshold>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
and_popcount_rows(const int32_t* __restrict__ a,
                  const int32_t* __restrict__ b, long long stride,
                  const int32_t* __restrict__ ia,
                  const int32_t* __restrict__ ib, int n_rows, int n_words,
                  const uint8_t* __restrict__ alive,
                  const int32_t* __restrict__ k, int32_t* __restrict__ sup,
                  uint8_t* __restrict__ kill) {
  const int lane = threadIdx.x & 31;
  const int row_step = gridDim.x * kWarpsPerBlock;
  const int thresh = kThreshold ? __ldg(k) - 2 : 0;
  for (int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       row < n_rows; row += row_step) {
    // every lane of a warp works on the same row: the branch is uniform
    if (kThreshold && !alive[row]) {
      if (lane == 0) {
        sup[row] = 0;
        kill[row] = 0;
      }
      continue;
    }
    const long long ra = ia ? static_cast<long long>(__ldg(ia + row)) : row;
    const long long rb = ib ? static_cast<long long>(__ldg(ib + row)) : row;
    const uint32_t* pa = reinterpret_cast<const uint32_t*>(a + ra * stride);
    const uint32_t* pb = reinterpret_cast<const uint32_t*>(b + rb * stride);
    int acc = 0;
    int w = lane;
    for (; w + 96 < n_words; w += 128) {
      const uint32_t a0 = __ldg(pa + w), b0 = __ldg(pb + w);
      const uint32_t a1 = __ldg(pa + w + 32), b1 = __ldg(pb + w + 32);
      const uint32_t a2 = __ldg(pa + w + 64), b2 = __ldg(pb + w + 64);
      const uint32_t a3 = __ldg(pa + w + 96), b3 = __ldg(pb + w + 96);
      acc += __popc(a0 & b0) + __popc(a1 & b1) + __popc(a2 & b2) +
             __popc(a3 & b3);
    }
    for (; w < n_words; w += 32) acc += __popc(__ldg(pa + w) & __ldg(pb + w));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      sup[row] = acc;
      if (kThreshold) kill[row] = acc < thresh ? 1 : 0;
    }
  }
}

int grid_for(int n_rows) {
  const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

}  // namespace

// K1.  a, b: int32 row bases (already offset to the first word), row i of
// a pair read at a + ia[i] * stride and b + ib[i] * stride (row i itself
// when ia/ib are null).  alive: uint8/bool [n_rows]; k: int32 scalar on the
// device; sup: int32 [n_rows]; kill: uint8/bool [n_rows].
extern "C" int peel_wave_launch(const void* a, const void* b, long long stride,
                                const void* ia, const void* ib, int n_rows,
                                int n_words, const void* alive, const void* k,
                                void* sup, void* kill, void* stream) {
  if (n_rows > 0) {
    and_popcount_rows<true><<<grid_for(n_rows), kWarpsPerBlock * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
        stride, static_cast<const int32_t*>(ia),
        static_cast<const int32_t*>(ib), n_rows, n_words,
        static_cast<const uint8_t*>(alive), static_cast<const int32_t*>(k),
        static_cast<int32_t*>(sup), static_cast<uint8_t*>(kill));
  }
  return static_cast<int>(cudaGetLastError());
}

// K2.  The same addressing; no mask, no threshold.
extern "C" int bitmap_support_launch(const void* a, const void* b,
                                     long long stride, const void* ia,
                                     const void* ib, int n_rows, int n_words,
                                     void* sup, void* stream) {
  if (n_rows > 0) {
    and_popcount_rows<false><<<grid_for(n_rows), kWarpsPerBlock * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
        stride, static_cast<const int32_t*>(ia),
        static_cast<const int32_t*>(ib), n_rows, n_words, nullptr, nullptr,
        static_cast<int32_t*>(sup), nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
