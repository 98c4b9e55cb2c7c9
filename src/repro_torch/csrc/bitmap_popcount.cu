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
// one AND, one POPC and one add, under one integer operation per byte
// loaded.  The least traffic is the bitmap read once plus ~14 B of
// per-slot index, mask and output.  Two bodies:
//
// * direct (and_popcount_rows; the rows entries, and the gathered entries
//   by name): one warp per slot streams both whole rows, lanes striding
//   the words in coalesced 128-byte segments, four load pairs in flight a
//   lane.  On a gathered wave that is 2 x E x W words, ~24x the bound on
//   the slashdot-like bitmap, where rows of hub nodes are re-read by many
//   edges and only ~1% of the words are nonzero.
// * digest (the gathered entries' default): the work follows the nonzero
//   words, as the paper's intersection walks the smaller neighbour set and
//   probes the other.  Four passes on the caller's stream, per call:
//   1. mark_rows: need[r] = 1 for both endpoints of every live slot (a
//      wave with few alive edges digests only their rows);
//   2. digest_rows: one warp per needed row reads its slab once (8-byte
//      loads where the row base allows, a peeled head word where it does
//      not), and a ballot and a prefix popcount compact its nonzero words
//      in ascending order into digest[r][0, C) as (slab-relative index,
//      word) pairs; nnz[r] is the full count, which may exceed C;
//   3. probe_pairs: a warp takes 32 consecutive slots, writes 0/0 for the
//      dead ones (K1) with coalesced stores and packs the live ones into a
//      list; a group of kProbeLanes = 8 lanes per listed slot takes the
//      endpoint s with the smaller nnz (ties to a) and adds
//      popc(x & row_o[w]) for each of s's digest entries (w, x): one
//      4-byte probe per nonzero word of the sparser row, mostly L2 hits in
//      hub rows.  A row with nnz 0 costs no probe.  A slot whose rows both
//      hold more than C nonzero words goes to a list in device memory
//      instead;
//   4. stream_pairs: one warp a listed slot streams both rows as the
//      direct body does (hub-hub pairs cluster among consecutive slots, so
//      the list spreads them over the card).
//   What bounds the digest body: pass 2 reads every needed row once, which
//   is the bound's own traffic; pass 3 adds one random 32-byte sector per
//   probe (the sparser rows' nonzero words, ~1% of the slashdot-like
//   bitmap) on top of it, and pays a chain of dependent loads a slot
//   (ids, nnz, digest entries, probes), which the 32-slot tiles, four
//   entries a lane in flight and several slots a warp keep overlapped.
//   The sums are integers, so the order of the adds is free and both
//   bodies equal the plain version bitwise.  A digest lives for one call
//   only: the peel clears bits between calls.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libbitmap_popcount.so bitmap_popcount.cu
// Every entry launches on the given stream, allocates nothing (the digest
// body's scratch is the caller's workspace), and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxBlocks = 65535;
// lanes that probe one slot in the digest body: the mean sparser row of
// the slashdot-like bitmap holds ~25 nonzero words, one sweep of 8 lanes
// with four entries each in flight (PERF.md, PR 20: 4, 8 and 16 lanes
// within 6% of each other on full waves of K1 and K2, 32 up to 21%
// slower on K2)
constexpr int kProbeLanes = 8;

// ---------------------------------------------------------------------------
// direct body
// ---------------------------------------------------------------------------

// popc(pa[w] & pb[w]) over this lane's words w = lane, lane + 32, ...:
// each load instruction of a warp one coalesced 128-byte segment, four
// load pairs in flight a lane.
__device__ __forceinline__ int stream_words(const uint32_t* pa,
                                            const uint32_t* pb, int n_words,
                                            int lane) {
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
  return acc;
}

__device__ __forceinline__ int warp_sum(int acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  return acc;
}

template <bool kThreshold>
__global__ void __launch_bounds__(kThreads)
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
    const int acc = warp_sum(stream_words(pa, pb, n_words, lane));
    if (lane == 0) {
      sup[row] = acc;
      if (kThreshold) kill[row] = acc < thresh ? 1 : 0;
    }
  }
}

int grid_for(long long units, int per_block) {
  const long long blocks = (units + per_block - 1) / per_block;
  return blocks < kMaxBlocks ? static_cast<int>(blocks) : kMaxBlocks;
}

// ---------------------------------------------------------------------------
// digest body
// ---------------------------------------------------------------------------

// Pass 1.  need[] was zeroed on the stream before; concurrent stores of
// the same byte are benign.
__global__ void __launch_bounds__(kThreads)
mark_rows(const int32_t* __restrict__ ia, const int32_t* __restrict__ ib,
          int n_slots, const uint8_t* __restrict__ alive,
          uint8_t* __restrict__ need) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_slots;
       i += gridDim.x * kThreads) {
    if (alive && !alive[i]) continue;
    need[__ldg(ia + i)] = 1;
    need[__ldg(ib + i)] = 1;
  }
}

// Pass 2.  bm is the bitmap's base already offset to the slab's first
// word; digest entries are (word index within the slab, word).
__global__ void __launch_bounds__(kThreads)
digest_rows(const int32_t* __restrict__ bm, long long stride, int n_rows,
            int n_words, int capacity, const uint8_t* __restrict__ need,
            int2* __restrict__ digest, int32_t* __restrict__ nnz) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;   // lanes under this one
  const int row_step = gridDim.x * kWarpsPerBlock;
  for (int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       row < n_rows; row += row_step) {
    if (!need[row]) continue;                  // uniform over the warp
    const uint32_t* p =
        reinterpret_cast<const uint32_t*>(bm + static_cast<long long>(row) *
                                                   stride);
    int2* d = digest + static_cast<long long>(row) * capacity;
    int count = 0;
    int head = 0;
    // a row base that is 4 but not 8 bytes aligned: its first word alone
    if ((reinterpret_cast<uintptr_t>(p) & 7u) != 0 && n_words > 0) {
      const uint32_t x = __ldg(p);
      if (x != 0) {
        if (lane == 0 && capacity > 0) d[0] = make_int2(0, static_cast<int>(x));
        count = 1;
      }
      head = 1;
    }
    const uint2* q = reinterpret_cast<const uint2*>(p + head);
    const int rest = n_words - head;
    // 4 x 64 words a step: four independent 8-byte loads a lane in flight
    for (int base = 0; base < rest; base += 256) {
      uint32_t x[8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int w = base + 64 * u + 2 * lane;
        x[2 * u] = x[2 * u + 1] = 0;
        if (w + 1 < rest) {
          const uint2 v = __ldg(q + (w >> 1));
          x[2 * u] = v.x;
          x[2 * u + 1] = v.y;
        } else if (w < rest) {
          x[2 * u] = __ldg(p + head + w);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const unsigned b0 = __ballot_sync(0xffffffffu, x[2 * u] != 0);
        const unsigned b1 = __ballot_sync(0xffffffffu, x[2 * u + 1] != 0);
        // words in ascending order: lane l holds words 2l and 2l + 1
        int pos = count + __popc(b0 & below) + __popc(b1 & below);
        const int w = head + base + 64 * u + 2 * lane;
        if (x[2 * u] != 0) {
          if (pos < capacity) d[pos] = make_int2(w, static_cast<int>(x[2 * u]));
          ++pos;
        }
        if (x[2 * u + 1] != 0 && pos < capacity)
          d[pos] = make_int2(w + 1, static_cast<int>(x[2 * u + 1]));
        count += __popc(b0) + __popc(b1);
      }
    }
    if (lane == 0) nnz[row] = count;
  }
}

// Pass 3.  A warp takes 32 consecutive slots at a time: coalesced loads
// of their mask, ids and the two rows' nnz, zeros for dead slots (K1),
// then the live slots with a row that fits packed in slot order into a
// per-warp list, kProbeLanes lanes a listed slot (the lanes of a group
// take every branch together, groups of one warp may not, so the group's
// shuffles name its lanes).  A slot whose rows are both over the capacity is
// appended to a list in device memory for pass 4: hub-hub pairs cluster
// among consecutive slots, and streaming them here would serialise a
// cluster on one warp.
template <bool kThreshold>
__global__ void __launch_bounds__(kThreads)
probe_pairs(const int32_t* __restrict__ bm, long long stride,
            const int32_t* __restrict__ ia, const int32_t* __restrict__ ib,
            int n_slots, int capacity, const int2* __restrict__ digest,
            const int32_t* __restrict__ nnz, const uint8_t* __restrict__ alive,
            const int32_t* __restrict__ k, int32_t* __restrict__ sup,
            uint8_t* __restrict__ kill, int32_t* __restrict__ over_slots,
            int32_t* __restrict__ n_over) {
  constexpr int G = kProbeLanes, kGroups = 32 / G;
  __shared__ int4 pairs[kWarpsPerBlock][32];   // ra, rb, nnz[ra], nnz[rb]
  __shared__ int slots[kWarpsPerBlock][32];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int grp = lane / G, g = lane % G;
  const unsigned below = (1u << lane) - 1u;
  const unsigned gmask = ((1u << G) - 1u) << (grp * G);
  const int thresh = kThreshold ? __ldg(k) - 2 : 0;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(bm);
  const int step = 32 * gridDim.x * kWarpsPerBlock;
  for (int base = 32 * (blockIdx.x * kWarpsPerBlock + wib); base < n_slots;
       base += step) {
    const int slot = base + lane;
    const bool in = slot < n_slots;
    const bool live = in && (!kThreshold || alive[slot]);
    if (kThreshold && in && !live) {
      sup[slot] = 0;
      kill[slot] = 0;
    }
    int ra = 0, rb = 0, na = 0, nb = 0;
    if (live) {
      ra = __ldg(ia + slot);
      rb = __ldg(ib + slot);
      na = __ldg(nnz + ra);
      nb = __ldg(nnz + rb);
    }
    const bool over = live && na > capacity && nb > capacity;
    const unsigned fit_m = __ballot_sync(0xffffffffu, live && !over);
    const unsigned over_m = __ballot_sync(0xffffffffu, over);
    if (over_m) {                              // uniform over the warp
      int at = 0;
      if (lane == 0) at = atomicAdd(n_over, __popc(over_m));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (over) over_slots[at + __popc(over_m & below)] = slot;
    }
    if (live && !over) {
      const int r = __popc(fit_m & below);
      pairs[wib][r] = make_int4(ra, rb, na, nb);
      slots[wib][r] = slot;
    }
    __syncwarp();
    const int n_fit = __popc(fit_m);
    for (int first = 0; first < n_fit; first += kGroups) {
      const int li = first + grp;
      if (li >= n_fit) continue;               // uniform over the group
      const int4 p = pairs[wib][li];
      const bool b_side = p.w < p.z;           // ties to a
      const long long s = b_side ? p.y : p.x, o = b_side ? p.x : p.y;
      const int ns = b_side ? p.w : p.z;
      const int2* d = digest + s * capacity;
      const uint32_t* po = words + o * stride;
      int acc = 0;
      // four entries a lane in flight, then their four probes; an entry
      // past ns holds word 0 and loads nothing
      for (int j = g; j < ns; j += 4 * G) {
        int2 e[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          e[u] = j + u * G < ns ? __ldg(d + j + u * G) : make_int2(0, 0);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (e[u].y != 0)
            acc += __popc(static_cast<uint32_t>(e[u].y) & __ldg(po + e[u].x));
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        acc += __shfl_down_sync(gmask, acc, off, G);
      if (g == 0) {
        sup[slots[wib][li]] = acc;
        if (kThreshold) kill[slots[wib][li]] = acc < thresh ? 1 : 0;
      }
    }
    __syncwarp();
  }
}

// Pass 4.  One warp a listed slot streams both rows, as the direct body
// does; the list's length is on the device, so the grid is fixed.
template <bool kThreshold>
__global__ void __launch_bounds__(kThreads)
stream_pairs(const int32_t* __restrict__ bm, long long stride,
             const int32_t* __restrict__ ia, const int32_t* __restrict__ ib,
             int n_words, const int32_t* __restrict__ over_slots,
             const int32_t* __restrict__ n_over,
             const int32_t* __restrict__ k, int32_t* __restrict__ sup,
             uint8_t* __restrict__ kill) {
  const int lane = threadIdx.x & 31;
  const int count = *n_over;
  const int thresh = kThreshold ? __ldg(k) - 2 : 0;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(bm);
  for (int li = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); li < count;
       li += gridDim.x * kWarpsPerBlock) {
    const int slot = over_slots[li];
    const int acc = warp_sum(stream_words(
        words + static_cast<long long>(__ldg(ia + slot)) * stride,
        words + static_cast<long long>(__ldg(ib + slot)) * stride, n_words,
        lane));
    if (lane == 0) {
      sup[slot] = acc;
      if (kThreshold) kill[slot] = acc < thresh ? 1 : 0;
    }
  }
}

constexpr int kStreamBlocks = 1024;   // ~8 resident blocks on each of 132 SMs

// The four passes.  workspace: digest (8 * n_nodes * capacity bytes), nnz
// (4 * n_nodes), the over list (4 * n_slots), its length (4), need
// (n_nodes); the length and need are zeroed by one memset.
template <bool kThreshold>
int digest_launch(const void* bm, long long stride, int n_nodes,
                  const void* ia, const void* ib, int n_slots, int n_words,
                  int capacity, const void* alive, const void* k, void* sup,
                  void* kill, void* workspace, void* stream) {
  if (n_slots <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int2* digest = static_cast<int2*>(workspace);
  int32_t* nnz = reinterpret_cast<int32_t*>(
      static_cast<char*>(workspace) +
      8LL * static_cast<long long>(n_nodes) * capacity);
  int32_t* over_slots = nnz + n_nodes;
  int32_t* n_over = over_slots + n_slots;
  uint8_t* need = reinterpret_cast<uint8_t*>(n_over + 1);
  const int32_t* rows = static_cast<const int32_t*>(bm);
  const int32_t* pa = static_cast<const int32_t*>(ia);
  const int32_t* pb = static_cast<const int32_t*>(ib);
  const uint8_t* al = static_cast<const uint8_t*>(alive);
  cudaError_t err = cudaMemsetAsync(n_over, 0, 4 + n_nodes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  mark_rows<<<grid_for(n_slots, kThreads), kThreads, 0, st>>>(pa, pb, n_slots,
                                                              al, need);
  digest_rows<<<grid_for(n_nodes, kWarpsPerBlock), kThreads, 0, st>>>(
      rows, stride, n_nodes, n_words, capacity, need, digest, nnz);
  const int32_t* kk = static_cast<const int32_t*>(k);
  int32_t* out = static_cast<int32_t*>(sup);
  uint8_t* kl = static_cast<uint8_t*>(kill);
  probe_pairs<kThreshold><<<grid_for(n_slots, kThreads), kThreads, 0, st>>>(
      rows, stride, pa, pb, n_slots, capacity, digest, nnz, al, kk, out, kl,
      over_slots, n_over);
  stream_pairs<kThreshold><<<kStreamBlocks, kThreads, 0, st>>>(
      rows, stride, pa, pb, n_words, over_slots, n_over, kk, out, kl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1, direct body.  a, b: int32 row bases (already offset to the first
// word), row i of a pair read at a + ia[i] * stride and b + ib[i] * stride
// (row i itself when ia/ib are null).  alive: uint8/bool [n_rows]; k:
// int32 scalar on the device; sup: int32 [n_rows]; kill: uint8/bool
// [n_rows].
extern "C" int peel_wave_launch(const void* a, const void* b, long long stride,
                                const void* ia, const void* ib, int n_rows,
                                int n_words, const void* alive, const void* k,
                                void* sup, void* kill, void* stream) {
  if (n_rows > 0) {
    and_popcount_rows<true><<<grid_for(n_rows, kWarpsPerBlock), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
        stride, static_cast<const int32_t*>(ia),
        static_cast<const int32_t*>(ib), n_rows, n_words,
        static_cast<const uint8_t*>(alive), static_cast<const int32_t*>(k),
        static_cast<int32_t*>(sup), static_cast<uint8_t*>(kill));
  }
  return static_cast<int>(cudaGetLastError());
}

// K2, direct body.  The same addressing; no mask, no threshold.
extern "C" int bitmap_support_launch(const void* a, const void* b,
                                     long long stride, const void* ia,
                                     const void* ib, int n_rows, int n_words,
                                     void* sup, void* stream) {
  if (n_rows > 0) {
    and_popcount_rows<false><<<grid_for(n_rows, kWarpsPerBlock), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
        stride, static_cast<const int32_t*>(ia),
        static_cast<const int32_t*>(ib), n_rows, n_words, nullptr, nullptr,
        static_cast<int32_t*>(sup), nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1, digest body, gathered only: both rows of slot i from one bitmap, bm
// + ia[i] * stride and bm + ib[i] * stride (bm offset to the slab's first
// word), n_nodes rows; capacity C entries a row.
extern "C" int peel_wave_digest_launch(const void* bm, long long stride,
                                       int n_nodes, const void* ia,
                                       const void* ib, int n_slots,
                                       int n_words, int capacity,
                                       const void* alive, const void* k,
                                       void* sup, void* kill, void* workspace,
                                       void* stream) {
  return digest_launch<true>(bm, stride, n_nodes, ia, ib, n_slots, n_words,
                             capacity, alive, k, sup, kill, workspace, stream);
}

// K2, digest body.  The same addressing; no mask, no threshold.
extern "C" int bitmap_support_digest_launch(const void* bm, long long stride,
                                            int n_nodes, const void* ia,
                                            const void* ib, int n_slots,
                                            int n_words, int capacity,
                                            void* sup,
                                            void* workspace, void* stream) {
  return digest_launch<false>(bm, stride, n_nodes, ia, ib, n_slots, n_words,
                              capacity, nullptr, nullptr, sup, nullptr,
                              workspace, stream);
}
