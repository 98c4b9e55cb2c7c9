// Blocked online-softmax attention (FlashAttention-style forward) for
// Hopper (sm_90a), in two hand-written bodies.
//
// K3 flash_attention  replaces repro/kernels/flash_attention.py::
//                     flash_attention_kernel: o = softmax(q k^T * Dh^-0.5 +
//                     mask) v with a causal and/or sliding-window mask, fp32
//                     max / normaliser / accumulator, a row whose keys are
//                     all masked written as 0, output in the input type.
//                     Keys at or beyond the sequence length are masked in
//                     every mode (the Pallas kernel leaves its zero-padded
//                     keys unmasked when causal is off; the port follows
//                     ref.attention_ref instead).
//
// Layout: q and o are [B, S, Hq, D], k and v [B, S, Hkv, D] with D
// contiguous and the other three axes given by strides in elements, so the
// model's projections feed the kernel without a transpose, and query head h
// reads KV head h / (Hq / Hkv) in place: the reference's jnp.repeat of K/V
// for GQA never exists.  The reference's [BH, S, D] entry is the same call
// with Hq = Hkv = 1.
//
// The TPU kernel walks a sequential (bh, q-tile, kv-tile) grid and carries
// its running max, normaliser and accumulator in VMEM scratch between grid
// steps.  Here one block owns one (b, h, q-tile) and loops over the live key
// tiles itself: tiles in which every pair is masked (above the causal
// diagonal, or behind the window) are never loaded.  Blocks are issued
// heaviest q-tile first, so the causal tail is short.
//
// What bounds it on an H100: operations.  Causal prefill at S = 4096 does
// 4 D flops per unmasked (q, k) pair, about 1,100 flops per byte of q, k,
// v and o; the card's balance is about 295 (bf16 tensor cores) and 20
// (fp32 CUDA cores).  So the products belong on the tensor cores.
//
// The wgmma body (bf16, D = 64, 128 or 256: the models' prefill paths) is
// shaped like FlashAttention-3's forward.  A block of 384 threads owns 128
// query rows: warpgroup 0 is the producer, and one of its threads issues
// every TMA copy (Q once; K and V of each live key tile into a ring of two
// stages, each copy completing on its stage's full mbarrier, each stage
// handed back on its empty mbarrier); warpgroups 1 and 2 each own 64 query
// rows.  A key tile is 128 keys at D = 64 and 128 and 64 keys at D = 256,
// where 128-key tiles would need 320 KB of shared memory.  The producer
// gives its registers back with setmaxnreg (24 a thread) so the consumers
// can hold 240.  Tiles arrive through 4-D tensor maps over [B, S, H, D]
// with the 128-byte swizzle (a box is 64 columns of 128 Q rows or of one
// key tile, so a row of D columns is D / 64 boxes); the KV head is a
// coordinate, and TMA fills rows past S with zeros.  S = Q K^T is wgmma
// m64nNk16, N the keys of a tile, with both operands in shared memory (K
// stored [keys, D] is the K-major B it wants), accumulated in fp32
// registers.  The softmax runs on that fragment: the element mask only on
// tiles that straddle the diagonal, the window or S; row max and row sum
// over the four lanes that share a row; the scale applied in fp32 after the
// product and folded with log2(e) into exp2f.  A row with no live key yet
// keeps m = -inf, so its P and its rescale factor are 0; at D = 256 the
// second key tile of a diagonal block lies wholly above warpgroup 0's rows,
// which still wait on its full barriers, run its products (all of its P is
// 0) and hand its stage back.  P goes to bf16 in registers as two terms,
// hi = P cut to its top 16 bits and lo = bf16(P - hi), each the register A
// operand of O += P V (wgmma m64nDk16, V read [keys, D] as an MN-major B
// through the transpose flag), so the product sees P to 2^-16.  The
// normaliser l sums the unrounded fp32 P.  Each consumer issues tile i's
// Q K^T before tile i - 1's P V and runs tile i's softmax while that P V is
// in flight; only the rescale of O waits for it.  The epilogue divides by
// l (0 where l is 0), rounds to bf16 (nearest even), stages the tile
// through the warpgroup's Q rows in shared memory and stores rows < S with
// 16-byte stores.  Shared memory: Q (128 x D x 2 bytes) plus two stages of
// K and V (keys x D x 2 bytes each): 160 KB at D = 128, 64 + 2 x (32 + 32)
// = 192 KB at D = 256; one block per SM.  Registers of a consumer thread
// at D = 256: O 128, S 32, P as hi + lo 32, of the 240.
//
// Tolerance of the wgmma body against the fp32 plain version, at every
// head dim: a bf16 x bf16 product is exact in fp32, so S differs from the
// SIMT body's only in the order of summation, and the output is rounded to
// bf16 (2^-9 relative) in both bodies.  P alone would add a rounding of
// 2^-9 relative per weight, and that is relative to each weight, not to
// the output: where sum p v cancels in a row with few live keys, the
// error, up to 2^-9 sum p |v| / l, exceeds atol 1e-3 + rtol 1.6e-2 |o| (on
// the card: up to 2.2 times that limit, in 10 to 30 of 4.2M outputs at [8
// heads, 4096, 128], all in the first rows).  With P as hi + lo, lo = P -
// hi exactly in fp32 (|lo| < 2^-7 P) and its rounding to bf16 leaves P -
// (hi + lo) at most 2^-16 P, so the bf16 tolerances hold as they were:
// 3e-2 on the reference's sweep, rtol 1.6e-2 + atol 1e-3 at the path's
// shapes (worst error under half the limit).  None of this depends on D or
// on the key tile.  The lo term costs one more wgmma per k-step of P V.
//
// The SIMT body (fp32 at any head dim, bf16 at D = 16 and 32; any input
// when asked for by name) keeps the first design: one 256-thread block per
// (b, h, 64-row q-tile), 64-key tiles, products in fp32 on CUDA cores (so
// its ceiling is the 67 TFLOP/s fp32 rate), Q and K then V staged through
// shared memory widened to fp32, P through shared memory transposed.  fp32
// is held to the reference's 2e-5, which bf16 tensor cores cannot give.  A
// thread owns rows 4*ty..4*ty+3 of the tile (ty = tid / 16) and, of S,
// columns tx + 16 j (tx = tid % 16, j < 4), of O, D / 16 columns; row max
// and row sum are reduced across the 16 lanes of a row with shuffles.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// No -lcuda: the tensor-map encoder is fetched from the driver at run time
// (cudaGetDriverEntryPoint).  The entry launches on the given stream,
// allocates nothing, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a body, head dimension or layout it does not
// take) so the caller can raise on a refused launch.

#include <cstdint>
#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows of a block
constexpr int kBK = 64;        // keys of a KV tile
constexpr int kThreads = 256;
constexpr int kLdP = kBQ + 4;  // row pitch of P^T in shared memory (floats)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  // four bf16 in 8 bytes; a bf16 is the high half of its fp32 value
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);   // round to nearest even, as torch's cast
}

// Rows row0 .. row0 + 63 of one head of src into dst [64][D + 4] as fp32;
// rows at or beyond seq are filled with zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride_s, int row0,
                                          int seq) {
  constexpr int kLd = D + 4, kChunks = D / 4;
  for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < seq) x = load4(src + (long long)(row0 + r) * stride_s + c);
    *reinterpret_cast<float4*>(dst + r * kLd + c) = x;
  }
}

// Column of O held in a thread's register slot `c` (c < D / 16): groups of
// four adjacent columns when D / 16 is a multiple of four (16-byte loads of
// V), else columns tx + 16 c.
template <int D>
__device__ __forceinline__ int out_col(int tx, int c) {
  constexpr int kOC = D / 16;
  if constexpr (kOC % 4 == 0) return (tx + 16 * (c / 4)) * 4 + (c % 4);
  return tx + 16 * c;
}

// two blocks per SM up to D = 128 (85 KB of shared memory each), one above
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, (D <= 128 ? 2 : 1))
flash_attention_fwd(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    long long q_b, long long q_h, long long q_s,
                    long long kv_b, long long kv_h, long long kv_s,
                    long long o_b, long long o_h, long long o_s,
                    int n_heads, int group, int seq, int causal, int window,
                    float scale) {
  constexpr int kLd = D + 4;     // row pitch of the Q and K/V tiles (floats)
  constexpr int kOC = D / 16;    // O columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kBQ][kLd]
  float* kvs = qs + kBQ * kLd;                   // [kBK][kLd], K then V
  float* pt = kvs + kBK * kLd;                   // [kBK][kLdP], P^T

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n_qt = (seq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBQ;   // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / n_heads, h = bh % n_heads, hk = h / group;
  const T* qb = q + b * q_b + h * q_h;
  const T* kb = k + b * kv_b + hk * kv_h;
  const T* vb = v + b * kv_b + hk * kv_h;
  T* ob = o + b * o_b + h * o_h;

  // live KV tiles: [kt_lo, kt_hi)
  int kt_hi = (seq + kBK - 1) / kBK;
  if (causal) kt_hi = min(kt_hi, (q0 + kBQ - 1) / kBK + 1);
  int kt_lo = 0;
  if (window >= 0) kt_lo = max(0, q0 - window + 1) / kBK;

  load_tile<T, D>(qs, qb, q_s, q0, seq);

  float m[4], l[4], acc[4][kOC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                 // last tile's V and P fully read
    load_tile<T, D>(kvs, kb, kv_s, k0, seq);
    __syncthreads();

    // S = Q K^T on rows 4 ty + i, columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kvs + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      bool live[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        live[j] = kp < seq && (!causal || qp >= kp) &&
                  (window < 0 || qp - kp < window);
        s[i][j] = live[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = live[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx + 16 * j) * kLdP + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();                 // K fully read, P^T written
    load_tile<T, D>(kvs, vb, kv_s, k0, seq);
    __syncthreads();

    // O += P V
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(pt + c * kLdP + 4 * ty);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[kOC];
      if constexpr (kOC % 4 == 0) {
#pragma unroll
        for (int g = 0; g < kOC / 4; ++g) {
          const float4 t = *reinterpret_cast<const float4*>(
              kvs + c * kLd + (tx + 16 * g) * 4);
          vv[4 * g] = t.x;
          vv[4 * g + 1] = t.y;
          vv[4 * g + 2] = t.z;
          vv[4 * g + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int cc = 0; cc < kOC; ++cc) vv[cc] = kvs[c * kLd + tx + 16 * cc];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < kOC; ++cc)
          acc[i][cc] = fmaf(pr[i], vv[cc], acc[i][cc]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * ty + i;
    if (qp >= seq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < kOC; ++c)
      store1(ob + (long long)qp * o_s + out_col<D>(tx, c), acc[i][c] / li);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const long long* st, int batch, int n_heads, int group,
                   int seq, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr int kSmem = (kBQ * (D + 4) + kBK * (D + 4) + kBK * kLdP) * 4;
  auto kernel = flash_attention_fwd<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBQ - 1) / kBQ, batch * n_heads);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], n_heads, group, seq, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int head_dim, const void* q, const void* k,
                     const void* v, void* o, const long long* st, int batch,
                     int n_heads, int group, int seq, int causal, int window,
                     float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(q, k, v, o, st, batch, n_heads, group, seq, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, st, batch, n_heads, group, seq, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, st, batch, n_heads, group, seq, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, st, batch, n_heads, group, seq, causal, window, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, st, batch, n_heads, group, seq, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// wgmma body: bf16, D = 64, 128 or 256
// ---------------------------------------------------------------------------

namespace hopper {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;        // query rows of a block (two warpgroups of 64)
// keys of a K/V tile: 128, or 64 at D = 256 (shared memory)
template <int D>
constexpr int kBN = D == 256 ? 64 : 128;
constexpr int kStages = 2;      // K/V ring depth
constexpr int kThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kBox = 64;        // bf16 columns of one 128-byte swizzled box
constexpr int kQBox = kBM * 128;         // one 64-column box of Q's 128 rows
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// one arrival, and `bytes` more to come from TMA in this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// box (c0 .. c0 + 63, c1, c2 .. c2 + rows - 1, c3) of a 4-D map into shared
// memory, rows as the map was made with
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand at shared address `addr`
// (1024-byte aligned up to the k-step offset): rows of 128 bytes, 8-row
// groups 1024 bytes apart (SBO); `lbo` is the byte distance between 64-wide
// boxes along MN, read only for an MN-major operand.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B from shared memory, both
// K-major, through descriptors
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B from shared memory, both
// K-major, through descriptors
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A from registers (four bf16 pairs a
// thread), B from shared memory through a descriptor, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (four bf16 pairs a
// thread), B from shared memory through a descriptor, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D[64 x 256] += A[64 x 16] B[16 x 256]: A from registers (four bf16 pairs a
// thread), B from shared memory through a descriptor, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (D == 256) wgmma_rs_n256(d, a, desc_b, 1);
  else if constexpr (D == 128) wgmma_rs_n128(d, a, desc_b, 1);
  else wgmma_rs_n64(d, a, desc_b, 1);
}

// S (+)= Q K^T over one k-step: N keys, N = 128 or 64
template <int N>
__device__ __forceinline__ void wgmma_qk(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  if constexpr (N == 128) wgmma_ss_n128(d, desc_a, desc_b, scale_d);
  else wgmma_ss_n64(d, desc_a, desc_b, scale_d);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);   // nearest even
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Shared memory, from a 1024-byte aligned base: Q [kBM rows] as D / 64
// boxes of 16 KB, then K of each stage, then V of each stage (D / 64 boxes
// of kBN<D> rows each), then the mbarriers.
template <int D>
struct Layout {
  static constexpr int kKVBox = kBN<D> * 128;         // one box of a K/V tile
  static constexpr int kQTile = kQBox * (D / kBox);   // bytes of Q
  static constexpr int kKVTile = kKVBox * (D / kBox); // bytes of a K/V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQTile;
  static constexpr int kV = kQTile + kKVTile * kStages;
  static constexpr int kBar = kQTile + 2 * kKVTile * kStages;
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages) + 1024;  // + align
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      bf16* __restrict__ o, long long o_b, long long o_h,
                      long long o_s, int n_heads, int group, int seq,
                      int causal, int window, float scale_log2) {
  using L = Layout<D>;
  constexpr int BN = kBN<D>;
  constexpr int kC = D / kBox;                 // 64-column boxes of a row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sq = base + L::kQ;
  // mbarriers: Q full; then per stage K full, K empty, V full, V empty
  const uint32_t bar = base + L::kBar;
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8 * (1 + s); };
  auto k_empty = [&](int s) { return bar + 8 * (1 + kStages + s); };
  auto v_full = [&](int s) { return bar + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bar + 8 * (1 + 3 * kStages + s); };

  const int n_qt = (seq + kBM - 1) / kBM;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * kBM;   // heaviest first
  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads, hk = h / group;

  // live key tiles: [kt_lo, kt_hi), the same range for producer and consumers
  int kt_hi = (seq + BN - 1) / BN;
  if (causal) kt_hi = min(kt_hi, (q0 + kBM - 1) / BN + 1);
  int kt_lo = 0;
  if (window >= 0) kt_lo = max(0, q0 - window + 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 2 * 128);           // every consumer thread
      mbar_init(v_empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every copy; the warpgroup's registers go
    // to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQTile);
      for (int c = 0; c < kC; ++c)
        tma_load(sq + c * kQBox, &tm_q, q_full, c * kBox, h, q0, b);
      for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
        const int s = i % kStages;
        const uint32_t parity = ((i / kStages) & 1) ^ 1;   // first pass free
        const uint32_t kb = base + L::kK + s * L::kKVTile;
        const uint32_t vb = base + L::kV + s * L::kKVTile;
        mbar_wait(k_empty(s), parity);
        mbar_expect_tx(k_full(s), L::kKVTile);
        for (int c = 0; c < kC; ++c)
          tma_load(kb + c * L::kKVBox, &tm_k, k_full(s), c * kBox, hk,
                   kt * BN, b);
        mbar_wait(v_empty(s), parity);
        mbar_expect_tx(v_full(s), L::kKVTile);
        for (int c = 0; c < kC; ++c)
          tma_load(vb + c * L::kKVBox, &tm_v, v_full(s), c * kBox, hk,
                   kt * BN, b);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows qw .. qw + 63 of the tile; in
  // an m64nN fragment a thread holds rows r0 and r0 + 8 (of the 64), and of
  // each 8-column group j the columns 8 j + 2 c4 and 8 j + 2 c4 + 1
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int g = lane / 4, c4 = lane % 4;
  const int r0 = 16 * (t / 32) + g;
  const int qw = q0 + 64 * cw;
  const uint32_t q_rows = sq + cw * 64 * 128;  // this warpgroup's Q rows

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // running max of raw scores
  float l[2] = {0.f, 0.f};               // this thread's share of the sum

  float sc[BN / 2];                      // S of the tile in hand, then P
  uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4];   // P of the tile before, bf16

  // S = Q K^T of tile i: D / 16 k-steps of 32 bytes inside the 128-byte
  // rows (a k-step's 64-column box at kk / 4 in Q and in K); issued, not
  // waited for
  auto issue_qk = [&](int i) {
    const uint32_t kb = base + L::kK + (i % kStages) * L::kKVTile;
    mbar_wait(k_full(i % kStages), (i / kStages) & 1);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_qk<BN>(sc, smem_desc(q_rows + (kk / 4) * kQBox + col, 16),
                   smem_desc(kb + (kk / 4) * L::kKVBox + col, 16), kk > 0);
    }
    wgmma_commit();
  };
  // O += P_lo V + P_hi V of tile i: V [keys, D] is an MN-major B whose
  // 64-column boxes lie kKVBox apart (LBO); a k-step is 16 keys, 2 KB;
  // issued, not waited for
  auto issue_pv = [&](int i) {
    const uint32_t vb = base + L::kV + (i % kStages) * L::kKVTile;
    mbar_wait(v_full(i % kStages), (i / kStages) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t dv = smem_desc(vb + kk * 2048, L::kKVBox);
      wgmma_pv<D>(acc, p_lo[kk], dv);
      wgmma_pv<D>(acc, p_hi[kk], dv);
    }
    wgmma_commit();
  };
  // the P registers stay live (unclobbered) until the P V reading them is
  // complete
  auto keep_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        asm volatile("" : "+r"(p_hi[kk][x]), "+r"(p_lo[kk][x]) :: "memory");
  };
  // online softmax of tile i's S in place: sc becomes P (fp32), m and l
  // move on, and the returned factors rescale O
  auto softmax = [&](int i, float (&alpha)[2]) {
    const int k0 = (kt_lo + i) * BN;
    // mask only a tile that straddles the end, the diagonal or the window
    if (k0 + BN > seq || (causal && k0 + BN - 1 > qw) ||
        (window >= 0 && qw + 63 - k0 >= window)) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + 2 * c4 + (e & 1);
          const int qp = qw + r0 + 8 * (e >> 1);
          const bool live = kp < seq && (!causal || kp <= qp) &&
                            (window < 0 || qp - kp < window);
          if (!live) sc[4 * j + e] = -INFINITY;
        }
    }
    float mx[2] = {m[0], m[1]}, ms[2];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row with no live key yet keeps m = -inf; its p and alpha are 0
      ms[r] = mx[r] == -INFINITY ? 0.f : mx[r] * scale_log2;
      alpha[r] = exp2f(m[r] * scale_log2 - ms[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) {
      const int r = (j >> 1) & 1;
      sc[j] = exp2f(fmaf(sc[j], scale_log2, -ms[r]));
      l[r] += sc[j];
    }
  };
  // P as two bf16 terms, hi = P cut to its top 16 bits (a byte permute,
  // no conversion) and lo = bf16(P - hi), rounded to nearest: the S
  // fragment of keys 16 kk .. 16 kk + 15 is the register A fragment of
  // k-step kk
  auto to_bf16 = [&]() {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float a0 = sc[8 * kk + 2 * x], a1 = sc[8 * kk + 2 * x + 1];
        const uint32_t u0 = __float_as_uint(a0), u1 = __float_as_uint(a1);
        p_hi[kk][x] = __byte_perm(u0, u1, 0x7632);
        p_lo[kk][x] = pack_bf16(a0 - __uint_as_float(u0 & 0xffff0000u),
                                a1 - __uint_as_float(u1 & 0xffff0000u));
      }
  };
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];
  };

  mbar_wait(q_full, 0);
  const int n_tiles = kt_hi - kt_lo;
  // tile i's Q K^T goes out before tile i - 1's P V, and tile i's softmax
  // runs while that P V is in flight; only the rescale of O waits for it
  if (n_tiles > 0) {
    float alpha[2];
    issue_qk(0);
    wgmma_wait_all();
    fence_regs(sc);
    mbar_arrive(k_empty(0));
    softmax(0, alpha);
    rescale(alpha);
    to_bf16();
  }
  for (int i = 1; i < n_tiles; ++i) {
    float alpha[2];
    issue_qk(i);
    issue_pv(i - 1);
    wgmma_wait_one();                  // tile i's S is in
    fence_regs(sc);
    mbar_arrive(k_empty(i % kStages));
    softmax(i, alpha);
    wgmma_wait_all();                  // tile i - 1's P V is in
    fence_regs(acc);
    keep_p();
    mbar_arrive(v_empty((i - 1) % kStages));
    rescale(alpha);
    to_bf16();
  }
  if (n_tiles > 0) {
    issue_pv(n_tiles - 1);
    wgmma_wait_all();
    fence_regs(acc);
    keep_p();
    mbar_arrive(v_empty((n_tiles - 1) % kStages));
  }

  // epilogue: O / l in bf16, staged through this warpgroup's Q rows (in the
  // same swizzled layout, so the 4-byte writes of a warp hit distinct
  // banks), then 16-byte stores of the rows below S
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  uint8_t* stage = smem_raw + (base - raw) + L::kQ + cw * 64 * 128;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = r0 + 8 * e;
      const float x0 = l[e] == 0.f ? 0.f : acc[4 * j + 2 * e] / l[e];
      const float x1 = l[e] == 0.f ? 0.f : acc[4 * j + 2 * e + 1] / l[e];
      const int unit = (j % 8) ^ (row % 8);
      *reinterpret_cast<uint32_t*>(stage + (j / 8) * kQBox + row * 128 +
                                   unit * 16 + c4 * 4) = pack_bf16(x0, x1);
    }
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + cw) : "memory");
  bf16* ob = o + b * o_b + h * o_h;
  constexpr int kUnits = D / 8;                // 16-byte units of a row
#pragma unroll
  for (int it = 0; it < 64 * kUnits / 128; ++it) {
    const int idx = it * 128 + t;
    const int row = idx / kUnits, u = idx % kUnits;
    if (qw + row >= seq) continue;
    const uint4 x = *reinterpret_cast<const uint4*>(
        stage + (u / 8) * kQBox + row * 128 + ((u % 8) ^ (row % 8)) * 16);
    *reinterpret_cast<uint4*>(ob + (long long)(qw + row) * o_s + u * 8) = x;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, without linking libcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [batch, seq, heads, D] bf16 with element strides (batch, head, seq), as a
// 4-D map (D, heads, seq, batch) read in boxes of 64 x 1 x rows x 1 with the
// 128-byte swizzle; rows past seq read as zeros
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int d,
              int heads, int seq, int batch, long long st_b, long long st_h,
              long long st_s, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st_h * 2, (cuuint64_t)st_s * 2,
                                 (cuuint64_t)st_b * 2};
  const cuuint32_t box[4] = {kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const long long* st, int batch, int n_heads, int group,
                   int seq, int causal, int window, float scale,
                   cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v;
  const int n_kv = n_heads / group;
  if (!make_map(enc, &tm_q, q, D, n_heads, seq, batch, st[0], st[1], st[2],
                kBM) ||
      !make_map(enc, &tm_k, k, D, n_kv, seq, batch, st[3], st[4], st[5],
                kBN<D>) ||
      !make_map(enc, &tm_v, v, D, n_kv, seq, batch, st[3], st[4], st[5],
                kBN<D>))
    return cudaErrorInvalidValue;
  constexpr int kSmem = Layout<D>::kBytes;
  auto kernel = flash_attention_wgmma<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * n_heads, (seq + kBM - 1) / kBM);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(o), st[6], st[7], st[8], n_heads,
      group, seq, causal, window, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace hopper

}  // namespace

// Dynamic shared memory a launch of a body asks for at `head_dim` (bytes),
// or -1 where the body does not take the head dim; for the compile report.
extern "C" int flash_attention_smem_bytes(int wgmma, int head_dim, int is_bf16) {
  if (wgmma) {
    if (!is_bf16) return -1;
    if (head_dim == 64) return hopper::Layout<64>::kBytes;
    if (head_dim == 128) return hopper::Layout<128>::kBytes;
    if (head_dim == 256) return hopper::Layout<256>::kBytes;
    return -1;
  }
  switch (head_dim) {
    case 16: case 32: case 64: case 128: case 256:
      return (kBQ * (head_dim + 4) + kBK * (head_dim + 4) + kBK * kLdP) * 4;
    default: return -1;
  }
}

// strides: nine element strides, (batch, head, seq) of q, of k and v, of o.
// window < 0: no sliding window.  is_bf16: bf16 tensors, else fp32.
// wgmma: the Hopper body (bf16 with head_dim 64, 128 or 256 only), else SIMT.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    const long long* strides, int batch, int n_heads, int group, int seq,
    int head_dim, int is_bf16, int causal, int window, float scale,
    int wgmma, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (wgmma) {
    if (!is_bf16) return static_cast<int>(cudaErrorInvalidValue);
    switch (head_dim) {
      case 64: err = hopper::launch<64>(q, k, v, o, strides, batch, n_heads, group, seq, causal, window, scale, s); break;
      case 128: err = hopper::launch<128>(q, k, v, o, strides, batch, n_heads, group, seq, causal, window, scale, s); break;
      case 256: err = hopper::launch<256>(q, k, v, o, strides, batch, n_heads, group, seq, causal, window, scale, s); break;
      default: err = cudaErrorInvalidValue;
    }
  } else {
    err = is_bf16 ? dispatch<__nv_bfloat16>(head_dim, q, k, v, o, strides,
                                            batch, n_heads, group, seq, causal,
                                            window, scale, s)
                  : dispatch<float>(head_dim, q, k, v, o, strides, batch,
                                    n_heads, group, seq, causal, window, scale,
                                    s);
  }
  return static_cast<int>(err);
}
