// Blocked online-softmax attention (FlashAttention-style forward) for
// Hopper (sm_90a).
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
// steps.  Here one block owns one (b, h, 64-row q-tile) and loops over the
// live 64-key tiles itself: tiles in which every pair is masked (above the
// causal diagonal, or behind the window) are never loaded.  Q stays in
// shared memory; K and then V of each tile are staged through one shared
// buffer in fp32; P goes through shared memory transposed.  256 threads: a
// thread owns rows 4*ty..4*ty+3 of the tile (ty = tid / 16) and, of S,
// columns tx + 16 j (tx = tid % 16, j < 4), of O, D / 16 columns; row max
// and row sum are reduced across the 16 lanes of a row with shuffles.
// Blocks are issued heaviest q-tile first, so the causal tail is short.
//
// What bounds it on an H100: operations.  Causal prefill at S = 4096 does
// 4 D flops per unmasked (q, k) pair, about 1,100 flops per byte of q, k,
// v and o; the card's balance is about 295 (bf16 tensor cores) and 20
// (fp32 CUDA cores).  This first kernel does its products in fp32 on CUDA
// cores, as the reference's fp32 dots do, with 4x4 (S) and 4x(D/16) (O)
// register tiles fed by 16-byte shared-memory loads, so its ceiling is the
// 67 TFLOP/s fp32 rate, not the 989 TFLOP/s bf16 bound it is measured
// against.  wgmma on bf16 tiles, TMA loads and a pipelined K/V ring are
// later work, with their own tolerance argument.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// The entry launches on the given stream, allocates nothing, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for an unsupported head
// dimension) so the caller can raise on a refused launch.

#include <cstdint>
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

}  // namespace

// strides: nine element strides, (batch, head, seq) of q, of k and v, of o.
// window < 0: no sliding window.  is_bf16: bf16 tensors, else fp32.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    const long long* strides, int batch, int n_heads, int group, int seq,
    int head_dim, int is_bf16, int causal, int window, float scale,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(head_dim, q, k, v, o, strides, batch,
                                        n_heads, group, seq, causal, window,
                                        scale, s)
              : dispatch<float>(head_dim, q, k, v, o, strides, batch, n_heads,
                                group, seq, causal, window, scale, s);
  return static_cast<int>(err);
}
