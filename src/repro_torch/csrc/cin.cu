// One xDeepFM CIN layer for Hopper (sm_90a): a tuned fp32 SIMT GEMM.
//
// K5 cin_layer  replaces repro/kernels/cin.py::cin_layer_kernel:
//               out[b, o, d] = relu(sum_{h, m} w[o, h, m] xk[b, h, d]
//                                   x0[b, m, d]), fp32 throughout.
//
// As in the TPU kernel, the layer is one dense product
//     out[(b, d), o] = sum_k P[(b, d), k] W[o, k],   k = h * M + m,
//     P[(b, d), (h, m)] = xk[b, h, d] * x0[b, m, d],
// and the [B * D, H * M] outer product P never reaches device memory: each
// 128 x 20 tile of it is built in shared memory from the xk and x0 values
// of its rows, just before the tile is used.
//
// What bounds it on an H100: operations.  2 * B * D * O * H * M flops on a
// few bytes per row (xDeepFM layer 2: 3.2 million flops per 1.6 KB batch
// row), far above the card's operations-per-byte balance, so the fp32
// CUDA-core peak (67 TFLOP/s: 128 FMAs a clock on each of 132 SMs) is the
// bound.  What the design does about it, point by point:
//  1. A wide register tile.  256 threads (8 warps, so a thread may hold
//     255 registers; 10 warps leave 168, and a 320-thread layout of 8 x 10
//     spilled), each with 8 rows x 13 outputs: 104 fp32 accumulators.  Per
//     k a thread uses 8 floats of P (two float4, k-major; a warp's lanes
//     read two addresses: a broadcast) and 13 of W (one float4 holds 4 k
//     of an output; W's rows are o-major, 20 floats = 5 16-byte chunks, so
//     8 lanes on 8 consecutive outputs hit 8 distinct groups of 4 banks):
//     104 FMAs per 21 floats.  W's float4s are taken in two groups of
//     outputs (7, then 6) and P is read again for the second: a broadcast
//     costs the banks little, and the live registers stay within 255.
//  2. Output tiles that fit O = 200.  A block tile is 128 rows x 208
//     outputs; thread (ty, tx) owns rows 8 ty .. 8 ty + 7 and outputs
//     tx + 16 j, j < 13.  At O = 200, 8 of 208 outputs (3.8%) are padding,
//     and each P element is built once for all of them.
//  3. A two-stage pipeline with one barrier per 20-deep k tile.  W's tile
//     for stage s + 1 goes into shared memory by cp.async, thread o copying
//     row o0 + o: 16 bytes a copy where the row's address is 16-byte
//     aligned and the tile whole, else 4 bytes with zero fill past the
//     slice's end (H * M may be odd); the copies are issued before stage
//     s's FMAs.  P's tile for stage s + 1 is loaded from xk and x0 into
//     registers before them, then multiplied and stored after them.  The
//     (h * D, m * D) offsets of each k column are computed once per tile
//     by 20 threads into a two-slot table in shared memory, two tiles
//     ahead.  Shared memory is dynamic (107,328 bytes), set with
//     cudaFuncSetAttribute.
//  4. A whole-wave plan at p99: split-K over whole ranges of h.  The grid
//     is (row tiles, output tiles, S); slice s runs h in [s H / S,
//     (s + 1) H / S) with all of m.  kernels/cin.py::plan picks S (S = 1
//     where the tiles fill a wave; at p99 40 row tiles x S = 3 = 120
//     blocks, one an SM).  With S > 1 each slice writes its partial sums,
//     in the output's own [B, O, D] layout, to a workspace [S, B, O, D]
//     that the wrapper allocates; cin_reduce adds the S partials in slice
//     order and applies relu.  With S = 1 the GEMM's epilogue applies relu
//     and writes the output.  No atomics.
//  5. A coalesced epilogue.  The 128 x 208 tile goes through shared
//     memory, so the block's outputs out[b, o0:o0+208, 0:D] for each b
//     (one contiguous run of floats) are written in 16-byte stores by
//     consecutive threads.
//
// Tolerance: every product xk * x0 is rounded to fp32 once (it is stored
// to shared memory before any FMA reads it) and accumulated with fp32 FMAs
// in ascending k within a slice, as the Pallas body's fp32 dot does; only
// the order of the fp32 sums differs, and the split-K partials are added
// in a fixed order.  No TF32, no tensor cores, no fast-math.  The result
// is deterministic: the same inputs give the same bits.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libcin.so cin.cu
// The entry launches on the given stream, allocates nothing, and returns
// the first CUDA error so the caller can raise on a refused launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;                // rows (b, d) of a block tile
constexpr int kBN = 208;                // outputs o of a block tile
constexpr int kBK = 20;                 // depth k = (h, m) of a k tile
constexpr int kTM = 8;                  // rows of a thread's register tile
constexpr int kTN = 13;                 // outputs of a thread's register tile
constexpr int kTX = kBN / kTN;          // 16 threads across the outputs
constexpr int kThreads = kTX * (kBM / kTM);   // 256
constexpr int kChunks = kBK / 4;        // 16-byte chunks of a W row per tile
constexpr int kWGroups = 2;             // W's float4 read in 2 groups of outputs
constexpr int kWGroup = (kTN + kWGroups - 1) / kWGroups;
constexpr int kPElems = kBK * kBM / kThreads;   // P elements a thread builds
constexpr int kPStep = kThreads / kBM;          // their column stride (2)
constexpr int kOutStride = kBM + 1;     // staged tile: o-major, padded rows
// shared memory, in floats: two stages of P ([kBK][kBM]) and of W
// ([kBN][kBK]) and the two-slot column table, or the staged output tile
constexpr int kAFloats = 2 * kBK * kBM;
constexpr int kBFloats = 2 * kBN * kBK;
constexpr int kTabInts = 2 * 2 * kBK;
constexpr int kPipeFloats = kAFloats + kBFloats + kTabInts;
constexpr int kOutFloats = kBN * kOutStride;
constexpr int kSmemBytes =
    4 * (kPipeFloats > kOutFloats ? kPipeFloats : kOutFloats);
constexpr int kReduceThreads = 256;

static_assert(kBK % 4 == 0 && kBM % kTM == 0 && kBN % kTN == 0, "tiles");
// a W row in shared memory is an odd number of 16-byte chunks, so that 8
// lanes reading 8 consecutive rows hit 8 distinct groups of 4 banks
static_assert(kChunks % 2 == 1, "W rows of an odd number of chunks");
static_assert(kBK * kBM % kThreads == 0 && kThreads % kBM == 0,
              "each thread builds P on one row, kPElems columns");

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// copies 4 bytes, or writes a 0 where src_bytes is 0
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Writes a staged output tile (o-major, row stride kOutStride) to dst in
// the [B, O, D] layout: for each batch row b the tile covers, its run of
// bn * d_dim floats from (b * O + o0) * D, in groups of kW consecutive
// floats (16-byte stores where kW is 4).  A group whose rows (b, d) are
// not all in the tile stores its in-tile floats one by one.
template <int kW>
__device__ void store_tile(const float* s_out, float* dst, long long r0,
                           long long r_end, int d_dim, int o_dim, int o0,
                           int bn, bool relu) {
  const long long b_first = r0 / d_dim;
  const int nb = static_cast<int>((r_end - 1) / d_dim - b_first + 1);
  const int per_b = bn * d_dim / kW;
  for (int it = threadIdx.x; it < nb * per_b; it += kThreads) {
    const int bi = it / per_b;
    const int q0 = (it - bi * per_b) * kW;
    const long long b = b_first + bi;
    float v[kW];
    bool in[kW];
    bool all = true;
#pragma unroll
    for (int e = 0; e < kW; ++e) {
      const int q = q0 + e;
      const int ol = q / d_dim;
      const long long rl = b * d_dim + (q - ol * d_dim) - r0;
      in[e] = rl >= 0 && rl < r_end - r0;
      all = all && in[e];
      v[e] = in[e] ? s_out[ol * kOutStride + rl] : 0.f;
      if (relu) v[e] = fmaxf(v[e], 0.f);
    }
    float* g = dst + (b * o_dim + o0) * d_dim + q0;
    if constexpr (kW == 4) {
      if (all) {
        *reinterpret_cast<float4*>(g) = make_float4(v[0], v[1], v[2], v[3]);
        continue;
      }
    }
#pragma unroll
    for (int e = 0; e < kW; ++e)
      if (in[e]) g[e] = v[e];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
cin_gemm(const float* __restrict__ xk, const float* __restrict__ x0,
         const float* __restrict__ w, float* __restrict__ out,
         float* __restrict__ ws, int batch, int h_dim, int m_dim, int d_dim,
         int o_dim) {
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                              // [2][kBK][kBM]
  float* b_s = smem + kAFloats;                   // [2][kBN][kBK]
  int2* tab = reinterpret_cast<int2*>(smem + kAFloats + kBFloats);  // [2][kBK]

  const int tid = threadIdx.x;
  const long long n_rows = static_cast<long long>(batch) * d_dim;
  const long long r0 = static_cast<long long>(blockIdx.x) * kBM;
  const int o0 = blockIdx.y * kBN;
  const int slices = gridDim.z;
  const int k_dim = h_dim * m_dim;
  const int k_begin = blockIdx.z * h_dim / slices * m_dim;
  const int k_end = (blockIdx.z + 1) * h_dim / slices * m_dim;
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;

  // building P: this thread's elements are row tid % kBM, columns
  // tid / kBM + kPStep * i
  const int p_row = tid % kBM;
  const int p_col = tid / kBM;
  const long long r = r0 + p_row;
  const bool row_ok = r < n_rows;
  const long long b = row_ok ? r / d_dim : 0;
  const long long d = row_ok ? r - b * d_dim : 0;
  const float* xk_row = xk + b * h_dim * d_dim + d;
  const float* x0_row = x0 + b * m_dim * d_dim + d;
  float pk[kPElems], pm[kPElems];

  // the product: rows ty * kTM + i, outputs tx + kTX * j
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  // (h * D, m * D) of column c of tile u, or -1 past the slice's end
  auto fill_table = [&](int slot, int u, int c) {
    const int k = k_begin + u * kBK + c;
    int2 t = make_int2(-1, -1);
    if (k < k_end) {
      const int h = k / m_dim;
      t = make_int2(h * d_dim, (k - h * m_dim) * d_dim);
    }
    tab[slot * kBK + c] = t;
  };
  // loading W: thread tid < kBN copies row o0 + tid of each k tile, in
  // 16-byte copies where the row's address allows it and the tile is
  // whole, else in 4-byte copies with zero fill past the slice's end
  const int w_row = o0 + tid;
  const bool w_ok = tid < kBN && w_row < o_dim;
  const float* w_src =
      w + (w_ok ? static_cast<long long>(w_row) * k_dim + k_begin : 0);
  const bool w_vec = (reinterpret_cast<uintptr_t>(w_src) & 15) == 0;
  auto copy_w = [&](int stage, int u) {
    if (!w_ok) return;
    float* dst = b_s + stage * kBN * kBK + tid * kBK;
    const float* src = w_src + u * kBK;
    const int left = k_end - k_begin - u * kBK;
    if (w_vec && left >= kBK) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) cp_async16(dst + 4 * c, src + 4 * c);
    } else {
#pragma unroll
      for (int e = 0; e < kBK; ++e)
        cp_async4(dst + e, e < left ? src + e : w, e < left ? 4 : 0);
    }
  };
  auto load_p = [&](int slot) {
#pragma unroll
    for (int i = 0; i < kPElems; ++i) {
      const int2 t = tab[slot * kBK + p_col + kPStep * i];
      const bool ok = row_ok && t.x >= 0;
      pk[i] = ok ? __ldg(xk_row + t.x) : 0.f;
      pm[i] = ok ? __ldg(x0_row + t.y) : 0.f;
    }
  };
  auto store_p = [&](int stage) {
    float* dst = a_s + stage * kBK * kBM;
#pragma unroll
    for (int i = 0; i < kPElems; ++i)
      dst[(p_col + kPStep * i) * kBM + p_row] = __fmul_rn(pk[i], pm[i]);
  };

  if (tid < kBK) fill_table(0, 0, tid);
  else if (tid < 2 * kBK) fill_table(1, 1, tid - kBK);
  if (tid < kBN && !w_ok) {   // rows past O: zero in both stages, for good
#pragma unroll
    for (int e = 0; e < kBK; ++e)
      b_s[tid * kBK + e] = b_s[(kBN + tid) * kBK + e] = 0.f;
  }
  if (n_tiles > 0) copy_w(0, 0);
  cp_async_commit();
  __syncthreads();
  if (n_tiles > 0) {
    load_p(0);
    store_p(0);
  }
  cp_async_wait_all();
  __syncthreads();

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    const bool next = t + 1 < n_tiles;
    if (next) {
      copy_w(stage ^ 1, t + 1);
      load_p((t + 1) & 1);
    }
    cp_async_commit();
    // slot t & 1 held tile t's columns, last read before the barrier
    if (tid < kBK && t + 2 < n_tiles) fill_table(t & 1, t + 2, tid);

    const float* a_t = a_s + stage * kBK * kBM + ty * kTM;
    const float* b_t = b_s + stage * kBN * kBK + tx * kBK;
    // per 4-deep chunk and group of outputs: a float4 of W (4 k) for each
    // output, then per k a broadcast float4 pair of P and 8 FMAs an output
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
      for (int g = 0; g < kWGroups; ++g) {
        const int j0 = g * kWGroup;
        const int j1 = j0 + kWGroup < kTN ? j0 + kWGroup : kTN;
        float4 bq[kWGroup];
#pragma unroll
        for (int j = 0; j < kWGroup; ++j)
          if (j0 + j < j1)
            bq[j] = *reinterpret_cast<const float4*>(
                b_t + (j0 + j) * kTX * kBK + 4 * c);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 lo =
              *reinterpret_cast<const float4*>(a_t + (4 * c + q) * kBM);
          const float4 hi =
              *reinterpret_cast<const float4*>(a_t + (4 * c + q) * kBM + 4);
          const float a[kTM] = {lo.x, lo.y, lo.z, lo.w,
                                hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int j = 0; j < kWGroup; ++j) {
            if (j0 + j >= j1) continue;
            const float bw = q == 0 ? bq[j].x
                           : q == 1 ? bq[j].y
                           : q == 2 ? bq[j].z
                                    : bq[j].w;
#pragma unroll
            for (int i = 0; i < kTM; ++i)
              acc[i][j0 + j] = fmaf(a[i], bw, acc[i][j0 + j]);
          }
        }
      }
    }

    if (next) store_p(stage ^ 1);
    cp_async_wait_all();
    __syncthreads();
  }

  // epilogue: stage the tile (o-major) over the pipeline's buffers, then
  // write it out; the last barrier of the loop ended every read of them
  float* s_out = smem;
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      s_out[(tx + kTX * j) * kOutStride + ty * kTM + i] = acc[i][j];
  __syncthreads();
  const bool split = slices > 1;
  float* dst = split ? ws + static_cast<long long>(blockIdx.z) * n_rows * o_dim
                     : out;
  const long long r_end = r0 + kBM < n_rows ? r0 + kBM : n_rows;
  const int bn = o_dim - o0 < kBN ? o_dim - o0 : kBN;
  if (static_cast<long long>(o_dim) * d_dim % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(dst) & 15) == 0)
    store_tile<4>(s_out, dst, r0, r_end, d_dim, o_dim, o0, bn, !split);
  else
    store_tile<1>(s_out, dst, r0, r_end, d_dim, o_dim, o0, bn, !split);
}

// out[i] = relu(ws[0][i] + ws[1][i] + ... + ws[S - 1][i]), the partials
// added in slice order; kW consecutive floats a thread (16-byte loads and
// stores where kW is 4)
template <int kW>
__global__ void __launch_bounds__(kReduceThreads)
cin_reduce(const float* __restrict__ ws, float* __restrict__ out,
           long long n, int slices) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * kReduceThreads + threadIdx.x) * kW;
  if (i >= n) return;
  if constexpr (kW == 4) {
    float4 s = *reinterpret_cast<const float4*>(ws + i);
    for (int z = 1; z < slices; ++z) {
      const float4 v = *reinterpret_cast<const float4*>(ws + z * n + i);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    *reinterpret_cast<float4*>(out + i) =
        make_float4(fmaxf(s.x, 0.f), fmaxf(s.y, 0.f), fmaxf(s.z, 0.f),
                    fmaxf(s.w, 0.f));
  } else {
    float s = ws[i];
    for (int z = 1; z < slices; ++z) s += ws[z * n + i];
    out[i] = fmaxf(s, 0.f);
  }
}

}  // namespace

// Dynamic shared memory of a cin_gemm block, in bytes.
extern "C" int cin_layer_smem_bytes() { return kSmemBytes; }

// K5.  xk: float32 [batch, h_dim, d_dim]; x0: float32 [batch, m_dim,
// d_dim]; w: float32 [o_dim, h_dim, m_dim]; out: float32 [batch, o_dim,
// d_dim]; all contiguous.  slices is the plan's S (kernels/cin.py::plan);
// where it is above 1, ws is a float32 workspace [slices, batch, o_dim,
// d_dim], else unused.
extern "C" int cin_layer_launch(const void* xk, const void* x0, const void* w,
                                void* out, void* ws, int batch, int h_dim,
                                int m_dim, int d_dim, int o_dim, int slices,
                                void* stream) {
  const long long n_rows = static_cast<long long>(batch) * d_dim;
  if (n_rows <= 0 || o_dim <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaFuncSetAttribute(
      cin_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((n_rows + kBM - 1) / kBM),
                  static_cast<unsigned>((o_dim + kBN - 1) / kBN),
                  static_cast<unsigned>(slices));
  cin_gemm<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const float*>(xk), static_cast<const float*>(x0),
      static_cast<const float*>(w), static_cast<float*>(out),
      static_cast<float*>(ws), batch, h_dim, m_dim, d_dim, o_dim);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return static_cast<int>(err);
  const long long n = n_rows * o_dim;
  const float* part = static_cast<const float*>(ws);
  float* dst = static_cast<float*>(out);
  if (n % 4 == 0 && (reinterpret_cast<uintptr_t>(part) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const long long blocks = (n / 4 + kReduceThreads - 1) / kReduceThreads;
    cin_reduce<4><<<static_cast<unsigned>(blocks), kReduceThreads, 0, s>>>(
        part, dst, n, slices);
  } else {
    const long long blocks = (n + kReduceThreads - 1) / kReduceThreads;
    cin_reduce<1><<<static_cast<unsigned>(blocks), kReduceThreads, 0, s>>>(
        part, dst, n, slices);
  }
  return static_cast<int>(cudaGetLastError());
}
