// One xDeepFM CIN layer for Hopper (sm_90a).
//
// K5 cin_layer  replaces repro/kernels/cin.py::cin_layer_kernel:
//               out[b, o, d] = relu(sum_{h, m} w[o, h, m] xk[b, h, d]
//                                   x0[b, m, d]), fp32 throughout.
//
// As in the TPU kernel, the layer is one dense product
//     out[(b, d), o] = sum_k P[(b, d), k] W[o, k],   k = h * M + m,
//     P[(b, d), (h, m)] = xk[b, h, d] * x0[b, m, d],
// and the [B * D, H * M] outer product P never reaches device memory: each
// 128 x 16 tile of it is built in shared memory from the xk and x0 values
// of its rows, just before the tile is used.  The rest is a plain tiled
// SIMT GEMM: a 128 (rows) x 64 (outputs) block tile, 16-deep k tiles,
// 256 threads each holding an 8 x 4 register tile, fp32 FMAs on the CUDA
// cores in ascending k.  Relu and the [B, O, D] layout are the epilogue.
//
// What bounds it on an H100: operations.  2 * B * D * O * H * M flops on a
// few bytes per row (xDeepFM layer 2: 3.2 million flops per 1.6 KB batch
// row), far above the card's operations-per-byte balance, so the fp32
// CUDA-core peak (67 TFLOP/s) is the bound.  What the design does about
// it: the outer product costs one multiply per A element against 64 FMAs
// that use it; every thread does 32 FMAs per pair of shared-memory reads.
// Double-buffered tiles, a coalesced epilogue and tensor cores (TF32 or
// bf16 wgmma, with their own tolerance) are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libcin.so cin.cu
// The entry launches on the given stream, allocates nothing, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;   // rows (b, d) of a block tile
constexpr int kBN = 64;    // outputs o of a block tile
constexpr int kBK = 16;    // depth k = (h, m) of a k tile
constexpr int kTM = 8;     // rows of a thread's register tile
constexpr int kTN = 4;     // outputs of a thread's register tile
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);   // 256
constexpr int kBPad = 4;   // keeps the B tile's float4 rows 16-byte aligned

__global__ void __launch_bounds__(kThreads)
cin_layer(const float* __restrict__ xk, const float* __restrict__ x0,
          const float* __restrict__ w, float* __restrict__ out, int batch,
          int h_dim, int m_dim, int d_dim, int o_dim) {
  __shared__ __align__(16) float a_s[kBK][kBM];          // P tile, k-major
  __shared__ __align__(16) float b_s[kBK][kBN + kBPad];  // W tile, k-major
  const long long n_rows = static_cast<long long>(batch) * d_dim;
  const int k_dim = h_dim * m_dim;
  const long long r0 = static_cast<long long>(blockIdx.x) * kBM;
  const int o0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;

  // building P: each thread owns one row and 8 of the 16 k columns
  const int a_row = tid % kBM;
  const int a_k = tid / kBM;   // 0 or 1: columns a_k, a_k + 2, ...
  const long long r = r0 + a_row;
  const bool row_ok = r < n_rows;
  const float* xk_row = xk;
  const float* x0_row = x0;
  if (row_ok) {
    const long long b = r / d_dim;
    const long long d = r - b * d_dim;
    xk_row = xk + b * h_dim * d_dim + d;
    x0_row = x0 + b * m_dim * d_dim + d;
  }
  // loading W: k column b_k, outputs b_o + 16 j
  const int b_k = tid % kBK;
  const int b_o = tid / kBK;
  // the product: 8 rows from ty * 8, 4 outputs from tx * 4
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k_dim; k0 += kBK) {
    int k = k0 + a_k;
    int h = k / m_dim;
    int m = k - h * m_dim;
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) {
      float v = 0.f;
      if (row_ok && k < k_dim)
        v = __ldg(xk_row + static_cast<long long>(h) * d_dim) *
            __ldg(x0_row + static_cast<long long>(m) * d_dim);
      a_s[a_k + 2 * j][a_row] = v;
      k += 2;
      m += 2;
      while (m >= m_dim) {
        m -= m_dim;
        ++h;
      }
    }
#pragma unroll
    for (int j = 0; j < kBN / (kThreads / kBK); ++j) {
      const int o = o0 + b_o + j * (kThreads / kBK);
      const int kk = k0 + b_k;
      b_s[b_k][b_o + j * (kThreads / kBK)] =
          (o < o_dim && kk < k_dim)
              ? __ldg(w + static_cast<long long>(o) * k_dim + kk)
              : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&a_s[kk][ty * kTM]);
      const float4 a_hi =
          *reinterpret_cast<const float4*>(&a_s[kk][ty * kTM + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&b_s[kk][tx * kTN]);
      const float a[kTM] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                            a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float bw[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long ri = r0 + ty * kTM + i;
    if (ri >= n_rows) continue;
    const long long b = ri / d_dim;
    const long long d = ri - b * d_dim;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int o = o0 + tx * kTN + j;
      if (o < o_dim) out[(b * o_dim + o) * d_dim + d] = fmaxf(acc[i][j], 0.f);
    }
  }
}

}  // namespace

// K5.  xk: float32 [batch, h_dim, d_dim]; x0: float32 [batch, m_dim,
// d_dim]; w: float32 [o_dim, h_dim, m_dim]; out: float32 [batch, o_dim,
// d_dim]; all contiguous.
extern "C" int cin_layer_launch(const void* xk, const void* x0, const void* w,
                                void* out, int batch, int h_dim, int m_dim,
                                int d_dim, int o_dim, void* stream) {
  const long long n_rows = static_cast<long long>(batch) * d_dim;
  if (n_rows > 0 && o_dim > 0) {
    const dim3 grid(static_cast<unsigned>((n_rows + kBM - 1) / kBM),
                    static_cast<unsigned>((o_dim + kBN - 1) / kBN));
    cin_layer<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(xk), static_cast<const float*>(x0),
        static_cast<const float*>(w), static_cast<float*>(out), batch, h_dim,
        m_dim, d_dim, o_dim);
  }
  return static_cast<int>(cudaGetLastError());
}
