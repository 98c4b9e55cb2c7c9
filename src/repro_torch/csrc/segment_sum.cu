// Segment sum (embedding-bag reduction) for Hopper (sm_90a).
//
// K4 segment_matmul  replaces repro/kernels/segment_matmul.py::
//                    segment_matmul_kernel: out[s] = sum of rows i with
//                    seg[i] == s, ids outside [0, n) dropped, in the input
//                    type.  Two entries share one kernel:
//   rows entry       row i is messages[i]               ([E, D] in memory)
//   gathered entry   row i is table[indices[i]], read in place, so the
//                    [E, D] gather that the reference builds before its
//                    segment sum never exists on the card; an index in
//                    [-R, 0) counts from the end and one outside [-R, R)
//                    makes its segment NaN (jnp.take's fill semantics)
//
// The TPU kernel turns the scatter into one-hot matmuls on the MXU.  Here
// the caller stable-sorts the ids once (torch.sort, index preparation), so
// segment s is the run [starts[s], starts[s+1]) of the sorted order, with
// every row of a segment in ascending original index.  segment_starts
// finds the run boundaries in one pass over the sorted ids (no binary
// search, no atomics); segment_sum then gives one thread to each
// (segment, column), which walks its run in order and accumulates in fp32.
// So the result is deterministic and sums in the order of a sequential
// scatter; ids outside [0, n) sort before or after every run.
//
// What bounds it on an H100: device-memory bytes.  One add per element
// read, far below the card's operations-per-byte balance.  The least
// traffic is the rows read once, the ids and the order read once and the
// output written once (on the xDeepFM path, 32 rows of 40 bytes per bag).
// What the design does about it: consecutive threads take consecutive
// columns of one segment, so a warp reads whole rows; a gathered row costs
// its own 32-byte sectors and no copy.  Sharing the sort between the two
// segment sums of a mean bag and wider per-thread loads are left for later.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libsegment_sum.so segment_sum.cu
// Every entry launches on the given stream, allocates nothing, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// sorted ids clamped to [-1, n]: -1 stands for every negative id, n for
// every id >= n
__device__ __forceinline__ int clamp_id(int s, int n) {
  return s < 0 ? -1 : (s > n ? n : s);
}

// starts[s] for s in [0, n]: the first position of the sorted ids holding
// an id >= s.  Position i (0 <= i <= e) owns the ids s in (key[i-1],
// key[i]], with key[-1] = -1 and key[e] = n, so every s is written once.
__global__ void __launch_bounds__(kThreads)
segment_starts(const int32_t* __restrict__ sorted_ids, long long e, int n,
               int32_t* __restrict__ starts) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i <= e;
       i += (long long)gridDim.x * kThreads) {
    const int lo = i == 0 ? -1 : clamp_id(__ldg(sorted_ids + i - 1), n);
    const int hi = i == e ? n : clamp_id(__ldg(sorted_ids + i), n);
    for (int s = lo + 1; s <= hi; ++s) starts[s] = static_cast<int32_t>(i);
  }
}

// out[s, c] = sum over j in [starts[s], starts[s+1]) of src[row(order[j]),
// c], in order, in fp32; row(i) = i (rows entry) or indices[i] (gathered).
template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum(const T* __restrict__ src, long long n_src_rows,
            const int32_t* __restrict__ indices,
            const long long* __restrict__ order,
            const int32_t* __restrict__ starts, int n, int d,
            T* __restrict__ out) {
  const long long total = static_cast<long long>(n) * d;
  for (long long t = blockIdx.x * (long long)kThreads + threadIdx.x;
       t < total; t += (long long)gridDim.x * kThreads) {
    const int s = static_cast<int>(t / d);
    const int c = static_cast<int>(t - static_cast<long long>(s) * d);
    const int lo = __ldg(starts + s), hi = __ldg(starts + s + 1);
    float acc = 0.f;
    for (int j = lo; j < hi; ++j) {
      long long row = __ldg(order + j);
      if (indices) {
        row = __ldg(indices + row);
        if (row < 0) row += n_src_rows;
        if (row < 0 || row >= n_src_rows) {
          acc = __int_as_float(0x7fc00000);  // NaN: jnp.take's fill value
          continue;
        }
      }
      acc += to_f32(src[row * d + c]);
    }
    out[t] = from_f32<T>(acc);
  }
}

int grid_for(long long work) {
  const long long blocks = (work + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? (blocks > 0 ? blocks : 1)
                                              : kMaxBlocks);
}

template <typename T>
void launch_sum(const void* src, long long n_src_rows, const void* indices,
                const void* order, const void* starts, int n, int d,
                void* out, cudaStream_t stream) {
  segment_sum<T><<<grid_for(static_cast<long long>(n) * d), kThreads, 0,
                   stream>>>(
      static_cast<const T*>(src), n_src_rows,
      static_cast<const int32_t*>(indices),
      static_cast<const long long*>(order),
      static_cast<const int32_t*>(starts), n, d, static_cast<T*>(out));
}

}  // namespace

// K4, both entries.  src: [n_src_rows, d] rows of type dtype (0 float32,
// 1 float16), row-major; indices: int32 [e] or null (rows
// entry, row i is src row i); sorted_ids: int32 [e], the segment ids after
// a stable sort; order: int64 [e], the sort's permutation; starts: int32
// [n + 1] scratch; out: [n, d] of the same type.
extern "C" int segment_sum_launch(const void* src, long long n_src_rows,
                                  const void* indices, const void* sorted_ids,
                                  const void* order, long long e, int n, int d,
                                  int dtype, void* starts, void* out,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    segment_starts<<<grid_for(e + 1), kThreads, 0, st>>>(
        static_cast<const int32_t*>(sorted_ids), e, n,
        static_cast<int32_t*>(starts));
    if (d > 0) {
      if (dtype == 0)
        launch_sum<float>(src, n_src_rows, indices, order, starts, n, d, out,
                          st);
      else
        launch_sum<__half>(src, n_src_rows, indices, order, starts, n, d, out,
                           st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
