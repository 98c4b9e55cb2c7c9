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
// and either may take the mean: the fp32 sum over max(count, 1), count the
// segment's in-range ids, divided once (IEEE, round to nearest) before the
// store.
//
// The TPU kernel turns the scatter into one-hot matmuls on the MXU.  Here
// segment s is the run [starts[s], starts[s+1]) of ids in ascending order:
// the caller's own ids when it declares them sorted (the xDeepFM bags,
// arange(B F).repeat_interleave(bag)), else ids the wrapper stable-sorted,
// with `order` mapping a position back to its row.  Either way every row of
// a segment is summed in ascending original index, in fp32, so the result is
// deterministic and both entries give the same bits.
//
// What bounds it on an H100: device-memory bytes.  One add per element, far
// below the card's operations-per-byte balance.  The least traffic is the
// ids and indices read once, each distinct row read once and the output
// written once; but a gathered row costs whole 32-byte sectors, and a
// 40-byte row (D = 10, fp32) starts on an 8-byte boundary, so it always
// spans two: 64 bytes per gathered row, whether or not it was read before.
// Random rows reach those bytes only with many independent loads in flight.
// What the design does about it:
//   - no sort on declared-sorted ids, and no `order` array to read;
//   - segment_bounds: one pass over adjacent id pairs writes every run
//     boundary and flags a descending pair (a false declaration), which
//     makes segment_sum write NaN everywhere: loud, with no host sync;
//   - segment_sum: one thread per (segment, load unit of its row), the
//     unit the widest that a row's alignment allows (8 bytes for a 40-byte
//     row: only every other one starts on 16 bytes), so the five threads
//     of a row sit in neighbouring lanes and a warp's loads merge into
//     whole sectors.  A thread walks its run in chunks of kChunk positions:
//     it issues the chunk's index loads (streamed, evict-first, so they do
//     not push table rows out of L2), then all kChunk row loads
//     (non-coherent, independent of each other), and only then adds them in
//     ascending position, in fp32.  An xDeepFM bag of 8 is one chunk: three
//     latencies in all (bounds, indices, rows), no barrier and no shared
//     memory, so the registers alone bound how many warps an SM keeps in
//     flight.  A run of any length is taken chunk by chunk, its sum carried
//     in registers (hub segments of the rows entry's GNN callers).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libsegment_sum.so segment_sum.cu
// The entry launches on the given stream (a 4-byte memset and two kernels),
// allocates nothing, and returns cudaGetLastError() so the caller can raise
// on a refused launch.

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;        // positions whose loads a thread has in flight
constexpr long long kMaxBlocks = 1 << 20;
constexpr int kNaNBits = 0x7fc00000;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// ids clamped to [-1, n]: -1 stands for every negative id, n for every
// id >= n
__device__ __forceinline__ int clamp_id(int s, int n) {
  return s < 0 ? -1 : (s > n ? n : s);
}

// starts[s] for s in [0, n]: the first position holding an id >= s, for
// ids in ascending order.  Position i (0 <= i <= e) owns the s in
// (key[i-1], key[i]], with key[-1] = -1 and key[e] = n, so every s is
// written once.  A descending pair sets *unsorted (zeroed before the
// launch); starts is then incomplete, and segment_sum never reads it.
__global__ void __launch_bounds__(kThreads)
segment_bounds(const int32_t* __restrict__ ids, long long e, int n,
               int32_t* __restrict__ starts, int32_t* __restrict__ unsorted) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i <= e;
       i += (long long)gridDim.x * kThreads) {
    const int a = i == 0 ? -1 : __ldg(ids + i - 1);
    const int b = i == e ? n : __ldg(ids + i);
    if (i > 0 && i < e && a > b) *unsorted = 1;
    const int lo = i == 0 ? -1 : clamp_id(a, n);
    const int hi = i == e ? n : clamp_id(b, n);
    for (int s = lo + 1; s <= hi; ++s) starts[s] = static_cast<int32_t>(i);
  }
}

// Thread t sums unit u = t mod upr (kElems values of type T) of segment
// s = t / upr over its run, in ascending position, in fp32.  Units of a
// row and of the output row are contiguous: src and out are [rows, upr]
// arrays of U.
template <typename T, typename U>
__global__ void __launch_bounds__(kThreads)
segment_sum(const U* __restrict__ src, int n_src_rows,
            const int32_t* __restrict__ indices,
            const long long* __restrict__ order,
            const int32_t* __restrict__ starts,
            const int32_t* __restrict__ unsorted, long long units, int upr,
            int mean, U* __restrict__ out) {
  constexpr int kElems = static_cast<int>(sizeof(U) / sizeof(T));
  const long long t = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (t >= units) return;
  const long long s = t / upr;
  float acc[kElems];
#pragma unroll
  for (int k = 0; k < kElems; ++k) acc[k] = 0.f;
  int lo = 0, hi = 0;
  if (*unsorted) {          // a false sortedness declaration: all NaN
#pragma unroll
    for (int k = 0; k < kElems; ++k) acc[k] = __int_as_float(kNaNBits);
  } else {
    lo = __ldg(starts + s);
    hi = __ldg(starts + s + 1);
  }
  const U* const base = src + (t - s * upr);
  for (int j0 = lo; j0 < hi; j0 += kChunk) {
    int row[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int j = j0 + c;
      if (j < hi) {
        int r = order ? static_cast<int>(__ldcs(order + j)) : j;
        if (indices) {
          r = order ? __ldg(indices + r) : __ldcs(indices + j);
          if (r < 0) r += n_src_rows;
          if (r < 0 || r >= n_src_rows) r = -1;
        }
        row[c] = r;
      }
    }
    U v[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c)
      if (j0 + c < hi && row[c] >= 0)
        v[c] = __ldg(base + static_cast<long long>(row[c]) * upr);
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (j0 + c < hi) {
        const T* x = reinterpret_cast<const T*>(&v[c]);
#pragma unroll
        for (int k = 0; k < kElems; ++k)   // NaN: jnp.take's fill value
          acc[k] += row[c] >= 0 ? to_f32(x[k]) : __int_as_float(kNaNBits);
      }
    }
  }
  U o;
  T* y = reinterpret_cast<T*>(&o);
  const float count = fmaxf(static_cast<float>(hi - lo), 1.f);
#pragma unroll
  for (int k = 0; k < kElems; ++k)
    y[k] = from_f32<T>(mean ? __fdiv_rn(acc[k], count) : acc[k]);
  out[t] = o;
}

int grid_for(long long work) {
  const long long blocks = (work + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? (blocks > 0 ? blocks : 1)
                                              : kMaxBlocks);
}

template <typename T, typename U>
int launch_sum(const void* src, int n_src_rows, const void* indices,
               const void* order, const int32_t* starts,
               const int32_t* unsorted, int n, int d, int mean, void* out,
               cudaStream_t stream) {
  const int upr = static_cast<int>(d * sizeof(T) / sizeof(U));
  const long long units = static_cast<long long>(n) * upr;
  const long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  segment_sum<T, U><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const U*>(src), n_src_rows,
      static_cast<const int32_t*>(indices),
      static_cast<const long long*>(order), starts, unsorted, units, upr,
      mean, static_cast<U*>(out));
  return 0;
}

template <typename T>
int launch_unit(int unit, const void* src, int n_src_rows,
                const void* indices, const void* order, const int32_t* starts,
                const int32_t* unsorted, int n, int d, int mean, void* out,
                cudaStream_t st) {
  switch (unit) {
    case 16:
      return launch_sum<T, uint4>(src, n_src_rows, indices, order, starts,
                                  unsorted, n, d, mean, out, st);
    case 8:
      return launch_sum<T, uint2>(src, n_src_rows, indices, order, starts,
                                  unsorted, n, d, mean, out, st);
    case 4:
      return launch_sum<T, unsigned int>(src, n_src_rows, indices, order,
                                         starts, unsorted, n, d, mean, out,
                                         st);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch_sum<T, unsigned short>(src, n_src_rows, indices, order,
                                             starts, unsorted, n, d, mean,
                                             out, st);
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K4, every entry.  src: [n_src_rows, d] rows of type dtype (0 float32,
// 1 float16), row-major, n_src_rows < 2^31; indices: int32 [e] or null (rows entry, row i is
// src row i); ids: int32 [e] segment ids in ascending order (declared by
// the caller, or a stable sort's output); order: int64 [e], the sort's
// permutation, or null when the ids are the caller's own; unit: bytes of
// one load, dividing d * sizeof(dtype) and the alignment of src and out
// (kernels/segment_matmul.py::load_unit); mean: divide by max(count, 1);
// scratch: int32 [n + 2] (starts [n + 1], then the unsorted flag); out:
// [n, d] of the same type.
extern "C" int segment_sum_launch(const void* src, int n_src_rows,
                                  const void* indices, const void* ids,
                                  const void* order, long long e, int n, int d,
                                  int dtype, int unit, int mean, void* scratch,
                                  void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0 && d > 0) {
    int32_t* starts = static_cast<int32_t*>(scratch);
    int32_t* unsorted = starts + n + 1;
    cudaMemsetAsync(unsorted, 0, sizeof(int32_t), st);
    segment_bounds<<<grid_for(e + 1), kThreads, 0, st>>>(
        static_cast<const int32_t*>(ids), e, n, starts, unsorted);
    const int status =
        dtype == 0
            ? launch_unit<float>(unit, src, n_src_rows, indices, order, starts,
                                 unsorted, n, d, mean, out, st)
            : launch_unit<__half>(unit, src, n_src_rows, indices, order,
                                  starts, unsorted, n, d, mean, out, st);
    if (status != 0) return status;
  }
  return static_cast<int>(cudaGetLastError());
}
