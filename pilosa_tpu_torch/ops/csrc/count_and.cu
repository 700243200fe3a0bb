// Intersection count |a & b| on Hopper (sm_90a).
//
// Replaces the Pallas kernel _count_and_pallas
// (pilosa_tpu/ops/pallas_kernels.py:194, pallas_call at :198; body
// _count_and_kernel at :182; entry count_and at :213):
//
//     out = sum_w popcount(a[w] & b[w])
//
// over two equal-shaped word arrays, given as rows x words with a row
// stride each, so that one plane of a [shards, planes, words] stack (the
// exists row of every shard, an aggregate's count) is read in place,
// without a copy.  A flat vector is one row.
//
// On the TPU a sequential grid of 2048-word blocks carried the sum in an
// int32 SMEM scalar, exact only below 2^31 bits.  Here blocks run in no
// order: each thread keeps a 64-bit sum in a register over a grid-stride
// loop, the block reduces it with warp shuffles and shared memory, and one
// 64-bit atomicAdd per block meets the others in the zeroed output.
// Integer addition commutes, so the count is exact in any order.
//
// Bound: bytes.  Both operands are read once; the work per word is one
// AND, one popcount and one add.  Threads read 16-byte int4 vectors,
// neighbouring threads on neighbouring addresses, with streaming loads
// (__ldcs); rows whose width is not a multiple of 4 words, or whose
// stride or base is not 16-byte aligned, take the same loop over single
// words.
//
// The launch goes on the caller's stream and does not synchronise; the C
// entry returns cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kTargetBlocks = 132 * 16;
constexpr int kMaxGridY = 65535;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
count_and_kernel(const int32_t* __restrict__ a, long long a_stride,
                 const int32_t* __restrict__ b, long long b_stride,
                 long long rows, long long words,
                 unsigned long long* __restrict__ out) {
  __shared__ unsigned long long warp_sums[kWarps];
  unsigned long long acc = 0;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const int32_t* ar = a + r * a_stride;
    const int32_t* br = b + r * b_stride;
    if (kVec) {
      const int4* a4 = reinterpret_cast<const int4*>(ar);
      const int4* b4 = reinterpret_cast<const int4*>(br);
      const long long vecs = words / 4;
      for (long long i = first; i < vecs; i += step) {
        const int4 x = __ldcs(a4 + i);
        const int4 y = __ldcs(b4 + i);
        acc += __popc(static_cast<unsigned>(x.x & y.x)) +
               __popc(static_cast<unsigned>(x.y & y.y)) +
               __popc(static_cast<unsigned>(x.z & y.z)) +
               __popc(static_cast<unsigned>(x.w & y.w));
      }
    } else {
      for (long long i = first; i < words; i += step) {
        acc += __popc(static_cast<unsigned>(__ldcs(ar + i) & __ldcs(br + i)));
      }
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    unsigned long long s = lane < kWarps ? warp_sums[lane] : 0ull;
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, off);
    }
    if (lane == 0 && s != 0) atomicAdd(out, s);
  }
}

}  // namespace

// a int32[rows, a_stride] and b int32[rows, b_stride], of which the first
// words of each row are counted; out uint64[1], zeroed by the caller, gets
// the count added.  vec: words, both strides and both bases are multiples
// of 4 words / 16 bytes (the wrapper checks).
extern "C" int count_and_launch(const void* a, long long a_stride,
                                const void* b, long long b_stride,
                                long long rows, long long words, void* out,
                                int vec, void* stream) {
  if (rows <= 0 || words <= 0) return 0;
  const long long cols = vec ? words / 4 : words;
  const int gy = rows < kMaxGridY ? static_cast<int>(rows) : kMaxGridY;
  long long gx = (cols + kThreads - 1) / kThreads;
  const long long want = (kTargetBlocks + gy - 1) / gy;
  if (gx > want) gx = want;
  if (gx < 1) gx = 1;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const int32_t*>(a);
  const auto* pb = static_cast<const int32_t*>(b);
  auto* o = static_cast<unsigned long long*>(out);
  if (vec) {
    count_and_kernel<true><<<grid, kThreads, 0, s>>>(pa, a_stride, pb,
                                                     b_stride, rows, words, o);
  } else {
    count_and_kernel<false><<<grid, kThreads, 0, s>>>(pa, a_stride, pb,
                                                      b_stride, rows, words,
                                                      o);
  }
  return static_cast<int>(cudaGetLastError());
}
