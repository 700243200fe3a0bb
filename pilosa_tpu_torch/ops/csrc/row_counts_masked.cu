// Masked row scan of TopN on Hopper (sm_90a).
//
// Replaces the Pallas kernel _row_counts_masked_pallas
// (pilosa_tpu/ops/pallas_kernels.py:145, pallas_call at :151; body
// _row_counts_kernel at :131):
//
//     out[r] = sum_w popcount(mat[r, w] & filt[i, w])
//
// with i = fidx[r] when a filter index is given, else 0.  Without the
// index it is the Pallas kernel's function exactly (one filter row for
// the whole matrix: TopN with a filter on one shard).  With it, one launch
// scans the rows of many shards, each against its own shard's filter row
// (the fused cross-shard TopN scan, pilosa_tpu/ops/bitmap.py:455-480).
//
// On the TPU a sequential grid of 128-row x 2048-word blocks carried each
// row's sum across the word blocks in the output block.  Here one block
// owns one row at a time (a grid-stride loop over rows) and a loop inside
// the block walks the row's words, so nothing carries between blocks and
// no cross-block reduction is needed.
//
// Bound: bytes.  The matrix is read once; the filter rows are few (one
// per shard, 128 KiB each at 2^20 columns) and are read again by every
// row of their shard, so after the first they come from L2.  The work per
// word is one AND, one popcount and one add, far below the card's integer
// rate.  Design for that: 256 threads read the row as 16-byte int4
// vectors, neighbouring threads on neighbouring addresses, the matrix
// with streaming loads (__ldcs: read once, kept out of L2's way) and the
// filter through the read-only path (__ldg) so it stays in L2; counts are
// kept in registers with __popc on the unsigned word, then summed across
// the warp with __shfl_down_sync and across the 8 warps through shared
// memory.  A row holds fewer than 2^31 bits (the wrapper checks), so the
// int32 sum cannot wrap.  Rows whose width is not a multiple of 4 words
// take the same loop over single words.
//
// The launch goes on the caller's stream and does not synchronise; the C
// entry returns cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGrid = 1 << 20;

__device__ __forceinline__ int popc_and4(int4 x, int4 y) {
  return __popc(static_cast<unsigned>(x.x & y.x)) +
         __popc(static_cast<unsigned>(x.y & y.y)) +
         __popc(static_cast<unsigned>(x.z & y.z)) +
         __popc(static_cast<unsigned>(x.w & y.w));
}

// Sum of v over the block; the result is valid in thread 0.
__device__ __forceinline__ int block_sum(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  int s = 0;
  if (warp == 0) {
    s = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, off);
    }
  }
  // warp_sums is reused by the block's next row
  __syncthreads();
  return s;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
row_counts_masked_kernel(const int32_t* __restrict__ mat,
                         const int32_t* __restrict__ filt,
                         const int32_t* __restrict__ fidx,
                         int32_t* __restrict__ out, int rows,
                         long long words) {
  __shared__ int warp_sums[kWarps];
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const int f = fidx != nullptr ? fidx[r] : 0;
    const int32_t* a = mat + static_cast<size_t>(r) * words;
    const int32_t* b = filt + static_cast<size_t>(f) * words;
    int c = 0;
    if (kVec) {
      const int4* a4 = reinterpret_cast<const int4*>(a);
      const int4* b4 = reinterpret_cast<const int4*>(b);
      const long long vecs = words / 4;
#pragma unroll 4
      for (long long i = threadIdx.x; i < vecs; i += kThreads) {
        c += popc_and4(__ldcs(a4 + i), __ldg(b4 + i));
      }
    } else {
      for (long long i = threadIdx.x; i < words; i += kThreads) {
        c += __popc(static_cast<unsigned>(__ldcs(a + i) & __ldg(b + i)));
      }
    }
    const int s = block_sum(c, warp_sums);
    if (threadIdx.x == 0) out[r] = s;
  }
}

}  // namespace

// mat int32[rows, words], filt int32[n_filters, words], fidx int32[rows]
// or null (every row against filter 0), out int32[rows].  vec: words is a
// multiple of 4 and mat and filt are 16-byte aligned (the wrapper checks).
extern "C" int row_counts_masked_launch(const void* mat, const void* filt,
                                        const void* fidx, void* out,
                                        int rows, long long words, int vec,
                                        void* stream) {
  if (rows <= 0) return 0;
  if (words <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = rows < kMaxGrid ? rows : kMaxGrid;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const int32_t*>(mat);
  const auto* f = static_cast<const int32_t*>(filt);
  const auto* i = static_cast<const int32_t*>(fidx);
  auto* o = static_cast<int32_t*>(out);
  if (vec) {
    row_counts_masked_kernel<true><<<grid, kThreads, 0, s>>>(m, f, i, o, rows,
                                                             words);
  } else {
    row_counts_masked_kernel<false><<<grid, kThreads, 0, s>>>(m, f, i, o,
                                                              rows, words);
  }
  return static_cast<int>(cudaGetLastError());
}
