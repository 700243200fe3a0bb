// GroupBy's masked matrix count on Hopper (sm_90a).
//
// Replaces the Pallas kernel _mmc_pallas
// (pilosa_tpu/ops/pallas_kernels.py:652, pallas_call at :661; body
// _mmc_kernel at :638):
//
//     out[g, r] = sum_w popcount(mat[r, w] & masks[g, w])
//
// mat int32[R, W] (a shard's child rows), masks int32[G, W] (the groups
// of the level so far), out int32[G, R].
//
// On the TPU an 8 x 128 x 256 (G x R x W) block grid built the whole
// [GB, RB, WB] popcount intermediate in VMEM and carried the sums across
// the sequential word axis in the output block.  Here a block owns a
// 32 x 32 (G x R) tile of outputs and keeps them in registers: each of
// its 8 warps owns 4 groups, each lane one row, so a thread holds 4 sums.
// The block walks its share of the word axis in 64-word chunks staged in
// shared memory (both operands' 32 rows), and every staged word is used
// 32 times (by every row, or every group, of the tile) instead of being
// streamed once per (g, r) pair.  The word axis is also split across
// blocks (grid z), so that even a single 32 x 32 tile fills the card;
// the partial sums of a split meet in the output by integer atomicAdd
// (exact, in any order) after the output is zeroed on the same stream.
//
// Bound: operations.  At GroupBy's shapes (64 groups x 64 rows x 32768
// words per shard at 2^20 columns) the operands are 16 MiB but the work
// is G * R * W = 2^27 word pairs, each an AND, a popcount and an add;
// the popcount unit (16 results per SM per clock on compute capability
// 9.0) is the limit.  The inner loop reads one int4 of its row (lanes on
// rows 68 words apart: conflict-free) and four int4 of its groups (the
// same address across the warp: a broadcast) per 16 popcounts.  Warps
// whose four groups all lie past G skip the compute.  Sums are int32: a
// row holds fewer than 2^31 bits (the wrapper checks).
//
// The launch goes on the caller's stream and does not synchronise; the C
// entry returns the first CUDA error of the memset and the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;                 // groups and rows per block tile
constexpr int kThreads = 256;             // 8 warps
constexpr int kGroupsPerWarp = kTile / (kThreads / 32);
constexpr int kChunk = 64;                // words staged per step
constexpr int kStride = kChunk + 4;       // padded row stride (int4 aligned)
constexpr int kStage = kTile * kChunk / kThreads;  // words per thread

static_assert(kGroupsPerWarp == 4, "4 groups per warp");
static_assert(kStage * kThreads == kTile * kChunk, "staging covers a tile");

__device__ __forceinline__ int popc_and4(int4 x, int4 y) {
  return __popc(static_cast<unsigned>(x.x & y.x)) +
         __popc(static_cast<unsigned>(x.y & y.y)) +
         __popc(static_cast<unsigned>(x.z & y.z)) +
         __popc(static_cast<unsigned>(x.w & y.w));
}

// Stage words [w0, w0 + kChunk) of rows [r0, r0 + kTile) of src into
// dst[kTile][kStride]; rows past n_rows and words past words read as 0.
__device__ __forceinline__ void stage(const int32_t* __restrict__ src,
                                      int n_rows, long long words, int r0,
                                      long long w0, int* dst) {
#pragma unroll
  for (int k = 0; k < kStage; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int row = e / kChunk;
    const int col = e % kChunk;
    const int r = r0 + row;
    const long long w = w0 + col;
    dst[row * kStride + col] =
        (r < n_rows && w < words)
            ? __ldg(src + static_cast<size_t>(r) * words + w)
            : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
masked_matrix_counts_kernel(const int32_t* __restrict__ mat,
                            const int32_t* __restrict__ masks,
                            int32_t* __restrict__ out, int n_rows,
                            int n_groups, long long words,
                            int chunks_per_block) {
  __shared__ __align__(16) int mat_s[kTile * kStride];
  __shared__ __align__(16) int mask_s[kTile * kStride];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kTile;
  const int g0 = blockIdx.y * kTile;
  const int gw = warp * kGroupsPerWarp;  // the warp's first tile group
  const bool live = g0 + gw < n_groups;  // uniform across the warp
  const long long n_chunks = (words + kChunk - 1) / kChunk;
  const long long c_begin =
      static_cast<long long>(blockIdx.z) * chunks_per_block;
  const long long c_end = c_begin + chunks_per_block < n_chunks
                              ? c_begin + chunks_per_block
                              : n_chunks;
  int acc[kGroupsPerWarp] = {0, 0, 0, 0};
  for (long long c = c_begin; c < c_end; ++c) {
    const long long w0 = c * kChunk;
    stage(mat, n_rows, words, r0, w0, mat_s);
    stage(masks, n_groups, words, g0, w0, mask_s);
    __syncthreads();
    if (live) {
      const int4* m4 =
          reinterpret_cast<const int4*>(mat_s + lane * kStride);
#pragma unroll 4
      for (int v = 0; v < kChunk / 4; ++v) {
        const int4 m = m4[v];
#pragma unroll
        for (int j = 0; j < kGroupsPerWarp; ++j) {
          const int4 k =
              reinterpret_cast<const int4*>(mask_s + (gw + j) * kStride)[v];
          acc[j] += popc_and4(m, k);
        }
      }
    }
    // the next chunk overwrites the staged tiles
    __syncthreads();
  }
  const int r = r0 + lane;
  if (!live || r >= n_rows) return;
#pragma unroll
  for (int j = 0; j < kGroupsPerWarp; ++j) {
    const int g = g0 + gw + j;
    if (g < n_groups) {
      atomicAdd(out + static_cast<size_t>(g) * n_rows + r, acc[j]);
    }
  }
}

}  // namespace

// mat int32[n_rows, words], masks int32[n_groups, words], out
// int32[n_groups, n_rows] (zeroed here, on the stream, before the launch).
extern "C" int masked_matrix_counts_launch(const void* mat, const void* masks,
                                           void* out, int n_rows, int n_groups,
                                           long long words, void* stream) {
  if (n_rows <= 0 || n_groups <= 0) return 0;
  if (words <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(n_groups) * n_rows * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long tiles_r = (n_rows + kTile - 1) / kTile;
  const long long tiles_g = (n_groups + kTile - 1) / kTile;
  if (tiles_g > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_chunks = (words + kChunk - 1) / kChunk;
  // about 4 blocks per SM in all, as long as each block keeps a chunk
  const long long target = 4LL * sms;
  long long split = (target + tiles_r * tiles_g - 1) / (tiles_r * tiles_g);
  if (split < 1) split = 1;
  if (split > n_chunks) split = n_chunks;
  if (split > 65535) split = 65535;
  const long long per_block = (n_chunks + split - 1) / split;
  split = (n_chunks + per_block - 1) / per_block;
  const dim3 grid(static_cast<unsigned>(tiles_r),
                  static_cast<unsigned>(tiles_g),
                  static_cast<unsigned>(split));
  masked_matrix_counts_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int32_t*>(mat), static_cast<const int32_t*>(masks),
      static_cast<int32_t*>(out), n_rows, n_groups, words,
      static_cast<int>(per_block));
  return static_cast<int>(cudaGetLastError());
}
