// Bitmap VM on Hopper (sm_90a): a megabatch of op-tape programs over one
// pooled compressed operand, one popcount per (query, domain slot) cell.
//
// Replaces the Pallas kernel _vm_counts_kernel / _vm_counts_pallas_body
// (pilosa_tpu/ops/pallas_kernels.py:418-481):
//
//     for each query q and domain slot d:
//       regs[l]         = pool[gidx[l][q][d]]            l < L (leaf slots)
//       regs[L + t]     = OP(prog[q][t][0])(regs[a], regs[b])   t < T
//       out[q][d]       = popcount(regs[L + T - 1])      over 2048 words
//
// with OP in AND, OR, XOR, ANDNOT, COPY (0..4, ops/tape.py) and a, b the
// absolute register operands prog[q][t][1..2].
//
// Design for the card.  The Pallas body kept a cell's whole register file
// in VMEM: (L + T) containers of 8 KiB, 384 KiB at the default caps
// (L = 16, T = 32), more than the 227 KiB of shared memory a Hopper block
// may hold.  Every op is word-wise, so the word axis tiles exactly: one
// block per cell, 128 threads, each thread walks its four int4 slices of
// the container (16 words) and for each slice loads the L leaf vectors
// (neighbouring threads on neighbouring 16-byte addresses), runs the T
// instructions on its own column of a shared-memory register file
// [L + T][128] of int4, and adds __popc of the last register.  The
// register file of the block is (L + T) * 2 KiB: 16 KiB at (4, 4),
// 96 KiB at the caps.  The tape of q (T * 3 ints) and the L row indices
// of the cell are read into shared memory once per block; the opcode is
// uniform across the block, so the interpreter never diverges.  The sums
// reduce across the warp with shuffles, across the four warps through
// shared memory, and one int32 per cell is written (at most 2^16, no
// overflow).
//
// Bound: bytes.  A cell reads its L gathered containers (8 KiB each) and
// writes 4 bytes; the work per word is T bitwise ops and one popcount.
// Cells of pad slots and pad rows all gather the pool's one zero row,
// which stays in L2.
//
// The wrapper (ops/cuda_kernels.vm_counts) checks every gidx entry
// against the pool and every operand against its instruction before the
// launch, so the kernel indexes without clamping.  The launch goes on the
// caller's stream and does not synchronise; the C entry returns
// cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kContainerWords = 2048;          // uint32 words
constexpr int kVecs = kContainerWords / 4;     // int4 vectors
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kVecsPerThread = kVecs / kThreads;

__device__ __forceinline__ int popc4(int4 v) {
  return __popc(static_cast<unsigned>(v.x)) +
         __popc(static_cast<unsigned>(v.y)) +
         __popc(static_cast<unsigned>(v.z)) +
         __popc(static_cast<unsigned>(v.w));
}

__device__ __forceinline__ int4 apply(int op, int4 a, int4 b) {
  switch (op) {
    case 0: return make_int4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
    case 1: return make_int4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
    case 2: return make_int4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
    case 3: return make_int4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z,
                             a.w & ~b.w);
    default: return a;  // COPY
  }
}

__global__ void __launch_bounds__(kThreads)
vm_counts_kernel(const int4* __restrict__ pool,
                 const int32_t* __restrict__ prog,
                 const int32_t* __restrict__ gidx,
                 int32_t* __restrict__ out, int n_q, int tape_len,
                 int slots, int domain) {
  extern __shared__ int4 smem[];
  int4* regs = smem;                                    // [L + T][kThreads]
  int* tape = reinterpret_cast<int*>(regs + (slots + tape_len) * kThreads);
  int* rows = tape + 3 * tape_len;                      // [L]
  __shared__ int warp_sums[kWarps];

  const int cell = blockIdx.x;
  const int q = cell / domain;
  const int d = cell - q * domain;
  const int tid = threadIdx.x;
  for (int i = tid; i < 3 * tape_len; i += kThreads) {
    tape[i] = prog[static_cast<size_t>(q) * 3 * tape_len + i];
  }
  for (int l = tid; l < slots; l += kThreads) {
    rows[l] = gidx[(static_cast<size_t>(l) * n_q + q) * domain + d];
  }
  __syncthreads();

  const int last = slots + tape_len - 1;
  int count = 0;
#pragma unroll 1
  for (int k = 0; k < kVecsPerThread; ++k) {
    const int v = k * kThreads + tid;
#pragma unroll 4
    for (int l = 0; l < slots; ++l) {
      regs[l * kThreads + tid] =
          __ldg(pool + static_cast<size_t>(rows[l]) * kVecs + v);
    }
    for (int t = 0; t < tape_len; ++t) {
      const int op = tape[3 * t];
      const int4 a = regs[tape[3 * t + 1] * kThreads + tid];
      const int4 b = regs[tape[3 * t + 2] * kThreads + tid];
      regs[(slots + t) * kThreads + tid] = apply(op, a, b);
    }
    count += popc4(regs[last * kThreads + tid]);
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    count += __shfl_down_sync(0xffffffffu, count, off);
  }
  if ((tid & 31) == 0) warp_sums[tid >> 5] = count;
  __syncthreads();
  if (tid == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w];
    out[cell] = s;
  }
}

static_assert(kVecs % kThreads == 0, "whole int4 slices per thread");

// the dynamic shared memory of one block; the wrapper's vm_smem_bytes
// (ops/cuda_kernels.py) computes the same, to refuse a call before launch
int smem_bytes(int tape_len, int slots) {
  return (slots + tape_len) * kThreads * static_cast<int>(sizeof(int4)) +
         (3 * tape_len + slots) * static_cast<int>(sizeof(int));
}

}  // namespace

extern "C" int vm_counts_launch(const void* pool, const void* prog,
                                const void* gidx, void* out, int n_q,
                                int tape_len, int slots, int domain,
                                void* stream) {
  const long long cells = static_cast<long long>(n_q) * domain;
  if (cells <= 0) return 0;
  if (tape_len <= 0 || slots <= 0 || cells > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = smem_bytes(tape_len, slots);
  cudaError_t err = cudaFuncSetAttribute(
      vm_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  vm_counts_kernel<<<static_cast<unsigned>(cells), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(pool), static_cast<const int32_t*>(prog),
      static_cast<const int32_t*>(gidx), static_cast<int32_t*>(out), n_q,
      tape_len, slots, domain);
  return static_cast<int>(cudaGetLastError());
}
