// Kind-decoding bitmap VM on Hopper (sm_90a): K3 over a kind-split
// megapool, decoding array and run containers as it gathers them.
//
// Replaces the Pallas kernel _vm_counts_kinds_pallas
// (pilosa_tpu/ops/pallas_kernels.py:489-504), which decodes the array
// pool (kindpools.decode_array_jnp) and the run pool (decode_runs_jnp)
// into dense blocks, puts them behind the bitmap rows and runs K3's body:
//
//     virtual row g:  g < Rb            bitmap block bpool[g]
//                     g < Rb + Ra       array row apool[g - Rb]
//                                       (acard[g - Rb] sorted uint16 values)
//                     otherwise         run row rpool[g - Rb - Ra]
//                                       ((start, last) uint16 pairs)
//     for each query q and domain slot d:
//       regs[l]     = decode(row gidx[l][q][d])          l < L
//       regs[L + t] = OP(prog[q][t][0])(regs[a], regs[b])   t < T
//       out[q][d]   = popcount(regs[L + T - 1])
//
// with OP in AND, OR, XOR, ANDNOT, COPY (0..4, ops/tape.py).
//
// Design for the card.  It is vm_counts.cu with a decoding gather: one
// block per cell, 128 threads, each thread walking its four int4 slices
// (128 bits each) of the container, with a shared-memory register file
// [L + T][128] of int4 and the tape and the cell's rows in shared
// memory.  Where a leaf's row is a bitmap block the thread loads its
// slice from HBM, as K3 does.  Where it is an array or a run row, the
// thread builds its slice from the compact row instead:
//
// - array: a binary search over the row's sorted values finds the first
//   value at or past the slice's first bit, and the values inside the
//   slice's 128 bits are set in the thread's own int4 (a thread owns its
//   slice, so no other thread writes it and no atomics are needed);
// - run: valid pairs form a sorted, disjoint prefix of the row (padding
//   is the invalid pair (1, 0) after them); a binary search finds the
//   prefix's length, a second one the first run whose last bit reaches
//   the slice, and the runs that overlap the slice OR their coverage
//   masks into the int4.
//
// So the dense array and run blocks never reach HBM: a cell reads 8 KiB
// for a bitmap leaf, and for an array or run leaf the few compact values
// its slices need (a whole row is 2 * acap + 4 bytes or 4 * rcap bytes).
// The kind of a leaf is uniform across the block, so the branch does not
// diverge.  The register file is (L + T) * 2 KiB: 96 KiB at the caps
// (L = 16, T = 32), under the 227 KiB a block may hold.
//
// Bound: bytes, as K3: the compact rows the directory names, the program,
// the directory and the counts.  The searches add a few dependent L1/L2
// reads per slice.
//
// The wrapper (ops/cuda_kernels.vm_counts_kinds) checks every gidx entry
// against Rb + Ra + Rr and every operand against its instruction before
// the launch, so the kernel indexes without clamping.  The launch goes on
// the caller's stream and does not synchronise; the C entry returns
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

// bits [a, b] (0 <= a <= b < 32) of one word
__device__ __forceinline__ unsigned span_mask(int a, int b) {
  const unsigned hi = b == 31 ? 0xffffffffu : ((1u << (b + 1)) - 1u);
  return hi & ~((1u << a) - 1u);
}

// The 128-bit slice [lo, lo + 128) of an array row: values[0, card) sorted.
__device__ int4 decode_array_slice(const uint16_t* __restrict__ vals,
                                   int card, int lo) {
  unsigned w[4] = {0u, 0u, 0u, 0u};
  int left = 0, right = card;  // first index with vals[i] >= lo
  while (left < right) {
    const int mid = (left + right) >> 1;
    if (static_cast<int>(__ldg(vals + mid)) < lo) left = mid + 1;
    else right = mid;
  }
  for (int i = left; i < card; ++i) {
    const int off = static_cast<int>(__ldg(vals + i)) - lo;
    if (off >= 128) break;
    w[off >> 5] |= 1u << (off & 31);
  }
  return make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]),
                   static_cast<int>(w[2]), static_cast<int>(w[3]));
}

// The 128-bit slice [lo, lo + 128) of a run row of `cap` pairs.
__device__ int4 decode_run_slice(const uint16_t* __restrict__ pairs, int cap,
                                 int lo) {
  unsigned w[4] = {0u, 0u, 0u, 0u};
  // valid pairs (last >= start) are a prefix: its length
  int left = 0, right = cap;
  while (left < right) {
    const int mid = (left + right) >> 1;
    if (__ldg(pairs + 2 * mid + 1) >= __ldg(pairs + 2 * mid)) left = mid + 1;
    else right = mid;
  }
  const int nruns = left;
  // the first run whose last bit is at or past lo
  left = 0;
  right = nruns;
  while (left < right) {
    const int mid = (left + right) >> 1;
    if (static_cast<int>(__ldg(pairs + 2 * mid + 1)) < lo) left = mid + 1;
    else right = mid;
  }
  const int hi = lo + 127;
  for (int i = left; i < nruns; ++i) {
    const int s = __ldg(pairs + 2 * i);
    if (s > hi) break;
    const int a = max(s, lo) - lo;
    const int b = min(static_cast<int>(__ldg(pairs + 2 * i + 1)), hi) - lo;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int wa = max(a, 32 * k), wb = min(b, 32 * k + 31);
      if (wa <= wb) w[k] |= span_mask(wa - 32 * k, wb - 32 * k);
    }
  }
  return make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]),
                   static_cast<int>(w[2]), static_cast<int>(w[3]));
}

__global__ void __launch_bounds__(kThreads)
vm_counts_kinds_kernel(const int4* __restrict__ bpool,
                       const uint16_t* __restrict__ apool,
                       const int32_t* __restrict__ acard,
                       const uint16_t* __restrict__ rpool,
                       const int32_t* __restrict__ prog,
                       const int32_t* __restrict__ gidx,
                       int32_t* __restrict__ out, int n_rb, int n_ra,
                       int acap, int rcap, int n_q, int tape_len,
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
    const int lo = v * 128;  // the slice's first bit
#pragma unroll 1
    for (int l = 0; l < slots; ++l) {
      const int g = rows[l];
      int4 x;
      if (g < n_rb) {
        x = __ldg(bpool + static_cast<size_t>(g) * kVecs + v);
      } else if (g < n_rb + n_ra) {
        const int r = g - n_rb;
        x = decode_array_slice(apool + static_cast<size_t>(r) * acap,
                               __ldg(acard + r), lo);
      } else {
        const int r = g - n_rb - n_ra;
        x = decode_run_slice(rpool + static_cast<size_t>(r) * 2 * rcap, rcap,
                             lo);
      }
      regs[l * kThreads + tid] = x;
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

// the dynamic shared memory of one block, as in vm_counts.cu; the
// wrapper's vm_smem_bytes (ops/cuda_kernels.py) computes the same
int smem_bytes(int tape_len, int slots) {
  return (slots + tape_len) * kThreads * static_cast<int>(sizeof(int4)) +
         (3 * tape_len + slots) * static_cast<int>(sizeof(int));
}

}  // namespace

extern "C" int vm_counts_kinds_launch(
    const void* bpool, const void* apool, const void* acard,
    const void* rpool, const void* prog, const void* gidx, void* out,
    int n_rb, int n_ra, int acap, int rcap, int n_q, int tape_len, int slots,
    int domain, void* stream) {
  const long long cells = static_cast<long long>(n_q) * domain;
  if (cells <= 0) return 0;
  if (tape_len <= 0 || slots <= 0 || cells > 0x7fffffffLL || acap <= 0 ||
      rcap <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = smem_bytes(tape_len, slots);
  cudaError_t err = cudaFuncSetAttribute(
      vm_counts_kinds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  vm_counts_kinds_kernel<<<static_cast<unsigned>(cells), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(bpool), static_cast<const uint16_t*>(apool),
      static_cast<const int32_t*>(acard), static_cast<const uint16_t*>(rpool),
      static_cast<const int32_t*>(prog), static_cast<const int32_t*>(gidx),
      static_cast<int32_t*>(out), n_rb, n_ra, acap, rcap, n_q, tape_len,
      slots, domain);
  return static_cast<int>(cudaGetLastError());
}
