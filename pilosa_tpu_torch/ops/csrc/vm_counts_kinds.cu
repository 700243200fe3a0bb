// Kind-decoding bitmap VM on Hopper (sm_90a): K3 over a kind-split
// megapool, with array and run containers decoded by the block in shared
// memory.
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
// What bounds it on this card.  A cell reads little from HBM: 8 KiB per
// bitmap leaf, and for an array or a run leaf only its compact row (2
// bytes a value, 4 bytes a pair; 130 and 64 bytes at the kinds leg's
// rows).  Its work is the decode and the tape on dense 2 KiB slices in
// shared memory, so the kernel is bound by the instructions its warps
// execute and by the barriers between its phases, not by bytes.  On an
// H100 the run rows' prefix xor is the largest part of that work, then
// the loading and clearing of the leaf slices, the run toggles and the
// array atomics (k3k_breakdown.py times the kernel with each left out).
// The first design (a binary search per thread, slice and leaf in
// global memory) was bound by the latency of those dependent loads.
//
// Design.  One block per cell, 128 threads, K3's four passes: in pass k
// thread i owns the int4 vector 128k + i (bits [16384k, 16384(k + 1)) of
// the container belong to the pass), and the register file [L + T][128]
// of int4 in shared memory holds the pass's 2 KiB of every register.
//
// - The tape is planned once per query on the host
//   (ops/cuda_kernels.vm_kinds_plan): COPYs become aliases of their
//   operands, and instructions and leaf slots that the result does not
//   reach are dropped (ops/tape.py pads tapes with COPYs and pads slots
//   onto the zero row).  The block reads its query's live instructions,
//   one packed int each, and the rows of the cell's live slots; the
//   result is the last live instruction's output, kept in a thread
//   register, or a leaf slot when no instruction is live.
// - Per pass, each thread writes its own int4 of every live leaf slot:
//   a bitmap leaf's vector loaded from HBM as in K3, zero for an array or
//   run leaf.  __syncthreads().
// - Arrays: the threads walk the row's sorted values from where the last
//   pass stopped, 128 at a time with coalesced 2-byte loads, and
//   atomicOr each value below the pass's upper edge into its shared
//   word; __syncthreads_count of those values says where the next pass
//   starts, so a value is loaded once per block (plus at most one chunk
//   per pass).  Each value sets its own bit, so the result is exact.
// - Runs: the threads stride over the row's pairs (valid where last >=
//   start, as the plain decode reads them); each run's intersection with
//   the pass, cut at the 4096-bit edges of each warp's part, toggles its
//   first bit and the bit after its last with atomicXor.  Roaring runs
//   are disjoint, so after __syncthreads() a prefix xor turns the toggles
//   into coverage: within each word by shifts, across a warp's 128 words
//   with one __ballot_sync of the threads' parities; a warp whose part
//   holds no toggle skips it.  A run of any length costs at most eight
//   atomics per pass, and no thread writes a long run's words one by one.
// - Then the live instructions run on the thread's own column, as in K3,
//   and the last one's output is popcounted in registers.
//
// The kind of a leaf is uniform across the block, so no branch on it
// diverges.  No thread searches a compact row.  The register file is
// (L + T) * 2 KiB as in K3; the tape is one int per instruction and each
// slot keeps one int for its row and one for its array position, so a
// block needs (L + T) * 2048 + (T + 2L) * 4 bytes, at most what K3 needs
// for every (L, T) with L + T <= 113 (the wrapper's
// vm_kinds_smem_bytes, ops/cuda_kernels.py, computes the same).
//
// The wrapper (ops/cuda_kernels.vm_counts_kinds) checks every gidx entry
// against Rb + Ra + Rr and every operand against its instruction before
// the launch, so the kernel indexes without clamping.  The launch goes on
// the caller's stream and does not synchronise; the C entry returns
// cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kContainerWords = 2048;          // uint32 words
constexpr int kVecs = kContainerWords / 4;     // int4 vectors
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPasses = kVecs / kThreads;
constexpr int kPassBits = kThreads * 128;      // bits of one pass
constexpr int kWarpBits = 32 * 128;            // bits of one warp's part
constexpr int kMaxRegs = 256;                  // register ids fit a byte
constexpr unsigned kFull = 0xffffffffu;

// Phases a timing build may leave out, to see what each costs
// (k3k_breakdown.py builds with -DK3K_OMIT=<mask>; its counts are then
// wrong).  The served build leaves out nothing.
#ifndef K3K_OMIT
#define K3K_OMIT 0
#endif
constexpr int kOmitGather = 1;   // loading and clearing the leaf slices
constexpr int kOmitArrays = 2;   // the array scatter
constexpr int kOmitToggles = 4;  // the run toggles; every warp still xors
constexpr int kOmitCover = 8;    // the run prefix xor
constexpr int kOmitTape = 16;    // all but the last live instruction
__host__ __device__ constexpr bool omits(int phase) {
  return (K3K_OMIT & phase) != 0;
}

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

// A packed instruction: opcode, operands a and b, destination register.
__device__ __forceinline__ int ins_op(unsigned i) { return i & 0xff; }
__device__ __forceinline__ int ins_a(unsigned i) { return (i >> 8) & 0xff; }
__device__ __forceinline__ int ins_b(unsigned i) { return (i >> 16) & 0xff; }
__device__ __forceinline__ int ins_dst(unsigned i) { return i >> 24; }

// Set the pass's values of one array row in ``words`` (the slot's 512
// shared words), from value index ``*start`` on; leaves in ``*start``
// where the next pass begins.  All threads call it.
__device__ __forceinline__ void scatter_array(
    unsigned* words, const uint16_t* __restrict__ vals, int card, int lo,
    int* start, int tid) {
  int base = *start;
  for (;;) {
    const int i = base + tid;
    const int v = i < card ? static_cast<int>(__ldg(vals + i)) : 1 << 16;
    const bool in = v < lo + kPassBits;
    // values are sorted: the pass's values are a prefix of the chunk
    const int n = __syncthreads_count(in);
    if (in) atomicOr(words + ((v - lo) >> 5), 1u << (v & 31));
    base += n;
    if (n < kThreads) break;
  }
  if (tid == 0) *start = base;
}

__device__ __forceinline__ void toggle(unsigned* words, int bit) {
  atomicXor(words + (bit >> 5), 1u << (bit & 31));
}

// Toggle the edges of one run row's coverage of the pass, cut at the
// warps' parts, in ``words``.  All threads call it.
__device__ __forceinline__ void toggle_runs(
    unsigned* words, const uint16_t* __restrict__ pairs, int cap, int lo,
    int tid) {
  for (int p = tid; p < cap; p += kThreads) {
    const int s = __ldg(pairs + 2 * p), e = __ldg(pairs + 2 * p + 1);
    if (e < s) continue;  // the padding pair (1, 0)
    const int a = max(s, lo) - lo;
    const int b = min(e, lo + kPassBits - 1) - lo;
    if (a > b) continue;  // outside the pass
    for (int seg = a / kWarpBits; seg <= b / kWarpBits; ++seg) {
      const int seg_lo = seg * kWarpBits;
      toggle(words, max(a, seg_lo));
      const int after = min(b, seg_lo + kWarpBits - 1) + 1;
      if (after < seg_lo + kWarpBits) toggle(words, after);
    }
  }
}

__device__ __forceinline__ unsigned prefix_xor(unsigned x) {
  x ^= x << 1;
  x ^= x << 2;
  x ^= x << 4;
  x ^= x << 8;
  return x ^ (x << 16);
}

// A thread's int4 of toggles -> coverage, the warp's part starting
// uncovered: bit i is the parity of the toggles at or before it.
__device__ __forceinline__ int4 cover(int4 t, int lane) {
  const unsigned w0 = prefix_xor(static_cast<unsigned>(t.x));
  const unsigned w1 = prefix_xor(static_cast<unsigned>(t.y));
  const unsigned w2 = prefix_xor(static_cast<unsigned>(t.z));
  const unsigned w3 = prefix_xor(static_cast<unsigned>(t.w));
  const unsigned p0 = w0 >> 31, p1 = w1 >> 31, p2 = w2 >> 31, p3 = w3 >> 31;
  const unsigned odd = __ballot_sync(kFull, p0 ^ p1 ^ p2 ^ p3);
  const unsigned c0 = __popc(odd & ((1u << lane) - 1u)) & 1u;
  const unsigned c1 = c0 ^ p0, c2 = c1 ^ p1, c3 = c2 ^ p2;
  return make_int4(static_cast<int>(w0 ^ (0u - c0)),
                   static_cast<int>(w1 ^ (0u - c1)),
                   static_cast<int>(w2 ^ (0u - c2)),
                   static_cast<int>(w3 ^ (0u - c3)));
}

__global__ void __launch_bounds__(kThreads)
vm_counts_kinds_kernel(const int4* __restrict__ bpool,
                       const uint16_t* __restrict__ apool,
                       const int32_t* __restrict__ acard,
                       const uint16_t* __restrict__ rpool,
                       const int32_t* __restrict__ plan,
                       const int32_t* __restrict__ gidx,
                       int32_t* __restrict__ out, int n_rb, int n_ra,
                       int acap, int rcap, int n_q, int tape_len,
                       int slots, int domain) {
  extern __shared__ int4 smem[];
  int4* regs = smem;                                    // [L + T][kThreads]
  unsigned* tape =
      reinterpret_cast<unsigned*>(regs + (slots + tape_len) * kThreads);
  int* rows = reinterpret_cast<int*>(tape + tape_len);  // [L]
  int* astart = rows + slots;                           // [L]
  __shared__ int warp_sums[kWarps];

  const int cell = blockIdx.x;
  const int q = cell / domain;
  const int d = cell - q * domain;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // the query's plan: live count, result, live instructions, live slots
  const int32_t* qplan =
      plan + static_cast<size_t>(q) * (2 + tape_len + slots);
  const int live_n = __ldg(qplan), res = __ldg(qplan + 1);
  for (int t = tid; t < live_n; t += kThreads) {
    tape[t] = static_cast<unsigned>(__ldg(qplan + 2 + t));
  }
  bool decoded = false;
  for (int l = tid; l < slots; l += kThreads) {
    const int g =
        __ldg(qplan + 2 + tape_len + l)
            ? gidx[(static_cast<size_t>(l) * n_q + q) * domain + d]
            : -1;  // a slot the result does not read
    rows[l] = g;
    astart[l] = 0;
    decoded |= g >= n_rb;
  }
  const bool any_decoded = __syncthreads_or(decoded);

  int count = 0;
#pragma unroll 1
  for (int k = 0; k < kPasses; ++k) {
    const int v = k * kThreads + tid;
    const int lo = k * kPassBits;
#pragma unroll 4
    for (int l = 0; l < slots; ++l) {
      const int g = rows[l];
      if (g < 0 || omits(kOmitGather)) continue;
      regs[l * kThreads + tid] =
          g < n_rb ? __ldg(bpool + static_cast<size_t>(g) * kVecs + v)
                   : make_int4(0, 0, 0, 0);
    }
    if (any_decoded) {
      __syncthreads();
      for (int l = 0; l < slots; ++l) {
        const int g = rows[l];
        if (g < n_rb) continue;  // dead or bitmap
        unsigned* words = reinterpret_cast<unsigned*>(regs + l * kThreads);
        if (g < n_rb + n_ra) {
          if (omits(kOmitArrays)) continue;
          const int r = g - n_rb;
          scatter_array(words, apool + static_cast<size_t>(r) * acap,
                        __ldg(acard + r), lo, astart + l, tid);
        } else {
          if (omits(kOmitToggles)) continue;
          const int r = g - n_rb - n_ra;
          toggle_runs(words, rpool + static_cast<size_t>(r) * 2 * rcap,
                      rcap, lo, tid);
        }
      }
      __syncthreads();
      for (int l = 0; l < slots; ++l) {
        if (rows[l] < n_rb + n_ra || omits(kOmitCover)) continue;
        int4* x = regs + l * kThreads + tid;
        const int4 t = *x;
        // a warp's part with no toggles stays uncovered (zero)
        if (omits(kOmitToggles) ||
            __ballot_sync(kFull, (t.x | t.y | t.z | t.w) != 0)) {
          *x = cover(t, lane);
        }
      }
    }
    if (live_n == 0) {  // the result is a leaf
      count += popc4(regs[res * kThreads + tid]);
      continue;
    }
    for (int i = 0; i < (omits(kOmitTape) ? 0 : live_n - 1); ++i) {
      const unsigned ins = tape[i];
      regs[ins_dst(ins) * kThreads + tid] =
          apply(ins_op(ins), regs[ins_a(ins) * kThreads + tid],
                regs[ins_b(ins) * kThreads + tid]);
    }
    const unsigned ins = tape[live_n - 1];
    count += popc4(apply(ins_op(ins), regs[ins_a(ins) * kThreads + tid],
                         regs[ins_b(ins) * kThreads + tid]));
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    count += __shfl_down_sync(kFull, count, off);
  }
  if (lane == 0) warp_sums[tid >> 5] = count;
  __syncthreads();
  if (tid == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w];
    out[cell] = s;
  }
}

static_assert(kVecs % kThreads == 0, "whole int4 slices per thread");
static_assert(kPassBits % kWarpBits == 0, "whole warp parts per pass");

// the dynamic shared memory of one block: the register file, the packed
// tape, and a row and an array position per slot; the wrapper's
// vm_kinds_smem_bytes (ops/cuda_kernels.py) computes the same
int smem_bytes(int tape_len, int slots) {
  return (slots + tape_len) * kThreads * static_cast<int>(sizeof(int4)) +
         (tape_len + 2 * slots) * static_cast<int>(sizeof(int));
}

// set-and-launch lock of the shared memory attribute (vm_counts.cu)
std::mutex launch_mutex;

}  // namespace

extern "C" int vm_counts_kinds_launch(
    const void* bpool, const void* apool, const void* acard,
    const void* rpool, const void* plan, const void* gidx, void* out,
    int n_rb, int n_ra, int acap, int rcap, int n_q, int tape_len, int slots,
    int domain, void* stream) {
  const long long cells = static_cast<long long>(n_q) * domain;
  if (cells <= 0) return 0;
  if (tape_len <= 0 || slots <= 0 || slots + tape_len > kMaxRegs ||
      cells > 0x7fffffffLL || acap <= 0 || rcap <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = smem_bytes(tape_len, slots);
  // the shared memory limit is one attribute of the function for every
  // host thread: set it and enqueue under one lock (vm_counts.cu)
  std::lock_guard<std::mutex> hold(launch_mutex);
  cudaError_t err = cudaFuncSetAttribute(
      vm_counts_kinds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  vm_counts_kinds_kernel<<<static_cast<unsigned>(cells), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(bpool), static_cast<const uint16_t*>(apool),
      static_cast<const int32_t*>(acard), static_cast<const uint16_t*>(rpool),
      static_cast<const int32_t*>(plan), static_cast<const int32_t*>(gidx),
      static_cast<int32_t*>(out), n_rb, n_ra, acap, rcap, n_q, tape_len,
      slots, domain);
  return static_cast<int>(cudaGetLastError());
}
