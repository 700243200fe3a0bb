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
// What bounds it on this card: bytes, each distinct container of the
// launch read from HBM once, and at wide batches the integer work of the
// cells.  The queries of one coalesced batch name the same field rows
// again and again (a 4-query batch over five rows gathers 11 leaf
// vectors of D containers, but only 5 are distinct).  The first design
// ran one block per (query, domain slot) cell: queries that shared a leaf
// read its container in blocks D apart, after the card had streamed more
// than its L2 holds, so each read came from HBM again, and pad slots and
// COPYs ran at full cost.
//
// Design.
//
// - The plan is made on the host (ops/cuda_kernels.vm_plan), once per
//   launch.  Each query's tape is planned once per distinct tape
//   (vm_tape_plan and _query_plan, cached by the tape's bytes): COPYs
//   become aliases of their operands, and instructions and leaf slots
//   that the result does not reach are dropped.  An instruction whose
//   operand a is the previous one's output is flagged kPrev (the thread
//   still holds it); only an output that is read again otherwise is
//   flagged kStore and gets a scratch register.  The live slots'
//   directory vectors gidx[l][q][:] that are equal are one distinct leaf.
//   Queries are cut, in order, into groups whose distinct leaves and
//   registers fit one block's shared memory; at the coalescer's shapes
//   one group holds the whole batch.
// - Blocks are domain-major: block b owns domain slot d = b / G and query
//   group g = b % G, so the groups of one d run side by side.  128
//   threads; each holds kVec int4 vectors (2, or 1 where a group's
//   registers fill shared memory) of every register per pass, so a block
//   walks a container in 4 / kVec passes.
// - Each pass, every thread copies its vectors of each of the group's
//   distinct leaves from HBM into its column of a shared-memory register
//   file with cp.async, all copies in flight at once.  (A second leaf
//   buffer, the next pass's copies flying while a pass computes, measured
//   slower: it halves the blocks an SM holds.)  Then it runs every query
//   of the group in turn on that
//   column: the query's live instructions, registers renamed at block
//   start (a live slot to its distinct leaf, a stored output to its
//   scratch register), and __popc of the result.  Opcodes and operands
//   are uniform across the block, so nothing diverges, and a thread reads
//   only its own column, so a pass needs no barrier.
// - Each query's popcount is summed across the warp (__reduce_add_sync)
//   into a per-warp slot in shared memory, and after the last pass one
//   int32 per (query, d) is written (at most 2^16, no overflow).
//
// The shared memory of a block is vm_counts_smem_bytes below: the leaf
// and scratch registers of its group, per query the renamed tape (2 + T
// ints) and four warp sums, and the row of each distinct leaf at d.  The
// plan takes kVec = 2 where every group fits, else 1.  A group of one
// query with every slot live and distinct and a scratch register per
// instruction, at one vector, is the wrapper's admission bound
// (vm_smem_bytes): it admits every (L, T) the first design admitted.
//
// The plan arrives as one int32 array, `meta`:
//   [B][2 + T + L]  per query: the live instruction count n, the result
//                   register (a leaf slot when n = 0), the n live
//                   instructions packed op | flags | a << 8 | b << 16 |
//                   dst << 24 (slots, then scratch registers L + s; zeros
//                   after them), and per slot its group-local distinct
//                   leaf, -1 where dead;
//   [G][5]          per group: first query, queries, first leaf, leaves,
//                   scratch registers;
//   [U]             per distinct leaf (groups in order): l * B + q of a
//                   live slot that names it, its row of gidx.
//
// The wrapper (ops/cuda_kernels.vm_counts) checks every gidx entry
// against the pool and every operand against its instruction before the
// plan and the launch, so the kernel indexes without clamping.  The
// launch goes on the caller's stream and does not synchronise; the C
// entry returns cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kContainerWords = 2048;          // uint32 words
constexpr int kVecs = kContainerWords / 4;     // int4 vectors
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupInts = 5;
constexpr int kMaxRegs = 256;                  // register ids fit a byte
constexpr unsigned kFull = 0xffffffffu;

// Phases a timing build may leave out, to see what each costs
// (k3_compare.py builds with -DK3_OMIT=<mask>; its counts are then
// wrong).  The served build leaves out nothing.
#ifndef K3_OMIT
#define K3_OMIT 0
#endif
constexpr int kOmitCopy = 1;    // the copies of the leaves from HBM
constexpr int kOmitTape = 2;    // the instructions: each query counts leaf 0
constexpr int kOmitReduce = 4;  // the per-query warp sums: one per thread
__host__ __device__ constexpr bool omits(int phase) {
  return (K3_OMIT & phase) != 0;
}

__device__ __forceinline__ int popc4(int4 v) {
  return __popc(static_cast<unsigned>(v.x)) +
         __popc(static_cast<unsigned>(v.y)) +
         __popc(static_cast<unsigned>(v.z)) +
         __popc(static_cast<unsigned>(v.w));
}

// r[k] = OP(x[k], b[k]) over a thread's kVec vectors: x in registers,
// b a register in shared memory (vector k kThreads int4 after the
// first).  The opcode is uniform across the block, so the switch never
// diverges; COPY is never live (the plan makes it an alias).
template <int kVec>
__device__ __forceinline__ void apply(int op, const int4* x, const int4* b,
                                      int4* r) {
  switch (op) {
    case 0:
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int4 y = b[k * kThreads];
        r[k] = make_int4(x[k].x & y.x, x[k].y & y.y, x[k].z & y.z,
                         x[k].w & y.w);
      }
      break;
    case 1:
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int4 y = b[k * kThreads];
        r[k] = make_int4(x[k].x | y.x, x[k].y | y.y, x[k].z | y.z,
                         x[k].w | y.w);
      }
      break;
    case 2:
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int4 y = b[k * kThreads];
        r[k] = make_int4(x[k].x ^ y.x, x[k].y ^ y.y, x[k].z ^ y.z,
                         x[k].w ^ y.w);
      }
      break;
    default:
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int4 y = b[k * kThreads];
        r[k] = make_int4(x[k].x & ~y.x, x[k].y & ~y.y, x[k].z & ~y.z,
                         x[k].w & ~y.w);
      }
  }
}

// A packed instruction: opcode and flags, operands a and b, destination
// register.  kPrev: a is the previous instruction's output, still in the
// thread's registers; kStore: the output is read again, so it is stored
// (ops/cuda_kernels.py VM_PREV, VM_STORE).
constexpr unsigned kPrev = 0x10, kStore = 0x20;
__device__ __forceinline__ int ins_op(unsigned i) { return i & 0x0f; }
__device__ __forceinline__ int ins_a(unsigned i) { return (i >> 8) & 0xff; }
__device__ __forceinline__ int ins_b(unsigned i) { return (i >> 16) & 0xff; }
__device__ __forceinline__ int ins_dst(unsigned i) { return i >> 24; }

// The block's register of absolute register r of a query whose slots map
// to distinct leaves through lmap: a slot's leaf, or a scratch register
// past the group's nu leaves.
__device__ __forceinline__ unsigned rename(int r, const int32_t* lmap,
                                           int slots, int nu) {
  return static_cast<unsigned>(r < slots ? __ldg(lmap + r)
                                         : nu + (r - slots));
}

// One block: domain slot d, query group g; kVec int4 vectors per thread
// and pass, so 4 / kVec passes.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
vm_counts_kernel(const int4* __restrict__ pool,
                 const int32_t* __restrict__ gidx,
                 const int32_t* __restrict__ meta,
                 int32_t* __restrict__ out, int n_q, int tape_len,
                 int slots, int domain, int n_groups) {
  constexpr int kStride = kVec * kThreads;    // int4 of a register
  constexpr int kPasses = kVecs / kStride;
  const int g = blockIdx.x % n_groups;
  const int d = blockIdx.x / n_groups;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int row_len = 2 + tape_len + slots;
  const int32_t* groups = meta + static_cast<size_t>(n_q) * row_len;
  const int32_t* grp = groups + kGroupInts * g;
  const int q0 = __ldg(grp), nq = __ldg(grp + 1), u0 = __ldg(grp + 2);
  const int nu = __ldg(grp + 3), scratch = __ldg(grp + 4);
  const int32_t* leaf_src = groups + kGroupInts * n_groups + u0;

  extern __shared__ int4 smem[];
  int4* regs = smem;                   // [nu + S][kVec][kThreads]
  const int code_len = 2 + tape_len;
  int* code = reinterpret_cast<int*>(regs + (nu + scratch) * kStride);
  int* sums = code + nq * code_len;             // [nq][kWarps]
  int* rows = sums + nq * kWarps;               // [nu]

  for (int u = tid; u < nu; u += kThreads) {
    rows[u] = __ldg(gidx + static_cast<size_t>(__ldg(leaf_src + u)) * domain
                    + d);
  }
  // each query's tape, renamed onto the block's registers
  for (int i = tid; i < nq * code_len; i += kThreads) {
    const int qi = i / code_len, j = i - qi * code_len;
    const int32_t* p = meta + static_cast<size_t>(q0 + qi) * row_len;
    const int32_t* lmap = p + 2 + tape_len;
    const int n = __ldg(p);
    unsigned v = 0;
    if (j == 0) {
      v = n;
    } else if (j == 1) {
      v = n == 0 ? rename(__ldg(p + 1), lmap, slots, nu) : 0;
    } else if (j - 2 < n) {
      const unsigned ins = static_cast<unsigned>(__ldg(p + j));
      // a flagged kPrev and an unstored output name no register
      const unsigned a =
          ins & kPrev ? 0 : rename(ins_a(ins), lmap, slots, nu);
      const unsigned b = rename(ins_b(ins), lmap, slots, nu);
      const unsigned dst =
          ins & kStore ? rename(ins_dst(ins), lmap, slots, nu) : 0;
      v = (ins & 0xff) | a << 8 | b << 16 | dst << 24;
    }
    code[i] = static_cast<int>(v);
  }
  for (int i = tid; i < nq * kWarps; i += kThreads) sums[i] = 0;
  __syncthreads();

  // the thread's vectors of register r
  auto reg = [&](int r) { return regs + r * kStride + tid; };
  int unreduced = 0;  // a build without the warp sums counts here
#pragma unroll 1
  for (int pass = 0; pass < kPasses; ++pass) {
    // the thread's vectors of every distinct leaf, all copies in flight
    for (int u = 0; u < (omits(kOmitCopy) ? 0 : nu); ++u) {
      const int4* src =
          pool + static_cast<size_t>(rows[u]) * kVecs + pass * kStride + tid;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        __pipeline_memcpy_async(reg(u) + k * kThreads, src + k * kThreads,
                                sizeof(int4));
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    for (int qi = 0; qi < nq; ++qi) {
      const int* c = code + qi * code_len;
      const int n = c[0];
      int4 r[kVec];
      if (n == 0 || omits(kOmitTape)) {  // the result is a leaf
        const int4* x = reg(omits(kOmitTape) ? 0 : c[1]);
#pragma unroll
        for (int k = 0; k < kVec; ++k) r[k] = x[k * kThreads];
      }
      for (int i = 0; i < (omits(kOmitTape) ? 0 : n); ++i) {
        const unsigned ins = static_cast<unsigned>(c[2 + i]);
        int4 x[kVec];
        if (!(ins & kPrev)) {
          const int4* a = reg(ins_a(ins));
#pragma unroll
          for (int k = 0; k < kVec; ++k) x[k] = a[k * kThreads];
        } else {
#pragma unroll
          for (int k = 0; k < kVec; ++k) x[k] = r[k];
        }
        apply<kVec>(ins_op(ins), x, reg(ins_b(ins)), r);
        if (ins & kStore) {
          int4* y = reg(ins_dst(ins));
#pragma unroll
          for (int k = 0; k < kVec; ++k) y[k * kThreads] = r[k];
        }
      }
      int count = 0;
#pragma unroll
      for (int k = 0; k < kVec; ++k) count += popc4(r[k]);
      if (omits(kOmitReduce)) {
        unreduced += count;
        continue;
      }
      count = __reduce_add_sync(kFull, count);
      if (lane == 0) sums[qi * kWarps + warp] += count;
    }
  }
  if (omits(kOmitReduce) && lane == 0) sums[warp] += unreduced;

  __syncthreads();
  for (int qi = tid; qi < nq; qi += kThreads) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sums[qi * kWarps + w];
    out[static_cast<size_t>(q0 + qi) * domain + d] = s;
  }
}

static_assert(kVecs % (2 * kThreads) == 0, "whole int4 vectors per thread");

// The kernel's dynamic shared memory limit is one attribute of the
// function, shared by every host thread: set by one launch and read by
// another's, it refuses the larger launch (cudaErrorInvalidValue).  The
// coalescer flushes its buckets on their leaders' threads, so launches
// of different sizes race; each sets the limit and enqueues under this
// lock.  The launch is asynchronous, so the lock is held for microseconds.
std::mutex launch_mutex;

template <int kVec>
int launch(const void* pool, const void* gidx, const void* meta, void* out,
           int n_q, int tape_len, int slots, int domain, int n_groups,
           int smem, void* stream) {
  std::lock_guard<std::mutex> hold(launch_mutex);
  cudaError_t err = cudaFuncSetAttribute(
      vm_counts_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  vm_counts_kernel<kVec><<<static_cast<unsigned>(n_groups) * domain,
                           kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(pool), static_cast<const int32_t*>(gidx),
      static_cast<const int32_t*>(meta), static_cast<int32_t*>(out), n_q,
      tape_len, slots, domain, n_groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The dynamic shared memory of a block whose group has `leaves` distinct
// leaves, `scratch` scratch registers and `queries` queries, for tapes of
// `tape_len`, at `vec` int4 vectors per thread and pass; the wrapper's
// vm_group_smem_bytes (ops/cuda_kernels.py) computes the same.
extern "C" int vm_counts_smem_bytes(int leaves, int scratch, int queries,
                                    int tape_len, int vec) {
  return (leaves + scratch) * vec * kThreads *
             static_cast<int>(sizeof(int4)) +
         (queries * (2 + tape_len + kWarps) + leaves) *
             static_cast<int>(sizeof(int));
}

extern "C" int vm_counts_launch(const void* pool, const void* gidx,
                                const void* meta, void* out, int n_q,
                                int tape_len, int slots, int domain,
                                int n_groups, int vec, int smem,
                                void* stream) {
  const long long blocks = static_cast<long long>(n_groups) * domain;
  if (n_q <= 0 || domain <= 0) return 0;
  if (tape_len <= 0 || slots <= 0 || slots + tape_len > kMaxRegs ||
      n_groups <= 0 || n_groups > n_q || blocks > 0x7fffffffLL ||
      smem <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (vec) {
    case 1: return launch<1>(pool, gidx, meta, out, n_q, tape_len, slots,
                             domain, n_groups, smem, stream);
    case 2: return launch<2>(pool, gidx, meta, out, n_q, tape_len, slots,
                             domain, n_groups, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
