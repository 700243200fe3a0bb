// BSI ripple compare on Hopper (sm_90a).
//
// Replaces the Pallas kernel _bsi_compare_pallas
// (pilosa_tpu/ops/pallas_kernels.py:726, pallas_call at :738; body
// _bsi_compare_kernel at :700; entry bsi_compare_unsigned at :760).  A
// bit-sliced integer field keeps, per shard, the planes
//
//     P[s, 0] exists, P[s, 1] sign, P[s, 2 + i] magnitude bit i
//
// as rows of 32-bit words.  For every word column the kernel walks the
// magnitude planes from the most significant down, against an unsigned
// predicate given as two 32-bit limbs, and writes the columns strictly
// below it (lt) and strictly above it (gt) among the considered ones:
//
//     lt |= eq & pred_bit & ~plane
//     gt |= eq & ~pred_bit & plane
//     eq &= ~(plane ^ pred_bit)          (eq starts as consider)
//
// "Considered" is either given (cons, one row per shard: the caller's own
// exists & ~sign, exists & sign, or a filter on top) or, with form set,
// formed here as exists & ~sign & filt, which is the Pallas kernel's
// function exactly.  Callers derive eq = consider & ~lt & ~gt.  Only
// predicate bits below depth are read, as in the reference's ripple; the
// wrapper owns the upred >= 2^depth early-out.
//
// On the TPU one grid step held a 2048-word block of every plane in VMEM.
// Here a thread owns one 16-byte column of four words (or one word when
// the width is not a multiple of 4) of one shard, so nothing is shared
// between threads and no block reduction is needed; the shard is grid y.
// The running lt / gt / eq stay in registers.
//
// Bound: bytes.  Each considered word and each of the depth planes is read
// once, lt and gt written once; per word and plane the work is six bitwise
// operations, far below the card's integer rate.  Neighbouring threads
// read neighbouring 16-byte columns of one plane, so a warp's loads
// coalesce into 512-byte segments; the planes are read with streaming
// loads (__ldcs: read once, kept out of L2's way).
//
// The launch goes on the caller's stream and does not synchronise; the C
// entry returns cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridX = 1 << 16;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ unsigned pred_mask(unsigned lo, unsigned hi,
                                              int i) {
  const unsigned bit = i < 32 ? (lo >> i) & 1u : (hi >> (i - 32)) & 1u;
  return 0u - bit;  // all ones or zero
}

__device__ __forceinline__ uint4 ld4(const int32_t* p) {
  const int4 v = __ldcs(reinterpret_cast<const int4*>(p));
  return make_uint4(static_cast<unsigned>(v.x), static_cast<unsigned>(v.y),
                    static_cast<unsigned>(v.z), static_cast<unsigned>(v.w));
}

__device__ __forceinline__ void st4(int32_t* p, uint4 v) {
  *reinterpret_cast<int4*>(p) =
      make_int4(static_cast<int>(v.x), static_cast<int>(v.y),
                static_cast<int>(v.z), static_cast<int>(v.w));
}

__device__ __forceinline__ void step(unsigned p, unsigned m, unsigned& lt,
                                     unsigned& gt, unsigned& eq) {
  lt |= eq & m & ~p;
  gt |= eq & ~m & p;
  eq &= ~(p ^ m);
}

// One shard s per grid row; column j counts 16-byte groups (kVec) or
// words.  planes: [S, nplanes, words]; cons (or filt, with kForm):
// [S, words]; lt, gt: [S, words].
template <bool kVec, bool kForm>
__global__ void __launch_bounds__(kThreads)
bsi_compare_kernel(const int32_t* __restrict__ planes,
                   const int32_t* __restrict__ cons,
                   int32_t* __restrict__ lt_out,
                   int32_t* __restrict__ gt_out, int shards, int nplanes,
                   long long words, int depth, unsigned lo, unsigned hi) {
  const long long cols = kVec ? words / 4 : words;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (int s = blockIdx.y; s < shards; s += gridDim.y) {
    const int32_t* P = planes + static_cast<long long>(s) * nplanes * words;
    const long long row0 = static_cast<long long>(s) * words;
    for (long long j = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
         j < cols; j += stride) {
      if (kVec) {
        const long long w = 4 * j;
        uint4 c = ld4(cons + row0 + w);
        if (kForm) {
          const uint4 e = ld4(P + w);
          const uint4 g = ld4(P + words + w);
          c.x &= e.x & ~g.x;
          c.y &= e.y & ~g.y;
          c.z &= e.z & ~g.z;
          c.w &= e.w & ~g.w;
        }
        uint4 lt = make_uint4(0u, 0u, 0u, 0u);
        uint4 gt = make_uint4(0u, 0u, 0u, 0u);
        uint4 eq = c;
        for (int i = depth - 1; i >= 0; --i) {
          const unsigned m = pred_mask(lo, hi, i);
          const uint4 p = ld4(P + (2 + i) * words + w);
          step(p.x, m, lt.x, gt.x, eq.x);
          step(p.y, m, lt.y, gt.y, eq.y);
          step(p.z, m, lt.z, gt.z, eq.z);
          step(p.w, m, lt.w, gt.w, eq.w);
        }
        st4(lt_out + row0 + w, lt);
        st4(gt_out + row0 + w, gt);
      } else {
        unsigned c = static_cast<unsigned>(__ldcs(cons + row0 + j));
        if (kForm) {
          c &= static_cast<unsigned>(__ldcs(P + j)) &
               ~static_cast<unsigned>(__ldcs(P + words + j));
        }
        unsigned lt = 0u, gt = 0u, eq = c;
        for (int i = depth - 1; i >= 0; --i) {
          step(static_cast<unsigned>(__ldcs(P + (2 + i) * words + j)),
               pred_mask(lo, hi, i), lt, gt, eq);
        }
        lt_out[row0 + j] = static_cast<int32_t>(lt);
        gt_out[row0 + j] = static_cast<int32_t>(gt);
      }
    }
  }
}

template <bool kVec>
void launch(bool form, dim3 grid, cudaStream_t s, const int32_t* p,
            const int32_t* c, int32_t* lt, int32_t* gt, int shards,
            int nplanes, long long words, int depth, unsigned lo,
            unsigned hi) {
  if (form) {
    bsi_compare_kernel<kVec, true><<<grid, kThreads, 0, s>>>(
        p, c, lt, gt, shards, nplanes, words, depth, lo, hi);
  } else {
    bsi_compare_kernel<kVec, false><<<grid, kThreads, 0, s>>>(
        p, c, lt, gt, shards, nplanes, words, depth, lo, hi);
  }
}

}  // namespace

// planes int32[shards, nplanes, words] with nplanes = 2 + depth;
// cons int32[shards, words]: the considered columns, or the filter when
// form is 1 (consider = exists & ~sign & filt); lt, gt int32[shards,
// words].  The predicate's bits are lo | hi << 32.  vec: words is a
// multiple of 4 and every pointer is 16-byte aligned (the wrapper
// checks).
extern "C" int bsi_compare_launch(const void* planes, const void* cons,
                                  void* lt, void* gt, int shards,
                                  int nplanes, long long words, int depth,
                                  unsigned lo, unsigned hi, int form,
                                  int vec, void* stream) {
  if (shards <= 0 || words <= 0) return 0;
  if (depth < 0 || nplanes != depth + 2 || depth > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long cols = vec ? words / 4 : words;
  long long gx = (cols + kThreads - 1) / kThreads;
  if (gx > kMaxGridX) gx = kMaxGridX;
  const int gy = shards < kMaxGridY ? shards : kMaxGridY;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const int32_t*>(planes);
  const auto* c = static_cast<const int32_t*>(cons);
  auto* l = static_cast<int32_t*>(lt);
  auto* g = static_cast<int32_t*>(gt);
  if (vec) {
    launch<true>(form != 0, grid, s, p, c, l, g, shards, nplanes, words,
                 depth, lo, hi);
  } else {
    launch<false>(form != 0, grid, s, p, c, l, g, shards, nplanes, words,
                  depth, lo, hi);
  }
  return static_cast<int>(cudaGetLastError());
}
