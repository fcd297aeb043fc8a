// Stable merge-path merge of two ascending runs per row for Hopper (sm_90a), plain C entry point.
//
// Replaces: src/repro/kernels/merge_runs/kernel.py::merge_runs_pallas (body
// _merge_kernel, stage _merge_stage), the Pallas TPU kernel that forms
// [A ascending | B reversed] per row in VMEM and runs the log2(2T) stages of a
// bitonic merge network as reshapes and element-wise min/max.  A bitonic
// network suits the TPU's vector units; on a GPU a thread can run a
// two-finger merge in registers, so this kernel is a merge path instead
// (Green, McColl and Bader, "GPU Merge Path", ICS 2012): O(T) comparisons a
// row instead of O(T log T), and one barrier instead of log2(2T).
//
// What bounds it on an H100: each key and payload is read once and written
// once, 32 bytes per input pair (268 MB at G=16384, T=512: 80 us at 3.35
// TB/s).  The comparisons are far too few to set the bound, so it is bound
// by bytes, and the design is about keeping enough bytes in flight.
//
// Design.  A block of kThreads threads produces a span of 256 * e outputs,
// e = min(kE, 2T) per thread: several whole rows when 2T <= span, else one
// span of one row.  It stages its A and B keys and payloads in shared memory
// (17.5 KB, static, so no attribute call at any T) with cp.async, every copy
// of the block issued before any is waited on (16-byte copies when T >= 4
// and all six pointers are 16-byte aligned, else 4-byte ones), then passes
// one barrier.  Thread j owns the outputs [j e, (j+1) e) of its row (or
// span): it binary-searches its diagonal d, and the next thread's, for the
// splits (A[i] <= B[d-1-i] moves right: ties go to A), learns at one more
// barrier that every thread's range is sound, merges its e outputs
// sequentially from shared memory into registers with the same comparison,
// and writes them as 16-byte stores, so a warp writes 1 KB contiguously.  No
// barrier falls between outputs.  Equal keys keep A's entries before B's,
// each run in its own order: the output equals a stable sort of [A | B],
// payloads included.  When a row spans several blocks (T > 1024), its warps
// first find the row's block splits in device memory (one warp each, 32
// probes a step), and the block stages only the ranges between its own two
// (rounded out to 16 bytes).  Small blocks keep several resident per SM, so
// one block's loads overlap another's merge.  Keys compare in their own type
// (a template parameter); payloads move as raw 32-bit words.
//
// NaN keys are outside the contract: a NaN compares false, so a row holding
// one is not ascending and its searches may give splits that cross.  The
// kernel then clamps the splits in order (block splits in every block of the
// row alike; thread splits by thread 0, only where some thread's range is
// unsound), so that every (key, payload) pair of such a row still leaves
// exactly once; the row's order is then left open.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxT = 8192;
constexpr int kE = 8;                  // outputs a thread merges
constexpr int kThreads = 256;
constexpr int kSpan = kThreads * kE;   // outputs a block produces, at most
constexpr int kWords = kSpan + 16;     // a staging array: a span, plus each side's 16-byte rounding

template <typename K>
__device__ __forceinline__ K key_of(uint32_t w) {
  K k;
  memcpy(&k, &w, sizeof k);
  return k;
}

__device__ __forceinline__ void cp_async_16(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Issue the copies of `words` words from src to dst (16-byte copies need both
// aligned and words a multiple of 4); waited on by cp.async.wait_all.
template <bool kVec>
__device__ __forceinline__ void stage(uint32_t* dst, const uint32_t* src, int words) {
  if (kVec) {
    for (int c = threadIdx.x * 4; c < words; c += kThreads * 4) cp_async_16(dst + c, src + c);
  } else {
    for (int c = threadIdx.x; c < words; c += kThreads) cp_async_4(dst + c, src + c);
  }
}

// How many of the first d outputs of the stable merge of a[0, na) and b[0, nb)
// come from a: the first i in [max(0, d - nb), min(d, na)) with
// !(a[i] <= b[d-1-i]), else min(d, na).
template <typename K>
__device__ __forceinline__ int split(const uint32_t* a, int na, const uint32_t* b, int nb, int d) {
  int lo = max(0, d - nb), hi = min(d, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_of<K>(a[mid]) <= key_of<K>(b[d - 1 - mid])) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The same split of two rows of t keys in device memory, found by one warp:
// lane l probes lo + (hi - lo) l / 32; the probes that hold form a prefix.
template <typename K>
__device__ int warp_split(const uint32_t* a, const uint32_t* b, int t, int d, int lane) {
  int lo = max(0, d - t), hi = min(d, t);
  while (lo < hi) {
    const int len = hi - lo;
    const int i = lo + ((len * lane) >> 5);
    const bool holds = key_of<K>(a[i]) <= key_of<K>(b[d - 1 - i]);
    const int c = __popc(__ballot_sync(0xffffffffu, holds));
    if (c == 0) {
      hi = lo;
    } else {
      const int next = c < 32 ? lo + ((len * c) >> 5) : hi;
      lo = lo + ((len * (c - 1)) >> 5) + 1;
      hi = next;
    }
  }
  return lo;
}

template <typename K, bool kVec>
__global__ void __launch_bounds__(kThreads)
    merge_path_kernel(const uint32_t* __restrict__ ak, const uint32_t* __restrict__ bk,
                      const uint32_t* __restrict__ av, const uint32_t* __restrict__ bv,
                      uint32_t* __restrict__ ok, uint32_t* __restrict__ ov, int rows, int t, int e_arg) {
  __shared__ __align__(16) uint32_t sk[kWords];
  __shared__ __align__(16) uint32_t sv[kWords];
  __shared__ int sp[kThreads];  // the row's block splits, then each thread's split
  const int e = kVec ? kE : e_arg;  // the scalar path also takes 2T = 2 or 4
  const int n = 2 * t;
  const int span = kThreads * e;
  const int tid = threadIdx.x;

  // A thread merges within a unit (a row, or this block's span of one): the
  // unit's A at sk + a0 (na keys), its B at sk + b0 (nb keys); d is the
  // thread's diagonal in the unit, out where its first output goes.
  int a0, na, b0, nb, d, unit, live_threads;
  size_t out;
  if (n <= span) {  // whole rows: A of row r at r t, B at span / 2 + r t
    const int rows_per_block = span / n;
    const long long row0 = (long long)blockIdx.x * rows_per_block;
    const int live = (int)min((long long)rows_per_block, (long long)rows - row0);
    const size_t g0 = (size_t)row0 * t;
    const int half = span / 2;
    stage<kVec>(sk, ak + g0, live * t);
    stage<kVec>(sk + half, bk + g0, live * t);
    stage<kVec>(sv, av + g0, live * t);
    stage<kVec>(sv + half, bv + g0, live * t);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    const int r = tid * e / n;
    a0 = r * t;
    b0 = half + r * t;
    na = nb = t;
    d = tid * e - r * n;
    unit = n;
    live_threads = live * (n / e);
    out = (size_t)(row0 + r) * n + d;
  } else {  // one span of a row: outputs [part * span, (part + 1) * span)
    constexpr int q = kVec ? 4 : 1;  // words per copy
    const int per_row = n / span;
    const size_t row = blockIdx.x / per_row;
    const int part = blockIdx.x % per_row;
    const uint32_t* ga = ak + row * t;
    const uint32_t* gb = bk + row * t;
    for (int k = (tid >> 5) + 1; k < per_row; k += kThreads / 32) {  // a warp a block diagonal
      const int s = warp_split<K>(ga, gb, t, k * span, tid & 31);
      if ((tid & 31) == 0) sp[k] = s;
    }
    __syncthreads();
    // The row's splits, clamped in order so that each block gets 0..span
    // keys of A and the rest of B.  Ascending runs give splits that the clamp
    // leaves as they are; every block of a row clamps alike.
    int i0 = 0, i1 = 0;
    for (int k = 1, prev = 0; k <= part + 1; ++k) {
      const int s = k < per_row ? sp[k] : t;
      prev = min(max(s, max(prev, k * span - t)), min(prev + span, t));
      if (k == part) i0 = prev;
      i1 = prev;
    }
    const int j0 = part * span - i0, j1 = (part + 1) * span - i1;
    const int a_lo = i0 & ~(q - 1), a_words = ((i1 + q - 1) & ~(q - 1)) - a_lo;
    const int b_lo = j0 & ~(q - 1), b_words = ((j1 + q - 1) & ~(q - 1)) - b_lo;
    stage<kVec>(sk, ga + a_lo, a_words);
    stage<kVec>(sk + a_words, gb + b_lo, b_words);
    stage<kVec>(sv, av + row * t + a_lo, a_words);
    stage<kVec>(sv + a_words, bv + row * t + b_lo, b_words);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    a0 = i0 - a_lo;
    na = i1 - i0;
    b0 = a_words + j0 - b_lo;
    nb = span - na;
    d = tid * e;
    unit = span;
    live_threads = kThreads;
    out = row * n + part * span + d;
  }

  // This thread takes A[s0, s1) and B[d - s0, d + e - s1); the next thread's
  // search gives it the same s1.  One barrier tells every thread whether all
  // ranges are sound (0 <= s1 - s0 <= e); where one is not (a NaN key),
  // thread 0 clamps the splits in order, as above.
  const uint32_t* ka = sk + a0;
  const uint32_t* kb = sk + b0;
  const bool live = tid < live_threads;
  int s0 = 0, s1 = 0;
  if (live) {
    s0 = split<K>(ka, na, kb, nb, d);
    s1 = split<K>(ka, na, kb, nb, d + e);
  }
  sp[tid] = s0;
  if (__syncthreads_or(live && (s1 < s0 || s1 - s0 > e))) {
    if (tid == 0) {
      for (int k = 0, prev = 0; k < live_threads; ++k) {
        const int dk = (k * e) & (unit - 1);
        prev = dk == 0 ? 0 : min(max(sp[k], max(prev, dk - nb)), min(prev + e, na));
        sp[k] = prev;
      }
    }
    __syncthreads();
    if (live) {
      s0 = sp[tid];
      s1 = d + e == unit ? na : sp[tid + 1];
    }
  }
  if (!live) return;

  // The sequential merge of this thread's e outputs, with the search's
  // comparison.  A[s1] and B[d + e - s1] may be read (they lie inside the
  // staging arrays) but are never taken.
  int i = s0, j = d - s0;
  const int j1 = d + e - s1;
  uint32_t x = ka[i], y = kb[j];
  uint32_t kw[kE], vw[kE];
#pragma unroll
  for (int k = 0; k < kE; ++k) {
    if (k < e) {
      if (j >= j1 || (i < s1 && key_of<K>(x) <= key_of<K>(y))) {
        kw[k] = x;
        vw[k] = sv[a0 + i];
        x = ka[++i];
      } else {
        kw[k] = y;
        vw[k] = sv[b0 + j];
        y = kb[++j];
      }
    }
  }
  if (kVec) {
    uint4* dk = reinterpret_cast<uint4*>(ok + out);
    uint4* dv = reinterpret_cast<uint4*>(ov + out);
#pragma unroll
    for (int c = 0; c < kE / 4; ++c) {
      dk[c] = make_uint4(kw[4 * c], kw[4 * c + 1], kw[4 * c + 2], kw[4 * c + 3]);
      dv[c] = make_uint4(vw[4 * c], vw[4 * c + 1], vw[4 * c + 2], vw[4 * c + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kE; ++k) {
      if (k < e) {
        ok[out + k] = kw[k];
        ov[out + k] = vw[k];
      }
    }
  }
}

template <typename K>
int launch(const void* ak, const void* bk, const void* av, const void* bv, void* ok, void* ov,
           int rows, int t, bool vec, cudaStream_t stream) {
  const int n = 2 * t;
  const int e = n < kE ? n : kE;
  const int span = kThreads * e;
  const long long blocks =
      n <= span ? ((long long)rows + span / n - 1) / (span / n) : (long long)rows * (n / span);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = vec ? merge_path_kernel<K, true> : merge_path_kernel<K, false>;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(ak), static_cast<const uint32_t*>(bk),
      static_cast<const uint32_t*>(av), static_cast<const uint32_t*>(bv),
      static_cast<uint32_t*>(ok), static_cast<uint32_t*>(ov), rows, t, e);
  return (int)cudaGetLastError();  // returns the launch's error and clears it
}

}  // namespace

// Returns a cudaError_t: 0 on success.  a/b keys and payloads: (rows, t),
// contiguous; out keys and payloads: (rows, 2t).  key_type: 0 int32, 1 uint32,
// 2 float32; payloads are any 32-bit words.  t a power of two <= 8192.
// Launches on `stream`, allocates nothing and does not synchronise.
extern "C" int merge_runs_launch(const void* ak, const void* bk, const void* av, const void* bv,
                                 void* ok, void* ov, int rows, int t, int key_type, void* stream) {
  if (rows <= 0 || t <= 0 || (t & (t - 1)) != 0 || t > kMaxT) {
    return (int)cudaErrorInvalidValue;
  }
  const uintptr_t any = (uintptr_t)ak | (uintptr_t)bk | (uintptr_t)av | (uintptr_t)bv |
                        (uintptr_t)ok | (uintptr_t)ov;
  const bool vec = 2 * t >= kE && (any & 15) == 0;  // T >= 4: a thread's kE outputs in one row
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (key_type) {
    case 0: return launch<int32_t>(ak, bk, av, bv, ok, ov, rows, t, vec, s);
    case 1: return launch<uint32_t>(ak, bk, av, bv, ok, ov, rows, t, vec, s);
    case 2: return launch<float>(ak, bk, av, bv, ok, ov, rows, t, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
