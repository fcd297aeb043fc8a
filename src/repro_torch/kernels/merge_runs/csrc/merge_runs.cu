// Bitonic merge of two ascending runs per row for Hopper (sm_90a), plain C entry point.
//
// Replaces: src/repro/kernels/merge_runs/kernel.py::merge_runs_pallas (body
// _merge_kernel, stage _merge_stage), the Pallas TPU kernel that forms
// [A ascending | B reversed] per row in VMEM and runs the log2(2T) stages of a
// bitonic merge network as reshapes and element-wise min/max.
//
// What bounds it on an H100: each key and payload is read once and written
// once, 32 bytes per input pair (e.g. 268 MB at G=16384, T=512, ~80 us at
// 3.35 TB/s).  The G*T*log2(2T) compare-exchanges are too few to set the
// bound, so it is bound by bytes.
//
// Design: a row of 2T keys and 2T payloads lives in dynamic shared memory
// (T <= 8192: 128 KB at the top).  One block holds R = max(1, 256 / T) rows,
// so short rows still give a block 256 threads.  The load writes A in place
// and B reversed (B[c] to position 2T-1-c), which makes each row bitonic;
// stage `stride` (T down to 1) compare-exchanges positions lo and lo + stride
// of every pair, a swap only on strict lo > hi as in the TPU kernel, with a
// __syncthreads() between stages.  Payloads move as raw 32-bit words; the key
// type is a template parameter, so int32, uint32 and float32 compare as
// themselves.  NaN keys are outside the contract (a NaN never swaps).  Warp
// shuffles for strides below 32, more rows per block and vector loads are
// left to a later kernel; power-of-two strides cost at most two-way bank
// conflicts.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxT = 8192;      // the whole row in shared memory: 2T x 8 B <= 128 KB
constexpr int kMinPairs = 256;   // compare-exchanges per stage a block gets at least
constexpr int kMaxThreads = 1024;

template <typename K>
__global__ void merge_runs_kernel(const K* __restrict__ ak, const K* __restrict__ bk,
                                  const uint32_t* __restrict__ av, const uint32_t* __restrict__ bv,
                                  K* __restrict__ ok, uint32_t* __restrict__ ov, int rows,
                                  int log_t, int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = 1 << log_t;
  const int n = 2 * t;  // a merged row
  K* sk = reinterpret_cast<K*>(smem);
  uint32_t* sv = reinterpret_cast<uint32_t*>(sk + rows_per_block * n);

  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long left = (long long)rows - row0;
  const int live_rows = left < rows_per_block ? (int)left : rows_per_block;
  const int pairs = live_rows << log_t;  // elements of A (and of B) held; pairs per stage
  const size_t in0 = (size_t)row0 << log_t;
  const size_t out0 = (size_t)row0 * n;

  // [A | reversed B] per row: A[r, c] to r*n + c, B[r, c] to r*n + n-1-c
  for (int i = threadIdx.x; i < pairs; i += blockDim.x) {
    const int r = i >> log_t;
    const int c = i & (t - 1);
    const int base = r * n;
    sk[base + c] = ak[in0 + i];
    sv[base + c] = av[in0 + i];
    sk[base + n - 1 - c] = bk[in0 + i];
    sv[base + n - 1 - c] = bv[in0 + i];
  }
  __syncthreads();

  for (int stride = t; stride >= 1; stride >>= 1) {
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int r = p >> log_t;
      const int q = p & (t - 1);  // pair q of row r: (q / stride) * 2 * stride + q % stride
      const int lo = r * n + ((q & ~(stride - 1)) << 1) + (q & (stride - 1));
      const int hi = lo + stride;
      const K kl = sk[lo];
      const K kh = sk[hi];
      if (kl > kh) {  // strict: equal keys stay put, the TPU kernel's rule
        sk[lo] = kh;
        sk[hi] = kl;
        const uint32_t v = sv[lo];
        sv[lo] = sv[hi];
        sv[hi] = v;
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < live_rows * n; i += blockDim.x) {
    ok[out0 + i] = sk[i];
    ov[out0 + i] = sv[i];
  }
}

template <typename K>
int launch(const void* ak, const void* bk, const void* av, const void* bv, void* ok, void* ov,
           int rows, int t, cudaStream_t stream) {
  int log_t = 0;
  while ((1 << log_t) < t) ++log_t;
  const int rows_per_block = t >= kMinPairs ? 1 : kMinPairs / t;
  const int threads = rows_per_block * t < kMaxThreads ? rows_per_block * t : kMaxThreads;
  const size_t smem = (size_t)rows_per_block * 2 * t * (sizeof(K) + sizeof(uint32_t));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        merge_runs_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)(((long long)rows + rows_per_block - 1) / rows_per_block);
  merge_runs_kernel<K><<<blocks, threads, smem, stream>>>(
      static_cast<const K*>(ak), static_cast<const K*>(bk), static_cast<const uint32_t*>(av),
      static_cast<const uint32_t*>(bv), static_cast<K*>(ok), static_cast<uint32_t*>(ov), rows,
      log_t, rows_per_block);
  return (int)cudaGetLastError();
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (key_type) {
    case 0: return launch<int32_t>(ak, bk, av, bv, ok, ov, rows, t, s);
    case 1: return launch<uint32_t>(ak, bk, av, bv, ok, ov, rows, t, s);
    case 2: return launch<float>(ak, bk, av, bv, ok, ov, rows, t, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
