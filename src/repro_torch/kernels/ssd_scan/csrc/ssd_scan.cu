// Mamba2 SSD chunked scan for Hopper (sm_90a), plain C entry point.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py::ssd_scan_pallas (body
// _ssd_kernel), the Pallas TPU kernel whose grid is (B, H, chunks) with the
// chunk axis run in order and the (P, N) state carried in VMEM scratch.
//
// What bounds it on an H100: at the serving shape of mamba2-780m (B=4,
// S=1024, H=48, P=64, N=128, L=256, bf16) the function moves ~60 MB and needs
// ~16 GFLOP (causal half of the L x L scores), so on bf16 tensor cores it
// would be bound by memory (~18 us).  This first kernel computes in f32 on
// CUDA cores (67 TFLOP/s peak), so operations bound it.
//
// Design: one thread block per (batch, head); the chunk loop runs inside the
// block in place of the TPU's sequential chunk axis, and the f32 state lives
// in shared memory for the whole sequence (no device-memory round trip).  Per
// chunk the (L, L) decay-weighted scores are tiled over TT x TT blocks of
// rows l and columns s, skipping blocks above the diagonal; each product is a
// shared-memory matrix product in which a thread owns 4x4 outputs and reads
// operands as float4.  The causal mask is applied before the exp.  B and C
// are re-read from L2 once per tile pair and are not shared across the heads
// of a group; wgmma, TMA and that sharing are left to a later kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanSegments = 16;  // L is a multiple of 16

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// out[m][n] (+)= sum_k a[k][m] * b[k][n] over shared memory, both operands
// stored k-major.  M and NC are multiples of 4; lda, ldb, ldo are multiples
// of 4 and every base is 16-byte aligned.  Each thread owns 4x4 outputs.
template <bool kAccumulate>
__device__ void mm_kmajor(const float* a, int lda, const float* b, int ldb, float* out,
                          int ldo, int M, int NC, int K) {
  const int tiles_n = NC / 4;
  const int tiles = (M / 4) * tiles_n;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
    const int m0 = (t / tiles_n) * 4;
    const int n0 = (t % tiles_n) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (kAccumulate) {
        const float4 o = *reinterpret_cast<const float4*>(out + (m0 + i) * ldo + n0);
        acc[i][0] = o.x;
        acc[i][1] = o.y;
        acc[i][2] = o.z;
        acc[i][3] = o.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
    }
    for (int k = 0; k < K; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(a + k * lda + m0);
      const float4 bv = *reinterpret_cast<const float4*>(b + k * ldb + n0);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(out + (m0 + i) * ldo + n0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// Shared-memory floats the kernel needs for one block.
__host__ __device__ inline size_t smem_floats(int P, int N, int L, int TT) {
  const int ldt = TT + 4;
  return (size_t)N * P + 2 * (size_t)L + 2 * (size_t)N * ldt + 2 * (size_t)TT * P +
         (size_t)TT * TT + kScanSegments;
}

// x, y: (B,S,H,P); dt: (B,S,H); a: (H,); bmat, cmat: (B,S,G,N);
// state_out: (B,H,P,N) f32.  S % L == 0, L % TT == 0, TT in {16, 32, 64}.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const T* __restrict__ bmat,
                    const T* __restrict__ cmat, T* __restrict__ y,
                    float* __restrict__ state_out, int S, int H, int P, int G, int N, int L,
                    int TT) {
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int g = h / (H / G);
  const float a_h = a[h];
  const int ldt = TT + 4;  // row stride of the transposed tiles

  float* st = smem;             // [N][P]   state, n-major
  float* cum = st + N * P;      // [L]      inclusive cumsum of dt*a
  float* dts = cum + L;         // [L]      dt
  float* ct = dts + L;          // [N][ldt] C tile, transposed (phase 1)
  float* bs = ct;               // [TT][N]  B tile (phase 2, aliases ct)
  float* bt = ct + N * ldt;     // [N][ldt] B tile, transposed
  float* xs = bt + N * ldt;     // [TT][P]  dt*x (phase 2: times persist)
  float* wt = xs + TT * P;      // [TT][TT] decay-masked scores, s-major
  float* ya = wt + TT * TT;     // [TT][P]  y accumulator
  float* seg = ya + TT * P;     // [kScanSegments] scan carries

  const size_t row_x = (size_t)H * P;  // stride of s in x and y
  const size_t row_bc = (size_t)G * N;  // stride of s in bmat and cmat
  const T* xh = x + (size_t)b * S * row_x + (size_t)h * P;
  T* yh = y + (size_t)b * S * row_x + (size_t)h * P;
  const T* bg = bmat + (size_t)b * S * row_bc + (size_t)g * N;
  const T* cg = cmat + (size_t)b * S * row_bc + (size_t)g * N;
  const float* dth = dt + (size_t)b * S * H + h;

  for (int i = threadIdx.x; i < N * P; i += blockDim.x) st[i] = 0.f;

  const int seglen = L / kScanSegments;
  for (int c0 = 0; c0 < S; c0 += L) {
    __syncthreads();  // the previous chunk is done with cum, dts and st
    for (int l = threadIdx.x; l < L; l += blockDim.x) {
      const float d = dth[(size_t)(c0 + l) * H];
      dts[l] = d;
      cum[l] = d * a_h;
    }
    __syncthreads();
    // inclusive cumsum: sequential within segments, then segment carries
    for (int sg = threadIdx.x; sg < kScanSegments; sg += blockDim.x) {
      float run = 0.f;
      for (int i = sg * seglen; i < (sg + 1) * seglen; ++i) {
        run += cum[i];
        cum[i] = run;
      }
      seg[sg] = run;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float run = 0.f;
      for (int sg = 0; sg < kScanSegments; ++sg) {
        const float tot = seg[sg];
        seg[sg] = run;
        run += tot;
      }
    }
    __syncthreads();
    for (int l = threadIdx.x; l < L; l += blockDim.x) cum[l] += seg[l / seglen];
    __syncthreads();
    const float cum_last = cum[L - 1];

    // ---- phase 1: y for one tile of TT rows l at a time
    for (int l0 = 0; l0 < L; l0 += TT) {
      for (int i = threadIdx.x; i < TT * N; i += blockDim.x) {
        const int l = i / N, n = i % N;
        ct[n * ldt + l] = to_f32(cg[(size_t)(c0 + l0 + l) * row_bc + n]);
      }
      __syncthreads();
      // inter-chunk: ya[l][p] = exp(cum_l) * sum_n C[l][n] st[n][p]
      mm_kmajor<false>(ct, ldt, st, P, ya, P, TT, P, N);
      __syncthreads();
      for (int i = threadIdx.x; i < TT * P; i += blockDim.x) ya[i] *= expf(cum[l0 + i / P]);
      // intra-chunk: tiles of TT columns s on or below the diagonal
      for (int s0 = 0; s0 <= l0; s0 += TT) {
        for (int i = threadIdx.x; i < TT * N; i += blockDim.x) {
          const int s = i / N, n = i % N;
          bt[n * ldt + s] = to_f32(bg[(size_t)(c0 + s0 + s) * row_bc + n]);
        }
        for (int i = threadIdx.x; i < TT * P; i += blockDim.x) {
          const int s = i / P, p = i % P;
          xs[i] = dts[s0 + s] * to_f32(xh[(size_t)(c0 + s0 + s) * row_x + p]);
        }
        __syncthreads();
        // wt[s][l] = sum_n B[s][n] C[l][n]
        mm_kmajor<false>(bt, ldt, ct, ldt, wt, TT, TT, TT, N);
        __syncthreads();
        for (int i = threadIdx.x; i < TT * TT; i += blockDim.x) {
          const int s = s0 + i / TT, l = l0 + i % TT;
          wt[i] = s <= l ? wt[i] * expf(cum[l] - cum[s]) : 0.f;  // mask before exp
        }
        __syncthreads();
        // ya[l][p] += sum_s wt[s][l] xs[s][p]
        mm_kmajor<true>(wt, TT, xs, P, ya, P, TT, P, TT);
        __syncthreads();
      }
      for (int i = threadIdx.x; i < TT * P; i += blockDim.x) {
        const int l = i / P, p = i % P;
        yh[(size_t)(c0 + l0 + l) * row_x + p] = from_f32<T>(ya[i]);
      }
    }

    // ---- phase 2: state = exp(cum_L) state + sum_s exp(cum_L - cum_s) dt_s B_s x_s^T
    const float chunk_decay = expf(cum_last);
    for (int i = threadIdx.x; i < N * P; i += blockDim.x) st[i] *= chunk_decay;
    for (int s0 = 0; s0 < L; s0 += TT) {
      for (int i = threadIdx.x; i < TT * N; i += blockDim.x) {
        const int s = i / N, n = i % N;
        bs[i] = to_f32(bg[(size_t)(c0 + s0 + s) * row_bc + n]);
      }
      for (int i = threadIdx.x; i < TT * P; i += blockDim.x) {
        const int s = i / P, p = i % P;
        xs[i] = expf(cum_last - cum[s0 + s]) * dts[s0 + s] *
                to_f32(xh[(size_t)(c0 + s0 + s) * row_x + p]);
      }
      __syncthreads();
      // st[n][p] += sum_s bs[s][n] xs[s][p]
      mm_kmajor<true>(bs, N, xs, P, st, P, N, P, TT);
      __syncthreads();
    }
  }

  float* so = state_out + (size_t)bh * P * N;
  for (int i = threadIdx.x; i < P * N; i += blockDim.x) {
    const int p = i / N, n = i % N;
    so[i] = st[n * P + p];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* bmat, const void* cmat,
           void* y, void* state, int batch, int seqlen, int heads, int headdim, int groups,
           int dstate, int chunk, cudaStream_t stream) {
  const int tt = chunk % 64 == 0 ? 64 : chunk % 32 == 0 ? 32 : 16;
  const size_t smem = smem_floats(headdim, dstate, chunk, tt) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T><<<batch * heads, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(bmat), static_cast<const T*>(cmat), static_cast<T*>(y),
      static_cast<float*>(state), seqlen, heads, headdim, groups, dstate, chunk, tt);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 on success.  Launches on `stream`, allocates
// nothing and does not synchronise.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a, const void* bmat,
                               const void* cmat, void* y, void* state, int batch, int seqlen,
                               int heads, int headdim, int groups, int dstate, int chunk,
                               int is_bf16, void* stream) {
  if (batch <= 0 || heads <= 0 || groups <= 0 || chunk <= 0 || chunk % 16 != 0 ||
      seqlen % chunk != 0 || headdim % 4 != 0 || dstate % 4 != 0 || heads % groups != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(x, dt, a, bmat, cmat, y, state, batch, seqlen, heads, headdim,
                                 groups, dstate, chunk, s);
  }
  return launch<float>(x, dt, a, bmat, cmat, y, state, batch, seqlen, heads, headdim, groups,
                       dstate, chunk, s);
}
