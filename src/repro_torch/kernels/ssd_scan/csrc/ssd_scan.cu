// Mamba2 SSD chunked scan for Hopper (sm_90a), plain C entry point.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py::ssd_scan_pallas (body
// _ssd_kernel), the Pallas TPU kernel whose grid is (B, H, chunks) with the
// chunk axis run in order and the (P, N) state carried in VMEM scratch.
//
// What bounds it on an H100: at the serving shape of mamba2-780m (B=4,
// S=1024, H=48, P=64, G=1, N=128, L=256, bf16) the function reads and writes
// ~60 MB and needs ~16 GFLOP (the causal half of the L x L form), so on bf16
// tensor cores it is bound by memory (~18 us).  This design takes ~0.18 ms
// there, ~0.11 of it in chunk_out, which is held by each block's chain of
// loads, barriers and products (removing the CB reads, 126 MB, saves 17%),
// not by bytes; scripts/ssd_variants.py times each stage and edited copies.
//
// bf16: the standard SSD chunk decomposition, four launches on the stream,
// every product on tensor cores (mma.sync m16n8k16, bf16 operands brought to
// shared memory by cp.async or by the threads that compute them, loaded with
// ldmatrix, f32 accumulators), chunks spread across the card:
//   1. cb: C B^T per (batch, chunk, group) for the 64 x 64 tiles on or below
//      the diagonal -- once per group, not once per head (mamba2-780m has one
//      group for its 48 heads).  The operands are the bf16 inputs, so the
//      products are exact in f32.
//   2. chunk_state: per (batch, chunk, head), cum = cumsum(dt a) and the
//      chunk's own state sum_s exp(cum_L - cum_s) dt_s x_s B_s^T.
//   3. state_pass: per (batch, head), the state entering each chunk, in f32,
//      in order over the chunks, written over the chunk's own state.
//   4. chunk_out: per (batch, chunk, head, 64-row tile), y = [CB o decay o dt]
//      x + exp(cum_l) C S_in^T, the decay masked to s <= l before the exp.
// Each operand that is a computed f32 value (the weighted dt x of stage 2,
// the decay-weighted scores and S_in of stage 4) enters its product as bf16
// hi + lo, two products into one f32 accumulator: rounded once, the chunk
// states miss the f32 state bar and the scores and S_in take most of the y
// bar (tests/test_torch_ssd_scan.py mirrors this schedule on the CPU).  The
// stages meet in device memory through the caller's workspace (CB, the
// per-chunk states, cum: ~30 MB at the serving shape, mostly served by L2).
//
// f32: the CUDA-core kernel (ssd_scan_kernel): one thread block per (batch,
// head); the chunk loop runs inside the block in place of the TPU's
// sequential chunk axis, and the f32 state lives in shared memory for the
// whole sequence.  Per chunk the (L, L) decay-weighted scores are tiled over
// TT x TT blocks of rows l and columns s, skipping blocks above the diagonal;
// each product is a shared-memory matrix product in which a thread owns 4x4
// outputs and reads operands as float4.  The causal mask is applied before
// the exp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanSegments = 16;  // L is a multiple of 16

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
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const float* __restrict__ bmat,
                    const float* __restrict__ cmat, float* __restrict__ y,
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
  const float* xh = x + (size_t)b * S * row_x + (size_t)h * P;
  float* yh = y + (size_t)b * S * row_x + (size_t)h * P;
  const float* bg = bmat + (size_t)b * S * row_bc + (size_t)g * N;
  const float* cg = cmat + (size_t)b * S * row_bc + (size_t)g * N;
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
        ct[n * ldt + l] = cg[(size_t)(c0 + l0 + l) * row_bc + n];
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
          bt[n * ldt + s] = bg[(size_t)(c0 + s0 + s) * row_bc + n];
        }
        for (int i = threadIdx.x; i < TT * P; i += blockDim.x) {
          const int s = i / P, p = i % P;
          xs[i] = dts[s0 + s] * xh[(size_t)(c0 + s0 + s) * row_x + p];
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
        yh[(size_t)(c0 + l0 + l) * row_x + p] = ya[i];
      }
    }

    // ---- phase 2: state = exp(cum_L) state + sum_s exp(cum_L - cum_s) dt_s B_s x_s^T
    const float chunk_decay = expf(cum_last);
    for (int i = threadIdx.x; i < N * P; i += blockDim.x) st[i] *= chunk_decay;
    for (int s0 = 0; s0 < L; s0 += TT) {
      for (int i = threadIdx.x; i < TT * N; i += blockDim.x) {
        const int s = i / N, n = i % N;
        bs[i] = bg[(size_t)(c0 + s0 + s) * row_bc + n];
      }
      for (int i = threadIdx.x; i < TT * P; i += blockDim.x) {
        const int s = i / P, p = i % P;
        xs[i] = expf(cum_last - cum[s0 + s]) * dts[s0 + s] *
                xh[(size_t)(c0 + s0 + s) * row_x + p];
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

int launch_f32(const void* x, const void* dt, const void* a, const void* bmat, const void* cmat,
               void* y, void* state, int batch, int seqlen, int heads, int headdim, int groups,
               int dstate, int chunk, cudaStream_t stream) {
  const int tt = chunk % 64 == 0 ? 64 : chunk % 32 == 0 ? 32 : 16;
  const size_t smem = smem_floats(headdim, dstate, chunk, tt) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // reported here; not left for the next launch
    return (int)err;
  }
  ssd_scan_kernel<<<batch * heads, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const float*>(bmat), static_cast<const float*>(cmat), static_cast<float*>(y),
      static_cast<float*>(state), seqlen, heads, headdim, groups, dstate, chunk, tt);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ bf16
using bf16 = __nv_bfloat16;
constexpr int kT = 64;                // tile edge: rows, columns and K step of every stage
constexpr int kLd = kT + 8;           // padded row strides (bf16) of 64- and 128-wide tiles:
constexpr int kLdWide = 2 * kT + 8;   // ldmatrix then reads 8 rows from 8 distinct bank groups
constexpr int kScanWarps = 32;        // chunk_cumsum's per-warp totals

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a b for one 16 x 8 x 16 tile: bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_16x8x16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async_16(bf16* dst, const bf16* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most kPending committed groups of this thread's copies are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Commits this thread's copies and waits for all of them.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// s[r * lds + c] = g[r * gstride + c] for r < rows and c < cols, 0 elsewhere in
// the kRows x kCols tile.  vec: 16-byte cp.async copies (cols % 8 == 0, g and
// gstride 16-byte aligned); the caller commits and waits for them.
template <int kRows, int kCols>
__device__ __forceinline__ void load_tile(bf16* s, int lds, const bf16* g, size_t gstride,
                                          int rows, int cols, bool vec) {
  if (vec) {
    constexpr int kChunks = kCols / 8;
    for (int i = threadIdx.x; i < kRows * kChunks; i += blockDim.x) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      bf16* d = s + r * lds + c;
      if (r < rows && c < cols) {
        cp_async_16(d, g + r * gstride + c);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kCols; i += blockDim.x) {
      const int r = i / kCols, c = i % kCols;
      s[r * lds + c] = (r < rows && c < cols) ? g[r * gstride + c] : __float2bfloat16(0.f);
    }
  }
}

// f32 a and b as packed bf16 hi parts and packed bf16 remainders a - hi,
// b - hi (each rounded to nearest): two registers of an MMA operand.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - f.x, b - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Four f32 values split as split2 does, into shared memory at hi and lo
// (8-byte aligned).
__device__ __forceinline__ void store_split4(bf16* hi, bf16* lo, const float (&v)[4]) {
  uint2 h, l;
  split2(v[0], v[1], h.x, l.x);
  split2(v[2], v[3], h.y, l.y);
  *reinterpret_cast<uint2*>(hi) = h;
  *reinterpret_cast<uint2*>(lo) = l;
}

// One warp's 32 x 32 block at (m0, n0): acc[i][j] (its 16 x 8 tile (i, j)) +=
// A B over k < K (K % 16 == 0), both bf16 in shared memory.  A is stored
// [m][k] (kATrans: [k][m]), B is stored [n][k] (kBTrans: [k][n]).  Element e
// of acc[i][j] is row m0 + 16 i + lane / 4 + 8 (e / 2), column
// n0 + 8 j + 2 (lane % 4) + e % 2.
template <bool kATrans, bool kBTrans>
__device__ __forceinline__ void warp_mma(float (&acc)[2][4][4], const bf16* A, int lda,
                                         const bf16* B, int ldb, int m0, int n0, int K) {
  const int lane = threadIdx.x & 31;
  const int r8 = lane & 7, b3 = (lane >> 3) & 1, b4 = lane >> 4;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + 16 * i;
      if (kATrans) {
        ldsm_x4_trans(a[i], A + (k0 + r8 + 8 * b4) * lda + m + 8 * b3);
      } else {
        ldsm_x4(a[i], A + (m + (lane & 15)) * lda + k0 + 8 * b4);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + 16 * j;
      uint32_t r[4];
      if (kBTrans) {
        ldsm_x4_trans(r, B + (k0 + r8 + 8 * b3) * ldb + n + 8 * b4);
      } else {
        ldsm_x4(r, B + (n + r8 + 8 * b4) * ldb + k0 + 8 * b3);
      }
      b[2 * j][0] = r[0];
      b[2 * j][1] = r[1];
      b[2 * j + 1][0] = r[2];
      b[2 * j + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_16x8x16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
}

// out[r * ld + c] = acc for the warp's elements with r < rows, c < cols
// (cols even; out 8-byte aligned at even c).
__device__ __forceinline__ void store_acc(const float (&acc)[2][4][4], float* out, int ld, int m0,
                                          int n0, int rows, int cols) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = m0 + 16 * i + (lane >> 2) + 8 * hh, c = n0 + 8 * j + 2 * (lane & 3);
        if (r < rows && c < cols) {
          *reinterpret_cast<float2*>(out + (size_t)r * ld + c) =
              make_float2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
        }
      }
    }
  }
}

// cum[l] = sum_{i <= l} dt[i * stride] * a_h for l < L, block-wide; ends
// synchronised.  Each thread sums a run of consecutive l, then the runs are
// scanned across warps.
__device__ void chunk_cumsum(float* cum, const float* dt, size_t stride, float a_h, int L) {
  __shared__ float warp_total[kScanWarps];
  const int per = (L + blockDim.x - 1) / blockDim.x;
  const int lo = min(L, (int)threadIdx.x * per), hi = min(L, lo + per);
  float total = 0.f;
  for (int i = lo; i < hi; ++i) {
    cum[i] = dt[(size_t)i * stride] * a_h;
    total += cum[i];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float inclusive = total;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, inclusive, o);
    if (lane >= o) inclusive += v;
  }
  if (lane == 31) warp_total[warp] = inclusive;
  __syncthreads();
  float run = inclusive - total;
  for (int w = 0; w < warp; ++w) run += warp_total[w];
  for (int i = lo; i < hi; ++i) {
    run += cum[i];
    cum[i] = run;
  }
  __syncthreads();
}

// Stage 1, cb: cb[b][c][g][l][s] = sum_n C[l][n] B[s][n] over one 64 x 64 tile
// (row tile lt, column tile st <= lt) of the chunk.  Grid (tiles on or below
// the diagonal, G, B * chunks), 128 threads as 2 x 2 warps of 32 x 32.
__global__ void __launch_bounds__(128)
    ssd_cb_kernel(const bf16* __restrict__ bmat, const bf16* __restrict__ cmat,
                  float* __restrict__ cb, int S, int G, int N, int L, bool vec_bc) {
  __shared__ __align__(16) bf16 cs[kT * kLd];
  __shared__ __align__(16) bf16 bs[kT * kLd];
  int lt = 0, st = blockIdx.x;
  while (st > lt) st -= ++lt;
  const int nc = S / L, g = blockIdx.y, c = blockIdx.z % nc, b = blockIdx.z / nc;
  const int l0 = lt * kT, s0 = st * kT, rows_l = min(kT, L - l0), rows_s = min(kT, L - s0);
  const size_t row = (size_t)G * N, t0 = (size_t)b * S + (size_t)c * L;
  const bf16* cg = cmat + (t0 + l0) * row + (size_t)g * N;
  const bf16* bg = bmat + (t0 + s0) * row + (size_t)g * N;
  const int warp = threadIdx.x >> 5, m0 = (warp >> 1) * 32, n0 = (warp & 1) * 32;
  float acc[2][4][4] = {};
  for (int k0 = 0; k0 < N; k0 += kT) {
    const int kc = min(kT, N - k0);
    __syncthreads();  // the previous step's products are done with cs and bs
    load_tile<kT, kT>(cs, kLd, cg + k0, row, rows_l, kc, vec_bc);
    load_tile<kT, kT>(bs, kLd, bg + k0, row, rows_s, kc, vec_bc);
    cp_async_wait_all();
    __syncthreads();
    warp_mma<false, false>(acc, cs, kLd, bs, kLd, m0, n0, (kc + 15) & ~15);
  }
  float* out = cb + ((((size_t)b * nc + c) * G + g) * L + l0) * L + s0;
  store_acc(acc, out, L, m0, n0, rows_l, rows_s);
}

// Stage 2, chunk_state: per (b, chunk c, head h) the chunk's own state
// states[b][c][h][p][n] = sum_s w_s x[s][p] B[s][n], w_s = exp(cum_L - cum_s)
// dt_s, over one 64 x 128 tile of (p, n); w x enters the product as bf16
// hi + lo.  The blocks of tile 0 also write the chunk's cum for stages 3 and
// 4.  Grid (p tiles * n tiles, H, B * chunks), 256 threads as 2 x 4 warps;
// 2 L floats of dynamic shared memory.  The next x tile is loaded into
// registers while the tensor cores work on the current one.
constexpr int kStateThreads = 256;
constexpr int kStateQuads = kT * kT / 4 / kStateThreads;  // x quads per thread and tile

// three blocks an SM: 80 registers, 8 bytes spilled, 0.009 ms faster than two at
// the serving shape (scripts/ssd_variants.py, H100)
__global__ void __launch_bounds__(kStateThreads, 3)
    ssd_chunk_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                           const float* __restrict__ a, const bf16* __restrict__ bmat,
                           float* __restrict__ states, float* __restrict__ cum_out, int S, int H,
                           int P, int G, int N, int L, bool vec_x, bool vec_bc) {
  __shared__ __align__(16) bf16 xh[kT * kLd];      // w x, [s][p]: hi
  __shared__ __align__(16) bf16 xl[kT * kLd];      //              lo
  __shared__ __align__(16) bf16 bs[kT * kLdWide];  // B, [s][n]
  extern __shared__ float dyn[];
  float* cum = dyn;    // [L]
  float* w = dyn + L;  // [L]
  const int n_tiles = (N + 2 * kT - 1) / (2 * kT);
  const int p0 = (blockIdx.x / n_tiles) * kT, n0 = (blockIdx.x % n_tiles) * 2 * kT;
  const int h = blockIdx.y, nc = S / L, c = blockIdx.z % nc, b = blockIdx.z / nc;
  const int g = h / (H / G);
  const size_t t0 = (size_t)b * S + (size_t)c * L;
  const float* dth = dt + t0 * H + h;
  const int rows_p = min(kT, P - p0), cols_n = min(2 * kT, N - n0);
  const size_t row_x = (size_t)H * P, row_bc = (size_t)G * N;
  const bf16* xg = x + t0 * row_x + (size_t)h * P + p0;
  const bf16* bg = bmat + t0 * row_bc + (size_t)g * N + n0;

  float4 xq[kStateQuads];  // x[s][p .. p + 3] of this thread's quads, unscaled
  auto fetch = [&](int s0) {
    const int ks = min(kT, L - s0);
#pragma unroll
    for (int q = 0; q < kStateQuads; ++q) {
      const int i = threadIdx.x + q * kStateThreads, s = i / (kT / 4), p = (i % (kT / 4)) * 4;
      xq[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s < ks && p < rows_p) {  // P % 4 == 0: all four valid
        const bf16* src = xg + (size_t)(s0 + s) * row_x + p;
        if (vec_x) {
          const uint2 raw = *reinterpret_cast<const uint2*>(src);
          const float2 f01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
          const float2 f23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
          xq[q] = make_float4(f01.x, f01.y, f23.x, f23.y);
        } else {
          xq[q] = make_float4(__bfloat162float(src[0]), __bfloat162float(src[1]),
                              __bfloat162float(src[2]), __bfloat162float(src[3]));
        }
      }
    }
  };
  fetch(0);
  chunk_cumsum(cum, dth, H, a[h], L);
  const float last = cum[L - 1];
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    w[l] = expf(last - cum[l]) * dth[(size_t)l * H];
    if (blockIdx.x == 0) cum_out[(((size_t)b * H + h) * nc + c) * L + l] = cum[l];
  }
  const int warp = threadIdx.x >> 5, m0 = (warp >> 2) * 32, nw0 = (warp & 3) * 32;
  float acc[2][4][4] = {};
  for (int s0 = 0; s0 < L; s0 += kT) {
    const int ks = min(kT, L - s0);
    __syncthreads();  // w is written; the previous step's products are done
    load_tile<kT, 2 * kT>(bs, kLdWide, bg + (size_t)s0 * row_bc, row_bc, ks, cols_n, vec_bc);
#pragma unroll
    for (int q = 0; q < kStateQuads; ++q) {
      const int i = threadIdx.x + q * kStateThreads, s = i / (kT / 4), p = (i % (kT / 4)) * 4;
      const float ws = s < ks ? w[s0 + s] : 0.f;
      const float v[4] = {ws * xq[q].x, ws * xq[q].y, ws * xq[q].z, ws * xq[q].w};
      store_split4(xh + s * kLd + p, xl + s * kLd + p, v);
    }
    if (s0 + kT < L) fetch(s0 + kT);
    cp_async_wait_all();
    __syncthreads();
    warp_mma<true, true>(acc, xh, kLd, bs, kLdWide, m0, nw0, ks);
    warp_mma<true, true>(acc, xl, kLd, bs, kLdWide, m0, nw0, ks);
  }
  float* out = states + ((((size_t)b * nc + c) * H + h) * P + p0) * N + n0;
  store_acc(acc, out, N, m0, nw0, rows_p, cols_n);
}

// Stage 3, state_pass: per (b, h) and four elements of (p, n), the state
// entering chunk c, S_in[c] = exp(cum_L[c-1]) S_in[c-1] + state[c-1] with
// S_in[0] = 0, in order over the chunks, written over state[c]; the state
// after the last chunk goes to state_out.  Grid (P N / 1024 rounded up, H, B),
// 256 threads; the states of kPassAhead chunks are loaded at once.
constexpr int kPassAhead = 4;

__global__ void __launch_bounds__(256)
    ssd_state_pass_kernel(float* __restrict__ states, const float* __restrict__ cum,
                          float* __restrict__ state_out, int nc, int H, int PN, int L) {
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (e >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* cum_last = cum + ((size_t)b * H + h) * nc * L + (L - 1);
  const size_t chunk_stride = (size_t)H * PN;
  float* st = states + ((size_t)b * nc * H + h) * PN + e;  // chunk 0
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kPassAhead) {
    float4 own[kPassAhead];
    float d[kPassAhead];
#pragma unroll
    for (int k = 0; k < kPassAhead; ++k) {
      if (c0 + k < nc) {
        own[k] = *reinterpret_cast<const float4*>(st + (c0 + k) * chunk_stride);
        d[k] = expf(cum_last[(size_t)(c0 + k) * L]);
      }
    }
#pragma unroll
    for (int k = 0; k < kPassAhead; ++k) {
      if (c0 + k < nc) {
        *reinterpret_cast<float4*>(st + (c0 + k) * chunk_stride) = run;
        run = make_float4(run.x * d[k] + own[k].x, run.y * d[k] + own[k].y,
                          run.z * d[k] + own[k].z, run.w * d[k] + own[k].w);
      }
    }
  }
  *reinterpret_cast<float4*>(state_out + ((size_t)b * H + h) * PN + e) = run;
}

// Stage 4, chunk_out: per (b, chunk c, head h), one 64 x 64 tile of (l, p):
// y[l][p] = exp(cum_l) sum_n C[l][n] S_in[p][n] + sum_{s <= l} W[l][s] x[s][p],
// W[l][s] = CB[l][s] exp(cum_l - cum_s) dt_s, masked to s <= l before the
// exp.  Below the diagonal tile (s < l0 <= l, l0 the tile's first row) the
// decay is exp(cum_l - cum_l0) exp(cum_l0 - cum_s), two factors of at most 1
// computed once per row and per column instead of once per element.  Grid
// (row tiles * p tiles, H, B * chunks): the row tiles of one (b, c, h),
// which share S_in and x, run side by side, those that span the most
// columns first.  128 threads; warp w owns rows l0 + 16 w .. + 15 and all
// 64 columns.  Each thread builds its own A fragments of W, from CB in
// registers, as bf16 hi + lo: W takes no shared memory and no barrier.  The
// shared operands -- the C tiles, S_in as hi + lo and the x tiles -- pass
// through shared memory, the x tiles double-buffered by cp.async so the
// next one loads while the warps work.  3 L + 64 floats of dynamic shared
// memory.
constexpr int kOutThreads = 128;
constexpr int kOutQuads = kT * kT / 4 / kOutThreads;  // S_in quads per thread and tile

__global__ void __launch_bounds__(kOutThreads)
    ssd_chunk_out_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                         const bf16* __restrict__ cmat, const float* __restrict__ cb,
                         const float* __restrict__ states, const float* __restrict__ cum_in,
                         bf16* __restrict__ y, int S, int H, int P, int G, int N, int L,
                         bool vec_x, bool vec_bc) {
  __shared__ __align__(16) bf16 xs[2][kT * kLd];  // x [s][p], two steps
  __shared__ __align__(16) bf16 sh[kT * kLd];     // S_in [p][n]: hi
  __shared__ __align__(16) bf16 sl[kT * kLd];     //              lo
  extern __shared__ float dyn[];
  float* cum = dyn;              // [L]
  float* dts = dyn + L;          // [L]
  float* decay_s = dyn + 2 * L;  // [L]  exp(cum_l0 - cum_s) dt_s for s < l0
  float* decay_l = dyn + 3 * L;  // [kT] exp(cum_l - cum_l0) for the tile's rows
  const int nc = S / L, row_tiles = (L + kT - 1) / kT;
  const int lt = row_tiles - 1 - (int)blockIdx.x % row_tiles;
  const int c = blockIdx.z % nc, b = blockIdx.z / nc;
  const int h = blockIdx.y, g = h / (H / G), p0 = (blockIdx.x / row_tiles) * kT, l0 = lt * kT;
  const int rows_l = min(kT, L - l0), cols_p = min(kT, P - p0);
  const size_t t0 = (size_t)b * S + (size_t)c * L;
  const size_t row_x = (size_t)H * P, row_bc = (size_t)G * N;
  const bf16* cg = cmat + (t0 + l0) * row_bc + (size_t)g * N;
  const float* sg = states + ((((size_t)b * nc + c) * H + h) * P + p0) * N;
  const bf16* xg = x + t0 * row_x + (size_t)h * P + p0;
  const float* cbg = cb + ((((size_t)b * nc + c) * G + g) * L + l0) * (size_t)L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3, r8 = lane & 7, b3 = (lane >> 3) & 1, b4 = lane >> 4;
  const int ra = 16 * warp + gid, rb = ra + 8;  // this thread's rows of the tile
  const bool va = ra < rows_l, vb = rb < rows_l;

  auto load_x = [&](int s0, int buf) {
    load_tile<kT, kT>(xs[buf], kLd, xg + (size_t)s0 * row_x, row_x, min(kT, L - s0), cols_p, vec_x);
    cp_async_commit();
  };
  load_x(0, 0);
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    cum[l] = cum_in[(((size_t)b * H + h) * nc + c) * L + l];
    dts[l] = dt[(t0 + l) * H + h];
  }
  __syncthreads();
  for (int s = threadIdx.x; s < l0; s += blockDim.x) decay_s[s] = expf(cum[l0] - cum[s]) * dts[s];
  for (int l = threadIdx.x; l < kT; l += blockDim.x) {
    decay_l[l] = l < rows_l ? expf(cum[l0 + l] - cum[l0]) : 0.f;
  }
  float acc[8][4] = {};

  // inter-chunk: exp(cum_l) C S_in^T; the first chunk enters with S_in = 0.
  // The C tile goes to xs[1], which the x tiles first use after it.
  if (c > 0) {
    for (int k0 = 0; k0 < N; k0 += kT) {
      const int kc = min(kT, N - k0);
      __syncthreads();  // the previous slice's products are done with xs[1], sh and sl
      load_tile<kT, kT>(xs[1], kLd, cg + k0, row_bc, rows_l, kc, vec_bc);
      cp_async_commit();
#pragma unroll
      for (int q = 0; q < kOutQuads; ++q) {
        const int i = threadIdx.x + q * kOutThreads, p = i / (kT / 4), n = (i % (kT / 4)) * 4;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (p < cols_p && n < kc) {  // N % 4 == 0: all four valid
          const float4 f = *reinterpret_cast<const float4*>(sg + (size_t)p * N + k0 + n);
          v[0] = f.x;
          v[1] = f.y;
          v[2] = f.z;
          v[3] = f.w;
        }
        store_split4(sh + p * kLd + n, sl + p * kLd + n, v);
      }
      cp_async_wait<0>();
      __syncthreads();
      for (int kk = 0; kk < kc; kk += 16) {
        uint32_t a[4];
        ldsm_x4(a, xs[1] + (16 * warp + (lane & 15)) * kLd + kk + 8 * b4);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t rh[4], rl[4];
          const int off = (16 * jp + r8 + 8 * b4) * kLd + kk + 8 * b3;
          ldsm_x4(rh, sh + off);
          ldsm_x4(rl, sl + off);
          mma_16x8x16(acc[2 * jp], a, rh[0], rh[1]);
          mma_16x8x16(acc[2 * jp], a, rl[0], rl[1]);
          mma_16x8x16(acc[2 * jp + 1], a, rh[2], rh[3]);
          mma_16x8x16(acc[2 * jp + 1], a, rl[2], rl[3]);
        }
      }
    }
    const float da = va ? expf(cum[l0 + ra]) : 0.f, db = vb ? expf(cum[l0 + rb]) : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] *= da;
      acc[j][1] *= da;
      acc[j][2] *= db;
      acc[j][3] *= db;
    }
  }

  // intra-chunk: the column tiles s0 <= l0, x double-buffered
  for (int t = 0; t <= lt; ++t) {
    const int s0 = t * kT, ks = min(kT, L - s0);
    __syncthreads();  // every warp is done with the buffer the next load overwrites
    if (t < lt) {
      load_x(s0 + kT, (t + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // x of this step has landed for every thread
    const bf16* xb = xs[t & 1];
    const float* cba = cbg + (size_t)ra * L + s0;
    const float* cbb = cbg + (size_t)rb * L + s0;
    const float dla = decay_l[ra], dlb = decay_l[rb];  // 0 past the tile's rows
    const float cla = va ? cum[l0 + ra] : 0.f, clb = vb ? cum[l0 + rb] : 0.f;
    for (int kk = 0; kk < ks; kk += 16) {
      float w[8];  // W at (ra, kk + 2 tig + {0, 1}), (rb, ..), (ra, +8 ..), (rb, +8 ..)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int s = kk + 2 * tig + 8 * half;
        const float2 fa = va ? *reinterpret_cast<const float2*>(cba + s) : make_float2(0.f, 0.f);
        const float2 fb = vb ? *reinterpret_cast<const float2*>(cbb + s) : make_float2(0.f, 0.f);
        const float cv[4] = {fa.x, fa.y, fb.x, fb.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? ra : rb, col = s0 + s + (e & 1);
          float v;
          if (s0 < l0) {  // below the diagonal tile: every s < every l
            v = cv[e] * (e < 2 ? dla : dlb) * decay_s[col];
          } else {  // masked before the exp; 0 past the tile's rows
            v = col <= l0 + row && row < rows_l
                    ? cv[e] * expf((e < 2 ? cla : clb) - cum[col]) * dts[col]
                    : 0.f;
          }
          w[4 * half + e] = v;
        }
      }
      uint32_t ahi[4], alo[4];
      split2(w[0], w[1], ahi[0], alo[0]);
      split2(w[2], w[3], ahi[1], alo[1]);
      split2(w[4], w[5], ahi[2], alo[2]);
      split2(w[6], w[7], ahi[3], alo[3]);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t r[4];
        ldsm_x4_trans(r, xb + (kk + r8 + 8 * b3) * kLd + 16 * jp + 8 * b4);
        mma_16x8x16(acc[2 * jp], ahi, r[0], r[1]);
        mma_16x8x16(acc[2 * jp], alo, r[0], r[1]);
        mma_16x8x16(acc[2 * jp + 1], ahi, r[2], r[3]);
        mma_16x8x16(acc[2 * jp + 1], alo, r[2], r[3]);
      }
    }
  }

  bf16* yg = y + (t0 + l0) * row_x + (size_t)h * P + p0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * tig;
    if (col < cols_p && va) {
      *reinterpret_cast<__nv_bfloat162*>(yg + (size_t)ra * row_x + col) =
          __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    }
    if (col < cols_p && vb) {
      *reinterpret_cast<__nv_bfloat162*>(yg + (size_t)rb * row_x + col) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
    }
  }
}

// Lets `kernel` take `dynamic` bytes of dynamic shared memory beside its
// `fixed` static bytes where they pass the default 48 KB.
template <typename K>
cudaError_t allow_smem(K kernel, size_t fixed, size_t dynamic) {
  if (fixed + dynamic <= 48 * 1024) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dynamic);
  if (err != cudaSuccess) cudaGetLastError();  // reported here; not left for the next launch
  return err;
}

int launch_bf16(const bf16* x, const float* dt, const float* a, const bf16* bmat,
                const bf16* cmat, bf16* y, float* state, float* cb, float* states, float* cum,
                int batch, int seqlen, int heads, int headdim, int groups, int dstate, int chunk,
                cudaStream_t stream) {
  const int nc = seqlen / chunk, row_tiles = (chunk + kT - 1) / kT;
  const int p_tiles = (headdim + kT - 1) / kT, n_tiles = (dstate + 2 * kT - 1) / (2 * kT);
  if (heads > 65535 || groups > 65535 || (long long)batch * nc > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec_x = headdim % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_bc = dstate % 8 == 0 && reinterpret_cast<uintptr_t>(bmat) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(cmat) % 16 == 0;
  const size_t dyn_state = 2 * (size_t)chunk * sizeof(float);
  const size_t dyn_out = (3 * (size_t)chunk + kT) * sizeof(float);
  cudaError_t err = allow_smem(ssd_chunk_state_kernel,
                               (2 * kLd + kLdWide) * kT * sizeof(bf16) + kScanWarps * sizeof(float),
                               dyn_state);
  if (err == cudaSuccess) err = allow_smem(ssd_chunk_out_kernel, 4 * kLd * kT * sizeof(bf16), dyn_out);
  if (err != cudaSuccess) return (int)err;
  ssd_cb_kernel<<<dim3(row_tiles * (row_tiles + 1) / 2, groups, batch * nc), 128, 0, stream>>>(
      bmat, cmat, cb, seqlen, groups, dstate, chunk, vec_bc);
  ssd_chunk_state_kernel<<<dim3(p_tiles * n_tiles, heads, batch * nc), kStateThreads, dyn_state,
                           stream>>>(
      x, dt, a, bmat, states, cum, seqlen, heads, headdim, groups, dstate, chunk, vec_x, vec_bc);
  const int pn = headdim * dstate;
  ssd_state_pass_kernel<<<dim3((pn / 4 + 255) / 256, heads, batch), 256, 0, stream>>>(
      states, cum, state, nc, heads, pn, chunk);
  ssd_chunk_out_kernel<<<dim3(row_tiles * p_tiles, heads, batch * nc), kOutThreads, dyn_out,
                         stream>>>(
      x, dt, cmat, cb, states, cum, y, seqlen, heads, headdim, groups, dstate, chunk,
      vec_x, vec_bc);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 on success.  Launches on `stream`, allocates
// nothing and does not synchronise.  bf16 needs the workspace: cb
// (B, S/chunk, G, chunk, chunk), states (B, S/chunk, H, P, N) and cum
// (B, H, S), all f32; f32 takes none (null pointers).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a, const void* bmat,
                               const void* cmat, void* y, void* state, void* cb, void* states,
                               void* cum, int batch, int seqlen, int heads, int headdim,
                               int groups, int dstate, int chunk, int is_bf16, void* stream) {
  if (batch <= 0 || heads <= 0 || groups <= 0 || chunk <= 0 || chunk % 16 != 0 ||
      seqlen % chunk != 0 || headdim % 4 != 0 || dstate % 4 != 0 || heads % groups != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (cb == nullptr || states == nullptr || cum == nullptr) return (int)cudaErrorInvalidValue;
    return launch_bf16(static_cast<const bf16*>(x), static_cast<const float*>(dt),
                       static_cast<const float*>(a), static_cast<const bf16*>(bmat),
                       static_cast<const bf16*>(cmat), static_cast<bf16*>(y),
                       static_cast<float*>(state), static_cast<float*>(cb),
                       static_cast<float*>(states), static_cast<float*>(cum), batch, seqlen,
                       heads, headdim, groups, dstate, chunk, s);
  }
  return launch_f32(x, dt, a, bmat, cmat, y, state, batch, seqlen, heads, headdim, groups,
                    dstate, chunk, s);
}
