// Causal GQA flash attention for Hopper (sm_90a), plain C entry point.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (body _fa_kernel), the Pallas TPU kernel whose grid is (B, H, q blocks, kv
// blocks) with the kv axis run in order and the running max, sum and
// accumulator carried in VMEM scratch across it.  That kernel casts q, k and v
// to f32 and keeps the probabilities P in f32 for the product with v.
//
// What bounds it on an H100: at the forward shape of qwen2.5-3b (B=4, S=1024,
// H=16, K=2, D=128, bf16) the function moves ~38 MB and needs 17.2 GFLOP over
// the causal half, so on bf16 tensor cores it is bound by operations (~17 us).
// Carrying P as two bf16 terms (below) makes the product with v twice as long:
// 25.8 GFLOP in all.
//
// bf16 inputs (flash_attention_wgmma): one CTA of three warpgroups per (head,
// batch, 128-row q tile), the longest q tiles first.  Warpgroup 0 is the
// producer: one thread loads the q tile once and the 64-key K/V tiles, from the
// window's first tile to the diagonal, by TMA into a ring of kStages stages
// (mbarriers: full when a tile has landed, empty when both consumers are done
// with it), 128-byte swizzled, D as two 64-column boxes; it gives up registers
// (setmaxnreg).  Warpgroups 1 and 2 each own 64 q rows:
//   S = Q K^T      wgmma m64n64k16, both operands from shared memory, f32
//                  accumulate (bf16 products are exact in f32, so this is the
//                  TPU kernel's f32 dot up to the order of the sum);
//   online softmax in f32 on the accumulator's registers: the causal/window
//                  mask only on tiles that cross the diagonal or the window's
//                  edge, masked logits -1e30, the row max of the raw logits
//                  across the four lanes of a row, then p = 2^(s * c - m * c)
//                  with c = scale * log2(e), one FMA and one ex2 per element
//                  (a row with no key yet in its window takes shift 0, so its
//                  masked p are 0 and not the FMA's rounding error of -m * c);
//   O += P V       P split into P_hi = bf16(P) and P_lo = bf16(P - P_hi), each
//                  an RS wgmma (A from registers, the S accumulator's layout;
//                  V from shared memory with the transpose bit), so P keeps
//                  ~16 bits and each output lies within bf16's rounding of the
//                  f32 result.  This is 1.5x the tensor-core work of rounding P
//                  once, the price of the TPU kernel's f32-probability semantics.
// TMA zero-fills a ragged tail of S and the columns past D; the causal mask
// covers keys >= S; only rows < S and columns < D are written, after dividing
// by max(l, 1e-30) as the TPU kernel does.
//
// f32 inputs (flash_attention_kernel): f32 on CUDA cores, since TF32 tensor
// cores (2^-11 per product) cannot hold the f32 bar of 2e-5.  One block of 256
// threads per (head, batch, 64-row q tile); the kv loop runs inside the block,
// from the window's first tile to the diagonal tile.  Four threads own one q
// row: each keeps a quarter of the row's head dim (float4 chunks c = sub + 4i)
// of q and of the f32 accumulator in registers, the partial q.k dots are
// summed across the four lanes with shuffles, and each lane keeps the row's
// running max and sum.  The k and v tiles (32 keys) are staged in shared
// memory once per tile for the whole block; a ragged tail is zero-filled, and
// only rows < S are written.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;

// ------------------------------------------------------------ f32, CUDA cores
constexpr int kBQ = 64;                // q rows per block
constexpr int kBK = 32;                // keys per kv tile
constexpr int kTPR = 4;                // threads per q row
constexpr int kThreads = kBQ * kTPR;   // 256

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// NC: float4 chunks of the head dim per thread, ceil(D / 16).
template <int NC>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int seqlen, int heads,
                       int kv_heads, int headdim, int window, float scale) {
  __shared__ __align__(16) float ks[kBK * kMaxD];
  __shared__ __align__(16) float vs[kBK * kMaxD];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // the longest rows are scheduled first
  const int kvh = h / (heads / kv_heads);
  const int c4 = headdim / 4;
  const int row = threadIdx.x / kTPR;
  const int sub = threadIdx.x % kTPR;
  const int q0 = qt * kBQ;
  const int qpos = q0 + row;
  const bool live = qpos < seqlen;  // rows past the end compute but are not written
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  const size_t qoff = (((size_t)b * seqlen + (live ? qpos : 0)) * heads + h) * headdim;
  float4 qr[NC], acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = sub + kTPR * i;
    qr[i] = (live && c < c4) ? load4(q + qoff + 4 * c) : zero;
    acc[i] = zero;
  }
  float m = kNegInf, l = 0.f;

  const size_t kv_row = (size_t)kv_heads * headdim;  // elements between positions
  const size_t kv_off = ((size_t)b * seqlen * kv_heads + kvh) * headdim;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  const int kt_hi = (min(q0 + kBQ, seqlen) - 1) / kBK;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBK;
    for (int idx = threadIdx.x; idx < kBK * c4; idx += kThreads) {
      const int j = idx / c4, c = idx % c4;
      float4 kk = zero, vv = zero;
      if (k0 + j < seqlen) {
        const size_t off = kv_off + (size_t)(k0 + j) * kv_row + 4 * c;
        kk = load4(k + off);
        vv = load4(v + off);
      }
      store4(ks + j * headdim + 4 * c, kk);
      store4(vs + j * headdim + 4 * c, vv);
    }
    __syncthreads();

    float s[kBK];
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float* kr = ks + j * headdim;
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = sub + kTPR * i;
        if (c < c4) {
          const float4 kk = *reinterpret_cast<const float4*>(kr + 4 * c);
          dot = fmaf(qr[i].x, kk.x, dot);
          dot = fmaf(qr[i].y, kk.y, dot);
          dot = fmaf(qr[i].z, kk.z, dot);
          dot = fmaf(qr[i].w, kk.w, dot);
        }
      }
      s[j] = dot;
    }
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float dot = s[j];
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kpos = k0 + j;
      const bool keep = kpos <= qpos && (window <= 0 || qpos - kpos < window);
      s[j] = keep ? dot * scale : kNegInf;
      m_new = fmaxf(m_new, s[j]);
    }
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      acc[i].x *= alpha;
      acc[i].y *= alpha;
      acc[i].z *= alpha;
      acc[i].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float* vr = vs + j * headdim;
      const float p = s[j];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = sub + kTPR * i;
        if (c < c4) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + 4 * c);
          acc[i].x = fmaf(p, vv.x, acc[i].x);
          acc[i].y = fmaf(p, vv.y, acc[i].y);
          acc[i].z = fmaf(p, vv.z, acc[i].z);
          acc[i].w = fmaf(p, vv.w, acc[i].w);
        }
      }
    }
    __syncthreads();  // the next tile overwrites ks and vs
  }

  if (live) {
    const float lc = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = sub + kTPR * i;
      if (c < c4) {
        store4(o + qoff + 4 * c,
               make_float4(acc[i].x / lc, acc[i].y / lc, acc[i].z / lc, acc[i].w / lc));
      }
    }
  }
}

template <int NC>
int launch_f32(const void* q, const void* k, const void* v, void* o, int batch, int seqlen, int heads,
               int kv_heads, int headdim, int window, float scale, cudaStream_t stream) {
  const dim3 grid(heads, batch, (seqlen + kBQ - 1) / kBQ);
  flash_attention_kernel<NC><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), seqlen, heads, kv_heads, headdim, window, scale);
  return (int)cudaGetLastError();
}

int dispatch_f32(const void* q, const void* k, const void* v, void* o, int batch, int seqlen,
                 int heads, int kv_heads, int headdim, int window, float scale, cudaStream_t s) {
  if (headdim <= 16) return launch_f32<1>(q, k, v, o, batch, seqlen, heads, kv_heads, headdim, window, scale, s);
  if (headdim <= 32) return launch_f32<2>(q, k, v, o, batch, seqlen, heads, kv_heads, headdim, window, scale, s);
  if (headdim <= 64) return launch_f32<4>(q, k, v, o, batch, seqlen, heads, kv_heads, headdim, window, scale, s);
  return launch_f32<8>(q, k, v, o, batch, seqlen, heads, kv_heads, headdim, window, scale, s);
}

// ---------------------------------------------------- bf16, wgmma and TMA
namespace wg {

constexpr int kBQ = 128;                 // q rows per CTA: two consumer warpgroups of 64
constexpr int kBK = 64;                  // keys per K/V tile
constexpr int kStages = 3;               // K/V tiles in flight
constexpr int kThreads = 384;            // producer warpgroup + two consumers
constexpr int kConsumers = 256;
constexpr int kBox = 64;                 // bf16 columns per TMA box: 128 bytes, the swizzle's width
constexpr int kD = 128;                  // head dim as computed: two boxes, zeros past the real D
constexpr int kChunks = kD / kBox;
constexpr uint32_t kRowBytes = kBox * 2;
constexpr uint32_t kQChunk = kBQ * kRowBytes;   // one 64-column box of the q tile: 16 KB
constexpr uint32_t kKVChunk = kBK * kRowBytes;  // one 64-column box of a K or V tile: 8 KB
constexpr uint32_t kAtom = 8 * kRowBytes;       // 8 rows of 128 bytes: one swizzle atom
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;       // 128 * 40 + 256 * 232 <= 65536

// Offsets in the (1024-byte aligned) dynamic shared memory.
namespace smem {
constexpr uint32_t kStage = kChunks * kKVChunk;  // one K or V tile
constexpr uint32_t q = 0;
constexpr uint32_t k = q + kChunks * kQChunk;
constexpr uint32_t v = k + kStages * kStage;
constexpr uint32_t bars = v + kStages * kStage;  // q_full, full[kStages], empty[kStages]
constexpr uint32_t bytes = bars + 8 * (1 + 2 * kStages);
}  // namespace smem

// 2^x in one MUFU instruction (relative error ~2^-22; results below 2^-126 are 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// S (64 x 64 keys) = Q K^T over the head dim: 16 columns per step, 32 bytes into
// a swizzled 128-byte row, the next 64-column box after four steps.  `qs` is the
// warpgroup's 64 rows of the q tile, `ks` the stage's K tile.
__device__ __forceinline__ void issue_qk(float (&s)[kBK / 2], uint32_t qs, uint32_t ks) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    const uint64_t da = hopper::sw128_desc(qs + (kk / 4) * kQChunk + col, 16, kAtom);
    const uint64_t db = hopper::sw128_desc(ks + (kk / 4) * kKVChunk + col, 16, kAtom);
    hopper::wgmma_m64n64k16_ss(s, da, db, kk > 0);
  }
}

// O += P_hi V + P_lo V: 16 keys (two swizzle atoms of V's rows) per step; across
// D the next 64-column box lies kKVChunk further on.  `vs` is the stage's V tile.
__device__ __forceinline__ void issue_pv(float (&acc)[kD / 2], const uint32_t (&p_hi)[kBK / 16][4],
                                         const uint32_t (&p_lo)[kBK / 16][4], uint32_t vs) {
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j) {
    const uint64_t db = hopper::sw128_desc(vs + j * 2 * kAtom, kKVChunk, kAtom);
    hopper::wgmma_m64n128k16_rs(acc, p_hi[j], db, 1);
    hopper::wgmma_m64n128k16_rs(acc, p_lo[j], db, 1);
  }
}

// P (f32, the S accumulator's layout) as P_hi = bf16(P) and P_lo = bf16(P - P_hi),
// in the A-operand layout: key step j (keys 16j..16j+15) takes register r from
// accumulator elements 8j + 2r and 8j + 2r + 1.
__device__ __forceinline__ void split_p(const float (&p)[kBK / 2], uint32_t (&p_hi)[kBK / 16][4],
                                        uint32_t (&p_lo)[kBK / 16][4]) {
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = p[8 * j + 2 * r], c = p[8 * j + 2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
      const float2 hf = __bfloat1622float2(hi);
      p_hi[j][r] = *reinterpret_cast<const uint32_t*>(&hi);
      p_lo[j][r] = pack_bf16(a - hf.x, c - hf.y);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int seqlen,
                      int heads, int kv_heads, int headdim, int window, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + smem::bars;
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // the longest q tiles are scheduled first
  const int kvh = h / (heads / kv_heads);
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  const int kt_hi = (min(q0 + kBQ, seqlen) - 1) / kBK;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full0 + 8 * s, 1);
      hopper::mbar_init(empty0 + 8 * s, kConsumers);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------------ producer
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(q_full, kChunks * kQChunk);
      for (int c = 0; c < kChunks; ++c) {
        hopper::tma_load_4d(base + smem::q + c * kQChunk, &tq, q_full, c * kBox, h, q0, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = kt_lo; kt <= kt_hi; ++kt) {
        const uint32_t full = full0 + 8 * stage;
        hopper::mbar_wait(empty0 + 8 * stage, phase ^ 1);
        hopper::mbar_expect_tx(full, 2 * smem::kStage);
        for (int c = 0; c < kChunks; ++c) {
          const uint32_t off = stage * smem::kStage + c * kKVChunk;
          hopper::tma_load_4d(base + smem::k + off, &tk, full, c * kBox, kvh, kt * kBK, b);
          hopper::tma_load_4d(base + smem::v + off, &tv, full, c * kBox, kvh, kt * kBK, b);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;  // which 64 q rows of the tile
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r_lo = q0 + 64 * cw;                    // the warpgroup's first row
    const int row0 = r_lo + 16 * (t / 32) + lane / 4;  // this thread's rows: row0 and row0 + 8
    const int col0 = 2 * (lane % 4);                   // and its columns in each 8-wide group
    const bool active = r_lo < seqlen;

    // Accumulator layout (m64nN): element i lies in row row0 + 8 * ((i >> 1) & 1)
    // and column 8 * (i >> 2) + col0 + (i & 1).
    float acc[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // the running max of each row's raw logits q.k
    float l[2] = {0.f, 0.f};          // and the running sum of its p (this thread's part)

    // The warpgroup's tiles are one run [n_lo, n_hi] of the CTA's [kt_lo, kt_hi]; a
    // tile past its last row's diagonal or before its first row's window is only
    // passed on.
    const int n_lo = window > 0 ? max(0, r_lo - window + 1) / kBK : 0;
    const int n_hi = active ? min(kt_hi, (r_lo + 63) / kBK) : -1;
    const uint32_t qs = base + smem::q + cw * (kQChunk / 2);

    hopper::mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = kt_lo; kt <= kt_hi; ++kt) {
      hopper::mbar_wait(full0 + 8 * stage, phase);
      if (kt >= n_lo && kt <= n_hi) {
        float s[kBK / 2];
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
        hopper::fence_regs(s);
        hopper::wgmma_fence();
        issue_qk(s, qs, base + smem::k + stage * smem::kStage);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);

        // Mask only where the tile crosses the diagonal or the window's edge.  The
        // max is taken on the raw logits; scale, log2(e) and the max fold into one
        // FMA per element: p = 2^(s * scale_log2 - m * scale_log2).  Where a row's
        // max is still the mask value (all its keys so far lie before its window),
        // the shift is 0 so that p = 2^(-1e30 * scale_log2) = 0: with the shift
        // -m * scale_log2 the FMA would return the rounding error of that product,
        // up to ~1e22, whose ex2 is inf when it is positive.
        const int k0 = kt * kBK;
        const bool crosses = k0 + kBK - 1 > r_lo || (window > 0 && r_lo + 63 - k0 >= window);
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int r = (i >> 1) & 1;
          if (crosses) {
            const int row = row0 + 8 * r;
            const int key = k0 + 8 * (i >> 2) + col0 + (i & 1);
            if (key > row || (window > 0 && row - key >= window)) s[i] = kNegInf;
          }
          mx[r] = fmaxf(mx[r], s[i]);
        }
        float alpha[2], shift[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[r] = exp2_approx((m[r] - mx[r]) * scale_log2);
          shift[r] = mx[r] == kNegInf ? 0.f : -mx[r] * scale_log2;
          m[r] = mx[r];
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int r = (i >> 1) & 1;
          s[i] = exp2_approx(fmaf(s[i], scale_log2, shift[r]));
          l[r] += s[i];
        }
#pragma unroll
        for (int i = 0; i < kD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

        uint32_t p_hi[kBK / 16][4], p_lo[kBK / 16][4];
        split_p(s, p_hi, p_lo);
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
        issue_pv(acc, p_hi, p_lo, base + smem::v + stage * smem::kStage);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
      }
      hopper::mbar_arrive(empty0 + 8 * stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    if (active) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int row = row0 + 8 * r;
        if (row < seqlen) {
          const float lc = fmaxf(l[r], 1e-30f);
          __nv_bfloat16* out = o + ((size_t)(b * seqlen + row) * heads + h) * headdim;
#pragma unroll
          for (int g = 0; g < kD / 8; ++g) {
            const int col = 8 * g + col0;
            if (col < headdim) {
              *reinterpret_cast<uint32_t*>(out + col) = pack_bf16(acc[4 * g + 2 * r] / lc, acc[4 * g + 2 * r + 1] / lc);
            }
          }
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found at run time through the runtime's entry-point
// query, so that the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                            cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map over a (B, S, N, D) bf16 tensor with boxes of `rows` positions x 64
// columns of one head, 128-byte swizzled; what lies past S or D reads as zero.
bool tensor_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int batch, int seqlen, int n,
                int headdim, int rows) {
  const cuuint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t dims[4] = {(cuuint64_t)headdim, (cuuint64_t)n, (cuuint64_t)seqlen, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {e * headdim, e * headdim * n, e * headdim * n * seqlen};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch(const void* q, const void* k, const void* v, void* o, int batch, int seqlen, int heads,
           int kv_heads, int headdim, int window, float scale, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, encode, q, batch, seqlen, heads, headdim, kBQ) ||
      !tensor_map(&tk, encode, k, batch, seqlen, kv_heads, headdim, kBK) ||
      !tensor_map(&tv, encode, v, batch, seqlen, kv_heads, headdim, kBK)) {
    return (int)cudaErrorInvalidValue;
  }
  const int bytes = smem::bytes + 1024;  // room to align the base to 1024 bytes
  // The shared-memory limit is set once per device, at its first launch.
  static std::atomic<uint64_t> limit_set{0};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(limit_set.load(std::memory_order_relaxed) & bit)) {
    rc = cudaFuncSetAttribute(flash_attention_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc != cudaSuccess) return (int)rc;
    limit_set.fetch_or(bit, std::memory_order_relaxed);
  }
  const dim3 grid(heads, batch, (seqlen + kBQ - 1) / kBQ);
  flash_attention_wgmma<<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), seqlen, heads, kv_heads, headdim, window,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

// Returns a cudaError_t: 0 on success.  q, o: (B, S, H, D); k, v: (B, S, K, D),
// contiguous and 16-byte aligned.  bf16 runs the wgmma kernel, f32 the CUDA-core
// kernel.  Launches on `stream`, allocates nothing and does not synchronise.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int batch, int seqlen, int heads, int kv_heads, int headdim,
                                      int window, float scale, int is_bf16, void* stream) {
  if (batch <= 0 || seqlen <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
      headdim <= 0 || headdim % 8 != 0 || headdim > kMaxD || batch > 65535 ||
      (seqlen + kBQ - 1) / kBQ > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return wg::launch(q, k, v, o, batch, seqlen, heads, kv_heads, headdim, window, scale, s);
  return dispatch_f32(q, k, v, o, batch, seqlen, heads, kv_heads, headdim, window, scale, s);
}
