// Causal GQA flash attention for Hopper (sm_90a), plain C entry point.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (body _fa_kernel), the Pallas TPU kernel whose grid is (B, H, q blocks, kv
// blocks) with the kv axis run in order and the running max, sum and
// accumulator carried in VMEM scratch across it.
//
// What bounds it on an H100: at the forward shape of qwen2.5-3b (B=4, S=1024,
// H=16, K=2, D=128, bf16) the function moves ~38 MB and needs ~17 GFLOP over
// the causal half, so on bf16 tensor cores it would be bound by operations
// (~17 us).  This first kernel computes in f32 on CUDA cores (67 TFLOP/s
// peak), so operations bound it further.
//
// Design: one block of 256 threads per (head, batch, 64-row q tile); the kv
// loop runs inside the block in place of the TPU's sequential kv axis, from
// the window's first tile to the diagonal tile, so tiles wholly above the
// diagonal or outside the window are never visited.  Four threads own one q
// row: each keeps a quarter of the row's head dim (float4 chunks c = sub +
// 4i) of q and of the f32 accumulator in registers, the partial q.k dots are
// summed across the four lanes with shuffles (the sum is the same bit pattern
// in all four), and each lane then keeps the row's running max and sum.  The
// k and v tiles (32 keys) are staged in shared memory as f32, once per tile
// for the whole block; a ragged tail is zero-filled, and only rows < S are
// written.  Masked logits are -1e30, as in the TPU kernel.  Tensor cores
// (mma/wgmma), TMA and a pipeline of tiles are left to a later kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                // q rows per block
constexpr int kBK = 32;                // keys per kv tile
constexpr int kTPR = 4;                // threads per q row
constexpr int kThreads = kBQ * kTPR;   // 256
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// NC: float4 chunks of the head dim per thread, ceil(D / 16).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, int seqlen, int heads, int kv_heads, int headdim,
                       int window, float scale) {
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

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int seqlen, int heads,
           int kv_heads, int headdim, int window, float scale, cudaStream_t stream) {
  const dim3 grid(heads, batch, (seqlen + kBQ - 1) / kBQ);
  flash_attention_kernel<T, NC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), seqlen, heads, kv_heads, headdim, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int batch, int seqlen,
             int heads, int kv_heads, int headdim, int window, float scale, cudaStream_t s) {
  if (headdim <= 16) return launch<T, 1>(q, k, v, o, batch, seqlen, heads, kv_heads, headdim, window, scale, s);
  if (headdim <= 32) return launch<T, 2>(q, k, v, o, batch, seqlen, heads, kv_heads, headdim, window, scale, s);
  if (headdim <= 64) return launch<T, 4>(q, k, v, o, batch, seqlen, heads, kv_heads, headdim, window, scale, s);
  return launch<T, 8>(q, k, v, o, batch, seqlen, heads, kv_heads, headdim, window, scale, s);
}

}  // namespace

// Returns a cudaError_t: 0 on success.  q, o: (B, S, H, D); k, v: (B, S, K, D),
// contiguous and 16-byte aligned.  Launches on `stream`, allocates nothing and
// does not synchronise.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int batch, int seqlen, int heads, int kv_heads, int headdim,
                                      int window, float scale, int is_bf16, void* stream) {
  if (batch <= 0 || seqlen <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
      headdim <= 0 || headdim % 8 != 0 || headdim > kMaxD || batch > 65535 ||
      (seqlen + kBQ - 1) / kBQ > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(q, k, v, o, batch, seqlen, heads, kv_heads, headdim, window,
                                   scale, s);
  }
  return dispatch<float>(q, k, v, o, batch, seqlen, heads, kv_heads, headdim, window, scale, s);
}
