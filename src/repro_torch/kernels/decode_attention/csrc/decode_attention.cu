// One query row's attention over a K/V cache where the cache holds it, for Hopper (sm_90a),
// plain C entry point.
//
// Replaces no TPU kernel: the JAX package decodes through plain jnp (a gather of K and V by
// the q-head -> kv-head map, two einsums, a masked softmax), and so did the port's
// layers._attend_cache.  On the card that plain path gathers and re-lays out every cache
// row, max_len of them, four times a step: for zamba2-7b-instruct at batch 32 that is
// ~4 GB of gathers and copies per site per step against the ~1 GB of K/V rows it needs at the longest
// prompt.  This kernel reads each kv head's rows 0..pos (or the sliding window's) once, in
// place, by strides, and nothing else but q, a small f32 workspace and the output.
//
// What bounds it on an H100: per kv head and row it reads 2 x D bf16 values and does ~4 x D
// operations per q head that reads them, far below bf16's ~295 operations a byte, so it is
// bound by HBM bytes: (pos + 1) x 2 x K x D x 2 B a batch row (12.6 GB over 13 zamba2 sites
// at B = 32, pos = 1056: 3.8 ms at 3.35 TB/s).  CUDA cores do the arithmetic; the design is
// about bytes in flight.
//
// Design.  Pass 1 (decode_attention_chunk): one block of 4 warps per (chunk of `chunk` cache
// rows, 64 from kernel.py, kv head, batch row).  The grid is static over Smax, so that a CUDA graph can hold it;
// each block reads pos from device memory and a block whose chunk lies wholly outside
// [max(0, pos - window + 1), pos] returns at once, reading and writing nothing: pass 2 takes
// the same range from pos and never reads that chunk's partial.  A block first finds, in order
// of h, the q heads that the map kvm sends to its kv head (warp 0, by ballots over kvm), up to
// NG of them at a time (NG, a template parameter, is the power of two at or above H / K, up to
// 8; a kv head read by more q heads takes further rounds over its rows).  So K/V is read once
// per kv head whatever the grouping, and grouped-query attention pays no extra bytes.  A warp
// owns one row at a time: lane l holds elements 8l .. 8l + 7 of the row (one 16-byte load; D
// <= 256), the q . k dot is summed over the warp by an xor butterfly (every lane ends with the
// same bits), and the warp keeps, per q head, a running max m, sum l and accumulator (8 f32 a
// lane) over its rows: scores, softmax and P . V all in f32.  Each warp issues its next kRows
// rows' K and V loads before using any.  The block then joins its warps' (m, l, acc) in shared
// memory in warp order and writes one partial per (batch row, q head, chunk) to the workspace.
// Pass 2 (decode_attention_merge): one block per (q head, batch row), a thread per element of
// D, joins the partials of the chunks in range in chunk order and writes acc / l in bf16.  No
// atomics: the same inputs give the same bits, so a replayed graph is its eager step bit for
// bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;              // rows a warp has in flight
constexpr int kMaxD = 256;            // 32 lanes x 8 elements
constexpr float kFloor = -1e30f;      // the running max before any row

struct Rows {
  int lo, hi;                         // the cache rows attended, inclusive
};

__device__ __forceinline__ Rows rows_of(const int* pos_ptr, int smax, int window) {
  const int pos = *pos_ptr;
  return {window > 0 ? max(0, pos - window + 1) : 0, min(pos, smax - 1)};
}

__device__ __forceinline__ void unpack8(uint4 u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(h[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int NG>
__global__ void __launch_bounds__(kThreads) decode_attention_chunk(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int64_t* __restrict__ kvm, const int* __restrict__ pos_ptr,
    float* __restrict__ part_acc, float2* __restrict__ part_ml, int H, int D, int smax, int chunk,
    int nchunks, int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, int window,
    float scale) {
  const int c = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const Rows r = rows_of(pos_ptr, smax, window);
  const int r0 = max(c * chunk, r.lo), r1 = min(c * chunk + chunk - 1, r.hi);
  if (r0 > r1) return;

  __shared__ int s_heads[NG];
  __shared__ int s_n, s_next;
  __shared__ float s_m[kWarps][NG], s_l[kWarps][NG];
  __shared__ __align__(16) float s_acc[kWarps][NG][kMaxD];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool active = lane < (D >> 3);
  const __nv_bfloat16* kb = k + b * ksb + kh * ksh + lane * 8;
  const __nv_bfloat16* vb = v + b * vsb + kh * vsh + lane * 8;

  for (int cursor = 0; cursor < H;) {
    if (warp == 0) {  // the next NG q heads h >= cursor with kvm[h] == kh, in order
      int n = 0, cur = cursor;
      while (cur < H && n < NG) {
        const int h = cur + lane;
        const bool hit = h < H && kvm[h] == kh;
        const unsigned bal = __ballot_sync(0xffffffffu, hit);
        const int rank = __popc(bal & ((1u << lane) - 1u));
        if (hit && n + rank < NG) s_heads[n + rank] = h;
        const int found = __popc(bal);
        if (n + found > NG) {  // more here than places left: resume at the first one not taken
          unsigned rest = bal;
          for (int i = 0; i < NG - n; ++i) rest &= rest - 1u;
          cur += __ffs(rest) - 1;
          n = NG;
        } else {
          n += found;
          cur += 32;
        }
      }
      if (lane == 0) {
        s_n = n;
        s_next = cur;
      }
    }
    __syncthreads();
    const int n = s_n;
    cursor = s_next;
    if (n == 0) break;

    float qf[NG][8], m[NG], l[NG], acc[NG][8];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      m[g] = kFloor;
      l[g] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[g][j] = qf[g][j] = 0.f;
      if (g < n && active) {
        const __nv_bfloat16* qp = q + ((int64_t)b * H + s_heads[g]) * D + lane * 8;
        unpack8(__ldg(reinterpret_cast<const uint4*>(qp)), qf[g]);
      }
    }

    for (int rs = r0 + warp * kRows; rs <= r1; rs += kWarps * kRows) {
      uint4 kr[kRows], vr[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int row = rs + u;
        if (active && row <= r1) {
          kr[u] = __ldg(reinterpret_cast<const uint4*>(kb + row * kss));
          vr[u] = __ldg(reinterpret_cast<const uint4*>(vb + row * vss));
        } else {
          kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      float s[NG][kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        float kf[8];
        unpack8(kr[u], kf);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) dot = fmaf(qf[g][j], kf[j], dot);
          dot = warp_sum(dot) * scale;
          s[g][u] = rs + u <= r1 ? dot : -CUDART_INF_F;
        }
      }
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < kRows; ++u) mx = fmaxf(mx, s[g][u]);
        const float alpha = expf(m[g] - mx);
        m[g] = mx;
        l[g] *= alpha;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[g][j] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        float vf[8];
        unpack8(vr[u], vf);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float p = expf(s[g][u] - m[g]);
          l[g] += p;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[g][j] = fmaf(p, vf[j], acc[g][j]);
        }
      }
    }

#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if (lane == 0) {
        s_m[warp][g] = m[g];
        s_l[warp][g] = l[g];
      }
      if (active) {
        float4* dst = reinterpret_cast<float4*>(&s_acc[warp][g][lane * 8]);
        dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
        dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
      }
    }
    __syncthreads();
    // a warp with no row in range holds (kFloor, 0, 0): its weight below is 0
    for (int i = threadIdx.x; i < n * D; i += kThreads) {
      const int g = i / D, d = i - g * D;
      float mx = kFloor;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
      float a = 0.f, sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float e = expf(s_m[w][g] - mx);
        a = fmaf(e, s_acc[w][g][d], a);
        sum = fmaf(e, s_l[w][g], sum);
      }
      const int64_t at = ((int64_t)b * H + s_heads[g]) * nchunks + c;
      part_acc[at * D + d] = a;
      if (d == 0) part_ml[at] = make_float2(mx, sum);
    }
    __syncthreads();  // s_heads and s_acc are written again in the next round
  }
}

__global__ void __launch_bounds__(kMaxD) decode_attention_merge(
    const float* __restrict__ part_acc, const float2* __restrict__ part_ml, const int64_t* __restrict__ kvm,
    const int* __restrict__ pos_ptr, __nv_bfloat16* __restrict__ out, int H, int K, int D, int smax, int chunk,
    int nchunks, int window) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  if (d >= D) return;
  const Rows r = rows_of(pos_ptr, smax, window);
  const int64_t kh = kvm[h];
  __nv_bfloat16* o = out + ((int64_t)b * H + h) * D + d;
  if (r.lo > r.hi || kh < 0 || kh >= K) {  // nothing attended: no pass-1 block wrote a partial
    *o = __float2bfloat16(0.f);
    return;
  }
  const int c0 = r.lo / chunk, c1 = r.hi / chunk;
  const int64_t base = ((int64_t)b * H + h) * nchunks;
  float mx = kFloor;
  for (int c = c0; c <= c1; ++c) mx = fmaxf(mx, part_ml[base + c].x);
  float a = 0.f, sum = 0.f;
  for (int c = c0; c <= c1; ++c) {
    const float2 ml = part_ml[base + c];
    const float e = expf(ml.x - mx);
    sum = fmaf(e, ml.y, sum);
    a = fmaf(e, part_acc[(base + c) * D + d], a);
  }
  *o = __float2bfloat16(a / sum);
}

template <int NG>
cudaError_t launch_chunks(dim3 grid, cudaStream_t s, const __nv_bfloat16* q, const __nv_bfloat16* k,
                          const __nv_bfloat16* v, const int64_t* kvm, const int* pos, float* acc, float2* ml,
                          int h, int d, int smax, int chunk, int nchunks, int64_t ksb, int64_t kss, int64_t ksh,
                          int64_t vsb, int64_t vss, int64_t vsh, int window, float scale) {
  decode_attention_chunk<NG><<<grid, kThreads, 0, s>>>(q, k, v, kvm, pos, acc, ml, h, d, smax, chunk, nchunks,
                                                       ksb, kss, ksh, vsb, vss, vsh, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, 1, H, D) and out contiguous; k and v (B, Smax, K, D) by element strides (sb, ss, sh), D
// contiguous; every pointer and row 16-byte aligned; kvm (H,) int64 and pos (one int32) on the
// card; work holds B x H x ceil(Smax / chunk) x (D + 2) floats.  group: ceil(H / K).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v, const void* kvm,
                                       const void* pos, void* out, void* work, int b, int h, int kh, int d,
                                       int smax, long long ksb, long long kss, long long ksh, long long vsb,
                                       long long vss, long long vsh, int chunk, int window, float scale,
                                       int group, void* stream) {
  if (b <= 0 || h <= 0 || kh <= 0 || kh > 65535 || b > 65535 || smax <= 0 || chunk <= 0 || d <= 0 ||
      d % 8 || d > kMaxD || window < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int nchunks = (smax + chunk - 1) / chunk;
  float* acc = static_cast<float*>(work);
  float2* ml = reinterpret_cast<float2*>(acc + (int64_t)b * h * nchunks * d);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* map = static_cast<const int64_t*>(kvm);
  const auto* p = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(nchunks, kh, b);
  cudaError_t err;
  if (group <= 1) {
    err = launch_chunks<1>(grid, s, qb, kb, vb, map, p, acc, ml, h, d, smax, chunk, nchunks, ksb, kss, ksh, vsb,
                           vss, vsh, window, scale);
  } else if (group <= 2) {
    err = launch_chunks<2>(grid, s, qb, kb, vb, map, p, acc, ml, h, d, smax, chunk, nchunks, ksb, kss, ksh, vsb,
                           vss, vsh, window, scale);
  } else if (group <= 4) {
    err = launch_chunks<4>(grid, s, qb, kb, vb, map, p, acc, ml, h, d, smax, chunk, nchunks, ksb, kss, ksh, vsb,
                           vss, vsh, window, scale);
  } else {
    err = launch_chunks<8>(grid, s, qb, kb, vb, map, p, acc, ml, h, d, smax, chunk, nchunks, ksb, kss, ksh, vsb,
                           vss, vsh, window, scale);
  }
  if (err != cudaSuccess) return (int)err;
  decode_attention_merge<<<dim3(h, b), (d + 31) / 32 * 32, 0, s>>>(acc, ml, map, p, static_cast<__nv_bfloat16*>(out),
                                                                   h, kh, d, smax, chunk, nchunks, window);
  return (int)cudaGetLastError();
}
