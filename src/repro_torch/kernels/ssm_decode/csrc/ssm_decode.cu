// One Mamba2 layer's single-token state update and its C contraction, for Hopper (sm_90a),
// plain C entry point.
//
// Replaces no TPU kernel: the JAX package decodes through plain jnp (src/repro/models/ssm.py,
// the Mixer's decode), and so did the port's Mamba2Mixer.decode.  On the card that plain step
// makes about nine passes over each layer's float32 state (B, H, P, N) a token: state x decay
// and (dt x) (x) B into two temporaries, their sum into a third, the einsum over C reading it
// again, and the decode step's stack of every layer's new state into the cache.  This kernel
// makes one: it reads each state element once, writes the new one once, into the destination
// the caller names (the layer's slot of the cache, which may be the state itself), and sums y
// on the way.
//
// What bounds it on an H100: per state element it does 4 float32 operations against 8 bytes
// read and written, so it is bound by HBM bytes: 2 x B x H x P x N x 4 B a layer (101 MB for
// mamba2-780m at B = 32: 30 us at 3.35 TB/s).  CUDA cores do the arithmetic; the design is
// about bytes in flight.
//
// Design.  One block per (tile of P rows, head, batch row).  A row of N state values is read by
// `lanes` threads (N / 4, or 32 with two float4 each at N = 256), each one 16-byte streaming
// load per float4; every thread starts its kRows rows' loads before using any.  B and C of the
// head's group (head h reads group h / (H / G)) sit in registers, converted to float32 once.
// Per element: new = state * decay + (dt * x) * B, each product and the sum rounded on its own
// (__fmul_rn, __fadd_rn: no contraction into an FMA), which are the plain step's roundings, so
// the new state equals it bit for bit; decay = expf(a * dt) once a block, by the same rounded
// product and the same accurate expf (no fast math: kernels/_nvcc.py) as PyTorch's exp.  y[p] = sum over n of new[p, n] * C[n]: each thread sums
// its columns in order, then the row's lanes join by an xor butterfly of warp shuffles.  No
// atomics: the same inputs give the same bits, so a replayed graph is its eager step bit for
// bit.  y sums in another order than the plain einsum: it lies within 1e-5 x sum |new * C| of
// the exact sum.  Each element is read and then written by the same thread, so `out` may be
// `state`: the update is in place.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // the widest block
constexpr int kRows = 4;       // rows a thread has in flight

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float step(float s, float decay, float dx, float b) {
  return __fadd_rn(__fmul_rn(s, decay), __fmul_rn(dx, b));
}

// V: float4s a thread holds of a row (1, or 2 at N = 256); a thread's columns are
// n = (j * lanes + lane) * 4 + e, j < V, so each load instruction of a row is contiguous.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) ssm_decode_kernel(
    const float* state, float* out, const T* __restrict__ x, const T* __restrict__ bm,
    const T* __restrict__ cm, const float* __restrict__ dt, const float* __restrict__ a,
    float* __restrict__ y, int h, int rep, int p, int n, int lanes, int64_t xsb, int64_t xsh, int64_t bsb,
    int64_t bsg, int64_t csb, int64_t csg) {
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int lane = threadIdx.x & (lanes - 1);
  const int rpp = blockDim.x / lanes;  // rows a pass of the block covers
  const int row0 = blockIdx.x * rpp * kRows + threadIdx.x / lanes;
  const int64_t bh = (int64_t)bb * h + hh;
  const int grp = hh / rep;
  const float dtv = dt[bh], dec = expf(__fmul_rn(a[hh], dtv));

  float bv[V][4], cv[V][4];
  const T* bp = bm + bb * bsb + grp * bsg;
  const T* cp = cm + bb * csb + grp * csg;
#pragma unroll
  for (int j = 0; j < V; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bv[j][e] = to_f(bp[(j * lanes + lane) * 4 + e]);
      cv[j][e] = to_f(cp[(j * lanes + lane) * 4 + e]);
    }
  }

  const int q4 = n / 4;
  const float4* src = reinterpret_cast<const float4*>(state + bh * p * n);
  float4* dst = reinterpret_cast<float4*>(out + bh * p * n);
  const T* xr = x + bb * xsb + hh * xsh;
  float4 s[kRows][V];
  float xv[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int row = row0 + k * rpp;
    const bool ok = row < p;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s[k][j] = ok ? __ldcs(src + (int64_t)row * q4 + j * lanes + lane) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    xv[k] = ok ? to_f(xr[row]) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int row = row0 + k * rpp;
    const bool ok = row < p;
    const float dx = __fmul_rn(dtv, xv[k]);
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float4 v = s[k][j];
      v.x = step(v.x, dec, dx, bv[j][0]);
      v.y = step(v.y, dec, dx, bv[j][1]);
      v.z = step(v.z, dec, dx, bv[j][2]);
      v.w = step(v.w, dec, dx, bv[j][3]);
      if (ok) __stcs(dst + (int64_t)row * q4 + j * lanes + lane, v);
      acc = fmaf(v.x, cv[j][0], acc);
      acc = fmaf(v.y, cv[j][1], acc);
      acc = fmaf(v.z, cv[j][2], acc);
      acc = fmaf(v.w, cv[j][3], acc);
    }
    for (int off = lanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (ok && lane == 0) y[bh * p + row] = acc;
  }
}

template <typename T, int V>
cudaError_t launch(dim3 grid, int threads, cudaStream_t s, const float* state, float* out, const void* x,
                   const void* bm, const void* cm, const float* dt, const float* a, float* y, int h, int rep,
                   int p, int n, int lanes, int64_t xsb, int64_t xsh, int64_t bsb, int64_t bsg, int64_t csb,
                   int64_t csg) {
  ssm_decode_kernel<T, V><<<grid, threads, 0, s>>>(state, out, static_cast<const T*>(x), static_cast<const T*>(bm),
                                                   static_cast<const T*>(cm), dt, a, y, h, rep, p, n, lanes, xsb,
                                                   xsh, bsb, bsg, csb, csg);
  return cudaGetLastError();
}

}  // namespace

// state and out (B, H, P, N) float32, contiguous and 16-byte aligned (out may be state); x (B, H, P)
// by element strides (xsb, xsh), P contiguous; bm and cm (B, G, N) by strides (sb, sg), N contiguous;
// dt (B, H) and a (H,) float32 contiguous; y (B, H, P) float32 contiguous.  x, bm and cm are float32
// (dtype 0) or bfloat16 (dtype 1).  N / 4 a power of two up to 32, or N = 256; H % G == 0.
extern "C" int ssm_decode_launch(const void* state, void* out, const void* x, const void* bm, const void* cm,
                                 const void* dt, const void* a, void* y, int b, int h, int g, int p, int n,
                                 long long xsb, long long xsh, long long bsb, long long bsg, long long csb,
                                 long long csg, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || g <= 0 || p <= 0 || n <= 0 || b > 65535 || h > 65535 || h % g || n % 4 ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int v = n == 256 ? 2 : 1;
  const int lanes = n / (4 * v);
  if (lanes > 32 || (lanes & (lanes - 1))) return (int)cudaErrorInvalidValue;
  // the block: as many rows a pass as fill 256 threads, fewer where P is short, whole warps
  int rpp = kThreads / lanes;
  const int need = (p + kRows - 1) / kRows;
  while (rpp > 1 && rpp / 2 >= need && (rpp / 2) * lanes >= 32) rpp /= 2;
  const int threads = rpp * lanes, tile = rpp * kRows;
  const dim3 grid((p + tile - 1) / tile, h, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* st = static_cast<const float*>(state);
  auto* o = static_cast<float*>(out);
  const auto* d = static_cast<const float*>(dt);
  const auto* av = static_cast<const float*>(a);
  auto* yy = static_cast<float*>(y);
  const int rep = h / g;
  cudaError_t err;
  if (dtype == 1) {
    err = v == 1 ? launch<__nv_bfloat16, 1>(grid, threads, s, st, o, x, bm, cm, d, av, yy, h, rep, p, n, lanes, xsb,
                                            xsh, bsb, bsg, csb, csg)
                 : launch<__nv_bfloat16, 2>(grid, threads, s, st, o, x, bm, cm, d, av, yy, h, rep, p, n, lanes, xsb,
                                            xsh, bsb, bsg, csb, csg);
  } else {
    err = v == 1 ? launch<float, 1>(grid, threads, s, st, o, x, bm, cm, d, av, yy, h, rep, p, n, lanes, xsb, xsh,
                                    bsb, bsg, csb, csg)
                 : launch<float, 2>(grid, threads, s, st, o, x, bm, cm, d, av, yy, h, rep, p, n, lanes, xsb, xsh,
                                    bsb, bsg, csb, csg);
  }
  return (int)err;
}
