// Split-K decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/
// decode_attention.py::_dec_kernel: for each (batch x KV head, split) it
// takes the G query rows of that KV head against one block of S / n_splits
// cache positions, masks positions >= kv_len, and writes the normalised
// partial output and the log-sum-exp of the split, both in fp32, exactly as
// the TPU kernel defines them (m_safe = max(m, NEG_INF / 2), the l > 0
// guard, max(l, 1e-30)).  A split that lies wholly past kv_len gives a zero
// partial and lse = -1e30, so it weighs nothing in the combine, which stays
// outside the kernel (ops.py), as it was on the TPU.
//
// What bounds it on this card: bytes.  One decode step streams the valid
// prefix of K and V once and does 4 flops per element of it, far below the
// ~295 flops per byte at which the H100 turns compute-bound.  At the LM
// decode shape (128 batch x KV heads, S = 2560, D = 80, bf16, kv_len ~2050)
// that is ~85 MB per layer, 25 us at 3.35 TB/s.
//
// What the design does about it:
//  * the cache is read in its (B, S, KV, D) layout through strides, so no
//    transposed copy of it is made per call;
//  * positions at or past kv_len are never loaded;
//  * each warp streams positions of the split: lane i holds head-dim
//    elements 4i .. 4i + 3 (one 8-byte bf16 or 16-byte fp32 load), and a
//    warp keeps UNROLL positions of K and V in flight before it reduces
//    their dot products with shuffles (G = 1 makes the product a GEMV);
//  * each warp keeps its own online-softmax state; the 8 warps merge
//    through shared memory at the end, into the TPU kernel's (o, lse).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int VEC = 4;                 // head-dim elements per lane
constexpr int DMAX = 32 * VEC;         // 128
constexpr int GMAX = 8;                // query rows per KV head, at most
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

template <typename TQ, typename TKV, int GT>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const int* __restrict__ kv_len,
              float* __restrict__ o, float* __restrict__ lse, int KV, int G,
              int D, int block, long long ksb, long long kss, long long ksh,
              long long vsb, long long vss, long long vsh, float scale) {
  constexpr int UNROLL = GT <= 2 ? 8 : 4;
  __shared__ float sm_m[WARPS][GT];
  __shared__ float sm_l[WARPS][GT];
  __shared__ float sm_acc[WARPS][GT][DMAX];

  const int bkv = blockIdx.x;
  const int split = blockIdx.y;
  const int n_splits = gridDim.y;
  const int b = bkv / KV;
  const int kvh = bkv - b * KV;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int d0 = lane * VEC;
  const bool active = d0 < D;

  // q: (B * KV, G, D) contiguous, scaled once
  float qr[GT][VEC];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      qr[g][e] = (g < G && active)
          ? to_f(q[((long long)bkv * G + g) * D + d0 + e]) * scale
          : 0.f;

  const int base = split * block;
  const int end = min(base + block, kv_len[b]);
  const TKV* kp = k + b * ksb + kvh * ksh + d0;
  const TKV* vp = v + b * vsb + kvh * vsh + d0;

  float m[GT], l[GT], acc[GT][VEC];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  for (int p0 = base + warp * UNROLL; p0 < end; p0 += WARPS * UNROLL) {
    float kr[UNROLL][VEC], vr[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int pos = p0 + u;
      if (active && pos < end) {
        load4(kp + pos * kss, kr[u]);
        load4(vp + pos * vss, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
    float s[GT][UNROLL];
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) x = fmaf(qr[g][e], kr[u][e], x);
        s[g][u] = x;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          s[g][u] += __shfl_xor_sync(0xffffffffu, s[g][u], off);

#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (p0 + u < end) mx = fmaxf(mx, s[g][u]);
      const float alpha = expf(m[g] - mx);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (p0 + u < end) {
          const float p = expf(s[g][u] - mx);
          l[g] += p;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vr[u][e], acc[g][e]);
        }
      }
      m[g] = mx;
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  if (active) {
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[warp][g][d0 + e] = acc[g][e];
  }
  __syncthreads();

  // merge the warps: rescale each to the split's m_safe, as _dec_kernel
  // takes every exponent against it
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int g = i / D, d = i - g * D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    const float m_safe = fmaxf(mx, NEG_INF / 2);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(sm_m[w][g] - m_safe);
      lt = fmaf(sm_l[w][g], c, lt);
      at = fmaf(sm_acc[w][g][d], c, at);
    }
    const long long row = ((long long)bkv * n_splits + split) * G + g;
    o[row * D + d] = at / fmaxf(lt, 1e-30f);
    if (d == 0) lse[row] = lt > 0.f ? logf(lt) + m_safe : NEG_INF;
  }
}

template <typename TQ, typename TKV, int GT>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           float* o, float* lse, int BKV, int KV, int G, int D, int block,
           int n_splits, const long long* st, float scale,
           cudaStream_t stream) {
  dim3 grid(BKV, n_splits);
  decode_kernel<TQ, TKV, GT><<<grid, THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), kv_len, o, lse, KV, G, D, block, st[0],
      st[1], st[2], st[3], st[4], st[5], scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int dispatch_g(const void* q, const void* k, const void* v,
               const int* kv_len, float* o, float* lse, int BKV, int KV,
               int G, int D, int block, int n_splits, const long long* st,
               float scale, cudaStream_t s) {
  if (G == 1)
    return launch<TQ, TKV, 1>(q, k, v, kv_len, o, lse, BKV, KV, G, D, block,
                              n_splits, st, scale, s);
  if (G == 2)
    return launch<TQ, TKV, 2>(q, k, v, kv_len, o, lse, BKV, KV, G, D, block,
                              n_splits, st, scale, s);
  if (G <= 4)
    return launch<TQ, TKV, 4>(q, k, v, kv_len, o, lse, BKV, KV, G, D, block,
                              n_splits, st, scale, s);
  return launch<TQ, TKV, GMAX>(q, k, v, kv_len, o, lse, BKV, KV, G, D, block,
                               n_splits, st, scale, s);
}

}  // namespace

extern "C" {

// q: (B * KV, G, D) contiguous; k, v: (B, S, KV, D) with unit stride along D
// (strides[6] = k b/s/h, v b/s/h, in elements, multiples of 4, and the
// pointers aligned to 4 elements); kv_len: (B,) int32.  Writes
// o: (B * KV, n_splits, G, D) and lse: (B * KV, n_splits, G), fp32,
// contiguous.  q_bf16 / kv_bf16 select bfloat16 (1) or float32 (0).
// A bfloat16 q against float32 k/v is not built.
// Returns the CUDA error of the launch (0 on success).
int dec_forward(const void* q, const void* k, const void* v,
                const int* kv_len, void* o, void* lse, int q_bf16,
                int kv_bf16, int B, int KV, int G, int S, int D,
                int n_splits, const long long* strides, float scale,
                void* stream) {
  if (D <= 0 || D > DMAX || D % VEC != 0 || G <= 0 || G > GMAX ||
      n_splits <= 0 || S % n_splits != 0 || (q_bf16 && !kv_bf16))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || KV == 0) return 0;
  const int BKV = B * KV;
  const int block = S / n_splits;
  auto s = static_cast<cudaStream_t>(stream);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  if (q_bf16 && kv_bf16)
    return dispatch_g<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, kv_len, of, lf, BKV, KV, G, D, block, n_splits, strides,
        scale, s);
  if (kv_bf16)
    return dispatch_g<float, __nv_bfloat16>(q, k, v, kv_len, of, lf, BKV, KV,
                                            G, D, block, n_splits, strides,
                                            scale, s);
  return dispatch_g<float, float>(q, k, v, kv_len, of, lf, BKV, KV, G, D,
                                  block, n_splits, strides, scale, s);
}

}  // extern "C"
