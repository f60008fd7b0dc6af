// Split-K decode attention for Hopper (sm_90a), plain C interface: the
// per-split partials, and the whole output with the split combine inside
// the same launch.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/
// decode_attention.py::_dec_kernel: for each (batch x KV head, split) it
// takes the G query rows of that KV head against one block of cache
// positions masked by kv_len, with the split's normalised partial output
// and log-sum-exp in fp32, exactly as the TPU kernel defines them
// (m_safe = max(m, NEG_INF / 2), the l > 0 guard, max(l, 1e-30)).  A split
// that lies wholly past kv_len gives a zero partial and lse = -1e30.
//  * dec_forward writes those partials (splits of S / n_splits positions,
//    as _dec_kernel cuts them), for decode_attention_splits and the JAX
//    parity tests; the combine then runs outside, as on the TPU;
//  * dec_forward_fused cuts the valid prefix kv_len into n_splits even
//    pieces, launches the splits of one (b, kv head) as one thread-block
//    cluster, and merges them through distributed shared memory with the
//    combine of ops.py (max of the LSEs, exp(lse - m) weights, weighted sum
//    over their sum) into the (B, H, D) output in q's dtype: one launch per
//    decode step and layer, no partials in device memory.  One split needs
//    no cluster: its combine is the identity, and it writes the output.
//
// What bounds it on this card: bytes.  One decode step streams the valid
// prefix of K and V once and does 4 flops per element of it, far below the
// ~295 flops per byte at which the H100 turns compute-bound.  At the LM
// decode shape (128 batch x KV heads, S = 2560, D = 80, bf16, kv_len ~2050)
// that is ~85 MB per layer, 25 us at 3.35 TB/s.  The first version of this
// kernel read 0.40-0.46 TB/s: 128 CTAs, 8-byte loads on 20 of 32 lanes, and
// every warp's loads waiting on its previous reduction.
//
// What the design does about it:
//  * every lane moves 16 bytes: a position's row of D elements is D / 8
//    (bf16) or D / 4 (fp32) lanes, and a warp load covers 32 / that many
//    positions (3 at D = 80 in bf16, 30 lanes busy), the dot product summed
//    over the row's lanes with shuffles;
//  * each warp streams its positions through a private 4-stage cp.async
//    ring in shared memory, so three chunks of K and V are in flight while
//    it reduces the current one; no block-wide barrier in the loop;
//  * 8 warps per CTA, each with ~5.8 KB of K and V in flight; the wrapper
//    picks as many splits as keep (B x KV) x splits within one CTA per SM
//    (1 at the LM shape: 128 CTAs).  More splits measured slower there on
//    an H100 (34 us for one split without a cluster, 40 us for 2, 47-51 us
//    for 3-8): each split adds a prologue, a merge and a wider cluster;
//  * the cache is read in its (B, S, KV, D) layout through strides, and
//    positions at or past kv_len are never loaded;
//  * each (warp, position slot) keeps its own online softmax; they merge in
//    shared memory into the split's (o, lse), then across the cluster;
//  * expf, logf and IEEE division (no fast math), so fp32 results stay
//    within 1e-5 of the plain PyTorch version.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 2;              // positions per lane slot per stage
constexpr int NSTAGE = 4;              // ring stages per warp
constexpr int DMAX = 128;
constexpr int GMAX = 8;                // query rows per KV head, at most
constexpr int MAX_SPLITS = 8;          // splits merged in one cluster
constexpr int MAX_SUBS = WARPS * 32;   // online-softmax states per CTA
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// the 16 bytes of one lane as floats
__device__ __forceinline__ void unpack(const uint4& x, float (&out)[4]) {
  out[0] = __uint_as_float(x.x);
  out[1] = __uint_as_float(x.y);
  out[2] = __uint_as_float(x.z);
  out[3] = __uint_as_float(x.w);
}
__device__ __forceinline__ void unpack(const uint4& x, float (&out)[8]) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte async copy global -> shared; 0 source bytes writes 16 zero bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// what a launch writes: the split-K partials; the output from one split
// per (b, kv head); the output merged across a cluster of splits.  Only the
// last one carries cluster code, which a plain launch measured slower with.
enum Mode { PARTIALS, WHOLE, CLUSTER };

struct Args {
  const int* kv_len;   // (B,) int32, or null: every row has kv_fixed
  int kv_fixed;
  void* out;           // partials: o (B * KV, n_splits, G, D) fp32;
                       // fused: (B, H, D) in q's dtype
  float* lse;          // partials: (B * KV, n_splits, G) fp32
  int KV, G, S, D;
  int block;           // partials: positions per split (S / n_splits)
  long long ksb, kss, ksh, vsb, vss, vsh;
  float scale;
};

// dynamic shared memory: the warps' rings, later each (warp, position
// slot) state's accumulator, at most WARPS * 32 * VE floats per query row
template <typename TKV, int GT>
constexpr int smem_bytes() {
  constexpr int ring = WARPS * NSTAGE * 2 * UNROLL * 32 * 16;
  constexpr int acc = WARPS * 32 * (16 / (int)sizeof(TKV)) * GT * 4;
  return ring > acc ? ring : acc;
}

template <typename TQ, typename TKV, int GT, int MODE>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, Args a) {
  constexpr int VE = 16 / sizeof(TKV);   // elements per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* ring = reinterpret_cast<uint4*>(smem_raw);   // smem_bytes<TKV, GT>
  __shared__ float sm_m[MAX_SUBS * GT];
  __shared__ float sm_l[MAX_SUBS * GT];
  __shared__ float sm_o[MODE == CLUSTER ? GT * DMAX : 1];
  __shared__ float sm_lse[GT];
  // after the loop the same memory holds each state's accumulator
  float* sm_acc = reinterpret_cast<float*>(smem_raw);

  const int D = a.D, G = a.G;
  const int split = blockIdx.x;
  const int n_splits = gridDim.x;
  const int bkv = blockIdx.y;
  const int b = bkv / a.KV;
  const int kvh = bkv - b * a.KV;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lpp = D / VE;                // lanes per position
  const int ppw = 32 / lpp;              // positions per warp load
  const int seg = lane / lpp;            // the lane's position slot
  const int rel = lane - seg * lpp;
  const bool active = seg < ppw;
  const int d0 = rel * VE;
  const int chunk = ppw * UNROLL;        // positions per warp per stage

  int len = a.kv_len ? a.kv_len[b] : a.kv_fixed;
  len = max(0, min(len, a.S));
  int start, end;
  if (MODE != PARTIALS) {
    const int blk = (len + n_splits - 1) / n_splits;
    start = split * blk;
    end = min(start + blk, len);
  } else {
    start = split * a.block;
    end = min(start + a.block, len);
  }
  const int n_chunks = end > start ? (end - start + chunk - 1) / chunk : 0;
  const int n_my = n_chunks > warp ? (n_chunks - warp + WARPS - 1) / WARPS
                                   : 0;

  // q: (B * KV, G, D) contiguous, scaled once
  float qr[GT][VE];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int e = 0; e < VE; ++e)
      qr[g][e] = (g < G && active)
          ? to_f(q[((long long)bkv * G + g) * D + d0 + e]) * a.scale
          : 0.f;

  const TKV* kp = k + b * a.ksb + kvh * a.ksh + d0;
  const TKV* vp = v + b * a.vsb + kvh * a.vsh + d0;
  uint4* wring = ring + warp * NSTAGE * 2 * UNROLL * 32;

  // the warp's i-th chunk (chunk index warp + i * WARPS) into stage i % NSTAGE
  auto issue = [&](int i) {
    uint4* slot = wring + (i % NSTAGE) * 2 * UNROLL * 32;
    const int p0 = start + (warp + i * WARPS) * chunk + seg;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int pos = p0 + u * ppw;
      const bool ok = active && pos < end;
      cp_async16(smem_u32(slot + u * 32 + lane),
                 ok ? static_cast<const void*>(kp + pos * a.kss)
                    : static_cast<const void*>(k),
                 ok ? 16 : 0);
      cp_async16(smem_u32(slot + (UNROLL + u) * 32 + lane),
                 ok ? static_cast<const void*>(vp + pos * a.vss)
                    : static_cast<const void*>(v),
                 ok ? 16 : 0);
    }
  };

  float m[GT], l[GT], acc[GT][VE];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[g][e] = 0.f;
  }

#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {
    if (i < n_my) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_my; ++i) {
    if (i + NSTAGE - 1 < n_my) issue(i + NSTAGE - 1);
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();   // chunk i has landed
    __syncwarp();
    const uint4* slot = wring + (i % NSTAGE) * 2 * UNROLL * 32;
    float kf[UNROLL][VE], vf[UNROLL][VE];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      unpack(slot[u * 32 + lane], kf[u]);
      unpack(slot[(UNROLL + u) * 32 + lane], vf[u]);
    }
    __syncwarp();   // the stage is read before it is loaded again

    const int p0 = start + (warp + i * WARPS) * chunk + seg;
    float s[GT][UNROLL];
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < VE; ++e) x = fmaf(qr[g][e], kf[u][e], x);
        s[g][u] = x;
      }
    // sum over the lpp lanes of each position slot (a tree over the slot
    // padded with zeros to a power of two), then broadcast from its head
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      if (off < lpp) {
#pragma unroll
        for (int g = 0; g < GT; ++g)
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const float y = __shfl_down_sync(0xffffffffu, s[g][u], off);
            if (rel + off < lpp) s[g][u] += y;
          }
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        s[g][u] = __shfl_sync(0xffffffffu, s[g][u], seg * lpp);

#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (active && p0 + u * ppw < end) mx = fmaxf(mx, s[g][u]);
      const float alpha = expf(m[g] - mx);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (active && p0 + u * ppw < end) {
          const float p = expf(s[g][u] - mx);
          l[g] += p;
#pragma unroll
          for (int e = 0; e < VE; ++e)
            acc[g][e] = fmaf(p, vf[u][e], acc[g][e]);
        }
      }
      m[g] = mx;
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the ring

  const int n_subs = WARPS * ppw;
  if (active) {
    const int sub = warp * ppw + seg;
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g < G) {
#pragma unroll
        for (int e = 0; e < VE; ++e)
          sm_acc[(sub * G + g) * D + d0 + e] = acc[g][e];
        if (rel == 0) {
          sm_m[sub * GT + g] = m[g];
          sm_l[sub * GT + g] = l[g];
        }
      }
    }
  }
  __syncthreads();

  // the split's (o, lse): each state rescaled to the split's m_safe, as
  // _dec_kernel takes every exponent against it
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int g = i / D, d = i - g * D;
    float mx = NEG_INF;
    for (int w = 0; w < n_subs; ++w) mx = fmaxf(mx, sm_m[w * GT + g]);
    const float m_safe = fmaxf(mx, NEG_INF / 2);
    float lt = 0.f, at = 0.f;
    for (int w = 0; w < n_subs; ++w) {
      const float c = expf(sm_m[w * GT + g] - m_safe);
      lt = fmaf(sm_l[w * GT + g], c, lt);
      at = fmaf(sm_acc[(w * G + g) * D + d], c, at);
    }
    const float o_split = at / fmaxf(lt, 1e-30f);
    const float lse_split = lt > 0.f ? logf(lt) + m_safe : NEG_INF;
    if constexpr (MODE == WHOLE) {   // one split's combine is the identity
      store(static_cast<TQ*>(a.out) + (long long)bkv * G * D + i, o_split);
    } else if constexpr (MODE == CLUSTER) {
      sm_o[i] = o_split;
      if (d == 0) sm_lse[g] = lse_split;
    } else {
      const long long row = ((long long)bkv * n_splits + split) * G + g;
      static_cast<float*>(a.out)[row * D + d] = o_split;
      if (d == 0) a.lse[row] = lse_split;
    }
  }

  if constexpr (MODE == CLUSTER) {
    // the cluster is this (b, kv head)'s n_splits CTAs; rank r holds
    // split r
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int rank = (int)cluster.block_rank();
    TQ* op = static_cast<TQ*>(a.out) + (long long)bkv * G * D;
    for (int i = rank * THREADS + threadIdx.x; i < G * D;
         i += n_splits * THREADS) {
      const int g = i / D;
      float mx = *cluster.map_shared_rank(&sm_lse[g], 0);
      for (int r = 1; r < n_splits; ++r)
        mx = fmaxf(mx, *cluster.map_shared_rank(&sm_lse[g], r));
      float num = 0.f, den = 0.f;
      for (int r = 0; r < n_splits; ++r) {
        const float w = expf(*cluster.map_shared_rank(&sm_lse[g], r) - mx);
        num = fmaf(*cluster.map_shared_rank(&sm_o[i], r), w, num);
        den += w;
      }
      store(op + i, num / den);
    }
    cluster.sync();   // no CTA leaves while another reads its shared memory
  }
}

template <typename TQ, typename TKV, int GT, int MODE>
int launch(const void* q, const void* k, const void* v, const Args& a,
           int BKV, int n_splits, cudaStream_t stream) {
  auto kernel = decode_kernel<TQ, TKV, GT, MODE>;
  constexpr int smem = smem_bytes<TKV, GT>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_splits, BKV);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = MODE == CLUSTER ? 1 : 0;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TQ*>(q),
      static_cast<const TKV*>(k), static_cast<const TKV*>(v), a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, int MODE>
int dispatch_g(const void* q, const void* k, const void* v, const Args& a,
               int BKV, int n_splits, cudaStream_t s) {
  if (a.G == 1) return launch<TQ, TKV, 1, MODE>(q, k, v, a, BKV, n_splits, s);
  if (a.G == 2) return launch<TQ, TKV, 2, MODE>(q, k, v, a, BKV, n_splits, s);
  if (a.G <= 4) return launch<TQ, TKV, 4, MODE>(q, k, v, a, BKV, n_splits, s);
  return launch<TQ, TKV, GMAX, MODE>(q, k, v, a, BKV, n_splits, s);
}

template <int MODE>
int forward(const void* q, const void* k, const void* v, const Args& a,
            int q_bf16, int kv_bf16, int B, int n_splits, void* stream) {
  if (a.D <= 0 || a.D > DMAX || a.D % 8 != 0 || a.G <= 0 || a.G > GMAX ||
      n_splits <= 0 || (long long)B * a.KV > 65535 || (q_bf16 && !kv_bf16))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || a.KV == 0) return 0;
  const int BKV = B * a.KV;
  auto s = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return dispatch_g<__nv_bfloat16, __nv_bfloat16, MODE>(q, k, v, a, BKV,
                                                           n_splits, s);
  if (kv_bf16)
    return dispatch_g<float, __nv_bfloat16, MODE>(q, k, v, a, BKV, n_splits,
                                                   s);
  return dispatch_g<float, float, MODE>(q, k, v, a, BKV, n_splits, s);
}

}  // namespace

extern "C" {

// q: (B * KV, G, D) contiguous; k, v: (B, S, KV, D) with unit stride along
// D, the other strides (strides[6] = k b/s/h, v b/s/h, in elements) and the
// pointers on 16-byte boundaries; kv_len: (B,) int32.  Writes
// o: (B * KV, n_splits, G, D) and lse: (B * KV, n_splits, G), fp32,
// contiguous.  q_bf16 / kv_bf16 select bfloat16 (1) or float32 (0).
// A bfloat16 q against float32 k/v is not built.
// Returns the CUDA error of the launch (0 on success).
int dec_forward(const void* q, const void* k, const void* v,
                const int* kv_len, void* o, void* lse, int q_bf16,
                int kv_bf16, int B, int KV, int G, int S, int D,
                int n_splits, const long long* strides, float scale,
                void* stream) {
  if (n_splits <= 0 || S % n_splits != 0) return (int)cudaErrorInvalidValue;
  Args a{kv_len, 0, o, static_cast<float*>(lse), KV, G, S, D, S / n_splits,
         strides[0], strides[1], strides[2], strides[3], strides[4],
         strides[5], scale};
  return forward<PARTIALS>(q, k, v, a, q_bf16, kv_bf16, B, n_splits,
                           stream);
}

// The same inputs; kv_len may be null, and then every row's valid length is
// kv_fixed.  The valid prefix is cut into n_splits (1..8) even pieces, one
// CTA each, merged inside the launch into out: (B, KV * G, D) = (B, H, D),
// contiguous, in q's dtype.  A row with no valid position gives zeros.
int dec_forward_fused(const void* q, const void* k, const void* v,
                      const int* kv_len, int kv_fixed, void* out, int q_bf16,
                      int kv_bf16, int B, int KV, int G, int S, int D,
                      int n_splits, const long long* strides, float scale,
                      void* stream) {
  if (n_splits > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  Args a{kv_len, kv_fixed, out, nullptr, KV, G, S, D, 0,
         strides[0], strides[1], strides[2], strides[3], strides[4],
         strides[5], scale};
  if (n_splits == 1)
    return forward<WHOLE>(q, k, v, a, q_bf16, kv_bf16, B, 1, stream);
  return forward<CLUSTER>(q, k, v, a, q_bf16, kv_bf16, B, n_splits, stream);
}

}  // extern "C"
