// Flash attention forward on the fp32 SIMT pipes for Hopper (sm_90a), for a
// float32 q, plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// ::_fa_kernel for the pairs with a float32 q: float32 K/V, or a bfloat16
// cache.  Block-tiled online-softmax attention with the running max, sum
// and accumulator in fp32, causal tiles above the diagonal skipped, the
// -1e30 sentinel for masked scores, and the output written in fp32.  The
// bf16 pair runs on the tensor cores (flash_attention_mma.cu); fp32 stays
// here because TF32 products could not hold the fp32 path's 1e-5.
//
// What bounds it on this card: operations.  At the LM prefill shape
// (BH = 128, Sq = 2048, Sk = 2560, D = 80, causal) the mask keeps ~86 GFLOP
// against ~340 MB of fp32 Q, K, V and O: 1.3 ms at the 67 TFLOP/s fp32
// peak outside the tensor cores, 0.1 ms at 3.35 TB/s.
//
// What the design does about it:
//  * one CTA of 256 threads per (64-query tile, batch x head); K/V tiles of
//    64 keys are staged in shared memory as fp32 (rows padded to D + 1
//    floats, so the 16 rows a warp reads in one step fall in distinct
//    banks); each thread owns a 4 x 4 block of scores and 4 rows x
//    ceil(D / 16) columns of the accumulator in registers;
//  * Q is scaled once on load; the P tile goes through shared memory into
//    the P.V product;
//  * the causal loop stops at the CTA's last query row, so the unfilled
//    tail of a serving cache is never read;
//  * GQA: query head h reads KV head h / G through the strides it is given,
//    so no repeated or transposed copy of K/V is ever made;
//  * any D <= 128 that is a multiple of 8; ragged Sq and Sk edges are
//    masked here, not asserted away;
//  * expf and IEEE division (no fast math), so fp32 results stay within
//    1e-5 of the plain PyTorch version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;             // query rows per CTA
constexpr int BK = 64;             // keys per tile
constexpr int TX = 16;             // threads along keys / head dim
constexpr int TY = 16;             // threads along query rows
constexpr int THREADS = TX * TY;   // 256
constexpr int RQ = BQ / TY;        // query rows per thread
constexpr int RK = BK / TX;        // keys per thread
constexpr int DMAX = 128;
constexpr int DJ = DMAX / TX;      // accumulator columns per thread, at most
constexpr int PLD = BK + 1;        // padded row of the P tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// element strides of q/o (b, s, h) and k/v (b, s, kv head); d is unit stride
struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + 1) + (size_t)BQ * PLD);
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                 const TKV* __restrict__ v, TQ* __restrict__ o, int H, int G,
                 int Sq, int Sk, int D, Strides st, int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;              // BQ x ld, scaled
  float* Ks = Qs + BQ * ld;      // BK x ld
  float* Vs = Ks + BK * ld;      // BK x ld
  float* Ps = Vs + BK * ld;      // BQ x PLD

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / G;

  const TQ* qp = q + b * st.qb + h * st.qh;
  const TKV* kp = k + b * st.kb + kvh * st.kh;
  const TKV* vp = v + b * st.vb + kvh * st.vh;
  TQ* op = o + b * st.ob + h * st.oh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i - r * D;
    const int qi = q0 + r;
    Qs[r * ld + c] = qi < Sq ? to_f(qp[qi * st.qs + c]) * scale : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][DJ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // keys at or past the CTA's last query row are masked for every row it
  // owns, so a causal CTA stops there
  const int q_end = min(q0 + BQ, Sq);
  const int k_end = causal ? min(Sk, q_end) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // the previous tile's Ks, Vs and Ps are consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i - r * D;
      const int kj = k0 + r;
      const bool ok = kj < Sk;
      Ks[r * ld + c] = ok ? to_f(kp[kj * st.ks + c]) : 0.f;
      Vs[r * ld + c] = ok ? to_f(vp[kj * st.vs + c]) : 0.f;
    }
    __syncthreads();

    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
    for (int c = 0; c < D; ++c) {
      float a[RQ], bk[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = Qs[(ty + TY * i) * ld + c];
#pragma unroll
      for (int j = 0; j < RK; ++j) bk[j] = Ks[(tx + TX * j) * ld + c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qpos = q0 + ty + TY * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int kpos = k0 + tx + TX * j;
        if (kpos >= Sk || (causal && kpos > qpos)) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are 16 aligned lanes of one warp
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + TY * i) * PLD + tx + TX * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float p[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) p[i] = Ps[(ty + TY * i) * PLD + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int c = tx + TX * j;
        if (c < D) {
          const float vv = Vs[kk * ld + c];
#pragma unroll
          for (int i = 0; i < RQ; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q0 + ty + TY * i;
    if (qi >= Sq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + TX * j;
      if (c < D) store(op + qi * st.os + c, acc[i][j] / l[i]);
    }
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int Sq, int Sk, int D, const Strides& st,
           int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<TQ, TKV>;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<TQ*>(o), H, H / KV, Sq, Sk, D,
      st, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: (B, Sq, H, D) float32; k, v: (B, Sk, KV, D), any strides with unit
// stride along D (strides[12] = q b/s/h, k b/s/h, v b/s/h, o b/s/h, in
// elements).  kv_bf16 selects a bfloat16 (1) or float32 (0) K/V.  A
// bfloat16 q is not built here: fa_forward_mma takes the bf16 pair.
// Returns the CUDA error of the launch (0 on success).
int fa_forward(const void* q, const void* k, const void* v, void* o,
               int kv_bf16, int B, int H, int KV, int Sq, int Sk,
               int D, const long long* strides, int causal, float scale,
               void* stream) {
  if (D <= 0 || D > DMAX || D % 8 != 0 || KV <= 0 || H % KV != 0 ||
      Sk <= 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  Strides st{strides[0], strides[1], strides[2], strides[3],
             strides[4], strides[5], strides[6], strides[7],
             strides[8], strides[9], strides[10], strides[11]};
  auto s = static_cast<cudaStream_t>(stream);
  if (kv_bf16)
    return launch<float, __nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Sk, D, st,
                                        causal, scale, s);
  return launch<float, float>(q, k, v, o, B, H, KV, Sq, Sk, D, st, causal,
                              scale, s);
}

}  // extern "C"
