// Flash attention forward for a float32 q on Hopper (sm_90a), with both
// products on the tf32 tensor cores at float32 accuracy ("3xTF32"), plain C
// interface.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// ::_fa_kernel for the pairs with a float32 q: float32 K/V, or a bfloat16
// cache (the pair the LM's float32 run makes).  Online-softmax attention
// with the scale applied in fp32 after the product, the running max, sum and
// accumulator in fp32, the -1e30 sentinel for masked scores, exp2f with
// log2(e) folded into the scale, IEEE division, no fast math, and the
// output in fp32.  Query row i sits at key position i + q_offset (a prompt
// chunk prefilled into a cache), as in repro.models.layers.mha(q_offset=).
// The bf16 pair runs in flash_attention_mma.cu.
//
// What bounds it on this card: operations.  At the LM prefill shape
// (B x H = 128, Sq = 2048, Sk = 2560, D = 80, causal) the mask keeps
// ~86 GFLOP.  On the fp32 pipes that is 1.28 ms at 67 TFLOP/s; the SIMT
// kernel this file replaces reached ~9 TFLOP/s there.  A tf32 product keeps
// 11 significant bits, too few for the 1e-5 the fp32 path is held to, so
// each fp32 operand x is split into big = tf32(x) and small =
// tf32(x - big), and a product is small.big + big.small + big.big in fp32
// (the small.small term, ~2^-22 of it, is dropped).  A bf16 operand is
// exact in tf32 (its small part is 0), so against a bf16 cache each product
// is 2 mma, not 3: 2 x 86 GFLOP at 494.7 TFLOP/s dense is 0.35 ms, 3 x 86
// is 0.52 ms for float32 K/V.
//
// What the design does about it (the structure of flash_attention_mma.cu):
//  * mma.sync.m16n8k8 tf32 with fp32 accumulate for Q.K^T and P.V; 128
//    query rows per CTA, 16 per warp (8 warps); key tiles of 64; the K/V
//    tiles go through a 2-stage ring in shared memory loaded with 16-byte
//    cp.async, so the next tile's copy flies while this one is computed;
//    Q stays in shared memory and is split again at each k step;
//  * the tensor core's accumulate does not round to nearest, and P.V adds
//    hundreds of key steps into each output element, so each 8-key step's
//    products are summed in zeroed registers and added to the accumulator
//    with a round-to-nearest add (mma_3x_add), which takes away most of
//    the error's drift toward zero; Q.K^T sums only D / 8 steps into a
//    fresh tile and keeps the tensor core's accumulate (zeroed registers
//    there too halve the error again, for ~8% more time with a bf16
//    cache and spills with float32 K/V: scripts/flash_fp32_accuracy.py);
//  * ldmatrix moves 16-bit elements only, so fragments are read with plain
//    shared-memory loads, vectorised by permuting the summed index: in
//    Q.K^T a thread's k indices t and t + 4 of two k steps are the head-dim
//    columns 4t .. 4t + 3 (one 16-byte load of Q per row, one 16- or 8-byte
//    load of K); in P.V k index t and t + 4 are keys 2t and 2t + 1, so P
//    goes from the score accumulators straight into the A operand, and two
//    n tiles take the head-dim columns 2g and 2g + 1 (one 8- or 4-byte load
//    of V per row), which leaves each thread 4 adjacent output columns;
//  * row pitches make every one of those loads free of bank conflicts:
//    Q and K rows of DP (the head dim rounded up to 16) elements padded to
//    16 mod 32 elements, V rows of DP + 4 floats or DP + 8 bf16; the padding
//    past D is zero-filled by the copy itself (cp.async of 0 source bytes);
//  * the causal mask is applied only on the tiles that cross a warp's
//    diagonal or the ragged Sk edge, a warp skips the tiles wholly above its
//    rows, a causal CTA stops at its last query's position, and causal CTAs
//    start heaviest first, so the grid's tail is made of short CTAs;
//  * GQA: query head h reads KV head h / G through the strides it is given,
//    and the cache is read in place, (B, S, KV, D), no copy or transpose;
//  * any D <= 128 that is a multiple of 8; ragged Sq and Sk edges are
//    masked here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

// c += a . b, a 16 x 8 (row), b 8 x 8 (col), tf32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small + O(2^-22 x), both parts tf32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// bf16 -> its fp32 (and tf32) bit pattern: the low and high halves of a word
__device__ __forceinline__ uint32_t lo_bf16(uint32_t w) { return w << 16; }
__device__ __forceinline__ uint32_t hi_bf16(uint32_t w) {
  return w & 0xffff0000u;
}

// b += a_big.b_small + a_small.b_big + a_big.b_big; a bf16 operand is exact
// in tf32, so its small part is 0 and its term is left out
template <bool B_EXACT>
__device__ __forceinline__ void mma_3x(float (&c)[4], const uint32_t (&ab)[4],
                                       const uint32_t (&as)[4], uint32_t b0,
                                       uint32_t b1) {
  if (B_EXACT) {
    mma_tf32(c, as, b0, b1);
    mma_tf32(c, ab, b0, b1);
  } else {
    uint32_t b0b, b0s, b1b, b1s;
    split(__uint_as_float(b0), b0b, b0s);
    split(__uint_as_float(b1), b1b, b1s);
    mma_tf32(c, as, b0b, b1b);
    mma_tf32(c, ab, b0s, b1s);
    mma_tf32(c, ab, b0b, b1b);
  }
}

// c += a.b as mma_3x computes it, but in zeroed registers that are then
// added to c with a round-to-nearest add: the tensor core's own accumulate
// does not round to nearest, and over the hundreds of key steps of a long
// row its errors pile up in one direction
template <bool B_EXACT>
__device__ __forceinline__ void mma_3x_add(float (&c)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           uint32_t b0, uint32_t b1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_3x<B_EXACT>(t, ab, as, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = __fadd_rn(c[e], t[e]);
}

// shared-memory row pitches (elements) for a head dim padded to DP
template <int DP, typename TKV>
struct Pitch {
  // Q and K: 16- (fp32) or 8-byte (bf16) loads at column 4t of row g
  static constexpr int QK = DP % 32 == 16 ? DP : DP + 16;
  // V: 8- (fp32) or 4-byte (bf16) loads at column 2g of row 2t
  static constexpr int V = sizeof(TKV) == 2 ? DP + 8 : DP + 4;
  static constexpr int SMEM =
      (int)sizeof(float) * BQ * QK + (int)sizeof(TKV) * 2 * BK * (QK + V);
};

template <int DP, typename TKV>
__global__ void __launch_bounds__(THREADS,
                                  (sizeof(TKV) == 2 && DP <= 80) ? 2 : 1)
flash_fwd_3xtf32_kernel(const float* __restrict__ q,
                        const TKV* __restrict__ k, const TKV* __restrict__ v,
                        float* __restrict__ o, int H, int G, int Sq, int Sk,
                        int D, Strides st, int causal, int q_offset,
                        float scale_log2) {
  constexpr bool KV16 = sizeof(TKV) == 2;
  constexpr int LDQ = Pitch<DP, TKV>::QK;
  constexpr int LDK = Pitch<DP, TKV>::QK;
  constexpr int LDV = Pitch<DP, TKV>::V;
  constexpr int KB = DP / 16;       // 16-column blocks of the head dim
  constexpr int NT = BK / 8;        // 8-key column tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);        // BQ x LDQ
  TKV* Ks = reinterpret_cast<TKV*>(Qs + BQ * LDQ);       // 2 x BK x LDK
  TKV* Vs = Ks + 2 * BK * LDK;                           // 2 x BK x LDV

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;          // row of the mma fragments
  const int t = lane & 3;           // column pair of the mma fragments
  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / G;

  const float* qp = q + b * st.qb + h * st.qh;
  const TKV* kp = k + b * st.kb + kvh * st.kh;
  const TKV* vp = v + b * st.vb + kvh * st.vh;
  float* op = o + b * st.ob + h * st.oh;

  // keys past the CTA's last query position are masked for every row it
  // owns, so a causal CTA stops there
  const int q_end = min(q0 + BQ, Sq);
  const int k_end = causal ? min(Sk, q_end + q_offset) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;

  load_tile<float, DP, LDQ>(Qs, qp, st.qs, q0, Sq, BQ, D);
  load_tile<TKV, DP, LDK>(Ks, kp, st.ks, 0, Sk, BK, D);
  load_tile<TKV, DP, LDV>(Vs, vp, st.vs, 0, Sk, BK, D);
  cp_async_commit();

  const int w0 = q0 + 16 * warp;    // the warp's first query row
  const int pos0 = w0 + q_offset;   // and its key position
  float acc[2 * KB][4];             // O: n tiles 2nb, 2nb + 1 per block nb
#pragma unroll
  for (int j = 0; j < 2 * KB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // rows g and g + 8, log2 domain
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      const int nxt = stage ^ 1;
      load_tile<TKV, DP, LDK>(Ks + nxt * BK * LDK, kp, st.ks, (it + 1) * BK,
                              Sk, BK, D);
      load_tile<TKV, DP, LDV>(Vs + nxt * BK * LDV, vp, st.vs, (it + 1) * BK,
                              Sk, BK, D);
    }
    cp_async_commit();
    cp_async_wait<1>();   // Q and tile it have landed; tile it + 1 flies
    __syncthreads();

    const int k0 = it * BK;
    // warp-uniform: a warp past Sq, or wholly above this tile, skips it
    if (w0 < Sq && !(causal && k0 > pos0 + 15)) {
      const TKV* Kt = Ks + stage * BK * LDK;
      const TKV* Vt = Vs + stage * BK * LDV;
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;

      // S = Q.K^T.  In head-dim block kb, k step u's index t is column
      // 16kb + 4t + 2u and its index t + 4 the column after it.
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        const float4 qg = *reinterpret_cast<const float4*>(
            Qs + (16 * warp + g) * LDQ + 16 * kb + 4 * t);
        const float4 qh = *reinterpret_cast<const float4*>(
            Qs + (16 * warp + g + 8) * LDQ + 16 * kb + 4 * t);
        uint32_t ab[2][4], as[2][4];   // a0..a3: (g, t) (g+8, t) (g, t+4) ..
        split(qg.x, ab[0][0], as[0][0]);
        split(qh.x, ab[0][1], as[0][1]);
        split(qg.y, ab[0][2], as[0][2]);
        split(qh.y, ab[0][3], as[0][3]);
        split(qg.z, ab[1][0], as[1][0]);
        split(qh.z, ab[1][1], as[1][1]);
        split(qg.w, ab[1][2], as[1][2]);
        split(qh.w, ab[1][3], as[1][3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const TKV* kr = Kt + (8 * j + g) * LDK + 16 * kb + 4 * t;
          uint32_t kx[4];
          if (KV16) {
            const uint2 w = *reinterpret_cast<const uint2*>(kr);
            kx[0] = lo_bf16(w.x);
            kx[1] = hi_bf16(w.x);
            kx[2] = lo_bf16(w.y);
            kx[3] = hi_bf16(w.y);
          } else {
            const uint4 w = *reinterpret_cast<const uint4*>(kr);
            kx[0] = w.x;
            kx[1] = w.y;
            kx[2] = w.z;
            kx[3] = w.w;
          }
          mma_3x<KV16>(s[j], ab[0], as[0], kx[0], kx[1]);
          mma_3x<KV16>(s[j], ab[1], as[1], kx[2], kx[3]);
        }
      }

      const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > pos0);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (edge) {
            const int kpos = k0 + 8 * j + 2 * t + (e & 1);
            const int qpos = pos0 + g + 8 * (e >> 1);
            if (kpos >= Sk || (causal && kpos > qpos)) x = NEG_INF;
          }
          s[j][e] = x;
        }

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        // the 4 threads of a row are lanes 4g .. 4g + 3
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = exp2f(m[r] - mx);
        m[r] = mx;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float e0 = exp2f(s[j][2 * r] - mx);
          const float e1 = exp2f(s[j][2 * r + 1] - mx);
          s[j][2 * r] = e0;
          s[j][2 * r + 1] = e1;
          rs += e0 + e1;
        }
        l[r] = l[r] * alpha + rs;
#pragma unroll
        for (int j = 0; j < 2 * KB; ++j) {
          acc[j][2 * r] *= alpha;
          acc[j][2 * r + 1] *= alpha;
        }
      }

      // O += P.V.  In key tile j, k index t is key 8j + 2t and t + 4 the
      // key after it, which is where the S accumulators hold P; n tile 2nb
      // is head-dim column 16nb + 2g, n tile 2nb + 1 the column after it.
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t pb[4], ps[4];
        split(s[j][0], pb[0], ps[0]);
        split(s[j][2], pb[1], ps[1]);
        split(s[j][1], pb[2], ps[2]);
        split(s[j][3], pb[3], ps[3]);
        const TKV* v0 = Vt + (8 * j + 2 * t) * LDV + 2 * g;
        const TKV* v1 = v0 + LDV;
#pragma unroll
        for (int nb = 0; nb < KB; ++nb) {
          uint32_t a0, a1, b0, b1;   // rows 2t, 2t + 1; columns 2g, 2g + 1
          if (KV16) {
            const uint32_t w0v = *reinterpret_cast<const uint32_t*>(v0 + 16 * nb);
            const uint32_t w1v = *reinterpret_cast<const uint32_t*>(v1 + 16 * nb);
            a0 = lo_bf16(w0v);
            b0 = hi_bf16(w0v);
            a1 = lo_bf16(w1v);
            b1 = hi_bf16(w1v);
          } else {
            const uint2 w0v = *reinterpret_cast<const uint2*>(v0 + 16 * nb);
            const uint2 w1v = *reinterpret_cast<const uint2*>(v1 + 16 * nb);
            a0 = w0v.x;
            b0 = w0v.y;
            a1 = w1v.x;
            b1 = w1v.y;
          }
          mma_3x_add<KV16>(acc[2 * nb], pb, ps, a0, a1);
          mma_3x_add<KV16>(acc[2 * nb + 1], pb, ps, b0, b1);
        }
      }
    }
    __syncthreads();   // the stage is consumed before it is loaded again
  }

  if (w0 >= Sq) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // the thread holds columns 16nb + 4t .. 16nb + 4t + 3 of rows g, g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row >= Sq) continue;
    float* orow = op + row * st.os;
#pragma unroll
    for (int nb = 0; nb < KB; ++nb) {
      const int c = 16 * nb + 4 * t;
      if (c < D)
        *reinterpret_cast<float4*>(orow + c) = make_float4(
            acc[2 * nb][2 * r] / l[r], acc[2 * nb + 1][2 * r] / l[r],
            acc[2 * nb][2 * r + 1] / l[r], acc[2 * nb + 1][2 * r + 1] / l[r]);
    }
  }
}

template <int DP, typename TKV>
int launch(const Problem& p) {
  auto kernel = flash_fwd_3xtf32_kernel<DP, TKV>;
  const int smem = Pitch<DP, TKV>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(p.B * p.H, (p.Sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, p.stream>>>(
      static_cast<const float*>(p.q), static_cast<const TKV*>(p.k),
      static_cast<const TKV*>(p.v), static_cast<float*>(p.o), p.H,
      p.H / p.KV, p.Sq, p.Sk, p.D, p.st, p.causal, p.q_offset,
      p.scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: (B, Sq, H, D) float32; k, v: (B, Sk, KV, D), float32 (kv_bf16 = 0)
// or bfloat16 (kv_bf16 = 1); any strides with unit stride along D, every
// other stride a multiple of 16 bytes and every pointer 16-byte aligned
// (strides[12] = q b/s/h, k b/s/h, v b/s/h, o b/s/h, in elements); q row i
// at key position i + q_offset >= 0.  Returns the CUDA error of the launch
// (0 on success).
int fa_forward_3xtf32(const void* q, const void* k, const void* v, void* o,
                      int kv_bf16, int B, int H, int KV, int Sq, int Sk,
                      int D, const long long* strides, int causal,
                      int q_offset, float scale, void* stream) {
  const Problem p = make_problem(q, k, v, o, B, H, KV, Sq, Sk, D, strides,
                                 causal, q_offset, scale, stream);
  if (const int err = check(p)) return err;
  if (B == 0 || Sq == 0) return 0;
  return dispatch_head_dim(D, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return kv_bf16 ? launch<DP, bf16>(p) : launch<DP, float>(p);
  });
}

}  // extern "C"
