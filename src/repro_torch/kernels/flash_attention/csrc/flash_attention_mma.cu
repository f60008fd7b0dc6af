// Flash attention forward on the tensor cores for Hopper (sm_90a), bf16 q
// against a bf16 K/V, plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// ::_fa_kernel for the bf16 pair, the only one the bf16 LM path makes
// (models/layers.py): online-softmax attention with the running max, sum and
// accumulator in fp32, the -1e30 sentinel for masked scores, causal tiles
// past the CTA's last query row skipped, and the output in bf16.  Query row
// i sits at key position i + q_offset (a prompt chunk prefilled into a
// cache), as in repro.models.layers.mha(q_offset=).  Float32 queries go to
// flash_attention_3xtf32.cu, where the 1e-5 tolerance of the fp32 path
// holds.
//
// What bounds it on this card: operations.  At the LM prefill shape
// (B x H = 128, Sq = 2048, Sk = 2560, D = 80, causal) the causal mask keeps
// ~86 GFLOP against ~170 MB of Q, K, V and O: 0.087 ms at the 989 TFLOP/s
// bf16 tensor-core peak, 0.05 ms at 3.35 TB/s.  The SIMT kernel did both
// products with fmaf on the fp32 pipes at ~9 TFLOP/s.
//
// What the design does about it:
//  * both products on the tensor cores, bf16 in and fp32 accumulate, with
//    mma.sync.m16n8k16 fed by ldmatrix (the FlashAttention-2 shape): Q.K^T
//    takes K rows as the col-major B operand as they lie, P.V loads V with
//    ldmatrix.trans; P goes from the score accumulators straight into the
//    A operand in registers, rounded to bf16 (as the plain path's
//    softmax(...).to(q.dtype) does), and never touches shared memory;
//  * 128 query rows per CTA, 16 per warp (8 warps); key tiles of 64; Q
//    stays in shared memory and its fragments are loaded per k step, so
//    D = 80 fits the 128 registers of two CTAs per SM without spilling;
//  * K/V tiles go through a 2-stage ring in shared memory loaded with
//    16-byte cp.async, so the next tile's copy is in flight while the
//    current one is computed;
//  * rows are padded in shared memory to the head dim rounded up to 16,
//    plus 8 bf16 (16 bytes), so a D = 80 row is 176 bytes: the 8 row
//    addresses of an ldmatrix fall in distinct banks, and the padding past
//    D is zero-filled by the copy itself (cp.async with 0 source bytes);
//  * S is scaled in fp32 after the product, with log2(e) folded into the
//    scale for exp2f; the causal mask is applied only on the tiles that
//    cross a warp's diagonal or the ragged Sk edge, and a warp skips the
//    tiles wholly above its rows;
//  * causal CTAs start heaviest first (the q tile index runs backwards in
//    the slow grid dimension), so the grid's tail is made of short CTAs;
//  * GQA: query head h reads KV head h / G through the strides it is given,
//    and the cache is read in place, (B, S, KV, D), no copy or transpose;
//  * any D <= 128 that is a multiple of 8 (padded to 16 in shared memory);
//    ragged Sq and Sk edges are masked here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

constexpr int PAD = 8;             // bf16 elements of padding per smem row

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b, a 16 x 16 (row), b 16 x 8 (col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, DP <= 80 ? 2 : 1)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                     int G, int Sq, int Sk, int D, Strides st, int causal,
                     int q_offset, float scale_log2) {
  constexpr int LD = DP + PAD;
  constexpr int KSTEPS = DP / 16;   // k steps of Q.K^T
  constexpr int NT = BK / 8;        // 8-key column tiles of S
  constexpr int DT = DP / 8;        // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // BQ x LD
  bf16* Ks = Qs + BQ * LD;                        // 2 stages of BK x LD
  bf16* Vs = Ks + 2 * BK * LD;                    // 2 stages of BK x LD

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

  const bf16* qp = q + b * st.qb + h * st.qh;
  const bf16* kp = k + b * st.kb + kvh * st.kh;
  const bf16* vp = v + b * st.vb + kvh * st.vh;
  bf16* op = o + b * st.ob + h * st.oh;

  // keys past the CTA's last query position are masked for every row it
  // owns, so a causal CTA stops there
  const int q_end = min(q0 + BQ, Sq);
  const int k_end = causal ? min(Sk, q_end + q_offset) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;

  load_tile<bf16, DP, LD>(Qs, qp, st.qs, q0, Sq, BQ, D);
  load_tile<bf16, DP, LD>(Ks, kp, st.ks, 0, Sk, BK, D);
  load_tile<bf16, DP, LD>(Vs, vp, st.vs, 0, Sk, BK, D);
  cp_async_commit();

  const int w0 = q0 + 16 * warp;    // the warp's first query row
  const int pos0 = w0 + q_offset;   // and its key position
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // rows g and g + 8, log2 domain
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      const int nxt = stage ^ 1;
      load_tile<bf16, DP, LD>(Ks + nxt * BK * LD, kp, st.ks, (it + 1) * BK,
                              Sk, BK, D);
      load_tile<bf16, DP, LD>(Vs + nxt * BK * LD, vp, st.vs, (it + 1) * BK,
                              Sk, BK, D);
    }
    cp_async_commit();
    cp_async_wait<1>();   // Q and tile it have landed; tile it + 1 flies
    __syncthreads();

    const int k0 = it * BK;
    // warp-uniform: a warp past Sq, or wholly above this tile, skips it
    if (w0 < Sq && !(causal && k0 > pos0 + 15)) {
      const bf16* Kt = Ks + stage * BK * LD;
      const bf16* Vt = Vs + stage * BK * LD;
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t qa[4];
        ldmatrix_x4(qa, smem_u32(Qs + (16 * warp + (lane & 15)) * LD +
                                 kk * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          uint32_t bk[4];
          ldmatrix_x4(bk, smem_u32(Kt + (16 * j + (lane & 7) +
                                         ((lane >> 4) << 3)) * LD +
                                   kk * 16 + ((lane >> 3) & 1) * 8));
          mma_bf16(s[2 * j], qa, bk[0], bk[1]);
          mma_bf16(s[2 * j + 1], qa, bk[2], bk[3]);
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
          const float p0 = exp2f(s[j][2 * r] - mx);
          const float p1 = exp2f(s[j][2 * r + 1] - mx);
          s[j][2 * r] = p0;
          s[j][2 * r + 1] = p1;
          rs += p0 + p1;
        }
        l[r] = l[r] * alpha + rs;
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          acc[j][2 * r] *= alpha;
          acc[j][2 * r + 1] *= alpha;
        }
      }

#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dj = 0; dj < DT / 2; ++dj) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, smem_u32(Vt + (16 * kk + (lane & 7) +
                                               (((lane >> 3) & 1) << 3)) *
                                                  LD +
                                         16 * dj + ((lane >> 4) << 3)));
          mma_bf16(acc[2 * dj], pa, bv[0], bv[1]);
          mma_bf16(acc[2 * dj + 1], pa, bv[2], bv[3]);
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
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row >= Sq) continue;
    bf16* orow = op + row * st.os;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int c = 8 * j + 2 * t;
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
            acc[j][2 * r] / l[r], acc[j][2 * r + 1] / l[r]);
    }
  }
}

template <int DP>
int launch(const Problem& p) {
  auto kernel = flash_fwd_mma_kernel<DP>;
  const int smem = (int)sizeof(bf16) * (BQ + 4 * BK) * (DP + PAD);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(p.B * p.H, (p.Sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, p.stream>>>(
      static_cast<const bf16*>(p.q), static_cast<const bf16*>(p.k),
      static_cast<const bf16*>(p.v), static_cast<bf16*>(p.o), p.H,
      p.H / p.KV, p.Sq, p.Sk, p.D, p.st, p.causal, p.q_offset,
      p.scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: (B, Sq, H, D) bf16; k, v: (B, Sk, KV, D) bf16; any strides with unit
// stride along D, every other stride a multiple of 8 elements and every
// pointer 16-byte aligned (strides[12] = q b/s/h, k b/s/h, v b/s/h,
// o b/s/h, in elements); q row i at key position i + q_offset >= 0.
// Returns the CUDA error of the launch (0 on success).
int fa_forward_mma(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int Sq, int Sk, int D,
                   const long long* strides, int causal, int q_offset,
                   float scale, void* stream) {
  const Problem p = make_problem(q, k, v, o, B, H, KV, Sq, Sk, D, strides,
                                 causal, q_offset, scale, stream);
  if (const int err = check(p)) return err;
  if (B == 0 || Sq == 0) return 0;
  return dispatch_head_dim(
      D, [&](auto dp) { return launch<decltype(dp)::value>(p); });
}

}  // extern "C"
