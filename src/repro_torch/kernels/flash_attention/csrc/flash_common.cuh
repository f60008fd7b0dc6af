// Pieces shared by the flash attention kernels of this directory
// (flash_attention_mma.cu, flash_attention_3xtf32.cu): the CTA's shape, one
// call's arguments and their checks, the 16-byte cp.async tile copy, and
// the dispatch on the head dim.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;     // query rows per CTA, 16 per warp
constexpr int BK = 64;             // keys per tile
constexpr int DMAX = 128;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// element strides of q/o (b, s, h) and k/v (b, s, kv head); d is unit stride
struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

// one call's arguments, as the C entry points take them
struct Problem {
  const void *q, *k, *v;
  void* o;
  int B, H, KV, Sq, Sk, D;
  Strides st;
  int causal, q_offset;
  float scale;
  cudaStream_t stream;
};

inline Problem make_problem(const void* q, const void* k, const void* v,
                            void* o, int B, int H, int KV, int Sq, int Sk,
                            int D, const long long* s, int causal,
                            int q_offset, float scale, void* stream) {
  return Problem{q, k, v, o, B, H, KV, Sq, Sk, D,
                 Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
                         s[8], s[9], s[10], s[11]},
                 causal, q_offset, scale, static_cast<cudaStream_t>(stream)};
}

// cudaErrorInvalidValue for a call no kernel here takes, else 0
inline int check(const Problem& p) {
  if (p.D <= 0 || p.D > DMAX || p.D % 8 != 0 || p.KV <= 0 ||
      p.H % p.KV != 0 || p.Sk <= 0 || p.q_offset < 0 ||
      (p.Sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// launch(std::integral_constant<int, DP>()) for the head dim padded to 16
template <typename F>
int dispatch_head_dim(int D, F&& launch) {
  switch ((D + 15) / 16 * 16) {
    case 16: return launch(std::integral_constant<int, 16>());
    case 32: return launch(std::integral_constant<int, 32>());
    case 48: return launch(std::integral_constant<int, 48>());
    case 64: return launch(std::integral_constant<int, 64>());
    case 80: return launch(std::integral_constant<int, 80>());
    case 96: return launch(std::integral_constant<int, 96>());
    case 112: return launch(std::integral_constant<int, 112>());
    default: return launch(std::integral_constant<int, 128>());
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

// rows [row0, row0 + rows) of a (rows, D) tile with row stride rs into
// shared memory rows of LD elements, DP of them filled; rows past n_rows and
// columns past D are zero-filled by the copy itself
template <typename T, int DP, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long rs,
                                          int row0, int n_rows, int rows,
                                          int D) {
  constexpr int E = 16 / (int)sizeof(T);   // elements per 16-byte chunk
  constexpr int CPR = DP / E;              // chunks per row
  for (int i = threadIdx.x; i < rows * CPR; i += THREADS) {
    const int r = i / CPR, c = i - r * CPR;
    const int row = row0 + r;
    const bool ok = row < n_rows && c * E < D;
    const T* s = ok ? src + row * rs + c * E : src;
    cp_async16(smem_u32(dst + r * LD + c * E), s, ok ? 16 : 0);
  }
}

}  // namespace flash
