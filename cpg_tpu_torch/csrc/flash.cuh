// Shared pieces of the flash-attention kernels (K7: flash_fwd.cu,
// flash_bwd.cu).
//
// Layout: q, k, v, o, dO and the gradients are (N, T, H, hd) row-major, the
// layout models/vit.py's attention produces; element (n, t, h, d) lies at
// ((n*T + t)*H + h)*hd + d, so a block reads its (n, h) rows H*hd elements
// apart, in place. lse and D are (N, H, T) f32.
//
// Tiles: 64 rows (queries or keys) of hd values, staged in shared memory as
// [row][hd + 8] bf16 (the pad puts ldmatrix's eight 16-byte rows on
// distinct banks). Rows past T are zero-filled by cp.async and never read
// from device memory; the kernels mask their scores.
//
// bf16 products run on the tensor cores (mma.sync m16n8k16, f32
// accumulation), each warp owning 16 rows of the block's 64:
//   mma_abt: C[16 x 8*NT] += A[16 x hd] . B[8*NT x hd]^T, A and B rows in
//            shared memory (S = Q K^T, dP = dO V^T and their transposes);
//   mma_pb:  C[16 x 8*NT] += P[16 x 64] . B[64 x 8*NT], P an f32 C-fragment
//            array rounded to bf16 in registers (the stock kernel's cast of
//            p and ds to the value dtype), B rows in shared memory read
//            transposed by ldmatrix.trans (P V, dS K, P^T dO, dS^T Q).
// f32 runs exact scalar FMA kernels (the tests' dtype), one row a thread.
#pragma once

#include <cfloat>
#include <utility>

#include "common.cuh"

namespace cpg {
namespace flash {

using bf16 = __nv_bfloat16;

constexpr int BR = 64;         // rows (queries or keys) per block and tile
constexpr int NT = 128;        // bf16 kernels: 4 warps x 16 rows
constexpr int BR32 = 32;       // f32 kernels: rows per inner tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// the stock Pallas kernel's DEFAULT_MASK_VALUE: masked scores stay finite,
// so a row max is never -inf and exp2(mask - max) is exactly 0
constexpr float MASK = -0.7f * FLT_MAX;

struct Dims {
  int n, t, h, hd;
  __host__ __device__ long long row_stride() const { return (long long)h * hd; }
  // offset of (n, t = 0, h, d = 0)
  __host__ __device__ long long base(int ni, int hi) const {
    return (long long)ni * t * h * hd + (long long)hi * hd;
  }
  // offset of lse/D (n, h, t = 0)
  __host__ __device__ long long lbase(int ni, int hi) const {
    return ((long long)ni * h + hi) * t;
  }
};

template <int HD>
__host__ __device__ constexpr int ld_bf16() { return HD + 8; }

// Rows [row0, row0 + ROWS) of one (n, h) slice into smem [ROWS][HD + 8]
// by THREADS threads; rows past T are zero-filled.
template <int HD, int ROWS = BR, int THREADS = NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long rs, int row0, int t) {
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = row0 + r < t;
    cp_async16(dst + r * ld_bf16<HD>() + c,
               src + (ok ? (long long)(row0 + r) * rs : 0) + c, ok);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// C[16 x 8*NC] += A[16 x 16*KS] . B[8*NC x 16*KS]^T; `a` points at the
// warp's first A row, `b` at B's first row, both [row][k] with stride ld.
template <int KS, int NC>
__device__ __forceinline__ void mma_abt(float (&c)[NC][4], const bf16* a,
                                        const bf16* b, int ld, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a + (lane & 15) * ld + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NC / 2; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * ld +
                          kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16_16816(c[2 * np], af, &bf[0]);
      mma_bf16_16816(c[2 * np + 1], af, &bf[2]);
    }
  }
}

// The A fragments of a warp's 16 rows x 16*KS columns ([row][k], stride
// ld), kept in registers across several products (mma_abt_regs).
template <int KS>
__device__ __forceinline__ void load_a_frags(uint32_t (&af)[KS][4], const bf16* a,
                                             int ld, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4(af[kk], a + (lane & 15) * ld + kk * 16 + (lane >> 4) * 8);
}

// mma_abt with A already in registers (load_a_frags): every accumulator
// sums over k in the same order as mma_abt.
template <int KS, int NC>
__device__ __forceinline__ void mma_abt_regs(float (&c)[NC][4],
                                             const uint32_t (&af)[KS][4],
                                             const bf16* b, int ld, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int np = 0; np < NC / 2; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * ld +
                          kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16_16816(c[2 * np], af[kk], &bf[0]);
      mma_bf16_16816(c[2 * np + 1], af[kk], &bf[2]);
    }
}

// C[16 x 8*NC] += bf16(P)[16 x 64] . B[64 x 8*NC]; P is the f32 C-fragment
// array of a 16 x 64 product (8 n-tiles); B is [k][n] with stride ld.
template <int NC>
__device__ __forceinline__ void mma_pb(float (&c)[NC][4], const float (&p)[8][4],
                                       const bf16* b, int ld, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t af[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < NC / 2; ++np) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                                np * 16 + (lane >> 4) * 8);
      mma_bf16_16816(c[2 * np], af, &bf[0]);
      mma_bf16_16816(c[2 * np + 1], af, &bf[2]);
    }
  }
}

template <int NC>
__device__ __forceinline__ void zero(float (&c)[NC][4]) {
#pragma unroll
  for (int i = 0; i < NC; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

// Rows [row0, row0 + rows) of an f32 (n, h) slice into smem [rows][ld],
// zeros past T, by `threads` threads.
__device__ __forceinline__ void load_rows_f32(float* dst, int ld,
                                              const float* src, long long rs,
                                              int row0, int rows, int t,
                                              int hd, int threads) {
  for (int i = threadIdx.x; i < rows * hd; i += threads) {
    const int r = i / hd, d = i % hd;
    dst[r * ld + d] = row0 + r < t ? src[(long long)(row0 + r) * rs + d] : 0.f;
  }
}

// Launch with `smem` bytes of dynamic shared memory (raising the kernel's
// limit above 48 KB first); returns cudaGetLastError().
template <typename... KA, typename... A>
int launch(void (*kernel)(KA...), dim3 grid, int threads, size_t smem,
           void* stream, A&&... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cpg::allow_smem((const void*)kernel, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(std::forward<A>(args)...);
  return (int)cudaGetLastError();
}

inline dim3 grid_of(const Dims& s) {
  return dim3((unsigned)((s.t + BR - 1) / BR), (unsigned)s.h, (unsigned)s.n);
}

inline bool dims_ok(const Dims& s) {
  return s.n > 0 && s.n <= 65535 && s.h > 0 && s.h <= 65535 && s.t > 0;
}

}  // namespace flash
}  // namespace cpg
