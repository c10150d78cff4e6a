// Implicit-GEMM backward kernels shared by the masked conv (K2, K3) and the
// fused BN+ReLU+conv3x3 chain (K5, K6).
//
// Both layers' backward passes are the same two products of a convolution,
// with the layer's own twist in an operand load or the epilogue:
//
//   dgrad   dx[m=(n,ih,iw), c] = sum_{k=(tap,o)} g_shift[m, k] * W[tap, c, o]
//           M = N*H*W input pixels, N_gemm = Cin, K = kh*kw*Cout. The A
//           tile is gathered straight from g (no transposed-conv buffer),
//           the B tile is the weight read transposed (reduce over Cout,
//           output over Cin).
//             K2: W is the effective weight, selected from w/own/pm in f32
//                 in the tile load (as K1), cast to the dot dtype there.
//             K5: W is the dot-dtype weight; the epilogue recomputes
//                 pre = a*x + b, keeps dact where pre > 0, writes
//                 dx = dact*a and this block's column sums of dact*x and
//                 dact (the da/db partials).
//   wgrad   G[k=(tap,c), o] = sum_{m=(n,oh,ow)} x_patch[m, k] * g[m, o]
//           K = kh*kw*Cin rows in HWIO order, N_gemm = Cout, reduced over
//           M = N*Ho*Wo output pixels (262,144 at VGG conv0, batch 256).
//           Blocks run in any order on the card, so the M reduction is
//           split over gridDim.z; each split writes an f32 partial tile,
//           and a second pass sums the partials in a fixed order: two runs
//           give the same bits (no float atomics).
//             K3: x raw; the second pass gates (dw on own == task, dpm = G*w
//                 on 0 < own < task).
//             K6: x_patch = relu(a*x + b) recomputed in the operand load and
//                 cast to the dot dtype there, zero in the SAME padding
//                 (padding applies after the activation).
//
// Precision: bf16 operands on the tensor cores (mma.sync m16n8k16, f32
// accumulation, ldmatrix fragments); f32 operands with exact f32 FMA.
// Rounding points follow the JAX kernels: g and W (or act) in the dot dtype,
// every sum in f32, dx cast to x's dtype last.
//
// What bounds them on the H100: at VGG16's batch-256 shapes the dgrads of
// the wide layers and every wgrad of >= 64 channels are compute-bound; the
// 32x32 layers' wgrads and conv0 move more bytes than they compute for.
// This first version stages each tile, synchronises and computes in turn
// (no multi-stage ring, no wgmma), like the forward kernels.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace cpg {
namespace bwd {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;   // 8 warps, 4 (rows) x 2 (cols), 32x32 outputs each
// dgrad tile: 128 pixels x 64 input channels, reduction depth 32
constexpr int BM = 128, BN = 64, BK = 32;
constexpr int LDA = BK + 8;   // bf16 [row][k] tiles; pads spread ldmatrix rows
constexpr int LD32 = BK + 1;  // f32 [row][k] tiles
// wgrad tile: 128 k-rows x 64 output channels, 32 output pixels per step
constexpr int BKO = 128, BMR = 32;
constexpr int LDX = BKO + 8, LDG = BN + 8;

struct ConvShape {
  int n, h, w, cin, ho, wo, cout, kh, kw, stride, pad_top, pad_left;
};

__device__ __forceinline__ float select_weight(float w, int own, float pm,
                                               int task, float thr,
                                               int ternary) {
  if (own == task) return w;
  if (own > 0 && own < task) {
    if (pm > thr) return w;
    if (ternary && pm < 0.f) return -w;
  }
  return 0.f;
}

// pre = a*x + b with the multiply and the add rounded separately, as the
// plain version computes it (no FMA contraction: the ReLU mask must agree)
__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

// ------------------------------------------------------------ dgrad ----

template <typename T>
struct DgradArgs {
  const T* g;                 // (N, Ho, Wo, Cout)
  const float* w;             // K2: raw weight, own, pm (HWIO)
  const int8_t* own;
  const float* pm;
  const T* wt;                // K5: weight in the dot dtype (HWIO)
  int task;
  float thr;
  int ternary;
  T* dx;                      // (N, H, W, Cin)
  const T* x;                 // K5 epilogue: x, a, b and the partials
  const float* a;
  const float* b;
  float* ws_da;               // (M tiles, Cin)
  float* ws_db;
};

// Per input pixel of the tile: the image's offset in g (-1 past M) and its
// coordinates shifted by the top/left padding.
struct DRows {
  long long gbase[BM];
  int ph[BM], pw[BM];
};

__device__ inline void fill_drows(DRows& rows, const ConvShape& s, int m0) {
  const int M = s.n * s.h * s.w;
  for (int r = threadIdx.x; r < BM; r += NT) {
    const int m = m0 + r;
    if (m < M) {
      const int t = m / s.w;
      rows.gbase[r] = (long long)(t / s.h) * s.ho * s.wo * s.cout;
      rows.ph[r] = t % s.h + s.pad_top;
      rows.pw[r] = m % s.w + s.pad_left;
    } else {
      rows.gbase[r] = -1;
    }
  }
}

// g at (row r, tap (dh, dw), channel o): the output pixel that reads this
// input pixel through that tap, or nullptr where none does (padding,
// stride, or r past M). Forward: ih = oh*stride - pad_top + dh.
template <typename T>
__device__ __forceinline__ const T* g_ptr(const T* g, const DRows& rows,
                                          const ConvShape& s, int r, int dh,
                                          int dw, int o) {
  const long long base = rows.gbase[r];
  const int oh_s = rows.ph[r] - dh, ow_s = rows.pw[r] - dw;
  if (base < 0 || oh_s < 0 || ow_s < 0) return nullptr;
  if (s.stride > 1 && (oh_s % s.stride || ow_s % s.stride)) return nullptr;
  const int oh = oh_s / s.stride, ow = ow_s / s.stride;
  if (oh >= s.ho || ow >= s.wo) return nullptr;
  return g + base + ((long long)oh * s.wo + ow) * s.cout + o;
}

// Four weight entries W[tap, c, o..o+3] as f32 (o % 4 == 0, Cout % 4 == 0)
template <bool kChain, typename T>
__device__ __forceinline__ float4 load_w4(const DgradArgs<T>& p, long long e) {
  if constexpr (kChain) {
    if constexpr (std::is_same<T, bf16>::value) {
      const uint2 v = *reinterpret_cast<const uint2*>(p.wt + e);
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
      const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
      return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                         __high2float(hi));
    } else {
      return *reinterpret_cast<const float4*>(p.wt + e);
    }
  } else {
    const float4 w = *reinterpret_cast<const float4*>(p.w + e);
    const float4 pm = *reinterpret_cast<const float4*>(p.pm + e);
    const char4 own = *reinterpret_cast<const char4*>(p.own + e);
    return make_float4(select_weight(w.x, own.x, pm.x, p.task, p.thr, p.ternary),
                       select_weight(w.y, own.y, pm.y, p.task, p.thr, p.ternary),
                       select_weight(w.z, own.z, pm.z, p.task, p.thr, p.ternary),
                       select_weight(w.w, own.w, pm.w, p.task, p.thr, p.ternary));
  }
}

template <bool kChain, typename T>
__device__ __forceinline__ float load_w1(const DgradArgs<T>& p, long long e) {
  if constexpr (kChain)
    return to_f32(p.wt[e]);
  else
    return select_weight(p.w[e], p.own[e], p.pm[e], p.task, p.thr, p.ternary);
}

// The K5 epilogue for one output element: returns dmasked and writes dx.
template <typename T>
__device__ __forceinline__ float chain_dx(const DgradArgs<T>& p, long long i,
                                          int c, float dact, float& xv) {
  xv = to_f32(p.x[i]);
  const float a = p.a[c];
  const float dm = affine(xv, a, p.b[c]) > 0.f ? dact : 0.f;
  p.dx[i] = from_f32<T>(dm * a);
  return dm;
}

template <bool kChain>
__global__ void __launch_bounds__(NT)
dgrad_bf16_kernel(DgradArgs<bf16> p, ConvShape s) {
  __shared__ __align__(16) bf16 As[BM * LDA];  // [pixel][k]
  __shared__ __align__(16) bf16 Bs[BN * LDA];  // [c][k], k = o of one tap
  __shared__ DRows rows;
  __shared__ float red[2][4][BN];              // K5: per-warp-row column sums

  const int M = s.n * s.h * s.w;
  const int K = s.kh * s.kw * s.cout;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  fill_drows(rows, s, m0);
  __syncthreads();

  // A and B: units of 4 consecutive k (= o) per thread; A rows tid/8 + 32j
  // (j < 4), B rows (input channels) tid/8 + 32j (j < 2)
  const int kk = (tid % 8) * 4, r0 = tid / 8;
  uint2 a_reg[4];
  float4 b_reg[2];

  auto load_tile = [&](int k0) {
    const int k = k0 + kk;
    const bool k_ok = k < K;  // K % 4 == 0
    const int o = k_ok ? k % s.cout : 0, tap = k_ok ? k / s.cout : 0;
    const int dh = tap / s.kw, dw = tap % s.kw;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bf16* q = k_ok ? g_ptr(p.g, rows, s, r0 + 32 * j, dh, dw, o) : nullptr;
      a_reg[j] = q ? *reinterpret_cast<const uint2*>(q) : make_uint2(0, 0);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = n0 + r0 + 32 * j;
      b_reg[j] = (k_ok && c < s.cin)
                     ? load_w4<kChain>(p, ((long long)tap * s.cin + c) * s.cout + o)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  const int a_row = wm * 32 + (lane & 15), a_koff = (lane >> 4) * 8;
  const int b_row = wn * 32 + (lane >> 4) * 8 + (lane & 7);
  const int b_koff = ((lane >> 3) & 1) * 8;

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint2*>(&As[(r0 + 32 * j) * LDA + kk]) = a_reg[j];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(b_reg[j].x, b_reg[j].y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(b_reg[j].z, b_reg[j].w);
      uint2 packed;
      packed.x = *reinterpret_cast<uint32_t*>(&lo);
      packed.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(&Bs[(r0 + 32 * j) * LDA + kk]) = packed;
    }
    __syncthreads();
    if (k0 + BK < K) load_tile(k0 + BK);

#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[2][4], bq[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], &As[(a_row + mi * 16) * LDA + ks + a_koff]);
#pragma unroll
      for (int pr = 0; pr < 2; ++pr)
        ldmatrix_x4(bq[pr], &Bs[(b_row + pr * 16) * LDA + ks + b_koff]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16_16816(&acc[(mi * 4 + ni) * 4], af[mi],
                         &bq[ni >> 1][(ni & 1) * 2]);
    }
  }

  float sda[8], sdb[8];  // K5: this thread's column sums, index ni*2 + e
#pragma unroll
  for (int i = 0; i < 8; ++i) sda[i] = sdb[i] = 0.f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 32 + mi * 16 + g + half * 8;
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + 2 * t4;
        const float* c = &acc[(mi * 4 + ni) * 4 + half * 2];
        const long long i = (long long)row * s.cin + col;
        if constexpr (kChain) {  // Cin % 8 == 0
          if (col < s.cin) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float xv;
              const float dm = chain_dx(p, i + e, col + e, c[e], xv);
              sda[ni * 2 + e] += __fmul_rn(dm, xv);
              sdb[ni * 2 + e] += dm;
            }
          }
        } else if (col + 1 < s.cin && s.cin % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(p.dx + i) =
              __floats2bfloat162_rn(c[0], c[1]);
        } else if (col < s.cin) {
          p.dx[i] = __float2bfloat16_rn(c[0]);
          if (col + 1 < s.cin) p.dx[i + 1] = __float2bfloat16_rn(c[1]);
        }
      }
    }
  if constexpr (kChain) {
    // rows of the warp: lanes with the same t4 hold the same columns
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        sda[i] += __shfl_xor_sync(0xffffffffu, sda[i], off);
        sdb[i] += __shfl_xor_sync(0xffffffffu, sdb[i], off);
      }
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int cc = wn * 32 + (i >> 1) * 8 + 2 * t4 + (i & 1);
        red[0][wm][cc] = sda[i];
        red[1][wm][cc] = sdb[i];
      }
    }
    __syncthreads();
    if (tid < 2 * BN) {
      const int which = tid / BN, cc = tid % BN, col = n0 + cc;
      if (col < s.cin) {
        const float v = ((red[which][0][cc] + red[which][1][cc]) +
                         red[which][2][cc]) + red[which][3][cc];
        (which ? p.ws_db : p.ws_da)[(long long)blockIdx.x * s.cin + col] = v;
      }
    }
  }
}

template <bool kChain>
__global__ void __launch_bounds__(NT)
dgrad_f32_kernel(DgradArgs<float> p, ConvShape s) {
  __shared__ float As[BM * LD32];  // [pixel][k]
  __shared__ float Bs[BN * LD32];  // [c][k]
  __shared__ DRows rows;
  __shared__ float red[2][16][BN];

  const int M = s.n * s.h * s.w;
  const int K = s.kh * s.kw * s.cout;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  fill_drows(rows, s, m0);
  __syncthreads();

  // one k column per thread: A rows tid/32 + 8j (j < 16), B rows (input
  // channels) tid/32 + 8j (j < 8); k = o runs along the warp (coalesced)
  const int kk = tid % BK, r0 = tid / BK;
  float a_reg[BM * BK / NT], b_reg[BN * BK / NT];

  auto load_tile = [&](int k0) {
    const int k = k0 + kk;
    const bool k_ok = k < K;
    const int o = k_ok ? k % s.cout : 0, tap = k_ok ? k / s.cout : 0;
    const int dh = tap / s.kw, dw = tap % s.kw;
#pragma unroll
    for (int j = 0; j < BM * BK / NT; ++j) {
      const float* q = k_ok ? g_ptr(p.g, rows, s, r0 + 8 * j, dh, dw, o) : nullptr;
      a_reg[j] = q ? *q : 0.f;
    }
#pragma unroll
    for (int j = 0; j < BN * BK / NT; ++j) {
      const int c = n0 + r0 + 8 * j;
      b_reg[j] = (k_ok && c < s.cin)
                     ? load_w1<kChain>(p, ((long long)tap * s.cin + c) * s.cout + o)
                     : 0.f;
    }
  };

  const int tx = tid & 15, ty = tid >> 4;  // rows ty*8+i, columns tx+16j
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BM * BK / NT; ++j) As[(r0 + 8 * j) * LD32 + kk] = a_reg[j];
#pragma unroll
    for (int j = 0; j < BN * BK / NT; ++j) Bs[(r0 + 8 * j) * LD32 + kk] = b_reg[j];
    __syncthreads();
    if (k0 + BK < K) load_tile(k0 + BK);
#pragma unroll 4
    for (int q = 0; q < BK; ++q) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(ty * 8 + i) * LD32 + q];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[(tx + 16 * j) * LD32 + q];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i * 4 + j] = fmaf(a[i], b[j], acc[i * 4 + j]);
    }
  }

  float sda[4] = {0.f, 0.f, 0.f, 0.f}, sdb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty * 8 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= s.cin) continue;
      const long long e = (long long)row * s.cin + col;
      if constexpr (kChain) {
        float xv;
        const float dm = chain_dx(p, e, col, acc[i * 4 + j], xv);
        sda[j] += __fmul_rn(dm, xv);
        sdb[j] += dm;
      } else {
        p.dx[e] = acc[i * 4 + j];
      }
    }
  }
  if constexpr (kChain) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[0][ty][tx + 16 * j] = sda[j];
      red[1][ty][tx + 16 * j] = sdb[j];
    }
    __syncthreads();
    if (tid < 2 * BN) {
      const int which = tid / BN, cc = tid % BN, col = n0 + cc;
      if (col < s.cin) {
        float v = 0.f;
        for (int t = 0; t < 16; ++t) v += red[which][t][cc];
        (which ? p.ws_db : p.ws_da)[(long long)blockIdx.x * s.cin + col] = v;
      }
    }
  }
}

inline dim3 dgrad_grid(const ConvShape& s) {
  const long long m = (long long)s.n * s.h * s.w;
  return dim3((unsigned)((m + BM - 1) / BM), (unsigned)((s.cin + BN - 1) / BN));
}

// ------------------------------------------------------------ wgrad ----

template <typename T>
struct WgradArgs {
  const T* x;        // (N, H, W, Cin)
  const T* g;        // (N, Ho, Wo, Cout)
  const float* a;    // K6: the affine of relu(a*x + b)
  const float* b;
  float* ws;         // (splits, K, Cout) f32 partials
  int chunk;         // output pixels per split, a multiple of BMR
};

// x_patch at output pixel m, tap (dh, dw), channel c: nullptr in the
// padding or past the split's end
template <typename T>
__device__ __forceinline__ const T* x_ptr(const T* x, const ConvShape& s,
                                          int m, int m_end, int dh, int dw,
                                          int c) {
  if (m >= m_end) return nullptr;
  const int t = m / s.wo;
  const int ih = (t % s.ho) * s.stride - s.pad_top + dh;
  const int iw = (m % s.wo) * s.stride - s.pad_left + dw;
  if (ih < 0 || ih >= s.h || iw < 0 || iw >= s.w) return nullptr;
  return x + (((long long)(t / s.ho) * s.h + ih) * s.w + iw) * s.cin + c;
}

template <bool kChain, bool kVecA>
__global__ void __launch_bounds__(NT)
wgrad_bf16_kernel(WgradArgs<bf16> p, ConvShape s) {
  __shared__ __align__(16) bf16 Xs[BMR * LDX];  // [pixel][k]
  __shared__ __align__(16) bf16 Gs[BMR * LDG];  // [pixel][o]

  const int M = s.n * s.ho * s.wo;
  const int K = s.kh * s.kw * s.cin;
  const int k0 = blockIdx.x * BKO, n0 = blockIdx.y * BN;
  const int m_begin = blockIdx.z * p.chunk;
  const int m_end = min(M, m_begin + p.chunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;

  // X: vector form (Cin % 8 == 0) 8 k per unit, rows tid/16 + 16j (j < 2);
  // scalar form one k, rows tid/128 + 2j (j < 16). The thread's k, and so
  // its (tap, c), is fixed for the whole reduction.
  constexpr int XN = kVecA ? 2 : BMR * BKO / NT;
  constexpr int XSTEP = kVecA ? NT / (BKO / 8) : NT / BKO;
  const int xk = kVecA ? (tid % (BKO / 8)) * 8 : tid % BKO;
  const int xr = kVecA ? tid / (BKO / 8) : tid / BKO;
  const int k = k0 + xk;
  const bool k_ok = k < K;
  const int c = k_ok ? k % s.cin : 0, tap = k_ok ? k / s.cin : 0;
  const int dh = tap / s.kw, dw = tap % s.kw;
  float av[8], bv[8];  // K6: the affine of this thread's channels
  if constexpr (kChain) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      av[e] = k_ok ? p.a[c + e] : 0.f;
      bv[e] = k_ok ? p.b[c + e] : 0.f;
    }
  }
  using XReg = typename std::conditional<kVecA, uint4, bf16>::type;
  XReg x_reg[XN];
  // G: 4 o per unit (Cout % 4 == 0), rows tid/16 + 16j (j < 2)
  const int go = (tid % (BN / 4)) * 4, gr = tid / (BN / 4);
  uint2 g_reg[2];

  auto load_tile = [&](int mb) {
#pragma unroll
    for (int j = 0; j < XN; ++j) {
      const bf16* q = k_ok ? x_ptr(p.x, s, mb + xr + j * XSTEP, m_end, dh, dw, c)
                           : nullptr;
      if constexpr (kVecA) {
        uint4 v = q ? *reinterpret_cast<const uint4*>(q) : make_uint4(0, 0, 0, 0);
        if constexpr (kChain) {
          if (q) {  // act = relu(a*x + b) in f32, cast to bf16; 0 in padding
            bf16* e8 = reinterpret_cast<bf16*>(&v);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              e8[e] = __float2bfloat16_rn(
                  fmaxf(affine(__bfloat162float(e8[e]), av[e], bv[e]), 0.f));
          }
        }
        x_reg[j] = v;
      } else {
        x_reg[j] = q ? *q : __float2bfloat16_rn(0.f);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = mb + gr + 16 * j, o = n0 + go;
      g_reg[j] = (m < m_end && o < s.cout)
                     ? *reinterpret_cast<const uint2*>(p.g + (long long)m * s.cout + o)
                     : make_uint2(0, 0);
    }
  };

  // A (k x m) from Xs[m][k] with ldmatrix.trans; B (m x o) from Gs[m][o]
  const int a_m = (lane >> 4) * 8 + (lane & 7), a_k = ((lane >> 3) & 1) * 8;
  const int b_m = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_n = wn * 32 + (lane >> 4) * 8;

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  if (m_begin < m_end) load_tile(m_begin);
  for (int mb = m_begin; mb < m_end; mb += BMR) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < XN; ++j) {
      if constexpr (kVecA)
        *reinterpret_cast<uint4*>(&Xs[(xr + j * XSTEP) * LDX + xk]) = x_reg[j];
      else
        Xs[(xr + j * XSTEP) * LDX + xk] = x_reg[j];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<uint2*>(&Gs[(gr + 16 * j) * LDG + go]) = g_reg[j];
    __syncthreads();
    if (mb + BMR < m_end) load_tile(mb + BMR);

#pragma unroll
    for (int ks = 0; ks < BMR; ks += 16) {
      uint32_t af[2][4], bq[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4_trans(af[mi], &Xs[(ks + a_m) * LDX + wm * 32 + mi * 16 + a_k]);
#pragma unroll
      for (int pr = 0; pr < 2; ++pr)
        ldmatrix_x4_trans(bq[pr], &Gs[(ks + b_m) * LDG + b_n + pr * 16]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16_16816(&acc[(mi * 4 + ni) * 4], af[mi],
                         &bq[ni >> 1][(ni & 1) * 2]);
    }
  }

  float* ws = p.ws + (long long)blockIdx.z * K * s.cout;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = k0 + wm * 32 + mi * 16 + g + half * 8;
      if (row >= K) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + 2 * t4;  // Cout % 4 == 0
        if (col < s.cout) {
          const float* v = &acc[(mi * 4 + ni) * 4 + half * 2];
          *reinterpret_cast<float2*>(ws + (long long)row * s.cout + col) =
              make_float2(v[0], v[1]);
        }
      }
    }
}

template <bool kChain>
__global__ void __launch_bounds__(NT)
wgrad_f32_kernel(WgradArgs<float> p, ConvShape s) {
  __shared__ float Xs[BMR * BKO];  // [pixel][k]
  __shared__ float Gs[BMR * BN];   // [pixel][o]

  const int M = s.n * s.ho * s.wo;
  const int K = s.kh * s.kw * s.cin;
  const int k0 = blockIdx.x * BKO, n0 = blockIdx.y * BN;
  const int m_begin = blockIdx.z * p.chunk;
  const int m_end = min(M, m_begin + p.chunk);
  const int tid = threadIdx.x;

  // X: one k per thread, rows tid/128 + 2j (j < 16); G: one o per thread,
  // rows tid/64 + 4j (j < 8)
  const int xk = tid % BKO, xr = tid / BKO;
  const int k = k0 + xk;
  const bool k_ok = k < K;
  const int c = k_ok ? k % s.cin : 0, tap = k_ok ? k / s.cin : 0;
  const int dh = tap / s.kw, dw = tap % s.kw;
  const float ac = (kChain && k_ok) ? p.a[c] : 0.f;
  const float bc = (kChain && k_ok) ? p.b[c] : 0.f;
  const int go = tid % BN, gr = tid / BN;
  float x_reg[BMR * BKO / NT], g_reg[BMR * BN / NT];

  auto load_tile = [&](int mb) {
#pragma unroll
    for (int j = 0; j < BMR * BKO / NT; ++j) {
      const float* q = k_ok ? x_ptr(p.x, s, mb + xr + 2 * j, m_end, dh, dw, c)
                            : nullptr;
      float v = q ? *q : 0.f;
      if constexpr (kChain) v = q ? fmaxf(affine(v, ac, bc), 0.f) : 0.f;
      x_reg[j] = v;
    }
#pragma unroll
    for (int j = 0; j < BMR * BN / NT; ++j) {
      const int m = mb + gr + 4 * j, o = n0 + go;
      g_reg[j] = (m < m_end && o < s.cout) ? p.g[(long long)m * s.cout + o] : 0.f;
    }
  };

  const int tx = tid & 15, ty = tid >> 4;  // k rows ty*8+i, o columns tx+16j
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  if (m_begin < m_end) load_tile(m_begin);
  for (int mb = m_begin; mb < m_end; mb += BMR) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BMR * BKO / NT; ++j) Xs[(xr + 2 * j) * BKO + xk] = x_reg[j];
#pragma unroll
    for (int j = 0; j < BMR * BN / NT; ++j) Gs[(gr + 4 * j) * BN + go] = g_reg[j];
    __syncthreads();
    if (mb + BMR < m_end) load_tile(mb + BMR);
#pragma unroll 4
    for (int q = 0; q < BMR; ++q) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = Xs[q * BKO + ty * 8 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Gs[q * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i * 4 + j] = fmaf(a[i], b[j], acc[i * 4 + j]);
    }
  }

  float* ws = p.ws + (long long)blockIdx.z * K * s.cout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = k0 + ty * 8 + i;
    if (row >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < s.cout) ws[(long long)row * s.cout + col] = acc[i * 4 + j];
    }
  }
}

// Grid of a wgrad with `splits` partials; sets p.chunk.
template <typename T>
inline dim3 wgrad_grid(const ConvShape& s, int splits, WgradArgs<T>& p) {
  const long long m = (long long)s.n * s.ho * s.wo;
  const long long per = (m + splits - 1) / splits;
  p.chunk = (int)((per + BMR - 1) / BMR * BMR);
  const int k = s.kh * s.kw * s.cin;
  return dim3((unsigned)((k + BKO - 1) / BKO), (unsigned)((s.cout + BN - 1) / BN),
              (unsigned)splits);
}

// sum over the split partials of entry e, in split order
__device__ __forceinline__ float splitk_sum(const float* ws, int splits,
                                            long long entries, long long e) {
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += ws[z * entries + e];
  return v;
}

}  // namespace bwd
}  // namespace cpg
