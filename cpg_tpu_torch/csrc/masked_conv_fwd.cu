// Masked (CPG SharableConv2d) convolution forward as an implicit GEMM.
//
// Replaces: cpg_tpu/ops/pallas/masked_matmul.py `_fwd` / `_fwd_kernel` (the
// TPU forward kernel) as reached through cpg_tpu/ops/pallas/masked_conv.py
// `masked_conv2d`, with the ownership/piggymask select of `_mask_tile`.
//
//   y[n,i,j,o] = sum_{dh,dw,c} x_pad[n, i*s+dh, j*s+dw, c] * w_eff[dh,dw,c,o]
//   w_eff = w where own == task; 1[pm > thr] * w (ternary: also -w where
//           pm < 0) where 0 < own < task; 0 elsewhere.
//
// GEMM view: M = N*Ho*Wo output pixels, N_gemm = Cout, K = kh*kw*Cin read in
// HWIO order (k = (dh*kw + dw)*Cin + c), so the weight, ownership and
// piggymask tensors are used in place as (K, Cout) row-major matrices.
//
// What bounds it on the H100: at VGG16's shapes and batch 256 the conv is
// compute-bound (conv2/4/7) or bound by the 9 bytes read per weight entry
// (w f32 + own int8 + pm f32; conv0 and conv10). The design:
//   * the A tile is gathered straight from NHWC x with bounds checks for the
//     zero padding: no im2col tensor is ever written (the TPU path
//     materialised the patches);
//   * the B tile is loaded from w/own/pm, selected in f32 and cast to the
//     activation dtype on its way into shared memory: the effective weight
//     never reaches device memory;
//   * ragged edges in M, N and K are masked here (conv0 has K = 27), with no
//     padding of the operands by the caller;
//   * each thread issues all of a tile's global loads into registers before
//     it stores them to shared memory, and the next tile's loads before the
//     current tile's products, so loads overlap each other and the math.
// bf16 activations run on the tensor cores (mma.sync m16n8k16, f32
// accumulate) with ldmatrix fragment loads and 16-byte loads of x (Cin a
// multiple of 8) and of w/pm (Cout a multiple of 4, which the bf16 kernel
// requires); f32 activations run exact f32 FMA with scalar loads.
// Which convs it still serves (ops/masked_conv.py picks the route before
// the launch): every f32 conv; bf16 convs off the other routes, i.e. the
// narrow widths (Cin or Cout not multiples of 64: VGG16-BN at width 0.125,
// a model-axis slice of conv0 at 32 channels) and a Cin < 8 conv whose
// Cout is no multiple of 64 (conv0 and the stems at widths under 1.0). The
// bf16 Cin = 3 convs at width 1.0 (ResNet-50's and SphereNet-20's stems,
// VGG16-BN's conv0) run masked_conv_stem.cu; bf16 convs with Cin and Cout
// multiples of 64 run the select pass and a TMA + wgmma GEMM
// (masked_matmul.cu). This kernel has no multi-stage ring and no wgmma.
#include <type_traits>

#include "common.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int BM = 128;  // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 32;   // reduction depth per step
constexpr int NT = 256;  // 8 warps: 4 (M) x 2 (N), 32x32 outputs each

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

// Per output row of the tile: the image's offset in x (-1 past M) and the
// top-left input coordinate of its window.
struct Rows {
  long long base[BM];
  int ih0[BM], iw0[BM];
};

__device__ void fill_rows(Rows& rows, const ConvShape& s, int m0) {
  const int M = s.n * s.ho * s.wo;
  for (int r = threadIdx.x; r < BM; r += NT) {
    const int m = m0 + r;
    if (m < M) {
      const int ow = m % s.wo, t = m / s.wo;
      rows.base[r] = (long long)(t / s.ho) * s.h * s.w * s.cin;
      rows.ih0[r] = (t % s.ho) * s.stride - s.pad_top;
      rows.iw0[r] = ow * s.stride - s.pad_left;
    } else {
      rows.base[r] = -1;
    }
  }
}

// x element (row r, k) of the implicit im2col matrix, or nullptr where the
// window reaches into the zero padding or r lies past M
template <typename T>
__device__ __forceinline__ const T* a_ptr(const T* x, const Rows& rows,
                                          const ConvShape& s, int r, int dh,
                                          int dw, int c) {
  const long long base = rows.base[r];
  const int ih = rows.ih0[r] + dh, iw = rows.iw0[r] + dw;
  if (base < 0 || ih < 0 || ih >= s.h || iw < 0 || iw >= s.w) return nullptr;
  return x + base + ((long long)ih * s.w + iw) * s.cin + c;
}

// ---------------------------------------------------------------- bf16 ----
// Tiles: A [BM][BK+8], B [BK][BN+8] (Cout contiguous); the pads put
// ldmatrix's eight 16-byte rows on distinct banks.
constexpr int LDA = BK + 8;
constexpr int LDB = BN + 8;

template <bool kVecA>
__global__ void __launch_bounds__(NT)
masked_conv_fwd_bf16_kernel(const bf16* __restrict__ x,
                            const float* __restrict__ w,
                            const int8_t* __restrict__ own,
                            const float* __restrict__ pm,
                            bf16* __restrict__ y, ConvShape s, int task,
                            float thr, int ternary) {
  __shared__ __align__(16) bf16 As[BM * LDA];
  __shared__ __align__(16) bf16 Bs[BK * LDB];
  __shared__ Rows rows;

  const int M = s.n * s.ho * s.wo;
  const int K = s.kh * s.kw * s.cin;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  fill_rows(rows, s, m0);
  __syncthreads();

  // A, vector form (Cin % 8 == 0): 2 x 8 channels per thread, rows tid/4
  // and tid/4 + 64. Scalar form: one k column, 16 rows NT/BK apart.
  constexpr int A_N = kVecA ? 2 : BM * BK / NT;
  using AReg = typename std::conditional<kVecA, uint4, bf16>::type;
  AReg a_reg[A_N];
  const int a_kk = kVecA ? (tid % (BK / 8)) * 8 : tid % BK;
  const int a_r0 = kVecA ? tid / (BK / 8) : tid / BK;
  constexpr int A_STEP = kVecA ? NT / (BK / 8) : NT / BK;
  // B: 2 x 4 output channels per thread, k rows tid/16 and tid/16 + 16
  constexpr int B_N = BK * BN / 4 / NT;
  const int b_n4 = (tid % (BN / 4)) * 4, b_k0 = tid / (BN / 4);
  constexpr int B_STEP = NT / (BN / 4);
  float4 w_reg[B_N], pm_reg[B_N];
  char4 own_reg[B_N];

  auto load_tile = [&](int k0) {
    const int k = k0 + a_kk;
    const bool k_ok = k < K;
    const int c = k_ok ? k % s.cin : 0;
    const int tap = k_ok ? k / s.cin : 0;
    const int dh = tap / s.kw, dw = tap % s.kw;
#pragma unroll
    for (int j = 0; j < A_N; ++j) {
      const bf16* p = k_ok ? a_ptr(x, rows, s, a_r0 + j * A_STEP, dh, dw, c) : nullptr;
      if constexpr (kVecA)
        a_reg[j] = p ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
      else
        a_reg[j] = p ? *p : __float2bfloat16_rn(0.f);
    }
#pragma unroll
    for (int j = 0; j < B_N; ++j) {
      const int kb = k0 + b_k0 + j * B_STEP, o = n0 + b_n4;
      const bool ok = kb < K && o < s.cout;  // Cout % 4 == 0
      const long long e = (long long)kb * s.cout + o;
      w_reg[j] = ok ? *reinterpret_cast<const float4*>(w + e) : make_float4(0, 0, 0, 0);
      pm_reg[j] = ok ? *reinterpret_cast<const float4*>(pm + e) : make_float4(0, 0, 0, 0);
      own_reg[j] = ok ? *reinterpret_cast<const char4*>(own + e) : make_char4(0, 0, 0, 0);
    }
  };

  // ldmatrix lanes: A rows lane%16 at k offset 8*(lane/16); B (.trans) k rows
  // lane%8 + 8*((lane/8)%2) at n offset 8*(lane/16)
  const int a_row = wm * 32 + (lane & 15), a_koff = (lane >> 4) * 8;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_n = wn * 32 + (lane >> 4) * 8;

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // previous tile's products are done with smem
#pragma unroll
    for (int j = 0; j < A_N; ++j) {
      if constexpr (kVecA)
        *reinterpret_cast<uint4*>(&As[(a_r0 + j * A_STEP) * LDA + a_kk]) = a_reg[j];
      else
        As[(a_r0 + j * A_STEP) * LDA + a_kk] = a_reg[j];
    }
    // ownership/piggymask select in f32, cast on the way into smem
#pragma unroll
    for (int j = 0; j < B_N; ++j) {
      const float wv[4] = {w_reg[j].x, w_reg[j].y, w_reg[j].z, w_reg[j].w};
      const float pv[4] = {pm_reg[j].x, pm_reg[j].y, pm_reg[j].z, pm_reg[j].w};
      const int ov[4] = {own_reg[j].x, own_reg[j].y, own_reg[j].z, own_reg[j].w};
      __nv_bfloat162 lo = __floats2bfloat162_rn(
          select_weight(wv[0], ov[0], pv[0], task, thr, ternary),
          select_weight(wv[1], ov[1], pv[1], task, thr, ternary));
      __nv_bfloat162 hi = __floats2bfloat162_rn(
          select_weight(wv[2], ov[2], pv[2], task, thr, ternary),
          select_weight(wv[3], ov[3], pv[3], task, thr, ternary));
      uint2 packed;
      packed.x = *reinterpret_cast<uint32_t*>(&lo);
      packed.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(&Bs[(b_k0 + j * B_STEP) * LDB + b_n4]) = packed;
    }
    __syncthreads();
    if (k0 + BK < K) load_tile(k0 + BK);

#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[2][4], bq[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        cpg::ldmatrix_x4(af[mi], &As[(a_row + mi * 16) * LDA + ks + a_koff]);
#pragma unroll
      for (int pr = 0; pr < 2; ++pr)
        cpg::ldmatrix_x4_trans(bq[pr], &Bs[(ks + b_k) * LDB + b_n + pr * 16]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          cpg::mma_bf16_16816(&acc[(mi * 4 + ni) * 4], af[mi],
                              &bq[ni >> 1][(ni & 1) * 2]);
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 32 + mi * 16 + g + half * 8;
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + 2 * t4;
        if (col < s.cout) {
          const float* c = &acc[(mi * 4 + ni) * 4 + half * 2];
          *reinterpret_cast<__nv_bfloat162*>(y + (long long)row * s.cout + col) =
              __floats2bfloat162_rn(c[0], c[1]);
        }
      }
    }
}

// ----------------------------------------------------------------- f32 ----
// Tiles: A [BM][BK+1], B [BN][BK+1]; thread (tx, ty) computes rows ty*8+i
// and columns tx+16j with exact f32 FMA.
constexpr int LD32 = BK + 1;

__global__ void __launch_bounds__(NT)
masked_conv_fwd_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const int8_t* __restrict__ own,
                           const float* __restrict__ pm,
                           float* __restrict__ y, ConvShape s, int task,
                           float thr, int ternary) {
  __shared__ float As[BM * LD32];
  __shared__ float Bs[BN * LD32];
  __shared__ Rows rows;

  const int M = s.n * s.ho * s.wo;
  const int K = s.kh * s.kw * s.cin;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  fill_rows(rows, s, m0);
  __syncthreads();

  // A: one k column, 16 rows NT/BK apart; B: one n column, 8 k rows
  constexpr int A_N = BM * BK / NT, B_N = BK * BN / NT;
  const int a_kk = tid % BK, a_r0 = tid / BK;
  const int b_nn = tid % BN, b_k0 = tid / BN, b_n = n0 + b_nn;
  float a_reg[A_N], w_reg[B_N], pm_reg[B_N];
  int own_reg[B_N];

  auto load_tile = [&](int k0) {
    const int k = k0 + a_kk;
    const bool k_ok = k < K;
    const int c = k_ok ? k % s.cin : 0;
    const int tap = k_ok ? k / s.cin : 0;
    const int dh = tap / s.kw, dw = tap % s.kw;
#pragma unroll
    for (int j = 0; j < A_N; ++j) {
      const float* p = k_ok ? a_ptr(x, rows, s, a_r0 + j * (NT / BK), dh, dw, c) : nullptr;
      a_reg[j] = p ? *p : 0.f;
    }
#pragma unroll
    for (int j = 0; j < B_N; ++j) {
      const int kb = k0 + b_k0 + j * (NT / BN);
      const bool ok = kb < K && b_n < s.cout;
      const long long e = (long long)kb * s.cout + b_n;
      w_reg[j] = ok ? w[e] : 0.f;
      own_reg[j] = ok ? (int)own[e] : 0;
      pm_reg[j] = ok ? pm[e] : 0.f;
    }
  };

  const int tx = tid & 15, ty = tid >> 4;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < A_N; ++j) As[(a_r0 + j * (NT / BK)) * LD32 + a_kk] = a_reg[j];
#pragma unroll
    for (int j = 0; j < B_N; ++j)
      Bs[b_nn * LD32 + b_k0 + j * (NT / BN)] =
          select_weight(w_reg[j], own_reg[j], pm_reg[j], task, thr, ternary);
    __syncthreads();
    if (k0 + BK < K) load_tile(k0 + BK);

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(ty * 8 + i) * LD32 + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[(tx + 16 * j) * LD32 + kk];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i * 4 + j] = fmaf(a[i], b[j], acc[i * 4 + j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty * 8 + i, col = n0 + tx + 16 * j;
      if (row < M && col < s.cout) y[(long long)row * s.cout + col] = acc[i * 4 + j];
    }
}

dim3 grid_of(const ConvShape& s) {
  const long long m = (long long)s.n * s.ho * s.wo;
  return dim3((unsigned)((m + BM - 1) / BM), (unsigned)((s.cout + BN - 1) / BN));
}

}  // namespace

extern "C" {

// x (N,H,W,Cin) bf16, w/pm (kh,kw,Cin,Cout) f32, own int8, y (N,Ho,Wo,Cout)
// bf16; all contiguous on one device, Cout a multiple of 4, w/pm 16-byte
// and (when Cin % 8 == 0) x 16-byte aligned. The bottom and right padding
// enter through Ho and Wo (the caller resolves all four pads); windows past
// the image read zeros. Returns cudaGetLastError().
int masked_conv_fwd_bf16(const void* x, const void* w, const void* own,
                         const void* pm, void* y, int n, int h, int wd,
                         int cin, int ho, int wo, int cout, int kh, int kw,
                         int stride, int pad_top, int pad_left, int task,
                         float thr, int ternary, void* stream) {
  if (cout % 4) return (int)cudaErrorInvalidValue;
  const ConvShape s{n, h, wd, cin, ho, wo, cout, kh, kw, stride, pad_top,
                    pad_left};
  if (cin % 8 == 0)
    masked_conv_fwd_bf16_kernel<true><<<grid_of(s), NT, 0, (cudaStream_t)stream>>>(
        (const bf16*)x, (const float*)w, (const int8_t*)own, (const float*)pm,
        (bf16*)y, s, task, thr, ternary);
  else
    masked_conv_fwd_bf16_kernel<false><<<grid_of(s), NT, 0, (cudaStream_t)stream>>>(
        (const bf16*)x, (const float*)w, (const int8_t*)own, (const float*)pm,
        (bf16*)y, s, task, thr, ternary);
  return (int)cudaGetLastError();
}

// The same with f32 x and y, any Cin and Cout.
int masked_conv_fwd_f32(const void* x, const void* w, const void* own,
                        const void* pm, void* y, int n, int h, int wd,
                        int cin, int ho, int wo, int cout, int kh, int kw,
                        int stride, int pad_top, int pad_left, int task,
                        float thr, int ternary, void* stream) {
  const ConvShape s{n, h, wd, cin, ho, wo, cout, kh, kw, stride, pad_top,
                    pad_left};
  masked_conv_fwd_f32_kernel<<<grid_of(s), NT, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const int8_t*)own, (const float*)pm,
      (float*)y, s, task, thr, ternary);
  return (int)cudaGetLastError();
}

}  // extern "C"
