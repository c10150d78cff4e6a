// Dense masked matmul for Hopper (dense K1 forward and dense K2 input
// gradient), in two launches: a select pass and a TMA + wgmma GEMM.
//
// Replaces, for bf16 activations at the dense shapes of the ViTs:
// cpg_tpu/ops/pallas/masked_matmul.py `_fwd` (y = x @ w_eff) and `_bwd_dx`
// (dx = g @ w_eff^T), with the ownership/piggymask select of `_mask_tile`:
//
//   w_eff = w where own == task; 1[pm > thr] * w (ternary: also -w where
//           pm < 0) where 0 < own < task; 0 elsewhere;
//   selected in f32, then rounded to bf16 (the activation dtype).
//
// What bounds it on the H100: at vit_cifar's shapes (M = 16,384 rows,
// K, N in {256, 1024}) the product is bound by bytes: x and y (or g and
// dx) cross HBM once, 2 B an element each way, and the weights, 9 B an
// entry (w f32, own int8, pm f32), once. The TPU kernel selected inside its
// weight-tile load with bm = 1024 rows in 16 MB of VMEM; a Hopper block has
// 227 KB, so an in-tile select re-reads 9 B and re-selects every weight
// entry once per 128-row M tile (128 times at M = 16,384), which made the
// earlier 1x1 implicit-GEMM form bound by L2 and the select. Here:
//   * `masked_matmul_select_bf16` reads w, own and pm once (16-byte loads)
//     and writes the bf16 effective weight, 2 B an entry, to a per-call
//     scratch, in the layout the GEMM wants: w_eff^T (N, K) through a
//     shared-memory transpose tile for the forward, w_eff (K, N) as it is
//     for dx. The effective weight reaches device memory for one call; the
//     autograd residuals stay x, w, own and pm.
//   * `masked_matmul_gemm_tn_bf16` computes C[M, Nout] = A[M, R] Bt[Nout,
//     R]^T, both operands with the reduction axis contiguous (forward:
//     A = x, Bt = w_eff^T, R = K; dx: A = g, Bt = w_eff, R = N, Nout = K),
//     bf16 in and out, f32 accumulation. Persistent blocks, one an SM
//     (ops/masked_matmul.py `gemm_plan` sizes the grid and picks the tile
//     width BN of 64, 128 or 192), walk the 128 x BN output tiles with M
//     fastest. In each block one thread of a producer warp keeps a ring of
//     2-5 stages of {A 128 x 64, B BN x 64} tiles in flight by TMA
//     (128-byte swizzle, a "full" and an "empty" mbarrier a stage); two
//     consumer warpgroups, 64 rows each, run wgmma.mma_async m64nBNk16 on
//     the stages that have landed (A and B from shared memory, the
//     descriptors' swizzle matching TMA's), keep one wgmma group in flight
//     and hand a stage back when its group is done. The epilogue rounds
//     the f32 sums to bf16 into a swizzled shared-memory staging tile and
//     stores it by TMA, which drains while the warpgroup runs the next
//     tile's products (register-to-global stores of 4 bytes a thread, not
//     overlapped, were the largest cost of development builds). Ragged M,
//     R and Nout come from TMA's zero fill and clipped stores; nothing is
//     padded. No split-K and no atomics: two launches give equal bits.
// The GEMM kernel is in tma_gemm.cuh (EPI_STORE here), which K5
// (fused_chain_bwd_dx.cu) instantiates with its own epilogue.
// A and Bt need R % 8 == 0 and Nout % 8 == 0 (TMA's 16-byte row strides)
// and 16-byte aligned bases; the wrapper takes the 1x1 masked-conv kernels
// for any other shape and for f32.
//
// The same GEMM is the masked conv's forward (conv K1) and input gradient
// (conv K2) at VGG16-BN's 3x3, stride-1 shapes (`masked_conv_gemm_bf16`;
// replaces `_fwd` and `_bwd_dx` as reached through
// cpg_tpu/ops/pallas/masked_conv.py `masked_conv2d`, whose patches the TPU
// wrote to HBM). The weight is selected once over the HWIO kernel viewed as
// (kh*kw*Cin, Cout), transposed for the forward; only the producer's loads
// differ from the dense GEMM. k-step kt is (tap, channel block) = (kt / (C /
// 64), kt % (C / 64)), C the reduction channels (Cin forward, Cout dgrad),
// and its A tile is one TMA box of a 4-D map over the NHWC activation, dims
// (C, W, H, N), box (64, Wo, rows, images) with Wo * rows * images = 128:
// 128 consecutive output pixels (whole rows of one image, or whole images),
// laid out in shared memory exactly as the dense 128 x 64 K-major tile. The
// forward reads x at (c, ow0 + dw - pad_left, oh0 + dh - pad_top, n0), the
// input gradient g at the mirrored (c, iw0 + pad_left - dw, ih0 + pad_top -
// dh, n0); TMA's zero fill of coordinates outside the tensor (negative ones
// too) is the padding, so no im2col tensor is written. B is w_eff^T's 2-D
// box at (kt * 64, n0) for the forward (Cin % 64 == 0: a box never straddles
// two taps) and a 3-D map of w_eff as (Cout, Cin, taps) at (c, n0, tap) for
// the input gradient, which clips at Cin inside each tap. The output tile is
// 128 rows of (N*Ho*Wo, Cout) or (N*H*W, Cin), stored as the dense one.
// Bound on the H100 at batch 256: by operations (4.8-9.7 GFLOP a layer
// against 1-17 MB of activations), so the activation boxes and the selected
// weight come from L2 after their first read.
//
// The same select pass and ring, with A from TMA's im2col mode
// (`masked_conv_im2col_gemm_bf16`, tma_gemm.cuh `conv_im2col_kernel`), are
// the conv's y and dx where no box of whole rows makes 128 pixels or the
// stride is 2: every ResNet-50 and SphereNet-20 conv past the stem (bf16,
// Cin and Cout multiples of 64, 1x1 or 3x3; the 1x1 convs at stride 1 take
// the dense GEMM above). The earlier kernels (masked_conv_fwd.cu,
// conv_bwd.cuh) selected the weight inside every output tile's B load,
// re-reading 9 B a weight entry per 128-pixel tile, and ran one mma.sync
// stage at a time; at SphereNet's 14x12 unit, 336 row tiles moved ~1.8 GB
// of weight a launch for 0.051 ms of products. Here a tile is 128
// consecutive output pixels of the flattened (N, Ho, Wo) grid, across row
// and image boundaries: one im2col load per k-step brings them, each read
// at the tap's offset (off_w, off_h) from its base coordinate; the map's
// bounding box (lower corner -pad, the upper one set so the traversal walks
// exactly Wo columns and Ho rows) and its traversal stride (the conv's)
// make the grid, TMA's zero fill the padding, so the output tile is 128
// rows of (N*Ho*Wo, Cout), stored by TMA as the dense one. The stride-1
// input gradient is the same walk over g with the taps mirrored (offset k
// - 1 - d, lower corner -(k - 1 - pad)). At stride 2 it runs by phases: dx
// splits into its four parity phases (ih % 2, iw % 2), each a stride-1
// product of g with only the taps that reach it (3x3: 1, 2, 2 and 4 taps;
// 1x1: one phase of one tap, the other three zeros), no zero row
// multiplied; the phases share one launch (a tile index runs over them,
// the most taps first) and each stores its rows to dx's strided positions
// from the staging tile (a strided row set is no TMA box). Bound on the
// H100: by operations at the bound's count (a SphereNet unit conv is 50.7
// GFLOP against ~40 MB), in practice by the L2 rate of the A loads, which
// read each input pixel once per tap: at 64 output channels a k-step
// moves 24 KB for 1 MFLOP.
#include "common.cuh"
#include "tma_gemm.cuh"

using bf16 = __nv_bfloat16;
using namespace cpg::hopper;
using namespace cpg::gemm;

namespace {

// ------------------------------------------------------------- select ----
constexpr int SK = 32, SN = 64;  // select tile: 32 k x 64 n, 256 threads

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

// w, pm (K, N) f32 and own (K, N) int8 -> w_eff (K, N) or, with kTrans,
// w_eff^T (N, K), bf16. K and N are multiples of 8.
template <bool kTrans>
__global__ void __launch_bounds__(256)
select_bf16_kernel(const float* __restrict__ w, const int8_t* __restrict__ own,
                   const float* __restrict__ pm, bf16* __restrict__ out, int K,
                   int N, int task, float thr, int ternary) {
  __shared__ __align__(16) bf16 t[SN][SK + 8];  // [n][k] when kTrans
  const int k0 = blockIdx.y * SK, n0 = blockIdx.x * SN;
  const int tid = threadIdx.x;
  const int c4 = (tid % 16) * 4;
#pragma unroll
  for (int p = 0; p < SK / 16; ++p) {
    const int r = p * 16 + tid / 16;
    const int k = k0 + r, n = n0 + c4;
    if (k < K && n < N) {
      const size_t i = (size_t)k * N + n;
      const float4 wv = *reinterpret_cast<const float4*>(w + i);
      const float4 pv = *reinterpret_cast<const float4*>(pm + i);
      const char4 ov = *reinterpret_cast<const char4*>(own + i);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(
          select_weight(wv.x, ov.x, pv.x, task, thr, ternary),
          select_weight(wv.y, ov.y, pv.y, task, thr, ternary));
      const __nv_bfloat162 hi = __floats2bfloat162_rn(
          select_weight(wv.z, ov.z, pv.z, task, thr, ternary),
          select_weight(wv.w, ov.w, pv.w, task, thr, ternary));
      if (kTrans) {
        t[c4][r] = lo.x;
        t[c4 + 1][r] = lo.y;
        t[c4 + 2][r] = hi.x;
        t[c4 + 3][r] = hi.y;
      } else {
        *reinterpret_cast<__nv_bfloat162*>(out + i) = lo;
        *reinterpret_cast<__nv_bfloat162*>(out + i + 2) = hi;
      }
    }
  }
  if (!kTrans) return;
  __syncthreads();
  // 64 rows of n, each 32 k = four 16-byte chunks: one a thread
  const int nn = tid / 4, kc = (tid % 4) * 8;
  const int n = n0 + nn, k = k0 + kc;
  if (n < N && k < K)
    *reinterpret_cast<uint4*>(out + (size_t)n * K + k) =
        *reinterpret_cast<const uint4*>(&t[nn][kc]);
}

// --------------------------------------------------------------- GEMM ----
// tma_gemm.cuh holds the kernel; here its EPI_STORE launches by tile width

template <int WALK>
int launch_walk(const CUtensorMap& ma, const CUtensorMap& mb,
                const CUtensorMap& mc, int m, int r, int nout, int bn,
                int stages, int grid, const ConvWalk& cw, cudaStream_t st) {
  const FusedDx none{};
  switch (bn) {
    case 64:
      return launch_gemm<64, WALK, EPI_STORE>(ma, mb, mc, mc, m, r, nout,
                                              stages, grid, cw, none, st);
    case 128:
      return launch_gemm<128, WALK, EPI_STORE>(ma, mb, mc, mc, m, r, nout,
                                               stages, grid, cw, none, st);
    case 192:
      return launch_gemm<192, WALK, EPI_STORE>(ma, mb, mc, mc, m, r, nout,
                                               stages, grid, cw, none, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool DGRAD>
int launch_im2col_walk(const Im2colMaps& ma, const CUtensorMap& mb,
                       const CUtensorMap& mc, int nout, int bn, int stages,
                       int grid, const Im2colWalk& iw, cudaStream_t st) {
  const FusedDx none{};
  switch (bn) {
    case 64:
      return launch_conv_im2col<64, DGRAD, EPI_STORE>(
          ma, mb, mc, mc, nout, stages, grid, iw, none, st);
    case 128:
      return launch_conv_im2col<128, DGRAD, EPI_STORE>(
          ma, mb, mc, mc, nout, stages, grid, iw, none, st);
    case 192:
      return launch_conv_im2col<192, DGRAD, EPI_STORE>(
          ma, mb, mc, mc, nout, stages, grid, iw, none, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// w, pm (K, N) f32 and own (K, N) int8 -> out bf16: w_eff (K, N), or with
// transpose w_eff^T (N, K). K and N multiples of 8; w, pm 16-byte and out
// 16-byte aligned. Returns cudaGetLastError().
int masked_matmul_select_bf16(const void* w, const void* own, const void* pm,
                              void* out, int k, int n, int task, float thr,
                              int ternary, int transpose, void* stream) {
  if (k % 8 || n % 8) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + SN - 1) / SN, (k + SK - 1) / SK);
  if (transpose)
    select_bf16_kernel<true><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const float*)w, (const int8_t*)own, (const float*)pm, (bf16*)out, k,
        n, task, thr, ternary);
  else
    select_bf16_kernel<false><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const float*)w, (const int8_t*)own, (const float*)pm, (bf16*)out, k,
        n, task, thr, ternary);
  return (int)cudaGetLastError();
}

// C (M, Nout) = A (M, R) @ Bt (Nout, R)^T, bf16 row-major, f32 sums. R and
// Nout multiples of 8, bases 16-byte aligned; bn (tile width: 64, 128 or
// 192), stages and grid from ops/masked_matmul.py `gemm_plan`.
int masked_matmul_gemm_tn_bf16(const void* a, const void* bt, void* c, int m,
                               int r, int nout, int bn, int stages, int grid,
                               void* stream) {
  if (m <= 0 || r <= 0 || nout <= 0 || r % 8 || nout % 8 ||
      bad_plan(bn, stages, grid))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb, mc;  // C in 64 x 64 boxes (64 columns: one 128-B row)
  if (!make_map(&ma, a, m, r, BM) || !make_map(&mb, bt, nout, r, bn) ||
      !make_map(&mc, c, m, nout, 64))
    return (int)cudaErrorInvalidValue;
  return launch_walk<DENSE>(ma, mb, mc, m, r, nout, bn, stages, grid,
                            ConvWalk{}, (cudaStream_t)stream);
}

// Stride-1 masked conv over the selected weight, as an implicit GEMM (see
// the top). Forward (dgrad = 0): a = x (n, ah, aw, ch) with ch = Cin, bt =
// w_eff^T (nout = Cout, taps * ch), c = y (n * oh * ow, nout). Input
// gradient (dgrad = 1): a = g (n, ah, aw, ch) with ch = Cout, bt = w_eff
// (taps * nout, ch) with nout = Cin, c = dx (n * oh * ow, nout). taps = kh
// * kw; (oh, ow) is the output grid, tiled by boxes of (64, ow, box_h,
// box_n) with ow * box_h * box_n = 128; ch % 64 == 0, nout % 8 == 0, bases
// 16-byte aligned; bn, stages and grid from ops/masked_matmul.py
// `conv_plan`.
int masked_conv_gemm_bf16(const void* a, const void* bt, void* c, int n,
                          int ah, int aw, int ch, int oh, int ow, int nout,
                          int kh, int kw, int pad_top, int pad_left,
                          int dgrad, int box_h, int box_n, int bn, int stages,
                          int grid, void* stream) {
  const int taps = kh * kw, m = n * oh * ow;
  if (n <= 0 || ch <= 0 || ch % BK || nout <= 0 || nout % 8 || taps <= 0 ||
      ow * box_h * box_n != BM || bad_plan(bn, stages, grid))
    return (int)cudaErrorInvalidValue;
  const long long adims[4] = {ch, aw, ah, n};
  const int abox[4] = {BK, ow, box_h, box_n};
  CUtensorMap ma, mb, mc;
  bool ok = make_map_nd(&ma, a, 4, adims, abox) &&
            make_map(&mc, c, m, nout, 64);
  if (dgrad) {  // w_eff (taps, Cin, Cout) in boxes of 64 Cout x bn Cin
    const long long bdims[3] = {ch, nout, taps};
    const int bbox[3] = {BK, bn, 1};
    ok = ok && make_map_nd(&mb, bt, 3, bdims, bbox);
  } else {
    ok = ok && make_map(&mb, bt, nout, taps * ch, bn);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  const ConvWalk cw{ch / BK, kw, oh * ow, ow, pad_top, pad_left};
  cudaStream_t st = (cudaStream_t)stream;
  return dgrad ? launch_walk<CONV_DGRAD>(ma, mb, mc, m, taps * ch, nout, bn,
                                         stages, grid, cw, st)
               : launch_walk<CONV_FWD>(ma, mb, mc, m, taps * ch, nout, bn,
                                       stages, grid, cw, st);
}

// The masked conv's y or dx over the selected weight at any output grid,
// stride 1 or 2, as an implicit GEMM over im2col loads (see the top). a is
// x (n, ah, aw, ch = Cin) for the forward, g (n, ah = Ho, aw = Wo, ch =
// Cout) for the input gradient (dgrad); bt is w_eff^T (nout = Cout, taps *
// ch) or w_eff (taps * nout, ch) with nout = Cin; c is y (n, oh, ow, nout)
// or dx (n, oh = H, ow = W, nout). phases holds nphases rows of PHASE_INTS
// ints {rows, columns, lower_w, lower_h, row0, col0, ntaps, taps[9]}, from
// ops/masked_matmul.py `im2col_plan`: the forward's one phase walks (oh,
// ow) at traversal `stride`; the input gradient walks g at stride 1, in
// one phase at stride 1 (stored as y is) or in stride^2 = 4 parity phases
// at stride 2, each stored to dx's rows (row0 + 2 i, col0 + 2 j). ch % 64
// == 0, nout % 8 == 0, bases 16-byte aligned; bn, stages, grid from
// `im2col_plan` (tma_gemm.cuh `make_im2col_walk` reads the table).
int masked_conv_im2col_gemm_bf16(const void* a, const void* bt, void* c,
                                 int n, int ah, int aw, int ch, int oh,
                                 int ow, int nout, int taps, int stride,
                                 int dgrad, const int* phases, int nphases,
                                 int bn, int stages, int grid, void* stream) {
  Im2colWalk iw;
  Im2colMaps ma;
  if (bad_plan(bn, stages, grid) ||
      !make_im2col_walk(&iw, &ma, a, n, ah, aw, ch, oh, ow, nout, taps,
                        stride, dgrad, phases, nphases, bn, c))
    return (int)cudaErrorInvalidValue;
  if (iw.tiles == 0) return (int)cudaSuccess;
  CUtensorMap mb{}, mc{};
  bool ok = true;
  if (dgrad) {  // w_eff (taps, Cin, Cout) in boxes of 64 Cout x bn Cin
    const long long bdims[3] = {ch, nout, taps};
    const int bbox[3] = {BK, bn, 1};
    ok = make_map_nd(&mb, bt, 3, bdims, bbox);
  } else {
    ok = make_map(&mb, bt, nout, taps * ch, bn);
  }
  if (!iw.scatter) ok = ok && make_map(&mc, c, n * oh * ow, nout, 64);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return dgrad ? launch_im2col_walk<true>(ma, mb, mc, nout, bn, stages, grid,
                                          iw, st)
               : launch_im2col_walk<false>(ma, mb, mc, nout, bn, stages, grid,
                                           iw, st);
}

}  // extern "C"
