// Fused BN-affine + ReLU + 3x3 SAME conv backward: dx, da, db (K5).
//
// Replaces: cpg_tpu/ops/pallas/fused_chain.py `_bwd_pallas` through
// `_bwd_dx_kernel` (the TPU kernel behind the custom VJP of
// `fused_affine_relu_conv`), and the XLA backward `_fused_bwd_xla` that JAX
// used for the 2x2 seams: every shape the forward takes has a kernel here,
// so no seam switches to a plain version.
//
//   dact = conv_transpose(g, W)          (dot-dtype operands, f32 sums)
//   dmasked = dact * 1[a*x + b > 0]
//   dx = dmasked * a  (x's dtype),  da = sum dmasked * x,  db = sum dmasked
//
// What bounds it on the H100: operations at every VGG16-BN seam at batch
// 256 (4.8-19.3 GFLOP against 3-50 MB of x, g and dx) and at every
// ResNet-50 seam at batch 32 (7.4 GFLOP against 10-19 MB). Three routes,
// chosen by ops/fused_chain.py before the launch (`dx_route`):
//
// * bf16 with Cin and Cout multiples of 64 on a grid that `conv_box` tiles
//   (every VGG16-BN seam at width 1.0): `fused_chain_bwd_dx_gemm_bf16`.
//   dact is the persistent TMA + wgmma GEMM of tma_gemm.cuh on its
//   CONV_DGRAD walk, unchanged: A is g's mirrored per-tap 4-D TMA box (its
//   zero fill is the padding), B the seam's bf16 HWIO weight as it is,
//   through a 3-D (Cout, Cin, taps) map; the output tile is 128 input
//   pixels x BN input channels. Its epilogue (EPI_FUSED_DX) is K5's: the
//   producer loads x's 128 x BN tile by TMA on a barrier of its own, once
//   the ring holds the tile's first stages; the consumers recompute pre =
//   a*x + b with the product and the sum rounded apart (`__fmul_rn`,
//   `__fadd_rn`: nvcc would contract x*a + b into an FMA, and the mask must
//   be the plain version's bit for bit), write dx = bf16(dm * a) through
//   the staging tile and a TMA store, and sum the tile's columns of dm * x
//   and dm in a fixed order (the thread's two rows, a butterfly over the
//   lanes that share columns, the 8 warps in order through shared memory)
//   into an f32 workspace (2, tiles, Cin). Plan (tile width, ring depth,
//   grid): ops/masked_matmul.py `fused_dx_plan`.
// * bf16 with Cin and Cout multiples of 64 on any other grid (ResNet-50's
//   56, 28, 14 and 7-pixel seams, where 128 is a multiple of no row or
//   image, and where conv_bwd.cuh's dgrad below ran 2.3x cuDNN's dgrad):
//   `fused_chain_bwd_dx_im2col_bf16`. dact is tma_gemm.cuh's
//   `conv_im2col_kernel` on the stride-1 dgrad walk (one phase, the taps
//   mirrored: each k-step one TMA im2col load of 128 consecutive pixels of
//   g, wrapping rows and images, zeros outside), with the same B map and
//   the same epilogue (`fused_dx_epilogue`): dx's 128-row tile is 128
//   consecutive pixels, so x's tile is again a plain 2-D box of x as (M,
//   Cin). Plan: ops/masked_matmul.py `fused_dx_im2col_plan`.
// * every other shape (f32, narrow widths): `fused_chain_bwd_dx_bf16` /
//   `_f32`, the implicit-GEMM dgrad of conv_bwd.cuh (mma.sync, the A tile
//   gathering g around each pixel, W read transposed) with the mask in its
//   epilogue and 128-pixel column partials.
//
// Either way `colsum_kernel` then sums the tiles' partials in tile order:
// no float atomics, two runs give the same bits. Neither the activation nor
// dact reaches device memory.
#include "conv_bwd.cuh"
#include "tma_gemm.cuh"

using namespace cpg::bwd;
namespace gm = cpg::gemm;

namespace {

// out[which][c] = sum over tiles of ws[which][tile][c] in a fixed order:
// thread row y sums tiles y, y + 32, ... in order (eight loads in flight),
// then row 0 sums the 32 rows in order
constexpr int COLSUM_ROWS = 32;

__global__ void colsum_kernel(const float* __restrict__ ws_da,
                              const float* __restrict__ ws_db, int tiles,
                              int cin, float* __restrict__ da,
                              float* __restrict__ db) {
  __shared__ float part[COLSUM_ROWS][33];
  const float* ws = blockIdx.y ? ws_db : ws_da;
  const int c = blockIdx.x * 32 + threadIdx.x;
  float v = 0.f;
  if (c < cin) {
#pragma unroll 8
    for (int t = threadIdx.y; t < tiles; t += COLSUM_ROWS)
      v += ws[(long long)t * cin + c];
  }
  part[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && c < cin) {
    float sum = 0.f;
    for (int r = 0; r < COLSUM_ROWS; ++r) sum += part[r][threadIdx.x];
    (blockIdx.y ? db : da)[c] = sum;
  }
}

int launch_colsum(const void* ws_da, const void* ws_db, int tiles, int cin,
                  void* da, void* db, void* stream) {
  colsum_kernel<<<dim3((unsigned)((cin + 31) / 32), 2), dim3(32, COLSUM_ROWS), 0,
                  (cudaStream_t)stream>>>((const float*)ws_da,
                                          (const float*)ws_db, tiles, cin,
                                          (float*)da, (float*)db);
  return (int)cudaGetLastError();
}

template <typename T, typename K>
int launch(K kernel, const void* x, const void* g, const void* a,
           const void* b, const void* w, void* dx, void* ws_da, void* ws_db,
           void* da, void* db, int n, int h, int wd, int cin, int cout,
           void* stream) {
  const ConvShape s{n, h, wd, cin, h, wd, cout, 3, 3, 1, 1, 1};
  DgradArgs<T> p{};
  p.g = (const T*)g;
  p.wt = (const T*)w;
  p.dx = (T*)dx;
  p.x = (const T*)x;
  p.a = (const float*)a;
  p.b = (const float*)b;
  p.ws_da = (float*)ws_da;
  p.ws_db = (float*)ws_db;
  const dim3 grid = dgrad_grid(s);
  kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(p, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_colsum(ws_da, ws_db, (int)grid.x, cin, da, db, stream);
}

bool bad_shape(int n, int h, int wd, int cin, int cout) {
  return n < 1 || h < 1 || wd < 1 || cin < 1 || cout < 1;
}

template <int BN>
int launch_route(const CUtensorMap& mg, const CUtensorMap& mw,
                 const CUtensorMap& mdx, const CUtensorMap& mx, int m,
                 int cin, int cout, int stages, int grid,
                 const gm::ConvWalk& cw, const gm::FusedDx& fd,
                 cudaStream_t st) {
  return gm::launch_gemm<BN, gm::CONV_DGRAD, gm::EPI_FUSED_DX>(
      mg, mw, mdx, mx, m, 9 * cout, cin, stages, grid, cw, fd, st);
}

}  // namespace

extern "C" {

// x (N,H,W,Cin), g (N,H,W,Cout), w (3,3,Cin,Cout) and dx (N,H,W,Cin) bf16;
// a, b, da, db (Cin,) f32; ws_da, ws_db (ceil(N*H*W / 128), Cin) f32
// scratch. All contiguous on one device, x, g, w 16-byte aligned, Cin and
// Cout multiples of 8. Returns cudaGetLastError().
int fused_chain_bwd_dx_bf16(const void* x, const void* g, const void* a,
                            const void* b, const void* w, void* dx,
                            void* ws_da, void* ws_db, void* da, void* db,
                            int n, int h, int wd, int cin, int cout,
                            void* stream) {
  if (bad_shape(n, h, wd, cin, cout) || cin % 8 || cout % 8)
    return (int)cudaErrorInvalidValue;
  return launch<__nv_bfloat16>(dgrad_bf16_kernel<true>, x, g, a, b, w, dx,
                               ws_da, ws_db, da, db, n, h, wd, cin, cout,
                               stream);
}

// The same with f32 x, g, w and dx, any Cin and Cout.
int fused_chain_bwd_dx_f32(const void* x, const void* g, const void* a,
                           const void* b, const void* w, void* dx,
                           void* ws_da, void* ws_db, void* da, void* db,
                           int n, int h, int wd, int cin, int cout,
                           void* stream) {
  if (bad_shape(n, h, wd, cin, cout)) return (int)cudaErrorInvalidValue;
  return launch<float>(dgrad_f32_kernel<true>, x, g, a, b, w, dx, ws_da,
                       ws_db, da, db, n, h, wd, cin, cout, stream);
}

// The GEMM route (see the top): x (N,H,W,Cin), g (N,H,W,Cout), w
// (3,3,Cin,Cout) and dx (N,H,W,Cin) bf16; a, b, da, db (Cin,) f32; ws_da,
// ws_db (ceil(N*H*W / 128), Cin) f32 scratch. Cin and Cout multiples of
// 64, bases 16-byte aligned; the 128-pixel tile is the box (64, W, box_h,
// box_n) of ops/masked_conv.py `conv_box`; bn (64 or 128), stages and
// grid from ops/masked_matmul.py `fused_dx_plan`. Returns
// cudaGetLastError().
int fused_chain_bwd_dx_gemm_bf16(const void* x, const void* g, const void* a,
                                 const void* b, const void* w, void* dx,
                                 void* ws_da, void* ws_db, void* da, void* db,
                                 int n, int h, int wd, int cin, int cout,
                                 int box_h, int box_n, int bn, int stages,
                                 int grid, void* stream) {
  if (bad_shape(n, h, wd, cin, cout) || cin % gm::BK || cout % gm::BK ||
      wd * box_h * box_n != gm::BM ||
      gm::bad_plan(bn, stages, grid, gm::EPI_FUSED_DX))
    return (int)cudaErrorInvalidValue;
  const int m = n * h * wd;
  const long long gdims[4] = {cout, wd, h, n};
  const int gbox[4] = {gm::BK, wd, box_h, box_n};
  const long long wdims[3] = {cout, cin, 9};  // w as (taps, Cin, Cout)
  const int wbox[3] = {gm::BK, bn, 1};
  CUtensorMap mg, mw, mdx, mx;
  if (!cpg::hopper::make_map_nd(&mg, g, 4, gdims, gbox) ||
      !cpg::hopper::make_map_nd(&mw, w, 3, wdims, wbox) ||
      !gm::make_map(&mdx, dx, m, cin, 64) || !gm::make_map(&mx, x, m, cin, 64))
    return (int)cudaErrorInvalidValue;
  const gm::ConvWalk cw{cout / gm::BK, 3, h * wd, wd, 1, 1};
  const gm::FusedDx fd{(const float*)a, (const float*)b, (float*)ws_da,
                       (float*)ws_db, cin};
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  switch (bn) {
    case 64:
      err = launch_route<64>(mg, mw, mdx, mx, m, cin, cout, stages, grid, cw,
                             fd, st);
      break;
    case 128:
      err = launch_route<128>(mg, mw, mdx, mx, m, cin, cout, stages, grid,
                              cw, fd, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return launch_colsum(ws_da, ws_db, (m + gm::BM - 1) / gm::BM, cin, da, db,
                       stream);
}

// The im2col route (see the top): the GEMM route's tensors and scratch at
// any grid; phases is the stride-1 dgrad's one phase as ops/masked_matmul.py
// `im2col_plan` writes it (tma_gemm.cuh `make_im2col_walk`); bn (64 or
// 128), stages and grid from ops/masked_matmul.py `fused_dx_im2col_plan`.
// Returns cudaGetLastError().
int fused_chain_bwd_dx_im2col_bf16(const void* x, const void* g,
                                   const void* a, const void* b,
                                   const void* w, void* dx, void* ws_da,
                                   void* ws_db, void* da, void* db, int n,
                                   int h, int wd, int cin, int cout,
                                   const int* phases, int bn, int stages,
                                   int grid, void* stream) {
  gm::Im2colWalk iw;
  gm::Im2colMaps ma;
  if (bad_shape(n, h, wd, cin, cout) || cin % gm::BK || cout % gm::BK ||
      gm::bad_plan(bn, stages, grid, gm::EPI_FUSED_DX) ||
      !gm::make_im2col_walk(&iw, &ma, g, n, h, wd, cout, h, wd, cin, 9, 1, 1,
                            phases, 1, bn, dx) ||
      iw.ph[0].ntaps != 9)
    return (int)cudaErrorInvalidValue;
  const int m = n * h * wd;
  const long long wdims[3] = {cout, cin, 9};  // w as (taps, Cin, Cout)
  const int wbox[3] = {gm::BK, bn, 1};
  CUtensorMap mw, mdx, mx;
  if (!cpg::hopper::make_map_nd(&mw, w, 3, wdims, wbox) ||
      !gm::make_map(&mdx, dx, m, cin, 64) || !gm::make_map(&mx, x, m, cin, 64))
    return (int)cudaErrorInvalidValue;
  const gm::FusedDx fd{(const float*)a, (const float*)b, (float*)ws_da,
                       (float*)ws_db, cin};
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  switch (bn) {
    case 64:
      err = gm::launch_conv_im2col<64, true, gm::EPI_FUSED_DX>(
          ma, mw, mdx, mx, cin, stages, grid, iw, fd, st);
      break;
    case 128:
      err = gm::launch_conv_im2col<128, true, gm::EPI_FUSED_DX>(
          ma, mw, mdx, mx, cin, stages, grid, iw, fd, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return launch_colsum(ws_da, ws_db, (m + gm::BM - 1) / gm::BM, cin, da, db,
                       stream);
}

}  // extern "C"
