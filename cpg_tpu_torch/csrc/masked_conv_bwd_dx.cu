// Masked (CPG SharableConv2d) convolution backward, input gradient (K2).
//
// Replaces: cpg_tpu/ops/pallas/masked_matmul.py `_bwd_dx` / `_bwd_dx_kernel`
// (reached through the custom VJP of cpg_tpu/ops/pallas/masked_conv.py
// `masked_conv2d`), with the ownership/piggymask select of `_mask_tile`.
//
//   dx[n,ih,iw,c] = sum_{dh,dw,o} g[n,oh,ow,o] * w_eff[dh,dw,c,o]
//                   over the (oh, ow) with ih = oh*s - pad_top + dh (and
//                   likewise for iw)
//
// An implicit-GEMM dgrad (conv_bwd.cuh): M = N*H*W input pixels, N_gemm =
// Cin, K = kh*kw*Cout. The A tile is gathered from g with the stride and the
// XLA-resolved (possibly asymmetric) padding that the forward used; the
// effective weight is selected in f32 from w/own/pm in the B-tile load, read
// transposed (reduce over Cout, output over Cin) and cast to the activation
// dtype there, so it never reaches device memory. Ragged M, N and K are
// masked in the kernel. At stride > 1 each pixel's taps that no output reads
// are zero rows of A (correct, and stride 1 is the VGG16 case).
//
// What bounds it on the H100: at VGG16-BN's batch-256 shapes (conv2, 4, 7,
// 10) the work is compute-bound, except conv10 whose 9 bytes per weight
// entry dominate. bf16 needs Cout % 4 == 0 (8-byte loads of g and of four
// weight entries); f32 takes any shape.
#include "conv_bwd.cuh"

using namespace cpg::bwd;

namespace {

template <typename T>
DgradArgs<T> args(const void* g, const void* w, const void* own,
                  const void* pm, void* dx, int task, float thr, int ternary) {
  DgradArgs<T> p{};
  p.g = (const T*)g;
  p.w = (const float*)w;
  p.own = (const int8_t*)own;
  p.pm = (const float*)pm;
  p.task = task;
  p.thr = thr;
  p.ternary = ternary;
  p.dx = (T*)dx;
  return p;
}

}  // namespace

extern "C" {

// g (N,Ho,Wo,Cout) and dx (N,H,W,Cin) bf16; w/pm (kh,kw,Cin,Cout) f32, own
// int8; all contiguous on one device, 16-byte aligned (own 4-byte), Cout a
// multiple of 4. Returns cudaGetLastError().
int masked_conv_bwd_dx_bf16(const void* g, const void* w, const void* own,
                            const void* pm, void* dx, int n, int h, int wd,
                            int cin, int ho, int wo, int cout, int kh, int kw,
                            int stride, int pad_top, int pad_left, int task,
                            float thr, int ternary, void* stream) {
  if (cout % 4) return (int)cudaErrorInvalidValue;
  const ConvShape s{n, h, wd, cin, ho, wo, cout, kh, kw, stride, pad_top,
                    pad_left};
  dgrad_bf16_kernel<false><<<dgrad_grid(s), NT, 0, (cudaStream_t)stream>>>(
      args<__nv_bfloat16>(g, w, own, pm, dx, task, thr, ternary), s);
  return (int)cudaGetLastError();
}

// The same with f32 g and dx, any Cin and Cout.
int masked_conv_bwd_dx_f32(const void* g, const void* w, const void* own,
                           const void* pm, void* dx, int n, int h, int wd,
                           int cin, int ho, int wo, int cout, int kh, int kw,
                           int stride, int pad_top, int pad_left, int task,
                           float thr, int ternary, void* stream) {
  const ConvShape s{n, h, wd, cin, ho, wo, cout, kh, kw, stride, pad_top,
                    pad_left};
  dgrad_f32_kernel<false><<<dgrad_grid(s), NT, 0, (cudaStream_t)stream>>>(
      args<float>(g, w, own, pm, dx, task, thr, ternary), s);
  return (int)cudaGetLastError();
}

}  // extern "C"
