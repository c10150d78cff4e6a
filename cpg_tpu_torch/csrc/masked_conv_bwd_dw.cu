// Masked (CPG SharableConv2d) convolution backward, gated weight and
// piggymask gradients (K3).
//
// Replaces: cpg_tpu/ops/pallas/masked_matmul.py `_bwd_dw` / `_bwd_dw_kernel`
// (reached through the custom VJP of cpg_tpu/ops/pallas/masked_conv.py
// `masked_conv2d`).
//
//   G[dh,dw,c,o] = sum_{n,oh,ow} x_pad[n, oh*s+dh, ow*s+dw, c] * g[n,oh,ow,o]
//   dw  = G       where own == task, else 0
//   dpm = G * w   where 0 < own < task, else 0   (binary and ternary alike)
//
// An implicit-GEMM wgrad (conv_bwd.cuh) over the patches of x, never
// materialised: K = kh*kw*Cin rows, N_gemm = Cout, reduced over M = N*Ho*Wo
// (262,144 at conv0 batch 256, 1,024 at conv10). The TPU kernel carried the
// sum across its sequential grid in VMEM; on the card the M reduction is
// split over blocks, each writing an f32 partial, and a second kernel sums
// the partials in split order and applies the ownership gating on the way
// out: the train step's gating of these layers happens here, and two runs
// give the same bits. Ragged K (conv0: 27), M and Cout are masked in the
// kernel.
//
// What bounds it on the H100: conv2..conv10 are compute-bound at batch 256;
// conv0 (Cin = 3, K = 27) is bound by reading g. bf16 needs Cout % 4 == 0;
// the x loads are 16-byte vectors when Cin % 8 == 0 and scalar otherwise.
#include "conv_bwd.cuh"

using namespace cpg::bwd;

namespace {

__global__ void gate_kernel(const float* __restrict__ ws, int splits,
                            long long entries, const float* __restrict__ w,
                            const int8_t* __restrict__ own, int task,
                            float* __restrict__ dw, float* __restrict__ dpm) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= entries) return;
  const float G = splitk_sum(ws, splits, entries, e);
  const int o = own[e];
  dw[e] = o == task ? G : 0.f;
  dpm[e] = (o > 0 && o < task) ? G * w[e] : 0.f;
}

template <typename T, typename K>
int launch(K kernel, const void* x, const void* g, const void* w,
           const void* own, void* ws, void* dw, void* dpm, const ConvShape& s,
           int task, int splits, void* stream) {
  WgradArgs<T> p{(const T*)x, (const T*)g, nullptr, nullptr, (float*)ws, 0};
  const dim3 grid = wgrad_grid(s, splits, p);
  kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(p, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long entries = (long long)s.kh * s.kw * s.cin * s.cout;
  gate_kernel<<<(unsigned)((entries + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)ws, splits, entries, (const float*)w, (const int8_t*)own,
      task, (float*)dw, (float*)dpm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (N,H,W,Cin) and g (N,Ho,Wo,Cout) bf16; w (kh,kw,Cin,Cout) f32, own
// int8; ws (splits, kh*kw*Cin, Cout) f32 scratch; dw, dpm like w. All
// contiguous on one device, 16-byte aligned (own 4-byte), Cout a multiple
// of 4, splits >= 1. Returns cudaGetLastError().
int masked_conv_bwd_dw_bf16(const void* x, const void* g, const void* w,
                            const void* own, void* ws, void* dw, void* dpm,
                            int n, int h, int wd, int cin, int ho, int wo,
                            int cout, int kh, int kw, int stride, int pad_top,
                            int pad_left, int task, int splits, void* stream) {
  if (cout % 4 || splits < 1) return (int)cudaErrorInvalidValue;
  const ConvShape s{n, h, wd, cin, ho, wo, cout, kh, kw, stride, pad_top,
                    pad_left};
  if (cin % 8 == 0)
    return launch<__nv_bfloat16>(wgrad_bf16_kernel<false, true>, x, g, w, own,
                                 ws, dw, dpm, s, task, splits, stream);
  return launch<__nv_bfloat16>(wgrad_bf16_kernel<false, false>, x, g, w, own,
                               ws, dw, dpm, s, task, splits, stream);
}

// The same with f32 x and g, any Cin and Cout.
int masked_conv_bwd_dw_f32(const void* x, const void* g, const void* w,
                           const void* own, void* ws, void* dw, void* dpm,
                           int n, int h, int wd, int cin, int ho, int wo,
                           int cout, int kh, int kw, int stride, int pad_top,
                           int pad_left, int task, int splits, void* stream) {
  if (splits < 1) return (int)cudaErrorInvalidValue;
  const ConvShape s{n, h, wd, cin, ho, wo, cout, kh, kw, stride, pad_top,
                    pad_left};
  return launch<float>(wgrad_f32_kernel<false>, x, g, w, own, ws, dw, dpm, s,
                       task, splits, stream);
}

}  // extern "C"
