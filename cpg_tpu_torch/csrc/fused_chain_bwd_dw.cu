// Fused BN-affine + ReLU + 3x3 SAME conv backward: dW (K6).
//
// Replaces: cpg_tpu/ops/pallas/fused_chain.py `_bwd_pallas` through
// `_bwd_dw_kernel` (and, for the 2x2 seams, the XLA backward
// `_fused_bwd_xla` that JAX fell back to).
//
//   dW[dy,dx,c,o] = sum_{n,h,w} act[n, h+dy-1, w+dx-1, c] * g[n,h,w,o]
//   act = relu(a*x + b) in f32, cast to the dot dtype; 0 outside the image
//
// An implicit-GEMM wgrad (conv_bwd.cuh) with stride 1 and padding 1. The
// activation is recomputed from x in the operand load and cast to the dot
// dtype there, as the TPU kernel did, so it never reaches device memory;
// positions in the SAME padding are 0, not relu(b). The TPU kernel carried
// dW across its sequential grid in VMEM; here the reduction over the
// N*H*W pixels is split over blocks, each writing an f32 partial, and a
// second kernel sums the partials in split order: two runs give the same
// bits.
//
// What bounds it on the H100: compute at every VGG16-BN seam at batch 256.
// bf16 needs Cin and Cout in multiples of 8; f32 takes any shape.
#include "conv_bwd.cuh"

using namespace cpg::bwd;

namespace {

__global__ void sum_kernel(const float* __restrict__ ws, int splits,
                           long long entries, float* __restrict__ dw) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < entries) dw[e] = splitk_sum(ws, splits, entries, e);
}

template <typename T, typename K>
int launch(K kernel, const void* x, const void* g, const void* a,
           const void* b, void* ws, void* dw, int n, int h, int wd, int cin,
           int cout, int splits, void* stream) {
  const ConvShape s{n, h, wd, cin, h, wd, cout, 3, 3, 1, 1, 1};
  WgradArgs<T> p{(const T*)x, (const T*)g, (const float*)a, (const float*)b,
                 (float*)ws, 0};
  const dim3 grid = wgrad_grid(s, splits, p);
  kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(p, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long entries = 9LL * cin * cout;
  sum_kernel<<<(unsigned)((entries + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)ws, splits, entries, (float*)dw);
  return (int)cudaGetLastError();
}

bool bad_shape(int n, int h, int wd, int cin, int cout, int splits) {
  return n < 1 || h < 1 || wd < 1 || cin < 1 || cout < 1 || splits < 1;
}

}  // namespace

extern "C" {

// x (N,H,W,Cin) and g (N,H,W,Cout) bf16; a, b (Cin,) f32; ws (splits,
// 9*Cin, Cout) f32 scratch; dw (3,3,Cin,Cout) f32. All contiguous on one
// device, x and g 16-byte aligned, Cin and Cout multiples of 8. Returns
// cudaGetLastError().
int fused_chain_bwd_dw_bf16(const void* x, const void* g, const void* a,
                            const void* b, void* ws, void* dw, int n, int h,
                            int wd, int cin, int cout, int splits,
                            void* stream) {
  if (bad_shape(n, h, wd, cin, cout, splits) || cin % 8 || cout % 8)
    return (int)cudaErrorInvalidValue;
  return launch<__nv_bfloat16>(wgrad_bf16_kernel<true, true>, x, g, a, b, ws,
                               dw, n, h, wd, cin, cout, splits, stream);
}

// The same with f32 x and g, any Cin and Cout.
int fused_chain_bwd_dw_f32(const void* x, const void* g, const void* a,
                           const void* b, void* ws, void* dw, int n, int h,
                           int wd, int cin, int cout, int splits,
                           void* stream) {
  if (bad_shape(n, h, wd, cin, cout, splits)) return (int)cudaErrorInvalidValue;
  return launch<float>(wgrad_f32_kernel<true>, x, g, a, b, ws, dw, n, h, wd,
                       cin, cout, splits, stream);
}

}  // extern "C"
