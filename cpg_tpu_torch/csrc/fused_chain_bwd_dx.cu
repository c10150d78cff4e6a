// Fused BN-affine + ReLU + 3x3 SAME conv backward: dx, da, db (K5).
//
// Replaces: cpg_tpu/ops/pallas/fused_chain.py `_bwd_pallas` through
// `_bwd_dx_kernel` (the TPU kernel behind the custom VJP of
// `fused_affine_relu_conv`), and the XLA backward `_fused_bwd_xla` that JAX
// used for the 2x2 seams: this kernel takes every shape the forward kernel
// takes, so no seam switches implementation.
//
//   dact = conv_transpose(g, W)          (dot-dtype operands, f32 sums)
//   dmasked = dact * 1[a*x + b > 0]
//   dx = dmasked * a  (x's dtype),  da = sum dmasked * x,  db = sum dmasked
//
// dact is an implicit-GEMM dgrad (conv_bwd.cuh) with stride 1 and padding 1:
// the A tile gathers g around each pixel, zero outside its image, the B
// tile is W read transposed. The ReLU mask is recomputed from x in the
// epilogue, so neither the activation nor dact reaches device memory. The
// TPU kernel summed da and db across its sequential grid; here each block
// writes its 128-pixel column sums to an f32 workspace (a fixed-order warp
// shuffle and a fixed-order sum over the block's four warp rows), and a
// second kernel sums the blocks in order: two runs give the same bits.
//
// What bounds it on the H100: compute at every VGG16-BN seam at batch 256.
// bf16 needs Cin and Cout in multiples of 8 (the forward kernel's
// predicate); f32 takes any shape.
#include "conv_bwd.cuh"

using namespace cpg::bwd;

namespace {

// out[which][c] = sum over tiles of ws[which][tile][c], tiles in order
__global__ void colsum_kernel(const float* __restrict__ ws_da,
                              const float* __restrict__ ws_db, int tiles,
                              int cin, float* __restrict__ da,
                              float* __restrict__ db) {
  __shared__ float part[8][33];
  const float* ws = blockIdx.y ? ws_db : ws_da;
  const int c = blockIdx.x * 32 + threadIdx.x;
  float v = 0.f;
  if (c < cin)
    for (int t = threadIdx.y; t < tiles; t += 8) v += ws[(long long)t * cin + c];
  part[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && c < cin) {
    float sum = 0.f;
    for (int r = 0; r < 8; ++r) sum += part[r][threadIdx.x];
    (blockIdx.y ? db : da)[c] = sum;
  }
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
  colsum_kernel<<<dim3((unsigned)((cin + 31) / 32), 2), dim3(32, 8), 0,
                  (cudaStream_t)stream>>>((const float*)ws_da,
                                          (const float*)ws_db, (int)grid.x,
                                          cin, (float*)da, (float*)db);
  return (int)cudaGetLastError();
}

bool bad_shape(int n, int h, int wd, int cin, int cout) {
  return n < 1 || h < 1 || wd < 1 || cin < 1 || cout < 1;
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

}  // extern "C"
