// Fused BN-affine + ReLU + 3x3 SAME conv backward: dW (K6).
//
// Replaces: cpg_tpu/ops/pallas/fused_chain.py `_bwd_pallas` through
// `_bwd_dw_kernel` (and, for the 2x2 seams, the XLA backward
// `_fused_bwd_xla` that JAX fell back to).
//
//   dW[dy,dx,c,o] = sum_{n,h,w} act[n, h+dy-1, w+dx-1, c] * g[n,h,w,o]
//   act = relu(a*x + b) in f32, cast to the dot dtype; 0 outside the image
//
// The activation never reaches device memory, as in the TPU kernel; SAME
// padding is 0, not relu(b). The TPU kernel carried dW across its
// sequential grid in VMEM; here the reduction over the N*H*W pixels is split
// over blocks, each writing an f32 partial, and a second kernel sums the
// partials in split order: two runs give the same bits (no float atomics).
//
// What bounds it on the H100: compute. A seam at batch 256 is 2*N*H*W*9*
// Cin*Cout = 19.3 GFLOP (4.8 at 2x2) against 67-72 MB of x and g, 270-290
// FLOPs a byte, at the card's bf16 ridge (~295); the work is to keep the
// tensor cores fed: fetch and activate each x element once, not once per
// tap, and keep loads in flight under the products.
//
// The bf16 kernel here (dw_bf16_kernel):
//   * Tile. A block owns all nine taps of 32 input channels x 64 output
//     channels, one warp per tap (9 warps, 32x64 f32 accumulators each; one
//     block an SM: two would share an SM partition five warps to four and
//     cap the registers at 96 a thread, which spills and ran slower), and
//     walks a run of steps; a step is R whole image rows (R*W <= 128
//     pixels): with a halo row above and below when R divides H (16x16,
//     32x32), or R/H whole images, no halo needed, at the 8x8 and smaller
//     seams.
//   * Act once per element. Raw x lands in shared memory by cp.async; one
//     pass per step turns each thread's own 16-byte vectors into
//     bf16(relu(a*x+b)), 0 in the padding, so each element is read from
//     device memory once per block and activated once. The nine taps' A
//     operands are then the same act tile read at shifted rows: each lane
//     gives ldmatrix.trans the address of its pixel's neighbour, or of an
//     all-zero row where the neighbour is outside the image. These offsets
//     depend only on the lane, the tap and the step's shape, so they are
//     computed once per block: no division in the loop.
//   * Ring. Three stages of raw x and g (16-byte cp.async, one commit group
//     per step); the loads of step i+2 run under the products of step i.
//     Up to 128 pixels (8 k16 steps, 128 mma.sync per warp) per pair of
//     barriers.
//   * Product: mma.sync m16n8k16, f32 accumulation. wgmma would need A as
//     64 rows of one tap per warpgroup and g in the wgmma shared-memory
//     layout; that is left for later (PERF.md has the cost).
//   * Split-K. The split count per seam comes from the wrapper's own plan
//     (ops/fused_chain.py `k6_plan`); with one split the kernel writes dW
//     directly.
// bf16 needs Cin and Cout in multiples of 8 and W <= 128; the f32 path (the
// shared wgrad_f32_kernel) takes any shape.
#include "conv_bwd.cuh"

using namespace cpg::bwd;

namespace {

namespace k6 {

constexpr int CB = 32;            // input channels per block
constexpr int OB = 64;            // output channels per block
constexpr int NW = 9;             // warps: one per tap
constexpr int NT = 32 * NW;
constexpr int PIX = 128;          // pixels per step, at most
constexpr int STAGES = 3;
constexpr int LDA = CB + 8;       // act [staged pixel][LDA] bf16
constexpr int LDG = OB + 8;       // g [pixel][LDG] bf16 (the pads spread
                                  // ldmatrix's rows over the banks)
constexpr int XV = CB / 8;        // 16-byte vectors of a staged x pixel
constexpr int GV = OB / 8;        // of a g row
constexpr int XJ = (3 * PIX * XV + NT - 1) / NT;  // x vectors a thread
constexpr int GJ = (PIX * GV + NT - 1) / NT;      // g vectors a thread
static_assert(NT % XV == 0, "a thread's x vectors share one channel slice");

struct Geo {
  int n, h, w, cin, cout;
  int rows;       // image rows a step (of the N*H rows)
  int halo;       // 1: R divides H, rows above and below are staged
  int staged;     // staged x pixels a step, (rows + 2*halo) * w
  int pix;        // output pixels a step, rows * w
  int pk;         // pix rounded up to 16 (the k16 steps)
  int chunks;     // steps over the whole batch
  int per_split;  // steps a split
};

size_t smem_bytes(const Geo& s) {
  return ((size_t)STAGES * (s.pk * LDG + s.staged * CB) + (size_t)(s.staged + 1) * LDA)
             * sizeof(bf16) + 2 * CB * sizeof(float);
}

__global__ void __launch_bounds__(NT, 1)
dw_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
               const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ out, Geo s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* gs = reinterpret_cast<bf16*>(smem_raw);     // [STAGES][pk][LDG]
  bf16* raw = gs + STAGES * s.pk * LDG;             // [STAGES][staged][CB]
  bf16* act = raw + STAGES * s.staged * CB;         // [staged + 1][LDA]
  float* s_a = reinterpret_cast<float*>(act + (s.staged + 1) * LDA);
  float* s_b = s_a + CB;

  const int otiles = (s.cout + OB - 1) / OB;
  const int c0 = (blockIdx.x / otiles) * CB, o0 = (blockIdx.x % otiles) * OB;
  const int tid = threadIdx.x, lane = tid & 31, tap = tid >> 5;
  const int G = s.n * s.h;
  const int first = blockIdx.y * s.per_split;
  const int steps = max(0, min(s.chunks, first + s.per_split) - first);
  const uint4 zero4 = make_uint4(0, 0, 0, 0);

  if (tid < LDA / 8) reinterpret_cast<uint4*>(act + s.staged * LDA)[tid] = zero4;
  if (tid < CB) {
    const bool ok = c0 + tid < s.cin;
    s_a[tid] = ok ? a[c0 + tid] : 0.f;
    s_b[tid] = ok ? b[c0 + tid] : 0.f;
  }

  // x staging: vector u = tid + j*NT is staged pixel u / XV, channels
  // cv..cv+7 of the block's slice
  const int cv = (tid % XV) * 8;
  const bool c_ok = c0 + cv < s.cin;

  // the staged pixels [lo, hi) a step may read: the rows of the step's own
  // image (halo form) or of the batch
  auto bounds = [&](int g0, int& lo, int& hi) {
    int rlo = 0, rhi = G;
    if (s.halo) {
      rlo = g0 - g0 % s.h;
      rhi = min(G, rlo + s.h);
    }
    lo = max(0, rlo - (g0 - s.halo)) * s.w;
    hi = min(s.staged, (rhi - (g0 - s.halo)) * s.w);
  };

  auto load = [&](int step, int slot) {
    if (step < steps) {
      const int g0 = (first + step) * s.rows;
      int lo, hi;
      bounds(g0, lo, hi);
      const long long xpix = (long long)(g0 - s.halo) * s.w;
      bf16* xd = raw + slot * s.staged * CB;
#pragma unroll
      for (int j = 0; j < XJ; ++j) {
        const int u = tid + j * NT, sp = u / XV;
        if (sp >= s.staged) break;
        const bool ok = c_ok && sp >= lo && sp < hi;
        cpg::cp_async16(xd + u * 8, ok ? x + (xpix + sp) * s.cin + c0 + cv : x,
                        ok);
      }
      const long long p0 = (long long)g0 * s.w, npix = (long long)G * s.w;
      bf16* gd = gs + slot * s.pk * LDG;
#pragma unroll
      for (int j = 0; j < GJ; ++j) {
        const int u = tid + j * NT;
        if (u >= s.pk * GV) continue;
        const int p = u / GV, ov = (u % GV) * 8;
        const bool ok = p < s.pix && p0 + p < npix && o0 + ov < s.cout;
        cpg::cp_async16(gd + p * LDG + ov,
                        ok ? g + (p0 + p) * s.cout + o0 + ov : g, ok);
      }
    }
    cpg::cp_async_commit();
  };

  // act = bf16(relu(a*x + b)) of this thread's own vectors (its own copies,
  // so no barrier between the copy and this pass); 0 outside the image
  auto activate = [&](int step, int slot) {
    const int g0 = (first + step) * s.rows;
    int lo, hi;
    bounds(g0, lo, hi);
    const bf16* xs = raw + slot * s.staged * CB;
#pragma unroll
    for (int j = 0; j < XJ; ++j) {
      const int u = tid + j * NT, sp = u / XV;
      if (sp >= s.staged) break;
      uint4 v = zero4;
      if (c_ok && sp >= lo && sp < hi) {
        v = *reinterpret_cast<const uint4*>(xs + u * 8);
        bf16* e8 = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          e8[e] = __float2bfloat16_rn(
              fmaxf(affine(__bfloat162float(e8[e]), s_a[cv + e], s_b[cv + e]), 0.f));
      }
      *reinterpret_cast<uint4*>(act + sp * LDA + cv) = v;
    }
  };

  // A (channels x pixels) of this warp's tap: lane l addresses pixel
  // kk*16 + a_m's neighbour at (dy-1, dx-1), channels a_k..a_k+7
  const int dy = tap / 3, dx = tap % 3;
  const int a_m = (lane >> 4) * 8 + (lane & 7), a_k = ((lane >> 3) & 1) * 8;
  int a_off[PIX / 16];
#pragma unroll
  for (int kk = 0; kk < PIX / 16; ++kk) {
    const int p = kk * 16 + a_m;
    int idx = s.staged;  // the zero row
    if (p < s.pix) {
      const int r = p / s.w, ww = p % s.w + dx - 1;
      if (ww >= 0 && ww < s.w) {
        if (s.halo) {
          idx = (r + dy) * s.w + ww;  // halo rows hold zeros outside the image
        } else {
          const int hr = r % s.h + dy - 1;
          if (hr >= 0 && hr < s.h) idx = (r + dy - 1) * s.w + ww;
        }
      }
    }
    a_off[kk] = idx * LDA + a_k;
  }
  // B (pixels x output channels) from g [pixel][o] by ldmatrix.trans
  const int b_m = (lane & 7) + ((lane >> 3) & 1) * 8, b_n = (lane >> 4) * 8;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) load(i, i);
  for (int i = 0; i < steps; ++i) {
    cpg::cp_async_wait<STAGES - 2>();  // this thread's copies of step i
    __syncthreads();  // everyone's copies landed; step i-1's reads are done
    load(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    activate(i, i % STAGES);
    __syncthreads();
    const bf16* gt = gs + (i % STAGES) * s.pk * LDG;
#pragma unroll
    for (int kk = 0; kk < PIX / 16; ++kk) {
      if (kk * 16 >= s.pk) break;
      uint32_t af[2][4];
      cpg::ldmatrix_x4_trans(af[0], act + a_off[kk]);
      cpg::ldmatrix_x4_trans(af[1], act + a_off[kk] + 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bq[4];
        cpg::ldmatrix_x4_trans(bq, gt + (kk * 16 + b_m) * LDG + np * 16 + b_n);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          cpg::mma_bf16_16816(acc[mi][2 * np], af[mi], &bq[0]);
          cpg::mma_bf16_16816(acc[mi][2 * np + 1], af[mi], &bq[2]);
        }
      }
    }
  }
  cpg::cp_async_wait<0>();

  // dW row k = tap*Cin + c, column o; C fragment rows are channels
  float* dst = out + (long long)blockIdx.y * 9 * s.cin * s.cout;
  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = c0 + mi * 16 + gq + half * 8;
      if (c >= s.cin) continue;
      float* row = dst + ((long long)tap * s.cin + c) * s.cout;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int o = o0 + ni * 8 + 2 * t4;  // Cout % 8 == 0
        if (o < s.cout)
          *reinterpret_cast<float2*>(row + o) =
              make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
}

}  // namespace k6

__global__ void sum_kernel(const float* __restrict__ ws, int splits,
                           long long entries, float* __restrict__ dw) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < entries) dw[e] = splitk_sum(ws, splits, entries, e);
}

int sum_partials(const void* ws, void* dw, int splits, long long entries,
                 void* stream) {
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
// 9*Cin, Cout) f32 scratch (unused when splits == 1); dw (3,3,Cin,Cout)
// f32. `rows` image rows a step: rows*W <= 128, and rows divides H or H
// divides rows. All contiguous on one device, x and g 16-byte aligned, Cin
// and Cout multiples of 8. Returns cudaGetLastError().
int fused_chain_bwd_dw_bf16(const void* x, const void* g, const void* a,
                            const void* b, void* ws, void* dw, int n, int h,
                            int wd, int cin, int cout, int rows, int splits,
                            void* stream) {
  if (bad_shape(n, h, wd, cin, cout, splits) || cin % 8 || cout % 8 ||
      rows < 1 || rows * wd > k6::PIX || splits > 65535 ||
      (rows < h ? h % rows : rows % h))
    return (int)cudaErrorInvalidValue;
  k6::Geo s{n, h, wd, cin, cout, rows, rows < h ? 1 : 0, 0, rows * wd, 0, 0, 0};
  s.staged = (rows + 2 * s.halo) * wd;
  s.pk = (s.pix + 15) / 16 * 16;
  s.chunks = (int)(((long long)n * h + rows - 1) / rows);
  s.per_split = (s.chunks + splits - 1) / splits;
  const size_t smem = k6::smem_bytes(s);
  cudaError_t err =
      cpg::allow_smem((const void*)k6::dw_bf16_kernel, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(((cin + k6::CB - 1) / k6::CB) * ((cout + k6::OB - 1) / k6::OB)),
                  (unsigned)splits);
  k6::dw_bf16_kernel<<<grid, k6::NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)g, (const float*)a, (const float*)b,
      (float*)(splits == 1 ? dw : ws), s);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return sum_partials(ws, dw, splits, 9LL * cin * cout, stream);
}

// The same with f32 x and g, any Cin and Cout: the shared implicit-GEMM
// wgrad (conv_bwd.cuh) with relu(a*x+b) recomputed in its operand load.
int fused_chain_bwd_dw_f32(const void* x, const void* g, const void* a,
                           const void* b, void* ws, void* dw, int n, int h,
                           int wd, int cin, int cout, int splits,
                           void* stream) {
  if (bad_shape(n, h, wd, cin, cout, splits)) return (int)cudaErrorInvalidValue;
  const ConvShape s{n, h, wd, cin, h, wd, cout, 3, 3, 1, 1, 1};
  WgradArgs<float> p{(const float*)x, (const float*)g, (const float*)a,
                     (const float*)b, (float*)ws, 0};
  const dim3 grid = wgrad_grid(s, splits, p);
  wgrad_f32_kernel<true><<<grid, NT, 0, (cudaStream_t)stream>>>(p, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_partials(ws, dw, splits, 9LL * cin * cout, stream);
}

}  // extern "C"
