// Masked weight gradient for Hopper (K3), dense and conv: a split-M TMA +
// wgmma GEMM with both operands MN-major, the splits summed in a fixed
// order and the ownership gating in the epilogue.
//
// Replaces, for bf16 activations: cpg_tpu/ops/pallas/masked_matmul.py
// `_bwd_dw` / `_bwd_dw_kernel` (reached through the custom VJPs of
// `masked_matmul` and of cpg_tpu/ops/pallas/masked_conv.py `masked_conv2d`):
//
//   G[k, o] = sum_m x_patch[m, k] * g[m, o]     bf16 operands, f32 sums
//   dw  = G       where own == task, else 0
//   dpm = G * w   where 0 < own < task, else 0   (binary and ternary alike)
//
// with f32 outputs (K, N), or HWIO for a conv (k = (dh * kw + dw) * Cin + c).
//
// What bounds it on the H100: the dense shapes of the ViTs (M = 16,384 rows,
// K, N in {256, 1024}) move about as many bytes as they do products (x and
// g cross HBM once); the VGG16-BN convs at batch 256 do 4.8-9.7 GFLOP a
// layer against 2-34 MB of activations and are bound by operations; conv0
// (Cin = 3, K = 27) by reading g. The earlier kernel (conv_bwd.cuh
// `wgrad_bf16_kernel`) staged x and g through registers with mma.sync and
// two __syncthreads a 32-pixel step, and wrote one f32 partial of the whole
// (K, N) gradient per split for a second pass: 9 splits at fc1 moved 38 MB
// each way. Here:
//   * The output tile is 128 k-rows x BN Cout-columns (BN 64 or 128);
//     each of two consumer warpgroups owns 64 k-rows. The reduction runs
//     over pixels m, and x (m, k) and g (m, o) both have the output
//     dimension contiguous, so both come from shared memory MN-major
//     (wgmma's transpose flags set): no transposed copy is written. A
//     stage is {A: two 64 (k) x P (pixels) boxes, B: BN / 64 boxes of
//     64 (o) x P}, each P rows of 128 B in TMA's 128-byte swizzle, which
//     the MN-major descriptor (tma_wgmma.cuh `smem_desc_mn`) reads back:
//     64-element atoms along M / N are one box (P * 128 B) apart, 8-row
//     atoms along the pixels 1,024 B apart, a k16 step 2,048 B.
//   * One thread of a producer warp keeps a ring of 3-6 stages in flight by
//     TMA (a "full" and an "empty" mbarrier a stage; waits trap after ~2^32
//     cycles). WGRAD_DENSE loads 2-D boxes of x (M, Kx) and g (M, N), P =
//     64 pixels a stage. WGRAD_CONV loads, per 64-row half of the k tile,
//     one 4-D box (64 ch, Wo, rows, images) = 128 output pixels of the NHWC
//     input at the tap's offset (ow0 + dw - pad_left, oh0 + dh - pad_top):
//     TMA's zero fill is the padding, nothing is materialised; with Cin =
//     64 the two halves are two taps. g's box is the (M, Cout) rows of the
//     unshifted output pixels. Boxes that start past Kx or N are not
//     loaded, and the stage's byte count says so.
//   * The reduction is split over M in whole steps (ops/masked_matmul.py
//     `wgrad_plan` picks BN, the split count, the ring depth and the
//     persistent grid): items (tile, split) are walked split-major by one
//     block an SM. With one split the epilogue gates straight from the
//     accumulators. With more, each split writes its f32 partial tile to a
//     scratch in fragment order (one 16-byte store a thread and register
//     quad, coalesced), and `wgrad_gate_kernel`, a second launch over
//     every entry, sums each entry's partials in split order z = 0 .. S-1
//     and gates. No float atomics: two launches give equal bits, and so do
//     any two grids of one (BN, split) plan. (A one-launch form, in which
//     the block that took a tile's last ticket summed its partials, was
//     slower at every measured shape: that sum runs on one SM per tile,
//     bound by the latency of its loads, where the gate pass spreads it
//     over the card.)
//   * conv0 (kh * kw * Cin <= 64) is reduced as a dense product over its
//     patches: `im2col_bf16_kernel` writes them as bf16 (M, Kp), Kp = K
//     rounded up to 8 (27 -> 32: 64-byte rows TMA can stride), zeros past
//     K; WGRAD_DENSE reads Kx = Kp columns and stores the first K rows.
// x and g need 16-byte aligned bases and Kx, N multiples of 8 (TMA's row
// strides); w 8-byte and own 2-byte aligned. The wrapper keeps conv_bwd.cuh's
// kernels for f32 and every other width.
#include "tma_wgmma.cuh"

using bf16 = __nv_bfloat16;
using namespace cpg::hopper;

namespace {

constexpr int BKW = 128;             // k rows a tile: two consumer warpgroups
constexpr int CONSUMERS = 2;
constexpr int CTHREADS = 128 * CONSUMERS;
constexpr int THREADS = CTHREADS + 32;  // + one producer warp
constexpr int SMEM_PER_BLOCK = 232448;

// What the producer loads (see the top).
enum WgradWalk { WGRAD_DENSE = 0, WGRAD_CONV = 1 };

// pixels a stage: 64 dense rows, or one 128-pixel conv box
__host__ __device__ constexpr int step_rows(int walk) {
  return walk == WGRAD_DENSE ? 64 : 128;
}

// a stage: 2 A boxes and bn / 64 B boxes of `rows` 128-byte rows
__host__ __device__ constexpr int stage_bytes(int bn, int rows) {
  return (BKW + bn) * rows * 2;
}

// 1 KB of slack to align the ring to 1,024 bytes, the ring, a full and an
// empty barrier a stage
__host__ __device__ constexpr int wgrad_smem_bytes(int bn, int rows,
                                                   int stages) {
  return 1024 + stages * stage_bytes(bn, rows) + 16 * stages;
}

// The conv's walk (unused by WGRAD_DENSE): Cin / 64 channel blocks a tap,
// kw taps a kernel row, the output grid's hw = Ho * Wo and wo, the padding
// before the first row and column.
struct ConvWalk {
  int cblocks, kw, hw, wo, pad_top, pad_left;
};

struct WgradArgs {
  const float* w;        // (k, n) f32
  const int8_t* own;     // (k, n) int8
  float* dw;             // (k, n) f32
  float* dpm;            // (k, n) f32
  float* ws;             // (splits * tiles, BKW * bn) f32 partials
  int m, kx, k, n;       // pixels, x's columns, output rows and columns
  int task, splits, per, tiles_k, tiles;
};

// dw and dpm of two neighbouring entries e, e + 1 (e even)
__device__ __forceinline__ void gate2(const WgradArgs& p, long long e,
                                      float g0, float g1) {
  const char2 o = *reinterpret_cast<const char2*>(p.own + e);
  const float2 w = *reinterpret_cast<const float2*>(p.w + e);
  const bool own0 = o.x == p.task, own1 = o.y == p.task;
  const bool pri0 = o.x > 0 && o.x < p.task, pri1 = o.y > 0 && o.y < p.task;
  *reinterpret_cast<float2*>(p.dw + e) =
      make_float2(own0 ? g0 : 0.f, own1 ? g1 : 0.f);
  *reinterpret_cast<float2*>(p.dpm + e) =
      make_float2(pri0 ? g0 * w.x : 0.f, pri1 ? g1 * w.y : 0.f);
}

// The D fragment of m64nBNk16 in consumer thread c (0..255): warpgroup c /
// 128 owns tile rows 64 * (c / 128) ..; warp w of it rows 16w + lane / 4
// and + 8; register 4j + {0, 1} (+ {2, 3}: row + 8) columns 8j + 2 *
// (lane % 4) + {0, 1}.
__device__ __forceinline__ int frag_row(int c) {
  return (c / 128) * 64 + ((c / 32) % 4) * 16 + (c % 32) / 4;
}
__device__ __forceinline__ int frag_col(int c) { return 2 * (c % 4); }

// G = x_patch^T g over the item's pixels, then the gating or the partial
// (see the top).
template <int BN, int WALK>
__global__ void __launch_bounds__(THREADS, 1)
wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap tma_x,
                   const __grid_constant__ CUtensorMap tma_g, WgradArgs p,
                   ConvWalk cw, int stages) {
  constexpr int P = step_rows(WALK);
  constexpr int BOX = P * 128;  // one 64-wide box of P rows
  constexpr int STAGE = stage_bytes(BN, P);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const Ring pipe{ring + stages * STAGE, stages};
  const int steps = (p.m + P - 1) / P;
  const int items = p.tiles * p.splits;

  if (threadIdx.x == 0) {
    pipe.init(CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // producer warp: one thread issues every TMA load of the block
    if (threadIdx.x != CTHREADS) return;
    RingPos pos;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int t = it % p.tiles, z = it / p.tiles;
      const int k0 = (t % p.tiles_k) * BKW, n0 = (t / p.tiles_k) * BN;
      const int s1 = min((z + 1) * p.per, steps);
      uint32_t bytes = 0;  // the boxes that start inside x and g
      for (int h = 0; h < 2; ++h) bytes += k0 + 64 * h < p.kx ? BOX : 0;
      for (int q = 0; q < BN / 64; ++q) bytes += n0 + 64 * q < p.n ? BOX : 0;
      for (int st = z * p.per; st < s1; ++st) {
        const uint32_t full = pipe.acquire(pos, bytes);
        const uint32_t a = ring + pos.s * STAGE, b = a + 2 * BOX;
        const int m0 = st * P;
        if constexpr (WALK == WGRAD_DENSE) {
          for (int h = 0; h < 2; ++h)
            if (k0 + 64 * h < p.kx)
              tma_load_2d(a + h * BOX, &tma_x, k0 + 64 * h, m0, full);
        } else {
          // the box's first output pixel: image, row, column
          const int img = m0 / cw.hw;
          const int oh0 = (m0 - img * cw.hw) / cw.wo;
          const int ow0 = m0 - img * cw.hw - oh0 * cw.wo;
          for (int h = 0; h < 2; ++h) {
            const int kb = k0 / 64 + h;
            if (kb * 64 >= p.kx) continue;
            const int tap = kb / cw.cblocks, c0 = (kb % cw.cblocks) * 64;
            tma_load_4d(a + h * BOX, &tma_x, c0,
                        ow0 + tap % cw.kw - cw.pad_left,
                        oh0 + tap / cw.kw - cw.pad_top, img, full);
          }
        }
        for (int q = 0; q < BN / 64; ++q)
          if (n0 + 64 * q < p.n)
            tma_load_2d(b + q * BOX, &tma_g, n0 + 64 * q, m0, full);
        pos.advance(stages);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns k rows 64 * wg .. 64 * wg + 63 of a tile
  const int c = threadIdx.x;
  const bool leader = c % 128 == 0;
  float acc[BN / 2];
  RingPos pos;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int t = it % p.tiles, z = it / p.tiles;
    const int k0 = (t % p.tiles_k) * BKW, n0 = (t / p.tiles_k) * BN;
    const int s1 = min((z + 1) * p.per, steps);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int st = z * p.per; st < s1; ++st) {
      pipe.wait(pos);
      const uint32_t a = ring + pos.s * STAGE + wg * BOX;
      const uint32_t b = ring + pos.s * STAGE + 2 * BOX;
      const uint64_t da = smem_desc_mn(a, BOX, 1024);
      const uint64_t db = smem_desc_mn(b, BOX, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk)  // 16 pixels = 2,048 B
        wgmma_bf16<BN, 1, 1>(acc, da + 128 * kk, db + 128 * kk, 1);
      wgmma_commit();
      // the previous stage's products are done: hand it back
      wgmma_wait<1>();
      if (prev >= 0 && leader) pipe.release(prev);
      prev = pos.s;
      pos.advance(stages);
    }
    wgmma_wait<0>();
    if (prev >= 0 && leader) pipe.release(prev);

    if (p.splits > 1) {  // the gate pass sums and gates
      float4* part =
          reinterpret_cast<float4*>(p.ws) + (long long)it * (BKW * BN / 4);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        __stcg(part + j * CTHREADS + c,
               make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                           acc[4 * j + 3]));
      continue;
    }

    // epilogue: gate the tile's sums into dw and dpm, clipped at k and n
    const int row = k0 + frag_row(c);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + frag_col(c);
      if (col >= p.n) continue;
      if (row < p.k)
        gate2(p, (long long)row * p.n + col, acc[4 * j], acc[4 * j + 1]);
      if (row + 8 < p.k)
        gate2(p, (long long)(row + 8) * p.n + col, acc[4 * j + 2],
              acc[4 * j + 3]);
    }
  }
}

// The gate pass after a split GEMM: one thread a register quad (tile, j,
// consumer thread c) sums the quad over the splits in split order and
// gates its four entries.
__global__ void wgrad_gate_kernel(WgradArgs p, int bn) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long quads = (long long)p.tiles * (BKW * bn / 4);
  if (q >= quads) return;
  const int t = (int)(q / (BKW * bn / 4));
  const int r = (int)(q % (BKW * bn / 4));
  const int j = r / CTHREADS, c = r % CTHREADS;
  const float4* part = reinterpret_cast<const float4*>(p.ws) + q;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  constexpr int AHEAD = 8;  // independent loads in flight, added in order
  for (int z0 = 0; z0 < p.splits; z0 += AHEAD) {
    float4 u[AHEAD];
#pragma unroll
    for (int i = 0; i < AHEAD; ++i)
      if (z0 + i < p.splits) u[i] = __ldcg(part + (long long)(z0 + i) * quads);
#pragma unroll
    for (int i = 0; i < AHEAD; ++i)
      if (z0 + i < p.splits) {
        v.x += u[i].x;
        v.y += u[i].y;
        v.z += u[i].z;
        v.w += u[i].w;
      }
  }
  const int row = (t % p.tiles_k) * BKW + frag_row(c);
  const int col = (t / p.tiles_k) * bn + 8 * j + frag_col(c);
  if (col >= p.n) return;
  if (row < p.k) gate2(p, (long long)row * p.n + col, v.x, v.y);
  if (row + 8 < p.k) gate2(p, (long long)(row + 8) * p.n + col, v.z, v.w);
}

// x (n, h, w, c) bf16 -> patches (n * ho * wo, kp) bf16: column k = (dh *
// kw + dw) * c + ch of pixel (img, oh, ow) is x[img, oh * stride - pad_top
// + dh, ow * stride - pad_left + dw, ch], zero in the padding and for k >=
// kh * kw * c; kp % 8 == 0. One thread a pixel, 16-byte stores; the
// column's (dh, dw, ch) advance by counting, not by division.
__global__ void im2col_bf16_kernel(const bf16* __restrict__ x,
                                   bf16* __restrict__ out, int n, int h,
                                   int w, int c, int ho, int wo, int kh,
                                   int kw, int stride, int pad_top,
                                   int pad_left, int kp) {
  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= (long long)n * ho * wo) return;
  const int img = (int)(m / (ho * wo)), rem = (int)(m % (ho * wo));
  const int ih0 = (rem / wo) * stride - pad_top;
  const int iw0 = (rem % wo) * stride - pad_left;
  const int K = kh * kw * c;
  const bf16* img_x = x + (long long)img * h * w * c;
  int dh = 0, dw = 0, ch = 0;
  for (int k0 = 0; k0 < kp; k0 += 8) {
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int ih = ih0 + dh, iw = iw0 + dw;
      v[e] = k0 + e < K && ih >= 0 && ih < h && iw >= 0 && iw < w
                 ? img_x[((long long)ih * w + iw) * c + ch]
                 : __float2bfloat16_rn(0.f);
      if (++ch == c) {
        ch = 0;
        if (++dw == kw) {
          dw = 0;
          ++dh;
        }
      }
    }
    *reinterpret_cast<uint4*>(out + m * kp + k0) =
        *reinterpret_cast<const uint4*>(v);
  }
}

template <int BN, int WALK>
int launch_bn(const CUtensorMap& mx, const CUtensorMap& mg,
              const WgradArgs& p, const ConvWalk& cw, int stages, int grid,
              cudaStream_t st) {
  const int smem = wgrad_smem_bytes(BN, step_rows(WALK), stages);
  // per call: the attribute belongs to the current device
  cudaError_t err =
      cpg::allow_smem((const void*)wgrad_wgmma_kernel<BN, WALK>, smem);
  if (err != cudaSuccess) return (int)err;
  wgrad_wgmma_kernel<BN, WALK><<<grid, THREADS, smem, st>>>(mx, mg, p, cw,
                                                            stages);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  const long long quads = (long long)p.tiles * (BKW * BN / 4);
  wgrad_gate_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, st>>>(p, BN);
  return (int)cudaGetLastError();
}

template <int WALK>
int launch_walk(const CUtensorMap& mx, const CUtensorMap& mg, WgradArgs p,
                const ConvWalk& cw, int bn, int stages, int grid,
                cudaStream_t st) {
  if (stages < 2 || grid <= 0 || p.splits < 1 ||
      wgrad_smem_bytes(bn, step_rows(WALK), stages) > SMEM_PER_BLOCK)
    return (int)cudaErrorInvalidValue;
  const int steps = (p.m + step_rows(WALK) - 1) / step_rows(WALK);
  p.per = (steps + p.splits - 1) / p.splits;
  p.tiles_k = (p.k + BKW - 1) / BKW;
  p.tiles = p.tiles_k * ((p.n + bn - 1) / bn);
  switch (bn) {
    case 64: return launch_bn<64, WALK>(mx, mg, p, cw, stages, grid, st);
    case 128: return launch_bn<128, WALK>(mx, mg, p, cw, stages, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// a (rows, cols) row-major bf16 matrix in boxes of 64 columns x box_rows
bool make_map(CUtensorMap* map, const void* ptr, long long rows,
              long long cols, int box_rows) {
  const long long dims[2] = {cols, rows};
  const int box[2] = {64, box_rows};
  return make_map_nd(map, ptr, 2, dims, box);
}

WgradArgs args(const void* w, const void* own, void* ws, void* dw,
               void* dpm, int m, int kx, int k, int n, int task, int splits) {
  WgradArgs p{};
  p.w = (const float*)w;
  p.own = (const int8_t*)own;
  p.dw = (float*)dw;
  p.dpm = (float*)dpm;
  p.ws = (float*)ws;
  p.m = m;
  p.kx = kx;
  p.k = k;
  p.n = n;
  p.task = task;
  p.splits = splits;
  return p;
}

}  // namespace

extern "C" {

// Dense K3: x (m, kx) and g (m, n) bf16, w (k, n) f32, own (k, n) int8 ->
// dw, dpm (k, n) f32, k <= kx (columns of x past k are reduced and not
// stored). ws: splits * tiles * 128 * bn f32 (unused when splits == 1),
// tiles = ceil(k / 128) * ceil(n / bn). kx, n multiples of 8; x, g
// 16-byte, w, dw, dpm 8-byte, own 2-byte aligned; bn (64 or 128),
// splits, stages and grid from ops/masked_matmul.py `wgrad_plan`. Returns
// cudaGetLastError().
int masked_matmul_wgrad_bf16(const void* x, const void* g, const void* w,
                             const void* own, void* ws, void* dw, void* dpm,
                             int m, int kx, int k, int n, int task, int bn,
                             int splits, int stages, int grid, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || k > kx || kx % 8 || n % 8)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mg;
  if (!make_map(&mx, x, m, kx, 64) || !make_map(&mg, g, m, n, 64))
    return (int)cudaErrorInvalidValue;
  return launch_walk<WGRAD_DENSE>(
      mx, mg, args(w, own, ws, dw, dpm, m, kx, k, n, task, splits),
      ConvWalk{}, bn, stages, grid, (cudaStream_t)stream);
}

// Conv K3 at stride 1: x (nimg, h, wd, cin) and g (nimg, ho, wo, cout)
// bf16, w (kh, kw, cin, cout) f32, own int8 -> dw, dpm HWIO f32. cin % 64
// == 0, cout % 8 == 0; (ho, wo) tiled by boxes (64, wo, box_h, box_n) with
// wo * box_h * box_n = 128; the rest as the dense entry.
int masked_conv_wgrad_bf16(const void* x, const void* g, const void* w,
                           const void* own, void* ws, void* dw, void* dpm,
                           int nimg, int h, int wd, int cin, int ho, int wo,
                           int cout, int kh, int kw, int pad_top,
                           int pad_left, int box_h, int box_n, int task,
                           int bn, int splits, int stages, int grid,
                           void* stream) {
  const int m = nimg * ho * wo, k = kh * kw * cin;
  if (m <= 0 || cin <= 0 || cin % 64 || cout <= 0 || cout % 8 || k <= 0 ||
      wo * box_h * box_n != step_rows(WGRAD_CONV))
    return (int)cudaErrorInvalidValue;
  const long long xdims[4] = {cin, wd, h, nimg};
  const int xbox[4] = {64, wo, box_h, box_n};
  CUtensorMap mx, mg;
  if (!make_map_nd(&mx, x, 4, xdims, xbox) ||
      !make_map(&mg, g, m, cout, step_rows(WGRAD_CONV)))
    return (int)cudaErrorInvalidValue;
  const ConvWalk cw{cin / 64, kw, ho * wo, wo, pad_top, pad_left};
  return launch_walk<WGRAD_CONV>(
      mx, mg, args(w, own, ws, dw, dpm, m, k, k, cout, task, splits), cw, bn,
      stages, grid, (cudaStream_t)stream);
}

// x (n, h, w, c) bf16 -> out (n * ho * wo, kp) bf16 patches (see
// im2col_bf16_kernel); kp % 8 == 0, out 16-byte aligned.
int masked_conv_im2col_bf16(const void* x, void* out, int n, int h, int w,
                            int c, int ho, int wo, int kh, int kw, int stride,
                            int pad_top, int pad_left, int kp, void* stream) {
  if (kp % 8 || kp < kh * kw * c) return (int)cudaErrorInvalidValue;
  const long long m = (long long)n * ho * wo;
  im2col_bf16_kernel<<<(unsigned)((m + 255) / 256), 256, 0,
                       (cudaStream_t)stream>>>(
      (const bf16*)x, (bf16*)out, n, h, w, c, ho, wo, kh, kw, stride, pad_top,
      pad_left, kp);
  return (int)cudaGetLastError();
}

}  // extern "C"
