// Fused BN-affine + ReLU + 3x3 SAME convolution forward (stride 1), K4.
//
// Replaces: cpg_tpu/ops/pallas/fused_chain.py `_fwd_pallas` / `_fused_kernel`
// (the TPU forward kernel behind `fused_affine_relu_conv`).
//
//   y = conv3x3_same(relu(a * x + b), w)
//
// with (a, b) the folded BatchNorm affine, so VGG16's eight intra-block
// BN -> ReLU -> conv seams read the previous conv's output once and never
// write the normalised activation to device memory.
//
// What bounds it on the H100: operations at every VGG16-BN seam at batch
// 256 (4.8-19.3 GFLOP against 3-34 MB of x and y) and at every ResNet-50
// seam at batch 32 (7.4 GFLOP against 10-13 MB). Two routes, chosen by
// ops/fused_chain.py before the launch (`fwd_route`):
//
// * bf16 with Cin and Cout multiples of 64 on a grid whose halo tiles fit
//   shared memory (every VGG16-BN seam at width 1.0, on `conv_box`'s tiles,
//   and ResNet-50's 56, 28, 14 and 7-pixel seams, whose tiles start mid-row
//   and cross images; not 1x1): `fused_chain_fwd_gemm_bf16`, an
//   implicit GEMM on Hopper's TMA and wgmma. TMA can land only raw x, and
//   SAME padding comes after the activation (a padded position of the
//   activation is 0, not relu(b)), so the A operand cannot be TMA's zero-
//   filled per-tap box fed straight to wgmma. Instead, for each (output tile
//   of 128 consecutive pixels, 64-channel block), the tile's halo of raw x
//   is loaded by TMA: boxes of (64, W + 2, rows + 2, images) pixels, `rows`
//   being the most rows of one image that a tile touches
//   (ops/masked_matmul.py `fused_fwd_halo`). Where a tile touches whole
//   images (rows = H) one box at (c0, -1, -1, img) holds them all, a halo
//   per image. Otherwise the box starts at the tile's first row, (c0, -1,
//   row0 - 1, img), and a tile that runs into the next image loads a second
//   box of that image's first rows, (c0, -1, -1, img + 1), `split` pixels
//   after the first (a multiple of 8, so that both land in one 128-byte
//   swizzle phase); a tile never reads the rows of a neighbouring image
//   through a shifted tap, because each image has halo rows of its own.
//   Each lane computes its ldmatrix row's pixel from (image, row, column) of
//   its output pixel at every tile. The halo is activated once, in place:
//   relu(a*x + b) with the product and the sum rounded apart (`__fmul_rn`,
//   `__fadd_rn`; nvcc would contract them into an FMA) and rounded once to
//   bf16, 0 at every halo position outside its image; a 16-byte chunk of
//   pixel p holds channels 8 * (chunk ^ (p & 7)) under the 128-byte swizzle.
//   The nine taps then read shifted pixel rows of that tile with ldmatrix:
//   their rows have pitch W + 2 and shift by single pixels, which no wgmma
//   descriptor addresses, so the product is wgmma with A from registers
//   (tma_wgmma.cuh `wgmma_bf16_ra`), the fragments of the next tap loaded
//   while this tap's group runs (two register sets). B is the weight (9 *
//   Cin, Cout) read MN-major: a ring of per-tap boxes of 64 input x BN output
//   channels (`smem_desc_mn`, the transpose flag set; tma_wgmma.cuh `Ring`,
//   as the other GEMMs), so no transposed copy is written.
//   What bounds it in practice is the activation: done by the two consumer
//   warpgroups between their taps, it took 40% of the kernel's time at
//   ResNet-50's seams (PERF.md), where a 128-pixel tile's halo is 1.5
//   to 2.7 times its pixels and each 64-channel step needs its own. So the
//   producer side has warps of its own: one loads the weights, one loads
//   each step's halo as soon as its buffer is free, and four activation
//   warps activate it while the consumers multiply the step before, only
//   the pixels the tile's taps read (from its first pixel's up-left
//   neighbour to its last pixel's down-right one), and hand it over on a
//   barrier of its own. The halos sit in two buffers apart from the ring; a
//   step's buffer is free once every consumer warp's last ldmatrix of it
//   has landed (a third buffer gained under 2%: PERF.md). The epilogue
//   rounds to bf16 through the swizzled staging tile and stores by TMA
//   (tma_gemm.cuh `stage_store`). Whole K a tile, no split, no atomics.
//   Plan (tile width, ring depth, halo bytes, grid):
//   ops/masked_matmul.py `fused_fwd_plan`, whose shared-memory sum is
//   `fwd_smem_bytes` below.
// * every other shape (f32, narrow widths): the kernels below the route,
//   described next.
//
// Off the route: a block owns `rows` consecutive image rows of the
// flattened (N*H, W) row space (rows = 128 / W, so one tile is up to 128
// output pixels and may span several small images) and a 64-wide slice of
// Cout. Per Cin chunk of 32 it
//   1. stages the rows g0-1 .. g0+rows (halo included) in shared memory as
//      act = relu(a*x + b), computed in f32 (multiply and add rounded
//      separately, as the plain version does) and cast to the dot dtype,
//      plus the chunk's 9 x 32 x 64 weight slice;
//   2. accumulates the nine taps against it in f32: each output row's A
//      operand is read from its shifted neighbour among the staged rows;
//   3. after the last chunk, writes y in the dot dtype.
// act exists only in shared memory.
//
// Pitfalls these sources handle:
//   * Halo positions outside the image are 0 in act, not relu(b): SAME
//     padding applies after the activation. A tap whose neighbour lies
//     outside its image (above/below, left/right, or in the next image of a
//     multi-image tile) reads a shared all-zero row instead of a staged one.
//   * The shape predicate is this kernel's own (the TPU `_supported` was
//     sized for the v5e's VMEM and sent H < 3 to the XLA oracle): any N and
//     H, W <= 128, any Cin and Cout in f32 and multiples of 8 in bf16 (its
//     16-byte loads), which covers every VGG16-BN seam at width mult <= 2
//     (H = W from 32 down to 2, channels up to 1024). The shared memory a
//     shape needs follows from the tiles below; the Python wrapper checks
//     the same formulas (ops/fused_chain.py `supported`).
//   * Dtypes follow the JAX kernel: x arrives in the dot dtype, w is the
//     effective weight cast to the dot dtype by the wrapper, y is in the dot
//     dtype.
//
// The off-route bf16 kernel runs on the tensor cores with mma.sync
// m16n8k16 and f32 accumulation, loads its fragments with ldmatrix, copies
// the weight slice with 16-byte cp.async and stages act with 16-byte loads
// issued together; each chunk stages, synchronises and computes in turn.
// The f32 kernel is exact f32 FMA with scalar staging, for f32 evaluation.
#include "common.cuh"
#include "tma_gemm.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int BM = 128;  // output pixels per block (at most)
constexpr int BN = 64;   // output channels per block
constexpr int BKC = 32;  // input channels per staged chunk
constexpr int NT = 256;  // 8 warps
// bf16 tiles: act [pixel][BKC+8], weights [9*BKC][BN+8] (Cout contiguous);
// the pads make ldmatrix's eight 16-byte rows hit distinct banks
constexpr int LDA = BKC + 8;
constexpr int LDB = BN + 8;
// f32 tiles: act [pixel][BKC+1], weights [9*BN][BKC+1]
constexpr int LD32 = BKC + 1;
constexpr int MAX_STAGED = 3 * BM;  // (BM/W + 2) * W for W <= BM

int staged_pixels(int wd) { return (BM / wd + 2) * wd; }

size_t smem_bytes_bf16(int wd) {
  return ((size_t)(staged_pixels(wd) + 1) * LDA + 9 * BKC * LDB) * sizeof(bf16);
}

size_t smem_bytes_f32(int wd) {
  return (size_t)(staged_pixels(wd) + 1 + 9 * BN) * LD32 * sizeof(float);
}

// Output row m of the tile, for the taps: `pix` is the staged index of its
// own pixel, `col` its image column, `hrow` its image row, or -4 for a row
// past the tile (so every tap then reads the zero row).
struct RowRef {
  int pix, col, hrow;
};

__device__ __forceinline__ RowRef row_ref(int m, int wd, int h, int g0,
                                          int mt, int G) {
  const int r = m / wd;
  return {(r + 1) * wd + m % wd, m % wd,
          (m < mt && g0 + r < G) ? (g0 + r) % h : -4};
}

// staged index read by `row` for tap (dy, dx); `zero` where out of image
__device__ __forceinline__ int tap_index(const RowRef& row, int dy, int dx,
                                         int wd, int h, int zero) {
  const int hh = row.hrow + dy, ww = row.col + dx;
  return (hh >= 0 && hh < h && ww >= 0 && ww < wd) ? row.pix + dy * wd + dx
                                                   : zero;
}

__global__ void __launch_bounds__(NT)
fused_chain_fwd_bf16_kernel(const bf16* __restrict__ x,
                            const float* __restrict__ a,
                            const float* __restrict__ b,
                            const bf16* __restrict__ w, bf16* __restrict__ y,
                            int n, int h, int wd, int cin, int cout,
                            int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* act = reinterpret_cast<bf16*>(smem_raw);
  const int staged = (rows + 2) * wd;  // act row `staged` stays all zero
  bf16* wt = act + (staged + 1) * LDA;  // [9*BKC][LDB]

  const int G = n * h;  // image rows over the whole batch
  const int g0 = blockIdx.x * rows;
  const int n0 = blockIdx.y * BN;
  const int mt = rows * wd;  // output pixels this tile covers
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // 4 x 2 warps, 32x32 outputs each
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  for (int k = tid; k < LDA / 8; k += NT)
    reinterpret_cast<uint4*>(act + staged * LDA)[k] = zero4;

  // the A rows this lane addresses for ldmatrix: rows lane%16 of each of
  // the warp's two 16-row tiles, at channel offset 8*(lane/16)
  RowRef arow[2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
    arow[mi] = row_ref(wm * 32 + mi * 16 + (lane & 15), wd, h, g0, mt, G);
  const int a_koff = (lane >> 4) * 8;
  // B rows (k) and columns (n) this lane addresses for ldmatrix.trans
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_n = wn * 32 + (lane >> 4) * 8;

  // act staging: thread owns channels c0 + 8*(tid % 4) .. +8 of every
  // (NT/4)-th staged pixel
  constexpr int VEC = BKC / 8;
  constexpr int PER = (MAX_STAGED * VEC + NT - 1) / NT;
  const int cv = (tid % VEC) * 8;

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += BKC) {
    __syncthreads();  // previous chunk consumed
    // weight slice: 9*BKC rows of BN/8 16-byte vectors, asynchronous
    for (int u = tid; u < 9 * BKC * (BN / 8); u += NT) {
      const int q = u / (BN / 8), v = u % (BN / 8);
      const int c = c0 + q % BKC, o = n0 + v * 8;
      const bool ok = c < cin && o < cout;
      cpg::cp_async16(wt + q * LDB + v * 8,
                      ok ? w + ((long long)(q / BKC) * cin + c) * cout + o : w,
                      ok);
    }
    // act: all of this thread's 16-byte x loads first, then the affine+ReLU
    const bool c_ok = c0 + cv < cin;
    float av[8], bv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      av[e] = c_ok ? a[c0 + cv + e] : 0.f;
      bv[e] = c_ok ? b[c0 + cv + e] : 0.f;
    }
    uint4 xv[PER];
    bool ok[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int p = (tid + j * NT) / VEC;
      const int gg = g0 - 1 + p / wd;
      ok[j] = p < staged && c_ok && gg >= 0 && gg < G;
      xv[j] = ok[j] ? *reinterpret_cast<const uint4*>(
                          x + ((long long)gg * wd + p % wd) * cin + c0 + cv)
                    : zero4;
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int p = (tid + j * NT) / VEC;
      if (p < staged) {
        uint4 out = zero4;
        if (ok[j]) {
          const bf16* xs = reinterpret_cast<const bf16*>(&xv[j]);
          bf16* os = reinterpret_cast<bf16*>(&out);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            os[e] = __float2bfloat16_rn(fmaxf(
                __fadd_rn(__fmul_rn(__bfloat162float(xs[e]), av[e]), bv[e]), 0.f));
        }
        *reinterpret_cast<uint4*>(act + p * LDA + cv) = out;
      }
    }
    cpg::cp_async_wait_all();
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const bf16* ap[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ap[mi] = act + tap_index(arow[mi], dy, dx, wd, h, staged) * LDA + a_koff;
      const bf16* wtap = wt + tap * BKC * LDB;
#pragma unroll
      for (int ks = 0; ks < BKC; ks += 16) {
        uint32_t af[2][4], bq[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) cpg::ldmatrix_x4(af[mi], ap[mi] + ks);
#pragma unroll
        for (int pr = 0; pr < 2; ++pr)
          cpg::ldmatrix_x4_trans(bq[pr], wtap + (ks + b_k) * LDB + b_n + pr * 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            cpg::mma_bf16_16816(&acc[(mi * 4 + ni) * 4], af[mi],
                                &bq[ni >> 1][(ni & 1) * 2]);
      }
    }
  }

  const long long pix0 = (long long)g0 * wd;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = wm * 32 + mi * 16 + g + half * 8;
      if (m >= mt || g0 + m / wd >= G) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + 2 * t4;  // Cout % 8 == 0
        if (col < cout) {
          const float* c = &acc[(mi * 4 + ni) * 4 + half * 2];
          *reinterpret_cast<__nv_bfloat162*>(y + (pix0 + m) * cout + col) =
              __floats2bfloat162_rn(c[0], c[1]);
        }
      }
    }
}

__global__ void __launch_bounds__(NT)
fused_chain_fwd_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ a,
                           const float* __restrict__ b,
                           const float* __restrict__ w, float* __restrict__ y,
                           int n, int h, int wd, int cin, int cout, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* act = reinterpret_cast<float*>(smem_raw);
  const int staged = (rows + 2) * wd;
  float* wt = act + (staged + 1) * LD32;  // [9][BN][LD32]

  const int G = n * h;
  const int g0 = blockIdx.x * rows;
  const int n0 = blockIdx.y * BN;
  const int mt = rows * wd;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // cols tx+16j, rows ty*8+i
  for (int k = tid; k < LD32; k += NT) act[staged * LD32 + k] = 0.f;

  RowRef row[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) row[i] = row_ref(ty * 8 + i, wd, h, g0, mt, G);

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += BKC) {
    __syncthreads();
    {  // act: one channel per thread, every NT/BKC-th staged pixel
      const int kk = tid % BKC, c = c0 + kk;
      const bool c_ok = c < cin;
      const float ac = c_ok ? a[c] : 0.f, bc = c_ok ? b[c] : 0.f;
      for (int p = tid / BKC; p < staged; p += NT / BKC) {
        const int gg = g0 - 1 + p / wd;
        float v = 0.f;
        if (c_ok && gg >= 0 && gg < G)
          v = fmaxf(__fadd_rn(__fmul_rn(x[((long long)gg * wd + p % wd) * cin + c],
                                        ac), bc), 0.f);
        act[p * LD32 + kk] = v;
      }
    }
    for (int i = tid; i < 9 * BKC * BN; i += NT) {
      const int tap = i / (BKC * BN), rem = i % (BKC * BN);
      const int kk = rem / BN, nn = rem % BN, c = c0 + kk, o = n0 + nn;
      wt[(tap * BN + nn) * LD32 + kk] =
          (c < cin && o < cout) ? w[((long long)tap * cin + c) * cout + o] : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      int off[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) off[i] = tap_index(row[i], dy, dx, wd, h, staged) * LD32;
      const float* wtap = wt + tap * BN * LD32;
#pragma unroll 4
      for (int kk = 0; kk < BKC; ++kk) {
        float av[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = act[off[i] + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = wtap[(tx + 16 * j) * LD32 + kk];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i * 4 + j] = fmaf(av[i], bv[j], acc[i * 4 + j]);
      }
    }
  }

  const long long pix0 = (long long)g0 * wd;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (row[i].hrow >= 0 && col < cout)
        y[(pix0 + ty * 8 + i) * cout + col] = acc[i * 4 + j];
    }
}

template <typename T, typename K>
int launch(K kernel, size_t smem, const void* x, const void* a, const void* b,
           const void* w, void* y, int n, int h, int wd, int cin, int cout,
           void* stream) {
  const int rows = BM / wd;
  cudaError_t err = cpg::allow_smem((const void*)kernel, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long G = (long long)n * h;
  const dim3 grid((unsigned)((G + rows - 1) / rows), (unsigned)((cout + BN - 1) / BN));
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)a, (const float*)b, (const T*)w, (T*)y, n, h,
      wd, cin, cout, rows);
  return (int)cudaGetLastError();
}

bool bad_shape(int n, int h, int wd, int cin, int cout) {
  return wd < 1 || wd > BM || n < 1 || h < 1 || cin < 1 || cout < 1;
}

}  // namespace

// ---------------------------------------------------- the GEMM route ----
namespace k4 {

namespace gm = cpg::gemm;
using namespace cpg::hopper;

constexpr int BM = gm::BM;            // output pixels a tile
constexpr int BK = gm::BK;            // input channels a halo tile and a tap
constexpr int CONSUMERS = gm::CONSUMERS;
constexpr int HALOS = 2;              // activated halo tiles in flight
// the producer side: a warp whose lane 0 loads the weights, a warp whose
// lane 0 loads the halos, and ACT_WARPS warps that activate them
constexpr int ACT_WARPS = 4;
constexpr int ACT_THREADS = 32 * ACT_WARPS;
constexpr int THREADS = 128 * CONSUMERS + 64 + ACT_THREADS;

// One seam on the route: a halo box is (w + 2) x (rows + 2) pixels of 128 B
// an image, `imgs` images (rows == h: whole images) or one image whose
// tiles may run into the next (rows < h; split > 0 where they do: the
// second box's first pixel), in a buffer of halo_bytes (its pixels rounded
// up to the swizzle's 1,024 B); magic_pw and magic_ph divide by w + 2 and
// rows + 2 (`div_small`).
struct Geo {
  int n, h, w, cin, cout, rows, imgs, split, halo_bytes, magic_pw, magic_ph;
};

// The halo of one tile: its first pixel's image and (rows < h) row,
// whether it loads the second box, and the pixels lo .. hi - 1 that its
// taps read (`halo_tile`), the only ones activated.
struct HaloTile {
  int img, row0, lo, hi;
  bool two;
};

// The halo pixel of output pixel m < n h w at the centre tap: its image,
// row and column in the tile's boxes.
__device__ __forceinline__ int centre_pixel(const Geo& g, const HaloTile& t,
                                            int m) {
  const int hw = g.h * g.w, pw = g.w + 2;
  const int img = m / hw, rem = m - img * hw, i = rem / g.w;
  const int j = rem - i * g.w, b = img - t.img;
  return (b > 0 && g.split ? g.split + (i + 1) * pw
                           : (b * (g.rows + 2) + i - t.row0 + 1) * pw) +
         j + 1;
}

// A tile's halo pixels rise with its output pixels, so its taps read the
// pixels from its first pixel's up-left neighbour to its last pixel's
// down-right one (rows past the last pixel read around pixel w + 3,
// whatever is there: the store clips them).
__device__ __forceinline__ HaloTile halo_tile(const Geo& g, int tiles_m,
                                              int t) {
  const int hw = g.h * g.w, m0 = (t % tiles_m) * BM, img = m0 / hw;
  const int last = min(m0 + BM, g.n * hw) - 1, pw = g.w + 2;
  HaloTile ht{img, g.rows == g.h ? 0 : (m0 - img * hw) / g.w, 0, 0,
              g.split > 0 && last / hw != img};
  ht.lo = centre_pixel(g, ht, m0) - pw - 1;
  ht.hi = centre_pixel(g, ht, last) + pw + 2;
  return ht;
}

// dynamic shared memory: 1 KB of slack to align to 1,024 bytes, the halo
// tiles, the ring of bn x 64 weight stages, the output staging (as
// tma_gemm.cuh's), a full and an empty barrier a stage, and a full, an
// activated and an empty barrier a halo tile
__host__ __device__ constexpr int fwd_smem_bytes(int bn, int stages,
                                                 int halo_bytes) {
  return 1024 + HALOS * halo_bytes + stages * bn * BK * 2 +
         CONSUMERS * bn * 128 + 16 * stages + 24 * HALOS;
}

// relu(a*x + b) of the eight channels of one 16-byte chunk, the product and
// the sum rounded apart, rounded once to bf16
__device__ __forceinline__ uint4 act8(uint4 v, const float (&av)[8],
                                      const float (&bv)[8]) {
  uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = gm::bf16x2_to_float2(u[i]);
    const __nv_bfloat162 r = __floats2bfloat162_rn(
        fmaxf(__fadd_rn(__fmul_rn(f.x, av[2 * i]), bv[2 * i]), 0.f),
        fmaxf(__fadd_rn(__fmul_rn(f.y, av[2 * i + 1]), bv[2 * i + 1]), 0.f));
    u[i] = *reinterpret_cast<const uint32_t*>(&r);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// floor(p / d) for 0 <= p < 2,048 and 1 <= d <= 256, by a multiply with
// the magic number m = floor(2^20 / d) + 1: the error p (m - 2^20 / d) /
// 2^20 < 1 / 512 never carries past the next multiple of 1 / d
__host__ __device__ constexpr int div_magic(int d) {
  return (1 << 20) / d + 1;
}
__device__ __forceinline__ int div_small(int p, int magic) {
  return (p * magic) >> 20;
}

// One 16-byte chunk of the halo tile activated in place (0 outside the
// image), logical chunk lc of pixel p: in box i of the first load (rows
// from t.row0 - 1) or in the second box (rows from -1, the next image); a
// pixel between the two (i == imgs) is outside too.
__device__ __forceinline__ void activate_chunk(uint32_t buf, const Geo& g,
                                               const float (&av)[8],
                                               const float (&bv)[8], int lc,
                                               int p, const HaloTile& t) {
  const int pw = g.w + 2;
  const bool second = t.two && p >= g.split;
  const int pl = second ? p - g.split : p;
  const int q = div_small(pl, g.magic_pw), col = pl - q * pw;
  const int i = div_small(q, g.magic_ph);
  const int ih = (second ? 0 : t.row0) - 1 + q - i * (g.rows + 2);
  const bool in = col >= 1 && col <= g.w && ih >= 0 && ih < g.h &&
                  i < g.imgs && t.img + i + second < g.n;
  const uint32_t at = buf + p * 128 + ((lc ^ (p & 7)) << 4);
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (in) {
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(at));
    v = act8(v, av, bv);
  }
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(at),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// a and b of the eight channels of logical chunk lc of channel block c0
__device__ __forceinline__ void load_affine(float (&av)[8], float (&bv)[8],
                                            const float* __restrict__ a,
                                            const float* __restrict__ b,
                                            int c0, int lc) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    av[e] = __ldg(a + c0 + 8 * lc + e);
    bv[e] = __ldg(b + c0 + 8 * lc + e);
  }
}

// The activation warps activate the pixels tile t's taps read of its
// halo at buf, in place: activation thread i takes logical chunk i % 8
// (channels c0 + 8 (i % 8) ..; a and b in av, bv) of pixels t.lo + i / 8,
// + ACT_THREADS / 8, ...; positions outside their image (columns -1 and w,
// rows outside 0 .. h - 1, images past n) become 0.
__device__ __forceinline__ void activate(uint32_t buf, const Geo& g,
                                         const float (&av)[8],
                                         const float (&bv)[8], int i,
                                         const HaloTile& t) {
#pragma unroll 4
  for (int p = t.lo + i / 8; p < t.hi; p += ACT_THREADS / 8)
    activate_chunk(buf, g, av, bv, i % 8, p, t);
  // the next write to this buffer is TMA's (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The A fragments of one tap (4 k16 steps of 64 channels) for this lane's
// ldmatrix row: halo pixel p, 16-byte chunk 2 kk + lane / 16 under the
// swizzle.
__device__ __forceinline__ void load_tap(uint32_t (&fr)[4][4], uint32_t buf,
                                         int p) {
  const int hi = (threadIdx.x % 32) >> 4;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t at = buf + p * 128 + (((2 * kk + hi) ^ (p & 7)) << 4);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(fr[kk][0]), "=r"(fr[kk][1]), "=r"(fr[kk][2]), "=r"(fr[kk][3])
        : "r"(at)
        : "memory");
  }
}

// Keep a tap's fragment registers where the compiler put them until here:
// a wgmma reads them after its issue, so they must not be reused before
// the group that reads them is done.
__device__ __forceinline__ void hold(uint32_t (&fr)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(fr[kk][i])::"memory");
}

// The loads of step k's halo (tile t, channel block cb) into buffer k % 2,
// once the consumers are done with that buffer's last step
__device__ __forceinline__ void load_halo(const Geo& geo,
                                          const CUtensorMap* map,
                                          uint32_t halo, uint32_t hfull,
                                          uint32_t hempty, int tiles_m, int k,
                                          int t, int cb) {
  const int hb = k & 1;
  const HaloTile ht = halo_tile(geo, tiles_m, t);
  const uint32_t buf = halo + hb * geo.halo_bytes, full = hfull + 8 * hb;
  mbar_wait(hempty + 8 * hb, ((k >> 1) & 1) ^ 1);
  mbar_expect_tx(full, (geo.imgs + ht.two) * (geo.w + 2) * (geo.rows + 2) *
                           128);
  tma_load_4d(buf, map, cb * BK, -1, ht.row0 - 1, ht.img, full);
  if (ht.two)
    tma_load_4d(buf + geo.split * 128, map, cb * BK, -1, -1, ht.img + 1, full);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tma_x,
                 const __grid_constant__ CUtensorMap tma_w,
                 const __grid_constant__ CUtensorMap tma_y,
                 const float* __restrict__ a, const float* __restrict__ b,
                 Geo geo, int stages) {
  constexpr int STAGE = BN * BK * 2;  // BN / 64 boxes of 64 k x 64 n
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t halo = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = halo + HALOS * geo.halo_bytes;
  const uint32_t staging = ring + stages * STAGE;
  const uint32_t bars = staging + CONSUMERS * BN * 128;
  const Ring pipe{bars, stages};
  // a halo buffer's barriers: landed (TMA), activated (the activation
  // warps), read (the consumer warps' last ldmatrix of its step landed)
  const uint32_t hfull = bars + 16 * stages, hact = hfull + 8 * HALOS;
  const uint32_t hempty = hact + 8 * HALOS;
  const int tiles_m = (geo.n * geo.h * geo.w + BM - 1) / BM;
  const int tiles = tiles_m * ((geo.cout + BN - 1) / BN);
  const int cblocks = geo.cin / BK;

  if (threadIdx.x == 0) {
    pipe.init(CONSUMERS);
    for (int i = 0; i < HALOS; ++i) {
      mbar_init(hfull + 8 * i, 1);
      mbar_init(hact + 8 * i, ACT_WARPS);
      mbar_init(hempty + 8 * i, 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // A block's steps are (tile, channel block) pairs in order: tiles
  // blockIdx.x, + gridDim.x, ..., each over its cblocks; step k uses halo
  // buffer k % 2 for the (k / 2)-th time.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4 * CONSUMERS) {
    // the weight producer: its lane 0 issues every weight box
    if (lane != 0) return;
    RingPos pos;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int n0 = (t / tiles_m) * BN;
      for (int cb = 0; cb < cblocks; ++cb) {
        for (int tap = 0; tap < 9; ++tap) {
          const uint32_t full = pipe.acquire(pos, STAGE);
          for (int q = 0; q < BN / 64; ++q)
            tma_load_2d(ring + pos.s * STAGE + q * 8192, &tma_w, n0 + 64 * q,
                        tap * geo.cin + cb * BK, full);
          pos.advance(stages);
        }
      }
    }
    return;
  }
  if (warp == 4 * CONSUMERS + 1) {
    // the halo producer: its lane 0 loads each step's halo as soon as the
    // consumers have read that buffer's last step (two steps before), so
    // the load is not held behind the activation of the step between
    if (lane != 0) return;
    int k = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x)
      for (int cb = 0; cb < cblocks; ++cb, ++k)
        load_halo(geo, &tma_x, halo, hfull, hempty, tiles_m, k, t, cb);
    return;
  }
  if (warp > 4 * CONSUMERS + 1) {
    // the activation warps, beside the consumers' products: for each step
    // in order, wait for its halo, activate it in place and hand it to the
    // consumers
    const int i = threadIdx.x - 32 * (4 * CONSUMERS + 2);
    float av[8], bv[8];
    int k = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const HaloTile ht = halo_tile(geo, tiles_m, t);
      for (int cb = 0; cb < cblocks; ++cb, ++k) {
        const int hb = k & 1;
        load_affine(av, bv, a, b, cb * BK, i % 8);
        mbar_wait(hfull + 8 * hb, (k >> 1) & 1);
        activate(halo + hb * geo.halo_bytes, geo, av, bv, i, ht);
        __syncwarp();
        if (lane == 0) mbar_arrive(hact + 8 * hb);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output rows 64 wg .. 64 wg + 63 of a tile;
  // this lane's ldmatrix row r (its halo pixel at the centre tap: p0)
  const int wg = warp / 4;
  const int r = 64 * wg + 16 * (warp % 4) + (lane & 15);
  const int pw = geo.w + 2;
  const bool leader = threadIdx.x % 128 == 0;
  float acc[BN / 2];
  RingPos pos;
  int k = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t % tiles_m) * BM, n0 = (t / tiles_m) * BN;
    // a row past the last pixel reads around pixel w + 3 (its row is
    // clipped)
    const int p0 = m0 + r < geo.n * geo.h * geo.w
                       ? centre_pixel(geo, halo_tile(geo, tiles_m, t), m0 + r)
                       : pw + 1;
    for (int cb = 0; cb < cblocks; ++cb, ++k) {
      const int hb = k & 1;
      const uint32_t buf = halo + hb * geo.halo_bytes;
      mbar_wait(hact + 8 * hb, (k >> 1) & 1);
      uint32_t fr[2][4][4];
      load_tap(fr[0], buf, p0 - pw - 1);
      int prev = 0;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        pipe.wait(pos);
        const uint64_t db = smem_desc_mn(ring + pos.s * STAGE, 8192, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // 16 k rows = 2,048 B
          wgmma_bf16_ra<BN, 1>(acc, fr[tap & 1][kk], db + 128 * kk,
                               (cb | tap | kk) != 0);
        wgmma_commit();
        if (tap == 8) {
          // the last tap's wgmma took its fragments as operands, so this
          // warp's last ldmatrix of the halo has landed: the next TMA into
          // the buffer may overwrite it (an arrival right after the
          // ldmatrix let a TMA overtake the read)
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
          if (lane == 0) mbar_arrive(hempty + 8 * hb);
        }
        if (tap > 0) {
          // the previous tap's group is done: its stage and registers free
          wgmma_wait<1>();
          hold(fr[(tap + 1) & 1]);
          if (leader) pipe.release(prev);
        }
        prev = pos.s;
        pos.advance(stages);
        if (tap < 8) {
          const int nt = tap + 1;
          load_tap(fr[nt & 1], buf, p0 + (nt / 3 - 1) * pw + nt % 3 - 1);
        }
      }
      wgmma_wait<0>();
      hold(fr[0]);
      if (leader) pipe.release(prev);
    }
    gm::stage_store<BN>(acc, staging + wg * BN * 128, &tma_y, n0,
                        m0 + 64 * wg, wg);
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The most rows of one image, and images, that a tile of 128 consecutive
// pixels touches (ops/masked_matmul.py `fused_fwd_halo`): a tile starts at
// a multiple of gcd(128, w) within its row and of gcd(128, h * w) within
// its image.
inline int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }

inline int halo_rows(int h, int w) {
  const int rows = 1 + (w - gcd(BM, w) + BM - 1) / w;
  return rows < h ? rows : h;
}

inline int halo_imgs(int h, int w) {
  return 1 + (h * w - gcd(BM, h * w) + BM - 1) / (h * w);
}

template <int BN>
int launch_fwd(const CUtensorMap& mx, const CUtensorMap& mw,
               const CUtensorMap& my, const float* a, const float* b,
               const Geo& geo, int stages, int grid, cudaStream_t st) {
  const int smem = fwd_smem_bytes(BN, stages, geo.halo_bytes);
  cudaError_t err =
      cpg::allow_smem((const void*)fwd_wgmma_kernel<BN>, smem);
  if (err != cudaSuccess) return (int)err;
  fwd_wgmma_kernel<BN><<<grid, THREADS, smem, st>>>(mx, mw, my, a, b, geo,
                                                    stages);
  return (int)cudaGetLastError();
}

}  // namespace k4

extern "C" {

// x (N,H,W,Cin) bf16, a/b (Cin,) f32, w (3,3,Cin,Cout) bf16, y (N,H,W,Cout)
// bf16; all contiguous on one device, x and w 16-byte aligned, Cin and Cout
// multiples of 8. Returns a cudaError_t code.
int fused_chain_fwd_bf16(const void* x, const void* a, const void* b,
                         const void* w, void* y, int n, int h, int wd,
                         int cin, int cout, void* stream) {
  if (bad_shape(n, h, wd, cin, cout) || cin % 8 || cout % 8)
    return (int)cudaErrorInvalidValue;
  return launch<bf16>(fused_chain_fwd_bf16_kernel, smem_bytes_bf16(wd), x, a,
                      b, w, y, n, h, wd, cin, cout, stream);
}

// The same with f32 x, w and y, any Cin and Cout.
int fused_chain_fwd_f32(const void* x, const void* a, const void* b,
                        const void* w, void* y, int n, int h, int wd, int cin,
                        int cout, void* stream) {
  if (bad_shape(n, h, wd, cin, cout)) return (int)cudaErrorInvalidValue;
  return launch<float>(fused_chain_fwd_f32_kernel, smem_bytes_f32(wd), x, a,
                       b, w, y, n, h, wd, cin, cout, stream);
}

// The GEMM route (see the top): x (N,H,W,Cin), w (3,3,Cin,Cout) and y
// (N,H,W,Cout) bf16, a, b (Cin,) f32; Cin and Cout multiples of 64, bases
// 16-byte aligned. The halo's rows, imgs and split, and bn (64 or 128),
// stages and grid are ops/masked_matmul.py `fused_fwd_halo`'s and
// `fused_fwd_plan`'s. Returns a cudaError_t code.
int fused_chain_fwd_gemm_bf16(const void* x, const void* a, const void* b,
                              const void* w, void* y, int n, int h, int wd,
                              int cin, int cout, int rows, int imgs,
                              int split, int bn, int stages, int grid,
                              void* stream) {
  namespace gm = cpg::gemm;
  if (n < 1 || h < 1 || wd < 1 || cin < 1 || cout < 1)
    return (int)cudaErrorInvalidValue;
  const int box = (wd + 2) * (rows + 2);
  // whole images: every image a tile touches; else one image's rows, and a
  // second box where a tile can cross into the next image
  const bool ok_halo =
      rows == h ? imgs >= k4::halo_imgs(h, wd) && split == 0
                : rows >= k4::halo_rows(h, wd) && imgs == 1 &&
                      ((h * wd) % k4::BM == 0
                           ? split == 0
                           : split >= box && split % 8 == 0);
  const int halo_px = split ? split + box : box * imgs;
  const k4::Geo geo{n,
                    h,
                    wd,
                    cin,
                    cout,
                    rows,
                    imgs,
                    split,
                    (halo_px * 128 + 1023) / 1024 * 1024,
                    k4::div_magic(wd + 2),
                    k4::div_magic(rows + 2)};
  if (!ok_halo || rows < 1 || rows > h || cin % k4::BK || cout % k4::BK ||
      wd + 2 > 256 || rows + 2 > 256 || imgs > 256 || halo_px > 2048 ||
      stages < 2 || grid <= 0 || (bn != 64 && bn != 128) ||
      k4::fwd_smem_bytes(bn, stages, geo.halo_bytes) > gm::SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const long long xdims[4] = {cin, wd, h, n};
  const int xbox[4] = {k4::BK, wd + 2, rows + 2, imgs};
  CUtensorMap mx, mw, my;
  if (!cpg::hopper::make_map_nd(&mx, x, 4, xdims, xbox) ||
      !gm::make_map(&mw, w, 9 * cin, cout, 64) ||
      !gm::make_map(&my, y, n * h * wd, cout, 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float *af = (const float*)a, *bf = (const float*)b;
  return bn == 64
             ? k4::launch_fwd<64>(mx, mw, my, af, bf, geo, stages, grid, st)
             : k4::launch_fwd<128>(mx, mw, my, af, bf, geo, stages, grid, st);
}
}  // extern "C"
