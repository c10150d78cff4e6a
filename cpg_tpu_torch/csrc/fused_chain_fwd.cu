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
// 256 (4.8-19.3 GFLOP against 3-34 MB of x and y). Two routes, chosen by
// ops/fused_chain.py before the launch (`fwd_route`):
//
// * bf16 with Cin and Cout multiples of 64 on a grid that `conv_box` tiles
//   and whose halo tiles fit shared memory (every VGG16-BN seam at width
//   1.0; not 1x1): `fused_chain_fwd_gemm_bf16`, an
//   implicit GEMM on Hopper's TMA and wgmma. TMA can land only raw x, and
//   SAME padding comes after the activation (a padded position of the
//   activation is 0, not relu(b)), so the A operand cannot be TMA's zero-
//   filled per-tap box fed straight to wgmma. Instead, for each (128-pixel
//   output tile, 64-channel block), one producer thread loads one 4-D TMA box
//   of raw x with its halo, (64, W + 2, rows + 2, images) at (c0, -1, oh0 -
//   1, n0): images are a box dimension, so a tile of whole images gets a halo
//   per image. The two consumer warpgroups activate it once, in place:
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
//   as the other GEMMs), so no transposed copy is written. The activated halo tiles are double-buffered apart from the
//   ring and released after their nine taps. The activation runs beside the
//   products: each step (tile, channel block) activates the next step's halo
//   in slices, one after each of its last five taps while that tap's wgmma
//   group runs (the producer issues that halo after the step's fifth weight
//   box, when the buffer's previous step is done). The epilogue rounds to
//   bf16 through the swizzled staging tile and stores by TMA (tma_gemm.cuh
//   `stage_store`). Whole K a tile, no split, no atomics. Plan (tile width,
//   ring depth, halo bytes, grid): ops/masked_matmul.py `fused_fwd_plan`,
//   whose shared-memory sum is `fwd_smem_bytes` below.
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
constexpr int THREADS = gm::THREADS;  // two consumer WGs + a producer warp
constexpr int HALOS = 2;              // activated halo tiles in flight
// the taps from which a step activates the next step's halo, a slice
// after each (the producer loads that halo after this tap's weights)
constexpr int ACT_FIRST_TAP = 4;

// One seam on the route: the 128-pixel output tile is `rows` rows of w
// pixels of `imgs` images; its halo box holds halo_px = (w + 2) * (rows +
// 2) * imgs pixels of 128 B, in a buffer of halo_bytes (rounded up to the
// swizzle's 1,024 B); magic_pw and magic_ph divide by w + 2 and rows + 2
// (`div_small`).
struct Geo {
  int n, h, w, cin, cout, rows, imgs, halo_px, halo_bytes, magic_pw,
      magic_ph;
};

// dynamic shared memory: 1 KB of slack to align to 1,024 bytes, the halo
// tiles, the ring of bn x 64 weight stages, the output staging (as
// tma_gemm.cuh's), a full and an empty barrier a stage and a halo tile
__host__ __device__ constexpr int fwd_smem_bytes(int bn, int stages,
                                                 int halo_bytes) {
  return 1024 + HALOS * halo_bytes + stages * bn * BK * 2 +
         CONSUMERS * bn * 128 + 16 * (stages + HALOS);
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
// image), logical chunk lc of pixel p.
__device__ __forceinline__ void activate_chunk(uint32_t buf, const Geo& g,
                                               const float (&av)[8],
                                               const float (&bv)[8], int lc,
                                               int p, int img, int oh0) {
  const int pw = g.w + 2;
  const int q = div_small(p, g.magic_pw), col = p - q * pw;
  const int i = div_small(q, g.magic_ph), ih = oh0 - 1 + q - i * (g.rows + 2);
  const bool in = col >= 1 && col <= g.w && ih >= 0 && ih < g.h &&
                  img + i < g.n;
  const uint32_t at = buf + p * 128 + ((lc ^ (p & 7)) << 4);
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(at));
  v = in ? act8(v, av, bv) : make_uint4(0u, 0u, 0u, 0u);
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

// The consumers activate the halo tile at buf in place, activation rows k0
// .. k1 - 1 of 32 pixels: consumer thread c takes logical chunk c % 8
// (channels c0 + 8 (c % 8) ..; a and b in av, bv) of pixels 32 k + c / 8;
// positions outside their image (columns -1 and w, rows outside 0 .. h -
// 1, images past n) become 0.
__device__ __forceinline__ void activate(uint32_t buf, const Geo& g,
                                         const float (&av)[8],
                                         const float (&bv)[8], int lc,
                                         int k0, int k1, int img, int oh0) {
  for (int k = k0; k < k1; ++k) {
    const int p = 32 * k + (int)threadIdx.x / 8;
    if (p < g.halo_px) activate_chunk(buf, g, av, bv, lc, p, img, oh0);
  }
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

// The producer's load of step k's halo box (tile t, channel block cb) into
// buffer k % 2, once the consumers are done with that buffer's last step
__device__ __forceinline__ void load_halo(const Geo& geo,
                                          const CUtensorMap* map,
                                          uint32_t halo, uint32_t hfull,
                                          uint32_t hempty, int tiles_m, int k,
                                          int t, int cb) {
  const int hb = k & 1, hw = geo.h * geo.w;
  const int m0 = (t % tiles_m) * BM, img = m0 / hw;
  const int oh0 = (m0 - img * hw) / geo.w;
  mbar_wait(hempty + 8 * hb, ((k >> 1) & 1) ^ 1);
  mbar_expect_tx(hfull + 8 * hb, geo.halo_px * 128);
  tma_load_4d(halo + hb * geo.halo_bytes, map, cb * BK, -1, oh0 - 1, img,
              hfull + 8 * hb);
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
  const uint32_t hfull = bars + 16 * stages, hempty = hfull + 8 * HALOS;
  const int hw = geo.h * geo.w, M = geo.n * hw;
  const int tiles_m = (M + BM - 1) / BM;
  const int tiles = tiles_m * ((geo.cout + BN - 1) / BN);
  const int cblocks = geo.cin / BK;

  if (threadIdx.x == 0) {
    pipe.init(CONSUMERS);
    for (int i = 0; i < HALOS; ++i) {
      mbar_init(hfull + 8 * i, 1);
      mbar_init(hempty + 8 * i, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // A block's steps are (tile, channel block) pairs in order: tiles
  // blockIdx.x, + gridDim.x, ..., each over its cblocks; step k uses halo
  // buffer k % 2 for the (k / 2)-th time.
  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // producer warp: one thread issues every TMA load of the block. The
    // next step's halo goes out after this step's fifth weight box: by
    // then the consumers are done with the step before (its buffer), and
    // they activate the halo during this step's last taps.
    if (threadIdx.x != CONSUMERS * 128) return;
    RingPos pos;
    int k = 0;
    if (blockIdx.x < tiles)
      load_halo(geo, &tma_x, halo, hfull, hempty, tiles_m, 0, blockIdx.x, 0);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int n0 = (t / tiles_m) * BN;
      for (int cb = 0; cb < cblocks; ++cb, ++k) {
        for (int tap = 0; tap < 9; ++tap) {
          const uint32_t full = pipe.acquire(pos, STAGE);
          for (int q = 0; q < BN / 64; ++q)
            tma_load_2d(ring + pos.s * STAGE + q * 8192, &tma_w, n0 + 64 * q,
                        tap * geo.cin + cb * BK, full);
          pos.advance(stages);
          if (tap == ACT_FIRST_TAP) {
            const bool last = cb + 1 == cblocks;
            const int tn = last ? t + gridDim.x : t;
            if (tn < tiles)
              load_halo(geo, &tma_x, halo, hfull, hempty, tiles_m, k + 1, tn,
                        last ? 0 : cb + 1);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output rows 64 wg .. 64 wg + 63 of a tile;
  // this lane's ldmatrix row r and its halo pixel at the centre tap
  const int lane = threadIdx.x % 32, lc = threadIdx.x % 8;
  const int r = 64 * wg + 16 * ((threadIdx.x / 32) % 4) + (lane & 15);
  const int pw = geo.w + 2;
  const int rq = r / geo.w, ri = rq / geo.rows;
  const int p0 = (ri * (geo.rows + 2) + rq - ri * geo.rows + 1) * pw +
                 r % geo.w + 1;
  const int kpx = (geo.halo_px + 31) / 32;  // activation rows of 32 pixels
  const bool leader = threadIdx.x % 128 == 0;
  float acc[BN / 2], av[8], bv[8];
  if (blockIdx.x < tiles) {  // the first step's halo, all of it
    const int img = ((blockIdx.x % tiles_m) * BM) / hw;
    const int oh0 = ((blockIdx.x % tiles_m) * BM - img * hw) / geo.w;
    mbar_wait(hfull, 0);
    load_affine(av, bv, a, b, 0, lc);
    activate(halo, geo, av, bv, lc, 0, kpx, img, oh0);
    named_sync(3, 256);
  }
  RingPos pos;
  int k = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t % tiles_m) * BM, n0 = (t / tiles_m) * BN;
    for (int cb = 0; cb < cblocks; ++cb, ++k) {
      const uint32_t buf = halo + (k & 1) * geo.halo_bytes;
      const uint32_t nbuf = halo + ((k + 1) & 1) * geo.halo_bytes;
      // the next step, whose halo this step activates during its last taps
      const bool last = cb + 1 == cblocks;
      const int tn = last ? t + gridDim.x : t, cbn = last ? 0 : cb + 1;
      const bool next = tn < tiles;
      const int mn = (tn % tiles_m) * BM, imgn = mn / hw;
      const int ohn = (mn - imgn * hw) / geo.w;
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
        if (tap > 0) {
          // the previous tap's group is done: its stage and registers free
          wgmma_wait<1>();
          hold(fr[(tap + 1) & 1]);
          if (leader) pipe.release(prev);
        }
        prev = pos.s;
        pos.advance(stages);
        // while this tap's group runs, a slice of the next step's halo
        if (next && tap >= ACT_FIRST_TAP) {
          constexpr int SLICES = 9 - ACT_FIRST_TAP;
          if (tap == ACT_FIRST_TAP) {
            mbar_wait(hfull + 8 * ((k + 1) & 1), ((k + 1) >> 1) & 1);
            load_affine(av, bv, a, b, cbn * BK, lc);
          }
          const int sl = tap - ACT_FIRST_TAP;
          activate(nbuf, geo, av, bv, lc, sl * kpx / SLICES,
                   (sl + 1) * kpx / SLICES, imgn, ohn);
        }
        if (tap < 8) {
          const int nt = tap + 1;
          load_tap(fr[nt & 1], buf, p0 + (nt / 3 - 1) * pw + nt % 3 - 1);
        }
      }
      wgmma_wait<0>();
      hold(fr[0]);
      if (leader) {
        // every ldmatrix of this warpgroup came before its finished groups
        pipe.release(prev);
        mbar_arrive(hempty + 8 * (k & 1));
      }
      if (next) named_sync(3, 256);  // both halves of the next halo are in
    }
    gm::stage_store<BN>(acc, staging + wg * BN * 128, &tma_y, n0,
                        m0 + 64 * wg, wg);
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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
// 16-byte aligned. The 128-pixel tile is the box (64, W, box_h, box_n) of
// ops/masked_conv.py `conv_box`; bn (64 or 128), stages and grid from
// ops/masked_matmul.py `fused_fwd_plan`. Returns a cudaError_t code.
int fused_chain_fwd_gemm_bf16(const void* x, const void* a, const void* b,
                              const void* w, void* y, int n, int h, int wd,
                              int cin, int cout, int box_h, int box_n, int bn,
                              int stages, int grid, void* stream) {
  namespace gm = cpg::gemm;
  const int halo_px = (wd + 2) * (box_h + 2) * box_n;
  const k4::Geo geo{n,
                    h,
                    wd,
                    cin,
                    cout,
                    box_h,
                    box_n,
                    halo_px,
                    (halo_px * 128 + 1023) / 1024 * 1024,
                    k4::div_magic(wd + 2),
                    k4::div_magic(box_h + 2)};
  if (n < 1 || h < 1 || cin < 1 || cout < 1 || cin % k4::BK ||
      cout % k4::BK || wd * box_h * box_n != k4::BM || h % box_h ||
      (box_n > 1 && box_h != h) || wd + 2 > 256 || box_h + 2 > 256 ||
      halo_px > 2048 ||
      stages < 2 || grid <= 0 || (bn != 64 && bn != 128) ||
      k4::fwd_smem_bytes(bn, stages, geo.halo_bytes) > gm::SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const long long xdims[4] = {cin, wd, h, n};
  const int xbox[4] = {k4::BK, wd + 2, box_h + 2, box_n};
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
