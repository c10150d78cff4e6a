// The persistent TMA + wgmma TN GEMM of the port's Hopper kernels, with
// its producer walks and its epilogues (csrc/masked_matmul.cu describes the
// design), and its sibling over im2col loads (`conv_im2col_kernel`: the
// masked conv's y and dx at any grid, stride 1 or 2). Two sources
// instantiate both: masked_matmul.cu (the dense and conv K1/K2 products,
// EPI_STORE) and fused_chain_bwd_dx.cu (K5, EPI_FUSED_DX: the CONV_DGRAD
// walk over g's boxes, or the stride-1 dgrad im2col walk, over g and the
// seam's weight, whose epilogue `fused_dx_epilogue` applies the ReLU mask
// of a*x + b, writes dx = dm * a and the tile's column sums of dm * x and
// dm). `stage_store` is also K4's epilogue (fused_chain_fwd.cu).
#pragma once

#include "tma_wgmma.cuh"

namespace cpg {
namespace gemm {

using namespace cpg::hopper;

constexpr int BM = 128;            // output rows a tile: two warpgroups of 64
constexpr int BK = 64;             // reduction depth a stage: one 128-B row
constexpr int CONSUMERS = 2;       // consumer warpgroups
constexpr int THREADS = 128 * CONSUMERS + 32;  // + one producer warp
constexpr int A_TILE = BM * BK * 2;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block (H100)

__host__ __device__ constexpr int stage_bytes(int bn) {
  return A_TILE + bn * BK * 2;
}

// What the producer loads: the dense product, or the conv's forward or
// input gradient over per-tap activation boxes (masked_matmul.cu's top).
enum Walk { DENSE = 0, CONV_FWD = 1, CONV_DGRAD = 2 };

// What the consumers do with a finished tile: round to bf16 and store it
// (EPI_STORE), or K5's epilogue over the tile of x that the producer loads
// beside the ring (EPI_FUSED_DX).
enum Epilogue { EPI_STORE = 0, EPI_FUSED_DX = 1 };

// dynamic shared memory: 1 KB of slack to align the ring to 1,024 bytes
// (the 128-byte swizzle repeats every 8 rows of 128 B), the ring, the
// output staging (each consumer warpgroup's 64 x bn tile, as bn / 64
// swizzled 64 x 64 boxes), and a full and an empty barrier a stage; K5
// adds x's 128 x bn tile in the staging's layout (its column partials
// reuse it once it is read) and x's full and empty barriers
__host__ __device__ constexpr int gemm_smem_bytes(int bn, int stages,
                                                  int epi = EPI_STORE) {
  return 1024 + stages * stage_bytes(bn) + CONSUMERS * bn * 128 +
         16 * stages + (epi == EPI_FUSED_DX ? CONSUMERS * bn * 128 + 16 : 0);
}

// The conv's reduction walk and output grid (unused by DENSE): C / 64
// channel blocks a tap, kw taps a kernel row, the output grid's hw = Ho*Wo
// and wo, the padding before the first row and column.
struct ConvWalk {
  int cblocks, kw, hw, wo, pad_top, pad_left;
};

// K5's epilogue operands (unused by EPI_STORE): the folded BN affine a, b
// (cin,) f32, and the f32 column partials ws_da, ws_db (tiles_m, cin).
struct FusedDx {
  const float* a;
  const float* b;
  float* ws_da;
  float* ws_db;
  int cin;
};

// The consumer warpgroup's epilogue store, in three steps: wait until its
// staging tile is free (the last TMA store from it has read it); put each
// register quad j of the D fragment of m64nBN (warp w of the warpgroup
// holds rows 16w + lane/4 and + 8; register 4j + {0,1} (+{2,3}: row + 8)
// holds columns 8j + 2*(lane%4) + {0,1}), rounded to bf16, into the
// staging boxes in TMA's 128-byte swizzle (column group j % 8 of box j / 8
// lands at group (j % 8) ^ (row % 8)); then one thread stores the boxes by
// TMA at (col0 + 64 q, row0), which clips them at the tensor's edge. The
// stores drain while the warpgroup runs the next tile's products; named
// barrier 1 + wg.
__device__ __forceinline__ void staging_wait(int wg) {
  if (threadIdx.x % 128 == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  named_sync(1 + wg, 128);
}

// this thread's byte offset of register quad j in a staging (or x) tile
__device__ __forceinline__ uint32_t quad_offset(int j) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4;
  return r0 * 128 + 4 * (lane % 4) + (j / 8) * 8192 +
         (((j % 8) ^ (r0 % 8)) << 4);
}

__device__ __forceinline__ void staging_put(uint32_t mine, int j, float v0,
                                            float v1, float v2, float v3) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v0, v1);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v2, v3);
  const uint32_t at = mine + quad_offset(j);
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
               "r"(*reinterpret_cast<const uint32_t*>(&lo))
               : "memory");
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + 8 * 128),
               "r"(*reinterpret_cast<const uint32_t*>(&hi))
               : "memory");
}

template <int BN>
__device__ __forceinline__ void staging_store(uint32_t mine,
                                              const CUtensorMap* map,
                                              int col0, int row0, int wg) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(1 + wg, 128);
  if (threadIdx.x % 128 == 0) {
#pragma unroll
    for (int q = 0; q < BN / 64; ++q)
      tma_store_2d(map, mine + q * 8192, col0 + 64 * q, row0);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

template <int BN>
__device__ __forceinline__ void stage_store(const float (&acc)[BN / 2],
                                            uint32_t mine,
                                            const CUtensorMap* map, int col0,
                                            int row0, int wg) {
  staging_wait(wg);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
    staging_put(mine, j, acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                acc[4 * j + 3]);
  staging_store<BN>(mine, map, col0, row0, wg);
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// K5's epilogue of one tile (m-tile tm, columns n0 ..; rows m0 + 64 wg of
// this warpgroup): for each sum dact[m, c], pre = a[c] * x[m, c] + b[c]
// rounded as the plain version rounds it (product, then sum: no FMA), dm =
// pre > 0 ? dact : 0, dx = dm * a[c], rounded to bf16 and stored as
// `stage_store` stores; and the tile's column sums of dm * x and dm in a
// fixed order: the thread's two rows, a butterfly over the 8 lanes that
// share its columns, then the 8 warps in order through shared memory (x's
// tile, once both warpgroups have read it), written to the partials' row
// tm. x's 128 x BN tile lands at xbuf in the staging's layout
// (`load_x_tile`); the epilogue waits for it on xfull and hands the buffer
// back on xempty. Named barrier 3 spans both warpgroups.
template <int BN>
__device__ __forceinline__ void fused_dx_epilogue(
    const float (&acc)[BN / 2], uint32_t xbuf, uint32_t xfull,
    uint32_t xempty, uint32_t& xphase, uint32_t mine,
    const CUtensorMap* map, const FusedDx& fd, int tm, int n0, int m0,
    int wg) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const uint32_t xmine = xbuf + wg * BN * 128;
  float sums[BN / 8][4];  // da (c, c + 1), db (c, c + 1)
  mbar_wait(xfull, xphase);
  xphase ^= 1;
  staging_wait(wg);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = n0 + 8 * j + 2 * (lane % 4);
    const uint32_t at = xmine + quad_offset(j);
    uint32_t u0, u1;
    asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(u0) : "r"(at));
    asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(u1) : "r"(at + 8 * 128));
    const float2 xa = bf16x2_to_float2(u0), xb = bf16x2_to_float2(u1);
    const bool in = c < fd.cin;  // cin % 8 == 0: c + 1 too
    const float2 av = in ? *reinterpret_cast<const float2*>(fd.a + c)
                         : make_float2(0.f, 0.f);
    const float2 bv = in ? *reinterpret_cast<const float2*>(fd.b + c)
                         : make_float2(0.f, 0.f);
    const float xs[4] = {xa.x, xa.y, xb.x, xb.y};
    const float as[2] = {av.x, av.y}, bs[2] = {bv.x, bv.y};
    float dx[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pre = __fadd_rn(__fmul_rn(xs[e], as[e % 2]), bs[e % 2]);
      const float dm = pre > 0.f ? acc[4 * j + e] : 0.f;
      dx[e] = __fmul_rn(dm, as[e % 2]);
      const float px = __fmul_rn(dm, xs[e]);
      if (e < 2) {
        sums[j][e] = px;
        sums[j][2 + e] = dm;
      } else {
        sums[j][e - 2] = __fadd_rn(sums[j][e - 2], px);
        sums[j][e] = __fadd_rn(sums[j][e], dm);
      }
    }
    staging_put(mine, j, dx[0], dx[1], dx[2], dx[3]);
#pragma unroll
    for (int sh = 4; sh < 32; sh *= 2)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sums[j][e] = __fadd_rn(sums[j][e],
                               __shfl_xor_sync(0xffffffffu, sums[j][e], sh));
  }
  staging_store<BN>(mine, map, n0, m0 + 64 * wg, wg);
  // every consumer thread has read its x: the tile becomes the partials,
  // [2][8 warps][BN] f32
  named_sync(3, 256);
  const int w8 = wg * 4 + warp;
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * lane;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t at =
            xbuf + 4 * (((e / 2) * 8 + w8) * BN + col + (e % 2));
        asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(at), "f"(sums[j][e])
                     : "memory");
      }
    }
  }
  named_sync(3, 256);
  for (int i = threadIdx.x; i < 2 * BN; i += 256) {
    const int which = i / BN, col = i % BN;
    if (n0 + col >= fd.cin) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      float v;
      asm volatile("ld.shared.f32 %0, [%1];\n"
                   : "=f"(v)
                   : "r"(xbuf + 4 * ((which * 8 + w) * BN + col)));
      sum = __fadd_rn(sum, v);
    }
    (which ? fd.ws_db : fd.ws_da)[(long long)tm * fd.cin + n0 + col] = sum;
  }
  // the partials are read: x's buffer may be loaded again
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(3, 256);
  if (threadIdx.x == 0) mbar_arrive(xempty);
}

// The producer's load of x's 128 x BN tile at rows m0, columns n0 into
// xbuf for `fused_dx_epilogue`, once the epilogue before is done with it;
// each kernel issues it once the ring holds the tile's first stages, so
// that the wait does not stall the ring.
template <int BN>
__device__ __forceinline__ void load_x_tile(uint32_t xbuf,
                                            const CUtensorMap* map,
                                            uint32_t xfull, uint32_t xempty,
                                            uint32_t& xphase, int n0,
                                            int m0) {
  mbar_wait(xempty, xphase ^ 1);
  mbar_expect_tx(xfull, CONSUMERS * BN * 128);
  for (int h = 0; h < CONSUMERS; ++h)
    for (int q = 0; q < BN / 64; ++q)
      tma_load_2d(xbuf + h * BN * 128 + q * 8192, map, n0 + 64 * q,
                  m0 + 64 * h, xfull);
  xphase ^= 1;
}

// C[M, Nout] = A[M, R] Bt[Nout, R]^T, bf16, f32 accumulation (see
// masked_matmul.cu's top); with EPI_FUSED_DX, K5's dx, da and db partials
// (tma_x: x as (M, Nout) in 64 x 64 boxes; fd: the affine and partials).
template <int BN, int WALK, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
gemm_tn_bf16_kernel(const __grid_constant__ CUtensorMap tma_a,
                    const __grid_constant__ CUtensorMap tma_b,
                    const __grid_constant__ CUtensorMap tma_c,
                    const __grid_constant__ CUtensorMap tma_x, int M, int R,
                    int Nout, int stages, ConvWalk cw, FusedDx fd) {
  constexpr int STAGE = stage_bytes(BN);
  constexpr bool kDx = EPI == EPI_FUSED_DX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t staging = ring + stages * STAGE;  // CONSUMERS x bn x 128 B
  const uint32_t xbuf = staging + CONSUMERS * BN * 128;  // K5: x's tile
  const uint32_t bars = xbuf + (kDx ? CONSUMERS * BN * 128 : 0);
  const uint32_t xfull = bars + 16 * stages, xempty = xfull + 8;  // K5
  const Ring pipe{bars, stages};
  const int tiles_m = (M + BM - 1) / BM;
  const int tiles = tiles_m * ((Nout + BN - 1) / BN);
  const int KT = (R + BK - 1) / BK;

  if (threadIdx.x == 0) {
    pipe.init(CONSUMERS);
    if (kDx) {
      mbar_init(xfull, 1);
      mbar_init(xempty, 1);  // consumer thread 0, after barrier 3
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // producer warp: one thread issues every TMA load of the block
    if (threadIdx.x != CONSUMERS * 128) return;
    RingPos pos;
    uint32_t xphase = 0;
    const int xk = min(stages, KT - 1);  // K5: x's tile after this k-step
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % tiles_m) * BM, n0 = (t / tiles_m) * BN;
      // the conv tile's first output pixel: image, row, column
      const int img = WALK == DENSE ? 0 : m0 / cw.hw;
      const int oh0 = WALK == DENSE ? 0 : (m0 - img * cw.hw) / cw.wo;
      const int ow0 = WALK == DENSE ? 0 : m0 - img * cw.hw - oh0 * cw.wo;
      for (int kt = 0; kt < KT; ++kt) {
        // every box lands whole: out-of-range elements count as zeros
        const uint32_t full = pipe.acquire(pos, STAGE);
        const uint32_t a = ring + pos.s * STAGE, b = a + A_TILE;
        if constexpr (WALK == DENSE) {
          tma_load_2d(a, &tma_a, kt * BK, m0, full);
          tma_load_2d(b, &tma_b, kt * BK, n0, full);
        } else {
          const int tap = kt / cw.cblocks, c0 = (kt % cw.cblocks) * BK;
          const int dh = tap / cw.kw - cw.pad_top, dw = tap % cw.kw - cw.pad_left;
          // the forward reads x at (row + dh, col + dw); dgrad reads g at
          // (row - dh, col - dw)
          constexpr int sgn = WALK == CONV_FWD ? 1 : -1;
          tma_load_4d(a, &tma_a, c0, ow0 + sgn * dw, oh0 + sgn * dh, img, full);
          if constexpr (WALK == CONV_FWD)
            tma_load_2d(b, &tma_b, kt * BK, n0, full);
          else
            tma_load_3d(b, &tma_b, c0, n0, tap, full);
        }
        pos.advance(stages);
        if (kDx && kt == xk)
          load_x_tile<BN>(xbuf, &tma_x, xfull, xempty, xphase, n0, m0);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64*wg .. 64*wg + 63 of each tile
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const bool leader = threadIdx.x % 128 == 0;
  RingPos pos;
  uint32_t xphase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t % tiles_m) * BM, n0 = (t / tiles_m) * BN;
    int prev = 0;
    for (int kt = 0; kt < KT; ++kt) {
      pipe.wait(pos);
      const uint32_t a = ring + pos.s * STAGE + wg * 64 * BK * 2;
      const uint64_t da = smem_desc(a);
      const uint64_t db = smem_desc(ring + pos.s * STAGE + A_TILE);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_bf16<BN>(acc, da + 2 * kk, db + 2 * kk, (kt | kk) != 0);
      wgmma_commit();
      // the previous stage's products are done: hand it back
      wgmma_wait<1>();
      if (kt > 0 && leader) pipe.release(prev);
      prev = pos.s;
      pos.advance(stages);
    }
    wgmma_wait<0>();
    if (leader) pipe.release(prev);

    const uint32_t mine = staging + wg * BN * 128;
    if constexpr (kDx) {
      fused_dx_epilogue<BN>(acc, xbuf, xfull, xempty, xphase, mine, &tma_c,
                            fd, t % tiles_m, n0, m0, wg);
    } else {
      stage_store<BN>(acc, mine, &tma_c, n0, m0 + 64 * wg, wg);
    }
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------ im2col conv walk ----
// The masked conv's y and dx at any output grid, stride 1 or 2, 1x1 or 3x3
// (masked_matmul.cu `masked_conv_im2col_gemm_bf16` describes the design):
// the output is cut into phases (one for the forward and the stride-1
// input gradient; the stride-2 input gradient's four parity phases of dx),
// each a grid of output pixels walked in 128-pixel tiles of consecutive
// pixels, whose A tile a k-step is one im2col TMA load of the activation
// at one tap's offsets. A phase with no tap stores zeros.
constexpr int MAX_PHASES = 4, MAX_TAPS = 9;

struct Phase {
  int m, hw, w;          // output pixels, pixels an image, columns
  int tiles_m;           // its 128-pixel tiles
  int lower_w, lower_h;  // the A map's bounding box starts here
  int row0, col0;        // scatter: dx's first row and column of the phase
  int ntaps;             // taps a tile reduces, each cblocks k-steps
  int taps[MAX_TAPS];    // tap | offset_w << 8 | offset_h << 16
};

struct Im2colWalk {
  int nphases, cblocks;  // phases; 64-channel blocks of the reduction
  int step;              // the A maps' traversal stride
  int tiles;             // all tiles, each phase's m tiles by the n tiles
  int tile0[MAX_PHASES]; // the phases' first tiles
  int scatter;           // 1: store rows to dx's strided positions
  int out_h, out_w, out_step;  // scatter: dx's rows, columns, the stride
  __nv_bfloat16* out;    // scatter: dx (N, out_h, out_w, Nout)
  Phase ph[MAX_PHASES];
};

struct Im2colMaps {
  CUtensorMap a[MAX_PHASES];  // the activation, one im2col map a phase
};

__device__ __forceinline__ int phase_of(const Im2colWalk& iw, int t) {
  int p = 0;
#pragma unroll
  for (int q = 1; q < MAX_PHASES; ++q)
    if (q < iw.nphases && t >= iw.tile0[q]) p = q;
  return p;
}

// The scatter store of a staged tile: the warpgroup's rows r0 .. r0 + 63
// of phase P, in the staging tile as `staging_put` lays them out, copied in
// 16-byte chunks (8 threads a row) to dx row (img, row0 + step i, col0 +
// step j); rows past the phase and columns past Nout are not written.
template <int BN>
__device__ __forceinline__ void scatter_rows(uint32_t mine,
                                             const Im2colWalk& iw,
                                             const Phase& P, int r0, int n0,
                                             int nout, int wg) {
  named_sync(1 + wg, 128);
  const int lt = threadIdx.x % 128;
  for (int r = lt / 8; r < 64; r += 16) {
    const int q = r0 + r;
    if (q >= P.m) break;
    const int img = q / P.hw, rem = q - img * P.hw;
    const int i = rem / P.w, j = rem - i * P.w;
    const long long pix =
        ((long long)img * iw.out_h + P.row0 + iw.out_step * i) * iw.out_w +
        P.col0 + iw.out_step * j;
    __nv_bfloat16* dst = iw.out + pix * nout;
    for (int c = lt % 8; c < BN / 8; c += 8) {
      const int col = n0 + 8 * c;
      if (col >= nout) break;
      const uint32_t at = mine + r * 128 + (c / 8) * 8192 +
                          (((c % 8) ^ (r % 8)) << 4);
      uint4 v;
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(at));
      *reinterpret_cast<uint4*>(dst + col) = v;
    }
  }
}

// C = the conv's output as (M, Nout) rows (or, with iw.scatter, dx's rows
// at their strided positions): A = the activation through im2col maps, B =
// w_eff^T (Nout, taps * C) for the forward, w_eff as (taps, Nout, C) for
// the input gradient (DGRAD). The ring, the consumers and the TMA store are
// gemm_tn_bf16_kernel's. With EPI_FUSED_DX (K5: the stride-1 dgrad's one
// phase, stored as y is), gemm_tn_bf16_kernel's epilogue too: at stride 1
// dx's 128-row tile is 128 consecutive pixels, so x's tile beside it is
// the 2-D box of x as (M, Cin) at the tile's rows (tma_x), whichever rows
// and images the tile wraps.
template <int BN, bool DGRAD, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
conv_im2col_kernel(const __grid_constant__ Im2colMaps maps,
                   const __grid_constant__ CUtensorMap tma_b,
                   const __grid_constant__ CUtensorMap tma_c,
                   const __grid_constant__ CUtensorMap tma_x, int Nout,
                   int stages, const __grid_constant__ Im2colWalk iw,
                   FusedDx fd) {
  constexpr int STAGE = stage_bytes(BN);
  constexpr bool kDx = EPI == EPI_FUSED_DX;
  static_assert(!kDx || DGRAD, "K5's epilogue follows the input gradient");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t staging = ring + stages * STAGE;
  const uint32_t xbuf = staging + CONSUMERS * BN * 128;  // K5: x's tile
  const uint32_t bars = xbuf + (kDx ? CONSUMERS * BN * 128 : 0);
  const uint32_t xfull = bars + 16 * stages, xempty = xfull + 8;  // K5
  const Ring pipe{bars, stages};

  if (threadIdx.x == 0) {
    pipe.init(CONSUMERS);
    if (kDx) {
      mbar_init(xfull, 1);
      mbar_init(xempty, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    if (threadIdx.x != CONSUMERS * 128) return;
    RingPos pos;
    uint32_t xphase = 0;
    for (int t = blockIdx.x; t < iw.tiles; t += gridDim.x) {
      const int p = phase_of(iw, t);
      const Phase& P = iw.ph[p];
      const int local = t - iw.tile0[p];
      const int m0 = (local % P.tiles_m) * BM, n0 = (local / P.tiles_m) * BN;
      // the tile's first output pixel and its base coordinate in the map
      const int img = m0 / P.hw, rem = m0 - img * P.hw;
      const int i0 = rem / P.w, j0 = rem - i0 * P.w;
      const int w0 = P.lower_w + j0 * iw.step, h0 = P.lower_h + i0 * iw.step;
      const int KT = P.ntaps * iw.cblocks;
      for (int kt = 0; kt < KT; ++kt) {
        const int j = kt / iw.cblocks, c0 = (kt - j * iw.cblocks) * BK;
        const int tap = P.taps[j] & 255;
        const uint16_t ow = (P.taps[j] >> 8) & 255, oh = P.taps[j] >> 16;
        const uint32_t full = pipe.acquire(pos, STAGE);
        const uint32_t a = ring + pos.s * STAGE, b = a + A_TILE;
        tma_load_im2col_4d(a, &maps.a[p], c0, w0, h0, img, ow, oh, full);
        if constexpr (DGRAD)
          tma_load_3d(b, &tma_b, c0, n0, tap, full);
        else
          tma_load_2d(b, &tma_b, tap * iw.cblocks * BK + c0, n0, full);
        pos.advance(stages);
        if (kDx && kt == min(stages, KT - 1))  // K5: x's tile
          load_x_tile<BN>(xbuf, &tma_x, xfull, xempty, xphase, n0, m0);
      }
    }
    return;
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const bool leader = threadIdx.x % 128 == 0;
  RingPos pos;
  uint32_t xphase = 0;
  for (int t = blockIdx.x; t < iw.tiles; t += gridDim.x) {
    const int p = phase_of(iw, t);
    const Phase& P = iw.ph[p];
    const int local = t - iw.tile0[p];
    const int m0 = (local % P.tiles_m) * BM, n0 = (local / P.tiles_m) * BN;
    const int KT = P.ntaps * iw.cblocks;
    int prev = 0;
    for (int kt = 0; kt < KT; ++kt) {
      pipe.wait(pos);
      const uint32_t a = ring + pos.s * STAGE + wg * 64 * BK * 2;
      const uint64_t da = smem_desc(a);
      const uint64_t db = smem_desc(ring + pos.s * STAGE + A_TILE);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_bf16<BN>(acc, da + 2 * kk, db + 2 * kk, (kt | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > 0 && leader) pipe.release(prev);
      prev = pos.s;
      pos.advance(stages);
    }
    wgmma_wait<0>();
    if (KT > 0 && leader) pipe.release(prev);
    const uint32_t mine = staging + wg * BN * 128;
    if constexpr (kDx) {
      fused_dx_epilogue<BN>(acc, xbuf, xfull, xempty, xphase, mine, &tma_c,
                            fd, local % P.tiles_m, n0, m0, wg);
    } else {
      // the accumulators are read on one path only (a branch around them
      // serialises every wgmma); a phase no tap reaches stores zeros
      const bool live = KT > 0;
      staging_wait(wg);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        staging_put(mine, j, live ? acc[4 * j] : 0.f,
                    live ? acc[4 * j + 1] : 0.f, live ? acc[4 * j + 2] : 0.f,
                    live ? acc[4 * j + 3] : 0.f);
      if (iw.scatter)
        scatter_rows<BN>(mine, iw, P, m0 + 64 * wg, n0, Nout, wg);
      else
        staging_store<BN>(mine, &tma_c, n0, m0 + 64 * wg, wg);
    }
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// mx and fd are read only with EPI_FUSED_DX
template <int BN, bool DGRAD, int EPI>
int launch_conv_im2col(const Im2colMaps& ma, const CUtensorMap& mb,
                       const CUtensorMap& mc, const CUtensorMap& mx, int nout,
                       int stages, int grid, const Im2colWalk& iw,
                       const FusedDx& fd, cudaStream_t stream) {
  const int smem = gemm_smem_bytes(BN, stages, EPI);
  cudaError_t err = cpg::allow_smem(
      (const void*)conv_im2col_kernel<BN, DGRAD, EPI>, smem);
  if (err != cudaSuccess) return (int)err;
  conv_im2col_kernel<BN, DGRAD, EPI><<<grid, THREADS, smem, stream>>>(
      ma, mb, mc, mx, nout, stages, iw, fd);
  return (int)cudaGetLastError();
}

// The walk of `conv_im2col_kernel` and the activation's im2col maps from
// ops/masked_matmul.py `im2col_plan`'s phase table: nphases rows of
// PHASE_INTS ints {rows, columns, lower_w, lower_h, row0, col0, ntaps,
// taps[9]}, each tap id | offset_w << 8 | offset_h << 16. a is the
// activation (n, ah, aw, ch); the output grid is (oh, ow) with nout
// channels in tiles of bn; the forward walks one phase at traversal
// `stride`, the input gradient (dgrad) stride^2 phases at traversal 1,
// stored to out's strided rows when there are several. Returns false on a
// table or map the kernel does not take.
constexpr int PHASE_INTS = 7 + MAX_TAPS;

inline bool make_im2col_walk(Im2colWalk* iw, Im2colMaps* ma, const void* a,
                             int n, int ah, int aw, int ch, int oh, int ow,
                             int nout, int taps, int stride, int dgrad,
                             const int* phases, int nphases, int bn,
                             void* out) {
  if (n <= 0 || ch <= 0 || ch % BK || nout <= 0 || nout % 8 || taps <= 0 ||
      taps > MAX_TAPS || stride < 1 || stride > 2 || nphases < 1 ||
      nphases > MAX_PHASES || (dgrad && nphases != stride * stride) ||
      (!dgrad && nphases != 1) || bn <= 0)
    return false;
  const int tstep = dgrad ? 1 : stride;  // the traversal stride over a
  *iw = Im2colWalk{};
  *ma = Im2colMaps{};
  iw->nphases = nphases;
  iw->cblocks = ch / BK;
  iw->step = tstep;
  iw->scatter = nphases > 1;
  const int tiles_n = (nout + bn - 1) / bn;
  iw->out_h = oh;
  iw->out_w = ow;
  iw->out_step = stride;
  iw->out = (__nv_bfloat16*)out;
  const long long adims[4] = {ch, aw, ah, n};
  for (int p = 0; p < nphases; ++p) {
    const int* r = phases + p * PHASE_INTS;
    Phase& P = iw->ph[p];
    P.hw = r[0] * r[1];
    P.w = r[1];
    P.m = n * P.hw;
    P.tiles_m = (P.m + BM - 1) / BM;
    P.lower_w = r[2];
    P.lower_h = r[3];
    P.row0 = r[4];
    P.col0 = r[5];
    P.ntaps = r[6];
    if (r[0] < 0 || r[1] < 0 || P.ntaps < 0 || P.ntaps > taps) return false;
    for (int j = 0; j < P.ntaps; ++j) {
      const int t = r[7 + j], id = t & 255;
      if (id >= taps || ((t >> 8) & 255) > 15 || (t >> 16) > 15) return false;
      P.taps[j] = t;
    }
    iw->tile0[p] = iw->tiles;
    iw->tiles += P.tiles_m * tiles_n;
    if (P.m == 0 || P.ntaps == 0) continue;  // no load reads its map
    // the bounding box holds exactly the phase's columns and rows: the
    // last base coordinate is lower + (extent - 1) * tstep
    const int lower[2] = {P.lower_w, P.lower_h};
    const int upper[2] = {P.lower_w + (r[1] - 1) * tstep - (aw - 1),
                          P.lower_h + (r[0] - 1) * tstep - (ah - 1)};
    for (int i = 0; i < 2; ++i)
      if (lower[i] < -128 || lower[i] > 127 || upper[i] < -128 ||
          upper[i] > 127)
        return false;
    if (!make_im2col_map(&ma->a[p], a, adims, lower, upper, tstep, BM))
      return false;
  }
  return true;
}

// a (rows, cols) row-major bf16 matrix, in boxes of box_rows x BK
inline bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                     int box_rows) {
  const long long dims[2] = {cols, rows};
  const int box[2] = {BK, box_rows};
  return make_map_nd(map, ptr, 2, dims, box);
}

template <int BN, int WALK, int EPI>
int launch_gemm(const CUtensorMap& ma, const CUtensorMap& mb,
                const CUtensorMap& mc, const CUtensorMap& mx, int m, int r,
                int nout, int stages, int grid, const ConvWalk& cw,
                const FusedDx& fd, cudaStream_t stream) {
  const int smem = gemm_smem_bytes(BN, stages, EPI);
  // per call: the attribute belongs to the current device
  cudaError_t err = cpg::allow_smem(
      (const void*)gemm_tn_bf16_kernel<BN, WALK, EPI>, smem);
  if (err != cudaSuccess) return (int)err;
  gemm_tn_bf16_kernel<BN, WALK, EPI><<<grid, THREADS, smem, stream>>>(
      ma, mb, mc, mx, m, r, nout, stages, cw, fd);
  return (int)cudaGetLastError();
}

inline bool bad_plan(int bn, int stages, int grid, int epi = EPI_STORE) {
  return stages < 2 || grid <= 0 || gemm_smem_bytes(bn, stages, epi) > SMEM_LIMIT;
}

}  // namespace gemm
}  // namespace cpg
