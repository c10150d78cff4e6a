// The persistent TMA + wgmma TN GEMM of the port's Hopper kernels, with
// its producer walks and its epilogues (csrc/masked_matmul.cu describes the
// design). Two sources instantiate it: masked_matmul.cu (the dense and conv
// K1/K2 products, EPI_STORE) and fused_chain_bwd_dx.cu (K5, EPI_FUSED_DX:
// the CONV_DGRAD walk over g and the seam's weight, whose epilogue applies
// the ReLU mask of a*x + b, writes dx = dm * a and the tile's column sums
// of dm * x and dm). `stage_store` is also K4's epilogue
// (fused_chain_fwd.cu).
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
// tm. x's 128 x BN tile is at xbuf in the staging's layout. Named barrier 3
// spans both warpgroups.
template <int BN>
__device__ __forceinline__ void fused_dx_epilogue(
    const float (&acc)[BN / 2], uint32_t xbuf, uint32_t mine,
    const CUtensorMap* map, const FusedDx& fd, int tm, int n0, int m0,
    int wg) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const uint32_t xmine = xbuf + wg * BN * 128;
  float sums[BN / 8][4];  // da (c, c + 1), db (c, c + 1)
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
    // K5 loads x's tile once the ring holds this tile's first stages: by
    // then the consumers are past the previous tile's epilogue, so the
    // wait for x's buffer does not stall the ring
    const int xk = min(stages, KT - 1);
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
        if (kDx && kt == xk) {
          mbar_wait(xempty, xphase ^ 1);
          mbar_expect_tx(xfull, CONSUMERS * BN * 128);
          for (int h = 0; h < CONSUMERS; ++h)
            for (int q = 0; q < BN / 64; ++q)
              tma_load_2d(xbuf + h * BN * 128 + q * 8192, &tma_x,
                          n0 + 64 * q, m0 + 64 * h, xfull);
          xphase ^= 1;
        }
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
      mbar_wait(xfull, xphase);
      xphase ^= 1;
      fused_dx_epilogue<BN>(acc, xbuf, mine, &tma_c, fd, t % tiles_m, n0, m0,
                            wg);
      if (threadIdx.x == 0) mbar_arrive(xempty);
    } else {
      stage_store<BN>(acc, mine, &tma_c, n0, m0 + 64 * wg, wg);
    }
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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
