// Flash attention backward for Hopper (K7 backward; bf16, hd 64, T <= 256):
// one TMA + wgmma kernel that forms S and dP once per tile and writes dq,
// dk and dv, with dq summed in a fixed order.
//
// Replaces, on its route (ops/flash.py `bwd_route`): cpg_tpu/ops/flash.py
// `_flash_nhtd` -> the stock Pallas TPU kernel's backward
// (jax.experimental.pallas.ops.tpu.flash_attention `_flash_attention_bwd_dkv`
// and `_flash_attention_bwd_dq`, with the `di` that `_flash_attention_bwd`
// forms in XLA), reached through its custom VJP. Off the route (f32, other
// head dims, T > 256) the port keeps csrc/flash_bwd.cu's pair.
//
//   p_ij  = exp(s_ij - lse_i), s = q k^T / sqrt(hd); masked (keys >= T, and
//           j > i when causal) p = 0, as the stock kernel's -0.7 FLT_MAX
//   D_i   = sum_d dO_id o_id
//   dv_j  = sum_i bf16(p_ij) dO_i
//   ds_ij = bf16(p_ij (dO_i . v_j - D_i) / sqrt(hd))
//   dk_j  = sum_i ds_ij q_i,   dq_i = sum_j ds_ij k_j
// every sum in f32, the gradients rounded to bf16 last: the stock kernel's
// rounding points, as ops/flash.py `flash_mha_bwd_plain`.
//
// What bounds it on the H100: it must read q, k, v, o, dO (bf16) and lse
// (f32) once and write dq, dk, dv once: 8 * N*T*H*hd*2 + N*H*T*4 bytes, 20.1
// us at vit_cifar's (256, 64, 4, 64) and 46.2 us at vit_b16's (64, 196, 12,
// 64) at 3.35 TB/s; its five products, 10 * T^2 * hd FLOPs an (image, head),
// take 2.7 and 19.1 us at 989 TFLOP/s. Bytes bound it, but at vit_b16 the
// products come to 41% of the byte time, so they run on wgmma. The earlier
// pair formed S and dP twice (seven products), read every input twice,
// computed D with scalar loads in series, and ran one load -> product ->
// store chain a block with nothing in flight behind it.
//
// Design:
//   * A consumer warpgroup owns 64 keys (a "slot"): their K and V tiles in
//     shared memory, their dK and dV (64 x 64 f32 each) in registers. For
//     each 64-query tile it runs
//       1. S^T = K Q^T and dP^T = V dO^T by wgmma, both operands K-major;
//       2. P^T and dS^T in registers (masks, D, lse), rounded to bf16;
//       3. dV += P^T dO and dK += dS^T Q by wgmma with A from registers (the
//          accumulator fragment of step 1 is the A fragment) and B = dO, Q
//          MN-major (tma_wgmma.cuh `wgmma_bf16_ra`, the transpose bit);
//       4. dS^T to shared memory in the 128-byte swizzle;
//       5. the slot's dQ = dS K over its 64 keys by wgmma with A = dS^T and
//          B = K, both MN-major.
//     A block is two consumer warpgroups and a producer warp whose first
//     thread keeps TMA loads in flight: a double buffer of K/V (both
//     slots) and a ring of query tiles (Q, dO, o), on mbarriers
//     (tma_wgmma.cuh `Ring`; every wait traps after ~2^32 cycles).
//   * PAIR walk (T <= 64, vit_cifar): each warpgroup takes a whole
//     (image, head), one slot and one query tile; a block's item is two of
//     them. Each warpgroup's dQ product covers its own 64 keys and dq is
//     stored straight from the accumulator. The grid is persistent (ops/
//     flash.py `bwd_plan`), so the next item's loads fly under this one.
//   * BLOCK walk (64 < T <= 256, vit_b16): a block's item is one (image,
//     head); its keys in 128-key blocks (both slots), walked in order, each
//     over every query tile. Warpgroup 1 hands its slot's f32 dQ tile to
//     warpgroup 0 through shared memory (named barriers), which adds it to
//     its own and, with two key blocks, to the first block's tile kept in
//     shared memory: dq = (key block 0) + (slot 0 + slot 1), in that order.
//     No float atomics and no cluster: two launches give the same bits.
//     Both warpgroups run the same products: a wgmma that only one of them
//     issued made ptxas crash or serialise. A slot that starts past T
//     arrives as TMA's zeros and its scores are masked, so it adds exact
//     zeros to dQ.
//   * D = rowsum(dO o) is formed from the o and dO tiles in shared memory,
//     two threads a row with 16-byte reads, once a tile and warpgroup,
//     while the tile's first products run.
//   * q, k, v, o and dO are read in place, (N, T, H, hd), through 4-D
//     tensor maps (hd, H, T, N) with boxes (64, 1, 64, 1): 64 rows of 128 B
//     in the 128-byte swizzle; rows past T arrive as zeros.
//   * Registers: dK, dV, S^T and dP^T take 128 f32 registers a consumer
//     thread: hence two consumer warpgroups of 64 keys and one producer
//     warp (288 threads), one block an SM. ptxas gives the kernel 168
//     registers a thread (it counts whole warpgroups); both walks spill a
//     few words. (setmaxnreg, with a producer warpgroup, ran no faster.)
//   * Shared memory (`bwd_smem_bytes`): K/V 2 x 32 KB; the ring, stages x 24
//     KB (PAIR 48 KB: both warpgroups' tiles); dS^T 2 x 8 KB; dq staging 8
//     KB a warpgroup that stores dq; BLOCK: the f32 hand-over 16 KB and the
//     first key block's f32 dQ, 16 KB a query tile when T > 128; lse and D
//     3 KB. With the plan's 2 stages: PAIR 200,768 B; T <= 128 159,808 B;
//     T <= 192 208,960 B; T <= 256 225,344 B; all under 232,448 B.
//   * Stores: dq (per query tile) and dk, dv (per key block) are staged in
//     the 128-byte swizzle (dk, dv in the slot's own K and V tiles, free
//     once its products are done) and written by TMA, which clips rows past
//     T: whole 128-byte lines, and no warp waits on its stores.
#include "tma_wgmma.cuh"

using bf16 = __nv_bfloat16;
using namespace cpg::hopper;

namespace {

constexpr int HD = 64;               // head dim of the route
constexpr int TILE = 64 * 128;       // 64 rows of 128 B: one TMA box
constexpr int KV_BYTES = 4 * TILE;   // K of both slots, then V of both
constexpr int CONSUMERS = 2;
constexpr int CTHREADS = 128 * CONSUMERS;
constexpr int THREADS = CTHREADS + 32;  // + one producer warp
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_T = 256;
constexpr float SCALE = 0.125f;      // 1 / sqrt(64)
constexpr float LOG2E = 1.4426950408889634f;
// named barriers: 1 + wg a warpgroup's own; the BLOCK walk's dQ hand-over,
// DQ_FULL (warpgroup 1 arrives, 0 waits) and DQ_EMPTY (0 arrives, 1 waits)
constexpr int DQ_FULL = 3, DQ_EMPTY = 4;

__host__ __device__ constexpr int stage_bytes(bool pair) {
  return (pair ? 2 : 1) * 3 * TILE;  // Q, dO, o a slot
}

// 1 KB of slack to align to 1,024 B; K/V x 2; the ring; dS^T of each
// warpgroup; the dq staging tile of each warpgroup that stores dq (BLOCK:
// warpgroup 0); BLOCK: warpgroup 1's f32 dQ tile and the earlier key
// blocks' f32 dQ tiles (two key blocks); lse (2 x 256 f32) and D (2 x 2 x
// 64 f32); the ring's and K/V's mbarriers
__host__ __device__ constexpr int bwd_smem_bytes(bool pair, int n_kb,
                                                 int n_qt, int stages) {
  return 1024 + 2 * KV_BYTES + stages * stage_bytes(pair) + 2 * TILE +
         (pair ? 2 : 1) * TILE + (pair ? 0 : 2 * TILE) +
         (n_kb > 1 ? n_qt * 2 * TILE : 0) + 2 * MAX_T * 4 + 2 * 2 * 64 * 4 +
         16 * stages + 32;
}

struct BwdArgs {
  const float* lse;      // (N, H, T) f32
  int n, t, h, causal;
  int items, n_kb, n_qt, stages;
};

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// generic stores to shared memory before an async-proxy read (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 2^x (the MUFU's approximation; relative error ~2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Keep registers where they are until here: a wgmma reads its A fragments
// and writes its accumulators after its issue, up to the wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void hold(uint32_t (&fr)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(fr[kk][i])::"memory");
}

// One 64 x 64 accumulator (the m64n64 fragment, see below) rounded to bf16
// into a staging tile of 64 rows of 128 B in TMA's 128-byte swizzle
// (column group j of row r lands at group j ^ (r % 8)).
__device__ __forceinline__ void stage_tile(uint32_t tile, int r, int t4,
                                           const float (&a)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = r + 8 * h2;
      st_shared_u32(tile + row * 128 + ((j ^ (row & 7)) << 4) + 4 * t4,
                    pack_bf16(a[4 * j + 2 * h2], a[4 * j + 2 * h2 + 1]));
    }
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the warpgroup's earlier TMA stores have read their staging tiles
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The m64n64 accumulator fragment of consumer thread c of a warpgroup: warp
// c / 32 holds rows 16 (c / 32) + lane / 4 (registers 4j + {0, 1}) and + 8
// (4j + {2, 3}), columns 8j + 2 (lane % 4) + {0, 1}. As an A fragment of
// k-step kk (columns 16kk ..): {a0, a1, a2, a3} = registers 8kk + {0, 1},
// {2, 3}, {4, 5}, {6, 7}, packed in pairs.
template <bool PAIR>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_o,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_dq,
                       const __grid_constant__ CUtensorMap tm_dk,
                       const __grid_constant__ CUtensorMap tm_dv,
                       BwdArgs p) {
  constexpr int STAGE = stage_bytes(PAIR);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t base = smem_u32(sm);
  // the layout of `bwd_smem_bytes`, tiles 1,024-byte aligned
  const uint32_t kv_base = base;
  const uint32_t ring_base = kv_base + 2 * KV_BYTES;
  const uint32_t ds_base = ring_base + p.stages * STAGE;
  const uint32_t out_base = ds_base + 2 * TILE;
  const uint32_t xbuf_off = out_base + (PAIR ? 2 : 1) * TILE - base;
  const uint32_t part_off = xbuf_off + (PAIR ? 0 : 2 * TILE);
  const uint32_t lse_off = part_off + (p.n_kb > 1 ? p.n_qt * 2 * TILE : 0);
  const uint32_t d_off = lse_off + 2 * MAX_T * 4;
  const uint32_t bars = base + d_off + 2 * 2 * 64 * 4;
  const Ring ring{bars, p.stages};
  const Ring kv{bars + 16 * p.stages, 2};
  const int nh = p.n * p.h;

  if (threadIdx.x == 0) {
    ring.init(CONSUMERS);
    kv.init(CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, by a shuffle so that the compiler sees it uniform: no
  // wgmma may sit on a path it thinks divergent
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == CONSUMERS) {
    // producer warp: one thread issues every TMA load of the block
    if (threadIdx.x == CTHREADS) {
      // Every box is loaded: one past T (a BLOCK slot's keys) or past N (a
      // PAIR item's missing second (image, head)) lands as zeros.
      RingPos kp, qp;
      for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
        for (int kb = 0; kb < p.n_kb; ++kb) {
          int img[2], head[2], key0[2];
          for (int s = 0; s < 2; ++s) {
            const int item = PAIR ? 2 * it + s : it;
            img[s] = item / p.h;
            head[s] = item % p.h;
            key0[s] = PAIR ? 0 : kb * 128 + 64 * s;
          }
          const uint32_t full = kv.acquire(kp, KV_BYTES);
          const uint32_t buf = kv_base + kp.s * KV_BYTES;
          for (int s = 0; s < 2; ++s) {
            tma_load_4d(buf + s * TILE, &tm_k, 0, head[s], key0[s], img[s],
                        full);
            tma_load_4d(buf + (2 + s) * TILE, &tm_v, 0, head[s], key0[s],
                        img[s], full);
          }
          kp.advance(2);
          for (int qt = 0; qt < p.n_qt; ++qt) {
            const uint32_t qfull = ring.acquire(qp, STAGE);
            const uint32_t st = ring_base + qp.s * STAGE;
            for (int s = 0; s < (PAIR ? 2 : 1); ++s) {
              const uint32_t dst = st + s * 3 * TILE;
              tma_load_4d(dst, &tm_q, 0, head[s], qt * 64, img[s], qfull);
              tma_load_4d(dst + TILE, &tm_do, 0, head[s], qt * 64, img[s],
                          qfull);
              tma_load_4d(dst + 2 * TILE, &tm_o, 0, head[s], qt * 64, img[s],
                          qfull);
            }
            qp.advance(p.stages);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns slot wg
  const int c = threadIdx.x % 128, lane = threadIdx.x % 32;
  const int r = 16 * (c / 32) + lane / 4, t4 = lane % 4;  // fragment row
  const bool leader = c == 0;
  float* Ls = reinterpret_cast<float*>(sm + lse_off) + wg * MAX_T;
  float* Ds = reinterpret_cast<float*>(sm + d_off) + wg * 2 * 64;
  float4* xbuf = reinterpret_cast<float4*>(sm + xbuf_off);
  const uint32_t dsreg = ds_base + wg * TILE;      // this slot's dS^T
  const uint32_t out = out_base + (PAIR ? wg : 0) * TILE;  // dq staging
  const float sl2 = SCALE * LOG2E;
  // the BLOCK walk's tiles in this block, for the dQ hand-over
  const int my_items = (p.items - (int)blockIdx.x + (int)gridDim.x - 1) /
                       (int)gridDim.x;
  const int total_u = my_items * p.n_kb * p.n_qt;
  RingPos kp, qp;
  int u = 0;
  for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
    // PAIR: the second (image, head) of the last item may not exist; its
    // warpgroup runs the walk on zeros, and TMA clips its stores
    const int item = PAIR ? 2 * it + wg : it;
    const bool valid = item < nh;
    const int img = item / p.h, head = item % p.h;
    const long long lb = ((long long)img * p.h + head) * p.t;
    named_sync(1 + wg, 128);  // every read of the last item's lse is done
    for (int i = c; i < p.t; i += 128)
      Ls[i] = valid ? p.lse[lb + i] * LOG2E : 0.f;
    named_sync(1 + wg, 128);

    for (int kb = 0; kb < p.n_kb; ++kb) {
      kv.wait(kp);
      const uint32_t kbuf = kv_base + kp.s * KV_BYTES;
      const uint32_t kslot = kbuf + wg * TILE;
      const uint32_t vslot = kbuf + (2 + wg) * TILE;
      const int key0 = PAIR ? 0 : kb * 128 + 64 * wg;
      float dk[32], dv[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

      for (int qt = 0; qt < p.n_qt; ++qt, ++u) {
        ring.wait(qp);
        const uint32_t st = ring_base + qp.s * STAGE + (PAIR ? wg * 3 * TILE : 0);
        const uint32_t qs = st, dos = st + TILE, os = st + 2 * TILE;
        const int q0 = qt * 64;
        float* Dt = Ds + (u & 1) * 64;  // this tile's D, double-buffered

        // 1. S^T = K Q^T, dP^T = V dO^T
        float s[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16<64, 0, 0>(s, smem_desc(kslot) + 2 * kk,
                               smem_desc(qs) + 2 * kk, kk > 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16<64, 0, 0>(dp, smem_desc(vslot) + 2 * kk,
                               smem_desc(dos) + 2 * kk, kk > 0);
        wgmma_commit();

        // while they run, D of the tile's 64 queries: thread c takes row
        // c / 2, half c % 2, 16-byte reads under the swizzle
        {
          const int row = c >> 1, hf = c & 1;
          const uint4* orow =
              reinterpret_cast<const uint4*>(sm + (os - base) + row * 128);
          const uint4* drow =
              reinterpret_cast<const uint4*>(sm + (dos - base) + row * 128);
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int ch = (4 * hf + i) ^ (row & 7);
            const uint4 a = orow[ch], g = drow[ch];
            const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
            const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 af = __bfloat1622float2(a2[e]);
              const float2 gf = __bfloat1622float2(g2[e]);
              d = fmaf(gf.x, af.x, d);
              d = fmaf(gf.y, af.y, d);
            }
          }
          d += __shfl_xor_sync(0xffffffffu, d, 1);
          if (!hf) Dt[row] = d;
        }
        // the last dq store has read `out` (written in step 5)
        if (leader) bulk_wait_read();
        named_sync(1 + wg, 128);  // D is written; every thread is past the
                                  // last tile (its dS^T and D are free)
        wgmma_wait<0>();
        reg_fence(s);
        reg_fence(dp);

        // 2. P^T and dS^T (rows: keys, columns: queries); a tile wholly
        // inside T without the causal mask skips the masks
        const bool whole = !p.causal && key0 + 64 <= p.t && q0 + 64 <= p.t;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int qc = 8 * j + 2 * t4;
          const float2 l2 = *reinterpret_cast<const float2*>(Ls + q0 + qc);
          const float2 d2 = *reinterpret_cast<const float2*>(Dt + qc);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = 4 * j + 2 * h2 + e;
              float pv = ex2(s[idx] * sl2 - (e ? l2.y : l2.x));
              float dsv = pv * (dp[idx] - (e ? d2.y : d2.x)) * SCALE;
              if (!whole) {
                const int key = key0 + r + 8 * h2, qi = q0 + qc + e;
                const bool ok = key < p.t && qi < p.t &&
                                !(p.causal && key > qi);
                pv = ok ? pv : 0.f;
                dsv = ok ? dsv : 0.f;
              }
              s[idx] = pv;
              dp[idx] = dsv;
            }
        }
        uint32_t pf[4][4], df[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pf[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
            df[kk][i] = pack_bf16(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);
          }

        // 3. dV += P^T dO, dK += dS^T Q
        reg_fence(dv);
        reg_fence(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16_ra<64, 1>(dv, pf[kk], smem_desc_mn(dos, TILE, 1024) + 128 * kk, 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16_ra<64, 1>(dk, df[kk], smem_desc_mn(qs, TILE, 1024) + 128 * kk, 1);
        wgmma_commit();

        // 4. dS^T into the warpgroup's buffer: row key, 64 queries of 128 B
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int row = r + 8 * h2;
            st_shared_u32(dsreg + row * 128 + ((j ^ (row & 7)) << 4) + 4 * t4,
                          df[j >> 1][2 * (j & 1) + h2]);
          }
        fence_proxy_async();
        wgmma_wait<0>();
        hold(pf);
        hold(df);
        reg_fence(dv);
        reg_fence(dk);
        // the stage's tiles are read (D, steps 1 and 3)
        if (leader) ring.release(qp.s);
        qp.advance(p.stages);

        // 5. the slot's dQ = dS K over its 64 keys (zeros past T: dS^T, K)
        named_sync(1 + wg, 128);  // the whole dS^T is written
        float dq[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16<64, 1, 1>(dq, smem_desc_mn(dsreg, TILE, 1024) + 128 * kk,
                               smem_desc_mn(kslot, TILE, 1024) + 128 * kk,
                               kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dq);
        bool store_dq = PAIR;
        if (!PAIR && wg == 1) {
          // hand the slot's f32 dQ to warpgroup 0, in fragment order
          if (u > 0) named_sync(DQ_EMPTY, CTHREADS);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            xbuf[j * 128 + c] = make_float4(dq[4 * j], dq[4 * j + 1],
                                            dq[4 * j + 2], dq[4 * j + 3]);
          named_arrive(DQ_FULL, CTHREADS);
        } else if (!PAIR) {
          // dq = (earlier key blocks) + (slot 0 + slot 1), in that order
          float4* part = reinterpret_cast<float4*>(sm + part_off) +
                         qt * (2 * TILE / 16);
          named_sync(DQ_FULL, CTHREADS);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 x = xbuf[j * 128 + c];
            dq[4 * j] += x.x;
            dq[4 * j + 1] += x.y;
            dq[4 * j + 2] += x.z;
            dq[4 * j + 3] += x.w;
          }
          if (u + 1 < total_u) named_arrive(DQ_EMPTY, CTHREADS);
          if (kb > 0) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float4 x = part[j * 128 + c];
              dq[4 * j] = x.x + dq[4 * j];
              dq[4 * j + 1] = x.y + dq[4 * j + 1];
              dq[4 * j + 2] = x.z + dq[4 * j + 2];
              dq[4 * j + 3] = x.w + dq[4 * j + 3];
            }
          }
          store_dq = kb + 1 == p.n_kb;
          if (!store_dq) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              part[j * 128 + c] = make_float4(dq[4 * j], dq[4 * j + 1],
                                              dq[4 * j + 2], dq[4 * j + 3]);
          }
        }
        if (store_dq) {  // by TMA, clipped at T (and at N)
          stage_tile(out, r, t4, dq);
          fence_proxy_async();
          named_sync(1 + wg, 128);
          if (leader) {
            tma_store_4d(&tm_dq, out, 0, head, q0, img);
            bulk_commit();
          }
        }
      }
      // dK and dV through the slot's K and V tiles, once every product of
      // the warpgroup that reads them is done; then K and V are free
      named_sync(1 + wg, 128);
      stage_tile(kslot, r, t4, dk);
      stage_tile(vslot, r, t4, dv);
      fence_proxy_async();
      named_sync(1 + wg, 128);
      if (leader) {
        tma_store_4d(&tm_dk, kslot, 0, head, key0, img);
        tma_store_4d(&tm_dv, vslot, 0, head, key0, img);
        bulk_commit();
        bulk_wait_read();
        kv.release(kp.s);
      }
      kp.advance(2);
    }
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <bool PAIR>
int launch(const CUtensorMap (&maps)[8], const BwdArgs& p, int grid,
           cudaStream_t st) {
  const int smem = bwd_smem_bytes(PAIR, p.n_kb, p.n_qt, p.stages);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  // per call: the attribute belongs to the current device
  cudaError_t err = cpg::allow_smem(
      (const void*)flash_bwd_wgmma_kernel<PAIR>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_wgmma_kernel<PAIR><<<grid, THREADS, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7],
      p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o, dout, dq, dk, dv (N, T, H, 64) bf16, contiguous, 16-byte
// aligned; lse (N, H, T) f32; 1 <= T <= 256. stages and grid from
// ops/flash.py `bwd_plan` (the PAIR walk when T <= 64). Writes dq, dk, dv.
// Returns cudaGetLastError() (cudaErrorInvalidValue on what it does not
// take).
int flash_bwd_wgmma_bf16(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const void* lse,
                         void* dq, void* dk, void* dv, int n, int t, int h,
                         int hd, int causal, int stages, int grid,
                         void* stream) {
  if (hd != HD || n <= 0 || h <= 0 || t <= 0 || t > MAX_T || stages < 2 ||
      grid <= 0)
    return (int)cudaErrorInvalidValue;
  const bool pair = t <= 64;
  BwdArgs p{};
  p.lse = (const float*)lse;
  p.n = n;
  p.t = t;
  p.h = h;
  p.causal = causal;
  p.items = pair ? (n * h + 1) / 2 : n * h;
  p.n_kb = pair ? 1 : (t + 127) / 128;
  p.n_qt = (t + 63) / 64;
  p.stages = stages;
  if (grid > p.items) return (int)cudaErrorInvalidValue;
  const long long dims[4] = {HD, h, t, n};
  const int box[4] = {64, 1, 64, 1};
  CUtensorMap maps[8];
  const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
  for (int i = 0; i < 8; ++i)
    if (!make_map_nd(&maps[i], ptrs[i], 4, dims, box))
      return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return pair ? launch<true>(maps, p, grid, st) : launch<false>(maps, p, grid, st);
}

}  // extern "C"
