// Flash attention forward (K7 forward).
//
// Replaces: cpg_tpu/ops/flash.py `_flash_nhtd` -> the stock Pallas TPU
// kernel jax.experimental.pallas.ops.tpu.flash_attention (forward,
// `_flash_attention_kernel_single_batch`), as `flash_mha` reaches it.
//
//   o[n,i,h,:] = sum_j softmax_j(s_ij) v[n,j,h,:],  s_ij = q_i . k_j / sqrt(hd)
//   lse[n,h,i] = log sum_j exp(s_ij)          (f32, kept for the backward)
//
// with s_ij masked for j >= T (the ragged last key tile) and, when causal,
// for j > i. The TPU wrapper transposed to (N, H, T, hd) and padded T to
// 128 with segment ids; here the (N, T, H, hd) rows are read in place and
// the kernel masks keys >= T itself.
//
// What bounds it on the H100: bytes. 4*T*T*hd FLOPs against 8*T*hd bytes
// of bf16 q, k, v and o per (image, head) is T/2 FLOPs a byte: 32 at
// vit_cifar's T = 64 and 98 at vit_b16's T = 196, both under the card's
// ~295, so the least time is reading q, k, v and writing o once, with a
// block's loads overlapped by its products (at T = 64 an item is one key
// tile, so the overlap has to come from the next item).
//
// The bf16 kernel here is persistent and pipelined:
//   * Work. A work item is one (image, query tile, head), numbered with the
//     head fastest, so the blocks in flight read one image's heads, whose
//     rows lie side by side (H*hd*2 bytes), together. A query tile is 64
//     rows (4 warps of 16) at T <= 64, and 128 rows (8 warps sharing each
//     K/V tile) above, when hd <= 64. The grid is a small multiple of the
//     SM count, cut so that every block gets the same number of items
//     (ops/flash.py `fwd_grid`); block b takes items b, b + grid, ... A job
//     is one 64-key tile of an item (causal items stop at their diagonal).
//   * Ring. Two stages of {Q, K, V} tiles, filled by cp.async one job
//     ahead, across items: the next item's loads run under this item's
//     products. K (with Q, on an item's first job) and V are separate
//     commit groups, so S = Q K^T starts when Q and K have landed while V
//     is still in flight.
//   * Registers. Q's A fragments are read once per item and kept in
//     registers; S, the online softmax (running row max and sum, f32, in
//     log2 units) and P stay in registers; P = exp(s - max) is rounded to
//     bf16 before P V, which accumulates in f32 (mma.sync m16n8k16). Only
//     the last key tile and a warp's diagonal tiles pay for the masks.
//   * Output. o = acc / sum is cast to bf16 last, as the stock kernel
//     rounds; each warp stages its 16 rows in its own rows of the Q tile
//     and stores them as 16-byte vectors (no block barrier); lse as before.
// Per query row the arithmetic is that of a plain 64-key-tile online
// softmax: the same products in the same order and the same masks (-0.7 *
// FLT_MAX). Deeper rings (3 stages), one barrier a job, 32 rows a warp and
// 128-key tiles were measured and were no faster (PERF.md): at
// vit_b16 the kernel is bound by the softmax between mma.sync chains, not
// by its loads.
#include "flash.cuh"

using namespace cpg;
using namespace cpg::flash;

namespace {

constexpr int FWD_STAGES = 2;

// A work item's query rows: 16 a warp. A job is one 64-key tile (BR).
template <int WARPS>
__host__ __device__ constexpr int q_rows() { return 16 * WARPS; }

// shared memory of the bf16 kernel: the ring of {Q, K, V} tiles (each
// warp's output rows are staged in its own rows of the Q tile)
template <int HD, int WARPS>
constexpr size_t fwd_smem_bf16() {
  return (size_t)FWD_STAGES * (q_rows<WARPS>() + 2 * BR) * ld_bf16<HD>() *
         sizeof(bf16);
}

template <int HD, int WARPS>
__global__ void __launch_bounds__(32 * WARPS, WARPS == 4 && HD <= 64 ? 3 : 2)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, Dims s, int causal) {
  constexpr int LD = ld_bf16<HD>();
  constexpr int THREADS = 32 * WARPS, QR = q_rows<WARPS>();
  constexpr int STAGE = (QR + 2 * BR) * LD;  // Q, K, V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const long long rs = s.row_stride();
  const int n_qt = (s.t + QR - 1) / QR, n_kt = (s.t + BR - 1) / BR;
  const int items = s.n * n_qt * s.h;
  const float scale = rsqrtf((float)HD) * LOG2E;  // scores in log2 units

  // item -> (image, query tile, head); its key tiles
  auto decode = [&](int item, int& ni, int& qt, int& hi) {
    hi = item % s.h;
    const int r = item / s.h;
    qt = r % n_qt;
    ni = r / n_qt;
  };
  auto key_tiles = [&](int qt) {
    return causal ? min(n_kt, (qt * QR + QR - 1) / BR + 1) : n_kt;
  };

  // the load cursor runs one job ahead of the compute cursor
  int l_item = blockIdx.x, l_kt = 0;
  auto load_job = [&](int slot) {
    bf16* st = ring + slot * STAGE;
    const bool live = l_item < items;
    int ni = 0, qt = 0, hi = 0;
    if (live) {
      decode(l_item, ni, qt, hi);
      const long long base = s.base(ni, hi);
      if (l_kt == 0) load_tile<HD, QR, THREADS>(st, q + base, rs, qt * QR, s.t);
      load_tile<HD, BR, THREADS>(st + QR * LD, k + base, rs, l_kt * BR, s.t);
    }
    cp_async_commit();
    if (live)
      load_tile<HD, BR, THREADS>(st + (QR + BR) * LD, v + s.base(ni, hi), rs,
                                 l_kt * BR, s.t);
    cp_async_commit();
    if (live && ++l_kt == key_tiles(qt)) {
      l_kt = 0;
      l_item += gridDim.x;
    }
  };

  uint32_t qf[HD / 16][4];
  float acc[HD / 8][4];
  float m0 = 0.f, m1 = 0.f, l0 = 0.f, l1 = 0.f;

#pragma unroll
  for (int i = 0; i < FWD_STAGES - 1; ++i) load_job(i);
  int job = 0;
  bf16* st = ring;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int ni, qt, hi;
    decode(item, ni, qt, hi);
    const long long base = s.base(ni, hi);
    const int w0 = qt * QR + warp * 16;  // the warp's first row
    const int r0 = w0 + g, r1 = r0 + 8;  // this thread's two rows
    const bool busy = w0 < s.t;          // a warp past T only keeps pace
    const int nk = key_tiles(qt);
    for (int kt = 0; kt < nk; ++kt, ++job) {
      st = ring + (job % FWD_STAGES) * STAGE;
      cp_async_wait<2 * FWD_STAGES - 3>();  // this job's Q and K
      __syncthreads();  // everyone's copies landed; the last job is done
      load_job((job + FWD_STAGES - 1) % FWD_STAGES);
      if (kt == 0) {
        if (busy) load_a_frags<HD / 16>(qf, st + warp * 16 * LD, LD, lane);
        zero(acc);
        m0 = m1 = -INFINITY;
        l0 = l1 = 0.f;
      }
      float sc[8][4];
      if (busy) {
        zero(sc);
        mma_abt_regs<HD / 16, 8>(sc, qf, st + QR * LD, LD, lane);
        // keys >= T or above the diagonal exist only in the last tile and
        // in the warp's diagonal tiles; elsewhere no score is masked
        if (kt * BR + BR > s.t || (causal && kt * BR + BR - 1 > w0)) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = kt * BR + nt * 8 + 2 * t4 + e;
              const bool out = j >= s.t;
              sc[nt][e] = (out || (causal && j > r0)) ? MASK : sc[nt][e] * scale;
              sc[nt][2 + e] = (out || (causal && j > r1)) ? MASK : sc[nt][2 + e] * scale;
            }
        } else {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[nt][e] *= scale;
        }
        float mx0 = MASK, mx1 = MASK;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          mx0 = fmaxf(mx0, fmaxf(sc[nt][0], sc[nt][1]));
          mx1 = fmaxf(mx1, fmaxf(sc[nt][2], sc[nt][3]));
        }
        // the four threads of a quad hold one row's 64 columns
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sc[nt][e] = exp2f(sc[nt][e] - mn0);
            sc[nt][2 + e] = exp2f(sc[nt][2 + e] - mn1);
            ls0 += sc[nt][e];
            ls1 += sc[nt][2 + e];
          }
        l0 = l0 * al0 + ls0;  // per-thread partial sums; alpha is per row
        l1 = l1 * al1 + ls1;
#pragma unroll
        for (int dn = 0; dn < HD / 8; ++dn) {
          acc[dn][0] *= al0;
          acc[dn][1] *= al0;
          acc[dn][2] *= al1;
          acc[dn][3] *= al1;
        }
      }
      cp_async_wait<2 * FWD_STAGES - 2>();  // this job's V
      __syncthreads();
      if (busy) mma_pb<HD / 8>(acc, sc, st + (QR + BR) * LD, LD, lane);
    }
    if (!busy) continue;

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    // the warp's own 16 rows of this stage's Q tile: read into registers at
    // the item's first job, and no copy in flight targets this stage
    bf16* ow = st + warp * 16 * LD;
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      const int col = dn * 8 + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(ow + g * LD + col) =
          __floats2bfloat162_rn(acc[dn][0] * inv0, acc[dn][1] * inv0);
      *reinterpret_cast<__nv_bfloat162*>(ow + (g + 8) * LD + col) =
          __floats2bfloat162_rn(acc[dn][2] * inv1, acc[dn][3] * inv1);
    }
    __syncwarp();
    constexpr int VR = HD / 8;  // 16-byte vectors a row
#pragma unroll
    for (int u = lane; u < 16 * VR; u += 32) {
      const int r = u / VR, c = (u % VR) * 8, row = w0 + r;
      if (row < s.t)
        *reinterpret_cast<uint4*>(o + base + row * rs + c) =
            *reinterpret_cast<const uint4*>(ow + r * LD + c);
    }
    if (t4 == 0) {
      const long long lb = s.lbase(ni, hi);
      if (r0 < s.t) lse[lb + r0] = m0 * LN2 + logf(l0);
      if (r1 < s.t) lse[lb + r1] = m1 * LN2 + logf(l1);
    }
  }
  cp_async_wait<0>();
}

// f32: one query row a thread (64 a block), K/V in 32-row tiles, exact
// f32 FMA; the running max is updated key by key.
template <int HD>
__global__ void __launch_bounds__(BR)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Dims s, int causal) {
  constexpr int LDQ = HD + 1;
  extern __shared__ float smem_f[];
  float* Qs = smem_f;               // [64][HD + 1]
  float* Ks = Qs + BR * LDQ;        // [32][HD]
  float* Vs = Ks + BR32 * HD;       // [32][HD]
  const int qt = blockIdx.x, hi = blockIdx.y, ni = blockIdx.z;
  const int tid = threadIdx.x, row = qt * BR + tid;
  const long long rs = s.row_stride(), base = s.base(ni, hi);
  const float scale = rsqrtf((float)HD);

  load_rows_f32(Qs, LDQ, q + base, rs, qt * BR, BR, s.t, HD, BR);
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  float m = MASK, l = 0.f;
  const int k_end = causal ? min(s.t, qt * BR + BR) : s.t;
  for (int k0 = 0; k0 < k_end; k0 += BR32) {
    __syncthreads();
    load_rows_f32(Ks, HD, k + base, rs, k0, BR32, s.t, HD, BR);
    load_rows_f32(Vs, HD, v + base, rs, k0, BR32, s.t, HD, BR);
    __syncthreads();
    for (int jj = 0; jj < BR32; ++jj) {
      const int j = k0 + jj;
      if (j >= s.t || (causal && j > row)) continue;  // masked: p == 0
      float sc = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) sc = fmaf(Qs[tid * LDQ + d], Ks[jj * HD + d], sc);
      sc *= scale;
      if (sc > m) {
        const float al = expf(m - sc);
        l *= al;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] *= al;
        m = sc;
      }
      const float p = expf(sc - m);
      l += p;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, Vs[jj * HD + d], acc[d]);
    }
  }
  if (row < s.t) {
#pragma unroll
    for (int d = 0; d < HD; ++d) o[base + row * rs + d] = acc[d] / l;
    lse[s.lbase(ni, hi) + row] = m + logf(l);
  }
}

template <int HD>
int fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse,
            const Dims& s, int causal, void* stream) {
  const size_t smem = (BR * (HD + 1) + 2 * BR32 * HD) * sizeof(float);
  return launch(flash_fwd_f32_kernel<HD>, grid_of(s), BR, smem, stream,
                (const float*)q, (const float*)k, (const float*)v, (float*)o,
                (float*)lse, s, causal);
}

template <int HD, int WARPS>
int fwd_bf16_launch(const void* q, const void* k, const void* v, void* o,
                    void* lse, const Dims& s, int causal, int grid, void* stream) {
  return launch(flash_fwd_bf16_kernel<HD, WARPS>, dim3((unsigned)grid),
                32 * WARPS, fwd_smem_bf16<HD, WARPS>(), stream, (const bf16*)q,
                (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, s,
                causal);
}

// 8 warps (128 query rows sharing each K/V tile) when T > 64 and hd <= 64,
// else 4 (ops/flash.py `fwd_warps` mirrors this)
template <int HD>
int fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
             const Dims& s, int causal, int grid, void* stream) {
  if (s.t > BR && HD <= 64)
    return fwd_bf16_launch<HD, 8>(q, k, v, o, lse, s, causal, grid, stream);
  return fwd_bf16_launch<HD, 4>(q, k, v, o, lse, s, causal, grid, stream);
}

}  // namespace

extern "C" {

// q, k, v, o (N, T, H, hd) bf16, contiguous, 16-byte aligned; lse (N, H, T)
// f32; hd in {16, 32, 64, 128}; `grid` persistent blocks (>= 1; each takes
// every grid-th work item). Returns cudaGetLastError().
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                   void* lse, int n, int t, int h, int hd, int causal,
                   int grid, void* stream) {
  const Dims s{n, t, h, hd};
  if (!dims_ok(s) || grid < 1 ||
      (long long)n * ((t + BR - 1) / BR) * h > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return fwd_bf16<16>(q, k, v, o, lse, s, causal, grid, stream);
    case 32: return fwd_bf16<32>(q, k, v, o, lse, s, causal, grid, stream);
    case 64: return fwd_bf16<64>(q, k, v, o, lse, s, causal, grid, stream);
    case 128: return fwd_bf16<128>(q, k, v, o, lse, s, causal, grid, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same with f32 tensors.
int flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                  void* lse, int n, int t, int h, int hd, int causal,
                  void* stream) {
  const Dims s{n, t, h, hd};
  if (!dims_ok(s)) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return fwd_f32<16>(q, k, v, o, lse, s, causal, stream);
    case 32: return fwd_f32<32>(q, k, v, o, lse, s, causal, stream);
    case 64: return fwd_f32<64>(q, k, v, o, lse, s, causal, stream);
    case 128: return fwd_f32<128>(q, k, v, o, lse, s, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
