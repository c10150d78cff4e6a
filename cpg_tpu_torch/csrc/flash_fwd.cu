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
// for j > i. One block per (64-query tile, head, image): the query tile
// and each 64-key tile of K and V are staged in shared memory (cp.async,
// rows past T zero-filled), S = Q K^T runs on the tensor cores, the online
// softmax (running row max and sum, f32) rescales the output accumulator,
// P = exp(s - max) is rounded to bf16 in registers and P V accumulates in
// f32; o = acc / sum is cast to bf16 last, as the stock kernel rounds. A
// causal block stops at its diagonal key tile. The TPU wrapper transposed
// to (N, H, T, hd) and padded T to 128 with segment ids; here the (N, T,
// H, hd) rows are read in place and the kernel masks keys >= T itself.
//
// What bounds it on the H100: 4*T*T*hd FLOPs against 8*T*hd bytes of bf16
// q, k, v and o per (image, head) is T/2 FLOPs a byte: 32 at vit_cifar's
// T = 64 and 98 at vit_b16's T = 196, both under the card's ~295, so the
// least time is reading q, k, v and writing o. The design keeps the score
// matrix out of device memory (the default attention writes and reads it
// in f32) and reads each K/V tile once per 64 queries.
// Not yet done (later work): K/V double buffering and wgmma.
#include "flash.cuh"

using namespace cpg;
using namespace cpg::flash;

namespace {

template <int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, Dims s, int causal) {
  constexpr int LD = ld_bf16<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BR * LD;
  bf16* Vs = Ks + BR * LD;

  const int qt = blockIdx.x, hi = blockIdx.y, ni = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const long long rs = s.row_stride(), base = s.base(ni, hi);
  const int q0 = qt * BR;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two rows
  const float scale = rsqrtf((float)HD) * LOG2E;   // scores in log2 units

  load_tile<HD>(Qs, q + base, rs, q0, s.t);
  cp_async_wait_all();

  float acc[HD / 8][4];
  zero(acc);
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  int n_kt = (s.t + BR - 1) / BR;
  if (causal) n_kt = min(n_kt, qt + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // the previous tile's products are done with Ks/Vs
    load_tile<HD>(Ks, k + base, rs, kt * BR, s.t);
    load_tile<HD>(Vs, v + base, rs, kt * BR, s.t);
    cp_async_wait_all();
    __syncthreads();

    float sc[8][4];
    zero(sc);
    mma_abt<HD / 16, 8>(sc, Qs + warp * 16 * LD, Ks, LD, lane);

    float mx0 = MASK, mx1 = MASK;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = kt * BR + nt * 8 + 2 * t4 + e;
        const bool out = j >= s.t;
        sc[nt][e] = (out || (causal && j > r0)) ? MASK : sc[nt][e] * scale;
        sc[nt][2 + e] = (out || (causal && j > r1)) ? MASK : sc[nt][2 + e] * scale;
        mx0 = fmaxf(mx0, sc[nt][e]);
        mx1 = fmaxf(mx1, sc[nt][2 + e]);
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
    mma_pb<HD / 8>(acc, sc, Vs, LD, lane);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) {
    const int col = dn * 8 + 2 * t4;
    if (r0 < s.t)
      *reinterpret_cast<__nv_bfloat162*>(o + base + r0 * rs + col) =
          __floats2bfloat162_rn(acc[dn][0] * inv0, acc[dn][1] * inv0);
    if (r1 < s.t)
      *reinterpret_cast<__nv_bfloat162*>(o + base + r1 * rs + col) =
          __floats2bfloat162_rn(acc[dn][2] * inv1, acc[dn][3] * inv1);
  }
  if (t4 == 0) {
    const long long lb = s.lbase(ni, hi);
    if (r0 < s.t) lse[lb + r0] = m0 * LN2 + logf(l0);
    if (r1 < s.t) lse[lb + r1] = m1 * LN2 + logf(l1);
  }
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

template <int HD>
int fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
             const Dims& s, int causal, void* stream) {
  const size_t smem = 3 * BR * ld_bf16<HD>() * sizeof(bf16);
  return launch(flash_fwd_bf16_kernel<HD>, grid_of(s), NT, smem, stream,
                (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
                (float*)lse, s, causal);
}

}  // namespace

extern "C" {

// q, k, v, o (N, T, H, hd) bf16, contiguous, 16-byte aligned; lse (N, H, T)
// f32; hd in {16, 32, 64, 128}. Returns cudaGetLastError().
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                   void* lse, int n, int t, int h, int hd, int causal,
                   void* stream) {
  const Dims s{n, t, h, hd};
  if (!dims_ok(s)) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return fwd_bf16<16>(q, k, v, o, lse, s, causal, stream);
    case 32: return fwd_bf16<32>(q, k, v, o, lse, s, causal, stream);
    case 64: return fwd_bf16<64>(q, k, v, o, lse, s, causal, stream);
    case 128: return fwd_bf16<128>(q, k, v, o, lse, s, causal, stream);
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
