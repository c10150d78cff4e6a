// Flash attention backward (K7 backward): dQ, then dK and dV.
//
// Replaces, off the one-launch kernel's route (ops/flash.py `bwd_route`:
// f32, head dims 16 and 128, T > 256; csrc/flash_bwd_wgmma.cu takes bf16
// at hd 32 and 64 up to T = 256): cpg_tpu/ops/flash.py `_flash_nhtd` ->
// the stock Pallas TPU kernel's backward, `_flash_attention_bwd_dq` and
// `_flash_attention_bwd_dkv` (jax.experimental.pallas.ops.tpu.
// flash_attention), reached through its custom VJP.
//
//   p_ij  = exp(s_ij - lse_i)      recomputed from q, k and the forward's lse
//   D_i   = sum_d dO_id o_id       (the stock kernel's `di`, f32)
//   dv_j  = sum_i p_ij dO_i
//   ds_ij = p_ij (dO_i . v_j - D_i) / sqrt(hd)
//   dq_i  = sum_j ds_ij k_j,   dk_j = sum_i ds_ij q_i
//
// with the forward's masks (keys >= T; j > i when causal). Two kernels, no
// float atomics, so two runs give the same bits:
//   * flash_bwd_dq: one block per (64-query tile, head, image), looping over
//     the 64-key tiles (a causal block stops at its diagonal tile). It
//     first computes D for its queries and writes it out for the second
//     kernel;
//   * flash_bwd_dkv: one block per (64-key tile, head, image), looping over
//     the query tiles (a causal block starts at its diagonal tile); it
//     holds dK and dV for its keys in registers for the whole loop.
// The TPU grid carried dK/dV and dQ in VMEM across its sequential steps;
// here each block owns its output rows, so no reduction crosses blocks.
// Rounding points follow the stock kernel (flash_attention.py, the bwd
// kernels' bodies): scores, p, dp and ds in f32, p and ds rounded to dO's
// dtype before each product, f32 sums, the gradients cast last.
//
// What bounds it on the H100: 10*T*T*hd FLOPs (five products) against
// reading q, k, v, o, dO and writing dq, dk, dv (18*T*hd bytes in bf16) per
// (image, head): 0.56*T FLOPs a byte, 36 at T = 64 and 109 at T = 196,
// under the card's ~295, so bytes bound the least time; the kernels read
// each K/V (or Q/dO) tile once per 64 rows and recompute P instead of
// storing it. Not yet done (later work): double buffering and wgmma.
#include "flash.cuh"

using namespace cpg;
using namespace cpg::flash;

namespace {

template <int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ o,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse, bf16* __restrict__ dq,
                         float* __restrict__ dsum, Dims s, int causal) {
  constexpr int LD = ld_bf16<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + BR * LD;
  bf16* Ks = dOs + BR * LD;
  bf16* Vs = Ks + BR * LD;
  float* Ls = reinterpret_cast<float*>(Vs + BR * LD);  // lse * log2(e)
  float* Ds = Ls + BR;

  const int qt = blockIdx.x, hi = blockIdx.y, ni = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const long long rs = s.row_stride(), base = s.base(ni, hi);
  const long long lb = s.lbase(ni, hi);
  const int q0 = qt * BR;
  const int w0 = warp * 16 + g;                 // rows in the tile
  const int r0 = q0 + w0, r1 = r0 + 8;
  const float scale = rsqrtf((float)HD);

  load_tile<HD>(Qs, q + base, rs, q0, s.t);
  load_tile<HD>(dOs, dout + base, rs, q0, s.t);
  cp_async_wait_all();
  __syncthreads();
  if (tid < BR) {
    const int r = q0 + tid;
    float d = 0.f, l = 0.f;
    if (r < s.t) {
      const bf16* orow = o + base + r * rs;
      for (int c = 0; c < HD; ++c)
        d = fmaf(__bfloat162float(dOs[tid * LD + c]), __bfloat162float(orow[c]), d);
      dsum[lb + r] = d;
      l = lse[lb + r] * LOG2E;
    }
    Ds[tid] = d;
    Ls[tid] = l;
  }

  float acc[HD / 8][4];
  zero(acc);
  int n_kt = (s.t + BR - 1) / BR;
  if (causal) n_kt = min(n_kt, qt + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<HD>(Ks, k + base, rs, kt * BR, s.t);
    load_tile<HD>(Vs, v + base, rs, kt * BR, s.t);
    cp_async_wait_all();
    __syncthreads();

    float p[8][4], dp[8][4];
    zero(p);
    zero(dp);
    mma_abt<HD / 16, 8>(p, Qs + warp * 16 * LD, Ks, LD, lane);
    mma_abt<HD / 16, 8>(dp, dOs + warp * 16 * LD, Vs, LD, lane);
    const float l0 = Ls[w0], l1 = Ls[w0 + 8], d0 = Ds[w0], d1 = Ds[w0 + 8];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = kt * BR + nt * 8 + 2 * t4 + e;
        const bool out = j >= s.t;
        const float p0 = (out || (causal && j > r0))
                             ? 0.f : exp2f(p[nt][e] * scale * LOG2E - l0);
        const float p1 = (out || (causal && j > r1))
                             ? 0.f : exp2f(p[nt][2 + e] * scale * LOG2E - l1);
        p[nt][e] = p0 * (dp[nt][e] - d0) * scale;          // ds
        p[nt][2 + e] = p1 * (dp[nt][2 + e] - d1) * scale;
      }
    mma_pb<HD / 8>(acc, p, Ks, LD, lane);
  }

#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) {
    const int col = dn * 8 + 2 * t4;
    if (r0 < s.t)
      *reinterpret_cast<__nv_bfloat162*>(dq + base + r0 * rs + col) =
          __floats2bfloat162_rn(acc[dn][0], acc[dn][1]);
    if (r1 < s.t)
      *reinterpret_cast<__nv_bfloat162*>(dq + base + r1 * rs + col) =
          __floats2bfloat162_rn(acc[dn][2], acc[dn][3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, Dims s, int causal) {
  constexpr int LD = ld_bf16<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BR * LD;
  bf16* Qs = Vs + BR * LD;
  bf16* dOs = Qs + BR * LD;
  float* Ls = reinterpret_cast<float*>(dOs + BR * LD);  // lse * log2(e)
  float* Ds = Ls + BR;

  const int kt = blockIdx.x, hi = blockIdx.y, ni = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const long long rs = s.row_stride(), base = s.base(ni, hi);
  const long long lb = s.lbase(ni, hi);
  const int k0 = kt * BR;
  const int j0 = k0 + warp * 16 + g, j1 = j0 + 8;  // this thread's keys
  const float scale = rsqrtf((float)HD);

  load_tile<HD>(Ks, k + base, rs, k0, s.t);
  load_tile<HD>(Vs, v + base, rs, k0, s.t);

  float dka[HD / 8][4], dva[HD / 8][4];
  zero(dka);
  zero(dva);
  const int n_qt = (s.t + BR - 1) / BR;
  for (int qt = causal ? kt : 0; qt < n_qt; ++qt) {
    __syncthreads();
    load_tile<HD>(Qs, q + base, rs, qt * BR, s.t);
    load_tile<HD>(dOs, dout + base, rs, qt * BR, s.t);
    if (tid < BR) {
      const int r = qt * BR + tid;
      Ls[tid] = r < s.t ? lse[lb + r] * LOG2E : 0.f;
      Ds[tid] = r < s.t ? dsum[lb + r] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();

    float p[8][4];  // P^T: 16 keys x 64 queries
    zero(p);
    mma_abt<HD / 16, 8>(p, Ks + warp * 16 * LD, Qs, LD, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * 8 + 2 * t4 + e, i = qt * BR + c;
        const bool out = i >= s.t;
        const float li = Ls[c];
        p[nt][e] = (out || (causal && j0 > i))
                       ? 0.f : exp2f(p[nt][e] * scale * LOG2E - li);
        p[nt][2 + e] = (out || (causal && j1 > i))
                           ? 0.f : exp2f(p[nt][2 + e] * scale * LOG2E - li);
      }
    mma_pb<HD / 8>(dva, p, dOs, LD, lane);  // dV += P^T dO

    float dp[8][4];  // dP^T = V dO^T
    zero(dp);
    mma_abt<HD / 16, 8>(dp, Vs + warp * 16 * LD, dOs, LD, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float di = Ds[nt * 8 + 2 * t4 + e];
        p[nt][e] = p[nt][e] * (dp[nt][e] - di) * scale;    // dS^T
        p[nt][2 + e] = p[nt][2 + e] * (dp[nt][2 + e] - di) * scale;
      }
    mma_pb<HD / 8>(dka, p, Qs, LD, lane);   // dK += dS^T Q
  }

#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) {
    const int col = dn * 8 + 2 * t4;
    if (j0 < s.t) {
      *reinterpret_cast<__nv_bfloat162*>(dk + base + j0 * rs + col) =
          __floats2bfloat162_rn(dka[dn][0], dka[dn][1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + j0 * rs + col) =
          __floats2bfloat162_rn(dva[dn][0], dva[dn][1]);
    }
    if (j1 < s.t) {
      *reinterpret_cast<__nv_bfloat162*>(dk + base + j1 * rs + col) =
          __floats2bfloat162_rn(dka[dn][2], dka[dn][3]);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + j1 * rs + col) =
          __floats2bfloat162_rn(dva[dn][2], dva[dn][3]);
    }
  }
}

// ----------------------------------------------------------------- f32 ----
// One row a thread (64 a block), the other side in 32-row tiles, exact f32
// FMA; the thread's own row lives in shared memory [64][HD + 1].

template <int HD>
__global__ void __launch_bounds__(BR)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ o,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse, float* __restrict__ dq,
                        float* __restrict__ dsum, Dims s, int causal) {
  constexpr int LDR = HD + 1;
  extern __shared__ float smem_f[];
  float* Qs = smem_f;            // [64][HD + 1]
  float* dOs = Qs + BR * LDR;    // [64][HD + 1]
  float* Ks = dOs + BR * LDR;    // [32][HD]
  float* Vs = Ks + BR32 * HD;    // [32][HD]
  const int qt = blockIdx.x, hi = blockIdx.y, ni = blockIdx.z;
  const int tid = threadIdx.x, row = qt * BR + tid;
  const long long rs = s.row_stride(), base = s.base(ni, hi);
  const long long lb = s.lbase(ni, hi);
  const float scale = rsqrtf((float)HD);

  load_rows_f32(Qs, LDR, q + base, rs, qt * BR, BR, s.t, HD, BR);
  load_rows_f32(dOs, LDR, dout + base, rs, qt * BR, BR, s.t, HD, BR);
  __syncthreads();
  float d = 0.f, l = 0.f;
  if (row < s.t) {
    const float* orow = o + base + row * rs;
    for (int c = 0; c < HD; ++c) d = fmaf(dOs[tid * LDR + c], orow[c], d);
    dsum[lb + row] = d;
    l = lse[lb + row];
  }
  float acc[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) acc[c] = 0.f;
  const int k_end = causal ? min(s.t, qt * BR + BR) : s.t;
  for (int k0 = 0; k0 < k_end; k0 += BR32) {
    __syncthreads();
    load_rows_f32(Ks, HD, k + base, rs, k0, BR32, s.t, HD, BR);
    load_rows_f32(Vs, HD, v + base, rs, k0, BR32, s.t, HD, BR);
    __syncthreads();
    for (int jj = 0; jj < BR32; ++jj) {
      const int j = k0 + jj;
      if (j >= s.t || (causal && j > row)) continue;
      float sc = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < HD; ++c) {
        sc = fmaf(Qs[tid * LDR + c], Ks[jj * HD + c], sc);
        dp = fmaf(dOs[tid * LDR + c], Vs[jj * HD + c], dp);
      }
      const float ds = expf(sc * scale - l) * (dp - d) * scale;
#pragma unroll
      for (int c = 0; c < HD; ++c) acc[c] = fmaf(ds, Ks[jj * HD + c], acc[c]);
    }
  }
  if (row < s.t) {
#pragma unroll
    for (int c = 0; c < HD; ++c) dq[base + row * rs + c] = acc[c];
  }
}

template <int HD>
__global__ void __launch_bounds__(BR)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum, float* __restrict__ dk,
                         float* __restrict__ dv, Dims s, int causal) {
  constexpr int LDR = HD + 1;
  extern __shared__ float smem_f[];
  float* Ks = smem_f;            // [64][HD + 1]
  float* Vs = Ks + BR * LDR;     // [64][HD + 1]
  float* Qs = Vs + BR * LDR;     // [32][HD]
  float* dOs = Qs + BR32 * HD;   // [32][HD]
  float* Ls = dOs + BR32 * HD;   // [32]
  float* Ds = Ls + BR32;         // [32]
  const int kt = blockIdx.x, hi = blockIdx.y, ni = blockIdx.z;
  const int tid = threadIdx.x, key = kt * BR + tid;
  const long long rs = s.row_stride(), base = s.base(ni, hi);
  const long long lb = s.lbase(ni, hi);
  const float scale = rsqrtf((float)HD);

  load_rows_f32(Ks, LDR, k + base, rs, kt * BR, BR, s.t, HD, BR);
  load_rows_f32(Vs, LDR, v + base, rs, kt * BR, BR, s.t, HD, BR);
  float dka[HD], dva[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) dka[c] = dva[c] = 0.f;
  for (int i0 = causal ? kt * BR : 0; i0 < s.t; i0 += BR32) {
    __syncthreads();
    load_rows_f32(Qs, HD, q + base, rs, i0, BR32, s.t, HD, BR);
    load_rows_f32(dOs, HD, dout + base, rs, i0, BR32, s.t, HD, BR);
    if (tid < BR32) {
      const int r = i0 + tid;
      Ls[tid] = r < s.t ? lse[lb + r] : 0.f;
      Ds[tid] = r < s.t ? dsum[lb + r] : 0.f;
    }
    __syncthreads();
    for (int ii = 0; ii < BR32; ++ii) {
      const int i = i0 + ii;
      if (i >= s.t || (causal && key > i)) continue;
      float sc = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < HD; ++c) {
        sc = fmaf(Ks[tid * LDR + c], Qs[ii * HD + c], sc);
        dp = fmaf(Vs[tid * LDR + c], dOs[ii * HD + c], dp);
      }
      const float p = expf(sc * scale - Ls[ii]);
      const float ds = p * (dp - Ds[ii]) * scale;
#pragma unroll
      for (int c = 0; c < HD; ++c) {
        dva[c] = fmaf(p, dOs[ii * HD + c], dva[c]);
        dka[c] = fmaf(ds, Qs[ii * HD + c], dka[c]);
      }
    }
  }
  if (key < s.t) {
#pragma unroll
    for (int c = 0; c < HD; ++c) {
      dk[base + key * rs + c] = dka[c];
      dv[base + key * rs + c] = dva[c];
    }
  }
}

template <int HD>
int dq_bf16(const void* q, const void* k, const void* v, const void* o,
            const void* dout, const void* lse, void* dq, void* dsum,
            const Dims& s, int causal, void* stream) {
  const size_t smem = 4 * BR * ld_bf16<HD>() * sizeof(bf16) + 2 * BR * sizeof(float);
  return launch(flash_bwd_dq_bf16_kernel<HD>, grid_of(s), NT, smem, stream,
                (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
                (const bf16*)dout, (const float*)lse, (bf16*)dq, (float*)dsum,
                s, causal);
}

template <int HD>
int dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* dsum, void* dk, void* dv,
             const Dims& s, int causal, void* stream) {
  const size_t smem = 4 * BR * ld_bf16<HD>() * sizeof(bf16) + 2 * BR * sizeof(float);
  return launch(flash_bwd_dkv_bf16_kernel<HD>, grid_of(s), NT, smem, stream,
                (const bf16*)q, (const bf16*)k, (const bf16*)v,
                (const bf16*)dout, (const float*)lse, (const float*)dsum,
                (bf16*)dk, (bf16*)dv, s, causal);
}

template <int HD>
int dq_f32(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dq, void* dsum,
           const Dims& s, int causal, void* stream) {
  const size_t smem = (2 * BR * (HD + 1) + 2 * BR32 * HD) * sizeof(float);
  return launch(flash_bwd_dq_f32_kernel<HD>, grid_of(s), BR, smem, stream,
                (const float*)q, (const float*)k, (const float*)v,
                (const float*)o, (const float*)dout, (const float*)lse,
                (float*)dq, (float*)dsum, s, causal);
}

template <int HD>
int dkv_f32(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* dsum, void* dk, void* dv,
            const Dims& s, int causal, void* stream) {
  const size_t smem = (2 * BR * (HD + 1) + 2 * BR32 * HD + 2 * BR32) * sizeof(float);
  return launch(flash_bwd_dkv_f32_kernel<HD>, grid_of(s), BR, smem, stream,
                (const float*)q, (const float*)k, (const float*)v,
                (const float*)dout, (const float*)lse, (const float*)dsum,
                (float*)dk, (float*)dv, s, causal);
}

}  // namespace

extern "C" {

// q, k, v, o, dout, dq (N, T, H, hd) bf16, contiguous, 16-byte aligned; lse
// and dsum (N, H, T) f32; hd in {16, 32, 64, 128}. Writes dq and
// dsum = D = rowsum(dout * o). Returns cudaGetLastError().
int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      void* dq, void* dsum, int n, int t, int h, int hd,
                      int causal, void* stream) {
  const Dims s{n, t, h, hd};
  if (!dims_ok(s)) return (int)cudaErrorInvalidValue;
#define CALL(HD) dq_bf16<HD>(q, k, v, o, dout, lse, dq, dsum, s, causal, stream)
  switch (hd) {
    case 16: return CALL(16);
    case 32: return CALL(32);
    case 64: return CALL(64);
    case 128: return CALL(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CALL
}

// dk, dv from q, k, v, dout, lse and the dsum written by flash_bwd_dq_*.
int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dsum,
                       void* dk, void* dv, int n, int t, int h, int hd,
                       int causal, void* stream) {
  const Dims s{n, t, h, hd};
  if (!dims_ok(s)) return (int)cudaErrorInvalidValue;
#define CALL(HD) dkv_bf16<HD>(q, k, v, dout, lse, dsum, dk, dv, s, causal, stream)
  switch (hd) {
    case 16: return CALL(16);
    case 32: return CALL(32);
    case 64: return CALL(64);
    case 128: return CALL(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CALL
}

// The same two with f32 tensors.
int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const void* lse,
                     void* dq, void* dsum, int n, int t, int h, int hd,
                     int causal, void* stream) {
  const Dims s{n, t, h, hd};
  if (!dims_ok(s)) return (int)cudaErrorInvalidValue;
#define CALL(HD) dq_f32<HD>(q, k, v, o, dout, lse, dq, dsum, s, causal, stream)
  switch (hd) {
    case 16: return CALL(16);
    case 32: return CALL(32);
    case 64: return CALL(64);
    case 128: return CALL(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CALL
}

int flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dsum,
                      void* dk, void* dv, int n, int t, int h, int hd,
                      int causal, void* stream) {
  const Dims s{n, t, h, hd};
  if (!dims_ok(s)) return (int)cudaErrorInvalidValue;
#define CALL(HD) dkv_f32<HD>(q, k, v, dout, lse, dsum, dk, dv, s, causal, stream)
  switch (hd) {
    case 16: return CALL(16);
    case 32: return CALL(32);
    case 64: return CALL(64);
    case 128: return CALL(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CALL
}

}  // extern "C"
