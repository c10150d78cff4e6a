// Masked (CPG SharableConv2d) convolution forward at the convs whose input
// has fewer than 8 channels (K1's stem route): ResNet-50's 7x7/2 stem,
// SphereNet-20's 3x3/2 stem and VGG16-BN's conv0, all with Cin = 3.
//
// Replaces, on its route (ops/masked_conv.py `stem_route`):
// cpg_tpu/ops/pallas/masked_matmul.py `_fwd` / `_fwd_kernel` (the TPU
// forward kernel) as reached through cpg_tpu/ops/pallas/masked_conv.py
// `masked_conv2d`, which materialises the patches first; with the
// ownership/piggymask select of `_mask_tile`.
//
//   y[n,i,j,o] = sum_{dh,dw,c} x_pad[n, i*s+dh, j*s+dw, c] * w_eff[dh,dw,c,o]
//   w_eff = w where own == task; 1[pm > thr] * w (ternary: also -w where
//           pm < 0) where 0 < own < task; 0 elsewhere.
//
// What bounds it on the H100: bytes, the output's above all. With Cin = 3
// a pixel's 64 outputs cost 6 bytes of input and 128 of output: ResNet-50's
// stem at batch 32 reads 9.6 MB and writes 51.4 MB (18.2 us at 3.35 TB/s,
// its 7.6 GFLOP 7.7 us at 989 TFLOP/s); SphereNet-20's at batch 256 16.5
// and 88.1 MB; VGG16-BN's conv0 1.6 and 33.6 MB. The earlier kernel
// (masked_conv_fwd.cu) gathered x one element at a time through 32-deep
// k-steps and selected the weight in every block. The design:
//   * Persistent blocks walk tiles of 128 consecutive output pixels
//     (NHWC order), which start mid-row and may run into the next image.
//   * The halo is bulk async copies, not TMA tensor loads: the input rows
//     a tile's windows touch lie next to each other in NHWC, one span of
//     one image, plus a span of the next image's first rows for a tile
//     that runs into it. Each span is one `cp.async.bulk` on an mbarrier
//     (a row is W * Cin * 2 bytes, a multiple of 16), double-buffered: the
//     tile after next's halo is issued as soon as this tile's patches are
//     in registers. (TMA's im2col mode cannot load it: 6-byte pixels are
//     under its 16-byte channel minimum.)
//   * The patch operand never exists in device memory: each thread builds
//     its wgmma A fragments (register A, tma_wgmma.cuh `wgmma_bf16_ra`) for
//     its two output pixels straight from the halo in shared memory, k in
//     the (dh, dw, c) order of the HWIO weight and padded to a multiple of
//     16 (K = 147 -> 160, 27 -> 32) with zeros; a table of each k's offset
//     and tap replaces the divisions, and bounds checks against the image
//     give the zero padding where a thread's two pixels' windows leave the
//     image (elsewhere, most threads, every column is read unchecked and
//     the loads issue back to back).
//   * The effective weight is selected once per block, in f32, cast to
//     bf16 and kept resident: (K padded) x 64 output channels a block of
//     the weight, MN-major in the 128-byte swizzle (`smem_desc_mn`), rows
//     past K zero. No select pass and no extra launch.
//   * wgmma m64n64k16 with f32 accumulation, one warpgroup a 64-pixel half
//     of the tile; the 128 x 64 bf16 tile is staged in the 128-byte swizzle
//     and written by a 2-D TMA store, which overlaps the next tile.
// Rounding: the weight rounded once to bf16 after the f32 select, f32 sums,
// y cast to bf16 last (as the select pass + GEMM routes).
#include "tma_wgmma.cuh"

using bf16 = __nv_bfloat16;
using namespace cpg::hopper;

namespace {

constexpr int BM = 128;          // output pixels a tile
constexpr int THREADS = 256;     // two warpgroups, 64 pixels each
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_KSTEPS = 10;   // K <= 160
constexpr int MAX_COUT = 256;

struct StemArgs {
  const bf16* x;      // (N, H, W, Cin)
  const float* w;     // (kh, kw, Cin, Cout): (K, Cout) row-major
  const int8_t* own;
  const float* pm;
  int n, h, wd, cin, ho, wo, cout, kh, kw, stride, pad_top, pad_left;
  int task;
  float thr;
  int ternary;
  int halo_bytes;     // one halo buffer (ops/masked_conv.py `stem_plan`)
  int tiles;
};

__device__ __forceinline__ float select_weight(float w, int own, float pm,
                                               int task, float thr,
                                               int ternary) {
  if (own == task) return w;
  if (own > 0 && own < task) {
    if (pm > thr) return w;
    if (ternary && pm < 0.f) return -w;
  }
  return 0.f;
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The input rows a tile reads (ops/masked_conv.py `stem_spans`): rows lo_a
// .. lo_a + rows_a - 1 of image img_a, then, for a tile that runs into the
// next image, rows 0 .. rows_b - 1 of img_b (rows_b 0 otherwise).
struct Spans {
  int img_a, lo_a, rows_a, img_b, rows_b;
};

__device__ __forceinline__ Spans spans_of(const StemArgs& p, int tile) {
  const int hwo = p.ho * p.wo;
  const long long m_end = (long long)p.n * hwo;
  const long long m0 = (long long)tile * BM;
  const long long m1 = (m0 + BM < m_end ? m0 + BM : m_end) - 1;
  Spans s;
  s.img_a = (int)(m0 / hwo);
  s.img_b = (int)(m1 / hwo);
  const int r0 = (int)(m0 % hwo) / p.wo, r1 = (int)(m1 % hwo) / p.wo;
  const int last_a = s.img_b == s.img_a ? r1 : p.ho - 1;
  s.lo_a = max(0, r0 * p.stride - p.pad_top);
  s.rows_a = min(p.h - 1, last_a * p.stride - p.pad_top + p.kh - 1) -
             s.lo_a + 1;
  s.rows_b = s.img_b == s.img_a
                 ? 0
                 : min(p.h - 1, r1 * p.stride - p.pad_top + p.kh - 1) + 1;
  return s;
}

// one thread: arm the buffer's barrier and issue the tile's spans into it
__device__ __forceinline__ void load_halo(const StemArgs& p, int tile,
                                          uint32_t dst, uint32_t bar) {
  const Spans s = spans_of(p, tile);
  const long long row = (long long)p.wd * p.cin;  // elements of one row
  const uint32_t a = (uint32_t)(s.rows_a * row * 2);
  const uint32_t b = (uint32_t)(s.rows_b * row * 2);
  if ((int)(a + b) > p.halo_bytes) __trap();  // the plan is wrong
  mbar_expect_tx(bar, a + b);
  bulk_load(dst, p.x + ((long long)s.img_a * p.h + s.lo_a) * row, a, bar);
  if (b) bulk_load(dst + a, p.x + (long long)s.img_b * p.h * row, b, bar);
}

// Keep registers where they are until here: a wgmma reads its A fragments
// and writes its accumulators after its issue, up to the wait.
__device__ __forceinline__ void reg_fence(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int KSTEPS>
__device__ __forceinline__ void hold(uint32_t (&a)[KSTEPS][4]) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i])::"memory");
}

// Shared memory (`stem_smem_bytes`): 1 KB alignment slack; the weight,
// Cout / 64 blocks of KP rows x 128 B; the output staging tile, 128 rows x
// 128 B; two halo buffers; the k table (KP x 8 B); two mbarriers.
template <int KSTEPS>
__global__ void __launch_bounds__(THREADS, 2)
masked_conv_stem_kernel(const __grid_constant__ CUtensorMap tm_y,
                        StemArgs p) {
  constexpr int KP = 16 * KSTEPS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t base = smem_u32(sm);
  const int nblk = p.cout / 64;
  const uint32_t w_base = base;
  const uint32_t out_base = w_base + nblk * KP * 128;
  const uint32_t halo_base = out_base + BM * 128;
  int2* tab = reinterpret_cast<int2*>(sm + (halo_base - base) +
                                      2 * p.halo_bytes);
  const uint32_t bars = smem_u32(tab + KP);
  const int tid = threadIdx.x;
  const int K = p.kh * p.kw * p.cin;

  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // k -> (offset in a halo row block, tap): x = (dh * W + dw) * Cin + c
  // elements from the window's corner; .y = dh | dw << 16, -1 past K
  for (int k = tid; k < KP; k += THREADS) {
    int2 e = make_int2(0, -1);
    if (k < K) {
      const int tap = k / p.cin, c = k % p.cin;
      const int dh = tap / p.kw, dw = tap % p.kw;
      e = make_int2((dh * p.wd + dw) * p.cin + c, dh | (dw << 16));
    }
    tab[k] = e;
  }
  // the effective weight, selected once: bf16, row k of block j holds
  // output channels 64 j .. 64 j + 63, chunk q (8 channels) of row k at
  // chunk q ^ (k % 8)
  const int chunks = p.cout / 8;
  for (int i = tid; i < KP * chunks; i += THREADS) {
    const int k = i / chunks, o = (i % chunks) * 8;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (k < K) {  // 16-byte loads of w and pm, 4-byte loads of own
      const long long e = (long long)k * p.cout + o;
      const float4* w4 = reinterpret_cast<const float4*>(p.w + e);
      const float4* pm4 = reinterpret_cast<const float4*>(p.pm + e);
      const char4* own4 = reinterpret_cast<const char4*>(p.own + e);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 wv = w4[h], pv = pm4[h];
        const char4 ov = own4[h];
        const float wj[4] = {wv.x, wv.y, wv.z, wv.w};
        const float pj[4] = {pv.x, pv.y, pv.z, pv.w};
        const int oj[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          f[4 * h + j] =
              select_weight(wj[j], oj[j], pj[j], p.task, p.thr, p.ternary);
      }
    }
    const int blk = o / 64, q = (o % 64) / 8;
    st_shared_v4(w_base + (blk * KP + k) * 128 + ((q ^ (k & 7)) << 4),
                 pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                 pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
  }
  fence_proxy_async();  // the weight's generic stores, before wgmma reads
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      const int tile = blockIdx.x + i * gridDim.x;
      if (tile < p.tiles)
        load_halo(p, tile, halo_base + i * p.halo_bytes, bars + 8 * i);
    }
  }

  // the warpgroup, by a shuffle so that the compiler sees it uniform
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int c = tid % 128, lane = tid % 32;
  const int r = 16 * (c / 32) + lane / 4, t4 = lane % 4;  // fragment row
  const int hwo = p.ho * p.wo;
  const long long m_end = (long long)p.n * hwo;

  for (int i = 0, tile = blockIdx.x; tile < p.tiles;
       ++i, tile += gridDim.x) {
    const int b = i & 1;
    const Spans s = spans_of(p, tile);
    const long long m0 = (long long)tile * BM;
    // this thread's pixels, rows 64 wg + r and + 8 of the tile: the top-left
    // corner of each window (ih, iw), its element in the halo, and whether
    // the whole window lies inside the image (most pixels: no checks)
    int ih[2], iw[2], hb[2];
    bool inside[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const long long m = m0 + 64 * wg + r + 8 * h2;
      const int img = (int)(m / hwo), rem = (int)(m % hwo);
      ih[h2] = (rem / p.wo) * p.stride - p.pad_top;
      iw[h2] = (rem % p.wo) * p.stride - p.pad_left;
      const int hrow = img == s.img_a ? ih[h2] - s.lo_a : s.rows_a + ih[h2];
      hb[h2] = (hrow * p.wd + iw[h2]) * p.cin;
      if (m >= m_end) ih[h2] = -(1 << 24);  // past the last pixel: zeros
      inside[h2] = ih[h2] >= 0 && ih[h2] + p.kh <= p.h && iw[h2] >= 0 &&
                   iw[h2] + p.kw <= p.wd;
    }
    mbar_wait(bars + 8 * b, (i >> 1) & 1);
    const unsigned short* halo = reinterpret_cast<const unsigned short*>(
        sm + (halo_base - base) + b * p.halo_bytes);

    // A fragments: a[kk] = {(r, k0 .. k0+1), (r+8, k0 ..), (r, k0+8 ..),
    // (r+8, k0+8 ..)}, k0 = 16 kk + 2 t4; zero outside the image. Where
    // both pixels' windows lie inside the image every column is read
    // unchecked (past K the table points at the window's corner, a finite
    // x that the weight's zero rows cancel), with no branch in the
    // unrolled loop, so the loads issue back to back.
    uint32_t a[KSTEPS][4];
    if (inside[0] && inside[1]) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t v[2][4];  // [pixel][k0, k0+1, k0+8, k0+9]
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int x = tab[16 * kk + 2 * t4 + (q >> 1) * 8 + (q & 1)].x;
          v[0][q] = halo[hb[0] + x];
          v[1][q] = halo[hb[1] + x];
        }
        a[kk][0] = v[0][0] | (v[0][1] << 16);
        a[kk][1] = v[1][0] | (v[1][1] << 16);
        a[kk][2] = v[0][2] | (v[0][3] << 16);
        a[kk][3] = v[1][2] | (v[1][3] << 16);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t v[2][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int2 e = tab[16 * kk + 2 * t4 + (q >> 1) * 8 + (q & 1)];
          const int dh = e.y & 0xffff, dw = e.y >> 16;
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const bool ok = e.y >= 0 &&
                            (unsigned)(ih[h2] + dh) < (unsigned)p.h &&
                            (unsigned)(iw[h2] + dw) < (unsigned)p.wd;
            const uint32_t hv = halo[ok ? hb[h2] + e.x : 0];
            v[h2][q] = ok ? hv : 0u;
          }
        }
        a[kk][0] = v[0][0] | (v[0][1] << 16);
        a[kk][1] = v[1][0] | (v[1][1] << 16);
        a[kk][2] = v[0][2] | (v[0][3] << 16);
        a[kk][3] = v[1][2] | (v[1][3] << 16);
      }
    }
    fence_proxy_async();  // the halo's reads, before its async refill
    if (tid == 0) {       // the last tile's store has read the staging tile
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0 && tile + 2 * (int)gridDim.x < p.tiles)
      load_halo(p, tile + 2 * gridDim.x, halo_base + b * p.halo_bytes,
                bars + 8 * b);

    for (int blk = 0; blk < nblk; ++blk) {
      float acc[32];
      const uint32_t wb = w_base + blk * KP * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_bf16_ra<64, 1>(acc, a[kk],
                             smem_desc_mn(wb, KP * 128, 1024) + 128 * kk,
                             kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
      hold(a);
      if (blk > 0) {
        if (tid == 0)
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        __syncthreads();
      }
      // the m64n64 fragment: rows r and r + 8 (registers 4j + {0, 1} and
      // 4j + {2, 3}), columns 8j + 2 t4 + {0, 1}
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int row = 64 * wg + r + 8 * h2;
          st_shared_u32(out_base + row * 128 + ((j ^ (row & 7)) << 4) + 4 * t4,
                        pack_bf16(acc[4 * j + 2 * h2], acc[4 * j + 2 * h2 + 1]));
        }
      fence_proxy_async();
      __syncthreads();
      if (tid == 0) {  // clipped at M by TMA
        tma_store_2d(&tm_y, out_base, blk * 64, (int)m0);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__host__ __device__ constexpr int stem_smem_bytes(int kp, int cout,
                                                  int halo_bytes) {
  return 1024 + (cout / 64) * kp * 128 + BM * 128 + 2 * halo_bytes + kp * 8 +
         16;
}

template <int KSTEPS>
int launch(const CUtensorMap& map, const StemArgs& p, int grid,
           cudaStream_t st) {
  const int smem = stem_smem_bytes(16 * KSTEPS, p.cout, p.halo_bytes);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cpg::allow_smem((const void*)masked_conv_stem_kernel<KSTEPS>, smem);
  if (err != cudaSuccess) return (int)err;
  masked_conv_stem_kernel<KSTEPS><<<grid, THREADS, smem, st>>>(map, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (N,H,W,Cin) bf16, w/pm (kh,kw,Cin,Cout) f32, own int8, y (N,Ho,Wo,Cout)
// bf16; all contiguous on one device, x, y, w and pm 16-byte aligned, own
// 4-byte aligned. Cin < 8,
// kh*kw*Cin <= 160 (kp: that rounded up to 16), Cout a multiple of 64 up
// to 256, W * Cin * 2 a multiple of 16, Ho * Wo >= 128 (a tile touches at
// most two images). halo_bytes and grid from ops/masked_conv.py
// `stem_plan`. The bottom and right padding enter through Ho and Wo.
// Returns cudaGetLastError() (cudaErrorInvalidValue on what it does not
// take).
int masked_conv_stem_bf16(const void* x, const void* w, const void* own,
                          const void* pm, void* y, int n, int h, int wd,
                          int cin, int ho, int wo, int cout, int kh, int kw,
                          int stride, int pad_top, int pad_left, int task,
                          float thr, int ternary, int kp, int halo_bytes,
                          int grid, void* stream) {
  const int k = kh * kw * cin;
  const long long m = (long long)n * ho * wo;
  if (cin < 1 || cin >= 8 || k > 16 * MAX_KSTEPS || kp != (k + 15) / 16 * 16 ||
      cout % 64 || cout > MAX_COUT || (wd * cin * 2) % 16 || halo_bytes <= 0 ||
      halo_bytes % 16 || ho * wo < BM || m > 0x7fffffffLL || grid <= 0)
    return (int)cudaErrorInvalidValue;
  StemArgs p{(const bf16*)x, (const float*)w, (const int8_t*)own,
             (const float*)pm, n, h, wd, cin, ho, wo, cout, kh, kw, stride,
             pad_top, pad_left, task, thr, ternary, halo_bytes,
             (int)((m + BM - 1) / BM)};
  if (grid > p.tiles) return (int)cudaErrorInvalidValue;
  const long long dims[2] = {cout, m};
  const int box[2] = {64, BM};
  CUtensorMap map;
  if (!make_map_nd(&map, y, 2, dims, box)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kp / 16) {
    case 1: return launch<1>(map, p, grid, st);
    case 2: return launch<2>(map, p, grid, st);
    case 3: return launch<3>(map, p, grid, st);
    case 4: return launch<4>(map, p, grid, st);
    case 5: return launch<5>(map, p, grid, st);
    case 6: return launch<6>(map, p, grid, st);
    case 7: return launch<7>(map, p, grid, st);
    case 8: return launch<8>(map, p, grid, st);
    case 9: return launch<9>(map, p, grid, st);
    case 10: return launch<10>(map, p, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
