// TMA, mbarrier and wgmma helpers shared by the port's Hopper GEMMs
// (tma_gemm.cuh: the dense and conv TN GEMM of masked_matmul.cu and K5;
// masked_matmul_wgrad.cu: the weight-gradient GEMM; fused_chain_fwd.cu:
// K4; masked_conv_stem.cu: K1 at Cin < 8; flash_bwd_wgmma.cu: K7's
// backward). Device side: shared-memory addresses, mbarriers with a
// trapping wait, the producer/consumer ring of stages, TMA loads and
// stores of 2-4-D boxes (stores: 2-D and 4-D) and im2col-mode loads, named
// barriers, wgmma descriptors of 128-byte- and 64-byte-swizzled tiles
// (K-major and MN-major), the wgmma m64nNk16 bf16 instruction with both
// transpose flags and its form with A from registers. Host side:
// cuTensorMapEncodeTiled and cuTensorMapEncodeIm2col through the runtime's
// entry-point query (no -lcuda), a tiled bf16 tensor map of any rank and
// an im2col map of an NHWC tensor.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_cap.cuh"

namespace cpg {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase of this parity has completed. A wait that
// lasts past ~2^32 cycles (about two seconds) means a broken pipeline:
// trap, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1LL << 32)) __trap();
}

// The mbarrier ring of the warp-specialised GEMMs: `stages` shared-memory
// stages that one producer thread fills by TMA and the consumer
// warpgroups read. Stage s has a full barrier (the producer's arrival
// with the stage's byte count, completed by the TMA) and an empty one (one
// arrival a consumer warpgroup, from its leader, once the products that
// read the stage are done); `bars` holds the full barriers, then the
// empty ones, 8 B each. Each side walks the stages in order with a
// RingPos of its own; the producer's first pass finds every stage free.
struct RingPos {
  int s = 0;           // the stage
  uint32_t phase = 0;  // the parity of this pass over the ring
  __device__ __forceinline__ void advance(int stages) {
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
};

struct Ring {
  uint32_t full0, empty0;  // stage 0's barriers; stage s's are 8 s B on
  int stages;
  __device__ __forceinline__ Ring(uint32_t bars, int stages)
      : full0(bars), empty0(bars + 8 * stages), stages(stages) {}
  __device__ __forceinline__ uint32_t full(int s) const { return full0 + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return empty0 + 8 * s;
  }
  // one thread, before the block's mbarrier-init fence and __syncthreads
  __device__ __forceinline__ void init(int consumers) const {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), consumers);
    }
  }
  // producer: wait until stage p.s is free, arm its full barrier for
  // `bytes`, and return that barrier for the stage's TMA loads
  __device__ __forceinline__ uint32_t acquire(const RingPos& p,
                                              uint32_t bytes) const {
    mbar_wait(empty(p.s), p.phase ^ 1);
    mbar_expect_tx(full(p.s), bytes);
    return full(p.s);
  }
  // consumer: wait until stage p.s has landed
  __device__ __forceinline__ void wait(const RingPos& p) const {
    mbar_wait(full(p.s), p.phase);
  }
  // a consumer warpgroup's leader: hand stage s back to the producer
  __device__ __forceinline__ void release(int s) const { mbar_arrive(empty(s)); }
};

// 2-D TMA load of the box at (c0 innermost, c1) into shared memory; the
// barrier counts its bytes. Out-of-range elements land as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The same for 3-D and 4-D maps.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// im2col-mode TMA load of a 4-D (C, W, H, N) map made by `make_im2col_map`:
// the map's pixelsPerColumn pixels, each its channelsPerPixel channels from
// c0 on, as consecutive shared-memory rows. The pixels are the traversal of
// the map's bounding box from (w, h, n) on (W fastest, then H, then the
// image, each step the map's traversal stride), each read at (w + off_w,
// h + off_h): zeros where that leaves the tensor, and past the last image.
__device__ __forceinline__ void tma_load_im2col_4d(
    uint32_t dst, const CUtensorMap* map, int c0, int w, int h, int n,
    uint16_t off_w, uint16_t off_h, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6], {%7, %8};\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(w),
      "r"(h), "r"(n), "r"(bar), "h"(off_w), "h"(off_h)
      : "memory");
}

// 2-D TMA store of the box at (c0 innermost, c1) from shared memory;
// rows and columns past the tensor are not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%1, %2}], [%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(src)
      : "memory");
}

// The same for a 4-D map.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(src)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle: start address >> 4, leading offset unused (1), stride
// offset 1,024 B between groups of 8 rows, layout type 1 (128B swizzle).
// The tile starts on a 1,024-byte boundary; a step of 16 along K adds 32 B
// to the start address (the hardware applies the swizzle to the address).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// wgmma shared-memory descriptor of an MN-major tile in the 128-byte
// swizzle (PTX ISA, "Matrix Descriptor Format"; CUTLASS's canonical
// Swizzle<3,4,3> o ((64,n),(8,k)):((1,LBO),(64,SBO)) in elements): each
// 128-byte row holds 64 consecutive M (or N) elements at one k, 8 rows make
// a 1,024-byte swizzle atom, atoms along K are `sbo` bytes apart and atoms
// along M (or N), i.e. the next 64 elements, `lbo` bytes apart. So the
// leading and stride offsets swap roles against the K-major tile, and a
// step of 16 along K adds 16 rows = 2,048 B to the start address (the
// start stays on an atom boundary).
__device__ __forceinline__ uint64_t smem_desc_mn(uint32_t addr, uint32_t lbo,
                                                 uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

// The same two in the 64-byte swizzle (layout type 2), for tiles of 64-byte
// rows (32 bf16: a head dim of 32): K-major, 8-row groups 512 B apart, a
// step of 16 along K adds 32 B; MN-major, each 64-byte row holds 32
// consecutive M (or N) elements at one k, atoms of 8 rows (512 B) `sbo`
// apart along K and 32-element blocks `lbo` apart along M (or N), a step of
// 16 along K adds 1,024 B. Tiles start on a 512-byte boundary.
__device__ __forceinline__ uint64_t smem_desc_64b(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

__device__ __forceinline__ uint64_t smem_desc_mn_64b(uint32_t addr,
                                                     uint32_t lbo,
                                                     uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)2 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], bf16 operands from shared memory,
// f32 accumulators; scale_d == 0 overwrites D. TA / TB are wgmma's
// transpose immediates: 0 for a K-major operand, 1 for an MN-major one.
// The operand lists are written out: wgmma names every accumulator
// register.
template <int N, int TA, int TB>
struct Wgmma;

template <int TA, int TB>
struct Wgmma<32, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<64, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<128, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<192, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[96], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int N, int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  Wgmma<N, TA, TB>::run(d, da, db, scale_d);
}

// D[64 x N] (+)= A[64 x 16] B[16 x N] with A from registers: warp w of the
// warpgroup holds rows 16w .. 16w + 15 in the m16n8k16 A fragment (a[0]:
// row lane / 4, k 2 * (lane % 4) + {0, 1}; a[1]: row + 8; a[2]: k + 8;
// a[3]: both), which ldmatrix.x4 gives from any 16 row addresses, so the
// rows may be gathered (shifted taps) where a descriptor could not address
// them. B from shared memory as above; TB is its transpose immediate. The
// registers of a[] must not change until the group that reads them is
// done (wgmma_wait), and a wgmma_fence must come between writing them and
// the wgmma that reads them.
template <int N, int TB>
struct WgmmaRA;

template <int TB>
struct WgmmaRA<32, TB> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
  }
};

template <int TB>
struct WgmmaRA<64, TB> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
  }
};

template <int TB>
struct WgmmaRA<128, TB> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
  }
};

template <int N, int TB = 0>
__device__ __forceinline__ void wgmma_bf16_ra(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  WgmmaRA<N, TB>::run(d, a, db, scale_d);
}

// ------------------------------------------------------ tensor maps ----
// cuTensorMapEncodeTiled is a driver function; it is reached through the
// runtime's entry-point query, so the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline void* query_entry_point(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(name, &p, 12000,
                                                     cudaEnableDefault, &q);
#else
  cudaError_t err = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q);
#endif
  return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? p : nullptr;
}

// queried once, by whichever host thread comes first (a function-local
// static: the others wait for it)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = reinterpret_cast<EncodeTiled>(
      query_entry_point("cuTensorMapEncodeTiled"));
  return fn;
}

inline EncodeIm2col encode_im2col() {
  static const EncodeIm2col fn = reinterpret_cast<EncodeIm2col>(
      query_entry_point("cuTensorMapEncodeIm2col"));
  return fn;
}

// cuTensorMapEncodeTiled is a driver call: it fails unless a context is
// current in the calling host thread, and a serving thread can reach it
// before any runtime call has made one current there. So a host thread
// binds the current device's primary context (cudaSetDevice, then a no-op
// cudaFree that makes it current) whenever its current device is not the
// one it bound last: a thread may launch on several cards in turn.
inline bool bind_context() {
  thread_local int bound = -1;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  if (dev != bound) {
    if (cudaSetDevice(dev) != cudaSuccess || cudaFree(nullptr) != cudaSuccess)
      return false;
    bound = dev;
  }
  return true;
}

// a dense row-major bf16 tensor of `rank` dims (dims[0] innermost), in
// boxes of box[0] x box[1] x ... in the 128-byte swizzle (box[0] * 2 B <=
// 128 B), or in `swizzle` (the 64-byte one: box[0] * 2 B <= 64 B)
inline bool make_map_nd(CUtensorMap* map, const void* ptr, int rank,
                        const long long* dims, const int* box,
                        CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr || !bind_context()) return false;
  cuuint64_t d[5], strides[4];
  cuuint32_t b[5];
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  cuuint64_t stride = sizeof(__nv_bfloat16);
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims[i];
    b[i] = (cuuint32_t)box[i];
    stride *= d[i];
    if (i + 1 < rank) strides[i] = stride;
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(ptr), d, strides, b, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// an NHWC bf16 tensor, dims (C, W, H, N) innermost first, as an im2col map
// for `tma_load_im2col_4d`: `pixels` pixels of 64 channels a load, in the
// 128-byte swizzle (one 128-B row a pixel). The bounding box runs from
// `lower` to the last column or row plus `upper` ({W, H}: the encoder's
// DHW offsets, innermost first), walked at traversal `stride` in W and H.
inline bool make_im2col_map(CUtensorMap* map, const void* ptr,
                            const long long* dims, const int* lower,
                            const int* upper, int stride, int pixels) {
  EncodeIm2col fn = encode_im2col();
  if (fn == nullptr || !bind_context()) return false;
  cuuint64_t d[4], strides[3];
  cuuint64_t s = sizeof(__nv_bfloat16);
  for (int i = 0; i < 4; ++i) {
    d[i] = (cuuint64_t)dims[i];
    s *= d[i];
    if (i < 3) strides[i] = s;
  }
  const cuuint32_t elem[4] = {1, (cuuint32_t)stride, (cuuint32_t)stride, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            d, strides, lower, upper, 64, (cuuint32_t)pixels, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
}  // namespace cpg
