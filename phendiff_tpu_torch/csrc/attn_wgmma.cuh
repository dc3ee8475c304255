// Hopper building blocks of the D = 64 (and D = 72 forward) bf16 attention kernels
// (flash_attn_fwd.cu, flash_attn_bwd.cu): warpgroup products (wgmma), tiles
// fed by the Tensor Memory Accelerator (TMA) through an mbarrier ring, and
// the host side that encodes the tensor maps.
//
// Tiles.  Every shared-memory operand is a [rows, 64] bf16 tile of 128-byte
// rows that TMA wrote with the 128-byte swizzle (16-byte chunk c of row r at
// chunk c ^ (r % 8)); a stage starts on a 1024-byte boundary, so the
// swizzle pattern repeats every 8 rows from the tile's start.  A wgmma reads
// such a tile as its B operand in one of two ways:
//   * K-major (the 64 columns are the contraction: q k^T, g v^T, k q^T,
//     v g^T): a k16 step is 32 bytes into each row, so the descriptor's start
//     moves by 32 bytes a step;
//   * MN-major (the rows are the contraction: p v, ds k, p^T g, ds^T q): the
//     tile read transposed by the descriptor's transpose bit, a k16 step is
//     16 rows, 2048 bytes.
// In both, 8-row groups lie 1024 bytes apart (the stride byte offset); the
// leading byte offset is unused at 64 columns (one swizzle atom wide).
//
// D = 72 (DiT-XL/2's heads, forward only).  A 144-byte row is no swizzle
// atom, so a k or v tile is two: columns 0..63 as above, and a tail tile of
// columns 64..79 with the 32-byte swizzle (chunk c of row r at c ^ ((r / 4)
// % 2), 8-row groups 256 bytes apart), which TMA reads from a map whose
// inner extent is 72, so columns 72..79 arrive as zeros: Q K^T pads its
// contraction to 80 in shared memory, never in device memory.  Q K^T is the
// four k16 steps over the main tile and one over the tail (K-major); P V is
// m64n64 over the main tile and m64n16 over the tail (MN-major, a k16 step
// 512 bytes), whose columns 72..79 are zeros and are not written.
//
// Registers.  A is always in registers: q * scale, g, k, v loaded once a
// block (phd::load_a, the mma.sync A layout, which is wgmma's per warp of
// the warpgroup: warp w holds rows 16w .. 16w + 15), and p, ds rounded
// from the accumulators.  The f32 accumulator of m64nNk16 has, per warp and
// per 8 columns, mma.sync's layout (attn_mma.cuh): c[4i], c[4i + 1] on row
// g, columns 8i + 2t, 8i + 2t + 1; c[4i + 2], c[4i + 3] on row g + 8.  So
// the quad-shuffle softmax carries over, and the accumulators of 16
// columns, rounded to bf16x2, are the A operand of the next k16 step.

#pragma once

#include <cuda.h>

#include "attn_mma.cuh"

namespace phd {

// The attention kernels' designs, as ops/flash_attention.py::DESIGN_CODES
// numbers them: the caller chooses, the C entries refuse a design that does
// not fit the head dim.  kFma runs on f32 tensors, the others on bf16.
enum AttnDesign : int { kFma = 0, kMmaSync = 1, kWgmma = 2 };

namespace wg {

constexpr int THREADS = 384;  // a producer warpgroup and two consumer warpgroups
constexpr int ROWS = 128;     // q (or key) rows a block owns: 64 a consumer warpgroup

// ---- mbarriers and TMA -------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "PHD_WG_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@p bra PHD_WG_DONE;\n\t"
      "bra PHD_WG_WAIT;\n\t"
      "PHD_WG_DONE:\n\t}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Box (64, 1, rows, 1) of a (D, H, S, B) map at (0, h, s0, b): rows s0 ..
// of one (batch, head); rows >= S arrive as zeros.
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int h, int s0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(h), "r"(s0), "r"(b), "r"(bar)
      : "memory");
}

// Box of a (D, H, S, B) map at (x0, h, s0, b): a column block of rows s0 ..
// of one (batch, head); columns past the map's D and rows past S arrive as
// zeros.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                        int x0, int h, int s0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x0), "r"(h), "r"(s0), "r"(b), "r"(bar)
      : "memory");
}

// Box of a flat f32 map at element x0.
__device__ __forceinline__ void tma_flat(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int x0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2}], [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x0), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// The producer warpgroup gives registers up, the consumers take them:
// 24 x 128 + 240 x 256 = 64,512 of the SM's 65,536 (the launch's 168 a
// thread x 384).
__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
}

// ---- the ring ------------------------------------------------------------------
//
// STAGES stages, each two [N, 64] bf16 tiles at ring + 2 st N 128 bytes (and,
// with row maps, two rows of N f32 at rows + 2 st N 4), its full mbarrier at
// bars + 8 st and its empty one at bars + 8 (STAGES + st).  The producer's
// thread arrives on full[st] expecting the stage's bytes; each consumer
// thread (two warpgroups) arrives on empty[st] once done with the stage.

template <int STAGES>
__device__ __forceinline__ void init_ring(uint32_t bars) {
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (STAGES + st), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer thread's loop: tile `it` (rows it N .. of one batch and
// head, from maps m0 and m1, and with r0 the flat rows flat0 + it N of r0
// and r1) into stage it % STAGES once the consumers released the tile
// it - STAGES.  TAIL (D = 72): the bytes of each tail tile, read from maps
// t0m and t1m at column 64 after the two main tiles.
template <int N, int STAGES, int TAIL = 0>
__device__ __forceinline__ void produce(uint32_t ring, uint32_t rows, uint32_t bars,
                                        int ntiles, const CUtensorMap* m0,
                                        const CUtensorMap* m1, const CUtensorMap* r0,
                                        const CUtensorMap* r1, int h, int b, int flat0,
                                        const CUtensorMap* t0m = nullptr,
                                        const CUtensorMap* t1m = nullptr) {
  constexpr uint32_t TILE = N * 128, ROW = N * 4, STAGE = 2 * TILE + 2 * TAIL;
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % STAGES;
    if (it >= STAGES) mbar_wait(bars + 8 * (STAGES + st), ((it / STAGES) & 1) ^ 1);
    const uint32_t full = bars + 8 * st, t0 = ring + st * STAGE;
    mbar_expect_tx(full, STAGE + (r0 ? 2 * ROW : 0));
    tma_rows(t0, m0, full, h, it * N, b);
    tma_rows(t0 + TILE, m1, full, h, it * N, b);
    if constexpr (TAIL > 0) {
      tma_box(t0 + 2 * TILE, t0m, full, 64, h, it * N, b);
      tma_box(t0 + 2 * TILE + TAIL, t1m, full, 64, h, it * N, b);
    }
    if (r0) {
      const uint32_t rw = rows + 2 * st * ROW;
      tma_flat(rw, r0, full, flat0 + it * N);
      tma_flat(rw + ROW, r1, full, flat0 + it * N);
    }
  }
}

// ---- ping-pong between the two consumer warpgroups (the backward kernels) ------
//
// The consumer warpgroups (w = 0, 1) take turns issuing their products:
// w waits on named barrier 1 + w, issues, then arrives on the other's.  So
// while one runs its softmax on the CUDA cores and the special-function
// unit, the tensor cores run the other's products (FlashAttention-3's
// ping-pong schedule).  Warpgroup 1 arrives once at the start, so warpgroup
// 0 goes first; each has the same number of turns, so the last arrival
// (warpgroup 1's) is never waited on.

__device__ __forceinline__ void turn_wait(int w) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + w) : "memory");
}

__device__ __forceinline__ void turn_pass(int w) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - w) : "memory");
}

// ---- wgmma -------------------------------------------------------------------

// Descriptor of a swizzled [rows, 64] bf16 tile at shared address `addr`
// (see the header): start >> 4, leading and stride byte offsets 1024 >> 4,
// 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (64ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kstep) {
  return desc(tile + 32u * kstep);
}

__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kstep) {
  return desc(tile + 2048u * kstep);
}

// Descriptor of a [rows, 16] bf16 tail tile with the 32-byte swizzle: 8-row
// groups 256 bytes apart (both byte offsets, the one a layout one atom wide
// leaves unread included).  K-major it is one k16 step; MN-major a k16
// step is 16 rows, 512 bytes.
__device__ __forceinline__ uint64_t desc32(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (16ull << 16) | (16ull << 32) |
         (3ull << 62);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products (the wgmma's operands are only the asm's).
template <int N>
__device__ __forceinline__ void pin(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void zero(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// d (64 x 64, f32) = a (64 x 16, bf16 registers) * B (16 x 64 from `b`)
// + (acc ? d : 0); TB = 1 reads B transposed (MN-major).
template <int TB>
__device__ __forceinline__ void mma_n64(float* d, const uint32_t* a, uint64_t b, int acc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %38, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TB), "r"(acc));
}

// d (64 x 16, f32) = a (64 x 16, bf16 registers) * B (16 x 16 from `b`)
// + (acc ? d : 0); TB = 1 reads B transposed (MN-major).
template <int TB>
__device__ __forceinline__ void mma_n16(float* d, const uint32_t* a, uint64_t b, int acc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %14, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %13;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TB), "r"(acc));
}

// d (64 x 128, f32) = a (64 x 16, bf16 registers) * B (16 x 128 from `b`)
// + (acc ? d : 0).
template <int TB>
__device__ __forceinline__ void mma_n128(float* d, const uint32_t* a, uint64_t b, int acc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %70, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %69;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TB), "r"(acc));
}

// d (64 x N) = A (64 x 64 in registers: 4 k16 steps of 4) * tile^T, the
// tile [N, 64] K-major: scores and their transposes (d's old values are
// not read).
template <int N>
__device__ __forceinline__ void mma_abt(float* d, const uint32_t* a, uint32_t tile) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (N == 128)
      mma_n128<0>(d, a + 4 * k, desc_kmajor(tile, k), k > 0);
    else
      mma_n64<0>(d, a + 4 * k, desc_kmajor(tile, k), k > 0);
  }
}

// d (64 x N) += a (64 x 16: the fifth k16 step of q * scale) * tail^T, the
// tail tile [N, 16] K-major: Q K^T's columns 64..79 at D = 72.
template <int N>
__device__ __forceinline__ void mma_abt_tail(float* d, const uint32_t* a, uint32_t tail) {
  static_assert(N == 128, "the D = 72 forward reads 128-key tiles");
  mma_n128<0>(d, a, desc32(tail), 1);
}

// d (64 x 16) += P (64 x R in registers) * tail, the tail tile [R, 16] read
// transposed: P V's columns 64..79 at D = 72.
template <int R>
__device__ __forceinline__ void mma_pb_tail(float* d, const uint32_t* p, uint32_t tail) {
#pragma unroll
  for (int k = 0; k < R / 16; ++k) mma_n16<1>(d, p + 4 * k, desc32(tail + 512u * k), 1);
}

// d (64 x 64) += P (64 x R in registers: R / 16 k16 steps of 4) * tile, the
// tile [R, 64] read transposed: p v, ds k, p^T g, ds^T q.
template <int R>
__device__ __forceinline__ void mma_pb(float* d, const uint32_t* p, uint32_t tile) {
#pragma unroll
  for (int k = 0; k < R / 16; ++k) mma_n64<1>(d, p + 4 * k, desc_mnmajor(tile, k), 1);
}

// The A operand of R accumulator columns (c[0 .. R/2 - 1]), rounded to bf16.
template <int R>
__device__ __forceinline__ void to_a(uint32_t* a, const float* c) {
#pragma unroll
  for (int i = 0; i < R / 4; ++i) a[i] = pack_bf16(c[2 * i], c[2 * i + 1]);
}

// Maximum of r[0 .. N - 1], a tree written out at compile time (a loop
// over its levels was not unrolled and put the values in local memory).
template <int N>
__device__ __forceinline__ float tree_max(float* r) {
  if constexpr (N == 1) {
    return r[0];
  } else if constexpr (N % 2 == 1) {
    return fmaxf(tree_max<N - 1>(r), r[N - 1]);
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) r[i] = fmaxf(r[i], r[i + N / 2]);
    return tree_max<N / 2>(r);
  }
}

// The row max over a thread's R / 8 column pairs of row g (hi = 0) or
// g + 8 (hi = 1) of an accumulator of R columns, then over the quad.
template <int R>
__device__ __forceinline__ float row_max(const float* c, int hi) {
  float r[R / 8];
#pragma unroll
  for (int i = 0; i < R / 8; ++i) r[i] = fmaxf(c[4 * i + 2 * hi], c[4 * i + 2 * hi + 1]);
  return quad_max(tree_max<R / 8>(r));
}

}  // namespace wg

// ---- host: tensor maps -------------------------------------------------------

namespace wgh {

constexpr int kErrEncode = -1000;  // minus the CUresult of a refused tensor map

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime.
inline int encoder(EncodeTiledFn* out) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (q != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  *out = encode;
  return 0;
}

// A bf16 [B, S, H, 64] tensor addressed by (batch, seq, head) strides in
// elements, as a 4-D map (64, H, S, B) read in boxes of `rows` rows of one
// (batch, head), 128-byte swizzle, zeros past S.  The q/k/v column slices
// of the fused qkv projection are read in place.  With `tail` (D = 72) the
// map is (72, H, S, B) read in boxes of 16 columns, 32-byte swizzle, so a
// box at column 64 holds columns 64..71 and zeros.  Returns 0, a CUDA
// error, or kErrEncode - CUresult.
inline int encode_bshd(CUtensorMap* map, const void* base, int B, int S, int H,
                       long long sb, long long ss, long long sh, int rows, bool tail = false) {
  EncodeTiledFn encode;
  const int e = encoder(&encode);
  if (e != 0) return e;
  const cuuint64_t dims[4] = {tail ? 72u : 64u, static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {tail ? 16u : 64u, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            tail ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode - static_cast<int>(r);
}

// A flat f32 array of n elements read in boxes of `len`.
inline int encode_flat(CUtensorMap* map, const float* base, long long n, int len) {
  EncodeTiledFn encode;
  const int e = encoder(&encode);
  if (e != 0) return e;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n) * 4};  // rank 1: not read
  const cuuint32_t box[1] = {static_cast<cuuint32_t>(len)};
  const cuuint32_t estr[1] = {1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(base),
                            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode - static_cast<int>(r);
}

// Once per device and kernel: allow `bytes` of dynamic shared memory.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, unsigned long long* ready) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (*ready & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *ready |= bit;
  return e;
}

}  // namespace wgh
}  // namespace phd
