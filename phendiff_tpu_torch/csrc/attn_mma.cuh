// Building blocks of the attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): tensor-core products with mma.sync, fragment loads
// with ldmatrix, asynchronous global-to-shared copies, and the f32 helpers
// of the CUDA-core kernels.
//
// Tensor-core layout.  One warp owns 16 rows (queries, or keys in the dk/dv
// kernel).  Lane l holds, of every 16 x 8 f32 accumulator tile, rows
// g = l / 4 and g + 8 and columns 2t, 2t + 1 (t = l % 4): c[0], c[1] on row
// g, c[2], c[3] on row g + 8.  An A operand (16 rows x 16 deep, bf16) is
// four bf16x2 registers: (row g, depth 2t..), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..); at depth 8 only the first two.  Two accumulator tiles
// side by side, rounded to bf16x2, are thus exactly the A operand of the
// next product over those 16 columns (FlashAttention-2's register reuse):
// probabilities never go through shared memory.
//
// Shared-memory tiles hold R rows of D bf16 (D / 8 chunks of 16 bytes per
// row).  At D = 64 the chunk index is XORed with the row (mod 8), so the
// eight row addresses of one ldmatrix fall in eight different bank groups;
// at D = 8 a row is one chunk and eight consecutive rows already do.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace phd {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int MMA_WARPS = 4;                // warps per block of a tensor-core kernel
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_ROWS = 16 * MMA_WARPS;    // rows (queries or keys) per block
// Least resident blocks per SM, the second argument of the tensor-core
// kernels' __launch_bounds__.  At D = 64 their operands and accumulators
// take 200-255 registers a thread; left to itself ptxas caps them at 168
// for a third resident block and spills, so D = 64 asks for one block and
// gets up to 255 registers.  At D = 8 (under 80 registers) 0 leaves the
// choice to ptxas: a stated bound there made it trade occupancy for
// registers, or spill, and measured no faster.
template <int D>
constexpr int MMA_MIN_BLOCKS = D == 8 ? 0 : 1;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- f32 helpers of the CUDA-core kernels --------------------------------

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float* f) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// ---- bf16 pairs ------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// x rounded to bf16 and back: q * scale as the plain version computes it.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---- tensor-core products --------------------------------------------------

// c += a (16 x 16) * b (16 x 8), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_k16(float* c, const uint32_t* a, uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16 x 8) * b (8 x 8): the whole depth at D = 8, nothing padded.
__device__ __forceinline__ void mma_k8(float* c, const uint32_t* a, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// ---- shared memory ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a tile of CH chunks per row.
template <int CH>
__device__ __forceinline__ uint32_t chunk_off(int r, int c) {
  return static_cast<uint32_t>(r * CH + (c ^ (r & (CH - 1)))) * 16u;
}

// Four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

// 16 bytes global -> shared, asynchronously; zeros where !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// 4 bytes global -> shared, asynchronously; zero where !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// ---- fragments ---------------------------------------------------------------

// A-operand registers (D / 4 of them) of the 16 rows r_g, r_g + 8 of a
// [rows, D] bf16 matrix with row stride `ss`, lane column t; rows >= S are
// zero.  With scale_t > 0 each value is multiplied by it and rounded to
// bf16 (q * scale in the input dtype).
template <int D>
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* base, long long ss,
                                       int r_g, int S, int t, float scale_t = 0.f) {
#pragma unroll
  for (int j = 0; j < D / 4; ++j) {
    const int r = j & 3;
    const int row = r_g + ((r & 1) ? 8 : 0);
    const int col = 16 * (j >> 2) + (r >> 1) * 8 + 2 * t;
    uint32_t x = 0u;
    if (row < S) {
      x = *reinterpret_cast<const uint32_t*>(base + row * ss + col);
      if (scale_t > 0.f) {
        const float2 f = unpack_bf16(x);
        x = pack_bf16(f.x * scale_t, f.y * scale_t);
      }
    }
    a[j] = x;
  }
}

// c[n] += A * B^T for 32 columns (4 tiles of 8): A the warp's 16 rows in
// registers (load_a), B rows r0 .. r0 + 31 of a shared [rows, D] tile at
// `tile`.  Scores q k^T, dp = g v^T and their transposes.
template <int D>
__device__ __forceinline__ void mma_abt32(float (*c)[4], const uint32_t* a, uint32_t tile,
                                          int r0, int lane) {
  constexpr int CH = D / 8;
  static_assert(D == 8 || D % 32 == 0, "D must be 8 or a multiple of 32");
  if constexpr (D == 8) {
    uint32_t b[4];
    ldsm_x4(b, tile + chunk_off<CH>(r0 + lane, 0));
#pragma unroll
    for (int n = 0; n < 4; ++n) mma_k8(c[n], a, b[n]);
  } else {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int c4 = 0; c4 < CH / 4; ++c4) {
        uint32_t b[4];
        ldsm_x4(b, tile + chunk_off<CH>(r0 + 8 * n + (lane & 7), 4 * c4 + (lane >> 3)));
        mma_k16(c[n], a + 8 * c4, b[0], b[1]);
        mma_k16(c[n], a + 8 * c4 + 4, b[2], b[3]);
      }
    }
  }
}

// acc[nt] += P * B over 32 rows of B: P the warp's 16 x 32 operand as two
// A operands (pa[0]: columns 0..15, pa[1]: 16..31), B rows r0 .. r0 + 31 of
// a shared [rows, D] tile, read transposed.  Outputs p v, ds k, p^T g,
// ds^T q.
template <int D>
__device__ __forceinline__ void mma_pb32(float (*acc)[4], uint32_t (*pa)[4],
                                         uint32_t tile, int r0, int lane) {
  constexpr int CH = D / 8;
  if constexpr (D == 8) {
    uint32_t b[4];
    ldsm_x4_t(b, tile + chunk_off<CH>(r0 + lane, 0));
    mma_k16(acc[0], pa[0], b[0], b[1]);
    mma_k16(acc[0], pa[1], b[2], b[3]);
  } else {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int np = 0; np < CH / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, tile + chunk_off<CH>(r0 + 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                                          2 * np + (lane >> 4)));
        mma_k16(acc[2 * np], pa[kk], b[0], b[1]);
        mma_k16(acc[2 * np + 1], pa[kk], b[2], b[3]);
      }
    }
  }
}

// The two A operands of 32 columns of accumulator tiles c[0..3], rounded.
__device__ __forceinline__ void to_a32(uint32_t (*pa)[4], float (*c)[4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    pa[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    pa[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    pa[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// Asynchronous load of rows r0 .. r0 + R - 1 of a [S, D] bf16 matrix (row
// stride ss) into a shared tile; rows >= S are zeros.  Each thread copies
// the chunks i = threadIdx.x + k * MMA_THREADS.
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t tile, const __nv_bfloat16* base,
                                          long long ss, int r0, int S) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int i = threadIdx.x; i < R * CH; i += MMA_THREADS) {
    const int r = i / CH, c = i % CH;
    const bool valid = r0 + r < S;
    cp_async16(tile + chunk_off<CH>(r, c), base + (valid ? r0 + r : 0) * ss + 8 * c, valid);
  }
}

// Sum over the four lanes of a quad (the lanes holding one row).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

}  // namespace phd
