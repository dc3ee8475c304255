// Fused self-attention backward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` launched by `_flash_bwd_3d` in
// phendiff_tpu/ops/flash_attention.py (VJP rule `_flash_bwd_rule`).  For
// q, k, v, g of layout [B, S, H, D] in bf16 or f32 and
// p = softmax(q k^T * scale) in f32:
//   dp = g v^T,  ds = p * (dp - rowsum(p * dp)),
//   dq = ds k * scale,  dk = ds^T (q * scale),  dv = p^T g,
// with nothing of size [S, S] written to device memory.  D is 8 (the main
// path) or 64 (the SD path), the head dims the forward kernel takes.
//
// The TPU kernel held f32 [BQ, S] rows of p, dp and ds in VMEM (BQ = 512 at
// S = 1024) and carried dk/dv as VMEM accumulators revisited across a
// sequential q-block grid axis.  A Hopper block holds neither, and blocks
// run in no order, so the work is split into two kernels launched back to
// back, each recomputing p from the row log-sum-exp the forward saved
// (base-2 units: p = ex2(s * log2e - lse2)), each deterministic (fixed
// order, no float atomics):
//   1. dq, per q tile: S = Q K^T and dP = G V^T, ds = p * (dp - delta),
//      dQ += dS K.  It also writes the row term delta for kernel 2.
//   2. dk/dv, per key tile: S^T = K Q^T and dP^T = V G^T, so that P^T and
//      dS^T are already A operands (rows = keys); dV += P^T G and
//      dK += dS^T (Q * scale), with lse and delta read per column.
// The row term is delta = rowsum(g * o), with o the forward's output in the
// input dtype: in exact arithmetic it equals rowsum(p * dp) (the TPU
// kernel's form) and costs D products per row instead of a pass over the
// keys.  As in the TPU kernel, ds and p are rounded to the input dtype
// before the products that use them (dq, dk from ds; dv from p); every
// product accumulates in f32, and dq, dk, dv are written in the input
// dtype at the end.
//
// Bound.  Five products of 2*S*S*D flops a head and one exp a score.  At
// the main-path shape (B=32, H=32, S=1024, D=8) the exps bound it on the
// special-function unit (16 exp2 per clock per SM); at D = 64 the tensor
// cores do (10*D = 640 flops a score at 989 TFLOP/s, 0.65 ps, against 0.24
// ps an exp2).  The two-kernel design recomputes p in both kernels, so it
// does 7 products and 2 exps a score: its own floor is 1.4x the
// five-product bound at D = 64 (2x at D = 8).
//
// Three designs, chosen by the caller (ops/flash_attention.py::
// attention_design) and passed in as `design`:
//
// 1. bf16 D = 64 at S >= the route's threshold: warpgroup products
// (flash_bwd_dq_wgmma_kernel, flash_bwd_dkdv_wgmma_kernel; helpers in
// attn_wgmma.cuh).  Each is a block of three warpgroups owning 128 rows
// (q rows in kernel 1, keys in kernel 2), 64 a consumer warpgroup, whose
// operands (q * scale and g; k and v) sit in registers as wgmma's A; a
// producer warpgroup (24 registers by setmaxnreg) has one thread stream the
// other side's 64-row tiles by TMA, 128-byte swizzled, through a ring of
// WB_STAGES stages with full and empty mbarriers:
//   1. k and v tiles: S and dP are m64n64k16 over the tiles read K-major,
//      dQ += dS K reads the k tile transposed (MN-major);
//   2. q * scale and g tiles, and lse and delta rows (1-D f32 maps): S^T,
//      dP^T K-major, then dV += P^T G and dK += dS^T Q * scale transposed.
// In both, a tile's first products are issued together with the previous
// tile's last ones (dS K; dV and dK), which run under this tile's exps, and
// the two consumer warpgroups take turns issuing (attn_wgmma.cuh's
// ping-pong), which measured faster than unsynchronised warpgroups in the
// dk/dv kernel (and no slower in the dq kernel).
// TMA copies bytes, so it cannot scale q: kernel 1 writes q * scale,
// rounded to bf16 as the plain version scales q, to a [B, S, H, 64]
// scratch (qs) as it loads its rows, and kernel 2 reads that.  Rows past S
// arrive as zeros; keys past S are masked to p = 0 in kernel 1, q rows past
// S in kernel 2.  Design (a) of the two deterministic choices: two kernels
// with 7 products, each with its own fixed order.  Design (b), one kernel
// per key tile adding dq into an f32 buffer in a fixed key-tile order,
// would do 5 products but makes each block wait on blocks of lower index
// (a per-(b*h, q tile) counter), which holds only while blocks start in
// index order, something CUDA does not promise; (a) waits on nothing.
//
// 2. bf16 otherwise: mma.sync tensor cores (flash_bwd_dq_mma_kernel,
// flash_bwd_dkdv_mma_kernel).  One block of 4 warps per (b*h, 64-row tile),
// each warp owning 16 rows (queries in kernel 1, keys in kernel 2) whose
// operands stay in registers; the other side streams through shared memory
// as bf16 tiles, by cp.async, double-buffered, into ldmatrix fragments.
// The products are mma.m16n8k8 where D = 8 is the depth (q k^T, g v^T and
// their transposes) and m16n8k16 elsewhere; ds and p, rounded to bf16x2 in
// registers, are the A operands of the next product.  In kernel 2 q
// arrives unscaled; each thread multiplies the chunks it copied by scale
// (rounded to bf16, as the plain version scales q) before the block reads
// them.  At D = 64 the dk/dv accumulators are 2 x 32 f32 registers a
// thread.
//
// In both tensor-core designs the two kernels compute p with operands in
// different roles, so their p may differ in the last bit; two calls on the
// same inputs are bit-identical.
//
// 3. f32: CUDA cores (flash_bwd_dq_kernel, flash_bwd_dkdv_kernel); tensor
// cores take f32 only as TF32, which misses the f32 tolerances.  One
// thread per q row (dq) or key row (dk/dv), the other side streaming
// through shared memory; both compute a score from the same operands in the
// same order, so they see bit-identical p.

#include <type_traits>

#include "attn_wgmma.cuh"

namespace {

using phd::LOG2E;
using phd::MMA_ROWS;
using phd::MMA_THREADS;
using bf16 = __nv_bfloat16;

// ---- bf16, mma.sync tensor cores --------------------------------------------

template <int D>
constexpr int MMA_TILE = D == 8 ? 128 : 64;  // rows per streamed tile

// o, g, dq: contiguous [B, S, H, D]; lse, delta: [B*H, S] f32.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS, phd::MMA_MIN_BLOCKS<D>) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ g,
    const float* __restrict__ lse, bf16* __restrict__ dq, float* __restrict__ delta,
    int S, int H,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale) {
  constexpr int CH = D / 8, BK = MMA_TILE<D>, NT = D / 8;
  __shared__ __align__(128) uint4 kv_sh[2][2][BK * CH];  // [buffer][k, v]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const long long b = bh / H, h = bh % H;
  const int r_g = blockIdx.x * MMA_ROWS + warp * 16 + gi;  // rows r_g, r_g + 8

  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  const int ntiles = (S + BK - 1) / BK;
  phd::load_tile<D, BK>(phd::smem_u32(kv_sh[0][0]), kb, k_ss, 0, S);
  phd::load_tile<D, BK>(phd::smem_u32(kv_sh[0][1]), vb, v_ss, 0, S);
  phd::cp_async_commit();

  // q * scale and g as A operands; delta = rowsum(g * o) over the quad
  const long long rs = static_cast<long long>(H) * D;  // row stride of o, g, dq
  const long long off = b * S * rs + h * D;
  uint32_t qa[D / 4], ga[D / 4], oa[D / 4];
  phd::load_a<D>(qa, q + b * q_sb + h * q_sh, q_ss, r_g, S, t, phd::round_bf16(scale));
  phd::load_a<D>(ga, g + off, rs, r_g, S, t);
  phd::load_a<D>(oa, o + off, rs, r_g, S, t);
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int j = 0; j < D / 4; ++j) {
    const float2 gf = phd::unpack_bf16(ga[j]), of = phd::unpack_bf16(oa[j]);
    const float x = fmaf(gf.y, of.y, gf.x * of.x);
    if (j & 1) d1 += x; else d0 += x;
  }
  d0 = phd::quad_sum(d0);
  d1 = phd::quad_sum(d1);
  const long long lrow = static_cast<long long>(bh) * S;
  if (t == 0) {
    if (r_g < S) delta[lrow + r_g] = d0;
    if (r_g + 8 < S) delta[lrow + r_g + 8] = d1;
  }
  const float l0 = r_g < S ? lse[lrow + r_g] : 0.f;
  const float l1 = r_g + 8 < S ? lse[lrow + r_g + 8] : 0.f;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BK;
    if (it + 1 < ntiles) {
      const int nb = (it + 1) & 1;
      phd::load_tile<D, BK>(phd::smem_u32(kv_sh[nb][0]), kb, k_ss, k0 + BK, S);
      phd::load_tile<D, BK>(phd::smem_u32(kv_sh[nb][1]), vb, v_ss, k0 + BK, S);
      phd::cp_async_commit();
      phd::cp_async_wait<1>();
    } else {
      phd::cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t ktile = phd::smem_u32(kv_sh[it & 1][0]);
    const uint32_t vtile = phd::smem_u32(kv_sh[it & 1][1]);
    const int kn = S - k0;

#pragma unroll
    for (int j = 0; j < BK / 32; ++j) {
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      phd::mma_abt32<D>(s, qa, ktile, 32 * j, lane);
      phd::mma_abt32<D>(dp, ga, vtile, 32 * j, lane);
      if (kn < BK) {  // keys past S: p = ex2(-inf) = 0, so ds = 0
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (32 * j + 8 * n + 2 * t + (e & 1) >= kn) s[n][e] = -INFINITY;
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi = e >= 2;
          const float p = phd::ex2(fmaf(s[n][e], LOG2E, -(hi ? l1 : l0)));
          s[n][e] = p * (dp[n][e] - (hi ? d1 : d0));  // ds
        }
      uint32_t da[2][4];
      phd::to_a32(da, s);
      phd::mma_pb32<D>(acc, da, ktile, 32 * j, lane);
    }
    __syncthreads();  // the tile is consumed before its buffer is refilled
  }

  bf16* out = dq + off + 2 * t;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (r_g < S)
      *reinterpret_cast<uint32_t*>(out + r_g * rs + 8 * n) =
          phd::pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
    if (r_g + 8 < S)
      *reinterpret_cast<uint32_t*>(out + (r_g + 8) * rs + 8 * n) =
          phd::pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
  }
}

// g, dk, dv: contiguous [B, S, H, D]; lse, delta: [B*H, S] f32.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS, phd::MMA_MIN_BLOCKS<D>) flash_bwd_dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
    int S, int H,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale) {
  constexpr int CH = D / 8, BQ = MMA_TILE<D>, NT = D / 8;
  __shared__ __align__(128) uint4 qg_sh[2][2][BQ * CH];  // [buffer][q * scale, g]
  __shared__ __align__(16) float ld_sh[2][2][BQ];        // [buffer][lse, delta]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const long long b = bh / H, h = bh % H;
  const int r_g = blockIdx.x * MMA_ROWS + warp * 16 + gi;  // key rows r_g, r_g + 8
  const float scale_t = phd::round_bf16(scale);

  const long long rs = static_cast<long long>(H) * D;  // row stride of g, dk, dv
  const long long off = b * S * rs + h * D;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* gb = g + off;
  const float* lb = lse + static_cast<long long>(bh) * S;
  const float* db = delta + static_cast<long long>(bh) * S;
  // Rows past S arrive as zeros (q = g = 0, lse = delta = 0): p = 1 there,
  // but dp = 0 and g = 0, so they add nothing to dk or dv.
  auto load = [&](int q0, int buf) {
    phd::load_tile<D, BQ>(phd::smem_u32(qg_sh[buf][0]), qb, q_ss, q0, S);
    phd::load_tile<D, BQ>(phd::smem_u32(qg_sh[buf][1]), gb, rs, q0, S);
    for (int i = threadIdx.x; i < BQ; i += MMA_THREADS) {
      const bool valid = q0 + i < S;
      const int row = valid ? q0 + i : 0;
      phd::cp_async4(phd::smem_u32(&ld_sh[buf][0][i]), lb + row, valid);
      phd::cp_async4(phd::smem_u32(&ld_sh[buf][1][i]), db + row, valid);
    }
    phd::cp_async_commit();
  };
  // q * scale, rounded to bf16, in place over the chunks this thread copied
  auto scale_q = [&](int buf) {
    char* tile = reinterpret_cast<char*>(qg_sh[buf][0]);
    for (int i = threadIdx.x; i < BQ * CH; i += MMA_THREADS) {
      uint4* p = reinterpret_cast<uint4*>(tile + phd::chunk_off<CH>(i / CH, i % CH));
      uint4 x = *p;
      uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = phd::unpack_bf16(w[e]);
        w[e] = phd::pack_bf16(f.x * scale_t, f.y * scale_t);
      }
      *p = x;
    }
  };

  const int ntiles = (S + BQ - 1) / BQ;
  load(0, 0);
  uint32_t ka[D / 4], va[D / 4];
  phd::load_a<D>(ka, k + b * k_sb + h * k_sh, k_ss, r_g, S, t);
  phd::load_a<D>(va, v + b * v_sb + h * v_sh, v_ss, r_g, S, t);

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      load((it + 1) * BQ, buf ^ 1);
      phd::cp_async_wait<1>();
    } else {
      phd::cp_async_wait<0>();
    }
    scale_q(buf);
    __syncthreads();
    const uint32_t qtile = phd::smem_u32(qg_sh[buf][0]);
    const uint32_t gtile = phd::smem_u32(qg_sh[buf][1]);

#pragma unroll
    for (int j = 0; j < BQ / 32; ++j) {
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      phd::mma_abt32<D>(s, ka, qtile, 32 * j, lane);  // S^T: rows keys, columns q
      phd::mma_abt32<D>(dp, va, gtile, 32 * j, lane);
      float pt[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = 32 * j + 8 * n + 2 * t;
        const float2 lc = *reinterpret_cast<const float2*>(&ld_sh[buf][0][col]);
        const float2 dc = *reinterpret_cast<const float2*>(&ld_sh[buf][1][col]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool odd = e & 1;
          const float p = phd::ex2(fmaf(s[n][e], LOG2E, -(odd ? lc.y : lc.x)));
          pt[n][e] = p;
          s[n][e] = p * (dp[n][e] - (odd ? dc.y : dc.x));  // ds^T
        }
      }
      uint32_t pa[2][4], da[2][4];
      phd::to_a32(pa, pt);
      phd::to_a32(da, s);
      phd::mma_pb32<D>(dva, pa, gtile, 32 * j, lane);
      phd::mma_pb32<D>(dka, da, qtile, 32 * j, lane);
    }
    __syncthreads();  // the tile is consumed before its buffer is refilled
  }

#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const long long c = off + 8 * n + 2 * t;
    if (r_g < S) {
      *reinterpret_cast<uint32_t*>(dk + c + r_g * rs) = phd::pack_bf16(dka[n][0], dka[n][1]);
      *reinterpret_cast<uint32_t*>(dv + c + r_g * rs) = phd::pack_bf16(dva[n][0], dva[n][1]);
    }
    if (r_g + 8 < S) {
      *reinterpret_cast<uint32_t*>(dk + c + (r_g + 8) * rs) =
          phd::pack_bf16(dka[n][2], dka[n][3]);
      *reinterpret_cast<uint32_t*>(dv + c + (r_g + 8) * rs) =
          phd::pack_bf16(dva[n][2], dva[n][3]);
    }
  }
}

// ---- bf16, D = 64, warpgroup products ------------------------------------------

constexpr int WB_N = 64;                  // rows a stage (keys in kernel 1, q rows in kernel 2)
constexpr int WB_STAGES = 3;              // stages of the ring
constexpr int WB_TILE = WB_N * 64 * 2;    // bytes of one bf16 tile
constexpr int WB_ROW_BYTES = WB_N * 4;    // bytes of one stage's lse (or delta) row
// Kernel 1: the ring (k then v tile a stage), its 2 x WB_STAGES mbarriers,
// and room to align the ring to 1024 bytes (the 128-byte swizzle's period).
constexpr int WB_SMEM_DQ = 1024 + 2 * WB_STAGES * WB_TILE + 16 * WB_STAGES;
// Kernel 2: the ring (q * scale then g tile a stage), the stages' lse and
// delta rows, the mbarriers.
constexpr int WB_SMEM_DKDV =
    1024 + 2 * WB_STAGES * WB_TILE + 2 * WB_STAGES * WB_ROW_BYTES + 16 * WB_STAGES;

// Kernel 1: dq per 128 q rows, and for kernel 2 q * scale (qs) and the row
// terms (lse copied, delta) in rows of S4 = S rounded up to 4 (the 1-D TMA
// boxes start 16-byte aligned; rows S .. S4 - 1 are zero).
// o, g, dq, qs: contiguous [B, S, H, 64]; lse: [B*H, S] f32; terms: f32
// [2, B*H, S4].
__global__ void __launch_bounds__(phd::wg::THREADS, 1) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const bf16* __restrict__ q, const bf16* __restrict__ o, const bf16* __restrict__ g,
    const float* __restrict__ lse, bf16* __restrict__ dq, bf16* __restrict__ qs,
    float* __restrict__ terms, int S, int H, long long q_sb, long long q_ss, long long q_sh,
    float scale) {
  namespace wg = phd::wg;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ring = (phd::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = ring + 2 * WB_STAGES * WB_TILE;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int ntiles = (S + WB_N - 1) / WB_N;
  wg::init_ring<WB_STAGES>(bars);

  const int role = threadIdx.x / 128;  // 0: producer, 1 and 2: consumers
  if (role == 0) {
    wg::producer_registers();
    if (threadIdx.x == 0) {
      wg::prefetch_map(&kmap);
      wg::prefetch_map(&vmap);
      wg::produce<WB_N, WB_STAGES>(ring, 0, bars, ntiles, &kmap, &vmap, nullptr, nullptr, h, b,
                                   0);
    }
  } else {
    wg::consumer_registers();
    const int tid = threadIdx.x - 128 * role;
    const int warp = tid >> 5, lane = tid & 31;
    const int gi = lane >> 2, t = lane & 3;
    const int r_g = blockIdx.x * wg::ROWS + (role - 1) * 64 + warp * 16 + gi;  // rows r_g, r_g + 8

    // q * scale (also stored for kernel 2) and g as A operands; delta =
    // rowsum(g * o) over the quad
    const long long rs = static_cast<long long>(H) * 64;  // row stride of o, g, dq, qs
    const long long off = b * S * rs + h * 64;
    uint32_t qa[16], ga[16];
    phd::load_a<64>(qa, q + b * q_sb + h * q_sh, q_ss, r_g, S, t, phd::round_bf16(scale));
    phd::load_a<64>(ga, g + off, rs, r_g, S, t);
    float d0 = 0.f, d1 = 0.f;
    {
      uint32_t oa[16];
      phd::load_a<64>(oa, o + off, rs, r_g, S, t);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 gf = phd::unpack_bf16(ga[j]), of = phd::unpack_bf16(oa[j]);
        const float x = fmaf(gf.y, of.y, gf.x * of.x);
        if (j & 1) d1 += x; else d0 += x;
        const int row = r_g + ((j & 1) ? 8 : 0);
        const int col = 16 * (j >> 2) + ((j & 3) >> 1) * 8 + 2 * t;
        if (row < S) *reinterpret_cast<uint32_t*>(qs + off + row * rs + col) = qa[j];
      }
    }
    d0 = phd::quad_sum(d0);
    d1 = phd::quad_sum(d1);
    const long long lrow = static_cast<long long>(bh) * S;
    const float l0 = r_g < S ? lse[lrow + r_g] : 0.f;
    const float l1 = r_g + 8 < S ? lse[lrow + r_g + 8] : 0.f;
    const int S4 = (S + 3) & ~3;
    if (t == 0) {
      float* lt = terms + static_cast<long long>(bh) * S4;
      float* dt = lt + static_cast<long long>(gridDim.y) * S4;
      if (r_g < S4) lt[r_g] = l0, dt[r_g] = d0;  // rows >= S: 0 (q = g = o = 0)
      if (r_g + 8 < S4) lt[r_g + 8] = l1, dt[r_g + 8] = d1;
    }

    float acc[32];
    wg::zero<32>(acc);
    uint32_t da[16];  // the previous tile's ds, the A operand of its dS K

    const int w = role - 1;
    if (w == 1) wg::turn_pass(w);  // warpgroup 0 takes the first turn
    const bool ragged = S % WB_N != 0;

    // S and dP of tile `it`, with the previous tile's dS K queued behind
    // them (`dsk`), issued in this warpgroup's turn; then ds = p * (dp -
    // delta) into dp while dS K runs.  MASK: the tile holds keys past S
    // (only the last tile can).
    auto tile = [&](float* sc, float* dp, int it, bool dsk, auto mask) {
      const int st = it % WB_STAGES;
      const uint32_t kt = ring + 2 * st * WB_TILE;
      wg::mbar_wait(bars + 8 * st, (it / WB_STAGES) & 1);
      wg::pin<32>(sc);
      wg::pin<32>(dp);
      wg::pin<32>(acc);
      wg::turn_wait(w);
      wg::fence();
      wg::mma_abt<64>(sc, qa, kt);
      wg::mma_abt<64>(dp, ga, kt + WB_TILE);
      wg::commit();
      if (dsk) {
        const int prev = (it + WB_STAGES - 1) % WB_STAGES;
        wg::mma_pb<64>(acc, da, ring + 2 * prev * WB_TILE);
        wg::commit();
      }
      wg::turn_pass(w);
      if (dsk)
        wg::wait<1>();
      else
        wg::wait<0>();
      wg::pin<32>(sc);
      wg::pin<32>(dp);
      if constexpr (decltype(mask)::value) {
        const int kn = S - it * WB_N;  // keys past S: p = ex2(-inf) = 0, so ds = 0
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * i + 2 * t + (e & 1) >= kn) sc[4 * i + e] = -INFINITY;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool hi = i & 2;
        const float p = phd::ex2(fmaf(sc[i], LOG2E, -(hi ? l1 : l0)));
        dp[i] = p * (dp[i] - (hi ? d1 : d0));  // ds
      }
    };
    auto tile_of = [&](float* sc, float* dp, int it, bool dsk) {
      if (ragged && it == ntiles - 1)
        tile(sc, dp, it, dsk, std::true_type());
      else
        tile(sc, dp, it, dsk, std::false_type());
    };

    {
      float sc[32], dp[32];
      tile_of(sc, dp, 0, false);
      wg::to_a<64>(da, dp);
    }
    for (int it = 1; it < ntiles; ++it) {
      float sc[32], dp[32];
      tile_of(sc, dp, it, true);
      wg::wait<0>();  // the previous tile's dS K is done: its stage is free
      wg::pin<32>(acc);
      wg::mbar_arrive(bars + 8 * (WB_STAGES + (it - 1) % WB_STAGES));
      wg::to_a<64>(da, dp);
    }
    {
      const int last = (ntiles - 1) % WB_STAGES;
      wg::pin<32>(acc);
      wg::turn_wait(w);
      wg::fence();
      wg::mma_pb<64>(acc, da, ring + 2 * last * WB_TILE);
      wg::commit();
      wg::turn_pass(w);
      wg::wait<0>();
      wg::pin<32>(acc);
      wg::mbar_arrive(bars + 8 * (WB_STAGES + last));
    }

    bf16* out = dq + off + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (r_g < S)
        *reinterpret_cast<uint32_t*>(out + r_g * rs + 8 * n) =
            phd::pack_bf16(acc[4 * n] * scale, acc[4 * n + 1] * scale);
      if (r_g + 8 < S)
        *reinterpret_cast<uint32_t*>(out + (r_g + 8) * rs + 8 * n) =
            phd::pack_bf16(acc[4 * n + 2] * scale, acc[4 * n + 3] * scale);
    }
  }
}

// Kernel 2: dk and dv per 128 key rows, from qs and g tiles and the row
// terms kernel 1 wrote.  dk, dv: contiguous [B, S, H, 64].
__global__ void __launch_bounds__(phd::wg::THREADS, 1) flash_bwd_dkdv_wgmma_kernel(
    const __grid_constant__ CUtensorMap qsmap, const __grid_constant__ CUtensorMap gmap,
    const __grid_constant__ CUtensorMap lsemap, const __grid_constant__ CUtensorMap deltamap,
    const bf16* __restrict__ k, const bf16* __restrict__ v, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int S, int H, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh) {
  namespace wg = phd::wg;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ring = (phd::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t rows = ring + 2 * WB_STAGES * WB_TILE;
  const uint32_t bars = rows + 2 * WB_STAGES * WB_ROW_BYTES;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int ntiles = (S + WB_N - 1) / WB_N;
  wg::init_ring<WB_STAGES>(bars);

  const int role = threadIdx.x / 128;
  if (role == 0) {
    wg::producer_registers();
    if (threadIdx.x == 0) {
      wg::prefetch_map(&qsmap);
      wg::prefetch_map(&gmap);
      wg::produce<WB_N, WB_STAGES>(ring, rows, bars, ntiles, &qsmap, &gmap, &lsemap, &deltamap,
                                   h, b, bh * ((S + 3) & ~3));
    }
  } else {
    wg::consumer_registers();
    const int tid = threadIdx.x - 128 * role;
    const int warp = tid >> 5, lane = tid & 31;
    const int gi = lane >> 2, t = lane & 3;
    const int r_g = blockIdx.x * wg::ROWS + (role - 1) * 64 + warp * 16 + gi;  // key rows
    const float* row_sh =  // the stages' lse and delta rows
        reinterpret_cast<const float*>(smem_raw + (rows - phd::smem_u32(smem_raw)));

    uint32_t ka[16], va[16];
    phd::load_a<64>(ka, k + b * k_sb + h * k_sh, k_ss, r_g, S, t);
    phd::load_a<64>(va, v + b * v_sb + h * v_sh, v_ss, r_g, S, t);
    float dka[32], dva[32];
    wg::zero<32>(dka);
    wg::zero<32>(dva);
    uint32_t pa[16], da[16];  // the previous tile's p^T and ds^T, A operands

    const int w = role - 1;
    if (w == 1) wg::turn_pass(w);  // warpgroup 0 takes the first turn
    const bool ragged = S % WB_N != 0;

    // S^T and dP^T of tile `it`, with the previous tile's dV and dK products
    // queued behind them (`prev`), issued in this warpgroup's turn; then p^T
    // into sc and ds^T into dp while those run.  MASK: the tile holds q rows
    // past S (only the last tile can).
    auto tile = [&](float* sc, float* dp, int it, bool prev, auto mask) {
      const int st = it % WB_STAGES;
      const uint32_t qt = ring + 2 * st * WB_TILE;
      const float* lsh = row_sh + 2 * st * WB_N;  // lse, then delta
      wg::mbar_wait(bars + 8 * st, (it / WB_STAGES) & 1);
      wg::pin<32>(sc);
      wg::pin<32>(dp);
      wg::pin<32>(dka);
      wg::pin<32>(dva);
      wg::turn_wait(w);
      wg::fence();
      wg::mma_abt<64>(sc, ka, qt);  // S^T: rows keys, columns q
      wg::mma_abt<64>(dp, va, qt + WB_TILE);
      wg::commit();
      if (prev) {
        const uint32_t pt = ring + 2 * ((it + WB_STAGES - 1) % WB_STAGES) * WB_TILE;
        wg::mma_pb<64>(dva, pa, pt + WB_TILE);
        wg::mma_pb<64>(dka, da, pt);
        wg::commit();
      }
      wg::turn_pass(w);
      if (prev)
        wg::wait<1>();
      else
        wg::wait<0>();
      wg::pin<32>(sc);
      wg::pin<32>(dp);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 8 * i + 2 * t;
        const float2 lc = *reinterpret_cast<const float2*>(lsh + col);
        const float2 dc = *reinterpret_cast<const float2*>(lsh + WB_N + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool odd = e & 1;
          const float p = phd::ex2(fmaf(sc[4 * i + e], LOG2E, -(odd ? lc.y : lc.x)));
          sc[4 * i + e] = p;
          dp[4 * i + e] = p * (dp[4 * i + e] - (odd ? dc.y : dc.x));  // ds^T
          if constexpr (decltype(mask)::value) {  // q rows past S: p = ds = 0
            if (col + odd >= S - it * WB_N) sc[4 * i + e] = dp[4 * i + e] = 0.f;
          }
        }
      }
    };
    auto tile_of = [&](float* sc, float* dp, int it, bool prev) {
      if (ragged && it == ntiles - 1)
        tile(sc, dp, it, prev, std::true_type());
      else
        tile(sc, dp, it, prev, std::false_type());
    };

    {
      float sc[32], dp[32];
      tile_of(sc, dp, 0, false);
      wg::to_a<64>(pa, sc);
      wg::to_a<64>(da, dp);
    }
    for (int it = 1; it < ntiles; ++it) {
      float sc[32], dp[32];
      tile_of(sc, dp, it, true);
      wg::wait<0>();  // the previous tile's products are done: its stage is free
      wg::pin<32>(dka);
      wg::pin<32>(dva);
      wg::mbar_arrive(bars + 8 * (WB_STAGES + (it - 1) % WB_STAGES));
      wg::to_a<64>(pa, sc);
      wg::to_a<64>(da, dp);
    }
    {
      const uint32_t pt = ring + 2 * ((ntiles - 1) % WB_STAGES) * WB_TILE;
      wg::pin<32>(dka);
      wg::pin<32>(dva);
      wg::turn_wait(w);
      wg::fence();
      wg::mma_pb<64>(dva, pa, pt + WB_TILE);
      wg::mma_pb<64>(dka, da, pt);
      wg::commit();
      wg::turn_pass(w);
      wg::wait<0>();
      wg::pin<32>(dka);
      wg::pin<32>(dva);
      wg::mbar_arrive(bars + 8 * (WB_STAGES + (ntiles - 1) % WB_STAGES));
    }

    const long long rs = static_cast<long long>(H) * 64;
    const long long off = b * S * rs + h * 64;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const long long c = off + 8 * n + 2 * t;
      if (r_g < S) {
        *reinterpret_cast<uint32_t*>(dk + c + r_g * rs) = phd::pack_bf16(dka[4 * n], dka[4 * n + 1]);
        *reinterpret_cast<uint32_t*>(dv + c + r_g * rs) = phd::pack_bf16(dva[4 * n], dva[4 * n + 1]);
      }
      if (r_g + 8 < S) {
        *reinterpret_cast<uint32_t*>(dk + c + (r_g + 8) * rs) =
            phd::pack_bf16(dka[4 * n + 2], dka[4 * n + 3]);
        *reinterpret_cast<uint32_t*>(dv + c + (r_g + 8) * rs) =
            phd::pack_bf16(dva[4 * n + 2], dva[4 * n + 3]);
      }
    }
  }
}

// ---- f32, CUDA cores ---------------------------------------------------------

constexpr int BQ = 128;   // q rows per dq block, one per thread
constexpr int BK = 64;    // keys per shared-memory tile in the dq kernel
constexpr int BKV = 128;  // key rows per dk/dv block, one per thread
constexpr int TQ = 64;    // q rows per shared-memory tile in the dk/dv kernel

// sum_d a[d] * b[d], in order, b read from shared memory as float4.
template <int D>
__device__ __forceinline__ float dot_shared(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 t = *reinterpret_cast<const float4*>(b + d);
    s = fmaf(a[d], t.x, s);
    s = fmaf(a[d + 1], t.y, s);
    s = fmaf(a[d + 2], t.z, s);
    s = fmaf(a[d + 3], t.w, s);
  }
  return s;
}

// The same sum with a in shared memory and b in registers: identical
// operands in identical order, so identical result.
template <int D>
__device__ __forceinline__ float dot_shared_rev(const float* a_sh, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 t = *reinterpret_cast<const float4*>(a_sh + d);
    s = fmaf(t.x, b[d], s);
    s = fmaf(t.y, b[d + 1], s);
    s = fmaf(t.z, b[d + 2], s);
    s = fmaf(t.w, b[d + 3], s);
  }
  return s;
}

// o, g, dq: contiguous [B, S, H, D]; lse, delta: [B*H, S] f32.
template <int D>
__global__ void __launch_bounds__(BQ) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ g,
    const float* __restrict__ lse, float* __restrict__ dq, float* __restrict__ delta,
    int S, int H,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale) {
  static_assert(D % 8 == 0 && D <= 64, "D must be a multiple of 8, at most 64");
  constexpr int VEC = D / 8;

  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int bh = blockIdx.y;
  const long long b = bh / H, h = bh % H;
  const int row = blockIdx.x * BQ + threadIdx.x;
  const bool valid = row < S;

  float qs[D], gf[D], acc[D];
  float lse2 = 0.f, dlt = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) qs[d] = gf[d] = acc[d] = 0.f;
  if (valid) {
    const float* qp = q + b * q_sb + row * q_ss + h * q_sh;
    const long long off = ((b * S + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      float f[8], fg[8], fo[8];
      phd::load8(qp + 8 * c, f);
      phd::load8(g + off + 8 * c, fg);
      phd::load8(o + off + 8 * c, fo);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        qs[8 * c + i] = f[i] * scale;
        gf[8 * c + i] = fg[i];
        dlt = fmaf(fg[i], fo[i], dlt);
      }
    }
    lse2 = lse[static_cast<long long>(bh) * S + row];
    delta[static_cast<long long>(bh) * S + row] = dlt;
  }

  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the previous tile has been consumed
    for (int i = threadIdx.x; i < BK * VEC; i += BQ) {
      const int r = i / VEC, c = (i % VEC) * 8;
      const int key = k0 + r;
      float fk[8], fv[8];
      if (key < S) {
        phd::load8(kb + key * k_ss + c, fk);
        phd::load8(vb + key * v_ss + c, fv);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) fk[j] = fv[j] = 0.f;
      }
      phd::store8(&ks[r][c], fk);
      phd::store8(&vs[r][c], fv);
    }
    __syncthreads();

    const int kn = min(BK, S - k0);
#pragma unroll 4
    for (int j = 0; j < kn; ++j) {
      const float s = dot_shared<D>(qs, ks[j]);
      const float dp = dot_shared<D>(gf, vs[j]);
      const float p = phd::ex2(s * LOG2E - lse2);
      const float ds = p * (dp - dlt);
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(&ks[j][d]);
        acc[d] = fmaf(ds, kv.x, acc[d]);
        acc[d + 1] = fmaf(ds, kv.y, acc[d + 1]);
        acc[d + 2] = fmaf(ds, kv.z, acc[d + 2]);
        acc[d + 3] = fmaf(ds, kv.w, acc[d + 3]);
      }
    }
  }

  if (valid) {
    float* dqp = dq + ((b * S + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      float f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = acc[8 * c + i] * scale;
      phd::store8(dqp + 8 * c, f);
    }
  }
}

// g, dk, dv: contiguous [B, S, H, D]; lse, delta: [B*H, S] f32.
template <int D>
__global__ void __launch_bounds__(BKV) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
    int S, int H,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale) {
  static_assert(D % 8 == 0 && D <= 64, "D must be a multiple of 8, at most 64");
  constexpr int VEC = D / 8;

  __shared__ __align__(16) float qsh[TQ][D];  // q * scale
  __shared__ __align__(16) float gsh[TQ][D];
  __shared__ float lsh[TQ];
  __shared__ float dsh[TQ];

  const int bh = blockIdx.y;
  const long long b = bh / H, h = bh % H;
  const int key = blockIdx.x * BKV + threadIdx.x;
  const bool valid = key < S;

  float kf[D], vf[D], dka[D], dva[D];
#pragma unroll
  for (int d = 0; d < D; ++d) kf[d] = vf[d] = dka[d] = dva[d] = 0.f;
  if (valid) {
    const float* kp = k + b * k_sb + key * k_ss + h * k_sh;
    const float* vp = v + b * v_sb + key * v_ss + h * v_sh;
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      phd::load8(kp + 8 * c, kf + 8 * c);
      phd::load8(vp + 8 * c, vf + 8 * c);
    }
  }

  const float* qb = q + b * q_sb + h * q_sh;
  const float* lb = lse + static_cast<long long>(bh) * S;
  const float* db = delta + static_cast<long long>(bh) * S;

  for (int q0 = 0; q0 < S; q0 += TQ) {
    __syncthreads();  // the previous tile has been consumed
    for (int i = threadIdx.x; i < TQ * VEC; i += BKV) {
      const int r = i / VEC, c = (i % VEC) * 8;
      const int row = q0 + r;
      float fq[8], fg[8];
      if (row < S) {
        phd::load8(qb + row * q_ss + c, fq);
        phd::load8(g + ((b * S + row) * H + h) * D + c, fg);
#pragma unroll
        for (int j = 0; j < 8; ++j) fq[j] *= scale;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) fq[j] = fg[j] = 0.f;
      }
      phd::store8(&qsh[r][c], fq);
      phd::store8(&gsh[r][c], fg);
    }
    if (threadIdx.x < TQ) {
      const int row = q0 + threadIdx.x;
      lsh[threadIdx.x] = row < S ? lb[row] : 0.f;
      dsh[threadIdx.x] = row < S ? db[row] : 0.f;
    }
    __syncthreads();

    const int qn = min(TQ, S - q0);
#pragma unroll 4
    for (int i = 0; i < qn; ++i) {
      const float s = dot_shared_rev<D>(qsh[i], kf);
      const float dp = dot_shared_rev<D>(gsh[i], vf);
      const float p = phd::ex2(s * LOG2E - lsh[i]);
      const float ds = p * (dp - dsh[i]);
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(&qsh[i][d]);
        const float4 gv = *reinterpret_cast<const float4*>(&gsh[i][d]);
        dka[d] = fmaf(ds, qv.x, dka[d]);
        dka[d + 1] = fmaf(ds, qv.y, dka[d + 1]);
        dka[d + 2] = fmaf(ds, qv.z, dka[d + 2]);
        dka[d + 3] = fmaf(ds, qv.w, dka[d + 3]);
        dva[d] = fmaf(p, gv.x, dva[d]);
        dva[d + 1] = fmaf(p, gv.y, dva[d + 1]);
        dva[d + 2] = fmaf(p, gv.z, dva[d + 2]);
        dva[d + 3] = fmaf(p, gv.w, dva[d + 3]);
      }
    }
  }

  if (valid) {
    const long long off = ((b * S + key) * H + h) * D;
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      phd::store8(dk + off + 8 * c, dka + 8 * c);
      phd::store8(dv + off + 8 * c, dva + 8 * c);
    }
  }
}

}  // namespace

// q, k, v: [B, S, H, D] addressed by (batch, seq, head) strides in
// elements, D contiguous.  o (the forward's output), g (the output's
// gradient), dq, dk, dv: contiguous [B, S, H, D].  All of one dtype, f32
// for kFma and bf16 for the other designs.  lse: the forward's f32 [B, H, S] row log-sum-exp in
// base-2 units; delta: f32 scratch, [B, H, S], or for kWgmma [2, B*H, S4]
// with S4 = S rounded up to 4 (the row terms kernel 2 reads by TMA); qs:
// bf16 [B, S, H, D] scratch for kWgmma (q * scale), else null.  D is 8 or 64; every pointer
// is 16-byte aligned and every stride a multiple of 8 (the caller checks).
// `design`: phd::kFma (the CUDA-core kernels), kMmaSync (the mma.sync
// kernels) or kWgmma (the warpgroup kernels, D = 64 only, with qs).  Launches the dq kernel,
// then the dk/dv kernel, on `stream`; returns the first CUDA launch error
// (0 on success), or kErrEncode - CUresult for a refused tensor map.
extern "C" int phd_flash_attn_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* g,
    const float* lse, void* dq, void* dk, void* dv, float* delta, void* qs, int design,
    int B, int S, int H, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using phd::kFma, phd::kMmaSync, phd::kWgmma;
  const bool valid = (D == 8 || D == 64) &&
                     (design == kFma || design == kMmaSync ||
                      (design == kWgmma && D == 64 && qs != nullptr));
  if (!valid) return static_cast<int>(cudaErrorInvalidValue);
#define PHD_STRIDES q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale
#define PHD_DQ_ARGS(T)                                                                     \
  static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),            \
      static_cast<const T*>(o), static_cast<const T*>(g), lse, static_cast<T*>(dq), delta, \
      S, H, PHD_STRIDES
#define PHD_DKDV_ARGS(T)                                                                  \
  static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),           \
      static_cast<const T*>(g), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, \
      H, PHD_STRIDES
  if (design == kWgmma) {
    static unsigned long long ready_dq = 0, ready_dkdv = 0;
    cudaError_t e = phd::wgh::allow_smem(flash_bwd_dq_wgmma_kernel, WB_SMEM_DQ, &ready_dq);
    if (e == cudaSuccess)
      e = phd::wgh::allow_smem(flash_bwd_dkdv_wgmma_kernel, WB_SMEM_DKDV, &ready_dkdv);
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long rs = static_cast<long long>(H) * 64;  // row stride of g and qs
    const long long n = static_cast<long long>(B) * H * ((S + 3) & ~3);
    CUtensorMap kmap, vmap, qsmap, gmap, lsemap, deltamap;
    int err = phd::wgh::encode_bshd(&kmap, k, B, S, H, k_sb, k_ss, k_sh, WB_N);
    if (err == 0) err = phd::wgh::encode_bshd(&vmap, v, B, S, H, v_sb, v_ss, v_sh, WB_N);
    if (err == 0) err = phd::wgh::encode_bshd(&qsmap, qs, B, S, H, S * rs, rs, 64, WB_N);
    if (err == 0) err = phd::wgh::encode_bshd(&gmap, g, B, S, H, S * rs, rs, 64, WB_N);
    if (err == 0) err = phd::wgh::encode_flat(&lsemap, delta, n, WB_N);
    if (err == 0) err = phd::wgh::encode_flat(&deltamap, delta + n, n, WB_N);
    if (err != 0) return err;
    const dim3 grid((S + phd::wg::ROWS - 1) / phd::wg::ROWS, B * H);
    flash_bwd_dq_wgmma_kernel<<<grid, phd::wg::THREADS, WB_SMEM_DQ, st>>>(
        kmap, vmap, static_cast<const bf16*>(q), static_cast<const bf16*>(o),
        static_cast<const bf16*>(g), lse, static_cast<bf16*>(dq), static_cast<bf16*>(qs), delta,
        S, H, q_sb, q_ss, q_sh, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_dkdv_wgmma_kernel<<<grid, phd::wg::THREADS, WB_SMEM_DKDV, st>>>(
        qsmap, gmap, lsemap, deltamap, static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, k_sb, k_ss, k_sh, v_sb, v_ss,
        v_sh);
  } else if (design == kMmaSync) {
    const dim3 grid((S + MMA_ROWS - 1) / MMA_ROWS, B * H);
    if (D == 8)
      flash_bwd_dq_mma_kernel<8><<<grid, MMA_THREADS, 0, st>>>(PHD_DQ_ARGS(bf16));
    else
      flash_bwd_dq_mma_kernel<64><<<grid, MMA_THREADS, 0, st>>>(PHD_DQ_ARGS(bf16));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (D == 8)
      flash_bwd_dkdv_mma_kernel<8><<<grid, MMA_THREADS, 0, st>>>(PHD_DKDV_ARGS(bf16));
    else
      flash_bwd_dkdv_mma_kernel<64><<<grid, MMA_THREADS, 0, st>>>(PHD_DKDV_ARGS(bf16));
  } else {
    const dim3 grid_q((S + BQ - 1) / BQ, B * H), grid_k((S + BKV - 1) / BKV, B * H);
    if (D == 8)
      flash_bwd_dq_kernel<8><<<grid_q, BQ, 0, st>>>(PHD_DQ_ARGS(float));
    else
      flash_bwd_dq_kernel<64><<<grid_q, BQ, 0, st>>>(PHD_DQ_ARGS(float));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (D == 8)
      flash_bwd_dkdv_kernel<8><<<grid_k, BKV, 0, st>>>(PHD_DKDV_ARGS(float));
    else
      flash_bwd_dkdv_kernel<64><<<grid_k, BKV, 0, st>>>(PHD_DKDV_ARGS(float));
  }
#undef PHD_DKDV_ARGS
#undef PHD_DQ_ARGS
#undef PHD_STRIDES
  return static_cast<int>(cudaGetLastError());
}
