// Fused self-attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` launched by `_flash_fwd_3d` in
// phendiff_tpu/ops/flash_attention.py: o = softmax(q k^T * scale) v for
// q, k, v of layout [B, S, H, D] in bf16 or f32 (the TPU kernel, too, runs
// in its input dtype), with f32 softmax and f32 accumulation, and nothing
// of size [S, S] written to device memory.  D is 8 (the main path), 64
// (the SD path) or 72 (DiT-XL/2, forward only); the caller zero-pads other
// head dims up.  Three designs,
// chosen by the caller (ops/flash_attention.py::attention_design) and
// passed in as `design`:
//
// Bound.  At the main-path shape (B=32, H=32, S=1024, D=8) one call does
// B*H*S*S = 1.07e9 exponentials and 4*B*H*S*S*D = 3.4e10 flops over 67 MB of
// q/k/v/o: the special-function unit (16 exp2 per clock per SM) bounds it,
// not the tensor cores or the memory.  At D = 64 the tensor cores bound it:
// per score 4*D = 256 flops at 989 TFLOP/s take 0.26 ps, one exp2 at
// 16 x 132 x 1.98e9 a second 0.24 ps.
//
// 1. bf16 D = 64 at S >= the route's threshold, and bf16 D = 72 at every
// S: warpgroup products (flash_fwd_wgmma_kernel, helpers in attn_wgmma.cuh;
// at D = 72 each k and v tile has a 16-column tail tile, attn_wgmma.cuh's
// header says how).  A block of three
// warpgroups owns 128 q rows of one (batch, head):
//   * the producer warpgroup (24 registers a thread by setmaxnreg) has one
//     thread issue TMA loads of 128-key k and v tiles, 128-byte swizzled,
//     into a ring of WG_STAGES stages, each with a full and an empty
//     mbarrier; the 4-D tensor maps (64, H, S, B) read q/k/v through their
//     strides, so the fused qkv's column slices need no copy, and zero-fill
//     keys past S;
//   * two consumer warpgroups (240 registers) of 64 q rows each hold
//     q * scale (rounded to bf16 as the plain version scales q) in
//     registers as wgmma's A operand; per tile, S = Q K^T is four
//     m64n128k16 over the k tile (K-major), the online softmax runs on the
//     accumulator fragments (quad shuffles, one FFMA and one ex2 a score),
//     P rounded to bf16x2 in registers is the A operand of O += P V, eight
//     m64n64k16 reading the v tile transposed by the descriptor; the next
//     tile's Q K^T and this tile's P V are issued together, so the tensor
//     cores run P V under the next softmax (FlashAttention-3's
//     intra-warpgroup overlap); once P V is done every consumer thread
//     arrives on the stage's empty barrier.
// The two consumer warpgroups share each tile and run unsynchronised, so
// one's softmax also overlaps the other's products.  Making them take
// turns, as the backward does, measured slower here, and dropping the
// intra-warpgroup overlap slower still; 192-key tiles measured slower than
// 128-key ones at every SD shape.  The K/V tiles are re-read from L2 by
// each of the S / 128 blocks of a (batch, head).
//
// 2. bf16 otherwise (D = 8, and D = 64 below the threshold): mma.sync
// tensor cores (flash_fwd_mma_kernel).  The TPU
// kernel held a whole [BQ, S] score row in VMEM; a Hopper block cannot, so
// k and v stream through shared memory and each q row keeps an online
// softmax (running max m, running sum l, rescaled f32 accumulator):
//   * one block of 4 warps per (b*h, 64-row q tile); each warp owns 16 q
//     rows, whose q * scale (rounded to bf16, as the plain version scales
//     q) stays in registers as the A operand;
//   * k and v tiles of 64 keys arrive by cp.async,
//     double-buffered, as bf16, and reach the tensor cores through
//     ldmatrix (v transposed);
//   * S = Q K^T is mma.m16n8k8 at D = 8 (D is the whole depth, nothing is
//     padded) and m16n8k16 over 4 depth steps at D = 64; P V is m16n8k16,
//     its A operand the score accumulators rounded to bf16x2 in registers;
//   * the softmax runs on the accumulator fragments: row max and row sum
//     over a quad by two __shfl_xor, one rescale per tile, and each
//     probability is one FFMA (s*log2e - m*log2e) and one ex2.approx.
// In both, p is rounded to bf16 unnormalised before P V, as the TPU kernel
// rounds it (`_fwd_kernel`); the row sum l adds the f32 p, before
// rounding.  The output is the f32 accumulator over l, rounded once.
//
// 3. f32: CUDA cores (flash_fwd_kernel).  Tensor cores take f32 only as
// TF32, which misses the f32 tolerances, so f32 keeps plain FMA: one thread
// per q row, k/v tiles in shared memory read as broadcasts, the rescale
// once per CH keys, scores in base-2 units for one ex2.approx per
// probability.
//
// All write, when `lse` is non-null, each row's log-sum-exp in base-2
// units (m + log2(l)), f32 [B, H, S], for the backward
// (csrc/flash_attn_bwd.cu).  q, k and v are addressed through strides, so
// the three column slices of the fused qkv projection are read in place.

#include <type_traits>

#include "attn_wgmma.cuh"

namespace {

using phd::LOG2E;
using phd::MMA_ROWS;
using phd::MMA_THREADS;
using bf16 = __nv_bfloat16;

// ---- bf16, mma.sync tensor cores --------------------------------------------

template <int D>
__global__ void __launch_bounds__(MMA_THREADS, phd::MMA_MIN_BLOCKS<D>) flash_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int S, int H,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale) {
  constexpr int CH = D / 8;                // 16-byte chunks per row
  constexpr int BK = 64;                   // keys per tile and per softmax step
  constexpr int NT = D / 8;                // output tiles of 8 columns
  __shared__ __align__(128) uint4 kv_sh[2][2][BK * CH];  // [buffer][k, v]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const long long b = bh / H, h = bh % H;
  const int r_g = blockIdx.x * MMA_ROWS + warp * 16 + g;  // rows r_g, r_g + 8

  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  const int ntiles = (S + BK - 1) / BK;
  phd::load_tile<D, BK>(phd::smem_u32(kv_sh[0][0]), kb, k_ss, 0, S);
  phd::load_tile<D, BK>(phd::smem_u32(kv_sh[0][1]), vb, v_ss, 0, S);
  phd::cp_async_commit();

  uint32_t qa[D / 4];
  phd::load_a<D>(qa, q + b * q_sb + h * q_sh, q_ss, r_g, S, t, phd::round_bf16(scale));

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: per-lane partial sums
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

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 32; ++j) phd::mma_abt32<D>(s + 4 * j, qa, ktile, 32 * j, lane);

    const int kn = S - k0;  // keys of this tile that exist, if fewer than BK
    if (kn < BK) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * n + 2 * t + (e & 1) >= kn) s[n][e] = -INFINITY;
    }

    // the tile's first key exists, so both maxima are finite; on the first
    // tile m = -inf gives alpha = ex2(-inf) = 0
    static_assert(BK == 64, "the row max below is a tree over 8 tiles");
    float r0[8], r1[8];  // a tree, not a chain of dependent maxima
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      r0[n] = fmaxf(s[n][0], s[n][1]);
      r1[n] = fmaxf(s[n][2], s[n][3]);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      r0[n] = fmaxf(r0[n], r0[n + 4]);
      r1[n] = fmaxf(r1[n], r1[n + 4]);
    }
    r0[0] = fmaxf(fmaxf(r0[0], r0[2]), fmaxf(r0[1], r0[3]));
    r1[0] = fmaxf(fmaxf(r1[0], r1[2]), fmaxf(r1[1], r1[3]));
    const float mx0 = fmaxf(m0, phd::quad_max(r0[0]));
    const float mx1 = fmaxf(m1, phd::quad_max(r1[0]));
    const float alpha0 = phd::ex2((m0 - mx0) * LOG2E);
    const float alpha1 = phd::ex2((m1 - mx1) * LOG2E);
    m0 = mx0;
    m1 = mx1;
    const float nm0 = -mx0 * LOG2E, nm1 = -mx1 * LOG2E;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha0; acc[n][1] *= alpha0;
      acc[n][2] *= alpha1; acc[n][3] *= alpha1;
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = phd::ex2(fmaf(s[n][0], LOG2E, nm0));
      s[n][1] = phd::ex2(fmaf(s[n][1], LOG2E, nm0));
      s[n][2] = phd::ex2(fmaf(s[n][2], LOG2E, nm1));
      s[n][3] = phd::ex2(fmaf(s[n][3], LOG2E, nm1));
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int j = 0; j < BK / 32; ++j) {
      uint32_t pa[2][4];
      phd::to_a32(pa, s + 4 * j);
      phd::mma_pb32<D>(acc, pa, vtile, 32 * j, lane);
    }
    __syncthreads();  // the tile is consumed before its buffer is refilled
  }

  l0 = phd::quad_sum(l0);
  l1 = phd::quad_sum(l1);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  bf16* ob = o + b * o_sb + h * o_sh + 2 * t;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (r_g < S)
      *reinterpret_cast<uint32_t*>(ob + r_g * o_ss + 8 * n) =
          phd::pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r_g + 8 < S)
      *reinterpret_cast<uint32_t*>(ob + (r_g + 8) * o_ss + 8 * n) =
          phd::pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if (lse && t == 0) {
    float* lb = lse + static_cast<long long>(bh) * S;
    if (r_g < S) lb[r_g] = m0 * LOG2E + log2f(l0);
    if (r_g + 8 < S) lb[r_g + 8] = m1 * LOG2E + log2f(l1);
  }
}

// ---- bf16, D = 64 and 72, warpgroup products ------------------------------------

constexpr int WG_BN = 128;                      // keys a stage
constexpr int WG_STAGES = 3;                    // stages of the ring
constexpr int WG_TILE = WG_BN * 64 * 2;         // bytes of one k or v tile (columns 0..63)
constexpr int WG_TAIL = WG_BN * 16 * 2;         // bytes of a D = 72 tail tile (64..79)
// A stage: the k then v tile, at D = 72 their tail tiles after them.
template <int D>
constexpr int WG_STAGE = 2 * WG_TILE + (D == 72 ? 2 * WG_TAIL : 0);
// The ring, its 2 x WG_STAGES mbarriers, and room to align the ring to 1024
// bytes (the 128-byte swizzle's period).
template <int D>
constexpr int WG_SMEM = 1024 + WG_STAGES * WG_STAGE<D> + 16 * WG_STAGES;

// D = 64, or 72 with the tail tiles of attn_wgmma.cuh (ktail and vtail: the
// maps at column 64; at D = 64 they are not read).
template <int D>
__global__ void __launch_bounds__(phd::wg::THREADS, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap ktail, const __grid_constant__ CUtensorMap vtail,
    const bf16* __restrict__ q, bf16* __restrict__ o, float* __restrict__ lse, int S, int H,
    long long q_sb, long long q_ss, long long q_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale) {
  static_assert(D == 64 || D == 72, "the warpgroup forward takes D = 64 or 72");
  namespace wg = phd::wg;
  constexpr bool TAIL = D == 72;
  constexpr int STAGE = WG_STAGE<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ring = (phd::smem_u32(smem_raw) + 1023u) & ~1023u;
  // stage st: k tile at ring + st STAGE, its v tile next (then, at D = 72,
  // the k and v tails); full[st] at bars + 8 st, empty[st] at
  // bars + 8 (WG_STAGES + st)
  const uint32_t bars = ring + WG_STAGES * STAGE;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int ntiles = (S + WG_BN - 1) / WG_BN;
  wg::init_ring<WG_STAGES>(bars);

  const int role = threadIdx.x / 128;  // 0: producer, 1 and 2: consumers
  if (role == 0) {
    wg::producer_registers();
    if (threadIdx.x == 0) {
      wg::prefetch_map(&kmap);
      wg::prefetch_map(&vmap);
      if constexpr (TAIL) {
        wg::prefetch_map(&ktail);
        wg::prefetch_map(&vtail);
        wg::produce<WG_BN, WG_STAGES, WG_TAIL>(ring, 0, bars, ntiles, &kmap, &vmap, nullptr,
                                               nullptr, h, b, 0, &ktail, &vtail);
      } else {
        wg::produce<WG_BN, WG_STAGES>(ring, 0, bars, ntiles, &kmap, &vmap, nullptr, nullptr,
                                      h, b, 0);
      }
    }
  } else {
    wg::consumer_registers();
    const int tid = threadIdx.x - 128 * role;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r_g = blockIdx.x * wg::ROWS + (role - 1) * 64 + warp * 16 + g;  // rows r_g, r_g + 8

    // q * scale: 4 k16 steps, at D = 72 a fifth whose columns 72..79 are 0
    constexpr int QA = TAIL ? 20 : 16;
    uint32_t qa[QA];
    phd::load_a<D>(qa, q + b * q_sb + h * q_sh, q_ss, r_g, S, t, phd::round_bf16(scale));
    if constexpr (TAIL) qa[18] = qa[19] = 0u;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: per-lane partial sums
    float acc[32];
    wg::zero<32>(acc);
    constexpr int AT = TAIL ? 8 : 1;  // the tail's output columns 64..79
    float acc_t[AT];
    wg::zero<AT>(acc_t);
    uint32_t pa[WG_BN / 4];  // the previous tile's p, the A operand of its P V

    // Scores of tile `it` into s; then, with `pv`, the previous tile's
    // P V queued behind them, so the tensor cores run it under this tile's
    // softmax.  Returns with s ready and P V in flight.
    auto scores = [&](float* s, int it, bool pv) {
      const int st = it % WG_STAGES;
      wg::mbar_wait(bars + 8 * st, (it / WG_STAGES) & 1);
      wg::pin<WG_BN / 2>(s);
      wg::pin<32>(acc);
      if constexpr (TAIL) wg::pin<AT>(acc_t);
      wg::fence();
      wg::mma_abt<WG_BN>(s, qa, ring + st * STAGE);
      if constexpr (TAIL) wg::mma_abt_tail<WG_BN>(s, qa + 16, ring + st * STAGE + 2 * WG_TILE);
      wg::commit();
      if (pv) {
        const int prev = (it + WG_STAGES - 1) % WG_STAGES;
        wg::mma_pb<WG_BN>(acc, pa, ring + prev * STAGE + WG_TILE);
        if constexpr (TAIL)
          wg::mma_pb_tail<WG_BN>(acc_t, pa, ring + prev * STAGE + 2 * WG_TILE + WG_TAIL);
        wg::commit();
      }
      if (pv)
        wg::wait<1>();
      else
        wg::wait<0>();
      wg::pin<WG_BN / 2>(s);
    };
    // The online softmax of tile `it`'s scores: new maxima, s -> p in place,
    // the row sums; returns the rescale factors of the older terms.  MASK:
    // the tile holds keys past S (only the last tile can).
    auto softmax = [&](float* s, int it, float& alpha0, float& alpha1, auto mask) {
      if constexpr (decltype(mask)::value) {
        const int kn = S - it * WG_BN;  // keys of this tile that exist
#pragma unroll
        for (int i = 0; i < WG_BN / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * i + 2 * t + (e & 1) >= kn) s[4 * i + e] = -INFINITY;
      }
      // the tile's first key exists, so both maxima are finite; on the first
      // tile m = -inf gives alpha = ex2(-inf) = 0
      const float mx0 = fmaxf(m0, wg::row_max<WG_BN>(s, 0));
      const float mx1 = fmaxf(m1, wg::row_max<WG_BN>(s, 1));
      alpha0 = phd::ex2((m0 - mx0) * LOG2E);
      alpha1 = phd::ex2((m1 - mx1) * LOG2E);
      m0 = mx0;
      m1 = mx1;
      const float nm0 = -mx0 * LOG2E, nm1 = -mx1 * LOG2E;
      l0 *= alpha0;
      l1 *= alpha1;
#pragma unroll
      for (int i = 0; i < WG_BN / 8; ++i) {
        s[4 * i] = phd::ex2(fmaf(s[4 * i], LOG2E, nm0));
        s[4 * i + 1] = phd::ex2(fmaf(s[4 * i + 1], LOG2E, nm0));
        s[4 * i + 2] = phd::ex2(fmaf(s[4 * i + 2], LOG2E, nm1));
        s[4 * i + 3] = phd::ex2(fmaf(s[4 * i + 3], LOG2E, nm1));
        l0 += s[4 * i] + s[4 * i + 1];
        l1 += s[4 * i + 2] + s[4 * i + 3];
      }
    };
    const bool ragged = S % WG_BN != 0;
    auto softmax_of = [&](float* s, int it, float& alpha0, float& alpha1) {
      if (ragged && it == ntiles - 1)
        softmax(s, it, alpha0, alpha1, std::true_type());
      else
        softmax(s, it, alpha0, alpha1, std::false_type());
    };

    float alpha0, alpha1;
    {
      float s[WG_BN / 2];
      scores(s, 0, false);
      softmax_of(s, 0, alpha0, alpha1);
      wg::to_a<WG_BN>(pa, s);
    }
    for (int it = 1; it < ntiles; ++it) {
      float s[WG_BN / 2];
      scores(s, it, true);
      softmax_of(s, it, alpha0, alpha1);
      wg::wait<0>();  // the previous tile's P V is done: its stage is free
      wg::pin<32>(acc);
      if constexpr (TAIL) wg::pin<AT>(acc_t);
      wg::mbar_arrive(bars + 8 * (WG_STAGES + (it - 1) % WG_STAGES));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[4 * i] *= alpha0; acc[4 * i + 1] *= alpha0;
        acc[4 * i + 2] *= alpha1; acc[4 * i + 3] *= alpha1;
      }
      if constexpr (TAIL) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc_t[4 * i] *= alpha0; acc_t[4 * i + 1] *= alpha0;
          acc_t[4 * i + 2] *= alpha1; acc_t[4 * i + 3] *= alpha1;
        }
      }
      wg::to_a<WG_BN>(pa, s);
    }
    {
      const int last = (ntiles - 1) % WG_STAGES;
      wg::pin<32>(acc);
      if constexpr (TAIL) wg::pin<AT>(acc_t);
      wg::fence();
      wg::mma_pb<WG_BN>(acc, pa, ring + last * STAGE + WG_TILE);
      if constexpr (TAIL)
        wg::mma_pb_tail<WG_BN>(acc_t, pa, ring + last * STAGE + 2 * WG_TILE + WG_TAIL);
      wg::commit();
      wg::wait<0>();
      wg::pin<32>(acc);
      if constexpr (TAIL) wg::pin<AT>(acc_t);
      wg::mbar_arrive(bars + 8 * (WG_STAGES + last));
    }

    l0 = phd::quad_sum(l0);
    l1 = phd::quad_sum(l1);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    bf16* ob = o + b * o_sb + h * o_sh + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (r_g < S)
        *reinterpret_cast<uint32_t*>(ob + r_g * o_ss + 8 * n) =
            phd::pack_bf16(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
      if (r_g + 8 < S)
        *reinterpret_cast<uint32_t*>(ob + (r_g + 8) * o_ss + 8 * n) =
            phd::pack_bf16(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
    }
    if constexpr (TAIL) {  // columns 64..71; 72..79 are the padding's zeros
      if (r_g < S)
        *reinterpret_cast<uint32_t*>(ob + r_g * o_ss + 64) =
            phd::pack_bf16(acc_t[0] * inv0, acc_t[1] * inv0);
      if (r_g + 8 < S)
        *reinterpret_cast<uint32_t*>(ob + (r_g + 8) * o_ss + 64) =
            phd::pack_bf16(acc_t[2] * inv1, acc_t[3] * inv1);
    }
    if (lse && t == 0) {
      float* lb = lse + static_cast<long long>(bh) * S;
      if (r_g < S) lb[r_g] = m0 * LOG2E + log2f(l0);
      if (r_g + 8 < S) lb[r_g + 8] = m1 * LOG2E + log2f(l1);
    }
  }
}

// ---- f32, CUDA cores ---------------------------------------------------------

constexpr int BQ = 128;  // q rows per block, one per thread
constexpr int BK = 64;   // keys per shared-memory tile
constexpr int CH = 16;   // keys per online-softmax rescale

template <int D>
__global__ void __launch_bounds__(BQ) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
    int S, int H,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale) {
  static_assert(D % 8 == 0 && D <= 72, "D must be a multiple of 8, at most 72");
  constexpr int VEC = D / 8;  // 8-float vectors per row

  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int bh = blockIdx.y;
  const long long b = bh / H, h = bh % H;
  const int row = blockIdx.x * BQ + threadIdx.x;
  const bool valid = row < S;

  // q * scale carried in base-2 units
  float qf[D];
  if (valid) {
    const float* qp = q + b * q_sb + row * q_ss + h * q_sh;
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      float f[8];
      phd::load8(qp + 8 * c, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) qf[8 * c + i] = f[i] * scale * LOG2E;
    }
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qf[d] = 0.f;
  }

  float m = -INFINITY, l = 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

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
    for (int j0 = 0; j0 < kn; j0 += CH) {
      float s[CH];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(&ks[j0 + j][d]);
          dot = fmaf(qf[d], kv.x, dot);
          dot = fmaf(qf[d + 1], kv.y, dot);
          dot = fmaf(qf[d + 2], kv.z, dot);
          dot = fmaf(qf[d + 3], kv.w, dot);
        }
        s[j] = (j0 + j < kn) ? dot : -INFINITY;
        cmax = fmaxf(cmax, s[j]);
      }
      // cmax is finite: key j0 < kn is valid.  m = -inf on the first chunk
      // gives alpha = ex2(-inf) = 0.
      const float m_new = fmaxf(m, cmax);
      const float alpha = phd::ex2(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float p = phd::ex2(s[j] - m_new);
        l += p;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&vs[j0 + j][d]);
          acc[d] = fmaf(p, vv.x, acc[d]);
          acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
        }
      }
      m = m_new;
    }
  }

  if (valid) {
    const float inv = 1.f / l;
    float* op = o + b * o_sb + row * o_ss + h * o_sh;
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      float f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = acc[8 * c + i] * inv;
      phd::store8(op + 8 * c, f);
    }
    if (lse) lse[static_cast<long long>(bh) * S + row] = m + log2f(l);
  }
}

}  // namespace

// q, k, v, o: [B, S, H, D] of one dtype, f32 for kFma and bf16 for the
// other designs, addressed by (batch, seq, head) strides in elements; the D
// axis is contiguous.  lse: null, or f32 [B, H, S] for each row's
// log-sum-exp in base-2 units.  D is 8, 64 or 72; every pointer is 16-byte
// aligned and every stride a multiple of 8 (the caller checks).  `design`:
// phd::kFma (the CUDA-core kernel), kMmaSync (the mma.sync kernel, D = 8
// or 64) or kWgmma (the warpgroup kernel, D = 64 or 72).  Returns the CUDA error of
// the launch (0 on success), or kErrEncode - CUresult for a tensor map the
// driver refused.
extern "C" int phd_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int design,
    int B, int S, int H, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using phd::kFma, phd::kMmaSync, phd::kWgmma;
  const bool valid = (D == 8 || D == 64 || D == 72) &&
                     (design == kFma || (design == kMmaSync && D != 72) ||
                      (design == kWgmma && D != 8));
  if (!valid) return static_cast<int>(cudaErrorInvalidValue);
#define PHD_ARGS(T)                                                                   \
  static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),       \
      static_cast<T*>(o), lse, S, H, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, \
      v_sh, o_sb, o_ss, o_sh, scale
  if (design == kWgmma) {
    CUtensorMap kmap, vmap, ktail, vtail;
    int err = phd::wgh::encode_bshd(&kmap, k, B, S, H, k_sb, k_ss, k_sh, WG_BN);
    if (err == 0) err = phd::wgh::encode_bshd(&vmap, v, B, S, H, v_sb, v_ss, v_sh, WG_BN);
    if (err == 0 && D == 72)
      err = phd::wgh::encode_bshd(&ktail, k, B, S, H, k_sb, k_ss, k_sh, WG_BN, true);
    if (err == 0 && D == 72)
      err = phd::wgh::encode_bshd(&vtail, v, B, S, H, v_sb, v_ss, v_sh, WG_BN, true);
    if (err != 0) return err;
    const dim3 grid((S + phd::wg::ROWS - 1) / phd::wg::ROWS, B * H);
    if (D == 64) {
      static unsigned long long ready = 0;
      const cudaError_t e = phd::wgh::allow_smem(flash_fwd_wgmma_kernel<64>, WG_SMEM<64>, &ready);
      if (e != cudaSuccess) return static_cast<int>(e);
      flash_fwd_wgmma_kernel<64><<<grid, phd::wg::THREADS, WG_SMEM<64>, st>>>(
          kmap, vmap, kmap, vmap, static_cast<const bf16*>(q), static_cast<bf16*>(o), lse, S, H,
          q_sb, q_ss, q_sh, o_sb, o_ss, o_sh, scale);
    } else {
      static unsigned long long ready = 0;
      const cudaError_t e = phd::wgh::allow_smem(flash_fwd_wgmma_kernel<72>, WG_SMEM<72>, &ready);
      if (e != cudaSuccess) return static_cast<int>(e);
      flash_fwd_wgmma_kernel<72><<<grid, phd::wg::THREADS, WG_SMEM<72>, st>>>(
          kmap, vmap, ktail, vtail, static_cast<const bf16*>(q), static_cast<bf16*>(o), lse, S,
          H, q_sb, q_ss, q_sh, o_sb, o_ss, o_sh, scale);
    }
  } else if (design == kMmaSync) {
    const dim3 grid((S + MMA_ROWS - 1) / MMA_ROWS, B * H);
    if (D == 8)
      flash_fwd_mma_kernel<8><<<grid, MMA_THREADS, 0, st>>>(PHD_ARGS(bf16));
    else
      flash_fwd_mma_kernel<64><<<grid, MMA_THREADS, 0, st>>>(PHD_ARGS(bf16));
  } else {
    const dim3 grid((S + BQ - 1) / BQ, B * H);
    if (D == 8)
      flash_fwd_kernel<8><<<grid, BQ, 0, st>>>(PHD_ARGS(float));
    else if (D == 64)
      flash_fwd_kernel<64><<<grid, BQ, 0, st>>>(PHD_ARGS(float));
    else
      flash_fwd_kernel<72><<<grid, BQ, 0, st>>>(PHD_ARGS(float));
  }
#undef PHD_ARGS
  return static_cast<int>(cudaGetLastError());
}
