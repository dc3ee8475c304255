// Fused self-attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` launched by `_flash_fwd_3d` in
// phendiff_tpu/ops/flash_attention.py: o = softmax(q k^T * scale) v for
// q, k, v of layout [B, S, H, D] in bf16 or f32 (the TPU kernel, too, runs
// in its input dtype), with f32 softmax and f32 accumulation, and nothing
// of size [S, S] written to device memory.  D is 8 (the main path) or 64
// (the SD path); the caller zero-pads other head dims up.
//
// Design.  The TPU kernel held a whole [BQ, S] score row in VMEM and took
// the softmax denominator from a ones-row appended to v.  A Hopper block
// cannot hold that row, so this kernel streams k and v through shared
// memory in tiles of BK keys and keeps an online softmax (running max m,
// running sum l, rescaled f32 accumulator o) per q row:
//   * one block per (b*h, BQ-row q tile), one thread per q row; the row's
//     q (pre-scaled in the input dtype, as the plain version does) and o
//     live in registers;
//   * each k/v tile is loaded once per block with 16-byte loads, converted
//     to f32 in shared memory, and read by every thread of the block as a
//     broadcast (all threads read the same key at the same time);
//   * the rescale is done once per CH keys, not per key;
//   * scores are kept in base-2 units (q carries log2(e)) so each
//     exponential is one ex2.approx instruction.
// q, k and v are addressed through strides, so the three column slices of
// the fused qkv projection are read in place without copies.
//
// Bound.  At the main-path shape (B=32, H=32, S=1024, D=8) one call does
// B*H*S*S = 1.07e9 exponentials and 4*B*H*S*S*D = 3.4e10 flops over 67 MB of
// q/k/v/o: the special-function unit (16 exp2 per clock per SM) bounds it,
// not the tensor cores or the memory.  The arithmetic here is plain FMA on
// the CUDA cores (D=8 is half of the 16-deep bf16 MMA); an mma/wgmma
// version is later work.
//
// Numerics.  p stays f32 into the PV product (the TPU kernel rounded p to
// the input dtype there, the plain version rounds the normalised p to it),
// so in bf16 the kernel and the plain version differ at bf16 rounding of
// the output; in f32 they differ at f32 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;  // q rows per block, one per thread
constexpr int BK = 64;   // keys per shared-memory tile
constexpr int CH = 16;   // keys per online-softmax rescale
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* f) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store8(float* p, const float* f) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// x rounded to the input dtype T.
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float round_as(float x, const float*) { return x; }

template <typename T, int D>
__global__ void __launch_bounds__(BQ) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o,
    int S, int H,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale) {
  static_assert(D % 8 == 0 && D <= 64, "D must be a multiple of 8, at most 64");
  constexpr int VEC = D / 8;  // 16-byte vectors per row

  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int bh = blockIdx.y;
  const long long b = bh / H, h = bh % H;
  const int row = blockIdx.x * BQ + threadIdx.x;
  const bool valid = row < S;

  // q * scale rounded to T (the plain version scales q in the compute
  // dtype), then carried in base-2 units.
  const float scale_t = round_as(scale, q);
  float qf[D];
  if (valid) {
    const T* qp = q + b * q_sb + row * q_ss + h * q_sh;
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      float f[8];
      load8(qp + 8 * c, f);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        qf[8 * c + i] = round_as(f[i] * scale_t, q) * LOG2E;
    }
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qf[d] = 0.f;
  }

  float m = -INFINITY, l = 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the previous tile has been consumed
    for (int i = threadIdx.x; i < BK * VEC; i += BQ) {
      const int r = i / VEC, c = (i % VEC) * 8;
      const int key = k0 + r;
      float fk[8], fv[8];
      if (key < S) {
        load8(kb + key * k_ss + c, fk);
        load8(vb + key * v_ss + c, fv);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) fk[j] = fv[j] = 0.f;
      }
      *reinterpret_cast<float4*>(&ks[r][c]) = make_float4(fk[0], fk[1], fk[2], fk[3]);
      *reinterpret_cast<float4*>(&ks[r][c + 4]) = make_float4(fk[4], fk[5], fk[6], fk[7]);
      *reinterpret_cast<float4*>(&vs[r][c]) = make_float4(fv[0], fv[1], fv[2], fv[3]);
      *reinterpret_cast<float4*>(&vs[r][c + 4]) = make_float4(fv[4], fv[5], fv[6], fv[7]);
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
      const float alpha = ex2(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float p = ex2(s[j] - m_new);
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
    T* op = o + b * o_sb + row * o_ss + h * o_sh;
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      float f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = acc[8 * c + i] * inv;
      store8(op + 8 * c, f);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int D, long long q_sb, long long q_ss,
           long long q_sh, long long k_sb, long long k_ss, long long k_sh,
           long long v_sb, long long v_ss, long long v_sh, long long o_sb,
           long long o_ss, long long o_sh, float scale, cudaStream_t st) {
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
#define PHD_LAUNCH(DD)                                                      \
  flash_fwd_kernel<T, DD><<<grid, BQ, 0, st>>>(                             \
      qp, kp, vp, op, S, H, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, \
      v_sh, o_sb, o_ss, o_sh, scale)
  switch (D) {
    case 8: PHD_LAUNCH(8); break;
    case 64: PHD_LAUNCH(64); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PHD_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: [B, S, H, D] of one dtype (code 0 = f32, 1 = bf16),
// addressed by (batch, seq, head) strides in elements; the D axis is
// contiguous.  D is 8 or 64; every pointer is 16-byte aligned and every
// stride a multiple of 8 (the caller checks).  Returns the CUDA error of the
// launch (0 on success).
extern "C" int phd_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int S, int H, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, S, H, D, q_sb, q_ss, q_sh,
                                 k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb,
                                 o_ss, o_sh, scale, st);
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, S, H, D, q_sb, q_ss, q_sh, k_sb, k_ss,
                         k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
