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
// Design.  The TPU kernel held f32 [BQ, S] rows of p, dp and ds in VMEM
// (BQ = 512 at S = 1024) and carried dk/dv as VMEM accumulators revisited
// across a sequential q-block grid axis.  A Hopper block holds neither, and
// blocks run in no order, so the work is split into two kernels launched
// back to back, each deterministic (no float atomics):
//   1. dq: one block per (b*h, 128-row q tile), one thread per q row.  The
//      row's scaled q, g and dq accumulator live in registers; k and v
//      stream through shared memory in 64-key tiles (as in the forward);
//      p is recomputed from the row log-sum-exp the forward saved.  The
//      thread also writes the row term delta (below) for kernel 2.
//   2. dk/dv: one block per (b*h, 128-key tile), one thread per key row.
//      The key's k, v and the dk/dv accumulators live in registers; scaled
//      q, g, the log-sum-exp and delta stream through shared memory in
//      64-row tiles, read by all threads as broadcasts.
// Both kernels compute a score with the same operands in the same order,
// so they see bit-identical p.  Scores are turned into base-2 units
// before one ex2.approx per probability; the forward's log-sum-exp is
// stored in those units (lse2 = m + log2(l)).
//
// Numerics.  The row term uses rowsum(g * o), with o the forward's output
// in the input dtype: in exact arithmetic it equals rowsum(p * dp) (the
// TPU kernel's form) and costs D products per row instead of a pass over
// the keys.  As in the TPU kernel, ds and p are rounded to the input dtype
// before the products that use them (dq, dk from ds; dv from p); every
// product accumulates in f32, and dq, dk, dv are written in the input
// dtype at the end.
//
// Bound.  At the main-path shape (B=32, H=32, S=1024, D=8) one call needs
// one recompute of p: B*H*S*S = 1.07e9 exponentials, which bound it on the
// special-function unit (16 exp2 per clock per SM); its 5 products of
// 2*B*H*S*S*D flops and ~0.1 GB of q, k, v, o, g and gradients take less.
// This first version recomputes p twice (once per kernel) with plain FMA
// on the CUDA cores; sharing p between the two passes and tensor-core
// products are later work.  At D = 64 kernel 2 holds 4*64 floats per
// thread and spills some registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;   // q rows per dq block, one per thread
constexpr int BK = 64;    // keys per shared-memory tile in the dq kernel
constexpr int BKV = 128;  // key rows per dk/dv block, one per thread
constexpr int TQ = 64;    // q rows per shared-memory tile in the dk/dv kernel
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
template <typename T, int D>
__global__ void __launch_bounds__(BQ) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ g,
    const float* __restrict__ lse, T* __restrict__ dq, float* __restrict__ delta,
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

  const float scale_t = round_as(scale, q);
  float qs[D], gf[D], acc[D];
  float lse2 = 0.f, dlt = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) qs[d] = gf[d] = acc[d] = 0.f;
  if (valid) {
    const T* qp = q + b * q_sb + row * q_ss + h * q_sh;
    const long long off = ((b * S + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      float f[8], fg[8], fo[8];
      load8(qp + 8 * c, f);
      load8(g + off + 8 * c, fg);
      load8(o + off + 8 * c, fo);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        qs[8 * c + i] = round_as(f[i] * scale_t, q);
        gf[8 * c + i] = fg[i];
        dlt = fmaf(fg[i], fo[i], dlt);
      }
    }
    lse2 = lse[static_cast<long long>(bh) * S + row];
    delta[static_cast<long long>(bh) * S + row] = dlt;
  }

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
      store8(&ks[r][c], fk);
      store8(&vs[r][c], fv);
    }
    __syncthreads();

    const int kn = min(BK, S - k0);
#pragma unroll 4
    for (int j = 0; j < kn; ++j) {
      const float s = dot_shared<D>(qs, ks[j]);
      const float dp = dot_shared<D>(gf, vs[j]);
      const float p = ex2(s * LOG2E - lse2);
      const float ds = round_as(p * (dp - dlt), q);
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
    T* dqp = dq + ((b * S + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      float f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = acc[8 * c + i] * scale;
      store8(dqp + 8 * c, f);
    }
  }
}

// g, dk, dv: contiguous [B, S, H, D]; lse, delta: [B*H, S] f32.
template <typename T, int D>
__global__ void __launch_bounds__(BKV) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int S, int H,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale) {
  static_assert(D % 8 == 0 && D <= 64, "D must be a multiple of 8, at most 64");
  constexpr int VEC = D / 8;

  __shared__ __align__(16) float qsh[TQ][D];  // q * scale, rounded to T
  __shared__ __align__(16) float gsh[TQ][D];
  __shared__ float lsh[TQ];
  __shared__ float dsh[TQ];

  const int bh = blockIdx.y;
  const long long b = bh / H, h = bh % H;
  const int key = blockIdx.x * BKV + threadIdx.x;
  const bool valid = key < S;

  const float scale_t = round_as(scale, q);
  float kf[D], vf[D], dka[D], dva[D];
#pragma unroll
  for (int d = 0; d < D; ++d) kf[d] = vf[d] = dka[d] = dva[d] = 0.f;
  if (valid) {
    const T* kp = k + b * k_sb + key * k_ss + h * k_sh;
    const T* vp = v + b * v_sb + key * v_ss + h * v_sh;
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      load8(kp + 8 * c, kf + 8 * c);
      load8(vp + 8 * c, vf + 8 * c);
    }
  }

  const T* qb = q + b * q_sb + h * q_sh;
  const float* lb = lse + static_cast<long long>(bh) * S;
  const float* db = delta + static_cast<long long>(bh) * S;

  for (int q0 = 0; q0 < S; q0 += TQ) {
    __syncthreads();  // the previous tile has been consumed
    for (int i = threadIdx.x; i < TQ * VEC; i += BKV) {
      const int r = i / VEC, c = (i % VEC) * 8;
      const int row = q0 + r;
      float fq[8], fg[8];
      if (row < S) {
        load8(qb + row * q_ss + c, fq);
        load8(g + ((b * S + row) * H + h) * D + c, fg);
#pragma unroll
        for (int j = 0; j < 8; ++j) fq[j] = round_as(fq[j] * scale_t, q);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) fq[j] = fg[j] = 0.f;
      }
      store8(&qsh[r][c], fq);
      store8(&gsh[r][c], fg);
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
      const float p = ex2(s * LOG2E - lsh[i]);
      const float ds = round_as(p * (dp - dsh[i]), q);
      const float pr = round_as(p, q);
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(&qsh[i][d]);
        const float4 gv = *reinterpret_cast<const float4*>(&gsh[i][d]);
        dka[d] = fmaf(ds, qv.x, dka[d]);
        dka[d + 1] = fmaf(ds, qv.y, dka[d + 1]);
        dka[d + 2] = fmaf(ds, qv.z, dka[d + 2]);
        dka[d + 3] = fmaf(ds, qv.w, dka[d + 3]);
        dva[d] = fmaf(pr, gv.x, dva[d]);
        dva[d + 1] = fmaf(pr, gv.y, dva[d + 1]);
        dva[d + 2] = fmaf(pr, gv.z, dva[d + 2]);
        dva[d + 3] = fmaf(pr, gv.w, dva[d + 3]);
      }
    }
  }

  if (valid) {
    const long long off = ((b * S + key) * H + h) * D;
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      store8(dk + off + 8 * c, dka + 8 * c);
      store8(dv + off + 8 * c, dva + 8 * c);
    }
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, const void* o,
             const void* g, const float* lse, void* dq, void* dk, void* dv,
             float* delta, int B, int S, int H, long long q_sb, long long q_ss,
             long long q_sh, long long k_sb, long long k_ss, long long k_sh,
             long long v_sb, long long v_ss, long long v_sh, float scale,
             cudaStream_t st) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(g);
  flash_bwd_dq_kernel<T, D><<<dim3((S + BQ - 1) / BQ, B * H), BQ, 0, st>>>(
      qp, kp, vp, static_cast<const T*>(o), gp, lse, static_cast<T*>(dq), delta,
      S, H, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<T, D><<<dim3((S + BKV - 1) / BKV, B * H), BKV, 0, st>>>(
      qp, kp, vp, gp, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      S, H, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int D, const void* q, const void* k, const void* v, const void* o,
           const void* g, const float* lse, void* dq, void* dk, void* dv,
           float* delta, int B, int S, int H, long long q_sb, long long q_ss,
           long long q_sh, long long k_sb, long long k_ss, long long k_sh,
           long long v_sb, long long v_ss, long long v_sh, float scale,
           cudaStream_t st) {
  switch (D) {
    case 8:
      return launch_d<T, 8>(q, k, v, o, g, lse, dq, dk, dv, delta, B, S, H, q_sb, q_ss,
                            q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, st);
    case 64:
      return launch_d<T, 64>(q, k, v, o, g, lse, dq, dk, dv, delta, B, S, H, q_sb, q_ss,
                             q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v: [B, S, H, D] addressed by (batch, seq, head) strides in
// elements, D contiguous.  o (the forward's output), g (the output's
// gradient), dq, dk, dv: contiguous [B, S, H, D].  All of one dtype (code
// 0 = f32, 1 = bf16).  lse: the forward's f32 [B, H, S] row log-sum-exp in
// base-2 units; delta: f32 [B, H, S] scratch.  D is 8 or 64; every pointer
// is 16-byte aligned and every stride a multiple of 8 (the caller checks).
// Launches the dq kernel, then the dk/dv kernel, on `stream`; returns the
// first CUDA launch error (0 on success).
extern "C" int phd_flash_attn_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* g,
    const float* lse, void* dq, void* dk, void* dv, float* delta, int dtype,
    int B, int S, int H, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(D, q, k, v, o, g, lse, dq, dk, dv, delta, B, S, H,
                                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                                 v_sh, scale, st);
  if (dtype == 0)
    return launch<float>(D, q, k, v, o, g, lse, dq, dk, dv, delta, B, S, H, q_sb,
                         q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
