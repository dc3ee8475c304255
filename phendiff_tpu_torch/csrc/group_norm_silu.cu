// Fused GroupNorm + affine + optional SiLU for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_gn_kernel` launched by `_pallas_gn` in
// phendiff_tpu/ops/gn_kernels.py, with the semantics of the XLA path of
// phendiff_tpu/ops/group_norm.py (the TPU default): f32 one-pass moments
// E[x^2] - E[x]^2 per (sample, group), var clamped at 0 (the TPU kernel
// lacks that clamp), ((x - mean) * rsqrt(var + eps)) * scale + bias in f32,
// then SiLU, written in the input dtype.
//
// Design.  The TPU kernel ran one program per sample with the whole
// [S, C] slab in VMEM.  A 128 px level-0 sample is 128*128*192 = 3.1 M
// elements, far beyond a Hopper block, so the reduction is split:
//   1. gn_stats: grid (nsplit, B); each block sums x and x^2 per channel
//      over a contiguous range of rows, f32, and writes one partial per
//      channel (fixed-order sums, no atomics: deterministic);
//   2. gn_finalize: one block per sample combines the nsplit * C/G partials
//      of each group in a fixed order into mean and rstd;
//   3. gn_apply: same grid as 1; reads x once more and writes the output.
// Threads are laid out so that consecutive threads read consecutive
// 16-byte vectors of a row (8 channels each): every load and store is
// coalesced along C, and each thread keeps its 8 channels' coefficients in
// registers.  Group widths C/G that are not a power of two (6, 12) only
// change which group a channel maps to.
//
// Bound.  The work is 2 reads and 1 write of x (the TPU kernel's single
// read cannot carry over: a sample does not fit on chip), against the
// bound of 1 read and 1 write: memory, not arithmetic.
//
// The same file holds the per-channel moments of the moments tool
// (phd_channel_moments): the counterpart of `m_pallas` / `_pallas_kernel`
// in tools/bench_gn_moments.py, f32 sum x and sum x^2 per (sample,
// channel).  The TPU kernel carried f32 accumulators across a sequential
// S-tile grid axis; here pass 1 above (gn_stats) writes per-split partial
// sums from many blocks per sample, and moments_combine adds them in a
// fixed order (deterministic, no atomics).  One read of x bounds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// blockDim.x = (C/8) * R: thread t owns channels 8*(t % (C/8)) .. +7 and
// rows r0 + t / (C/8), stepping by R.
template <typename T>
__global__ void gn_stats(const T* __restrict__ x, float* __restrict__ psum,
                         float* __restrict__ psq, int S, int C,
                         int rows_per_split) {
  extern __shared__ float sh[];  // [2][R][C]
  const int cvn = C / 8;
  const int R = blockDim.x / cvn;
  const int cv = threadIdx.x % cvn, r = threadIdx.x / cvn;
  const int split = blockIdx.x, nsplit = gridDim.x;
  const long long b = blockIdx.y;
  const int s0 = split * rows_per_split;
  const int s1 = min(S, s0 + rows_per_split);

  float sum[8], sq[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) sum[i] = sq[i] = 0.f;
  const T* xb = x + b * S * C + 8 * cv;
  for (int s = s0 + r; s < s1; s += R) {
    float f[8];
    load8(xb + static_cast<long long>(s) * C, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sum[i] += f[i];
      sq[i] = fmaf(f[i], f[i], sq[i]);
    }
  }
  float* ssum = sh;
  float* ssq = sh + R * C;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    ssum[r * C + 8 * cv + i] = sum[i];
    ssq[r * C + 8 * cv + i] = sq[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int rr = 0; rr < R; ++rr) {
      a += ssum[rr * C + c];
      q += ssq[rr * C + c];
    }
    const long long idx = (b * nsplit + split) * C + c;
    psum[idx] = a;
    psq[idx] = q;
  }
}

// grid B, blockDim a multiple of 32: warp w reduces groups w, w + nwarps, ...
__global__ void gn_finalize(const float* __restrict__ psum,
                            const float* __restrict__ psq,
                            float* __restrict__ mean, float* __restrict__ rstd,
                            int nsplit, int S, int C, int G, float eps) {
  const long long b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const int cg = C / G;
  const int n = nsplit * cg;
  const float count = static_cast<float>(S) * cg;
  for (int g = warp; g < G; g += nwarps) {
    float a = 0.f, q = 0.f;
    for (int i = lane; i < n; i += 32) {
      const int sp = i / cg, c = g * cg + i % cg;
      const long long idx = (b * nsplit + sp) * C + c;
      a += psum[idx];
      q += psq[idx];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      q += __shfl_xor_sync(0xffffffffu, q, off);
    }
    if (lane == 0) {
      const float mu = a / count;
      const float var = fmaxf(q / count - mu * mu, 0.f);
      mean[b * G + g] = mu;
      rstd[b * G + g] = rsqrtf(var + eps);
    }
  }
}

// grid B: out[b, c] = sum over splits, in split order, of the partials.
__global__ void moments_combine(const float* __restrict__ psum,
                                const float* __restrict__ psq,
                                float* __restrict__ out_sum,
                                float* __restrict__ out_sq, int nsplit, int C) {
  const long long b = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const long long idx = (b * nsplit + sp) * C + c;
      a += psum[idx];
      q += psq[idx];
    }
    out_sum[b * C + c] = a;
    out_sq[b * C + c] = q;
  }
}

template <typename T, bool SILU>
__global__ void gn_apply(const T* __restrict__ x,
                         const float* __restrict__ mean,
                         const float* __restrict__ rstd,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias, T* __restrict__ out,
                         int S, int C, int G, int rows_per_split) {
  const int cvn = C / 8;
  const int R = blockDim.x / cvn;
  const int cv = threadIdx.x % cvn, r = threadIdx.x / cvn;
  const long long b = blockIdx.y;
  const int s0 = blockIdx.x * rows_per_split;
  const int s1 = min(S, s0 + rows_per_split);
  const int cg = C / G;

  float mu[8], rs[8], sc[8], bi[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = 8 * cv + i;
    const int g = c / cg;
    mu[i] = mean[b * G + g];
    rs[i] = rstd[b * G + g];
    sc[i] = scale[c];
    bi[i] = bias[c];
  }
  const long long base = b * S * C + 8 * cv;
  for (int s = s0 + r; s < s1; s += R) {
    const long long off = base + static_cast<long long>(s) * C;
    float f[8];
    load8(x + off, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float y = (f[i] - mu[i]) * rs[i];
      y = y * sc[i] + bi[i];
      if (SILU) y = y / (1.f + __expf(-y));
      f[i] = y;
    }
    store8(out + off, f);
  }
}

template <typename T>
void launch_apply(bool silu, dim3 grid, int threads, cudaStream_t st,
                  const void* x, const float* mean, const float* rstd,
                  const float* scale, const float* bias, void* out, int S,
                  int C, int G, int rows_per_split) {
  if (silu)
    gn_apply<T, true><<<grid, threads, 0, st>>>(
        static_cast<const T*>(x), mean, rstd, scale, bias,
        static_cast<T*>(out), S, C, G, rows_per_split);
  else
    gn_apply<T, false><<<grid, threads, 0, st>>>(
        static_cast<const T*>(x), mean, rstd, scale, bias,
        static_cast<T*>(out), S, C, G, rows_per_split);
}

// The statistics pass's launch shape: blockDim = (C/8) * R threads, R rows
// of 8-channel vectors in flight, and its shared memory.
struct StatsShape {
  int threads, rows_per_split;
  size_t smem;
};

StatsShape stats_shape(int S, int C, int nsplit) {
  const int cvn = C / 8;
  const int R = cvn >= 256 ? 1 : 256 / cvn;
  return {cvn * R, (S + nsplit - 1) / nsplit, 2 * sizeof(float) * static_cast<size_t>(R) * C};
}

int launch_stats(const void* x, int dtype, float* psum, float* psq, int B,
                 int S, int C, int nsplit, cudaStream_t st) {
  const StatsShape sh = stats_shape(S, C, nsplit);
  const dim3 grid(nsplit, B);
  if (dtype == 1)
    gn_stats<__nv_bfloat16><<<grid, sh.threads, sh.smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), psum, psq, S, C, sh.rows_per_split);
  else
    gn_stats<float><<<grid, sh.threads, sh.smem, st>>>(
        static_cast<const float*>(x), psum, psq, S, C, sh.rows_per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [B, S, C] contiguous, dtype code 0 = f32, 1 = bf16; out: [B, S, C]
// contiguous in the same dtype; scale, bias: f32 [C].  workspace:
// f32, 2 * B * nsplit * C + 2 * B * G elements.  C is a multiple of 8 and
// of G, C / 8 <= 1024, pointers are 16-byte aligned (the caller checks).
// Returns the first CUDA launch error (0 on success).
extern "C" int phd_group_norm_silu(const void* x, int dtype,
                                   const float* scale, const float* bias,
                                   void* out, float* workspace,
                                   int B, int S, int C, int G, float eps,
                                   int silu, int nsplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const StatsShape sh = stats_shape(S, C, nsplit);
  float* psum = workspace;
  float* psq = psum + static_cast<long long>(B) * nsplit * C;
  float* mean = psq + static_cast<long long>(B) * nsplit * C;
  float* rstd = mean + static_cast<long long>(B) * G;
  const dim3 grid(nsplit, B);

  int err = launch_stats(x, dtype, psum, psq, B, S, C, nsplit, st);
  if (err != 0) return err;

  gn_finalize<<<B, 256, 0, st>>>(psum, psq, mean, rstd, nsplit, S, C, G, eps);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  const bool s = silu != 0;
  if (dtype == 1)
    launch_apply<__nv_bfloat16>(s, grid, sh.threads, st, x, mean, rstd, scale, bias, out, S, C, G, sh.rows_per_split);
  else
    launch_apply<float>(s, grid, sh.threads, st, x, mean, rstd, scale, bias, out, S, C, G, sh.rows_per_split);
  return static_cast<int>(cudaGetLastError());
}

// Per-channel moments: x as above; out_sum, out_sq: f32 [B, C]; workspace:
// f32, 2 * B * nsplit * C elements.  Same constraints on C and alignment.
// Returns the first CUDA launch error (0 on success).
extern "C" int phd_channel_moments(const void* x, int dtype, float* workspace,
                                   float* out_sum, float* out_sq, int B, int S,
                                   int C, int nsplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* psum = workspace;
  float* psq = psum + static_cast<long long>(B) * nsplit * C;
  const int err = launch_stats(x, dtype, psum, psq, B, S, C, nsplit, st);
  if (err != 0) return err;
  moments_combine<<<B, 256, 0, st>>>(psum, psq, out_sum, out_sq, nsplit, C);
  return static_cast<int>(cudaGetLastError());
}
