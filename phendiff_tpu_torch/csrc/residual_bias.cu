// A ResnetBlock's residual with its convs' biases, for NVIDIA Hopper
// (sm_90a):
//
//   out = x + h + bias (+ bias2)   over NHWC maps [N, C], [C] biases
//
// It replaces no TPU kernel.  Unfused, each conv (F.conv2d on cuDNN) writes
// its output without the bias, ATen adds the [C] bias in a broadcast pass of
// its own (a read and a write of the map), and the block's residual is one
// more ATen add.  Here the convs run bias-free (models/unet2d.py,
// ResnetBlock), and the biases of conv2 and of the 1x1 shortcut ride in the
// residual: one pass that reads x and h and writes out.
//
// Numerics: the sum ((x + h) + bias) + bias2 in f32, in that order, rounded
// once to the maps' dtype (nearest even, as PyTorch rounds), so it equals
// ops/residual_bias.py's plain version bit for bit.
//
// Bound: bytes.  At the DDIM's largest map, (128, 128, 128, 64) in bf16,
// one call reads x and h and writes out: 3 x 268 MB, 0.240 ms at 3.35 TB/s.
// The arithmetic (three f32 adds an element) is far below it.
//
// Design.  A thread takes kUnroll 8-channel vectors (16-byte loads in bf16,
// two in f32) of x and h, kBlock vectors apart so a warp's loads are
// contiguous, and issues all its loads before the first add; a block covers
// kBlock * kUnroll consecutive vectors.  The biases (a few KiB) are read per
// vector through the read-only cache, which keeps them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;  // threads a block
constexpr int kUnroll = 4;   // vectors a thread

// 8 channels as loaded and stored: one 16-byte vector in bf16, two in f32.
template <typename T> struct Pack;
template <> struct Pack<__nv_bfloat16> { uint4 v; };
template <> struct Pack<float> { float4 a, b; };

__device__ __forceinline__ Pack<__nv_bfloat16> load8(const __nv_bfloat16* p) {
  return {__ldg(reinterpret_cast<const uint4*>(p))};
}

__device__ __forceinline__ Pack<float> load8(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  return {__ldg(q), __ldg(q + 1)};
}

__device__ __forceinline__ void unpack(const Pack<__nv_bfloat16>& p, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&p.v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void unpack(const Pack<float>& p, float* f) {
  f[0] = p.a.x; f[1] = p.a.y; f[2] = p.a.z; f[3] = p.a.w;
  f[4] = p.b.x; f[5] = p.b.y; f[6] = p.b.z; f[7] = p.b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ void store8(float* p, const float* f) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(f[0], f[1], f[2], f[3]);
  q[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// x, h, out: [N, C] contiguous; bias, bias2: [C]; nvec =
// N * C / 8 vectors, cvec = C / 8 a row.  TWO: bias2 is added.
template <typename T, bool TWO>
__global__ void __launch_bounds__(kBlock)
residual_bias_kernel(const T* __restrict__ x, const T* __restrict__ h,
                     const T* __restrict__ bias, const T* __restrict__ bias2,
                     T* __restrict__ out, int nvec, int cvec) {
  const int base = blockIdx.x * (kBlock * kUnroll) + threadIdx.x;
  Pack<T> vx[kUnroll], vh[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int v = base + k * kBlock;
    if (v < nvec) {
      vx[k] = load8(x + 8LL * v);
      vh[k] = load8(h + 8LL * v);
    }
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int v = base + k * kBlock;
    if (v < nvec) {
      const int c = 8 * (v % cvec);
      float fx[8], fh[8], fb[8];
      unpack(vx[k], fx);
      unpack(vh[k], fh);
      unpack(load8(bias + c), fb);
#pragma unroll
      for (int j = 0; j < 8; ++j) fx[j] = (fx[j] + fh[j]) + fb[j];
      if (TWO) {
        unpack(load8(bias2 + c), fb);
#pragma unroll
        for (int j = 0; j < 8; ++j) fx[j] += fb[j];
      }
      store8(out + 8LL * v, fx);
    }
  }
}

template <typename T>
int launch(const void* x, const void* h, const void* bias, const void* bias2, void* out,
           int nvec, int cvec, cudaStream_t st) {
  const int grid = (nvec + kBlock * kUnroll - 1) / (kBlock * kUnroll);
  const T* xp = static_cast<const T*>(x);
  const T* hp = static_cast<const T*>(h);
  const T* bp = static_cast<const T*>(bias);
  const T* b2p = static_cast<const T*>(bias2);
  T* op = static_cast<T*>(out);
  if (bias2 == nullptr)
    residual_bias_kernel<T, false><<<grid, kBlock, 0, st>>>(xp, hp, bp, b2p, op, nvec, cvec);
  else
    residual_bias_kernel<T, true><<<grid, kBlock, 0, st>>>(xp, hp, bp, b2p, op, nvec, cvec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, h, out: [rows, C] contiguous and 16-byte aligned, out apart from x
// and h; bias: [C], bias2: [C] or null, 16-byte aligned.  dtype 1: bf16, 0:
// f32, all tensors alike.  C % 8 == 0, C >= 8, rows * C / 8 <= 2^30.
// Returns 0, the CUDA launch error, or -1 for arguments it refuses.
extern "C" int phd_residual_bias(const void* x, const void* h, const void* bias,
                                 const void* bias2, void* out, int dtype, long long rows,
                                 int C, void* stream) {
  if (C % 8 != 0 || C < 8 || rows < 1 || rows * (C / 8) > (1LL << 30) || out == x ||
      out == h)
    return -1;
  const int cvec = C / 8;
  const int nvec = static_cast<int>(rows * cvec);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16>(x, h, bias, bias2, out, nvec, cvec, st);
  return launch<float>(x, h, bias, bias2, out, nvec, cvec, st);
}
