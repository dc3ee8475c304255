// Fused gated residual + LayerNorm + adaLN modulate at a DiT block's
// sub-layer boundary, for NVIDIA Hopper (sm_90a).
//
// For rows of x [B, S, C] and per-sample rows gate, shift, scale1p [B, C]:
//
//   x' = x + gate * y                     (written out where asked)
//   z  = LayerNorm(x') * scale1p + shift  (no affine, biased variance)
//
// It replaces no TPU kernel: the JAX package has no DiT.  A DiT block is
// x + gate * f(LN(x) * (1 + scale) + shift) twice, and unfused that is three
// memory-bound ops at each boundary (addcmul, layer_norm, addcmul) moving 7
// activations; x' is the tensor the next LayerNorm reads and the normed
// value goes only to the modulate, so one pass reads x and y and writes x'
// and z: 4 activations, one launch.  Variants: without y (the first block's
// norm: x' = x, nothing written but z), and without writing x' (the last
// boundary, whose z alone goes on to the final layer).
//
// Numerics: the same mathematics at the tensors' precision with fewer
// roundings.  x' is formed in f32 as addcmul forms it and rounded once to
// x's dtype; the statistics are taken in f32 over that stored x' (two passes
// over registers: the mean, then the centred squares), so the residual
// stream and the normed branch see the same values; z is rounded once, not
// after the norm and again after the modulate.
//
// Bound: bytes.  At DiT-XL/2's (32, 1024, 1152) in bf16 one call moves
// 4 x 75.5 MB, 90 us at 3.35 TB/s; the arithmetic (~10 f32 operations an
// element) is far below it.
//
// Design.  A warp owns a row: lane l holds the row's 8-channel vectors l,
// l + 32, ... (16-byte loads in bf16, two in f32) in registers, VPL of them
// (5 at C = 1152), so x and y are read from HBM once and x' stays on chip
// between the statistics and the normalisation; both sums are warp shuffles,
// with no shared memory and no block barrier.  A block of 8 warps takes
// rows_per_warp rows of one sample a warp (ops/adaln_norm.py: 2, so 2048
// blocks at DiT-XL/2's shape, several waves), the 8 warps on consecutive
// rows;
// the [B, C] rows of its sample (any row stride, so the unbind views of the
// [B, 6, C] modulation are read in place) come through L1, which the
// block's warps share.  Rows of 1152 bf16 hold 144 vectors: lanes 16-31
// take 4, lanes 0-15 take 5.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;      // warps a block
// vectors of 8 channels a lane: C <= 1280, DiT-S/B/L/XL's 384-1152; wider
// rows want more instantiations (and fewer blocks an SM)
constexpr int kMaxVpl = 5;

// Blocks an SM asks of the register allocation.  Four (64 registers a
// thread, 32 warps an SM) where a lane's x and y take at most 40 registers
// (bf16 at every width here, f32 to C = 512): at DiT-XL/2's shape that read
// 80% of the byte bound against 76% with the compiler's own choice of 117
// registers (H100 80GB HBM3).  Wider f32 rows ask for fewer, so their x and
// y do not spill.
template <typename T, int VPL>
constexpr int min_blocks() {
  return VPL * sizeof(T) <= 10 ? 4 : VPL * sizeof(T) <= 16 ? 2 : 1;
}

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

// Rounded to T (nearest even, as PyTorch rounds).
template <typename T> __device__ __forceinline__ Pack<T> pack(const float* f);

template <> __device__ __forceinline__ Pack<__nv_bfloat16> pack<__nv_bfloat16>(const float* f) {
  Pack<__nv_bfloat16> p;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&p.v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return p;
}

template <> __device__ __forceinline__ Pack<float> pack<float>(const float* f) {
  return {make_float4(f[0], f[1], f[2], f[3]), make_float4(f[4], f[5], f[6], f[7])};
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const Pack<__nv_bfloat16>& v) {
  *reinterpret_cast<uint4*>(p) = v.v;
}

__device__ __forceinline__ void store8(float* p, const Pack<float>& v) {
  reinterpret_cast<float4*>(p)[0] = v.a;
  reinterpret_cast<float4*>(p)[1] = v.b;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// x, y, x_out, z: [B, S, C] contiguous; gate, shift, scale1p: row b at
// b * its stride, channels contiguous.  HAS_Y false: x' = x; WRITE_X false:
// x' is not written.
template <typename T, int VPL, bool HAS_Y, bool WRITE_X>
__global__ void __launch_bounds__(kWarps * 32, (min_blocks<T, VPL>()))
adaln_norm_kernel(const T* __restrict__ x, const T* __restrict__ y,
                  const T* __restrict__ gate, const T* __restrict__ shift,
                  const T* __restrict__ scale1p, long long gate_stride,
                  long long shift_stride, long long scale_stride, T* __restrict__ x_out,
                  T* __restrict__ z, int S, int C, int rows_per_warp, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const T* g_row = HAS_Y ? gate + b * gate_stride : nullptr;
  const T* sh_row = shift + b * shift_stride;
  const T* sc_row = scale1p + b * scale_stride;
  const float inv_c = 1.0f / static_cast<float>(C);
  for (int k = 0; k < rows_per_warp; ++k) {
    const int s = (blockIdx.x * rows_per_warp + k) * kWarps + warp;
    if (s >= S) break;
    const long long row = (static_cast<long long>(b) * S + s) * C;
    Pack<T> v[VPL];
    float sum = 0.0f;
    if (HAS_Y) {
      Pack<T> w[VPL];
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int c = 8 * (lane + 32 * i);
        if (c < C) {
          v[i] = load8(x + row + c);
          w[i] = load8(y + row + c);
        }
      }
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int c = 8 * (lane + 32 * i);
        if (c < C) {
          float fx[8], fy[8], fg[8];
          unpack(v[i], fx);
          unpack(w[i], fy);
          unpack(load8(g_row + c), fg);
          // addcmul's f32 fma(gate, y, x), rounded once to T
#pragma unroll
          for (int j = 0; j < 8; ++j) fx[j] = fmaf(fg[j], fy[j], fx[j]);
          v[i] = pack<T>(fx);
          if (WRITE_X) store8(x_out + row + c, v[i]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int c = 8 * (lane + 32 * i);
        if (c < C) v[i] = load8(x + row + c);
      }
    }
    // statistics over the stored x'
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      if (8 * (lane + 32 * i) < C) {
        float f[8];
        unpack(v[i], f);
#pragma unroll
        for (int j = 0; j < 8; ++j) sum += f[j];
      }
    }
    const float mean = warp_sum(sum) * inv_c;
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      if (8 * (lane + 32 * i) < C) {
        float f[8];
        unpack(v[i], f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = f[j] - mean;
          sq = fmaf(d, d, sq);
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_c + eps);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = 8 * (lane + 32 * i);
      if (c < C) {
        float f[8], fs[8], fc[8];
        unpack(v[i], f);
        unpack(load8(sh_row + c), fs);
        unpack(load8(sc_row + c), fc);
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = fmaf((f[j] - mean) * rstd, fc[j], fs[j]);
        store8(z + row + c, pack<T>(f));
      }
    }
  }
}

template <typename T, int VPL>
int launch_vpl(const void* x, const void* y, const void* gate, const void* shift,
               const void* scale1p, long long gate_stride, long long shift_stride,
               long long scale_stride, void* x_out, void* z, int B, int S, int C,
               int rows_per_warp, float eps, cudaStream_t st) {
  const dim3 grid((S + kWarps * rows_per_warp - 1) / (kWarps * rows_per_warp), B);
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  const T* gp = static_cast<const T*>(gate);
  const T* shp = static_cast<const T*>(shift);
  const T* scp = static_cast<const T*>(scale1p);
  T* xo = static_cast<T*>(x_out);
  T* zp = static_cast<T*>(z);
  if (y == nullptr)
    adaln_norm_kernel<T, VPL, false, false><<<grid, kWarps * 32, 0, st>>>(
        xp, yp, gp, shp, scp, gate_stride, shift_stride, scale_stride, xo, zp, S, C,
        rows_per_warp, eps);
  else if (x_out == nullptr)
    adaln_norm_kernel<T, VPL, true, false><<<grid, kWarps * 32, 0, st>>>(
        xp, yp, gp, shp, scp, gate_stride, shift_stride, scale_stride, xo, zp, S, C,
        rows_per_warp, eps);
  else
    adaln_norm_kernel<T, VPL, true, true><<<grid, kWarps * 32, 0, st>>>(
        xp, yp, gp, shp, scp, gate_stride, shift_stride, scale_stride, xo, zp, S, C,
        rows_per_warp, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* y, const void* gate, const void* shift,
           const void* scale1p, long long gate_stride, long long shift_stride,
           long long scale_stride, void* x_out, void* z, int B, int S, int C,
           int rows_per_warp, float eps, cudaStream_t st) {
  // the fewest vectors a lane that hold a row
  const int need = (C / 8 + 31) / 32;
#define PHD_ADALN_VPL(n)                                                                   \
  if (need == n)                                                                           \
    return launch_vpl<T, n>(x, y, gate, shift, scale1p, gate_stride, shift_stride,         \
                            scale_stride, x_out, z, B, S, C, rows_per_warp, eps, st);
  PHD_ADALN_VPL(1) PHD_ADALN_VPL(2) PHD_ADALN_VPL(3) PHD_ADALN_VPL(4) PHD_ADALN_VPL(5)
#undef PHD_ADALN_VPL
  return -1;
}

}  // namespace

// x: [B, S, C] contiguous, 16-byte aligned; y: as x, or null (x' = x);
// gate (ignored without y), shift, scale1p: [B, C] rows at the given row
// strides in elements, channels contiguous, each row 16-byte aligned;
// x_out: [B, S, C] for x', or null (not written; null without y); z:
// [B, S, C].  dtype 1: bf16, 0: f32, all tensors alike.  C % 8 == 0,
// 8 <= C <= 1280, 1 <= B <= 65535, rows_per_warp >= 1.  Returns 0, the CUDA
// launch error, or -1 for arguments it refuses.
extern "C" int phd_adaln_norm(const void* x, const void* y, const void* gate,
                              const void* shift, const void* scale1p, long long gate_stride,
                              long long shift_stride, long long scale_stride, void* x_out,
                              void* z, int dtype, int B, int S, int C, int rows_per_warp,
                              float eps, void* stream) {
  if (C % 8 != 0 || C < 8 || C > 8 * 32 * kMaxVpl || B < 1 || B > 65535 || S < 1 ||
      rows_per_warp < 1 || (y == nullptr && x_out != nullptr) ||
      (y != nullptr && gate == nullptr))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, gate, shift, scale1p, gate_stride, shift_stride,
                                 scale_stride, x_out, z, B, S, C, rows_per_warp, eps, st);
  return launch<float>(x, y, gate, shift, scale1p, gate_stride, shift_stride, scale_stride,
                       x_out, z, B, S, C, rows_per_warp, eps, st);
}
