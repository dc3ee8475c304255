// Fused GroupNorm + affine + optional SiLU for NVIDIA Hopper (sm_90a):
// forward and backward kernels on thread-block clusters.
//
// The forward replaces the TPU kernel `_gn_kernel` launched by `_pallas_gn`
// in phendiff_tpu/ops/gn_kernels.py, with the semantics of the XLA path of
// phendiff_tpu/ops/group_norm.py (the TPU default): f32 one-pass moments
// E[x^2] - E[x]^2 per (sample, group), var clamped at 0 (the TPU kernel
// lacks that clamp), ((x - mean) * rsqrt(var + eps)) * scale + bias in f32,
// then SiLU, written in the input dtype.  It also writes each (sample,
// group)'s mean and rstd for the backward.
//
// The backward is the closed form of the gradient of that function (the TPU
// package recomputes its XLA reference under jax.vjp instead), with the
// saved mean mu and rstd r: x^ = (x - mu) r, z = scale x^ + bias,
// dz = g sigma(z) (1 + z (1 - sigma(z))) with SiLU (else g), per (sample,
// channel) A = sum_s dz and B = sum_s dz x^, per (sample, group)
// a = sum_c scale_c A_c / N and b = sum_c scale_c B_c / N with N = S C/G,
// dx = r (scale dz - a - x^ b) in x's dtype, dbias = sum_b A and
// dscale = sum_b B in f32.
//
// Bound.  Both are memory-bound: the forward moves one read of x and one
// write of the output, the backward one read of x and g and one write of
// dx; their arithmetic (~10 and ~20 f32 operations an element) takes a
// fraction of that time.  So each reads its inputs from HBM once, as the
// TPU kernel's single read into VMEM did.
//
// Design.  A whole sample does not fit on chip, but a tile of one sample
// and a slice of cb channels holding whole groups does: groups partition
// the channels, so a tile's statistics need nothing from outside it.  The
// tile's S rows are split over the k blocks of a thread-block cluster
// (cluster dims (k, 1, 1), grid (k * C / cb, B)).  Thread 0 of each block
// asks the TMA unit for all its rows x cb at once, in boxes of up to 256
// rows, each completing on its own mbarrier; the threads sum x and x^2 per
// channel in f32 box by box as the boxes land, and the k blocks combine
// their partial sums through distributed shared memory in rank order, so
// every block holds the same totals and two calls give the same bits.  Each
// block then normalises its slice from shared memory and writes it out: one
// read, one write.  Threads own 8 channels (a 16-byte bf16 vector) of a
// row: lane l of a warp takes vector l % (cb/8) of rows stepping by the
// warp's row count, so its channels' coefficients stay in registers and a
// warp's shuffles reduce the rows that share them.  The per-element work is
// a few FMAs and, with SiLU, one fast exp and one fast reciprocal.
//
// The forward optionally normalises x + a, with a [B, C] per (sample,
// channel) (a ResnetBlock's time embedding), so the caller need not write
// the broadcast sum to HBM and read it back.  A block holds one sample, so a
// thread loads its 8 channels of a once, and the statistics pass adds them
// as it reads each row, rounds the sum to the input's dtype (as PyTorch's add
// would) and writes it back over x in the tile, for the normalising pass to
// read unchanged.  Entries without an addend run the kernel compiled without
// it (template flag ADD).
//
// The backward (gn_bwd_cluster) holds x and g the same way, one launch a
// call, and is shaped by three limits the H100 showed (PERF.md):
// - Residency.  Its per-channel constants live in shared memory (ka = rs
//   scale and zb with z = x ka + zb, then the dx coefficients kb, kc with
//   dx = ka dz + kb x + kc), not in a thread's registers, and the sums run
//   on x itself (B = rs sum dz x + nmr sum dz), so it asks for three 256-
//   thread blocks an SM (80 registers a thread, no spill): shared memory,
//   not registers, sets how many blocks an SM holds.  (A cluster of 8
//   blocks that each take over a third of an SM's shared memory splits
//   again into 16 blocks of 128 threads, as gn_plan measured best.)
// - Small maps.  Where one sample's tile fits a block (k = 1), a block takes
//   nb whole samples of its channel slice: nb * S consecutive rows of the
//   [B*S, C] maps in the same TMA boxes, nb chosen so a call's blocks fit one
//   wave (ops/gn_kernels.py::gn_plan).  Warps split over the samples; a
//   sample of at most 8 rows is summed by one thread a vector, with no lanes
//   to combine.  The fixed chain of a block (TMA, barriers, coefficients,
//   ticket) is paid once for nb samples, not once a (sample, slice).
// - The batch reduction.  dbias and dscale add over the batch: each block
//   sums its samples in order, and the last block of a channel slice to
//   post its partial (an atomic ticket, one fencing thread) adds the
//   blocks' partials in order with all its threads, lanes taking runs of
//   blocks (ordered_sum); no float atomics, so calls are bit-equal.
// Large maps keep the cluster split of one sample's rows (nb = 1), whose
// partial sums meet through distributed shared memory, every block's
// values read at once.  What still holds them back: at large maps a
// cluster waits at its barrier for its slowest block's loads, and the
// blocks' loads, sums and dx writes overlap only across blocks; with SiLU,
// dz is computed twice (4 special-function operations an element), and at
// small maps a block's fixed chain (several microseconds on an H100) sets
// the time.
//
// The same file holds the per-channel moments of the moments tool
// (phd_channel_moments): the counterpart of `m_pallas` / `_pallas_kernel`
// in tools/bench_gn_moments.py, f32 sum x and sum x^2 per (sample,
// channel).  The TPU kernel carried f32 accumulators across a sequential
// S-tile grid axis; here gn_stats writes per-split partial sums from many
// blocks per sample, and moments_combine adds them in a fixed order
// (deterministic, no atomics).  One read of x bounds it.
//
// Maps whose tile does not fit a 16-block cluster take the streaming
// variant (phd_gn_stream_fwd, phd_gn_stream_bwd, at the end of the file):
// split statistics, a fixed-order combine, and a second read of x (and g)
// that normalises (or writes dx).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 232448;  // 227 KB: the most a Hopper block can use
constexpr int kMaxCluster = 16;   // above 8 needs the non-portable attribute
constexpr int kMaxTileChannels = 256;  // cb / 8 vectors of a row fit a warp

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

// ---- cluster tiles --------------------------------------------------------

constexpr int kBoxRows = 256;  // the most rows a TMA box may have
constexpr int kMaxBoxes = 64;  // mbarriers a block keeps, one per box

// A block's rows arrive in TMA boxes of up to 256 rows, and its tile has
// room for whole boxes (rows past its own are loaded and not used).
__host__ __device__ inline int box_rows(int rpb) { return rpb < kBoxRows ? rpb : kBoxRows; }

__host__ __device__ inline int alloc_rows(int rpb) {
  const int box = box_rows(rpb);
  return (rpb + box - 1) / box * box;
}

// Bytes of one tile (x or g) of a block, 128-byte aligned for TMA.
__host__ __device__ inline size_t tile_bytes(int rpb, int cb, int esize) {
  return (static_cast<size_t>(alloc_rows(rpb)) * cb * esize + 127) / 128 * 128;
}

// Shared memory of one forward block: its tile, then f32 scratch
// red[2][nwarps][cb], part[2][cb], tot[2][cb], coef[2][cb], then 16 bytes
// and one mbarrier per box.  ops/gn_kernels.py::_smem_bytes computes the
// same.
__host__ __device__ inline size_t smem_bytes(int rpb, int cb, int esize, int threads) {
  return tile_bytes(rpb, cb, esize) +
         sizeof(float) * (2 * (threads / 32) * cb + 6 * cb) + 16 + 8 * kMaxBoxes;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@p bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

// Start loading the block's tiles (xs, and gs unless null): nbox TMA boxes
// of `box` rows from row row0 of the [B*S, C] maps tx (and tg), channels
// c0 .. c0 + cb - 1; box i completes on mbarrier bars[i].  Thread 0 issues
// every box at once; the others return at once.  The caller passes a
// __syncthreads before any thread waits (mbar_wait) on the boxes of the rows
// it reads, so the barriers exist.
template <typename T>
__device__ void start_tiles(const CUtensorMap* tx, const CUtensorMap* tg, T* xs, T* gs,
                            long long row0, int c0, int box, int nbox, int cb, uint64_t* bars) {
  if (threadIdx.x == 0) {
    const unsigned box_bytes = box * cb * static_cast<unsigned>(sizeof(T));
    for (int i = 0; i < nbox; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bars + i))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int i = 0; i < nbox; ++i) {
      const unsigned bar = smem_u32(bars + i);
      const int row = static_cast<int>(row0) + i * box;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(box_bytes * (gs ? 2u : 1u))
                   : "memory");
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(xs) + i * box_bytes),
          "l"(reinterpret_cast<uint64_t>(tx)), "r"(c0), "r"(row), "r"(bar)
          : "memory");
      if (gs)
        asm volatile(
            "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(gs) + i * box_bytes),
            "l"(reinterpret_cast<uint64_t>(tg)), "r"(c0), "r"(row), "r"(bar)
            : "memory");
    }
  }
}

// Before the block exits: every box has landed (a box no thread read may
// still be in flight, and shared memory must outlive it).
__device__ __forceinline__ void finish_tiles(int nbox, uint64_t* bars) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < nbox; ++i) mbar_wait(smem_u32(bars + i), 0);
  }
}

// Split cluster barrier: arrive once this block no longer reads the others'
// shared memory, wait before it exits (a block's shared memory must outlive
// every remote read of it).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// dst(v, sum over q < n of src(q, v)) for v < m, each sum in a fixed order:
// `lanes` threads a value, lane l adding a run of consecutive q in order,
// then the lanes' partials in order (scratch: m * lanes floats).  The runs'
// loads are in flight together, where one thread a value would wait on them
// one after another.
template <typename Src, typename Dst>
__device__ void ordered_sum(int m, int n, int lanes, const Src& src, float* scratch,
                            const Dst& dst) {
  const int run = (n + lanes - 1) / lanes;
  for (int t = threadIdx.x; t < m * lanes; t += blockDim.x) {
    const int v = t / lanes, l = t - v * lanes, end = min(n, (l + 1) * run);
    float acc = 0.f;
#pragma unroll 4
    for (int q = l * run; q < end; ++q) acc += src(q, v);
    scratch[t] = acc;
  }
  __syncthreads();
  for (int v = threadIdx.x; v < m; v += blockDim.x) {
    float acc = 0.f;
    for (int l = 0; l < lanes; ++l) acc += scratch[v * lanes + l];
    dst(v, acc);
  }
}

// After the block's writes: one atomic ticket from *counter, for every
// thread.  Thread 0 fences after the block's barrier (a fence is cumulative
// over the writes the barrier ordered before it) and again after the atomic,
// so the last block to take a ticket reads every block's writes.
__device__ __forceinline__ unsigned take_ticket(unsigned* counter, unsigned* ticket) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    *ticket = atomicAdd(counter, 1u);
    __threadfence();
  }
  __syncthreads();
  return *ticket;
}

// The most lanes (a power of two, at most `most`) that m values can take
// in one pass of the block's threads.
__device__ __forceinline__ int sum_lanes(int m, int most) {
  int lanes = 1;
  while (2 * lanes <= most && 2 * lanes * m <= static_cast<int>(blockDim.x)) lanes *= 2;
  return lanes;
}

// Which vector of which rows a thread owns: lane l < V * P of each warp
// takes vector v = l % V (channels 8v .. 8v+7 of the tile) of rows
// row0, row0 + rstep, ...; V = cb / 8 vectors a row, P = 32 / V rows a warp.
struct VecMap {
  int V, P, j, v, row0, rstep;
  bool active;
};

__device__ __forceinline__ VecMap vec_map(int cb) {
  VecMap m;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  m.V = cb / 8;
  m.P = 32 / m.V;
  m.j = lane / m.V;
  m.v = lane - m.j * m.V;
  m.active = lane < m.V * m.P;
  m.row0 = warp * m.P + m.j;
  m.rstep = (blockDim.x >> 5) * m.P;
  return m;
}

// Sum over the P lanes of a warp that share vector v (lanes v + V * j), in
// a fixed tree order; lane v (j = 0) ends with the sum.
__device__ __forceinline__ float warp_rows_sum(float val, const VecMap& m) {
  for (int d = 1; d < m.P; d <<= 1) {
    const float o = __shfl_down_sync(0xffffffffu, val, d * m.V);
    if (m.j + d < m.P) val += o;
  }
  return val;
}

// The same for eight values at once, their shuffles issued together.
__device__ __forceinline__ void warp_rows_sum8(float (&v)[8], const VecMap& m) {
  for (int d = 1; d < m.P; d <<= 1) {
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = __shfl_down_sync(0xffffffffu, v[i], d * m.V);
    if (m.j + d < m.P) {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] += o[i];
    }
  }
}

// Two per-thread 8-channel partials (a, q) summed over the block's rows,
// then over the cluster's blocks in rank order.  Every block of the cluster
// ends with the tile's totals in tot[0][cb] (a) and tot[1][cb] (q).  Arrives
// at the split cluster barrier; the caller waits before it exits.
__device__ void tile_sums(cg::cluster_group& cluster, const float (&a)[8],
                          const float (&q)[8], const VecMap& m, int cb, float* red,
                          float* part, float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  float ra[8], rq[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    ra[i] = warp_rows_sum(m.active ? a[i] : 0.f, m);
    rq[i] = warp_rows_sum(m.active ? q[i] : 0.f, m);
  }
  if (lane < m.V) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      red[warp * cb + 8 * lane + i] = ra[i];
      red[(nwarps + warp) * cb + 8 * lane + i] = rq[i];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 2 * cb; t += blockDim.x) {
    const int which = t / cb, c = t - which * cb;
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += red[(which * nwarps + w) * cb + c];
    part[t] = s;
  }
  cluster.sync();
  const int k = static_cast<int>(cluster.num_blocks());
  for (int t = threadIdx.x; t < 2 * cb; t += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < k; ++r) s += cluster.map_shared_rank(part, r)[t];
    tot[t] = s;
  }
  cluster_arrive();
  __syncthreads();
}

// SiLU with a fast exp and reciprocal: y / (1 + e^-y), 0 where e^-y
// overflows.
__device__ __forceinline__ float silu(float y) { return __fdividef(y, 1.f + __expf(-y)); }

// A thread's 8 channels of the addend, as loaded: 16 bytes of bf16 or 32 of
// f32.
template <typename T>
struct Addend8 {
  uint4 v[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ Addend8<T> load_addend8(const T* p) {
  Addend8<T> a;
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T)) / 2; ++i)
    a.v[i] = reinterpret_cast<const uint4*>(p)[i];
  return a;
}

// x + a rounded to T, as PyTorch's add of two T tensors rounds it, written
// back over x in the tile (the normalising pass reads it there) and returned
// in f as f32.  bf16: packed bf16 adds, which round the exact sum once;
// PyTorch rounds the f32 sum, whose 24 bits are more than twice bf16's 8 + 2,
// and so lands on the same value.
__device__ __forceinline__ void add_in_place8(__nv_bfloat16* p, const Addend8<__nv_bfloat16>& a,
                                              float* f) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
  const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&a.v[0]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __hadd2(h[i], ha[i]);
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void add_in_place8(float* p, const Addend8<float>& a, float* f) {
  load8(p, f);
  const float* fa = reinterpret_cast<const float*>(a.v);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] += fa[i];
  store8(p, f);
}

// With ADD, the kernel normalises x + addend[b, c] (addend: [B, C] in T)
// instead of x: each thread keeps its 8 channels' addend in registers, and
// the statistics pass writes the sum, rounded to T, over x in the tile, so
// the normalising pass is the same and the sum never reaches HBM.
template <typename T, bool SILU, bool ADD>
__global__ void __launch_bounds__(kMaxThreads)
gn_fwd_cluster(const __grid_constant__ CUtensorMap tx, const T* __restrict__ addend,
               const float* __restrict__ scale, const float* __restrict__ bias,
               T* __restrict__ out, float* __restrict__ mean_out,
               float* __restrict__ rstd_out, int S, int C, int G, int cb, int rpb, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int c0 = static_cast<int>(blockIdx.x) / k * cb;
  const long long b = blockIdx.y;
  const int r0 = rank * rpb;
  const int rows = max(0, min(S - r0, rpb));
  const int gw = C / G;
  const int box = box_rows(rpb);
  T* xs = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + tile_bytes(rpb, cb, sizeof(T)));
  float* part = red + 2 * (blockDim.x >> 5) * cb;
  float* tot = part + 2 * cb;
  float* coef = tot + 2 * cb;
  uint64_t* bars = reinterpret_cast<uint64_t*>(coef + 2 * cb) + 2;

  start_tiles<T>(&tx, nullptr, xs, nullptr, b * S + r0, c0, box, alloc_rows(rpb) / box, cb, bars);
  __syncthreads();

  // sums of x and x^2 per channel, box by box as the boxes land
  const VecMap m = vec_map(cb);
  Addend8<T> a8;
  if constexpr (ADD) {
    if (m.active) a8 = load_addend8(addend + b * C + c0 + 8 * m.v);
  }
  float s[8], q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = q[i] = 0.f;
  if (m.active) {
    int landed = -1;
    for (int r = m.row0; r < rows; r += m.rstep) {
      if (r / box != landed) {
        landed = r / box;
        mbar_wait(smem_u32(bars + landed), 0);
      }
      float f[8];
      if constexpr (ADD)
        add_in_place8(xs + r * cb + 8 * m.v, a8, f);
      else
        load8(xs + r * cb + 8 * m.v, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[i] += f[i];
        q[i] = fmaf(f[i], f[i], q[i]);
      }
    }
  }
  tile_sums(cluster, s, q, m, cb, red, part, tot);

  // per channel: its group's mean and rstd, from the group's channels in
  // order, folded with the affine into y = x * mul + add
  const float count = static_cast<float>(S) * gw;
  for (int c = threadIdx.x; c < cb; c += blockDim.x) {
    const int first = c - c % gw;
    float a = 0.f, qq = 0.f;
    for (int i = 0; i < gw; ++i) {
      a += tot[first + i];
      qq += tot[cb + first + i];
    }
    const float mu = a / count;
    const float var = fmaxf(qq / count - mu * mu, 0.f);
    const float rs = rsqrtf(var + eps);
    const float mul = rs * scale[c0 + c];
    coef[c] = mul;
    coef[cb + c] = fmaf(-mu, mul, bias[c0 + c]);
    if (rank == 0 && c == first) {
      const long long gi = b * G + (c0 + c) / gw;
      mean_out[gi] = mu;
      rstd_out[gi] = rs;
    }
  }
  __syncthreads();

  if (m.active) {
    float mul[8], add[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      mul[i] = coef[8 * m.v + i];
      add[i] = coef[cb + 8 * m.v + i];
    }
    T* ob = out + (b * S + r0) * C + c0 + 8 * m.v;
#pragma unroll 2
    for (int r = m.row0; r < rows; r += m.rstep) {
      float f[8];
      load8(xs + r * cb + 8 * m.v, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float y = fmaf(f[i], mul[i], add[i]);
        f[i] = SILU ? silu(y) : y;
      }
      store8(ob + static_cast<long long>(r) * C, f);
    }
  }
  finish_tiles(alloc_rows(rpb) / box, bars);
  cluster_wait();
}

// dL/dz of the affine output z = scale x^ + bias, from the output gradient.
template <bool SILU>
__device__ __forceinline__ float grad_z(float g, float xh, float sc, float bi) {
  if (!SILU) return g;
  const float z = fmaf(xh, sc, bi);
  const float sg = __fdividef(1.f, 1.f + __expf(-z));
  return g * sg * fmaf(z, 1.f - sg, 1.f);
}

// The same from z itself.
template <bool SILU>
__device__ __forceinline__ float grad_of_z(float g, float z) {
  if (!SILU) return g;
  const float sg = __fdividef(1.f, 1.f + __expf(-z));
  return g * sg * fmaf(z, 1.f - sg, 1.f);
}

// ---- cluster backward -------------------------------------------------------

constexpr int kBwdThreads = 256;
constexpr int kBwdMinBlocks = 3;  // registers for three blocks an SM: at most 80 a thread
constexpr int kLaneRows = 8;      // samples of at most this many rows: one thread a vector

// Shared memory of one backward block holding nb samples of rpb rows: the x
// and g tiles, then f32 red[2][nwarps][cb], part[2][cb], sc[cb],
// tot[2][nb][cb], coef[4][nb][cb], a ticket (16 bytes) and one mbarrier per
// box.  ops/gn_kernels.py::_bwd_smem_bytes computes the same.
__host__ __device__ inline size_t bwd_smem_bytes(int nb, int rpb, int cb, int esize,
                                                 int threads) {
  return 2 * tile_bytes(nb * rpb, cb, esize) +
         sizeof(float) * (2 * (threads / 32) * cb + 3 * cb + 6 * nb * cb) + 16 + 8 * kMaxBoxes;
}

// Grid (k * C / cb, ceil(B / nb)), clusters of k blocks.  A block holds one
// channel slice of either nb whole samples (k = 1: nb * S consecutive rows of
// the [B*S, C] maps) or rows r0 .. r0 + rpb - 1 of one sample (nb = 1).
// sums: f32 [2][ceil(B / nb)][C] workspace (each block's dbias and dscale
// partials); counters: one zeroed ticket per channel slice, left at zero
// again by the slice's last block.
template <typename T, bool SILU>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
gn_bwd_cluster(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tg,
               const float* __restrict__ scale, const float* __restrict__ bias,
               const float* __restrict__ mean, const float* __restrict__ rstd,
               T* __restrict__ dx, float* __restrict__ dscale, float* __restrict__ dbias,
               float* __restrict__ sums, unsigned* __restrict__ counters, int B, int S,
               int C, int G, int cb, int rpb, int nb) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int slice = static_cast<int>(blockIdx.x) / k;
  const int c0 = slice * cb;
  const int b0 = static_cast<int>(blockIdx.y) * nb;
  const int nloc = min(nb, B - b0);  // samples this block holds
  const int r0 = rank * rpb;
  const int rows = max(0, min(S - r0, rpb));  // rows of each of them
  const int used = (nloc - 1) * rpb + rows;
  const int gw = C / G;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int box = box_rows(nb * rpb), nbox = (used + box - 1) / box;
  const size_t tb = tile_bytes(nb * rpb, cb, sizeof(T));
  T* xs = reinterpret_cast<T*>(smem);
  T* gs = reinterpret_cast<T*>(smem + tb);
  float* red = reinterpret_cast<float*>(smem + 2 * tb);  // [2][nw][cb]
  float* part = red + 2 * nw * cb;                       // [2][cb]
  float* scs = part + 2 * cb;                            // [cb]: scale
  float* tot = scs + cb;                                 // [2][nb][cb]: A, then B
  float* coef = tot + 2 * nb * cb;  // [4][nb][cb]: ka, zb, then rs, nmr -> kb, kc
  unsigned* ticket = reinterpret_cast<unsigned*>(coef + 4 * nb * cb);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ticket) + 2;

  start_tiles<T>(&tx, &tg, xs, gs, static_cast<long long>(b0) * S + r0, c0, box, nbox, cb,
                 bars);

  // While the tiles load: per (sample, channel) z = x ka + zb, i.e. ka = rs
  // sc and zb = sc nmr + bi with nmr = -mu rs; rs, nmr and scale are kept for
  // the coefficients.  The barrier after it also makes the mbarriers visible.
  for (int t = threadIdx.x; t < nloc * cb; t += blockDim.x) {
    const int s = t / cb, c = t - s * cb;
    const long long gi = static_cast<long long>(b0 + s) * G + (c0 + c) / gw;
    const float rs = rstd[gi], nmr = -mean[gi] * rs, sc = scale[c0 + c];
    coef[t] = rs * sc;
    coef[nb * cb + t] = fmaf(nmr, sc, bias[c0 + c]);
    coef[2 * nb * cb + t] = rs;
    coef[3 * nb * cb + t] = nmr;
    if (s == 0) scs[c] = sc;
  }
  __syncthreads();

  // Warps in ng groups of wps: group i takes samples i, i + ng, ...; lane l
  // of a warp takes vector l % V of rows l / V + P * (warp's place in its
  // group), stepping by wps * P.
  VecMap m = vec_map(cb);
  const int ng = min(nb, nw), wps = nw / ng, gi = warp / wps;
  m.row0 = (warp - gi * wps) * m.P + m.j;
  m.rstep = wps * m.P;

  // Per (sample, channel): A = sum dz and Bx = sum dz x over the rows.  A
  // thread adds channels v8 .. v8 + 7 of sample s's rows from row0 by rstep,
  // waiting on each box as it reaches it.
  int landed = -1;
  const auto row_sums = [&](int s, int v8, int row0, int rstep, float(&A)[8], float(&Bx)[8]) {
    float ka[8], zb[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ka[i] = SILU ? coef[s * cb + v8 + i] : 0.f;
      zb[i] = SILU ? coef[(nb + s) * cb + v8 + i] : 0.f;
      A[i] = Bx[i] = 0.f;
    }
    for (int r = row0; r < rows; r += rstep) {
      const int t = s * rpb + r;
      if (t / box != landed) {
        landed = t / box;
        mbar_wait(smem_u32(bars + landed), 0);
      }
      float f[8], gv[8];
      load8(xs + t * cb + v8, f);
      load8(gs + t * cb + v8, gv);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dz = grad_of_z<SILU>(gv[i], fmaf(f[i], ka[i], zb[i]));
        A[i] += dz;
        Bx[i] = fmaf(dz, f[i], Bx[i]);
      }
    }
  };
  const bool lane_rows = k == 1 && rows <= kLaneRows;
  if (lane_rows) {
    // A few rows a sample: thread task (s, v) adds vector v of sample s over
    // all its rows in order, and no lanes need combining.
    for (int task = threadIdx.x; task < nloc * m.V; task += blockDim.x) {
      const int s = task / m.V, v8 = 8 * (task - s * m.V);
      float A[8], Bx[8];
      row_sums(s, v8, 0, 1, A, Bx);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        tot[s * cb + v8 + i] = A[i];
        tot[(nb + s) * cb + v8 + i] = Bx[i];
      }
    }
  } else {
    // Rows over the lanes: each warp's rows, then (wps > 1) its group's warps.
    for (int s = gi; s < nloc; s += ng) {
      float A[8], Bx[8];
      row_sums(s, 8 * m.v, m.active ? m.row0 : rows, m.rstep, A, Bx);
      warp_rows_sum8(A, m);
      warp_rows_sum8(Bx, m);
      if (lane < m.V) {
        float* dst = wps > 1 ? red + warp * cb : tot + s * cb;
        const int next = wps > 1 ? nw * cb : nb * cb;  // from the A array to the Bx array
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          dst[8 * lane + i] = A[i];
          dst[next + 8 * lane + i] = Bx[i];
        }
      }
    }
  }
  __syncthreads();
  if (!lane_rows && wps > 1) {  // then each group has one sample: its warps' sums in order
    for (int t = threadIdx.x; t < 2 * nloc * cb; t += blockDim.x) {
      const int which = t / (nloc * cb), rem = t - which * nloc * cb;
      const int s = rem / cb, c = rem - s * cb;
      float acc = 0.f;
      for (int w = 0; w < wps; ++w) acc += red[(which * nw + s * wps + w) * cb + c];
      tot[(which * nb + s) * cb + c] = acc;
    }
    __syncthreads();
  }
  if (k > 1) {  // nb = 1: over the cluster's blocks, runs of ranks in order
    for (int t = threadIdx.x; t < 2 * cb; t += blockDim.x) part[t] = tot[t];
    cluster.sync();
    ordered_sum(
        2 * cb, k, sum_lanes(2 * cb, nw),
        [&](int r, int t) { return cluster.map_shared_rank(part, r)[t]; }, red,
        [&](int t, float acc) { tot[t] = acc; });
    cluster_arrive();
    __syncthreads();
  }

  // Per (sample, group), one warp: B = rs Bx + nmr A per channel, then
  // a = sum scale A / N and b = sum scale B / N (the lanes' strided shares,
  // then a butterfly, which leaves every lane the same bits), and the
  // group's dx coefficients dx = ka dz + kb x + kc: kb = -rs^2 b and
  // kc = -rs (b nmr + a).
  const int ngl = cb / gw;
  const float count = static_cast<float>(S) * gw;
  for (int task = warp; task < nloc * ngl; task += nw) {
    const int s = task / ngl, first = (task - s * ngl) * gw;
    const float rs = coef[(2 * nb + s) * cb + first], nmr = coef[(3 * nb + s) * cb + first];
    float a = 0.f, bq = 0.f;
    for (int c = first + lane; c < first + gw; c += 32) {
      const float At = tot[s * cb + c];
      const float Bt = fmaf(rs, tot[(nb + s) * cb + c], nmr * At);
      tot[(nb + s) * cb + c] = Bt;
      a = fmaf(scs[c], At, a);
      bq = fmaf(scs[c], Bt, bq);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, d);
      bq += __shfl_xor_sync(0xffffffffu, bq, d);
    }
    a /= count;
    bq /= count;
    const float kb = -rs * rs * bq, kc = -rs * fmaf(bq, nmr, a);
    __syncwarp();  // every lane has read rs and nmr before they are overwritten
    for (int c = first + lane; c < first + gw; c += 32) {
      coef[(2 * nb + s) * cb + c] = kb;
      coef[(3 * nb + s) * cb + c] = kc;
    }
  }
  __syncthreads();

  // dbias = sum_b A and dscale = sum_b B: rank 0 sums its block's samples in
  // order; with more than one sample group it posts that partial, and the
  // last block of the channel slice to post (an atomic ticket) adds the
  // groups' partials in order (ordered_sum).
  const int nbg = static_cast<int>(gridDim.y);
  const auto write_params = [&](int t, float acc) {
    (t >= cb ? dscale : dbias)[c0 + t % cb] = acc;
  };
  if (rank == 0) {
    for (int t = threadIdx.x; t < 2 * cb; t += blockDim.x) {
      const int which = t / cb, c = t - which * cb;
      float acc = 0.f;
      for (int s = 0; s < nloc; ++s) acc += tot[(which * nb + s) * cb + c];
      if (nbg == 1)
        write_params(t, acc);
      else
        sums[(static_cast<long long>(which) * nbg + blockIdx.y) * C + c0 + c] = acc;
    }
    if (nbg > 1 && take_ticket(&counters[slice], ticket) == static_cast<unsigned>(nbg - 1)) {
      ordered_sum(
          2 * cb, nbg, sum_lanes(2 * cb, nw),
          [&](int q, int t) {
            return __ldcg(sums + (static_cast<long long>(t / cb) * nbg + q) * C + c0 + t % cb);
          },
          red, write_params);
      if (threadIdx.x == 0) counters[slice] = 0u;
    }
  }

  // dx, sample by sample, from the tiles
  for (int s = gi; s < nloc; s += ng) {
    float ka[8], zb[8], kb[8], kc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = s * cb + 8 * m.v + i;
      ka[i] = coef[c];
      zb[i] = SILU ? coef[nb * cb + c] : 0.f;
      kb[i] = coef[2 * nb * cb + c];
      kc[i] = coef[3 * nb * cb + c];
    }
    if (m.active) {
      T* dst = dx + (static_cast<long long>(b0 + s) * S + r0) * C + c0 + 8 * m.v;
      for (int r = m.row0; r < rows; r += m.rstep) {
        const int t = s * rpb + r;
        float f[8], gv[8];
        load8(xs + t * cb + 8 * m.v, f);
        load8(gs + t * cb + 8 * m.v, gv);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float dz = grad_of_z<SILU>(gv[i], fmaf(f[i], ka[i], zb[i]));
          f[i] = fmaf(ka[i], dz, fmaf(kb[i], f[i], kc[i]));
        }
        store8(dst + static_cast<long long>(r) * C, f);
      }
    }
  }
  finish_tiles(nbox, bars);
  if (k > 1) cluster_wait();
}

template <typename T, bool SILU, bool BWD, bool ADD = false>
auto kernel_of() {
  if constexpr (BWD)
    return gn_bwd_cluster<T, SILU>;
  else
    return gn_fwd_cluster<T, SILU, ADD>;
}

// Per kernel, once per device: allow the full shared memory, prefer it over
// L1, and allow clusters above 8.
template <typename T, bool SILU, bool BWD, bool ADD = false>
cudaError_t prepare() {
  static unsigned long long ready = 0;  // one bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (ready & bit) return cudaSuccess;
  const auto kernel = kernel_of<T, SILU, BWD, ADD>();
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) ready |= bit;
  return e;
}

struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];

  ClusterLaunch(int B, int C, int cb, int k, int threads, int smem, cudaStream_t st) : cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = k;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(k * (C / cb), B);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Errors the entries return besides CUDA's own (positive) codes.
constexpr int kErrPlan = -1;          // the launch plan breaks a constraint
constexpr int kErrEncode = -1000;  // minus the CUresult of a refused TMA descriptor

// The forward plan's constraints; 0 if the launch shape is valid.
int check_plan(int esize, int B, int S, int C, int G, int cb, int k, int threads,
               int smem) {
  const int rpb = k >= 1 ? (S + k - 1) / k : 0;
  const bool ok =
      B >= 1 && B <= 65535 && S >= 1 && static_cast<long long>(B) * S < (1ll << 31) &&
      G >= 1 && C % G == 0 && cb >= 8 && cb % 8 == 0 && cb <= kMaxTileChannels &&
      C % cb == 0 && cb % (C / G) == 0 && k >= 1 && k <= kMaxCluster && threads >= 32 &&
      threads <= kMaxThreads && threads % 32 == 0 && smem <= kMaxSmem &&
      alloc_rows(rpb) / box_rows(rpb) <= kMaxBoxes &&
      static_cast<size_t>(smem) >= smem_bytes(rpb, cb, esize, threads);
  return ok ? 0 : kErrPlan;
}

// The backward plan's constraints (nb samples a block); 0 if valid.
int check_bwd_plan(int esize, int B, int S, int C, int G, int cb, int k, int nb, int threads,
                   int smem) {
  const int rpb = k >= 1 ? (S + k - 1) / k : 0;
  const int nw = threads / 32;
  const bool ok =
      B >= 1 && S >= 1 && static_cast<long long>(B) * S < (1ll << 31) && G >= 1 &&
      C % G == 0 && cb >= 8 && cb % 8 == 0 && cb <= kMaxTileChannels && C % cb == 0 &&
      cb % (C / G) == 0 && k >= 1 && k <= kMaxCluster && nb >= 1 && nb <= B &&
      (k == 1 || nb == 1) && (B + nb - 1) / nb <= 65535 && threads >= 32 &&
      threads <= kBwdThreads && threads % 32 == 0 && (nb >= nw || nw % nb == 0) &&
      smem <= kMaxSmem && alloc_rows(nb * rpb) / box_rows(nb * rpb) <= kMaxBoxes &&
      static_cast<size_t>(smem) >= bwd_smem_bytes(nb, rpb, cb, esize, threads);
  return ok ? 0 : kErrPlan;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The TMA descriptor of a [rows, C] map (T elements) read in boxes of
// box x cb, with L2 promotion to whole 128-byte lines (a tile row is a
// 32- or 48-byte slice of one; the neighbouring slices' clusters find the
// rest of the line in L2).  cuTensorMapEncodeTiled is looked up once.
// Returns 0, a CUDA error, or kErrEncode - CUresult.
template <typename T>
int encode_rows(CUtensorMap* map, const void* base, long long rows, int C, int cb, int box) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                                  cudaEnableDefault, &q);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (q != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(C) * sizeof(T)};
  const cuuint32_t boxd[2] = {static_cast<cuuint32_t>(cb), static_cast<cuuint32_t>(box)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(
      map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(base), dims, strides, boxd, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode - static_cast<int>(r);
}

template <typename T, bool SILU, bool ADD>
int launch_fwd(const void* x, const void* addend, const float* scale, const float* bias,
               void* out, float* mean, float* rstd, int B, int S, int C, int G, float eps,
               int cb, int k, int threads, int smem, cudaStream_t st) {
  cudaError_t e = prepare<T, SILU, false, ADD>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rpb = (S + k - 1) / k;
  CUtensorMap tx;
  const int err = encode_rows<T>(&tx, x, static_cast<long long>(B) * S, C, cb, box_rows(rpb));
  if (err != 0) return err;
  ClusterLaunch l(B, C, cb, k, threads, smem, st);
  e = cudaLaunchKernelEx(&l.cfg, gn_fwd_cluster<T, SILU, ADD>, tx,
                         static_cast<const T*>(addend), scale, bias, static_cast<T*>(out),
                         mean, rstd, S, C, G, cb, rpb, eps);
  return static_cast<int>(e);
}

template <typename T, bool SILU>
int launch_bwd(const void* x, const void* g, const float* scale, const float* bias,
               const float* mean, const float* rstd, void* dx, float* dscale, float* dbias,
               float* sums, unsigned* counters, int B, int S, int C, int G, int cb, int k,
               int nb, int threads, int smem, cudaStream_t st) {
  cudaError_t e = prepare<T, SILU, true>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rpb = (S + k - 1) / k;
  const int box = box_rows(nb * rpb);
  CUtensorMap tx, tg;
  int err = encode_rows<T>(&tx, x, static_cast<long long>(B) * S, C, cb, box);
  if (err == 0) err = encode_rows<T>(&tg, g, static_cast<long long>(B) * S, C, cb, box);
  if (err != 0) return err;
  ClusterLaunch l((B + nb - 1) / nb, C, cb, k, threads, smem, st);
  e = cudaLaunchKernelEx(&l.cfg, gn_bwd_cluster<T, SILU>, tx, tg, scale, bias, mean, rstd,
                         static_cast<T*>(dx), dscale, dbias, sums, counters, B, S, C, G, cb,
                         rpb, nb);
  return static_cast<int>(e);
}

template <typename T, bool SILU, bool BWD>
int max_active_clusters(int B, int C, int cb, int k, int threads, int smem) {
  cudaError_t e = prepare<T, SILU, BWD>();
  if (e != cudaSuccess) return -static_cast<int>(e);
  ClusterLaunch l(B, C, cb, k, threads, smem, nullptr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel_of<T, SILU, BWD>(), &l.cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// ---- moments tool ---------------------------------------------------------

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

// ---- streaming variant ------------------------------------------------------
//
// For maps whose (sample, channel slice) tile does not fit the shared memory
// of a 16-block cluster (ops/gn_kernels.py::gn_plan has no plan: the SD VAE's
// 512 px maps, S = 262144), x is read from HBM twice instead of once.
// Forward, three launches: gn_stats (per (split, channel) f32 sums of x and
// x^2, the moments tool's pass), stream_stats_combine (per (sample, group):
// splits, then the group's channels, in a fixed order -> mean, rstd) and
// stream_apply (reads x again, writes the output).  2 reads + 1 write
// against the bound's 1 + 1, so it reaches at most ~2/3 of the bound.  The
// caller keeps the f32 partials small beside x (ops/gn_kernels.py
// _stream_splits: at most one split per 256 bytes of a channel's column).
// Backward, two launches: stream_bwd_sums (per (split, channel) sums of dz
// and dz x, added over clusters of up to 8 splits through distributed shared
// memory; the last block of each sample, by an atomic ticket, adds the
// clusters' sums, computes the sample's A, B and its groups' a and b, and the
// last sample's block adds dbias and dscale over the samples in order) and
// stream_bwd_dx (reads x and g again, writes dx).  The three middle launches
// of the earlier version (each a few microseconds of work on the f32 SD maps
// that stream) are gone; 4 reads + 1 write against the bound's 2 + 1 cap it
// at 60% of the bound, the honest limit for maps no cluster holds.
// Every sum runs in a fixed order, so two calls give the same bits.  Threads
// own 8 channels of a row, as in gn_stats: a block is (C/8) * R threads
// working on R rows at once, the grid (nsplit, B), split i the rows
// [i * rps, (i + 1) * rps) of its sample.

__host__ __device__ inline int stream_rows(int C) {
  const int cvn = C / 8;
  return cvn >= 256 ? 1 : 256 / cvn;
}

constexpr int kCombineThreads = 256;  // a power of two: the tree below halves it

// grid (G, B), kCombineThreads threads: a group's partial sums (over the
// splits and its channels), a strided share a thread, then a fixed-order
// tree over the block.
__global__ void __launch_bounds__(kCombineThreads)
stream_stats_combine(const float* __restrict__ psum, const float* __restrict__ psq,
                     float* __restrict__ mean, float* __restrict__ rstd, int nsplit, int S,
                     int C, int G, float eps) {
  __shared__ float sa[kCombineThreads], sq[kCombineThreads];
  const long long b = blockIdx.y;
  const int g = blockIdx.x, t = threadIdx.x;
  const int gw = C / G, n = nsplit * gw;
  float a = 0.f, q = 0.f;
  for (int j = t; j < n; j += kCombineThreads) {
    const int sp = j / gw;
    const long long idx = (b * nsplit + sp) * C + static_cast<long long>(g) * gw + (j - sp * gw);
    a += psum[idx];
    q += psq[idx];
  }
  sa[t] = a;
  sq[t] = q;
  __syncthreads();
  for (int w = kCombineThreads / 2; w > 0; w >>= 1) {
    if (t < w) {
      sa[t] += sa[t + w];
      sq[t] += sq[t + w];
    }
    __syncthreads();
  }
  if (t == 0) {
    const float count = static_cast<float>(S) * gw;
    const float mu = sa[0] / count;
    const float var = fmaxf(sq[0] / count - mu * mu, 0.f);
    mean[b * G + g] = mu;
    rstd[b * G + g] = rsqrtf(var + eps);
  }
}

template <typename T, bool SILU>
__global__ void __launch_bounds__(kMaxThreads)
stream_apply(const T* __restrict__ x, const float* __restrict__ scale,
             const float* __restrict__ bias, const float* __restrict__ mean,
             const float* __restrict__ rstd, T* __restrict__ out, int S, int C, int G,
             int rps) {
  const int cvn = C / 8, R = blockDim.x / cvn;
  const int cv = threadIdx.x % cvn, r = threadIdx.x / cvn;
  const long long b = blockIdx.y;
  const int s0 = blockIdx.x * rps, s1 = min(S, s0 + rps);
  const int gw = C / G;
  float mul[8], add[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = 8 * cv + i;
    const float rs = rstd[b * G + c / gw];
    mul[i] = rs * scale[c];
    add[i] = fmaf(-mean[b * G + c / gw], mul[i], bias[c]);
  }
  const long long base = b * S * C + 8 * cv;
#pragma unroll 4
  for (int s = s0 + r; s < s1; s += R) {
    float f[8];
    load8(x + base + static_cast<long long>(s) * C, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float y = fmaf(f[i], mul[i], add[i]);
      f[i] = SILU ? silu(y) : y;
    }
    store8(out + base + static_cast<long long>(s) * C, f);
  }
}

// Per-thread coefficients of the backward: x^ = x * rs + nmr, z = x^ sc + bi.
struct BwdCoef {
  float rs[8], nmr[8], sc[8], bi[8];
};

__device__ __forceinline__ BwdCoef bwd_coef(const float* scale, const float* bias,
                                            const float* mean, const float* rstd,
                                            long long b, int c0, int G, int gw) {
  BwdCoef k;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c0 + i;
    k.rs[i] = rstd[b * G + c / gw];
    k.nmr[i] = -mean[b * G + c / gw] * k.rs[i];
    k.sc[i] = scale[c];
    k.bi[i] = bias[c];
  }
  return k;
}

// Grid (nsplit, B), clusters of kc blocks along the splits, blockDim (C/8) R.
// Each block sums dz and dz x per channel over its split's rows (z = x ka +
// zb, as in gn_bwd_cluster); each cluster adds its blocks' sums in rank
// order (rank r takes the r-th share of the 2C sums) into part: f32
// [B][nsplit / kc][2][C].  The last block of a sample to post (an atomic
// ticket, counters[b]) adds the clusters' sums in order, into sums: f32
// [2][B][C] (A and B = rs sum dz x + nmr A of the sample), and its groups'
// a and b, into coef: f32 [2][B][G]; the last sample to finish
// (counters[B]) adds dbias and dscale over the samples in order.  counters:
// B + 1 zeroed tickets, left zeroed.
template <typename T, bool SILU>
__global__ void __launch_bounds__(kMaxThreads, 1)
stream_bwd_sums(const T* __restrict__ x, const T* __restrict__ g,
                const float* __restrict__ scale, const float* __restrict__ bias,
                const float* __restrict__ mean, const float* __restrict__ rstd,
                float* __restrict__ part, float* __restrict__ sums, float* __restrict__ coef,
                float* __restrict__ dscale, float* __restrict__ dbias,
                unsigned* __restrict__ counters, int B, int S, int C, int G, int rps) {
  extern __shared__ float sh[];  // [2][R][C], then mine[2][C], then a ticket
  cg::cluster_group cluster = cg::this_cluster();
  const int kc = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cvn = C / 8, R = blockDim.x / cvn;
  const int cv = threadIdx.x % cvn, r = threadIdx.x / cvn;
  const int split = blockIdx.x, nsplit = gridDim.x, ncl = nsplit / kc;
  const long long b = blockIdx.y;
  const int s0 = split * rps, s1 = min(S, s0 + rps);
  const int gw = C / G;
  float ka[8], zb[8], A[8], Bs[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = 8 * cv + i;
    const float rs = SILU ? rstd[b * G + c / gw] : 0.f;
    ka[i] = rs * (SILU ? scale[c] : 0.f);
    zb[i] = SILU ? fmaf(-mean[b * G + c / gw] * rs, scale[c], bias[c]) : 0.f;
    A[i] = Bs[i] = 0.f;
  }
  const long long base = b * S * C + 8 * cv;
#pragma unroll 2
  for (int s = s0 + r; s < s1; s += R) {
    float f[8], gv[8];
    load8(x + base + static_cast<long long>(s) * C, f);
    load8(g + base + static_cast<long long>(s) * C, gv);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float dz = grad_of_z<SILU>(gv[i], fmaf(f[i], ka[i], zb[i]));
      A[i] += dz;
      Bs[i] = fmaf(dz, f[i], Bs[i]);
    }
  }
  float* sa = sh;
  float* sb = sh + R * C;
  float* mine = sh + 2 * R * C;
  unsigned* ticket = reinterpret_cast<unsigned*>(mine + 2 * C);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sa[r * C + 8 * cv + i] = A[i];
    sb[r * C + 8 * cv + i] = Bs[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int rr = 0; rr < R; ++rr) {
      a += sa[rr * C + c];
      q += sb[rr * C + c];
    }
    mine[c] = a;
    mine[C + c] = q;
  }
  cluster.sync();
  const int share = (2 * C + kc - 1) / kc, first = rank * share;
  const int n = max(0, min(2 * C, first + share) - first);
  float* dst = part + (b * ncl + split / kc) * 2 * C + first;
  ordered_sum(
      n, kc, sum_lanes(n, kc),
      [&](int q, int t) { return cluster.map_shared_rank(mine, q)[first + t]; }, sh,
      [&](int t, float acc) { dst[t] = acc; });
  cluster_arrive();
  if (take_ticket(&counters[b], ticket) == static_cast<unsigned>(nsplit - 1)) {
    float* tot = sh;  // [2][C]: A and B of the sample
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const float* src = part + b * ncl * 2 * C + c;
      float a = 0.f, q = 0.f;
#pragma unroll 8
      for (int i = 0; i < ncl; ++i) {
        a += __ldcg(src + static_cast<long long>(i) * 2 * C);
        q += __ldcg(src + static_cast<long long>(i) * 2 * C + C);
      }
      const float rs = rstd[b * G + c / gw];
      q = fmaf(rs, q, -mean[b * G + c / gw] * rs * a);
      tot[c] = a;
      tot[C + c] = q;
      sums[b * C + c] = a;
      sums[(B + b) * C + c] = q;
    }
    if (threadIdx.x == 0) counters[b] = 0u;
    __syncthreads();
    // a whole warp a group (blockDim need not be a multiple of 32): the
    // lanes' strided shares, then a butterfly
    const float count = static_cast<float>(S) * gw;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, full_warps = blockDim.x >> 5;
    for (int grp = warp; warp < full_warps && grp < G; grp += full_warps) {
      float a = 0.f, q = 0.f;
      for (int c = grp * gw + lane; c < (grp + 1) * gw; c += 32) {
        a = fmaf(scale[c], tot[c], a);
        q = fmaf(scale[c], tot[C + c], q);
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, d);
        q += __shfl_xor_sync(0xffffffffu, q, d);
      }
      if (lane == 0) {
        coef[b * G + grp] = a / count;
        coef[(B + b) * G + grp] = q / count;
      }
    }
    if (take_ticket(&counters[B], ticket) == static_cast<unsigned>(B - 1)) {
      for (int c = threadIdx.x; c < C; c += blockDim.x) {
        float da = 0.f, db = 0.f;
        for (int bb = 0; bb < B; ++bb) {
          da += __ldcg(&sums[static_cast<long long>(bb) * C + c]);
          db += __ldcg(&sums[static_cast<long long>(B + bb) * C + c]);
        }
        dbias[c] = da;
        dscale[c] = db;
      }
      if (threadIdx.x == 0) counters[B] = 0u;
    }
  }
  cluster_wait();
}

// dx = rs (sc dz - a - x^ b) = ka dz + kb x^ + kc.
template <typename T, bool SILU>
__global__ void __launch_bounds__(kMaxThreads)
stream_bwd_dx(const T* __restrict__ x, const T* __restrict__ g,
              const float* __restrict__ scale, const float* __restrict__ bias,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const float* __restrict__ coef, T* __restrict__ dx, int B, int S, int C, int G,
              int rps) {
  const int cvn = C / 8, R = blockDim.x / cvn;
  const int cv = threadIdx.x % cvn, r = threadIdx.x / cvn;
  const long long b = blockIdx.y;
  const int s0 = blockIdx.x * rps, s1 = min(S, s0 + rps);
  const int gw = C / G;
  const BwdCoef k = bwd_coef(scale, bias, mean, rstd, b, 8 * cv, G, gw);
  float ka[8], kb[8], kc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int grp = (8 * cv + i) / gw;
    ka[i] = k.rs[i] * k.sc[i];
    kb[i] = -k.rs[i] * coef[(B + b) * G + grp];
    kc[i] = -k.rs[i] * coef[b * G + grp];
  }
  const long long base = b * S * C + 8 * cv;
#pragma unroll 2
  for (int s = s0 + r; s < s1; s += R) {
    float f[8], gv[8];
    load8(x + base + static_cast<long long>(s) * C, f);
    load8(g + base + static_cast<long long>(s) * C, gv);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float xh = fmaf(f[i], k.rs[i], k.nmr[i]);
      const float dz = grad_z<SILU>(gv[i], xh, k.sc[i], k.bi[i]);
      f[i] = fmaf(ka[i], dz, fmaf(kb[i], xh, kc[i]));
    }
    store8(dx + base + static_cast<long long>(s) * C, f);
  }
}

// The streaming variant's constraints; 0 if valid.
int check_stream(int B, int S, int C, int G, int nsplit) {
  const bool ok = B >= 1 && B <= 65535 && S >= 1 && G >= 1 && C % 8 == 0 && C % G == 0 &&
                  C / 8 <= kMaxThreads && nsplit >= 1 && nsplit <= 65535;
  return ok ? 0 : kErrPlan;
}

// The streaming backward's: splits in whole clusters of kc <= 8 blocks, R
// rows a block pass of the sums, and the dx pass's splits.
int check_stream_bwd(int B, int S, int C, int G, int nsplit, int kc, int R, int nsplit_dx) {
  const bool ok = check_stream(B, S, C, G, nsplit) == 0 && kc >= 1 && kc <= 8 &&
                  nsplit % kc == 0 && R >= 1 &&
                  C / 8 * R <= kMaxThreads &&
                  sizeof(float) * 2 * (R + 1) * C + sizeof(unsigned) <= kMaxSmem &&
                  nsplit_dx >= 1 && nsplit_dx <= 65535;
  return ok ? 0 : kErrPlan;
}

template <typename T, bool SILU>
int launch_stream_fwd(const void* x, const float* scale, const float* bias, void* out,
                      float* mean, float* rstd, float* work, int B, int S, int C, int G,
                      float eps, int nsplit, cudaStream_t st) {
  const int R = stream_rows(C), threads = C / 8 * R;
  const int rps = (S + nsplit - 1) / nsplit;
  const dim3 grid(nsplit, B);
  float* psum = work;
  float* psq = work + static_cast<long long>(B) * nsplit * C;
  gn_stats<T><<<grid, threads, 2 * sizeof(float) * R * C, st>>>(
      static_cast<const T*>(x), psum, psq, S, C, rps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  stream_stats_combine<<<dim3(G, B), kCombineThreads, 0, st>>>(psum, psq, mean, rstd, nsplit,
                                                               S, C, G, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  stream_apply<T, SILU><<<grid, threads, 0, st>>>(static_cast<const T*>(x), scale, bias,
                                                   mean, rstd, static_cast<T*>(out), S, C,
                                                   G, rps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool SILU>
int launch_stream_bwd(const void* x, const void* g, const float* scale, const float* bias,
                      const float* mean, const float* rstd, void* dx, float* dscale,
                      float* dbias, float* work, unsigned* counters, int B, int S, int C, int G,
                      int nsplit, int kc, int R, int nsplit_dx, cudaStream_t st) {
  static unsigned long long ready = 0;  // one bit per device: the shared memory allowed
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!(ready & (1ull << (dev & 63)))) {
    e = cudaFuncSetAttribute(stream_bwd_sums<T, SILU>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready |= 1ull << (dev & 63);
  }
  float* part = work;
  float* sums = part + static_cast<long long>(B) * (nsplit / kc) * 2 * C;
  float* coef = sums + 2ll * B * C;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(nsplit, B);
  cfg.blockDim = dim3(C / 8 * R);
  cfg.dynamicSmemBytes = sizeof(float) * 2 * (R + 1) * C + sizeof(unsigned);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, stream_bwd_sums<T, SILU>, xt, gt, scale, bias, mean, rstd, part,
                         sums, coef, dscale, dbias, counters, B, S, C, G,
                         (S + nsplit - 1) / nsplit);
  if (e != cudaSuccess) return static_cast<int>(e);
  stream_bwd_dx<T, SILU><<<dim3(nsplit_dx, B), C / 8 * stream_rows(C), 0, st>>>(
      xt, gt, scale, bias, mean, rstd, coef, static_cast<T*>(dx), B, S, C, G,
      (S + nsplit_dx - 1) / nsplit_dx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Forward.  x: [B, S, C] contiguous, dtype code 0 = f32, 1 = bf16; addend:
// null, or [B, C] contiguous in x's dtype, added to x (the sum rounded to
// that dtype) before it is normalised; out: [B, S, C] contiguous in the same
// dtype; scale, bias: f32 [C]; mean, rstd: f32 [B, G] (written).
// (cb, k, threads, smem) is the launch plan; pointers are 16-byte aligned
// (the caller checks).  Returns 0 on success, else a CUDA error code,
// kErrPlan (-1) for a plan that breaks a constraint, or kErrEncode - CUresult
// for a TMA descriptor that could not be encoded.
extern "C" int phd_gn_fwd(const void* x, const void* addend, int dtype, const float* scale,
                          const float* bias, void* out, float* mean, float* rstd, int B,
                          int S, int C, int G, float eps, int silu, int cb, int k,
                          int threads, int smem, void* stream) {
  const int esize = dtype == 1 ? 2 : 4;
  const int err = check_plan(esize, B, S, C, G, cb, k, threads, smem);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (addend != nullptr) {
    if (dtype == 1)
      return silu ? launch_fwd<bf16, true, true>(x, addend, scale, bias, out, mean, rstd, B, S, C, G, eps, cb, k, threads, smem, st)
                  : launch_fwd<bf16, false, true>(x, addend, scale, bias, out, mean, rstd, B, S, C, G, eps, cb, k, threads, smem, st);
    return silu ? launch_fwd<float, true, true>(x, addend, scale, bias, out, mean, rstd, B, S, C, G, eps, cb, k, threads, smem, st)
                : launch_fwd<float, false, true>(x, addend, scale, bias, out, mean, rstd, B, S, C, G, eps, cb, k, threads, smem, st);
  }
  if (dtype == 1)
    return silu ? launch_fwd<bf16, true, false>(x, nullptr, scale, bias, out, mean, rstd, B, S, C, G, eps, cb, k, threads, smem, st)
                : launch_fwd<bf16, false, false>(x, nullptr, scale, bias, out, mean, rstd, B, S, C, G, eps, cb, k, threads, smem, st);
  return silu ? launch_fwd<float, true, false>(x, nullptr, scale, bias, out, mean, rstd, B, S, C, G, eps, cb, k, threads, smem, st)
              : launch_fwd<float, false, false>(x, nullptr, scale, bias, out, mean, rstd, B, S, C, G, eps, cb, k, threads, smem, st);
}

// Backward.  x, g: [B, S, C] contiguous in one dtype (code as above); mean,
// rstd: the forward's [B, G]; dx: [B, S, C] in x's dtype; dscale, dbias:
// f32 [C]; sums: f32 workspace of 2 * ceil(B / nb) * C; counters: C / cb
// zeroed unsigned tickets, left zeroed.  (cb, k, nb, threads, smem) is the
// plan; same return convention.
extern "C" int phd_gn_bwd(const void* x, const void* g, int dtype, const float* scale,
                          const float* bias, const float* mean, const float* rstd, void* dx,
                          float* dscale, float* dbias, float* sums, unsigned* counters, int B,
                          int S, int C, int G, int silu, int cb, int k, int nb, int threads,
                          int smem, void* stream) {
  const int esize = dtype == 1 ? 2 : 4;
  const int err = check_bwd_plan(esize, B, S, C, G, cb, k, nb, threads, smem);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == 1)
    return silu ? launch_bwd<bf16, true>(x, g, scale, bias, mean, rstd, dx, dscale, dbias, sums, counters, B, S, C, G, cb, k, nb, threads, smem, st)
                : launch_bwd<bf16, false>(x, g, scale, bias, mean, rstd, dx, dscale, dbias, sums, counters, B, S, C, G, cb, k, nb, threads, smem, st);
  return silu ? launch_bwd<float, true>(x, g, scale, bias, mean, rstd, dx, dscale, dbias, sums, counters, B, S, C, G, cb, k, nb, threads, smem, st)
              : launch_bwd<float, false>(x, g, scale, bias, mean, rstd, dx, dscale, dbias, sums, counters, B, S, C, G, cb, k, nb, threads, smem, st);
}

// How many clusters of a plan the card holds at once
// (cudaOccupancyMaxActiveClusters); negative: minus the CUDA error.
extern "C" int phd_gn_max_active_clusters(int backward, int dtype, int silu, int B, int C,
                                          int cb, int k, int threads, int smem) {
  using bf16 = __nv_bfloat16;
  if (backward) {
    if (dtype == 1)
      return silu ? max_active_clusters<bf16, true, true>(B, C, cb, k, threads, smem)
                  : max_active_clusters<bf16, false, true>(B, C, cb, k, threads, smem);
    return silu ? max_active_clusters<float, true, true>(B, C, cb, k, threads, smem)
                : max_active_clusters<float, false, true>(B, C, cb, k, threads, smem);
  }
  if (dtype == 1)
    return silu ? max_active_clusters<bf16, true, false>(B, C, cb, k, threads, smem)
                : max_active_clusters<bf16, false, false>(B, C, cb, k, threads, smem);
  return silu ? max_active_clusters<float, true, false>(B, C, cb, k, threads, smem)
              : max_active_clusters<float, false, false>(B, C, cb, k, threads, smem);
}

// Per-channel moments: x as above; out_sum, out_sq: f32 [B, C]; workspace:
// f32, 2 * B * nsplit * C elements.  C is a multiple of 8, C / 8 <= 1024,
// x 16-byte aligned.  Returns the first CUDA launch error (0 on success).
extern "C" int phd_channel_moments(const void* x, int dtype, float* workspace,
                                   float* out_sum, float* out_sq, int B, int S,
                                   int C, int nsplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* psum = workspace;
  float* psq = psum + static_cast<long long>(B) * nsplit * C;
  const int cvn = C / 8;
  const int R = cvn >= 256 ? 1 : 256 / cvn;
  const size_t sh = 2 * sizeof(float) * static_cast<size_t>(R) * C;
  const int rows_per_split = (S + nsplit - 1) / nsplit;
  const dim3 grid(nsplit, B);
  if (dtype == 1)
    gn_stats<__nv_bfloat16><<<grid, cvn * R, sh, st>>>(
        static_cast<const __nv_bfloat16*>(x), psum, psq, S, C, rows_per_split);
  else
    gn_stats<float><<<grid, cvn * R, sh, st>>>(
        static_cast<const float*>(x), psum, psq, S, C, rows_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moments_combine<<<B, 256, 0, st>>>(psum, psq, out_sum, out_sq, nsplit, C);
  return static_cast<int>(cudaGetLastError());
}

// Streaming forward, for maps without a cluster plan.  x, out, scale, bias,
// mean, rstd as in phd_gn_fwd; workspace: f32, 2 * B * nsplit * C elements.
// C % 8 == 0, C / 8 <= 512, pointers 16-byte aligned.  Returns 0, a CUDA
// error code, or kErrPlan (-1) for a shape it does not take.
extern "C" int phd_gn_stream_fwd(const void* x, int dtype, const float* scale,
                                 const float* bias, void* out, float* mean, float* rstd,
                                 float* workspace, int B, int S, int C, int G, float eps,
                                 int silu, int nsplit, void* stream) {
  const int err = check_stream(B, S, C, G, nsplit);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == 1)
    return silu ? launch_stream_fwd<bf16, true>(x, scale, bias, out, mean, rstd, workspace, B, S, C, G, eps, nsplit, st)
                : launch_stream_fwd<bf16, false>(x, scale, bias, out, mean, rstd, workspace, B, S, C, G, eps, nsplit, st);
  return silu ? launch_stream_fwd<float, true>(x, scale, bias, out, mean, rstd, workspace, B, S, C, G, eps, nsplit, st)
              : launch_stream_fwd<float, false>(x, scale, bias, out, mean, rstd, workspace, B, S, C, G, eps, nsplit, st);
}

// Streaming backward, two launches.  x, g, mean, rstd, dx, dscale, dbias as
// in phd_gn_bwd; workspace: f32, 2 * B * (nsplit / kc) * C +
// 2 * B * C + 2 * B * G elements; counters: B + 1 zeroed unsigned tickets,
// left zeroed.  nsplit: splits of S a sample in the sums pass, in clusters
// of kc <= 8 blocks (nsplit a multiple of kc); R: rows a block of it takes
// at once ((C / 8) R threads); nsplit_dx: the dx pass's splits.  Same return
// convention as phd_gn_stream_fwd.
extern "C" int phd_gn_stream_bwd(const void* x, const void* g, int dtype, const float* scale,
                                 const float* bias, const float* mean, const float* rstd,
                                 void* dx, float* dscale, float* dbias, float* workspace,
                                 unsigned* counters, int B, int S, int C, int G, int silu,
                                 int nsplit, int kc, int R, int nsplit_dx, void* stream) {
  const int err = check_stream_bwd(B, S, C, G, nsplit, kc, R, nsplit_dx);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == 1)
    return silu ? launch_stream_bwd<bf16, true>(x, g, scale, bias, mean, rstd, dx, dscale, dbias, workspace, counters, B, S, C, G, nsplit, kc, R, nsplit_dx, st)
                : launch_stream_bwd<bf16, false>(x, g, scale, bias, mean, rstd, dx, dscale, dbias, workspace, counters, B, S, C, G, nsplit, kc, R, nsplit_dx, st);
  return silu ? launch_stream_bwd<float, true>(x, g, scale, bias, mean, rstd, dx, dscale, dbias, workspace, counters, B, S, C, G, nsplit, kc, R, nsplit_dx, st)
              : launch_stream_bwd<float, false>(x, g, scale, bias, mean, rstd, dx, dscale, dbias, workspace, counters, B, S, C, G, nsplit, kc, R, nsplit_dx, st);
}
