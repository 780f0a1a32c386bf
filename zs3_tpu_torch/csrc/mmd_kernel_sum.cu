// Multi-bandwidth Gaussian kernel sum (K2) and its gradient (K3), for sm_90a.
//
// Replaces the TPU kernels zs3_tpu/ops/pallas_mmd.py::_fwd_kernel (K2,
// entered through kernel_sum) and ::_grad_x_kernel (K3, the custom VJP of
// kernel_sum).  Both take a batch of C independent problems (one per
// class) in one launch, where the JAX package maps over classes:
//
//   K2: out[c] = sum_ij wx[c,i] wy[c,j] sum_s exp(-d2_cij / (2 sigma_s))
//   K3: dx[c,i]  = sum_j C_cij y[c,j] - (sum_j C_cij) x[c,i]
//       dwx[c,i] = sum_j wy[c,j] K_cij
//   with d2_cij = max(|x_ci|^2 + |y_cj|^2 - 2 x_ci.y_cj, 0),
//        K_cij  = sum_s exp(-d2_cij / (2 sigma_s)),
//        C_cij  = wx[c,i] wy[c,j] sum_s exp(-d2_cij / (2 sigma_s)) / sigma_s
//   for x (C,N,D), y (C,M,D), wx (C,N), wy (C,M) f32, D <= 512, S <= 8.
//
// Bound on an H100 SXM.  With S=6 sigmas, one K2 call does
// C*N*M*(2D+3S+6) f32 operations (the dot, d2, S exponentials with their
// scale and sum, the weights; an expf counted as one): 184 MFLOP at the
// ZS3 step's shape C=21, N=M=128, D=256, or 2.75 us at 67 TFLOP/s, on
// 5.5 MB of input (1.6 us at 3.35 TB/s): operations.  One K3 call does
// C*N*M*(4D+5S+8) = 365 MFLOP on 8.3 MB, 5.4 us if every operation ran
// outside the tensor cores.  Both kernels run their products (x.y^T, and
// K3's C.y) on the TF32 tensor cores in 3xTF32, three products of TF32
// parts (6D per pair and product at 495 TFLOP/s) with f32 accumulation,
// and the rest beside them at 67 TFLOP/s, with the S exponentials on the
// SFU (16 an SM a clock, 4.2 T/s at 1.98 GHz).  In that arithmetic K2
// needs 1.07 us of tensor operations, 0.49 us of exponentials and 0.09 us
// of the rest at the step's shape, against 1.65 us of bytes: bytes bound
// it there, and the tensor operations (0.27 ms) at 2048 x 2048 rows a
// class.  K3 needs 2.1 us of tensor operations against 2.5 us of bytes
// at the step's shape, and is bound by the tensor operations at 2048.
// One TF32 product alone would not compute the same function (10 mantissa
// bits); hi.hi + hi.lo + lo.hi keeps f32's accuracy.
//
// Both kernels keep the N x M matrix out of device memory.  Tiles of 32
// rows sit in shared memory as 128-byte panels of 32 features under the
// 128-byte swizzle (16-byte chunk ^ row % 8), the layout a TMA box with
// CU_TENSOR_MAP_SWIZZLE_128B writes; tiles arrive by TMA (a 3-D tensor map
// over (D, rows, C), so rows past N or M and features past D land as
// zeros, and their weights load as 0) into an `mbarrier` ring, or, when
// D % 4 != 0 or a base is not 16-byte aligned, by the threads into the
// same layout.  Norms, d2, the exponentials (expf, not __expf) and the
// weights stay in exact f32.  No float atomics: repeated calls give the
// same bits.  K2's design is at its kernel below, K3's at its own.  The
// TPU kernel's row padding to 1024 and feature padding to 128 (its
// (8,128) tiling) and its sequential SMEM accumulator are gone.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int kTile = 32;      // rows of an x or y tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxSigmas = 8;
constexpr int kMaxD = 512;

struct Sigmas {
  int count;
  float coef[kMaxSigmas];  // -1 / (2 sigma_s)
  float inv[kMaxSigmas];   // 1 / sigma_s
};

__device__ __forceinline__ float sq_dist(float x2, float y2, float xy) {
  return fmaxf(x2 + y2 - 2.f * xy, 0.f);
}

// ---- Tiles, TMA and 3xTF32 products (K2 and K3) ------------------------------

constexpr int kPanel = 32;                    // features in one 128-byte panel row
constexpr int kPanelFloats = kTile * kPanel;  // one panel of a tile
constexpr int kStages = 2;                    // y tiles in the ring
constexpr int kRedPitch = 40;                 // 8 mod 32: conflict-free 8-byte accesses
constexpr int kSmallFloats = 6 * kTile;       // |x|^2, wx, |y|^2, wy, rowsum, dwx
constexpr int kMaxCluster = 8;
constexpr int kWarps = kThreads / 32;
// A wait that outlasts this (about 10 s of SM clock) traps instead of
// holding the card; the trap is sticky (the process's CUDA context is lost).
constexpr long long kHangCycles = 20000000000LL;

__host__ __device__ inline int pad_features(int d) { return (d + kPanel - 1) / kPanel * kPanel; }

// Dynamic shared memory of one K3 CTA: alignment slack, the x tile and the
// y ring (panels of 4 KB), `red` (two 32 x kRedPitch halves), the small
// arrays and the ring's mbarriers.
__host__ __device__ inline size_t grad_smem_bytes(int D) {
  const size_t dp = pad_features(D);
  return 1024 + sizeof(float) * (kTile * dp * (1 + kStages) + 2 * kTile * kRedPitch +
                                 kSmallFloats) + 8 * (kStages + 1);
}

// Float offset of (row r, feature k) in a swizzled tile.
__device__ __forceinline__ int swz(int r, int k) {
  return ((k >> 5) << 10) + (r << 5) + ((k & 31) ^ ((r & 7) << 2));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) break;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > kHangCycles) {
      __trap();
    }
  }
}

// TMA: rows [row, row + 32) of class c, features [col, col + 32), into one
// panel, completing on `bar`.
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map, int col, int row,
                                         int c, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(c),
         "r"(smem_u32(bar))
      : "memory");
}

// One tile (rows [row0, row0 + 32) of class c) by TMA, panel by panel.
__device__ __forceinline__ void tma_tile(float* dst, const CUtensorMap* map, int row0, int c,
                                         int panels, uint64_t* bar) {
  mbar_expect_tx(bar, panels * kPanelFloats * sizeof(float));
  for (int p = 0; p < panels; ++p) tma_load(dst + p * kPanelFloats, map, p * kPanel, row0, c, bar);
}

// The same tile loaded by the threads: zeros past `rows` and past D.
__device__ void plain_tile(float* dst, const float* __restrict__ src, int row0, int rows, int D,
                           int dp) {
  for (int e = threadIdx.x; e < kTile * dp; e += kThreads) {
    const int r = e / dp;
    const int k = e - r * dp;
    dst[swz(r, k)] =
        row0 + r < rows && k < D ? src[static_cast<long long>(row0 + r) * D + k] : 0.f;
  }
}

// norms[r] = |tile row r|^2: thread (r = tid / 8, part = tid % 8) sums
// the 16-byte chunk `part` of each panel of row r in order, then the row's
// 8 threads add their sums in a fixed tree.
__device__ void tile_norms(float* norms, const float* tile, int dp) {
  const int r = threadIdx.x / 8;
  const int part = threadIdx.x % 8;
  const float* chunk = tile + r * kPanel + ((part ^ (r & 7)) << 2);
  float s = 0.f;
#pragma unroll 4
  for (int p = 0; p < dp; p += kPanel, chunk += kPanelFloats) {
    const float4 v = *reinterpret_cast<const float4*>(chunk);
    s = fmaf(v.x, v.x, s);
    s = fmaf(v.y, v.y, s);
    s = fmaf(v.z, v.z, s);
    s = fmaf(v.w, v.w, s);
  }
  for (int off = 1; off < 8; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (part == 0) norms[r] = s;
}

// v rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
// as cvt.rna.tf32.f32 rounds a finite v, in two integer operations (the
// cvt is a longer sequence on sm_90): add half of the unit of the 13
// dropped bits to the magnitude, then clear them.
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo + (what 3xTF32 drops): hi its TF32 rounding, lo the residual's.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b in 3xTF32: the two cross terms, then hi.hi (lo.lo is dropped).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// This warp's share of the 32 x 32 product xs.ys^T of two swizzled tiles
// (dp features, zero-padded): rows 16 (w & 1) + [0, 16), columns
// 16 ((w >> 1) & 1) + [0, 16), and of each panel the depth steps
// [8 h, 8 h + 8) and [8 h + 16, 8 h + 24) for h = w >> 2, as two m16n8
// accumulators.  Every row a lane reads is its group g mod 8, so the
// swizzled offsets within a panel are four lane constants.
__device__ __forceinline__ void dot_tile_3xtf32(float (&acc)[2][4], const float* xs,
                                                const float* ys, int dp) {
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) >> 2;
  const int t = threadIdx.x & 3;
  const int h = warp >> 2;
  int off[4];  // depth 8 h + t, + 4, + 16, + 20 under the swizzle
#pragma unroll
  for (int q = 0; q < 4; ++q) off[q] = (8 * h + 16 * (q >> 1) + 4 * (q & 1) + t) ^ (g << 2);
  const float* x0 = xs + (16 * (warp & 1) + g) * kPanel;
  const float* y0 = ys + (16 * ((warp >> 1) & 1) + g) * kPanel;
#pragma unroll
  for (int n = 0; n < 2; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll 2
  for (int p = 0; p < dp; p += kPanel, x0 += kPanelFloats, y0 += kPanelFloats) {
#pragma unroll
    for (int q = 0; q < 4; q += 2) {
      uint32_t ah[4], al[4];
      split(x0[off[q]], ah[0], al[0]);
      split(x0[8 * kPanel + off[q]], ah[1], al[1]);
      split(x0[off[q + 1]], ah[2], al[2]);
      split(x0[8 * kPanel + off[q + 1]], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t bh0, bl0, bh1, bl1;
        split(y0[8 * n * kPanel + off[q]], bh0, bl0);
        split(y0[8 * n * kPanel + off[q + 1]], bh1, bl1);
        mma_3xtf32(acc[n], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }
}

// The accumulators of dot_tile_3xtf32 into red's half (w >> 2), a
// (32, kRedPitch) tile; the two halves' sum is the dot tile.
__device__ __forceinline__ void store_dot_tile(float* red, const float (&acc)[2][4]) {
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) >> 2;
  const int t = threadIdx.x & 3;
  float* out = red + (warp >> 2) * kTile * kRedPitch + (16 * (warp & 1) + g) * kRedPitch;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int col = 16 * ((warp >> 1) & 1) + 8 * n + 2 * t;
    *reinterpret_cast<float2*>(out + col) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(out + 8 * kRedPitch + col) = make_float2(acc[n][2], acc[n][3]);
  }
}

// ---- K2 ------------------------------------------------------------------
//
// A class's work is its tile pairs (x tile a, y tile b) of 32 x 32 rows, in
// row-major order: every pair, or, for a symmetric call (x is y and wx is
// wy), the pairs a <= b, each off the diagonal counted twice (the same
// function summed in another order; the reference computes every pair).
// Its output is one scalar, so the pairs can be split across CTAs with no
// D-wide partial to combine: CTA (k, c) of a grid (split, C) takes pairs
// [P k / split, P (k + 1) / split) of class c (ops/mmd_kernels.py::
// sum_plan picks `split` to fill the card).  Per pair:
//   1. the y tile's norms, then x.y^T on mma.sync.m16n8k8 in 3xTF32 as K3
//      takes it (dot_tile_3xtf32: two depth halves meet in `red`);
//   2. each thread takes d2, the S exponentials and the weights of 4
//      pairs of rows in exact f32 and adds them to its running sum.
// The x tile is loaded when the walk reaches a new a; the y tiles arrive
// by TMA into a ring of kStages, each tile's load issued as soon as the
// tile two ahead of it is read, so two barriers a pair remain; y's norms
// and weights are double-buffered by stage for the same reason.  At the
// end the CTA's sum (a fixed shuffle tree, then the warps in order) goes
// to partials[c][k]; the CTA that takes the last integer ticket of its
// class sums the class's partials in a fixed order, writes out[c] and
// resets the ticket to 0 for the next call.  One launch, no float
// atomics, no memset.

// |x|^2, wx, kStages of |y|^2 and of wy, the warps' sums.
constexpr int kSumSmallFloats = (2 + 2 * kStages) * kTile + kWarps;

// Dynamic shared memory of one K2 CTA: alignment slack, the x tile and the
// y ring, `red`, the small arrays and the mbarriers (x, then the ring).
__host__ __device__ inline size_t sum_smem_bytes(int D) {
  const size_t dp = pad_features(D);
  return 1024 + sizeof(float) * (kTile * dp * (1 + kStages) + 2 * kTile * kRedPitch +
                                 kSumSmallFloats) + 8 * (kStages + 1);
}

// Pair p of a class's walk over ty tiles a side: (a, b) row-major over
// every pair, or over a <= b when symmetric.
__device__ inline void pair_at(long long p, int ty, int sym, int& a, int& b) {
  if (!sym) {
    a = static_cast<int>(p / ty);
    b = static_cast<int>(p % ty);
    return;
  }
  a = 0;
  while (p >= ty - a) {
    p -= ty - a;
    ++a;
  }
  b = a + static_cast<int>(p);
}

__device__ __forceinline__ void next_pair(int& a, int& b, int ty, int sym) {
  if (++b == ty) {
    ++a;
    b = sym ? a : 0;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
kernel_sum_3xtf32(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_y, const float* __restrict__ x,
                  const float* __restrict__ y, const float* __restrict__ wx,
                  const float* __restrict__ wy, int N, int M, int D, int tma, int sym, Sigmas sig,
                  unsigned* __restrict__ tickets,
                  float* __restrict__ partials, float* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int dp = pad_features(D);
  const int panels = dp / kPanel;
  float* ys = xs + kTile * dp;             // the ring, kStages tiles
  float* red = ys + kStages * kTile * dp;  // two (32, kRedPitch) halves of x.y^T
  float* x2 = red + 2 * kTile * kRedPitch;
  float* wxs = x2 + kTile;
  float* y2 = wxs + kTile;            // kStages of them
  float* wys = y2 + kStages * kTile;  // kStages of them
  float* wsum = wys + kStages * kTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(wsum + kWarps);

  const int split = static_cast<int>(gridDim.x);
  const int c = blockIdx.y;
  const int ty = (M + kTile - 1) / kTile;
  const long long pairs =
      sym ? static_cast<long long>(ty) * (ty + 1) / 2
          : static_cast<long long>((N + kTile - 1) / kTile) * ty;
  const long long p0 = pairs * blockIdx.x / split;
  const int mine = static_cast<int>(pairs * (blockIdx.x + 1) / split - p0);
  const float* xc = x + static_cast<long long>(c) * N * D;
  const float* yc = y + static_cast<long long>(c) * M * D;
  const float* wxc = wx + static_cast<long long>(c) * N;
  const float* wyc = wy + static_cast<long long>(c) * M;

  int a, b;  // the pair this iteration takes
  pair_at(p0, ty, sym, a, b);
  int la = a, lb = b;  // the next pair whose y tile thread 0 loads
  if (tma && threadIdx.x == 0) {
    for (int s = 0; s <= kStages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    tma_tile(xs, &tm_x, a * kTile, c, panels, &bars[0]);
    for (int it = 0; it < min(kStages, mine); ++it) {
      tma_tile(ys + it * kTile * dp, &tm_y, lb * kTile, c, panels, &bars[1 + it]);
      next_pair(la, lb, ty, sym);
    }
  }
  // Thread j < 32 holds wy of row j of the next y tile, loaded a tile ahead.
  float w_next = threadIdx.x < kTile && b * kTile + threadIdx.x < M
                     ? wyc[b * kTile + threadIdx.x] : 0.f;
  int xa = -1;  // the x tile in xs
  uint32_t x_phase = 0;
  const int i = threadIdx.x / 8;  // the x row of this thread's 4 pairs of rows
  float total = 0.f;
  for (int it = 0; it < mine; ++it) {
    const int s = it % kStages;
    if (a != xa) {
      __syncthreads();  // the barriers are set; every warp is past its reads of xs, x2, wxs
      if (tma) {
        if (threadIdx.x == 0 && xa >= 0) tma_tile(xs, &tm_x, a * kTile, c, panels, &bars[0]);
      } else {
        plain_tile(xs, xc, a * kTile, N, D, dp);
      }
      if (threadIdx.x < kTile) {
        const int r = a * kTile + threadIdx.x;
        wxs[threadIdx.x] = r < N ? wxc[r] : 0.f;
      }
      if (tma) {
        mbar_wait(&bars[0], x_phase);
        x_phase ^= 1;
      } else {
        __syncthreads();
      }
      tile_norms(x2, xs, dp);
      xa = a;
    }
    int na = a, nb = b;
    next_pair(na, nb, ty, sym);
    const float w_this = w_next;
    if (threadIdx.x < kTile && it + 1 < mine) {
      const int r = nb * kTile + threadIdx.x;
      w_next = r < M ? wyc[r] : 0.f;
    }
    float* yt = ys + s * kTile * dp;
    if (tma) {
      mbar_wait(&bars[1 + s], (it / kStages) & 1);
    } else {
      plain_tile(yt, yc, b * kTile, M, D, dp);
      __syncthreads();
    }
    float* y2t = y2 + s * kTile;
    float* wyt = wys + s * kTile;
    if (threadIdx.x < kTile) wyt[threadIdx.x] = w_this;
    tile_norms(y2t, yt, dp);
    float xy[2][4];
    dot_tile_3xtf32(xy, xs, yt, dp);
    __syncthreads();  // norms and weights written; this stage read; the last pair's sums done
    if (tma && threadIdx.x == 0 && it + kStages < mine) {
      tma_tile(yt, &tm_y, lb * kTile, c, panels, &bars[1 + s]);
      next_pair(la, lb, ty, sym);
    }
    store_dot_tile(red, xy);
    __syncthreads();
    const float xi2 = x2[i];
    const float wi = sym && a != b ? 2.f * wxs[i] : wxs[i];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = threadIdx.x % 8 + 8 * q;
      const int at = i * kRedPitch + j;
      const float d2 = sq_dist(xi2, y2t[j], red[at] + red[kTile * kRedPitch + at]);
      float k = 0.f;
#pragma unroll
      for (int e = 0; e < kMaxSigmas; ++e) {
        if (e < sig.count) k += expf(d2 * sig.coef[e]);
      }
      total += (wi * k) * wyt[j];
    }
    a = na;
    b = nb;
  }

  // The CTA's sum in a fixed order, then the class's, by its last CTA.
  for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(0xffffffffu, total, off);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) wsum[warp] = total;
  __syncthreads();
  if (warp != 0) return;
  int last = 0;
  if (lane == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += wsum[w];
    partials[static_cast<long long>(c) * split + blockIdx.x] = s;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicAdd(&tickets[c], 1u) == static_cast<unsigned>(split - 1);
  }
  last = __shfl_sync(0xffffffffu, last, 0);
  if (!last) return;
  __threadfence();  // every partial of the class is visible
  float s = 0.f;
  const float* class_partials = partials + static_cast<long long>(c) * split;
  for (int q = lane; q < split; q += 32) s += __ldcg(class_partials + q);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    out[c] = s;
    tickets[c] = 0;
  }
}

// ---- K3 ------------------------------------------------------------------
//
// One CTA of 256 threads owns (class, tile of 32 x rows, cluster rank) and
// walks the y tiles of 32 rows that its rank takes (rank, rank + cluster,
// ...).  Both tiles sit in shared memory as 128-byte panels of 32 features
// under the 128-byte swizzle (16-byte chunk ^ row % 8), the layout a TMA
// box with CU_TENSOR_MAP_SWIZZLE_128B writes.  Per y tile:
//   1. x.y^T on mma.sync.m16n8k8 in 3xTF32: warp w forms rows 16 (w & 1),
//      columns 16 ((w >> 1) & 1) over half of the depth steps of each
//      panel (w >> 2); the two halves meet in shared memory (`red`) and
//      are added in order.  Each operand is split as it is loaded.
//   2. Each thread takes d2, the exponentials, C and K for 4 pairs in exact
//      f32 and keeps its rows' partial rowsum(C) and sum_j wy_j K in
//      registers; C goes back to `red`, split into its TF32 high part and
//      residual.
//   3. C.y on mma.sync in 3xTF32: warp w owns 8-column tiles w, w + 8, ...
//      of the 32 x D product, accumulated in registers over the walk.  The
//      depth axis (j) is read in the order (0, 2, 4, 6, 1, 3, 5, 7) of each
//      8, so C's fragment is two 8-byte loads and the y fragment is
//      conflict-free under the same swizzle as step 1.
// y tiles arrive by TMA into a ring of kStages (a 3-D tensor map over
// (D, rows, C), so rows past M and features past D land as zeros) while the
// previous tile computes; without a map (D % 4 != 0 or an unaligned base)
// the threads load each tile themselves into the same layout.  At the end
// the cluster's CTAs leave their partial C.y, rowsum and dwx in shared
// memory; rank r sums rows [32 r / cluster, 32 (r + 1) / cluster) over the
// ranks in rank order through distributed shared memory and writes dx and
// dwx.  No float atomics and no scratch in device memory: repeated calls
// give the same bits.


// acc[m][s] += C.y for rows 16 m + [0, 16) and the 8 columns of tile
// w + 8 s, over the 32 rows of the y tile; C's TF32 parts are (32,
// kRedPitch) tiles `chi` and `clo`.
template <int NTD>
__device__ __forceinline__ void cy_tile(float (&acc)[2][NTD][4], const float* chi,
                                        const float* clo, const float* ys, int dp) {
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) >> 2;
  const int t = threadIdx.x & 3;
  // Rows j0 + 2t and j0 + 2t + 1, column 8 (w % 4) + g of panel w / 4 + 2 s.
  const float* y0 = ys + (warp >> 2) * kPanelFloats;
  const int off0 = 2 * t * kPanel + ((8 * (warp & 3) + g) ^ (8 * t));
  const int off1 = (2 * t + 1) * kPanel + ((8 * (warp & 3) + g) ^ (8 * t + 4));
#pragma unroll
  for (int j0 = 0; j0 < kTile; j0 += 8) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int at = (16 * m + g) * kRedPitch + j0 + 2 * t;
      const float2 h0 = *reinterpret_cast<const float2*>(chi + at);
      const float2 h1 = *reinterpret_cast<const float2*>(chi + at + 8 * kRedPitch);
      const float2 l0 = *reinterpret_cast<const float2*>(clo + at);
      const float2 l1 = *reinterpret_cast<const float2*>(clo + at + 8 * kRedPitch);
      ah[m][0] = __float_as_uint(h0.x);
      ah[m][1] = __float_as_uint(h1.x);
      ah[m][2] = __float_as_uint(h0.y);
      ah[m][3] = __float_as_uint(h1.y);
      al[m][0] = __float_as_uint(l0.x);
      al[m][1] = __float_as_uint(l1.x);
      al[m][2] = __float_as_uint(l0.y);
      al[m][3] = __float_as_uint(l1.y);
    }
#pragma unroll
    for (int s = 0; s < NTD; ++s) {
      if (8 * (warp + kWarps * s) < dp) {
        uint32_t bh0, bl0, bh1, bl1;
        split(y0[2 * s * kPanelFloats + j0 * kPanel + off0], bh0, bl0);
        split(y0[2 * s * kPanelFloats + j0 * kPanel + off1], bh1, bl1);
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_3xtf32(acc[m][s], ah[m], al[m], bh0, bh1, bl0, bl1);
      }
    }
  }
}

// NTD: 8-column tiles of C.y per warp, ceil(pad_features(D) / 64).
template <int NTD>
__global__ void __launch_bounds__(kThreads, NTD <= 4 ? 2 : 1)
kernel_sum_grad_3xtf32(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_y, const float* __restrict__ x,
                       const float* __restrict__ y, const float* __restrict__ wx,
                       const float* __restrict__ wy, int N, int M, int D, int tma, Sigmas sig,
                       float* __restrict__ dx, float* __restrict__ dwx) {
  extern __shared__ unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int dp = pad_features(D);
  const int panels = dp / kPanel;
  float* ys = xs + kTile * dp;               // the ring, kStages tiles
  float* red = ys + kStages * kTile * dp;    // two (32, kRedPitch) halves
  float* x2 = red + 2 * kTile * kRedPitch;
  float* wxs = x2 + kTile;
  float* y2 = wxs + kTile;
  float* wys = y2 + kTile;
  float* rsum = wys + kTile;
  float* dwsum = rsum + kTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(dwsum + kTile);  // x tile, then the ring

  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = blockIdx.y;
  const int x0 = (blockIdx.x / cl) * kTile;
  const int tiles = (M + kTile - 1) / kTile;
  const int mine = rank < tiles ? (tiles - rank + cl - 1) / cl : 0;  // y tiles of this rank
  const float* xc = x + static_cast<long long>(c) * N * D;
  const float* yc = y + static_cast<long long>(c) * M * D;
  const float* wyc = wy + static_cast<long long>(c) * M;

  if (tma && threadIdx.x == 0) {
    for (int s = 0; s <= kStages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    tma_tile(xs, &tm_x, x0, c, panels, &bars[0]);
    for (int it = 0; it < min(kStages, mine); ++it) {
      tma_tile(ys + it * kTile * dp, &tm_y, (rank + it * cl) * kTile, c, panels, &bars[1 + it]);
    }
  }
  if (!tma) plain_tile(xs, xc, x0, N, D, dp);
  if (threadIdx.x < kTile) {
    wxs[threadIdx.x] = x0 + threadIdx.x < N ? wx[static_cast<long long>(c) * N + x0 + threadIdx.x]
                                            : 0.f;
  }
  __syncthreads();
  if (tma) mbar_wait(&bars[0], 0);
  tile_norms(x2, xs, dp);

  float acc[2][NTD][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int s = 0; s < NTD; ++s) acc[m][s][0] = acc[m][s][1] = acc[m][s][2] = acc[m][s][3] = 0.f;
  }
  float rowsum = 0.f;
  float dw = 0.f;
  const int i = threadIdx.x / 8;  // the x row of this thread's 4 pairs
  // Thread j < 32 holds wy of row j of the next tile, loaded a tile ahead.
  const int wrow = (rank * kTile + threadIdx.x);
  float w_next = threadIdx.x < kTile && mine > 0 && wrow < M ? wyc[wrow] : 0.f;
  for (int it = 0; it < mine; ++it) {
    const int s = it % kStages;
    const int y0 = (rank + it * cl) * kTile;
    const float* yt = ys + s * kTile * dp;
    const float w_this = w_next;
    if (threadIdx.x < kTile && it + 1 < mine) {
      const int r = y0 + cl * kTile + threadIdx.x;
      w_next = r < M ? wyc[r] : 0.f;
    }
    if (tma) {
      mbar_wait(&bars[1 + s], (it / kStages) & 1);
    } else {
      plain_tile(ys + s * kTile * dp, yc, y0, M, D, dp);
      __syncthreads();
    }
    if (threadIdx.x < kTile) wys[threadIdx.x] = w_this;
    tile_norms(y2, yt, dp);
    float dot[2][4];
    dot_tile_3xtf32(dot, xs, yt, dp);
    __syncthreads();  // norms and weights written; every warp is past the last C.y
    const int next = it - 1 + kStages;  // into the stage the last tile left
    if (tma && threadIdx.x == 0 && it >= 1 && next < mine) {
      tma_tile(ys + (next % kStages) * kTile * dp, &tm_y, (rank + next * cl) * kTile, c, panels,
               &bars[1 + next % kStages]);
    }
    store_dot_tile(red, dot);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = threadIdx.x % 8 + 8 * q;
      const int at = i * kRedPitch + j;
      const float d2 = sq_dist(x2[i], y2[j], red[at] + red[kTile * kRedPitch + at]);
      float k = 0.f;
      float cw = 0.f;
#pragma unroll
      for (int e = 0; e < kMaxSigmas; ++e) {
        if (e < sig.count) {
          const float v = expf(d2 * sig.coef[e]);
          k += v;
          cw += v * sig.inv[e];
        }
      }
      const float cij = (wxs[i] * cw) * wys[j];
      rowsum += cij;
      dw += k * wys[j];
      uint32_t hi, lo;
      split(cij, hi, lo);
      red[at] = __uint_as_float(hi);
      red[kTile * kRedPitch + at] = __uint_as_float(lo);
    }
    __syncthreads();
    cy_tile<NTD>(acc, red, red + kTile * kRedPitch, yt, dp);
  }

  // The cluster's sum, in rank order, through distributed shared memory.
  __syncthreads();  // every warp is past its last C.y: the ring is free
  float* part = ys;  // (32, dp + 8) partial C.y
  const int pp = dp + 8;
  {
    const int warp = threadIdx.x / 32;
    const int g = (threadIdx.x % 32) >> 2;
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int s = 0; s < NTD; ++s) {
        const int col = 8 * (warp + kWarps * s);
        if (col < dp) {
          float* out = part + (16 * m + g) * pp + col + 2 * t;
          *reinterpret_cast<float2*>(out) = make_float2(acc[m][s][0], acc[m][s][1]);
          *reinterpret_cast<float2*>(out + 8 * pp) = make_float2(acc[m][s][2], acc[m][s][3]);
        }
      }
    }
  }
  for (int off = 1; off < 8; off <<= 1) {  // the row's 8 threads, in a fixed tree
    rowsum += __shfl_xor_sync(0xffffffffu, rowsum, off);
    dw += __shfl_xor_sync(0xffffffffu, dw, off);
  }
  if (threadIdx.x % 8 == 0) {
    rsum[i] = rowsum;
    dwsum[i] = dw;
  }
  cluster.sync();
  const int per = kTile / cl;
  const int chunks = dp / 4;  // 16-byte chunks of a row
  const bool vec = (D & 3) == 0;
#pragma unroll 4
  for (int e = threadIdx.x; e < per * chunks; e += kThreads) {
    const int li = e / chunks;
    const int d = 4 * (e - li * chunks);
    const int r = rank * per + li;
    if (x0 + r >= N || d >= D) continue;
    float rs = 0.f;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < cl; ++q) {
      rs += cluster.map_shared_rank(rsum, q)[r];
      const float4 u = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, q) +
                                                        r * pp + d);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const float4 xv = *reinterpret_cast<const float4*>(xs + swz(r, d));
    const float4 o = make_float4(v.x - rs * xv.x, v.y - rs * xv.y, v.z - rs * xv.z,
                                 v.w - rs * xv.w);
    float* out = dx + (static_cast<long long>(c) * N + x0 + r) * D + d;
    if (vec) {
      *reinterpret_cast<float4*>(out) = o;
    } else {
      out[0] = o.x;
      if (d + 1 < D) out[1] = o.y;
      if (d + 2 < D) out[2] = o.z;
      if (d + 3 < D) out[3] = o.w;
    }
  }
  if (dwx != nullptr) {
    for (int li = threadIdx.x; li < per && x0 + rank * per + li < N; li += kThreads) {
      const int r = rank * per + li;
      float w = 0.f;
      for (int q = 0; q < cl; ++q) w += cluster.map_shared_rank(dwsum, q)[r];
      dwx[static_cast<long long>(c) * N + x0 + r] = w;
    }
  }
  cluster.sync();  // no CTA leaves while the others read its shared memory
}

int make_sigmas(const float* sigmas, int S, Sigmas* out) {
  if (S < 1 || S > kMaxSigmas) return static_cast<int>(cudaErrorInvalidValue);
  out->count = S;
  for (int q = 0; q < kMaxSigmas; ++q) {
    out->coef[q] = q < S ? -1.0f / (2.0f * sigmas[q]) : 0.f;
    out->inv[q] = q < S ? 1.0f / sigmas[q] : 0.f;
  }
  return 0;
}

// 16-byte loads need D % 4 == 0 and 16-byte aligned bases.
bool can_vec4(const float* x, const float* y, int D) {
  return D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(y) % 16 == 0;
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (C, rows, D) f32 tensor read in (32 features, 32 rows, 1 class) boxes
// under the 128-byte swizzle; boxes past rows or D fill with zeros.
bool encode(CUtensorMap* map, const float* base, int C, int rows, int D) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(C)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 4,
                                 static_cast<cuuint64_t>(D) * 4 * rows};
  const cuuint32_t box[3] = {kPanel, kTile, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The K3 instance for D (8-column tiles of C.y per warp).
const void* grad_kernel(int D) {
  const int dp = pad_features(D);
  if (dp <= 64) return reinterpret_cast<const void*>(kernel_sum_grad_3xtf32<1>);
  if (dp <= 128) return reinterpret_cast<const void*>(kernel_sum_grad_3xtf32<2>);
  if (dp <= 256) return reinterpret_cast<const void*>(kernel_sum_grad_3xtf32<4>);
  return reinterpret_cast<const void*>(kernel_sum_grad_3xtf32<8>);
}

int launch_grad(const float* x, const float* y, const float* wx, const float* wy, int C, int N,
                int M, int D, int cluster, Sigmas sig, float* dx, float* dwx,
                cudaStream_t stream) {
  const void* kernel = grad_kernel(D);
  const size_t smem = grad_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tm_x = {};
  CUtensorMap tm_y = {};
  int tma = 0;
  if (can_vec4(x, y, D)) {
    if (!encode(&tm_x, x, C, N, D) || !encode(&tm_y, y, C, M, D)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    tma = 1;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + kTile - 1) / kTile) * cluster, C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&tm_x, &tm_y, const_cast<float**>(&x), const_cast<float**>(&y),
                  const_cast<float**>(&wx), const_cast<float**>(&wy), &N, &M, &D, &tma, &sig,
                  &dx, &dwx};
  return static_cast<int>(cudaLaunchKernelExC(&cfg, kernel, args));
}

int launch_sum(const float* x, const float* y, const float* wx, const float* wy, int C, int N,
               int M, int D, int split, int sym, Sigmas sig, unsigned* tickets, float* partials,
               float* out, cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(kernel_sum_3xtf32);
  const size_t smem = sum_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tm_x = {};
  CUtensorMap tm_y = {};
  int tma = 0;
  if (can_vec4(x, y, D)) {
    if (!encode(&tm_x, x, C, N, D)) return static_cast<int>(cudaErrorInvalidValue);
    if (sym) {
      tm_y = tm_x;
    } else if (!encode(&tm_y, y, C, M, D)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    tma = 1;
  }
  void* args[] = {&tm_x, &tm_y, const_cast<float**>(&x), const_cast<float**>(&y),
                  const_cast<float**>(&wx), const_cast<float**>(&wy), &N, &M, &D, &tma, &sym,
                  &sig, &tickets, &partials, &out};
  return static_cast<int>(
      cudaLaunchKernel(kernel, dim3(split, C), dim3(kThreads), args, smem, stream));
}
}  // namespace

extern "C" {

// K2.  x (C,N,D), y (C,M,D), wx (C,N), wy (C,M), tickets (C,), partials
// (C * split,) and out (C,) are device pointers; sigmas (S <= 8) is a host
// array.  `split` CTAs share each class's tile pairs (ops/mmd_kernels.py::
// sum_plan); with `symmetric` (x == y, wx == wy, N == M) only the pairs
// a <= b are taken.  tickets must be 0 before the first call, and every
// call leaves them 0.  x and y are read through TMA tensor maps when
// D % 4 == 0 and both are 16-byte aligned, else by plain loads.  Launches
// on `stream` and returns the launch's CUDA error (0 on success).
int zs3_mmd_kernel_sum(const float* x, const float* y, const float* wx, const float* wy,
                       int C, int N, int M, int D, const float* sigmas, int S, int split,
                       int symmetric, unsigned* tickets, float* partials, float* out,
                       void* stream) {
  if (C < 1 || N < 1 || M < 1 || D < 1 || D > kMaxD || split < 1 ||
      (symmetric && (N != M || x != y || wx != wy))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long ty = (M + kTile - 1) / kTile;
  const long long pairs = symmetric ? ty * (ty + 1) / 2 : ((N + kTile - 1) / kTile) * ty;
  if (split > pairs) return static_cast<int>(cudaErrorInvalidValue);
  Sigmas sig;
  const int err = make_sigmas(sigmas, S, &sig);
  if (err != 0) return err;
  return launch_sum(x, y, wx, wy, C, N, M, D, split, symmetric ? 1 : 0, sig, tickets, partials,
                    out, static_cast<cudaStream_t>(stream));
}

// K3: dx (C,N,D) and dwx (C,N) with respect to x; dwx may be null.  Same
// conventions as zs3_mmd_kernel_sum; `cluster` (1, 2, 4 or 8) CTAs share
// each tile of 32 x rows and split its y tiles (ops/mmd_kernels.py::
// grad_plan).  x and y are read through TMA tensor maps when D % 4 == 0 and
// both are 16-byte aligned, else by plain loads.
int zs3_mmd_kernel_sum_grad(const float* x, const float* y, const float* wx,
                            const float* wy, int C, int N, int M, int D,
                            const float* sigmas, int S, float* dx, float* dwx, int cluster,
                            void* stream) {
  if (C < 1 || N < 1 || M < 1 || D < 1 || D > kMaxD || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Sigmas sig;
  const int err = make_sigmas(sigmas, S, &sig);
  if (err != 0) return err;
  return launch_grad(x, y, wx, wy, C, N, M, D, cluster, sig, dx, dwx,
                     static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory (bytes) of one K3 CTA at D features (-1: D not taken).
int zs3_mmd_grad_smem(int D) {
  return D < 1 || D > kMaxD ? -1 : static_cast<int>(grad_smem_bytes(D));
}

// K3 CTAs an SM of the current device holds at D features, by the
// occupancy API (negative: a CUDA error).
int zs3_mmd_grad_ctas_per_sm(int D) {
  if (D < 1 || D > kMaxD) return -static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = grad_kernel(D);
  const size_t smem = grad_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  return err != cudaSuccess ? -static_cast<int>(err) : per_sm;
}
// Dynamic shared memory (bytes) of one K2 CTA at D features (-1: D not taken).
int zs3_mmd_sum_smem(int D) {
  return D < 1 || D > kMaxD ? -1 : static_cast<int>(sum_smem_bytes(D));
}

// K2 CTAs an SM of the current device holds at D features, by the
// occupancy API (negative: a CUDA error).
int zs3_mmd_sum_ctas_per_sm(int D) {
  if (D < 1 || D > kMaxD) return -static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = reinterpret_cast<const void*>(kernel_sum_3xtf32);
  const size_t smem = sum_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  return err != cudaSuccess ? -static_cast<int>(err) : per_sm;
}

const char* zs3_mmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
