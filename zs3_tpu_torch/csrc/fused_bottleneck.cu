// Fused eval-mode ResNet bottleneck (stride 1, identity skip, BN folded), for sm_90a.
//
// Replaces the TPU kernel zs3_tpu/ops/pallas_bottleneck.py::_kernel (entered
// through _block_call, fused_stage and fused_bottleneck): for x (B, H, W, C)
// NHWC and folded weights with f32 biases b1 (P), b2 (P), b3 (C), it writes
//     y1  = round(relu(x @ w1 + b1))                   (zero outside the image)
//     y2  = round(relu(dilated_conv3x3(y1, w2, d) + b2))
//     out = round(relu(y2 @ w3 + b3 + x))
// with f32 accumulation, y1 and y2 rounded to x's dtype after their ReLU,
// the residual added in f32 and the output rounded once (f32 or bf16).
//
// Bound on an H100 SXM.  Per output pixel the block does 2(2CP + 9P^2)
// FLOPs and moves 2C values (read x, write out): with C = 4P that is
// 34 P^2 FLOPs over 16 P bytes in bf16, 2.1 P FLOPs a byte, against the
// card's ~295.  So layer1 (P = 64) and layer2 (128) are bound by bytes,
// layer3 (256) and layer4 (512) by operations (chip_smoke.py k5_bound).
//
// bf16: one persistent, cooperative launch in three phases.  The grid is
// one CTA per co-resident slot (SMs x CTAs per SM from the occupancy API);
// each CTA walks the same static list of (64-pixel M tile, BN-channel N
// tile) work items of a phase (item i -> CTA i mod grid), and a grid-wide
// barrier (a counter in a buffer the wrapper zeroes; generation g waits
// for g x grid arrivals) separates the phases:
//   A. y1 = relu(x @ w1 + b1): a GEMM over all B H W pixels, K = C, N = P,
//      written into a row-padded scratch y1p of (B, H + 2d, Wt, P) with
//      Wt = W + 2d, the image at (d, d) and zeros around it (the pad is
//      zeroed by the CTAs before phase A);
//   B. y2 = relu(conv3x3_d(y1) + b2): an implicit GEMM over the padded
//      raster of each image (rows d .. H + d - 1, all Wt columns), K = 9 P.
//      Tap (a, b) is the constant row offset ((a - 1) Wt + b - 1) d of
//      y1p, so its A tile is one contiguous 64-row box; raster positions
//      in the pad columns are computed and dropped ((Wt - W) / Wt of phase
//      B's work: 6% at layer3, 33% at layer4's d = 8), and rows before or
//      after the tensor come back as TMA's zero fill;
//   C. out = relu(y2 @ w3 + b3 + x): a GEMM over the pixels, K = P, N = C,
//      the residual read in the epilogue.
// No pixel's y1 is computed twice.  y1 and y2 live in scratch the wrapper
// allocates; at eval batch 4 they are at most 8.8 MB (layer1's y1p)
// against the 50 MB L2, so their writes and the nine tap reads stay in L2:
// the card's counterpart of the TPU kernel keeping them in VMEM.
//
// In a CTA one producer warp issues TMA copies (cp.async.bulk.tensor, 2-D
// tensor maps with 128-byte swizzle, encoded here through the driver entry
// point so the library needs no -lcuda) of a 64 x 64 A tile and a BN x 64
// K-major weight tile into a ring of 4 stages, each with a full and an
// empty mbarrier; one consumer warpgroup runs wgmma.mma_async
// m64nBNk16 (bf16 in, f32 accumulate) on each stage as it lands, keeps
// one wgmma group in flight, and writes its epilogue straight from
// registers.  The weights come pre-packed (ops/bottleneck_kernels.py::
// pack_block): bf16, transposed to (N, K) so that each tile is K-major.
// The caller picks the N tile BN (ops/bottleneck_kernels.py::plan: 128,
// or 64 when P or C is not a multiple of 128 (layer1) or when phase B
// would leave CTAs without an item (layer3 at batch 4)); the rest of the
// layout is derived here from the shape (make_args).  Two or
// three CTAs fit an SM (under 100 KB of shared memory, 160 threads and at
// most 148 registers each), so one CTA's epilogue or barrier wait overlaps
// another's products: that beat a deeper ring with one CTA an SM on the
// card.  There is no setmaxnreg: it only moves registers inside a CTA's
// launch allocation, and the consumer's fit without it.
//
// f32: the exact-FMA kernel below, the parity path (wgmma has no exact f32
// and TF32 would break its 1e-5 tolerance).  One 256-thread block owns an
// image and a tile of th x tw output pixels (th <= 4, tw <= 16) and
//   1. computes y1 for every pixel the tile's dilated 3x3 taps read (th + 2d
//      rows, or 3 groups of th rows when d >= th, by tw + 2d columns) into
//      shared memory, zero outside the image;
//   2. accumulates y2 for the tile over the nine taps, reading y1 rows from
//      shared memory at each tap's offset, and rounds it into shared memory;
//   3. multiplies y2 by w3 in 64-channel column chunks, adds b3 and the
//      residual x read from global memory, and writes the output.
// Each product is a sequence of 64 x 64 weight chunks staged in shared
// memory, one output column per thread.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// ---------------------------------------------------------------- f32 path

constexpr int kThreads = 256;
constexpr int kKC = 64;                 // K chunk of every product
constexpr int kNC = 64;                 // N chunk (output columns) of every product
constexpr int kPad = 8;                 // row padding (elements): no bank conflicts
constexpr int kStage = kKC + kPad;      // pitch of the staged chunks
constexpr int kMaxHalo = 128;           // y1 rows a block holds
constexpr int kMaxTile = 64;            // output pixels a block owns
constexpr int kMaxSmem = 232448;        // H100: 227 KB a block

struct Geo {
  int H, W, C, P, d;   // image, channels, planes, dilation
  int th, tw;          // output tile
  int HR, HC;          // halo rows and columns of y1
  int NH, NHp;         // halo pixels, padded to 16
  int M, Mp;           // tile pixels, padded to 16
  int Pp, Cp;          // P and C padded to 64
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Halo row j of y1 -> image row, for the tile starting at row r0.
__device__ __forceinline__ int halo_image_row(const Geo& g, int r0, int j) {
  if (g.d >= g.th) return r0 + (j / g.th - 1) * g.d + j % g.th;
  return r0 - g.d + j;
}

// Halo row of tap row a (0, 1, 2) for tile row i.
__device__ __forceinline__ int halo_row(const Geo& g, int a, int i) {
  return g.d >= g.th ? a * g.th + i : i + a * g.d;
}

// Image pixel of halo pixel h (-1 outside the image or past the halo).
__device__ __forceinline__ long long halo_pixel(const Geo& g, int b, int r0, int c0, int h) {
  if (h >= g.NH) return -1;
  const int j = h / g.HC;
  const int r = halo_image_row(g, r0, j);
  const int c = c0 - g.d + (h - j * g.HC);
  if (r < 0 || r >= g.H || c < 0 || c >= g.W) return -1;
  return (static_cast<long long>(b) * g.H + r) * g.W + c;
}

// Image pixel of tile pixel m (-1 outside the image or past the tile).
__device__ __forceinline__ long long tile_pixel(const Geo& g, int b, int r0, int c0, int m) {
  if (m >= g.M) return -1;
  const int r = r0 + m / g.tw;
  const int c = c0 + m % g.tw;
  if (r >= g.H || c >= g.W) return -1;
  return (static_cast<long long>(b) * g.H + r) * g.W + c;
}

// Stage W[k0:k0+64, n0:n0+64] of a (K, N) row-major matrix as Bs[k][n],
// zero outside it.
__device__ __forceinline__ void stage_weights(float* Bs, const float* __restrict__ w, int K,
                                              int N, int k0, int n0) {
  for (int i = threadIdx.x; i < kKC * kNC; i += kThreads) {
    const int k = i / kNC;
    const int n = i - k * kNC;
    Bs[k * kStage + n] =
        (k0 + k < K && n0 + n < N) ? w[static_cast<long long>(k0 + k) * N + n0 + n] : 0.0f;
  }
}

// Stage x[halo pixel h, k0:k0+64] for every h < NHp, zero outside the image.
__device__ __forceinline__ void stage_halo(float* As, const float* __restrict__ x, const Geo& g,
                                           int b, int r0, int c0, int k0) {
  constexpr int kVec = 4;
  const bool vec = g.C % kVec == 0;
  for (int i = threadIdx.x; i < g.NHp * (kKC / kVec); i += kThreads) {
    const int h = i / (kKC / kVec);
    const int k = (i - h * (kKC / kVec)) * kVec;
    const long long pix = halo_pixel(g, b, r0, c0, h);
    float4 v;
    if (pix >= 0 && vec && k0 + k + kVec <= g.C) {
      v = __ldg(reinterpret_cast<const float4*>(x + pix * g.C + k0 + k));
    } else {
      float* e = &v.x;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        e[j] = (pix >= 0 && k0 + k + j < g.C) ? x[pix * g.C + k0 + k + j] : 0.0f;
      }
    }
    *reinterpret_cast<float4*>(As + h * kStage + k) = v;
  }
}

// One product chunk: (rows x 64) += A (rows x 64 k) x Bs, where arow(m)
// points at row m's 64 k values.  Exact FMAs; the thread owns column
// n = tid % 64 and rows tid / 64 + 4 q.
template <int N, typename ARow>
__device__ __forceinline__ void run_chunk(float (&acc)[N], int rows, ARow arow, const float* Bs) {
  const int n = threadIdx.x % kNC;
  const int m0 = threadIdx.x / kNC;
  const float* a[N];
#pragma unroll
  for (int q = 0; q < N; ++q) a[q] = arow(min(m0 + 4 * q, rows - 1));
#pragma unroll 4
  for (int k = 0; k < kKC; ++k) {
    const float bv = Bs[k * kStage + n];
#pragma unroll
    for (int q = 0; q < N; ++q) {
      if (m0 + 4 * q < rows) acc[q] = fmaf(a[q][k], bv, acc[q]);
    }
  }
}

// Calls f(m, n, value) for each accumulator run_chunk filled.
template <int N, typename F>
__device__ __forceinline__ void each_chunk(float (&acc)[N], int rows, F f) {
  const int n = threadIdx.x % kNC;
  const int m0 = threadIdx.x / kNC;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    if (m0 + 4 * q < rows) f(m0 + 4 * q, n, acc[q]);
  }
}

// Accumulators per thread: 32 for the halo's product (up to 128 rows), 16
// for the tile's (up to 64).
__global__ void __launch_bounds__(kThreads)
fused_bottleneck_f32(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, const float* __restrict__ w3,
                     const float* __restrict__ b3, float* __restrict__ out, Geo g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int py = g.Pp + kPad;                             // pitch of y1 and y2
  float* y1s = reinterpret_cast<float*>(smem_raw);        // (NHp, py)
  float* y2s = y1s + g.NHp * py;                          // (Mp, py)
  float* As = y2s + g.Mp * py;                            // (NHp, kStage): x's halo
  float* Bs = As + g.NHp * kStage;                        // (64, kStage): weights
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * g.th;
  const int c0 = blockIdx.x * g.tw;

  // 1. y1 over the halo.
  for (int n0 = 0; n0 < g.Pp; n0 += kNC) {
    float acc[kMaxHalo / 4] = {};
    for (int k0 = 0; k0 < g.Cp; k0 += kKC) {
      stage_halo(As, x, g, b, r0, c0, k0);
      stage_weights(Bs, w1, g.C, g.P, k0, n0);
      __syncthreads();
      run_chunk(acc, g.NHp, [&](int m) { return As + m * kStage; }, Bs);
      __syncthreads();
    }
    each_chunk(acc, g.NHp, [&](int h, int n, float v) {
      const bool inside = halo_pixel(g, b, r0, c0, h) >= 0;
      const float bias = n0 + n < g.P ? b1[n0 + n] : 0.0f;
      y1s[h * py + n0 + n] = inside ? fmaxf(v + bias, 0.0f) : 0.0f;
    });
  }
  __syncthreads();

  // 2. y2 over the tile: nine taps of y1, read at their offsets.
  for (int n0 = 0; n0 < g.Pp; n0 += kNC) {
    float acc[kMaxTile / 4] = {};
    for (int tap = 0; tap < 9; ++tap) {
      const int ta = tap / 3;
      const int tb = tap - 3 * ta;
      for (int k0 = 0; k0 < g.Pp; k0 += kKC) {
        stage_weights(Bs, w2 + static_cast<long long>(tap) * g.P * g.P, g.P, g.P, k0, n0);
        __syncthreads();
        run_chunk(acc, g.Mp, [&](int m) {
          m = min(m, g.M - 1);
          const int i = m / g.tw;
          const int h = halo_row(g, ta, i) * g.HC + (m - i * g.tw) + tb * g.d;
          return y1s + h * py + k0;
        }, Bs);
        __syncthreads();
      }
    }
    each_chunk(acc, g.Mp, [&](int m, int n, float v) {
      const float bias = n0 + n < g.P ? b2[n0 + n] : 0.0f;
      y2s[m * py + n0 + n] = fmaxf(v + bias, 0.0f);
    });
  }
  __syncthreads();

  // 3. out = relu(y2 @ w3 + b3 + x) in 64-channel chunks.
  for (int n0 = 0; n0 < g.Cp; n0 += kNC) {
    float acc[kMaxTile / 4] = {};
    for (int k0 = 0; k0 < g.Pp; k0 += kKC) {
      stage_weights(Bs, w3, g.P, g.C, k0, n0);
      __syncthreads();
      run_chunk(acc, g.Mp, [&](int m) { return y2s + m * py + k0; }, Bs);
      __syncthreads();
    }
    each_chunk(acc, g.Mp, [&](int m, int n, float v) {
      const long long pix = tile_pixel(g, b, r0, c0, m);
      if (pix < 0 || n0 + n >= g.C) return;
      const long long at = pix * g.C + n0 + n;
      out[at] = fmaxf(v + b3[n0 + n] + x[at], 0.0f);
    });
  }
}

size_t smem_bytes(const Geo& g) {
  const size_t py = g.Pp + kPad;
  return sizeof(float) * (static_cast<size_t>(g.NHp) * py + static_cast<size_t>(g.Mp) * py +
                          static_cast<size_t>(g.NHp) * kStage + static_cast<size_t>(kKC) * kStage);
}

// The tile: the most output pixels (th <= 4 rows, tw <= 16 columns spread
// evenly over the width) whose halo and working set fit; then the smallest
// halo.  Returns false when nothing fits.
bool plan_f32(int H, int W, int C, int P, int d, Geo* out) {
  const int col_tiles = (W + 15) / 16;
  const int tw_max = (W + col_tiles - 1) / col_tiles;
  bool found = false;
  Geo best{};
  for (int th = 1; th <= 4 && th <= H; ++th) {
    for (int tw = 1; tw <= tw_max; ++tw) {
      Geo g{};
      g.H = H; g.W = W; g.C = C; g.P = P; g.d = d; g.th = th; g.tw = tw;
      g.HR = d >= th ? 3 * th : th + 2 * d;
      g.HC = tw + 2 * d;
      g.NH = g.HR * g.HC;
      g.NHp = round_up(g.NH, 16);
      g.M = th * tw;
      g.Mp = round_up(g.M, 16);
      g.Pp = round_up(P, kNC);
      g.Cp = round_up(C, kNC);
      if (g.NHp > kMaxHalo || g.M > kMaxTile || smem_bytes(g) > kMaxSmem) continue;
      if (!found || g.M > best.M || (g.M == best.M && g.NHp < best.NHp)) {
        best = g;
        found = true;
      }
    }
  }
  *out = best;
  return found;
}

// --------------------------------------------------------------- bf16 path

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;                  // M tile: one warpgroup's wgmma rows
constexpr int kBK = 64;                  // K chunk: one 128-byte swizzled row
constexpr int kRing = 4;                 // stages of the copy ring
constexpr int kWgThreads = 160;          // one consumer warpgroup + one producer warp
constexpr int kATile = kBM * kBK * 2;    // bytes of an A tile

// The layout of one launch (make_args); ops/bottleneck_kernels.py::plan
// reports the same numbers.
struct Args {
  int B, H, W, C, P, d;
  int Wt, Hp;          // y1p: Hp = H + 2d rows of Wt = W + 2d positions an image
  int M;               // B H W pixels
  int tiles_img;       // phase B's M tiles per image
  int m[3], n[3], k[3];  // per phase: M tiles, N tiles, K chunks
};
template <int BN>
__host__ __device__ constexpr int stage_bytes() { return kATile + BN * kBK * 2; }

template <int BN>
constexpr int wg_smem_bytes() {
  return 1024 + kRing * stage_bytes<BN>() + 2 * kRing * 8;  // align, ring, barriers
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// A wait that outlasts this (about 10 s of SM clock) traps instead of
// holding the card: the launch fails, and the trap is sticky, so the
// process's CUDA context is lost and every later CUDA call in it fails
// too (the process must be restarted).
constexpr long long kHangCycles = 20000000000LL;

__device__ __forceinline__ void hang_check(long long& t0) {
  if (t0 == 0) {
    t0 = clock64();
  } else if (clock64() - t0 > kHangCycles) {
    __trap();
  }
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
    hang_check(t0);
  }
}

// TMA: the (64 x rows) box at (col, row) of a 2-D tensor map into shared
// memory, completing on `bar`; boxes past the tensor fill with zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int col, int row,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
         "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows with 128-byte
// swizzle: 8-row groups 1024 bytes apart (SBO), layout type 1 (B128).
__device__ __forceinline__ uint64_t wg_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 64, f32) += A (64 x 16) B (16 x 64), both K-major in shared memory.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16) B (16 x 128), both K-major in shared memory.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t da, uint64_t db) {
  wgmma_n64(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t da, uint64_t db) {
  wgmma_n128(d, da, db);
}

// Grid-wide barrier number `gen` (1, 2): every CTA's writes before it are
// visible to every CTA's loads after it, TMA's included.
__device__ __forceinline__ void grid_barrier(unsigned int* counter, unsigned int gen) {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    const unsigned int target = gen * gridDim.x;
    unsigned int seen;
    long long t0 = 0;
    while (true) {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];\n"
                   : "=r"(seen) : "l"(counter) : "memory");
      if (seen >= target) break;
      hang_check(t0);
      __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// v[ph] without indexing the kernel's parameters at run time (which
// would copy them to local memory).
__device__ __forceinline__ int of_phase(const int (&v)[3], int ph) {
  return ph == 0 ? v[0] : (ph == 1 ? v[1] : v[2]);
}

// Phase B: first raster row of M tile mt (in y1p's rows).
__device__ __forceinline__ int raster_row(const Args& g, int mt) {
  const int img = mt / g.tiles_img;
  return (img * g.Hp + g.d) * g.Wt + (mt - img * g.tiles_img) * kBM;
}

template <int BN>
__global__ void __launch_bounds__(kWgThreads, 2)
fused_bottleneck_bf16(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_y1,
                      const __grid_constant__ CUtensorMap tm_y2,
                      const __grid_constant__ CUtensorMap tm_w1,
                      const __grid_constant__ CUtensorMap tm_w2,
                      const __grid_constant__ CUtensorMap tm_w3,
                      const bf16* __restrict__ x, const float* __restrict__ b1,
                      const float* __restrict__ b2, const float* __restrict__ b3,
                      bf16* __restrict__ y1p, bf16* __restrict__ y2, bf16* __restrict__ out,
                      unsigned int* __restrict__ counter, const Args g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRing * stage_bytes<BN>());
  uint64_t* empty = full + kRing;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // Zero y1p's pad (rows and columns around each image) before phase A
  // writes the inside.
  {
    const int vecs = g.P / 8;
    const long long total = static_cast<long long>(g.B) * g.Hp * g.Wt * vecs;
    const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
         i += step) {
      const long long pos = i / vecs;
      const int col = static_cast<int>(pos % g.Wt);
      const int row = static_cast<int>((pos / g.Wt) % g.Hp);
      if (row >= g.d && row < g.H + g.d && col >= g.d && col < g.W + g.d) continue;
      reinterpret_cast<uint4*>(y1p)[i] = make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int stage = 0;
  uint32_t parity = 0;
  const int pk = g.P / kBK;  // K chunks of one tap

  for (int ph = 0; ph < 3; ++ph) {
    const int n_tiles = of_phase(g.n, ph);
    const int items = of_phase(g.m, ph) * n_tiles;
    const int nk = of_phase(g.k, ph);
    if (warp == 4) {
      // Producer: lane 0 keeps the ring full.
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int mt = it / n_tiles;
        const int n0 = (it - mt * n_tiles) * BN;
        for (int kc = 0; kc < nk; ++kc) {
          if (lane == 0) {
            mbar_wait(&empty[stage], parity ^ 1);
            mbar_expect_tx(&full[stage], stage_bytes<BN>());
            unsigned char* a = smem + stage * stage_bytes<BN>();
            unsigned char* b = a + kATile;
            if (ph == 0) {
              tma_load(a, &tm_x, kc * kBK, mt * kBM, &full[stage]);
              tma_load(b, &tm_w1, kc * kBK, n0, &full[stage]);
            } else if (ph == 1) {
              const int tap = kc / pk;
              const int kk = (kc - tap * pk) * kBK;
              const int ta = tap / 3, tb = tap - 3 * (tap / 3);
              const int row = raster_row(g, mt) + ((ta - 1) * g.Wt + (tb - 1)) * g.d;
              tma_load(a, &tm_y1, kk, row, &full[stage]);
              tma_load(b, &tm_w2, kk, tap * g.P + n0, &full[stage]);
            } else {
              tma_load(a, &tm_y2, kc * kBK, mt * kBM, &full[stage]);
              tma_load(b, &tm_w3, kc * kBK, n0, &full[stage]);
            }
          }
          if (++stage == kRing) {
            stage = 0;
            parity ^= 1;
          }
        }
      }
      __syncwarp();
    } else {
      // Consumer warpgroup.
      float acc[BN / 2];
      const int r_lo = 16 * warp + lane / 4;  // rows r_lo and r_lo + 8 of the tile
      const int cb = 2 * (lane % 4);          // columns cb, cb + 1 of each 8-column group
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int mt = it / n_tiles;
        const int n0 = (it - mt * n_tiles) * BN;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
        fence_regs(acc);
        int prev = -1;
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(&full[stage], parity);
          const uint32_t a = smem_u32(smem + stage * stage_bytes<BN>());
          const uint32_t b = a + kATile;
          wg_fence();
#pragma unroll
          for (int ks = 0; ks < kBK / 16; ++ks) {
            wgmma<BN>(acc, wg_desc(a + 32 * ks), wg_desc(b + 32 * ks));
          }
          wg_commit();
          wg_wait<1>();  // the previous stage's products are done: release it
          if (prev >= 0 && threadIdx.x == 0) mbar_arrive(&empty[prev]);
          prev = stage;
          if (++stage == kRing) {
            stage = 0;
            parity ^= 1;
          }
        }
        wg_wait<0>();
        fence_regs(acc);
        if (prev >= 0 && threadIdx.x == 0) mbar_arrive(&empty[prev]);

        // Epilogue: rows r_lo + 8 h, columns n0 + 8 j + cb (+1).
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r_lo + 8 * h;
          long long pix;
          if (ph == 1) {
            const int local = raster_row(g, mt) - (mt / g.tiles_img) * g.Hp * g.Wt + r;
            const int rr = local / g.Wt, cc = local - (local / g.Wt) * g.Wt;
            pix = (rr < g.H + g.d && cc >= g.d && cc < g.W + g.d)
                      ? (static_cast<long long>(mt / g.tiles_img) * g.H + rr - g.d) * g.W + cc - g.d
                      : -1;
          } else {
            pix = mt * kBM + r < g.M ? static_cast<long long>(mt) * kBM + r : -1;
          }
          if (pix < 0) continue;
          if (ph == 0) {
            const long long hw = static_cast<long long>(g.H) * g.W;
            const long long img = pix / hw;
            const int rr = static_cast<int>((pix - img * hw) / g.W);
            const int cc = static_cast<int>(pix - img * hw - static_cast<long long>(rr) * g.W);
            bf16* dst = y1p + ((img * g.Hp + rr + g.d) * g.Wt + cc + g.d) * g.P + n0 + cb;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              const float2 bias = *reinterpret_cast<const float2*>(b1 + n0 + 8 * j + cb);
              *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
                  fmaxf(acc[4 * j + 2 * h] + bias.x, 0.0f),
                  fmaxf(acc[4 * j + 2 * h + 1] + bias.y, 0.0f));
            }
          } else if (ph == 1) {
            bf16* dst = y2 + pix * g.P + n0 + cb;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              const float2 bias = *reinterpret_cast<const float2*>(b2 + n0 + 8 * j + cb);
              *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
                  fmaxf(acc[4 * j + 2 * h] + bias.x, 0.0f),
                  fmaxf(acc[4 * j + 2 * h + 1] + bias.y, 0.0f));
            }
          } else {
            const long long at = pix * g.C + n0 + cb;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              const float2 bias = *reinterpret_cast<const float2*>(b3 + n0 + 8 * j + cb);
              const float2 res = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(x + at + 8 * j));
              *reinterpret_cast<__nv_bfloat162*>(out + at + 8 * j) = __floats2bfloat162_rn(
                  fmaxf(acc[4 * j + 2 * h] + bias.x + res.x, 0.0f),
                  fmaxf(acc[4 * j + 2 * h + 1] + bias.y + res.y, 0.0f));
            }
          }
        }
      }
    }
    if (ph < 2) grid_barrier(counter, ph + 1);
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime.
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

// A (rows, cols) row-major bf16 matrix, read in boxes of box_rows x 64.
bool encode(CUtensorMap* map, const void* ptr, long long rows, int cols, int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The layout of a launch over x (B, H, W, C) with P planes at dilation d
// and N tile bn; false when the bf16 kernel does not take the shape.
bool make_args(int B, int H, int W, int C, int P, int d, int bn, Args* g) {
  if (B < 1 || H < 1 || W < 1 || d < 1 || C < 64 || P < 64 || C % 64 || P % 64 ||
      (bn != 64 && bn != 128) || C % bn || P % bn) {
    return false;
  }
  g->B = B; g->H = H; g->W = W; g->C = C; g->P = P; g->d = d;
  g->Wt = W + 2 * d;
  g->Hp = H + 2 * d;
  g->M = B * H * W;
  g->tiles_img = (H * g->Wt + kBM - 1) / kBM;
  const int mt = (g->M + kBM - 1) / kBM;
  const int m[3] = {mt, B * g->tiles_img, mt};
  const int n[3] = {P / bn, P / bn, C / bn};
  const int k[3] = {C / kBK, 9 * P / kBK, P / kBK};
  for (int i = 0; i < 3; ++i) {
    g->m[i] = m[i];
    g->n[i] = n[i];
    g->k[i] = k[i];
  }
  return true;
}

constexpr int kMaxDevices = 64;

// CTAs of fused_bottleneck_bf16<BN> an SM of the current device holds, by
// the occupancy API, and the device's SM count: asked once per device
// (with the kernel's shared-memory attribute set then) and kept, so a
// launch pays no query.  Returns 0 or a CUDA error.
template <int BN>
int residency(int* per_sm, int* sms) {
  static std::atomic<int> per_sm_of[kMaxDevices];
  static std::atomic<int> sms_of[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  *per_sm = per_sm_of[dev].load(std::memory_order_acquire);
  *sms = sms_of[dev].load(std::memory_order_acquire);
  if (*per_sm > 0 && *sms > 0) return 0;
  err = cudaFuncSetAttribute(fused_bottleneck_bf16<BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, wg_smem_bytes<BN>());
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fused_bottleneck_bf16<BN>,
                                                        kWgThreads, wg_smem_bytes<BN>());
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  sms_of[dev].store(*sms, std::memory_order_release);
  per_sm_of[dev].store(*per_sm, std::memory_order_release);
  return 0;
}

template <int BN>
int launch_bf16(const Args& g, const bf16* x, const bf16* w1t, const float* b1, const bf16* w2t,
                const float* b2, const bf16* w3t, const float* b3, bf16* y1p, bf16* y2,
                unsigned int* counter, bf16* out, cudaStream_t stream) {
  CUtensorMap tm[6];
  const long long y1_rows = static_cast<long long>(g.B) * g.Hp * g.Wt;
  if (!encode(&tm[0], x, g.M, g.C, kBM) || !encode(&tm[1], y1p, y1_rows, g.P, kBM) ||
      !encode(&tm[2], y2, g.M, g.P, kBM) || !encode(&tm[3], w1t, g.P, g.C, BN) ||
      !encode(&tm[4], w2t, 9LL * g.P, g.P, BN) || !encode(&tm[5], w3t, g.C, g.P, BN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int per_sm = 0, sms = 0;
  const int err = residency<BN>(&per_sm, &sms);
  if (err != 0) return err;
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* params[] = {&tm[0], &tm[1], &tm[2], &tm[3], &tm[4], &tm[5], &x, &b1, &b2, &b3,
                    &y1p, &y2, &out, &counter, const_cast<Args*>(&g)};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_bottleneck_bf16<BN>), dim3(sms * per_sm),
      dim3(kWgThreads), params, wg_smem_bytes<BN>(), stream));
}

}  // namespace

extern "C" {

// f32, exact FMAs.  Launches on `stream` and returns cudaGetLastError()
// (0 on success).  x and out are contiguous (B, H, W, C) NHWC f32 and must
// not overlap; w1 (C, P), w2 (3, 3, P, P), w3 (P, C), b1, b2 (P) and b3 (C)
// are contiguous f32.  All pointers are device pointers; nothing is
// allocated here.
int zs3_fused_bottleneck_f32(const float* x, int B, int H, int W, int C, int P, int d,
                             const float* w1, const float* b1, const float* w2, const float* b2,
                             const float* w3, const float* b3, float* out, void* stream) {
  Geo g;
  if (B < 1 || H < 1 || W < 1 || C < 1 || P < 1 || d < 1 || !plan_f32(H, W, C, P, d, &g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(g);
  cudaError_t err = cudaFuncSetAttribute(fused_bottleneck_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g.W + g.tw - 1) / g.tw, (g.H + g.th - 1) / g.th, B);
  fused_bottleneck_f32<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w1, b1, w2, b2, w3, b3, out, g);
  return static_cast<int>(cudaGetLastError());
}

// The f32 kernel's tile: writes {th, tw, halo pixels, smem bytes} and
// returns 0, or returns -1 when no tile fits shared memory.
int zs3_fused_bottleneck_f32_plan(int H, int W, int C, int P, int d, int* info) {
  Geo g;
  if (H < 1 || W < 1 || C < 1 || P < 1 || d < 1 || !plan_f32(H, W, C, P, d, &g)) return -1;
  info[0] = g.th;
  info[1] = g.tw;
  info[2] = g.NH;
  info[3] = static_cast<int>(smem_bytes(g));
  return 0;
}

// bf16, the persistent wgmma kernel, one cooperative launch on `stream`;
// returns the launch's error (0 on success).  x and out are contiguous
// (B, H, W, C) bf16 with C and P multiples of 64 and of the N tile bn (64
// or 128); w1t (P, C), w2t (9 P, P) (tap-major, then output channel) and
// w3t (C, P) are the transposed bf16 weights of pack_block; b1, b2 (P), b3
// (C) f32; y1p (B, H + 2d, W + 2d, P) and y2 (B H W, P) bf16 scratch;
// counter one zeroed uint32.  Device pointers 16-byte aligned; nothing is
// allocated here.
int zs3_fused_bottleneck_bf16(int B, int H, int W, int C, int P, int d, int bn, const void* x,
                              const void* w1t, const float* b1, const void* w2t, const float* b2,
                              const void* w3t, const float* b3, void* y1p, void* y2,
                              unsigned int* counter, void* out, void* stream) {
  Args g;
  if (!make_args(B, H, W, C, P, d, bn, &g)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const bf16 *xb = static_cast<const bf16*>(x), *w1 = static_cast<const bf16*>(w1t),
             *w2 = static_cast<const bf16*>(w2t), *w3 = static_cast<const bf16*>(w3t);
  bf16 *y1 = static_cast<bf16*>(y1p), *y2b = static_cast<bf16*>(y2), *o = static_cast<bf16*>(out);
  if (bn == 64) return launch_bf16<64>(g, xb, w1, b1, w2, b2, w3, b3, y1, y2b, counter, o, s);
  return launch_bf16<128>(g, xb, w1, b1, w2, b2, w3, b3, y1, y2b, counter, o, s);
}

// CTAs of the bf16 kernel with N tile bn (64 or 128) that one SM of the
// current device holds, by the occupancy API (negative: a CUDA error).
// The launch takes its grid from the same query; ops/bottleneck_kernels.py
// reads it to pick the N tile.
int zs3_fused_bottleneck_bf16_ctas_per_sm(int bn) {
  int per_sm = 0, sms = 0, err;
  if (bn == 64) {
    err = residency<64>(&per_sm, &sms);
  } else if (bn == 128) {
    err = residency<128>(&per_sm, &sms);
  } else {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  return err != 0 ? -err : per_sm;
}

const char* zs3_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
