// Fused bilinear upsample + argmax over classes (eval path), for sm_90a.
//
// Replaces the TPU kernel zs3_tpu/ops/pallas_eval.py::_kernel (entered
// through upsample_argmax and predict_labels): for logits (B, HI, WI, C)
// NHWC, f32 or bf16, it writes labels (B, HO, WO) int32 with
//     labels = argmax_c(resize_bilinear(logits, (HO, WO), align_corners))
// in f32 arithmetic, where the first maximum wins (strict '>'), as
// jnp.argmax and the Pallas kernel do.  bf16 logits are widened exactly,
// so they give the labels of their f32 copy without a cast launch.
//
// Bound on an H100 SXM, by bytes: the function must read the logits once
// and write the labels once, B * (HI*WI*C*4 + HO*WO*4) bytes in f32, 2.45
// MB an image at 129x129x21 -> 513x513 (1.75 MB in bf16), 2.9 us at B=4
// and 11.7 us at B=16 at 3.35 TB/s.  Its own arithmetic bounds it first:
// the W blend (3 instructions) and the compare (3) of each of the 22 M
// pixel-classes at B=4, with the H blends, loads and loop about 8.6 SASS
// instructions a pixel and class.  Its time follows that count, not its
// bytes or its occupancy (chip_smoke.py::k1_parts; PERF.md, kernel table).
//
// The design.  The host (ops/eval_kernels.py::plan) cuts each axis into
// runs of output positions whose two taps lie on one pair of source
// positions (L, L+1): rows into groups of at most 2, columns into runs of
// at most 5 (4 at exact 4x: 129 -> 513 is 128 runs, the first of 5).  A
// thread owns one (row group, column run) tile.  For each class it loads
// the four source values of its pair of rows and pair of columns once,
// blends along H for both columns of each row, then along W for each
// column, and keeps a running (best, arg) per pixel in registers: one
// shared-memory load per 2-2.5 pixels and class, against two per pixel in
// the kernel this one replaces.  Each tap is fl(fl(wa*a) + fl(wb*b))
// (__fmul_rn/__fadd_rn: never contracted into an FMA), H first, then W,
// the order of the JAX package.  An output whose taps are one source
// position carries weight 0 on the other of its pair: for finite logits
// that adds a zero, so every label equals the tap table's arithmetic
// (tests/test_torch_port_k1.py replays both).  Whether a tile blends a
// fifth column is decided per warp, so no branch divides a warp inside
// the class loop.  512 threads and at most 64 registers: two CTAs an SM.
//
// One CTA takes one (image, band of row groups).  The band's source rows
// are one contiguous span of the logits; thread 0 copies it into shared
// memory with bulk asynchronous copies (cp.async.bulk, one per source
// row, each completing on its own mbarrier), all issued at the start, so
// a thread waits only for the rows its tile blends and the first groups
// compute while the later rows land.  Neither the image offset nor the
// row pitch is 16-byte aligned (10,836 bytes at 129x21 f32), so the copy
// starts at the span's address rounded down to 16 bytes and each row's
// copy ends at its end rounded up: the bytes read outside the span lie in
// the 16-byte blocks that hold its ends, inside the allocation, and are
// never used.  The staged rows are read in the logits' own type (bf16 is
// widened at the load by a shift).  Labels are gathered in shared memory
// and stored as 16-byte vectors along the band's output rows (one
// contiguous range of the labels), with scalar stores at its ends.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kRows = 2;  // rows of a tile
constexpr int kCols = 4;  // columns of a tile, and a fifth in the warps that need one

struct Geo {
  const unsigned char* logits;  // (B, HI, WI, C), f32 or bf16
  int* out;                     // (B, HO, WO) int32
  const int4* groups;           // row groups: (first output row, rows, source row L, 0)
  const int4* runs;             // column runs: (first output column, columns, source column L, 0)
  const float2* row_w;          // per output row: weights of source rows L and L+1
  const float2* col_w;          // per output column: weights of source columns L and L+1
  int HI, WI, C, HO, WO;
  int ngroups, nruns, groups_per_band, nbands;
  int off_src, off_lab;  // byte offsets in shared memory (the barriers at 0)
};

__device__ __forceinline__ float blend(float wa, float a, float wb, float b) {
  return __fadd_rn(__fmul_rn(wa, a), __fmul_rn(wb, b));
}

__device__ __forceinline__ float widen(const float* p) { return *p; }
__device__ __forceinline__ float widen(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(p))
                         << 16);
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

// A wait that outlasts this (about 10 s of SM clock) traps instead of
// holding the card: the launch fails, and the trap is sticky (the
// process's CUDA context is lost).
constexpr long long kHangCycles = 20000000000LL;

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

// `bytes` (a multiple of 16) from 16-byte aligned global `src` to
// 16-byte aligned shared `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, uintptr_t src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void take(float v, int k, float& best, int& arg) {
  if (v > best) {  // strict: the first maximum wins
    best = v;
    arg = k;
  }
}

// One class k of a tile: the four source values, the H blends of both
// columns for each row, the W blends and the running argmax.
template <bool kFirst, bool kFifth, typename T>
__device__ __forceinline__ void tile_class(
    const T* a0, const T* b0, const T* a1, const T* b1, int k,
    const float (&wra)[kRows], const float (&wrb)[kRows],
    const float (&wca)[kCols + 1], const float (&wcb)[kCols + 1],
    float (&best)[kRows][kCols + 1], int (&arg)[kRows][kCols + 1]) {
  const float va0 = widen(a0 + k), vb0 = widen(b0 + k);
  const float va1 = widen(a1 + k), vb1 = widen(b1 + k);
  float ha[kRows], hb[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    ha[r] = blend(wra[r], va0, wrb[r], va1);
    hb[r] = blend(wra[r], vb0, wrb[r], vb1);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < (kFifth ? kCols + 1 : kCols); ++j) {
      const float v = blend(wca[j], ha[r], wcb[j], hb[r]);
      if (kFirst) {
        best[r][j] = v;
        arg[r][j] = 0;
      } else {
        take(v, k, best[r][j], arg[r][j]);
      }
    }
  }
}

// A tile's labels over all C classes.  With kFifth every lane blends a
// fifth column (a copy of its last where its run has four).
template <bool kFifth, typename T>
__device__ __forceinline__ void tile_labels(
    const T* a0, const T* b0, const T* a1, const T* b1, int C,
    const float (&wra)[kRows], const float (&wrb)[kRows],
    const float (&wca)[kCols + 1], const float (&wcb)[kCols + 1],
    int (&arg)[kRows][kCols + 1]) {
  float best[kRows][kCols + 1];
  tile_class<true, kFifth>(a0, b0, a1, b1, 0, wra, wrb, wca, wcb, best, arg);
#pragma unroll 2
  for (int k = 1; k < C; ++k) {
    tile_class<false, kFifth>(a0, b0, a1, b1, k, wra, wrb, wca, wcb, best, arg);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2) upsample_argmax_kernel(const Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int* lab = reinterpret_cast<int*>(smem + g.off_lab);

  const int band = static_cast<int>(blockIdx.x % g.nbands);
  const long long b = blockIdx.x / g.nbands;
  const int g0 = band * g.groups_per_band;
  const int gn = min(g.groups_per_band, g.ngroups - g0);
  const int4 first = g.groups[g0];
  const int4 last = g.groups[g0 + gn - 1];
  const int o0 = first.x;
  const int r0 = first.z;                                 // first staged source row
  const int nrows = min(last.z + 1, g.HI - 1) - r0 + 1;  // staged source rows
  const long long row_bytes = static_cast<long long>(g.WI) * g.C * sizeof(T);
  const uintptr_t gs = reinterpret_cast<uintptr_t>(g.logits) + (b * g.HI + r0) * row_bytes;
  const uintptr_t base = gs & ~static_cast<uintptr_t>(15);
  if (threadIdx.x == 0) {
    for (int k = 0; k < nrows; ++k) mbar_init(&bars[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // Stage k ends where row k ends, rounded up to 16 bytes: rows 0..k
    // are whole once stages 0..k have landed.
    uintptr_t lo = base;
    for (int k = 0; k < nrows; ++k) {
      const uintptr_t hi = (gs + (k + 1) * row_bytes + 15) & ~static_cast<uintptr_t>(15);
      const uint32_t bytes = static_cast<uint32_t>(hi > lo ? hi - lo : 0);
      mbar_expect_tx(&bars[k], bytes);
      if (bytes) bulk_load(smem + g.off_src + (lo - base), lo, bytes, &bars[k]);
      lo = hi > lo ? hi : lo;
    }
  }
  __syncthreads();

  // The labels of the band, (rows, WO), start at `sh` in `lab`, so that
  // lab[4 i] lines up with a 16-byte boundary of the output.
  const long long ob = (b * g.HO + o0) * static_cast<long long>(g.WO);
  const int sh = static_cast<int>(((reinterpret_cast<uintptr_t>(g.out) >> 2) + ob) & 3);
  const T* src = reinterpret_cast<const T*>(smem + g.off_src + (gs - base));
  const int items = gn * g.nruns;
  for (int t = threadIdx.x; t < items; t += blockDim.x) {
    const int gl = t / g.nruns;
    // Groups rotate their runs by a warp each: the run of five columns
    // falls on another warp scheduler in each group.
    const int4 grp = g.groups[g0 + gl];
    const int4 run = g.runs[(t % g.nruns + 32 * gl) % g.nruns];
    float wra[kRows], wrb[kRows], wca[kCols + 1], wcb[kCols + 1];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {  // rows past the group's repeat its last
      const float2 w = g.row_w[grp.x + min(r, grp.y - 1)];
      wra[r] = w.x;
      wrb[r] = w.y;
    }
#pragma unroll
    for (int j = 0; j <= kCols; ++j) {
      const float2 w = g.col_w[run.x + min(j, run.y - 1)];
      wca[j] = w.x;
      wcb[j] = w.y;
    }
    const int ra = grp.z - r0;
    const int rb = min(grp.z + 1, g.HI - 1) - r0;
    const int ca = run.z;
    const int cb = min(run.z + 1, g.WI - 1);
    for (int k = 0; k <= rb; ++k) mbar_wait(&bars[k], 0);
    const T* a0 = src + (ra * g.WI + ca) * g.C;
    const T* b0 = src + (ra * g.WI + cb) * g.C;
    const T* a1 = src + (rb * g.WI + ca) * g.C;
    const T* b1 = src + (rb * g.WI + cb) * g.C;
    // The fifth column is decided per warp, so that no branch divides a
    // warp inside the class loop (one warp in four at 129 -> 513).
    int arg[kRows][kCols + 1];
    if (__any_sync(__activemask(), run.y > kCols)) {
      tile_labels<true>(a0, b0, a1, b1, g.C, wra, wrb, wca, wcb, arg);
    } else {
      tile_labels<false>(a0, b0, a1, b1, g.C, wra, wrb, wca, wcb, arg);
    }
    int* dst = lab + sh + (grp.x - o0) * g.WO + run.x;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j <= kCols; ++j) {
        if (r < grp.y && j < run.y) dst[r * g.WO + j] = arg[r][j];
      }
    }
  }
  __syncthreads();

  const int n = (last.x + last.y - o0) * g.WO;
  const int nvec = (sh + n + 3) >> 2;
  int* out = g.out + ob - sh;  // 16-byte aligned
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const int e0 = 4 * i;
    if (e0 >= sh && e0 + 4 <= sh + n) {
      reinterpret_cast<int4*>(out)[i] = reinterpret_cast<const int4*>(lab)[i];
    } else {
      for (int e = max(e0, sh); e < min(e0 + 4, sh + n); ++e) out[e] = lab[e];
    }
  }
}

template <typename T>
int launch(const Geo& g, int grid, int threads, int smem, cudaStream_t stream) {
  // Dynamic shared memory this instantiation may use, per device.
  static int opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024 && (dev >= 64 || smem > opted[dev])) {
    err = cudaFuncSetAttribute(upsample_argmax_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) opted[dev] = smem;
  }
  upsample_argmax_kernel<T><<<grid, threads, smem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `groups` (ngroups x 4 int) and `runs` (nruns x 4 int) are the plan's
// row groups and column runs, `row_w` (HO x 2) and `col_w` (WO x 2) the
// weights of each output row and column on its pair of source positions;
// a CTA takes `groups_per_band` groups of one image.  All pointers are
// device pointers; nothing is allocated here.
int zs3_upsample_argmax(const void* logits, int is_bf16, int B, int HI, int WI, int C,
                        int HO, int WO, const int* groups, int ngroups, int groups_per_band,
                        const float* row_w, const int* runs, int nruns, const float* col_w,
                        int threads, int off_src, int off_lab, int smem_bytes, int* out,
                        void* stream) {
  Geo g;
  g.logits = static_cast<const unsigned char*>(logits);
  g.out = out;
  g.groups = reinterpret_cast<const int4*>(groups);
  g.runs = reinterpret_cast<const int4*>(runs);
  g.row_w = reinterpret_cast<const float2*>(row_w);
  g.col_w = reinterpret_cast<const float2*>(col_w);
  g.HI = HI;
  g.WI = WI;
  g.C = C;
  g.HO = HO;
  g.WO = WO;
  g.ngroups = ngroups;
  g.nruns = nruns;
  g.groups_per_band = groups_per_band;
  g.nbands = (ngroups + groups_per_band - 1) / groups_per_band;
  g.off_src = off_src;
  g.off_lab = off_lab;
  const int grid = B * g.nbands;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(g, grid, threads, smem_bytes, s)
                 : launch<float>(g, grid, threads, smem_bytes, s);
}

const char* zs3_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
