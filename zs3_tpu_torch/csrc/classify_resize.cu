// Fused 1x1 classify + exact-4x bilinear upsample (inference tail), for sm_90a.
//
// Replaces the TPU kernel zs3_tpu/ops/pallas_tail.py::_kernel (entered
// through classify_resize_fused and classify_resize): for features
// (B, H, W, C) NHWC, classifier weights w (C, K) and bias b (K) it writes
//     out = resize_bilinear(feats @ w + b, (4(H-1)+1, 4(W-1)+1),
//                           align_corners=True)
// as (B, HO, WO, K) NHWC in the features' dtype (f32 or bf16).  The
// geometry is the one `supported()` admits: (H-1) % 8 == 0, H > 8.
//
// Bound on an H100 SXM: memory.  The function reads the features once
// and writes the full-resolution logits once: at the main path's
// (8, 129, 129, 256) bf16 -> (8, 513, 513, 21) bf16 that is 156.6 MB,
// 46.7 us at 3.35 TB/s.  The classify is 1.43 GFLOP and the two-tap
// resize about 0.2 GFLOP, well under the card's rates for that time.
//
// Design.  Classify and resize commute, so the kernel classifies at the
// feature grid (16x fewer pixels than the output) and never writes the
// low-resolution logits: they live in shared memory in f32.  A work item
// is (image, band of 8 source rows, tile of tc source columns): its
// 9 x (tc + 1) source pixels, halo included, give its 32 x 4tc output
// pixels (the last band also writes output row HO - 1, the last tile
// column WO - 1).  The launch is persistent: `grid` CTAs (SMs x the CTAs
// an SM holds, or fewer when there are fewer items) walk the items
// i = blockIdx.x + j * gridDim.x.  The caller picks tc (16, 8 or 4;
// ops/tail_kernels.py::plan) and the grid; the kernel derives the rest.
//   * bf16: the weights are rounded to bf16 and staged in shared memory
//     once per CTA, K padded to 8 NT.  The features come in 64-channel
//     chunks of the item's 9 x (tc + 1) box through a ring of 3 stages:
//     thread 0 issues a TMA copy (a 4-D tensor map over (B, H, W, C),
//     128-byte swizzle, zero fill past the image and past C) for chunk
//     g + 3 as soon as every thread is done with chunk g, so the next
//     item's first three chunks arrive while this item blends and stores
//     (at C = 256 its last one is fetched after its first is consumed: a
//     fourth stage would cost the second CTA an SM).  Where TMA cannot
//     describe the features
//     (C % 8 != 0, or a pointer that is not 16-byte aligned) every
//     thread loads the chunk into the same swizzled layout with plain
//     loads.  The classify is mma.sync m16n8k16 (bf16 in, f32
//     accumulate; A by ldmatrix from the swizzled stage), so products are
//     exact and only the f32 sum order differs from the plain version.
//   * f32: exact FMAs, eight threads per source pixel, each holding up to
//     16 class accumulators in registers, the weights staged once per CTA.
// Stores.  Each warp owns whole output rows of the item, so nothing but
// __syncwarp orders them.  For a row, lane pairs (source column, class)
// blend two source rows (H), then write up to four output columns (W),
// the plain version's order (__fmul_rn/__fadd_rn, so nothing contracts
// into an FMA), rounded once, into the warp's shared-memory copy of the
// row, placed at the row's own address modulo 16.  Then the warp copies
// the row's contiguous (columns x classes) run out as 16-byte vectors,
// with its misaligned head and tail (a row's pitch, WO K elements, is odd
// at K = 21) as scalar stores.
//
// The TPU kernel's matmul W-resize with lane packing and its layout
// adaptor exist for the TPU's 128-lane tiling and XLA's layout pinning;
// nothing here needs them.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBandRows = 8;               // source rows per band: 32 output rows
constexpr int kHeldRows = kBandRows + 1;   // with the next band's first row
constexpr int kLanes = 8;                  // f32: threads per source pixel
constexpr int kChunk = 64;                 // bf16: channels a stage holds (128 bytes)
constexpr int kMaxMTiles = 10;             // bf16: M tiles of 16 pixels a stage holds, at most
constexpr int kRing = 3;
constexpr int kMaxSmem = 232448;           // H100: 227 KB a block

// The launch's layout, derived on the host from the shape and tc.
struct Geo {
  int B, H, W, C, K, HO, WO;
  int tc, row;                 // source columns per tile; pixels per held row (tc + 1)
  int n_bands, n_tiles, items;
  int chunks;                  // bf16: 64-channel chunks of C
  int m_tiles, stage_bytes;    // bf16: a stage's 16-pixel M tiles (1024-byte multiple)
  int w_pitch;                 // row pitch (elements) of the staged weights
  int stage_pitch;             // bytes of one staged output row
  int off_w, off_b, off_L, off_st, off_bar, smem;  // shared memory, from a 1024-aligned base
  long long w_sc, w_sk;        // strides of w (C, K) in elements
  int tma;                     // bf16: the features come by TMA
};

// One work item: image b, band t (source rows r0 .. r0 + 8), tile u
// (source columns c0 .. c0 + ncs - 1).
struct Item {
  int b, t, u, r0, c0, ncs, ncols, run;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__device__ __forceinline__ Item decode(const Geo& g, int item) {
  Item it;
  const int per_image = g.n_bands * g.n_tiles;
  it.b = item / per_image;
  const int rem = item - it.b * per_image;
  it.t = rem / g.n_tiles;
  it.u = rem - it.t * g.n_tiles;
  it.r0 = it.t * kBandRows;
  it.c0 = it.u * g.tc;
  it.ncs = min(g.tc, g.W - 1 - it.c0) + 1;
  it.ncols = it.u == g.n_tiles - 1 ? 4 * (it.ncs - 1) + 1 : 4 * g.tc;
  it.run = it.ncols * g.K;
  return it;
}

__device__ __forceinline__ float blend(float wa, float a, float wb, float b) {
  return __fadd_rn(__fmul_rn(wa, a), __fmul_rn(wb, b));
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// Stage w (C, K) f32, strides (w_sc, w_sk), as dst[n ld_n + c ld_c] for
// n < np, c < cp, zero past K and C, in the dtype of dst.  Threads walk
// the dimension w is contiguous along, eight independent loads each.
template <typename T>
__device__ void stage_weights(T* dst, int ld_n, int ld_c, int np, int cp,
                              const float* __restrict__ w, const Geo& g) {
  constexpr int kBatch = 8;
  const bool c_fast = g.w_sc == 1;
  const int total = np * cp;
  for (int base = threadIdx.x; base < total; base += kThreads * kBatch) {
    float v[kBatch];
    int at[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * kThreads;
      const int n = c_fast ? i / cp : i % np;
      const int c = c_fast ? i % cp : i / np;
      at[j] = i < total ? n * ld_n + c * ld_c : -1;
      v[j] = i < total && n < g.K && c < g.C ? __ldg(w + c * g.w_sc + n * g.w_sk) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (at[j] >= 0) put(dst + at[j], v[j]);
    }
  }
}

// Blend the item's source logits L (9, row, K) f32 into its output rows
// and store them.  Warp w takes output rows w, w + 8, ...; for a row
// 4q + p, lane pairs (source column cq, class k) blend rows q and q + 1
// (H) into two values, then the up to four output columns 4cq + s (W),
// into the warp's staging row `buf` at the row's address modulo 16; then
// the warp copies the row out.
template <typename T>
__device__ void blend_store(const float* __restrict__ L, unsigned char* __restrict__ st,
                            const Geo& g, const Item& it, T* __restrict__ out) {
  constexpr int kVec = 16 / sizeof(T);
  const int K = g.K;
  const int rs = g.row * K;  // L's row stride
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  unsigned char* buf = st + warp * g.stage_pitch;
  const int rows = it.t == g.n_bands - 1 ? 4 * kBandRows + 1 : 4 * kBandRows;
  const int pairs = (it.ncols + 3) / 4 * K;
  const int run = it.run;
  const int dq = 32 / K, dr = 32 - dq * K;
  for (int r = warp; r < rows; r += kWarps) {
    const int q = r >> 2;
    const int p = r & 3;  // H phase: weight p / 4 on source row q + 1
    T* dst = out + ((static_cast<long long>(it.b) * g.HO + 4 * it.r0 + r) * g.WO +
                    4 * it.c0) * K;
    const int phase = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
    T* srow = reinterpret_cast<T*>(buf + phase);
    const float wp_hi = 0.25f * p;
    const float wp_lo = 1.0f - wp_hi;
    const float* l0 = L + q * rs;
    const float* l1 = l0 + (p ? rs : 0);
    int cq = lane / K;
    int k = lane - cq * K;
#pragma unroll 2
    for (int i = lane; i < pairs; i += 32) {  // i = cq K + k
      const int ns = min(4, it.ncols - 4 * cq);  // output columns of this pair
      float ha = l0[i], hb = 0.0f;
      if (p) ha = blend(wp_lo, ha, wp_hi, l1[i]);
      if (ns > 1) {
        hb = l0[i + K];
        if (p) hb = blend(wp_lo, hb, wp_hi, l1[i + K]);
      }
      T* o = srow + 4 * cq * K + k;
      put(o, ha);
#pragma unroll
      for (int sw = 1; sw < 4; ++sw) {
        if (sw < ns) put(o + sw * K, blend(1.0f - 0.25f * sw, ha, 0.25f * sw, hb));
      }
      k += dr;
      cq += dq;
      if (k >= K) {
        k -= K;
        ++cq;
      }
    }
    __syncwarp();
    // head elements, 16-byte vectors, tail elements
    const int head = min(run, ((16 - phase) & 15) / static_cast<int>(sizeof(T)));
    const int nv = (run - head) / kVec;
    const int tail = head + nv * kVec;
    for (int j = lane; j < nv; j += 32) {
      const int e = head + j * kVec;
      *reinterpret_cast<uint4*>(dst + e) = *reinterpret_cast<const uint4*>(srow + e);
    }
    if (lane < head) dst[lane] = srow[lane];
    if (tail + lane < run) dst[tail + lane] = srow[tail + lane];
    __syncwarp();
  }
}

// ---------------------------------------------------------------- bf16 path

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

// TMA: the (64, row, 9, 1) box at (channel, column, row, image) of the
// features into a stage, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c, int x, int y,
                                         int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(x), "r"(y),
         "r"(b), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of channels [8 unit, 8 unit + 8) of stage pixel p under the
// 128-byte swizzle (the stage is 1024-byte aligned; a pixel is one
// 128-byte line).
__device__ __forceinline__ int swizzled(int p, int unit) {
  return p * 128 + ((unit ^ (p & 7)) << 4);
}

// Chunk gi of this CTA's walk (item gi / chunks, chunk gi % chunks) by
// TMA into stage gi % kRing.
__device__ __forceinline__ void issue(const CUtensorMap* tm, const Geo& g, int gi,
                                      unsigned char* ring, uint64_t* full) {
  const int j = gi / g.chunks;
  const int c = gi - j * g.chunks;
  const Item it = decode(g, blockIdx.x + j * gridDim.x);
  const int s = gi % kRing;
  mbar_expect_tx(&full[s], kChunk * 2 * g.row * kHeldRows);
  tma_load(ring + s * g.stage_bytes, tm, c * kChunk, it.c0, it.r0, it.b, &full[s]);
}

// Plain loads of chunk c of the item's features into a stage, in TMA's
// layout, zero past the image and past C.
__device__ void load_plain(unsigned char* stage, const bf16* __restrict__ feats, const Geo& g,
                           const Item& it, int c) {
  for (int i = threadIdx.x; i < g.m_tiles * 16 * 8; i += kThreads) {
    const int p = i >> 3;
    const int unit = i & 7;
    const int r = p / g.row;
    const int cl = p - r * g.row;
    const int ch = c * kChunk + unit * 8;
    __align__(16) bf16 v[8];
    const bool in = r < kHeldRows && cl < it.ncs;
    const bf16* src = feats;
    if (in) {
      src += ((static_cast<long long>(it.b) * g.H + it.r0 + r) * g.W + it.c0 + cl) * g.C + ch;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = in && ch + j < g.C ? src[j] : __float2bfloat16_rn(0.0f);
    *reinterpret_cast<uint4*>(stage + swizzled(p, unit)) = *reinterpret_cast<const uint4*>(v);
  }
}

template <int MT>
__device__ __forceinline__ void zero(float (&acc)[MT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
}

// Chunk gi of this CTA's walk (chunk gi % chunks of item `it`) into acc:
// wait for its TMA copy (or load it), run its products, then release its
// stage to chunk gi + kRing.
template <int NT, int MT>
__device__ __forceinline__ void classify_chunk(float (&acc)[MT][4], const CUtensorMap* tm,
                                               const Geo& g, unsigned char* smem,
                                               uint64_t* full, const bf16* w_s,
                                               const bf16* __restrict__ feats, const Item& it,
                                               int gi, int total) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c = gi % g.chunks;
  const int s = gi % kRing;
  unsigned char* stage = smem + s * g.stage_bytes;
  if (g.tma) {
    mbar_wait(&full[s], (gi / kRing) & 1);
  } else {
    load_plain(stage, feats, g, it, c);
    __syncthreads();
  }
  const uint32_t sbase = smem_u32(stage);
  const bf16* w_c = w_s + c * kChunk;
  const int p = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix row of this lane
  const int hi = lane >> 4;                            // and its 8-channel half
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int tile = warp + kWarps * i;
    if (tile >= g.m_tiles * NT) break;
    const int mt = tile / NT;
    const int nt = tile - mt * NT;
    const uint32_t* bp =
        reinterpret_cast<const uint32_t*>(w_c + (nt * 8 + (lane >> 2)) * g.w_pitch) + (lane & 3);
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, sbase + swizzled(mt * 16 + p, 2 * ks + hi));
      mma_bf16(acc[i], a, bp[ks * 8], bp[ks * 8 + 4]);
    }
  }
  __syncthreads();  // every thread is done with the stage
  if (g.tma && threadIdx.x == 0 && gi + kRing < total) issue(tm, g, gi + kRing, smem, full);
}

// bf16 features: NT tiles of 8 classes (8 NT >= K; bf16_nt).  The M
// tiles x NT (16-pixel, 8-class) tiles of the classify are dealt to the
// 8 warps in turn, MT to a warp.
template <int NT>
__global__ void __launch_bounds__(kThreads, NT <= 4 ? 3 : 1)
classify_resize_bf16(const __grid_constant__ CUtensorMap tm, const bf16* __restrict__ feats,
                     const float* __restrict__ w, const float* __restrict__ bias,
                     bf16* __restrict__ out, const Geo g) {
  constexpr int NP = 8 * NT;
  constexpr int MT = (kMaxMTiles * NT + kWarps - 1) / kWarps;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  bf16* w_s = reinterpret_cast<bf16*>(smem + g.off_w);  // (NP, w_pitch)
  float* b_s = reinterpret_cast<float*>(smem + g.off_b);
  float* L = reinterpret_cast<float*>(smem + g.off_L);  // (9, row, K)
  unsigned char* st = smem + g.off_st;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + g.off_bar);

  const int my_items = (g.items - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int total = my_items * g.chunks;  // chunks this CTA consumes, in order
  if (g.tma && threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int gi = 0; gi < min(kRing, total); ++gi) issue(&tm, g, gi, smem, full);
  }
  stage_weights(w_s, g.w_pitch, 1, NP, g.chunks * kChunk, w, g);
  for (int n = threadIdx.x; n < NP; n += kThreads) {
    b_s[n] = n < g.K ? __bfloat162float(__float2bfloat16_rn(bias[n])) : 0.0f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int gq = (threadIdx.x % 32) >> 2;  // mma group: row of the C tile
  const int tig = threadIdx.x & 3;          // thread in group: column pair of the C tile
  const int npix = kHeldRows * g.row;
  for (int j = 0; j < my_items; ++j) {
    const Item it = decode(g, blockIdx.x + j * gridDim.x);
    float acc[MT][4];
    zero(acc);
    for (int c = 0; c < g.chunks; ++c) {
      classify_chunk<NT>(acc, &tm, g, smem, full, w_s, feats, it, j * g.chunks + c, total);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int tile = warp + kWarps * i;
      if (tile >= g.m_tiles * NT) break;
      const int mt = tile / NT;
      const int nt = tile - mt * NT;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mt * 16 + gq + 8 * h;
        if (p >= npix) continue;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int n = nt * 8 + 2 * tig + jj;
          if (n < g.K) L[p * g.K + n] = acc[i][2 * h + jj] + b_s[n];
        }
      }
    }
    __syncthreads();
    blend_store(L, st, g, it, out);  // while the next item's first chunks land
  }
}

// ----------------------------------------------------------------- f32 path

// f32 features: NK class accumulators per thread (8 NK >= K; f32_nk).
template <int NK>
__global__ void __launch_bounds__(kThreads)
classify_resize_f32(const float* __restrict__ feats, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out, const Geo g) {
  constexpr int KP = NK * kLanes;  // padded class count of the staged w
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* w_s = reinterpret_cast<float*>(smem + g.off_w);  // (C, KP)
  float* b_s = reinterpret_cast<float*>(smem + g.off_b);
  float* L = reinterpret_cast<float*>(smem + g.off_L);
  unsigned char* st = smem + g.off_st;

  stage_weights(w_s, 1, KP, KP, g.C, w, g);
  for (int k = threadIdx.x; k < KP; k += kThreads) b_s[k] = k < g.K ? bias[k] : 0.0f;
  __syncthreads();

  const bool vec4 = g.C % 4 == 0 && (reinterpret_cast<uintptr_t>(feats) & 15) == 0;
  for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
    const Item it = decode(g, item);
    const float* image = feats + static_cast<long long>(it.b) * g.H * g.W * g.C;
    const int npix = kHeldRows * it.ncs;
    // Thread task (pixel, lane) holds classes lane + 8 j.
    for (int task = threadIdx.x; task < npix * kLanes; task += kThreads) {
      const int p = task / kLanes;
      const int lane = task - p * kLanes;
      const int r = p / it.ncs;
      const int cl = p - r * it.ncs;
      const float* f = image + (static_cast<long long>(it.r0 + r) * g.W + it.c0 + cl) * g.C;
      float acc[NK];
#pragma unroll
      for (int j = 0; j < NK; ++j) acc[j] = 0.0f;
      int c = 0;
      if (vec4) {  // four channels a load, in the same order
#pragma unroll 4
        for (; c < g.C; c += 4) {
          const float4 fv = __ldg(reinterpret_cast<const float4*>(f + c));
          const float* wr = w_s + c * KP + lane;
#pragma unroll
          for (int j = 0; j < NK; ++j) {
            acc[j] = fmaf(fv.x, wr[kLanes * j], acc[j]);
            acc[j] = fmaf(fv.y, wr[KP + kLanes * j], acc[j]);
            acc[j] = fmaf(fv.z, wr[2 * KP + kLanes * j], acc[j]);
            acc[j] = fmaf(fv.w, wr[3 * KP + kLanes * j], acc[j]);
          }
        }
      }
#pragma unroll 4
      for (; c < g.C; ++c) {
        const float fv = __ldg(f + c);
        const float* wr = w_s + c * KP + lane;
#pragma unroll
        for (int j = 0; j < NK; ++j) acc[j] = fmaf(fv, wr[kLanes * j], acc[j]);
      }
      float* lp = L + (r * g.row + cl) * g.K;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const int k = lane + kLanes * j;
        if (k < g.K) lp[k] = acc[j] + b_s[k];
      }
    }
    __syncthreads();
    blend_store(L, st, g, it, out);
    __syncthreads();  // every warp is done with L
  }
}

// ------------------------------------------------------------------- host

// Accumulators per thread of the f32 path: 8 nk >= K, nk a power of 2.
int f32_nk(int K) {
  const int need = (K + kLanes - 1) / kLanes;
  int nk = 1;
  while (nk < need) nk *= 2;
  return nk;
}

// Class tiles of 8 in the bf16 path: 1-4 exactly, then 8 or 16.
int bf16_nt(int K) {
  const int need = (K + 7) / 8;
  return need <= 4 ? need : (need <= 8 ? 8 : 16);
}

// The layout of a launch; false when the shape or tc is not taken.
// ops/tail_kernels.py::smem_bytes mirrors the shared-memory sum.
bool make_geo(int is_bf16, int B, int H, int W, int C, int K, int tc, Geo* g) {
  if (K < 1 || K > 128 || H <= kBandRows || (H - 1) % kBandRows != 0 || W < 1 || C < 1 ||
      B < 1 || (tc != 4 && tc != 8 && tc != 16)) {
    return false;
  }
  g->B = B; g->H = H; g->W = W; g->C = C; g->K = K;
  g->HO = 4 * (H - 1) + 1;
  g->WO = 4 * (W - 1) + 1;
  g->tc = tc;
  g->row = tc + 1;
  g->n_bands = (H - 1) / kBandRows;
  g->n_tiles = W > 1 ? (W - 1 + tc - 1) / tc : 1;
  const long long items = static_cast<long long>(B) * g->n_bands * g->n_tiles;
  if (items > (1LL << 30)) return false;
  g->items = static_cast<int>(items);
  g->chunks = (C + kChunk - 1) / kChunk;
  g->m_tiles = (kHeldRows * g->row + 15) / 16;  // 10, 6 or 3
  g->stage_bytes = g->m_tiles * 16 * kChunk * 2;
  const int esize = is_bf16 ? 2 : 4;
  g->stage_pitch = align16((4 * tc + 1) * K * esize + 16);
  int off = 0;
  if (is_bf16) {
    const int np = 8 * bf16_nt(K);
    off = kRing * g->stage_bytes;
    g->w_pitch = g->chunks * kChunk + 8;  // 4 banks of skew a row: no conflicts
    g->off_w = off;
    off += align16(np * g->w_pitch * 2);
    g->off_b = off;
    off += align16(np * 4);
  } else {
    const int kp = kLanes * f32_nk(K);
    g->w_pitch = kp;
    g->off_w = off;
    off += align16(C * kp * 4);
    g->off_b = off;
    off += align16(kp * 4);
  }
  g->off_L = off;
  off += align16(kHeldRows * g->row * K * 4);
  g->off_st = off;
  off += kWarps * g->stage_pitch;
  g->off_bar = off;
  off += is_bf16 ? kRing * 8 : 0;
  g->smem = 1024 + off;
  g->tma = 0;
  return true;
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

// The features (B, H, W, C) bf16, read in (64, row, 9, 1) boxes.
bool encode(CUtensorMap* map, const void* feats, const Geo& g) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t c = g.C;
  const cuuint64_t dims[4] = {c, static_cast<cuuint64_t>(g.W), static_cast<cuuint64_t>(g.H),
                              static_cast<cuuint64_t>(g.B)};
  const cuuint64_t strides[3] = {c * 2, c * 2 * g.W, c * 2 * g.W * g.H};
  const cuuint32_t box[4] = {kChunk, static_cast<cuuint32_t>(g.row), kHeldRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(feats), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The kernel instance for a dtype and K (nullptr when none).
const void* kernel_of(int is_bf16, int K) {
  if (is_bf16) {
    switch (bf16_nt(K)) {
      case 1: return reinterpret_cast<const void*>(classify_resize_bf16<1>);
      case 2: return reinterpret_cast<const void*>(classify_resize_bf16<2>);
      case 3: return reinterpret_cast<const void*>(classify_resize_bf16<3>);
      case 4: return reinterpret_cast<const void*>(classify_resize_bf16<4>);
      case 8: return reinterpret_cast<const void*>(classify_resize_bf16<8>);
      case 16: return reinterpret_cast<const void*>(classify_resize_bf16<16>);
    }
    return nullptr;
  }
  switch (f32_nk(K)) {
    case 1: return reinterpret_cast<const void*>(classify_resize_f32<1>);
    case 2: return reinterpret_cast<const void*>(classify_resize_f32<2>);
    case 4: return reinterpret_cast<const void*>(classify_resize_f32<4>);
    case 8: return reinterpret_cast<const void*>(classify_resize_f32<8>);
    case 16: return reinterpret_cast<const void*>(classify_resize_f32<16>);
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the launch's error (0 on success).
// feats (B, H, W, C) and out (B, 4(H-1)+1, 4(W-1)+1, K) are contiguous
// NHWC of one dtype: is_bf16 = 1 for bf16, 0 for f32.  w (C, K) is f32
// with element strides (w_sc, w_sk); bias (K,) contiguous f32; bf16
// rounds both to bf16 as it stages them.  1 <= K <= 128, (H-1) % 8 == 0,
// H > 8; tile_cols (16, 8 or 4) source columns per work item; grid the
// persistent CTAs (at most the items are used).  bf16 features with C % 8
// == 0 at a 16-byte aligned address are read through a TMA tensor map.
// All pointers are device pointers; nothing is allocated here.
int zs3_classify_resize(const void* feats, int is_bf16, int B, int H, int W, int C,
                        const float* w, long long w_sc, long long w_sk, const float* bias, int K,
                        int tile_cols, int grid, void* out, void* stream) {
  Geo g;
  if (!make_geo(is_bf16, B, H, W, C, K, tile_cols, &g) || grid < 1 || g.smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  g.w_sc = w_sc;
  g.w_sk = w_sk;
  const void* kernel = kernel_of(is_bf16, K);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         g.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tm = {};
  if (is_bf16 && C % 8 == 0 && reinterpret_cast<uintptr_t>(feats) % 16 == 0) {
    if (!encode(&tm, feats, g)) return static_cast<int>(cudaErrorInvalidValue);
    g.tma = 1;
  }
  const unsigned int n = static_cast<unsigned int>(grid < g.items ? grid : g.items);
  auto s = static_cast<cudaStream_t>(stream);
  void* args_bf16[] = {&tm, const_cast<void**>(&feats), &w, &bias, &out, &g};
  void* args_f32[] = {const_cast<void**>(&feats), &w, &bias, &out, &g};
  return static_cast<int>(cudaLaunchKernel(kernel, dim3(n), dim3(kThreads),
                                           is_bf16 ? args_bf16 : args_f32, g.smem, s));
}

// Dynamic shared memory (bytes) one CTA of the launch takes (-1: the
// arguments are not taken).
int zs3_classify_resize_smem(int is_bf16, int C, int K, int tile_cols) {
  Geo g;
  if (!make_geo(is_bf16, 1, kBandRows + 1, 2, C, K, tile_cols, &g)) return -1;
  return g.smem;
}

// CTAs of the launch an SM of the current device holds, by the occupancy
// API (negative: a CUDA error).
int zs3_classify_resize_ctas_per_sm(int is_bf16, int C, int K, int tile_cols) {
  Geo g;
  if (!make_geo(is_bf16, 1, kBandRows + 1, 2, C, K, tile_cols, &g) || g.smem > kMaxSmem) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const void* kernel = kernel_of(is_bf16, K);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         g.smem);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, g.smem);
  }
  return err != cudaSuccess ? -static_cast<int>(err) : per_sm;
}

const char* zs3_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
