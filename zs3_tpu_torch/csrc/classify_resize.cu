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
// low-resolution logits: they live in shared memory.  One 256-thread
// block owns (image, 8-row source band, 16-column source tile): it
// classifies the 9 x 17 source pixels of its band and tile, with their
// one-row and one-column halo, into shared memory in f32, then writes
// its 32 x 64 output pixels.
//   * bf16 features: the classify is a (160 x C) x (C x 8 NT) product on
//     the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate),
//     over 64-channel chunks of the features and weights staged in
//     shared memory with 16-byte loads; w holds bf16 values already (the
//     wrapper rounds it to the features' dtype), so products are exact
//     and only the f32 sum order differs from the plain version.
//   * f32 features: f32 FMAs, eight threads per pixel, each holding up
//     to 16 class accumulators in registers, w staged in shared memory.
// The exact-4x align-corners weights are static per phase: output row
// 4q+p = (1 - p/4) L[q] + (p/4) L[q+1], and the same along W, so each
// output value is two H blends and one W blend of four shared-memory
// logits (H first, then W, the plain version's order), rounded once at
// the store.  Stores run over the contiguous (columns x classes) run of
// each output row, so neighbouring threads write neighbouring
// addresses.  The last band also writes output row 4(H-1), and the last
// tile output column 4(W-1): source row H-1 and column W-1, weight 1.
//
// The TPU kernel's matmul W-resize with lane packing and its layout
// adaptor exist for the TPU's 128-lane tiling and XLA's layout pinning;
// nothing here needs them.  Products and sums of the blends use
// __fmul_rn/__fadd_rn so the compiler cannot contract them into FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBandRows = 8;   // source rows per band (exact 4x: 32 output rows)
constexpr int kTileCols = 16;  // source columns per tile (64 output columns)
constexpr int kRow = kTileCols + 1;
constexpr int kPix = (kBandRows + 1) * kRow;  // 153 source pixels held
constexpr int kLanes = 8;      // f32 path: threads per source pixel
constexpr int kMTiles = (kPix + 15) / 16;     // bf16 path: 10 row tiles of 16
constexpr int kChunk = 64;                    // bf16 path: channels per stage
constexpr int kChunkPad = kChunk + 8;         // row pitch: no bank conflicts

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float blend(float wa, float a, float wb, float b) {
  return __fadd_rn(__fmul_rn(wa, a), __fmul_rn(wb, b));
}

struct Tile {
  int u, t, n_bands, n_tiles, c0, ncs, r0;
  long long b;
};

__device__ __forceinline__ Tile this_tile(int W) {
  Tile s;
  s.u = blockIdx.x;
  s.t = blockIdx.y;
  s.b = blockIdx.z;
  s.n_bands = gridDim.y;
  s.n_tiles = gridDim.x;
  s.c0 = s.u * kTileCols;
  s.ncs = min(kTileCols, W - 1 - s.c0) + 1;  // source columns held
  s.r0 = s.t * kBandRows;
  return s;
}

// Blend the classified source logits L (kBandRows + 1, kRow, K) into the
// block's output rows [4 r0, 4 r0 + 32) and columns [4 c0, 4 c0 + 64),
// plus row HO - 1 in the last band and column WO - 1 in the last tile.
template <typename T>
__device__ __forceinline__ void blend_store(const float* L, const Tile& s,
                                            int K, T* out, int HO, int WO) {
  const int i0 = 4 * s.r0;
  const int nrows = (s.t == s.n_bands - 1) ? HO - i0 : 4 * kBandRows;
  const int j0 = 4 * s.c0;
  const int ncols = (s.u == s.n_tiles - 1) ? WO - j0 : 4 * kTileCols;
  const int run = ncols * K;  // contiguous elements of one output row
  T* base = out + ((s.b * HO + i0) * static_cast<long long>(WO) + j0) * K;
  for (int e = threadIdx.x; e < run; e += kThreads) {
    const int jl = e / K;
    const int k = e - jl * K;
    const int cq = jl >> 2;
    const int sw = jl & 3;
    const int cr = sw ? cq + 1 : cq;  // second column tap (weight 0 at phase 0)
    const float ws_hi = 0.25f * sw;
    const float ws_lo = 1.0f - ws_hi;
    const float* la = L + cq * K + k;
    const float* lb = L + cr * K + k;
    for (int il = 0; il < nrows; ++il) {
      const int q = il >> 2;
      const int p = il & 3;
      const float a0 = la[q * kRow * K];
      const float b0 = lb[q * kRow * K];
      float ha = a0, hb = b0;
      if (p) {
        const float wp_hi = 0.25f * p;
        const float wp_lo = 1.0f - wp_hi;
        ha = blend(wp_lo, a0, wp_hi, la[(q + 1) * kRow * K]);
        hb = blend(wp_lo, b0, wp_hi, lb[(q + 1) * kRow * K]);
      }
      const float v = sw ? blend(ws_lo, ha, ws_hi, hb) : ha;
      store_f(base + static_cast<long long>(il) * WO * K + e, v);
    }
  }
}

// f32 features: NK class accumulators per thread (8 * NK >= K; f32_nk).
template <int NK>
__global__ void __launch_bounds__(kThreads)
classify_resize_f32(const float* __restrict__ feats, int H, int W, int C,
                    const float* __restrict__ w,  // (C, K)
                    const float* __restrict__ bias, int K,
                    float* __restrict__ out, int HO, int WO) {
  constexpr int KP = NK * kLanes;  // padded class count of the staged w
  extern __shared__ float smem[];
  float* w_s = smem;          // (C, KP)
  float* L = smem + C * KP;   // (kBandRows + 1, kRow, K)
  const Tile s = this_tile(W);

  for (int i = threadIdx.x; i < C * KP; i += kThreads) {
    const int c = i / KP;
    const int k = i - c * KP;
    w_s[i] = k < K ? w[c * K + k] : 0.0f;
  }
  __syncthreads();

  // Thread task (pixel, lane) holds classes lane + 8 j.
  const float* image = feats + s.b * H * static_cast<long long>(W) * C;
  const int npix = (kBandRows + 1) * s.ncs;
  for (int task = threadIdx.x; task < npix * kLanes; task += kThreads) {
    const int p = task / kLanes;
    const int lane = task - p * kLanes;
    const int r = p / s.ncs;
    const int cl = p - r * s.ncs;
    const float* f = image + (static_cast<long long>(s.r0 + r) * W + s.c0 + cl) * C;
    float acc[NK];
#pragma unroll
    for (int j = 0; j < NK; ++j) acc[j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const float fv = __ldg(f + c);
      const float* wr = w_s + c * KP + lane;
#pragma unroll
      for (int j = 0; j < NK; ++j) acc[j] = fmaf(fv, wr[kLanes * j], acc[j]);
    }
    float* lp = L + (r * kRow + cl) * K;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const int k = lane + kLanes * j;
      if (k < K) lp[k] = acc[j] + __ldg(bias + k);
    }
  }
  __syncthreads();
  blend_store(L, s, K, out, HO, WO);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 features: NT tiles of 8 classes (8 * NT >= K; bf16_nt); the 10 x NT
// (16-pixel, 8-class) output tiles of the classify are dealt to the 8
// warps in turn, MT to a warp.
template <int NT>
__global__ void __launch_bounds__(kThreads)
classify_resize_bf16(const __nv_bfloat16* __restrict__ feats, int H, int W, int C,
                     const float* __restrict__ w,  // (C, K), bf16 values
                     const float* __restrict__ bias, int K,
                     __nv_bfloat16* __restrict__ out, int HO, int WO) {
  constexpr int NP = 8 * NT;
  constexpr int MT = (kMTiles * NT + kWarps - 1) / kWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* f_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (160, kChunkPad)
  __nv_bfloat16* w_s = f_s + kMTiles * 16 * kChunkPad;               // (NP, kChunkPad)
  float* L = reinterpret_cast<float*>(w_s + NP * kChunkPad);          // (9, kRow, K)
  const Tile s = this_tile(W);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // mma group: row (A, C) or column (B) within the tile
  const int tig = lane & 3;  // thread in group: k pair (A, B) or column pair (C)
  const int npix = (kBandRows + 1) * s.ncs;
  const __nv_bfloat16* image = feats + s.b * H * static_cast<long long>(W) * C;
  const bool vec = (C % 8 == 0) && ((reinterpret_cast<uintptr_t>(feats) & 15) == 0);

  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  for (int k0 = 0; k0 < C; k0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed
    constexpr int kVecs = kChunk / 8;
    for (int i = threadIdx.x; i < kMTiles * 16 * kVecs; i += kThreads) {
      const int p = i / kVecs;
      const int kk = (i - p * kVecs) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (p < npix) {
        const int r = p / s.ncs;
        const int cl = p - r * s.ncs;
        const __nv_bfloat16* src =
            image + (static_cast<long long>(s.r0 + r) * W + s.c0 + cl) * C + k0 + kk;
        if (vec && k0 + kk + 8 <= C) {
          v = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          __align__(16) __nv_bfloat16 tmp[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            tmp[j] = k0 + kk + j < C ? src[j] : __float2bfloat16_rn(0.0f);
          }
          v = *reinterpret_cast<const uint4*>(tmp);
        }
      }
      *reinterpret_cast<uint4*>(f_s + p * kChunkPad + kk) = v;
    }
    for (int i = threadIdx.x; i < NP * kChunk; i += kThreads) {
      const int n = i / kChunk;
      const int kk = i - n * kChunk;
      const float wv = (n < K && k0 + kk < C) ? w[(k0 + kk) * K + n] : 0.0f;
      w_s[n * kChunkPad + kk] = __float2bfloat16_rn(wv);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int tile = warp + kWarps * i;
      if (tile >= kMTiles * NT) break;
      const int mt = tile / NT;
      const int nt = tile - mt * NT;
      const uint32_t* a_lo =
          reinterpret_cast<const uint32_t*>(f_s + (mt * 16 + g) * kChunkPad) + tig;
      const uint32_t* a_hi = a_lo + 8 * kChunkPad / 2;
      const uint32_t* bp =
          reinterpret_cast<const uint32_t*>(w_s + (nt * 8 + g) * kChunkPad) + tig;
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks) {
        const int o = ks * 8;  // 16 bf16 = 8 words per k step
        const uint32_t a[4] = {a_lo[o], a_hi[o], a_lo[o + 4], a_hi[o + 4]};
        mma_bf16(acc[i], a, bp[o], bp[o + 4]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int tile = warp + kWarps * i;
    if (tile >= kMTiles * NT) break;
    const int mt = tile / NT;
    const int nt = tile - mt * NT;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mt * 16 + g + 8 * h;
      if (p >= npix) continue;
      const int r = p / s.ncs;
      float* lp = L + (r * kRow + p - r * s.ncs) * K;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = nt * 8 + 2 * tig + j;
        if (n < K) lp[n] = acc[i][2 * h + j] + __ldg(bias + n);
      }
    }
  }
  __syncthreads();
  blend_store(L, s, K, out, HO, WO);
}

// Accumulators per thread of the f32 path: 8 * nk >= K, nk a power of 2.
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

size_t smem_f32(int C, int K) {
  return (static_cast<size_t>(C) * f32_nk(K) * kLanes + static_cast<size_t>(kPix) * K) *
         sizeof(float);
}

size_t smem_bf16(int K) {
  return static_cast<size_t>(kMTiles * 16 + 8 * bf16_nt(K)) * kChunkPad *
             sizeof(__nv_bfloat16) +
         static_cast<size_t>(kPix) * K * sizeof(float);
}

template <typename Kernel, typename T>
int launch(Kernel kernel, size_t smem, const T* feats, int B, int H, int W, int C,
           const float* w, const float* bias, int K, T* out, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_tiles = W > 1 ? (W - 1 + kTileCols - 1) / kTileCols : 1;
  const dim3 grid(n_tiles, (H - 1) / kBandRows, B);
  kernel<<<grid, kThreads, smem, stream>>>(feats, H, W, C, w, bias, K, out,
                                           4 * (H - 1) + 1, 4 * (W - 1) + 1);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const float* x, int B, int H, int W, int C, const float* w,
               const float* bias, int K, float* out, cudaStream_t stream) {
  const size_t smem = smem_f32(C, K);
#define ZS3_F32(N)                                                                  \
  case N:                                                                           \
    return launch(classify_resize_f32<N>, smem, x, B, H, W, C, w, bias, K, out, stream);
  switch (f32_nk(K)) {
    ZS3_F32(1) ZS3_F32(2) ZS3_F32(4) ZS3_F32(8) ZS3_F32(16)
  }
#undef ZS3_F32
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_bf16(const __nv_bfloat16* x, int B, int H, int W, int C, const float* w,
                const float* bias, int K, __nv_bfloat16* out, cudaStream_t stream) {
  const size_t smem = smem_bf16(K);
#define ZS3_BF16(N)                                                                 \
  case N:                                                                           \
    return launch(classify_resize_bf16<N>, smem, x, B, H, W, C, w, bias, K, out, stream);
  switch (bf16_nt(K)) {
    ZS3_BF16(1) ZS3_BF16(2) ZS3_BF16(3) ZS3_BF16(4) ZS3_BF16(8) ZS3_BF16(16)
  }
#undef ZS3_BF16
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// feats (B, H, W, C) and out (B, 4(H-1)+1, 4(W-1)+1, K) are contiguous
// NHWC of one dtype: is_bf16 = 1 for bf16, 0 for f32.  w is (C, K) f32
// (holding bf16 values when is_bf16), bias (K,) f32; 1 <= K <= 128,
// (H-1) % 8 == 0, H > 8.  All pointers are device pointers; nothing is
// allocated here.
int zs3_classify_resize(const void* feats, int is_bf16, int B, int H, int W,
                        int C, const float* w, const float* bias, int K,
                        void* out, void* stream) {
  if (K < 1 || K > 128 || H <= kBandRows || (H - 1) % kBandRows != 0 || W < 1 ||
      C < 1 || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_bf16(static_cast<const __nv_bfloat16*>(feats), B, H, W, C, w, bias, K,
                       static_cast<__nv_bfloat16*>(out), s);
  }
  return launch_f32(static_cast<const float*>(feats), B, H, W, C, w, bias, K,
                    static_cast<float*>(out), s);
}

// Dynamic shared memory (bytes) one block of the launch takes.
int zs3_classify_resize_smem(int is_bf16, int C, int K) {
  return static_cast<int>(is_bf16 ? smem_bf16(K) : smem_f32(C, K));
}

const char* zs3_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
