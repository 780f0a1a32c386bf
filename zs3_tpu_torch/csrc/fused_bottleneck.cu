// Fused eval-mode ResNet bottleneck (stride 1, identity skip, BN folded), for sm_90a.
//
// Replaces the TPU kernel zs3_tpu/ops/pallas_bottleneck.py::_kernel (entered
// through _block_call, fused_stage and fused_bottleneck): for x (B, H, W, C)
// NHWC and folded weights w1 (C, P), w2 (3, 3, P, P) HWIO, w3 (P, C) in x's
// dtype with f32 biases b1 (P), b2 (P), b3 (C), it writes
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
// Design.  One 256-thread block owns an image and a tile of th x tw output
// pixels (th <= 4 rows, tw <= 16 columns, picked on the host so the tile's
// working set fits shared memory).  It
//   1. computes y1 for every pixel the tile's dilated 3x3 taps read (th + 2d
//      rows, or 3 groups of th rows when d >= th, by tw + 2d columns) into
//      shared memory, zero outside the image as the unfused conv's padding;
//   2. accumulates y2 for the tile over the nine taps, reading y1 rows from
//      shared memory at each tap's offset, and rounds it into shared memory;
//   3. multiplies y2 by w3 in 64-channel column chunks, adds b3 and the
//      residual x read from global memory, and writes the output.
// y1 and y2 never reach device memory, as on the TPU.  Each product is a
// sequence of 64 x 64 weight chunks staged in shared memory; x's halo is
// staged 64 channels at a time (it is re-read from L2 for each 64-column
// chunk of y1: the halo of a whole stage does not fit).  bf16 products run on
// the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate); f32 products
// are exact f32 FMAs, one output column per thread.  The TPU kernel's flat
// row-padded layout, its 8-aligned row width and its th % d == 0 rule exist
// for Mosaic's tiling; here the kernel indexes NHWC directly and masks the
// image border itself.  wgmma and TMA are for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 64;                 // K chunk of every product
constexpr int kNC = 64;                 // N chunk (output columns) of every product
constexpr int kPad = 8;                 // row padding (elements): no bank conflicts
constexpr int kStage = kKC + kPad;      // pitch of the staged chunks
constexpr int kMaxHalo = 128;           // y1 rows a block holds (8 tiles of 16)
constexpr int kMaxTile = 64;            // output pixels a block owns (4 tiles of 16)
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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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

// Stage W[k0:k0+64, n0:n0+64] of a (K, N) row-major matrix, zero outside it:
// bf16 as Bs[n][k] (the mma's column operand), f32 as Bs[k][n].
template <typename T>
__device__ __forceinline__ void stage_weights(T* Bs, const T* __restrict__ w, int K, int N,
                                              int k0, int n0) {
  for (int i = threadIdx.x; i < kKC * kNC; i += kThreads) {
    const int k = i / kNC;
    const int n = i - k * kNC;
    const T v = (k0 + k < K && n0 + n < N) ? w[static_cast<long long>(k0 + k) * N + n0 + n]
                                           : from_f<T>(0.0f);
    if (sizeof(T) == 2) {
      Bs[n * kStage + k] = v;
    } else {
      Bs[k * kStage + n] = v;
    }
  }
}

// Stage x[halo pixel h, k0:k0+64] for every h < NHp, zero outside the image.
template <typename T>
__device__ __forceinline__ void stage_halo(T* As, const T* __restrict__ x, const Geo& g, int b,
                                           int r0, int c0, int k0) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = g.C % kVec == 0;
  for (int i = threadIdx.x; i < g.NHp * (kKC / kVec); i += kThreads) {
    const int h = i / (kKC / kVec);
    const int k = (i - h * (kKC / kVec)) * kVec;
    const long long pix = halo_pixel(g, b, r0, c0, h);
    __align__(16) T v[kVec];
    if (pix >= 0 && vec && k0 + k + kVec <= g.C) {
      *reinterpret_cast<uint4*>(v) = __ldg(reinterpret_cast<const uint4*>(x + pix * g.C + k0 + k));
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        v[j] = (pix >= 0 && k0 + k + j < g.C) ? x[pix * g.C + k0 + k + j] : from_f<T>(0.0f);
      }
    }
    *reinterpret_cast<uint4*>(As + h * kStage + k) = *reinterpret_cast<const uint4*>(v);
  }
}

__device__ __forceinline__ void mma_bf16(float& d0, float& d1, float& d2, float& d3,
                                         const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One product chunk: (rows x 64) += A (rows x 64 k) x Bs, where arow(m)
// points at row m's 64 k values (rows past the product's end may point at
// any valid row).  Each thread holds N accumulators.
//
// bf16: the (16-row, 8-column) output tiles are dealt to the warps in turn:
// tile t = warp + 8 q is m-tile t / 8, n-tile t % 8; acc[4 q + e] holds the
// mma's fragment element e.
template <int N, typename ARow>
__device__ __forceinline__ void run_chunk(float (&acc)[N], int rows, ARow arow,
                                          const __nv_bfloat16* Bs) {
  const int mtiles = (rows + 15) / 16;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const int t = warp + kWarps * q;
    if (t >= mtiles * (kNC / 8)) break;
    const int mt = t / (kNC / 8);
    const int nt = t - mt * (kNC / 8);
    const uint32_t* a_lo = reinterpret_cast<const uint32_t*>(arow(mt * 16 + g)) + tig;
    const uint32_t* a_hi = reinterpret_cast<const uint32_t*>(arow(mt * 16 + g + 8)) + tig;
    const uint32_t* bp = reinterpret_cast<const uint32_t*>(Bs + (nt * 8 + g) * kStage) + tig;
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      const int o = ks * 8;
      const uint32_t a[4] = {a_lo[o], a_hi[o], a_lo[o + 4], a_hi[o + 4]};
      mma_bf16(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3], a, bp[o], bp[o + 4]);
    }
  }
}

// f32: exact FMAs; the thread owns column n = tid % 64 and rows tid / 64 + 4 q.
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

// Calls f(m, n, value) for each accumulator run_chunk filled (the last
// argument only selects the type's layout).
template <int N, typename F>
__device__ __forceinline__ void each_chunk(float (&acc)[N], int rows, F f,
                                           const __nv_bfloat16*) {
  const int mtiles = (rows + 15) / 16;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const int t = warp + kWarps * q;
    if (t >= mtiles * (kNC / 8)) break;
    const int mt = t / (kNC / 8);
    const int nt = t - mt * (kNC / 8);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f(mt * 16 + g + 8 * (e >> 1), nt * 8 + 2 * tig + (e & 1), acc[4 * q + e]);
    }
  }
}

template <int N, typename F>
__device__ __forceinline__ void each_chunk(float (&acc)[N], int rows, F f, const float*) {
  const int n = threadIdx.x % kNC;
  const int m0 = threadIdx.x / kNC;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    if (m0 + 4 * q < rows) f(m0 + 4 * q, n, acc[q]);
  }
}

// Accumulators per thread: 32 for the halo's product (up to 128 rows: 8
// m-tiles of 16, or 32 rows a thread in f32), 16 for the tile's (up to 64).
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                        const float* __restrict__ b1, const T* __restrict__ w2,
                        const float* __restrict__ b2, const T* __restrict__ w3,
                        const float* __restrict__ b3, T* __restrict__ out, Geo g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int py = g.Pp + kPad;                             // pitch of y1 and y2
  T* y1s = reinterpret_cast<T*>(smem_raw);                // (NHp, py)
  T* y2s = y1s + g.NHp * py;                              // (Mp, py)
  T* As = y2s + g.Mp * py;                                // (NHp, kStage): x's halo
  T* Bs = As + g.NHp * kStage;                            // (64, kStage): weights
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
      y1s[h * py + n0 + n] = from_f<T>(inside ? fmaxf(v + bias, 0.0f) : 0.0f);
    }, Bs);
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
      y2s[m * py + n0 + n] = from_f<T>(fmaxf(v + bias, 0.0f));
    }, Bs);
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
      out[at] = from_f<T>(fmaxf(v + b3[n0 + n] + to_f(x[at]), 0.0f));
    }, Bs);
  }
}

size_t smem_bytes(const Geo& g, int elem) {
  const size_t py = g.Pp + kPad;
  return elem * (static_cast<size_t>(g.NHp) * py + static_cast<size_t>(g.Mp) * py +
                 static_cast<size_t>(g.NHp) * kStage + static_cast<size_t>(kKC) * kStage);
}

// The tile: the most output pixels (th <= 4 rows, tw <= 16 columns spread
// evenly over the width) whose halo and working set fit; then the smallest
// halo.  Returns false when nothing fits.
bool plan(int H, int W, int C, int P, int d, int elem, Geo* out) {
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
      if (g.NHp > kMaxHalo || g.M > kMaxTile || smem_bytes(g, elem) > kMaxSmem) continue;
      if (!found || g.M > best.M || (g.M == best.M && g.NHp < best.NHp)) {
        best = g;
        found = true;
      }
    }
  }
  *out = best;
  return found;
}

template <typename T>
int launch(const T* x, int B, const Geo& g, const T* w1, const float* b1, const T* w2,
           const float* b2, const T* w3, const float* b3, T* out, cudaStream_t stream) {
  const size_t smem = smem_bytes(g, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(fused_bottleneck_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g.W + g.tw - 1) / g.tw, (g.H + g.th - 1) / g.th, B);
  fused_bottleneck_kernel<T><<<grid, kThreads, smem, stream>>>(x, w1, b1, w2, b2, w3, b3, out, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).  x and
// out are contiguous (B, H, W, C) NHWC of one dtype (is_bf16 = 1 for bf16, 0
// for f32) and must not overlap; w1 (C, P), w2 (3, 3, P, P), w3 (P, C) are
// contiguous in that dtype, b1, b2 (P) and b3 (C) f32.  All pointers are
// device pointers; nothing is allocated here.
int zs3_fused_bottleneck(const void* x, int is_bf16, int B, int H, int W, int C, int P, int d,
                         const void* w1, const float* b1, const void* w2, const float* b2,
                         const void* w3, const float* b3, void* out, void* stream) {
  Geo g;
  if (B < 1 || H < 1 || W < 1 || C < 1 || P < 1 || d < 1 ||
      !plan(H, W, C, P, d, is_bf16 ? 2 : 4, &g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return launch(static_cast<const T*>(x), B, g, static_cast<const T*>(w1), b1,
                  static_cast<const T*>(w2), b2, static_cast<const T*>(w3), b3,
                  static_cast<T*>(out), s);
  }
  return launch(static_cast<const float*>(x), B, g, static_cast<const float*>(w1), b1,
                static_cast<const float*>(w2), b2, static_cast<const float*>(w3), b3,
                static_cast<float*>(out), s);
}

// The tile a launch would take: writes {th, tw, halo pixels, smem bytes}
// and returns 0, or returns -1 when no tile fits shared memory.
int zs3_fused_bottleneck_plan(int is_bf16, int H, int W, int C, int P, int d, int* info) {
  Geo g;
  if (H < 1 || W < 1 || C < 1 || P < 1 || d < 1 || !plan(H, W, C, P, d, is_bf16 ? 2 : 4, &g)) {
    return -1;
  }
  info[0] = g.th;
  info[1] = g.tw;
  info[2] = g.NH;
  info[3] = static_cast<int>(smem_bytes(g, is_bf16 ? 2 : 4));
  return 0;
}

const char* zs3_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
