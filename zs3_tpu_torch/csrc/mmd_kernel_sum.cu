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
//   for x (C,N,D), y (C,M,D), wx (C,N), wy (C,M) f32, D <= 512.
//
// Bound on an H100 SXM: operations.  With S=6 sigmas, one K2 call does
// C*N*M*(2D+3S+6) f32 operations (the dot, d2, S exponentials with their
// scale and sum, the weights; an expf counted as one): 184 MFLOP at the
// ZS3 step's shape C=21, N=M=128, D=256, or 2.75 us at 67 TFLOP/s, on
// 5.5 MB of input (1.6 us at 3.35 TB/s).  One K3 call does
// C*N*M*(4D+5S+8) = 365 MFLOP (5.4 us) on 8.3 MB.  TF32 tensor cores
// would not compute the same function.
//
// Design: the N x M matrix never reaches device memory.  One block of 256
// threads owns a (class, tile of 32 x rows) pair and loops over tiles of
// 32 y rows; both tiles sit in dynamic shared memory with a row pitch of
// 1 mod 32 words, so the 16 rows a warp reads at one depth fall in 16
// banks.  Row norms are taken once per tile with a fixed shuffle tree.
// Each thread forms a 2x2 block of the 32x32 dot tile with f32 FMAs, then
// d2, the exponentials (expf, not __expf) and the weights.  K2 reduces
// each block to one partial in a fixed order and a second kernel sums
// each class's partials in a fixed order: no float atomics, so two calls
// give the same bits.  K3 writes the weighted C and K tiles to shared
// memory and each thread accumulates C.y for one x row over D/8 columns
// in registers; a block owns its rows, so nothing is reduced across
// blocks.  Rows past N or M load as zeros with weight 0 and are never
// written.  The TPU kernel's row padding to 1024 and feature padding to
// 128 (its (8,128) tiling) and its sequential SMEM accumulator are gone.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;      // x rows per block, y rows per inner step
constexpr int kThreads = 256;  // 16x16 threads, 2x2 dot entries each
constexpr int kMaxSigmas = 8;
constexpr int kMaxD = 512;

struct Sigmas {
  int count;
  float coef[kMaxSigmas];  // -1 / (2 sigma_s)
  float inv[kMaxSigmas];   // 1 / sigma_s
};

__host__ __device__ inline int row_pitch(int d) { return (d + 31) / 32 * 32 + 1; }

// Rows [row0, row0 + kTile) of a (rows, D) matrix into shared memory at
// `pitch`; rows past the end are zeros.  Weights likewise, 0 past the end.
// With `vec4` (D a multiple of 4, 16-byte aligned rows) each thread moves
// 16 bytes a load; the loop is unrolled so several loads are in flight.
__device__ void load_tile(float* dst, float* wdst, const float* __restrict__ src,
                          const float* __restrict__ w, int row0, int rows, int D,
                          int pitch, bool vec4) {
  if (vec4) {
    const int d4 = D / 4;
#pragma unroll 8
    for (int e = threadIdx.x; e < kTile * d4; e += kThreads) {
      const int r = e / d4;
      const int k = (e - r * d4) * 4;
      const float4 v =
          row0 + r < rows
              ? *reinterpret_cast<const float4*>(src + static_cast<long long>(row0 + r) * D + k)
              : make_float4(0.f, 0.f, 0.f, 0.f);
      float* out = dst + r * pitch + k;
      out[0] = v.x;
      out[1] = v.y;
      out[2] = v.z;
      out[3] = v.w;
    }
  } else {
#pragma unroll 8
    for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
      const int r = e / D;
      const int k = e - r * D;
      dst[r * pitch + k] =
          row0 + r < rows ? src[static_cast<long long>(row0 + r) * D + k] : 0.f;
    }
  }
  if (threadIdx.x < kTile) {
    const int r = row0 + threadIdx.x;
    wdst[threadIdx.x] = r < rows ? w[r] : 0.f;
  }
}

// norms[r] = |tile row r|^2, each row summed by one warp in a fixed order.
__device__ void row_norms(float* norms, const float* tile, int D, int pitch) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < kTile; r += kThreads / 32) {
    float s = 0.f;
    for (int k = lane; k < D; k += 32) {
      const float v = tile[r * pitch + k];
      s = fmaf(v, v, s);
    }
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) norms[r] = s;
  }
}

// The thread's 2x2 entries (rows ty, ty+16; columns tx, tx+16) of the
// x-tile . y-tile^T product.
__device__ void dot_2x2(float acc[2][2], const float* xs, const float* ys, int D,
                        int pitch, int ty, int tx) {
  acc[0][0] = acc[0][1] = acc[1][0] = acc[1][1] = 0.f;
  const float* x0 = xs + ty * pitch;
  const float* x1 = xs + (ty + 16) * pitch;
  const float* y0 = ys + tx * pitch;
  const float* y1 = ys + (tx + 16) * pitch;
#pragma unroll 8
  for (int k = 0; k < D; ++k) {
    const float a0 = x0[k], a1 = x1[k], b0 = y0[k], b1 = y1[k];
    acc[0][0] = fmaf(a0, b0, acc[0][0]);
    acc[0][1] = fmaf(a0, b1, acc[0][1]);
    acc[1][0] = fmaf(a1, b0, acc[1][0]);
    acc[1][1] = fmaf(a1, b1, acc[1][1]);
  }
}

__device__ __forceinline__ float sq_dist(float x2, float y2, float xy) {
  return fmaxf(x2 + y2 - 2.f * xy, 0.f);
}

// Shared memory of either kernel: the two tiles, then small arrays.
struct Smem {
  float* xs;
  float* ys;
  float* x2;
  float* y2;
  float* wx;
  float* wy;
  float* extra;
};

__device__ Smem carve(float* base, int pitch) {
  Smem s;
  s.xs = base;
  s.ys = s.xs + kTile * pitch;
  s.x2 = s.ys + kTile * pitch;
  s.y2 = s.x2 + kTile;
  s.wx = s.y2 + kTile;
  s.wy = s.wx + kTile;
  s.extra = s.wy + kTile;
  return s;
}

size_t smem_bytes(int D, int extra_floats) {
  return sizeof(float) *
         (static_cast<size_t>(2 * kTile) * row_pitch(D) + 4 * kTile + extra_floats);
}

// ---- K2 ------------------------------------------------------------------

constexpr int kSumExtra = kThreads;  // per-thread partials for the block sum

__global__ void __launch_bounds__(kThreads)
kernel_sum_blocks(const float* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ wx, const float* __restrict__ wy,
                  int N, int M, int D, bool vec4, Sigmas sig,
                  float* __restrict__ partials) {
  extern __shared__ float smem[];
  const int pitch = row_pitch(D);
  Smem s = carve(smem, pitch);
  const int c = blockIdx.y;
  const int x0 = blockIdx.x * kTile;
  const float* xc = x + static_cast<long long>(c) * N * D;
  const float* yc = y + static_cast<long long>(c) * M * D;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  load_tile(s.xs, s.wx, xc, wx + static_cast<long long>(c) * N, x0, N, D, pitch, vec4);
  __syncthreads();
  row_norms(s.x2, s.xs, D, pitch);

  float total = 0.f;
  for (int y0 = 0; y0 < M; y0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(s.ys, s.wy, yc, wy + static_cast<long long>(c) * M, y0, M, D, pitch, vec4);
    __syncthreads();
    row_norms(s.y2, s.ys, D, pitch);
    __syncthreads();
    float acc[2][2];
    dot_2x2(acc, s.xs, s.ys, D, pitch, ty, tx);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int i = ty + 16 * a;
        const int j = tx + 16 * b;
        const float d2 = sq_dist(s.x2[i], s.y2[j], acc[a][b]);
        float k = 0.f;
        for (int q = 0; q < sig.count; ++q) k += expf(d2 * sig.coef[q]);
        total += (s.wx[i] * k) * s.wy[j];
      }
    }
  }

  float* red = s.extra;
  red[threadIdx.x] = total;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) partials[static_cast<long long>(c) * gridDim.x + blockIdx.x] = red[0];
}

// out[c] = sum of class c's block partials, in block order.
__global__ void kernel_sum_classes(const float* __restrict__ partials, int blocks,
                                   int C, float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partials[static_cast<long long>(c) * blocks + b];
  out[c] = s;
}

// ---- K3 ------------------------------------------------------------------

constexpr int kCPitch = kTile + 1;
constexpr int kGradExtra = 2 * kTile * kCPitch;  // weighted C and K tiles
constexpr int kLanes = kThreads / kTile;         // threads per x row in C.y

template <int kChunks>  // columns per thread: D <= kLanes * kChunks
__global__ void __launch_bounds__(kThreads)
kernel_sum_grad_x(const float* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ wx, const float* __restrict__ wy,
                  int N, int M, int D, bool vec4, Sigmas sig, float* __restrict__ dx,
                  float* __restrict__ dwx) {
  extern __shared__ float smem[];
  const int pitch = row_pitch(D);
  Smem s = carve(smem, pitch);
  float* cs = s.extra;               // (32, 33): wx_i wy_j sum_s e/sigma_s
  float* ks = cs + kTile * kCPitch;  // (32, 33): wy_j sum_s e
  const int c = blockIdx.y;
  const int x0 = blockIdx.x * kTile;
  const float* xc = x + static_cast<long long>(c) * N * D;
  const float* yc = y + static_cast<long long>(c) * M * D;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int row = threadIdx.x / kLanes;  // the x row this thread accumulates
  const int lane = threadIdx.x % kLanes;

  load_tile(s.xs, s.wx, xc, wx + static_cast<long long>(c) * N, x0, N, D, pitch, vec4);
  __syncthreads();
  row_norms(s.x2, s.xs, D, pitch);

  float cy[kChunks];
#pragma unroll
  for (int m = 0; m < kChunks; ++m) cy[m] = 0.f;
  float rowsum = 0.f;
  float dw = 0.f;
  for (int y0 = 0; y0 < M; y0 += kTile) {
    __syncthreads();
    load_tile(s.ys, s.wy, yc, wy + static_cast<long long>(c) * M, y0, M, D, pitch, vec4);
    __syncthreads();
    row_norms(s.y2, s.ys, D, pitch);
    __syncthreads();
    float acc[2][2];
    dot_2x2(acc, s.xs, s.ys, D, pitch, ty, tx);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int i = ty + 16 * a;
        const int j = tx + 16 * b;
        const float d2 = sq_dist(s.x2[i], s.y2[j], acc[a][b]);
        float k = 0.f;
        float cw = 0.f;
        for (int q = 0; q < sig.count; ++q) {
          const float e = expf(d2 * sig.coef[q]);
          k += e;
          cw += e * sig.inv[q];
        }
        cs[i * kCPitch + j] = (s.wx[i] * cw) * s.wy[j];
        ks[i * kCPitch + j] = k * s.wy[j];
      }
    }
    __syncthreads();
    const float* crow = cs + row * kCPitch;
    const float* krow = ks + row * kCPitch;
    for (int j = 0; j < kTile; ++j) {
      const float cij = crow[j];
      rowsum += cij;
      dw += krow[j];
      const float* yj = s.ys + j * pitch;
#pragma unroll
      for (int m = 0; m < kChunks; ++m) {
        const int d = lane + kLanes * m;
        if (d < D) cy[m] = fmaf(cij, yj[d], cy[m]);
      }
    }
  }

  const int i = x0 + row;
  if (i >= N) return;
  float* out = dx + (static_cast<long long>(c) * N + i) * D;
  const float* xi = s.xs + row * pitch;
#pragma unroll
  for (int m = 0; m < kChunks; ++m) {
    const int d = lane + kLanes * m;
    if (d < D) out[d] = cy[m] - rowsum * xi[d];
  }
  if (dwx != nullptr && lane == 0) dwx[static_cast<long long>(c) * N + i] = dw;
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

template <typename Kernel>
int opt_in_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <int kChunks>
int launch_grad(const float* x, const float* y, const float* wx, const float* wy, int C,
                int N, int M, int D, const Sigmas& sig, float* dx, float* dwx,
                cudaStream_t stream) {
  const size_t smem = smem_bytes(D, kGradExtra);
  int err = opt_in_smem(kernel_sum_grad_x<kChunks>, smem);
  if (err != 0) return err;
  const dim3 grid((N + kTile - 1) / kTile, C);
  kernel_sum_grad_x<kChunks><<<grid, kThreads, smem, stream>>>(
      x, y, wx, wy, N, M, D, can_vec4(x, y, D), sig, dx, dwx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Scratch floats K2 needs for `partials`: C * ceil(N / 32).
int zs3_mmd_partials(int C, int N) { return C * ((N + kTile - 1) / kTile); }

// K2.  x (C,N,D), y (C,M,D), wx (C,N), wy (C,M), partials and out (C,)
// are device pointers; sigmas (S <= 8) is a host array.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int zs3_mmd_kernel_sum(const float* x, const float* y, const float* wx, const float* wy,
                       int C, int N, int M, int D, const float* sigmas, int S,
                       float* partials, float* out, void* stream) {
  if (C < 1 || N < 1 || M < 1 || D < 1 || D > kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Sigmas sig;
  int err = make_sigmas(sigmas, S, &sig);
  if (err != 0) return err;
  const size_t smem = smem_bytes(D, kSumExtra);
  err = opt_in_smem(kernel_sum_blocks, smem);
  if (err != 0) return err;
  auto st = static_cast<cudaStream_t>(stream);
  const int blocks = (N + kTile - 1) / kTile;
  kernel_sum_blocks<<<dim3(blocks, C), kThreads, smem, st>>>(
      x, y, wx, wy, N, M, D, can_vec4(x, y, D), sig, partials);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  kernel_sum_classes<<<(C + 127) / 128, 128, 0, st>>>(partials, blocks, C, out);
  return static_cast<int>(cudaGetLastError());
}

// K3: dx (C,N,D) and dwx (C,N) with respect to x; dwx may be null.  Same
// conventions as zs3_mmd_kernel_sum.
int zs3_mmd_kernel_sum_grad(const float* x, const float* y, const float* wx,
                            const float* wy, int C, int N, int M, int D,
                            const float* sigmas, int S, float* dx, float* dwx,
                            void* stream) {
  if (C < 1 || N < 1 || M < 1 || D < 1 || D > kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Sigmas sig;
  const int err = make_sigmas(sigmas, S, &sig);
  if (err != 0) return err;
  auto st = static_cast<cudaStream_t>(stream);
  if (D <= kLanes * 4) return launch_grad<4>(x, y, wx, wy, C, N, M, D, sig, dx, dwx, st);
  if (D <= kLanes * 16) return launch_grad<16>(x, y, wx, wy, C, N, M, D, sig, dx, dwx, st);
  if (D <= kLanes * 32) return launch_grad<32>(x, y, wx, wy, C, N, M, D, sig, dx, dwx, st);
  return launch_grad<64>(x, y, wx, wy, C, N, M, D, sig, dx, dwx, st);
}

const char* zs3_mmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
