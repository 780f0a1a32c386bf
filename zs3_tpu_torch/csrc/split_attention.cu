// Split attention of radix 2 (ResNeSt's SplAt), its memory-bound ends, for
// sm_90a.
//
// Replaces no TPU kernel: zs3_tpu has no ResNeSt.  In a SplAt block the
// grouped 3x3 conv gives u, a channels_last (N, 2C, H, W) tensor whose two
// splits u_0 = channels [0, C) and u_1 = channels [C, 2C) are mixed per
// channel by a two-way softmax over a gate that reads their global mean:
//
//   g[n, c]    = mean_hw(u_0 + u_1)                         (splat_gap)
//   z          = fc2(ReLU(BN(fc1(g))))                      (torch: tiny)
//   a[n, r, c] = softmax_r(z[n, r*C + c])
//   out        = a_0 * u_0 + a_1 * u_1                      (splat_combine)
//
// and backward, with dy the gradient of out and dg the gradient autograd
// brings back through the gate to g:
//
//   da[n, r, c] = sum_hw dy * u_r;  dz_r = a_r * (da_r - sum_r' a_r' da_r')
//                                                           (splat_bwd_reduce)
//   du_r        = a_r * dy + dg / HW                        (splat_dx)
//
// In plain torch these are about 7 launches forward and 10 backward a
// block, and 4-5 passes over u where the four kernels take: forward one
// read of u (gap) and one read of u with one write of out (combine);
// backward one read of dy and u (reduce) and one read of dy with one
// write of du (dx).  A few operations a byte at most: the design is only
// about moving the bytes at the full rate.
//
// The layout.  u and du are read as the row-major (N, P, 2C) matrix of
// their P = H*W pixels an image, out and dy as (N, P, C); bf16, f32 or
// f64, every tensor 16-byte aligned, C a multiple of 16 bytes' values.
// A thread owns VEC adjacent channels c0.. of C (16 bytes: 8 bf16, 4 f32
// or 2 f64), which it reads in both splits (c0 and C + c0) and in dy, and
// walks rows of one image, accumulating in A (f32 for bf16 and f32, f64
// for f64).  A CTA of 256 threads is TX channel groups by TY = 256/TX
// rows, over one block of TX*VEC channels, one slab of one image's rows;
// the grid is (channel blocks, slabs, N), sized by the host
// (ops/splat_kernels.py::plan) to one wave of three CTAs an SM.  z, a, g,
// dg and dz are (N, 2C) or (N, C), contiguous and in A: the gate between
// the two ends (fc1, BN, ReLU, fc2) runs in f32 for bf16 u (its BN
// normalises N global means that differ little from image to image, which
// magnifies rounding).
//
// The two reductions are deterministic and use no float atomics: each
// CTA reduces its threads in a fixed tree (shuffles, then its warps in
// order) and writes one partial per channel; the last CTA of an (image,
// channel block) to arrive (an integer ticket) sums the slabs' partials
// in slab order and resets its ticket for the next launch.  The softmax
// is folded into the combine (each thread forms its channels' weights
// once, and the first slab's CTAs store them for the backward) and its
// backward into the reduce's last CTA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;   // CTAs an SM (the plan's CTAS_PER_SM)
constexpr int kUnrollFwd = 4;   // rows a thread loads at once, forward
constexpr int kUnrollBwd = 2;   // rows a thread loads at once, backward
constexpr int kPartBatch = 2;   // slab partials a thread of the last CTA loads at once

template <typename T>
struct AccOf {
  using type = float;
};
template <>
struct AccOf<double> {
  using type = double;
};

template <typename A>
struct Args {
  const void* u;   // (N, P, 2C)
  const void* dy;  // (N, P, C)
  void* out;       // combine: out (N, P, C); dx: du (N, P, 2C)
  const A* z;      // (N, 2C) gate logits
  A* a;            // (N, 2C) softmax weights
  A* g;            // (N, C) mean of u_0 + u_1
  const A* dg;     // (N, C) its gradient
  A* dz;           // (N, 2C) the gate logits' gradient
  A* part;         // (N, 2, nslabs, C) partials
  int* tickets;    // N * cblocks, 0 between launches
  long long P, rows_per_slab;
  int C, nslabs;
  A inv_p;
};

template <typename T, int VEC>
struct Vec;

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<double, 2> {
  static __device__ __forceinline__ void load(const double* p, double (&v)[2]) {
    const double2 u = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = u.x;
    v[1] = u.y;
  }
  static __device__ __forceinline__ void store(double* p, const double (&v)[2]) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  }
};

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float exp_acc(float v) { return expf(v); }
__device__ __forceinline__ double exp_acc(double v) { return exp(v); }

// A slab partial, written by other CTAs: through L2.
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ double load_cg(const double* p) { return __ldcg(p); }

__device__ __forceinline__ int thread_id() { return threadIdx.y * blockDim.x + threadIdx.x; }

// The CTA's K sums per channel, in a fixed order: within a warp down the
// lanes that share the channel group (offsets 16 .. TX), then warp 0
// takes the warps in order.  The result is in the threads of warp 0 whose
// lane < TX; all threads call it.
template <typename A, int VEC, int K>
__device__ void block_sums(A (&s)[K][VEC]) {
  __shared__ A s_part[kWarps][K][32 * VEC];
  const int TX = blockDim.x;
  for (int off = 16; off >= TX; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int v = 0; v < VEC; ++v) s[k][v] += __shfl_down_sync(0xffffffffu, s[k][v], off);
  }
  const int tid = thread_id(), warp = tid / 32, lane = tid % 32;
  if (lane < TX) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int v = 0; v < VEC; ++v) s_part[warp][k][lane * VEC + v] = s[k][v];
  }
  __syncthreads();
  if (warp == 0 && lane < TX) {
    for (int w = 1; w < kWarps; ++w) {
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int v = 0; v < VEC; ++v) s[k][v] += s_part[w][k][lane * VEC + v];
    }
  }
  __syncthreads();
}

// After warp 0's writers stored this CTA's partial: true in every thread
// of the CTA that arrived last at `ticket`, which then reads every partial
// (through L2) and resets the ticket.
__device__ bool arrived_last(int* ticket, int nslabs) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (thread_id() == 0) s_last = atomicAdd(ticket, 1) == nslabs - 1;
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

// The rows [begin, end) of this CTA's slab within its image.
template <typename A>
__device__ __forceinline__ void slab_range(const Args<A>& g, long long& begin, long long& end) {
  begin = blockIdx.y * g.rows_per_slab;
  end = min(g.P, begin + g.rows_per_slab);
}

// Each slab's K partials into part, then in the last CTA of the (image,
// channel block) their sums in slab order back in s (warp 0's writers).
template <typename A, int VEC, int K>
__device__ bool reduce_slabs(const Args<A>& g, A (&s)[K][VEC], int c0, bool active) {
  const int C = g.C, n = blockIdx.z, slab = blockIdx.y, TY = blockDim.y;
  block_sums<A, VEC, K>(s);
  const bool writer = thread_id() < blockDim.x && active;
  A* part = g.part + static_cast<long long>(n) * K * g.nslabs * C;
  if (writer) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        part[(static_cast<long long>(k) * g.nslabs + slab) * C + c0 + v] = s[k][v];
  }
  if (!arrived_last(g.tickets + n * gridDim.x + blockIdx.x, g.nslabs)) return false;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int v = 0; v < VEC; ++v) s[k][v] = 0;
  if (active) {
    for (int s0 = threadIdx.y; s0 < g.nslabs; s0 += kPartBatch * TY) {
      A b[kPartBatch][K][VEC];
#pragma unroll
      for (int u = 0; u < kPartBatch; ++u) {
        if (s0 + u * TY < g.nslabs) {
#pragma unroll
          for (int k = 0; k < K; ++k)
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              b[u][k][v] =
                  load_cg(part + (static_cast<long long>(k) * g.nslabs + s0 + u * TY) * C + c0 + v);
        }
      }
#pragma unroll
      for (int u = 0; u < kPartBatch; ++u) {
        if (s0 + u * TY < g.nslabs) {
#pragma unroll
          for (int k = 0; k < K; ++k)
#pragma unroll
            for (int v = 0; v < VEC; ++v) s[k][v] += b[u][k][v];
        }
      }
    }
  }
  block_sums<A, VEC, K>(s);
  if (thread_id() == 0) g.tickets[n * gridDim.x + blockIdx.x] = 0;
  return true;
}

template <typename T, int VEC, typename A = typename AccOf<T>::type>
__global__ void __launch_bounds__(kThreads, kMinBlocks) splat_gap_kernel(Args<A> g) {
  const int TY = blockDim.y, C = g.C, n = blockIdx.z;
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  const bool active = c0 < C;
  long long begin, end;
  slab_range(g, begin, end);
  A s[1][VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) s[0][v] = 0;
  if (active) {
    const long long row = 2LL * C;
    const T* u = static_cast<const T*>(g.u) + n * g.P * row + c0;
    long long r = begin + threadIdx.y;
    for (; r + (kUnrollFwd - 1) * TY < end; r += kUnrollFwd * TY) {
      A x[kUnrollFwd][2][VEC];
#pragma unroll
      for (int k = 0; k < kUnrollFwd; ++k) {
        Vec<T, VEC>::load(u + (r + k * TY) * row, x[k][0]);
        Vec<T, VEC>::load(u + (r + k * TY) * row + C, x[k][1]);
      }
#pragma unroll
      for (int k = 0; k < kUnrollFwd; ++k)
#pragma unroll
        for (int v = 0; v < VEC; ++v) s[0][v] += x[k][0][v] + x[k][1][v];
    }
    for (; r < end; r += TY) {
      A x0[VEC], x1[VEC];
      Vec<T, VEC>::load(u + r * row, x0);
      Vec<T, VEC>::load(u + r * row + C, x1);
#pragma unroll
      for (int v = 0; v < VEC; ++v) s[0][v] += x0[v] + x1[v];
    }
  }
  if (!reduce_slabs<A, VEC, 1>(g, s, c0, active)) return;
  if (thread_id() < blockDim.x && active) {
    A* out = g.g + static_cast<long long>(n) * C + c0;
#pragma unroll
    for (int v = 0; v < VEC; ++v) out[v] = s[0][v] * g.inv_p;
  }
}

// The softmax weights (a_0, a_1) of this thread's channels of image n, from
// the gate logits.
template <int VEC, typename A>
__device__ __forceinline__ void softmax2(const Args<A>& g, int n, int c0, A (&a0)[VEC],
                                         A (&a1)[VEC]) {
  const A* z = g.z + 2LL * g.C * n + c0;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const A z0 = z[v], z1 = z[g.C + v];
    const A m = z0 > z1 ? z0 : z1;
    const A e0 = exp_acc(z0 - m), e1 = exp_acc(z1 - m);
    const A inv = A(1) / (e0 + e1);
    a0[v] = e0 * inv;
    a1[v] = e1 * inv;
  }
}

template <typename T, int VEC, typename A = typename AccOf<T>::type>
__global__ void __launch_bounds__(kThreads, kMinBlocks) splat_combine_kernel(Args<A> g) {
  const int TY = blockDim.y, C = g.C, n = blockIdx.z;
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (c0 >= C) return;
  long long begin, end;
  slab_range(g, begin, end);
  A a0[VEC], a1[VEC];
  softmax2<VEC, A>(g, n, c0, a0, a1);
  if (blockIdx.y == 0 && threadIdx.y == 0) {
    A* a = g.a + 2LL * C * n + c0;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      a[v] = a0[v];
      a[C + v] = a1[v];
    }
  }
  const long long row = 2LL * C;
  const T* u = static_cast<const T*>(g.u) + n * g.P * row + c0;
  T* out = static_cast<T*>(g.out) + n * g.P * C + c0;
  long long r = begin + threadIdx.y;
  for (; r + (kUnrollFwd - 1) * TY < end; r += kUnrollFwd * TY) {
    A x[kUnrollFwd][2][VEC];
#pragma unroll
    for (int k = 0; k < kUnrollFwd; ++k) {
      Vec<T, VEC>::load(u + (r + k * TY) * row, x[k][0]);
      Vec<T, VEC>::load(u + (r + k * TY) * row + C, x[k][1]);
    }
#pragma unroll
    for (int k = 0; k < kUnrollFwd; ++k) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) x[k][0][v] = fma_rn(a1[v], x[k][1][v], a0[v] * x[k][0][v]);
      Vec<T, VEC>::store(out + (r + k * TY) * C, x[k][0]);
    }
  }
  for (; r < end; r += TY) {
    A x0[VEC], x1[VEC];
    Vec<T, VEC>::load(u + r * row, x0);
    Vec<T, VEC>::load(u + r * row + C, x1);
#pragma unroll
    for (int v = 0; v < VEC; ++v) x0[v] = fma_rn(a1[v], x1[v], a0[v] * x0[v]);
    Vec<T, VEC>::store(out + r * C, x0);
  }
}

template <typename T, int VEC, typename A = typename AccOf<T>::type>
__global__ void __launch_bounds__(kThreads, kMinBlocks) splat_bwd_reduce_kernel(Args<A> g) {
  const int TY = blockDim.y, C = g.C, n = blockIdx.z;
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  const bool active = c0 < C;
  long long begin, end;
  slab_range(g, begin, end);
  A s[2][VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) s[0][v] = s[1][v] = 0;
  if (active) {
    const long long row = 2LL * C;
    const T* u = static_cast<const T*>(g.u) + n * g.P * row + c0;
    const T* dy = static_cast<const T*>(g.dy) + n * g.P * C + c0;
    long long r = begin + threadIdx.y;
    for (; r + (kUnrollBwd - 1) * TY < end; r += kUnrollBwd * TY) {
      A x[kUnrollBwd][2][VEC], d[kUnrollBwd][VEC];
#pragma unroll
      for (int k = 0; k < kUnrollBwd; ++k) {
        Vec<T, VEC>::load(u + (r + k * TY) * row, x[k][0]);
        Vec<T, VEC>::load(u + (r + k * TY) * row + C, x[k][1]);
        Vec<T, VEC>::load(dy + (r + k * TY) * C, d[k]);
      }
#pragma unroll
      for (int k = 0; k < kUnrollBwd; ++k)
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          s[0][v] = fma_rn(d[k][v], x[k][0][v], s[0][v]);
          s[1][v] = fma_rn(d[k][v], x[k][1][v], s[1][v]);
        }
    }
    for (; r < end; r += TY) {
      A x0[VEC], x1[VEC], d[VEC];
      Vec<T, VEC>::load(u + r * row, x0);
      Vec<T, VEC>::load(u + r * row + C, x1);
      Vec<T, VEC>::load(dy + r * C, d);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        s[0][v] = fma_rn(d[v], x0[v], s[0][v]);
        s[1][v] = fma_rn(d[v], x1[v], s[1][v]);
      }
    }
  }
  if (!reduce_slabs<A, VEC, 2>(g, s, c0, active)) return;
  if (thread_id() < blockDim.x && active) {
    // The softmax's backward: dz_r = a_r * (da_r - sum_r' a_r' * da_r').
    const A* a = g.a + 2LL * C * n + c0;
    A* dz = g.dz + 2LL * C * n + c0;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const A a0 = a[v], a1 = a[C + v];
      const A dot = fma_rn(a1, s[1][v], a0 * s[0][v]);
      dz[v] = a0 * (s[0][v] - dot);
      dz[C + v] = a1 * (s[1][v] - dot);
    }
  }
}

template <typename T, int VEC, typename A = typename AccOf<T>::type>
__global__ void __launch_bounds__(kThreads, kMinBlocks) splat_dx_kernel(Args<A> g) {
  const int TY = blockDim.y, C = g.C, n = blockIdx.z;
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (c0 >= C) return;
  long long begin, end;
  slab_range(g, begin, end);
  A a0[VEC], a1[VEC], k0[VEC];
  {
    const A* a = g.a + 2LL * C * n + c0;
    const A* dg = g.dg + static_cast<long long>(n) * C + c0;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      a0[v] = a[v];
      a1[v] = a[C + v];
      k0[v] = dg[v] * g.inv_p;
    }
  }
  const long long row = 2LL * C;
  const T* dy = static_cast<const T*>(g.dy) + n * g.P * C + c0;
  T* du = static_cast<T*>(g.out) + n * g.P * row + c0;
  long long r = begin + threadIdx.y;
  for (; r + (kUnrollBwd - 1) * TY < end; r += kUnrollBwd * TY) {
    A d[kUnrollBwd][VEC];
#pragma unroll
    for (int k = 0; k < kUnrollBwd; ++k) Vec<T, VEC>::load(dy + (r + k * TY) * C, d[k]);
#pragma unroll
    for (int k = 0; k < kUnrollBwd; ++k) {
      A o0[VEC], o1[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        o0[v] = fma_rn(a0[v], d[k][v], k0[v]);
        o1[v] = fma_rn(a1[v], d[k][v], k0[v]);
      }
      Vec<T, VEC>::store(du + (r + k * TY) * row, o0);
      Vec<T, VEC>::store(du + (r + k * TY) * row + C, o1);
    }
  }
  for (; r < end; r += TY) {
    A d[VEC], o0[VEC], o1[VEC];
    Vec<T, VEC>::load(dy + r * C, d);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      o0[v] = fma_rn(a0[v], d[v], k0[v]);
      o1[v] = fma_rn(a1[v], d[v], k0[v]);
    }
    Vec<T, VEC>::store(du + r * row, o0);
    Vec<T, VEC>::store(du + r * row + C, o1);
  }
}

// The launch geometry the host's plan (ops/splat_kernels.py) hands over,
// in this order: type (0 f32, 1 bf16, 2 f64), N, P, C, tx, cblocks,
// nslabs, rows_per_slab.
struct Geometry {
  long long type, N, P, C, tx, cblocks, nslabs, rows_per_slab;
  dim3 grid() const {
    return dim3(static_cast<unsigned>(cblocks), static_cast<unsigned>(nslabs),
                static_cast<unsigned>(N));
  }
  dim3 block() const { return dim3(static_cast<unsigned>(tx), static_cast<unsigned>(kThreads / tx)); }
};

struct Call {
  const void *u, *dy, *z, *dg;
  void *out, *a, *g, *dz, *part;
  int* tickets;
};

template <typename T, typename A = typename AccOf<T>::type>
Args<A> make_args(const Geometry& geo, const Call& k) {
  Args<A> g = {};
  g.u = k.u;
  g.dy = k.dy;
  g.out = k.out;
  g.z = static_cast<const A*>(k.z);
  g.a = static_cast<A*>(k.a);
  g.g = static_cast<A*>(k.g);
  g.dg = static_cast<const A*>(k.dg);
  g.dz = static_cast<A*>(k.dz);
  g.part = static_cast<A*>(k.part);
  g.tickets = k.tickets;
  g.P = geo.P;
  g.rows_per_slab = geo.rows_per_slab;
  g.C = static_cast<int>(geo.C);
  g.nslabs = static_cast<int>(geo.nslabs);
  g.inv_p = static_cast<A>(1.0 / static_cast<double>(geo.P));
  return g;
}

enum Kernel { kGap, kCombine, kBwdReduce, kDx };

template <typename T, int VEC>
int launch(Kernel which, const Geometry& geo, const Call& k, cudaStream_t s) {
  const auto g = make_args<T>(geo, k);
  switch (which) {
    case kGap: splat_gap_kernel<T, VEC><<<geo.grid(), geo.block(), 0, s>>>(g); break;
    case kCombine: splat_combine_kernel<T, VEC><<<geo.grid(), geo.block(), 0, s>>>(g); break;
    case kBwdReduce: splat_bwd_reduce_kernel<T, VEC><<<geo.grid(), geo.block(), 0, s>>>(g); break;
    case kDx: splat_dx_kernel<T, VEC><<<geo.grid(), geo.block(), 0, s>>>(g); break;
  }
  return cudaGetLastError();
}

int dispatch(Kernel which, const long long* geometry, const Call& k, void* stream) {
  const Geometry& geo = *reinterpret_cast<const Geometry*>(geometry);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (geo.type) {
    case 1: return launch<__nv_bfloat16, 8>(which, geo, k, s);
    case 2: return launch<double, 2>(which, geo, k, s);
    default: return launch<float, 4>(which, geo, k, s);
  }
}

}  // namespace

extern "C" {

// Each launches one kernel on `stream` and returns cudaGetLastError() (0
// on success).  `geometry` (host memory, 8 int64: see Geometry) describes
// u and du as (N, P, 2C) and out and dy as (N, P, C), row-major
// (channels_last), f32, bf16 or f64 (type), 16-byte aligned, C a multiple
// of 16 bytes' values; the grid is (cblocks, nslabs, N) CTAs of (tx,
// 256/tx) threads, slab s holding rows [s*rows_per_slab,
// (s+1)*rows_per_slab) of an image's P, and cblocks * tx covers C's
// 16-byte channel groups.  z, a, g, dg, dz and the 2 * N * nslabs * C
// partials of `part` are f32 (f64 for f64 x).
// `tickets` holds N * cblocks ints, 0 on entry and on return.  All
// pointers are device pointers; nothing is allocated here.

// g = mean over the pixels of u_0 + u_1.
int zs3_splat_gap(const long long* geometry, const void* u, void* g, void* part, int* tickets,
                  void* stream) {
  Call k = {};
  k.u = u;
  k.g = g;
  k.part = part;
  k.tickets = tickets;
  return dispatch(kGap, geometry, k, stream);
}

// a = softmax over r of z, out = a_0 * u_0 + a_1 * u_1.
int zs3_splat_combine(const long long* geometry, const void* u, const void* z, void* out,
                      void* a, void* stream) {
  Call k = {};
  k.u = u;
  k.z = z;
  k.out = out;
  k.a = a;
  return dispatch(kCombine, geometry, k, stream);
}

// dz = the softmax's backward of da_r = sum over the pixels of dy * u_r.
int zs3_splat_bwd_reduce(const long long* geometry, const void* dy, const void* u,
                         const void* a, void* dz, void* part, int* tickets, void* stream) {
  Call k = {};
  k.dy = dy;
  k.u = u;
  k.a = const_cast<void*>(a);
  k.dz = dz;
  k.part = part;
  k.tickets = tickets;
  return dispatch(kBwdReduce, geometry, k, stream);
}

// du_r = a_r * dy + dg / P.
int zs3_splat_dx(const long long* geometry, const void* dy, const void* a, const void* dg,
                 void* du, void* stream) {
  Call k = {};
  k.dy = dy;
  k.a = const_cast<void*>(a);
  k.dg = dg;
  k.out = du;
  return dispatch(kDx, geometry, k, stream);
}

const char* zs3_splat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
