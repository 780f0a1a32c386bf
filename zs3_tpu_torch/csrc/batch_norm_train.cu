// Train-mode BatchNorm, with the ReLU that reads it and the update of the
// running statistics folded in, for sm_90a.
//
// Replaces no TPU kernel: zs3_tpu's BatchNorm is flax's nn.BatchNorm,
// which XLA fuses with its neighbours on the TPU.  On the H100 the port
// ran torch's channels_last batch-norm kernels, about half the card's
// bandwidth (a fifth in their statistics pass), then nine small launches
// for the running statistics and a ReLU kernel each way.
//
// x is a channels_last (N, C, H, W) tensor, read as the row-major (R, C)
// matrix of its R = N*H*W pixels; bf16, f32 or f64.  Four kernels, two a
// direction (ops/bn_kernels.py launches them through ctypes):
//
//   bn_fwd_stats   reads x once: the batch mean, biased variance and
//                  1/sqrt(var + eps) per channel, and (update != 0) the
//                  running statistics and num_batches_tracked in place;
//   bn_fwd_apply   reads x, writes y = x*a + b rounded once to x's type,
//                  with a = weight*invstd and b = bias - mean*a (in A),
//                  and max(y, 0) when the call site fuses its ReLU;
//   bn_bwd_reduce  reads dy and x: per channel sum(dz) (the bias's
//                  gradient) and sum(dz*xhat) (the weight's), where dz is
//                  dy, or with the ReLU dy where the rounded y > 0 (y
//                  recomputed from x, so y is never stored for it);
//   bn_bwd_apply   reads dy and x, writes
//                  dx = a*(dz - mean(dz) - xhat*mean(dz*xhat)).
//
// Bound, by bytes: 8 passes over the BN tensor in all (1 + 2 + 2 + 3),
// where torch's kernels with a separate ReLU take 13.  The arithmetic is
// a few operations an element, far below the card's ridge, so the
// design is only about moving the bytes at the full rate.
//
// The design.  A thread owns VEC adjacent channels (16 bytes: 8 bf16, 4
// f32 or 2 f64; C a multiple of VEC, every tensor 16-byte aligned) and
// walks rows, accumulating in A (f32 for bf16 and f32 x, f64 for f64 x,
// which is also the type of the per-channel parameters, statistics and
// gradients); a CTA of 256 threads is TX channel groups by TY = 256/TX
// rows, over one block of TX*VEC channels and one slab of rows.  The host
// (ops/bn_kernels.py::plan) sizes the grid, (channel blocks, slabs), to
// three CTAs a streaming multiprocessor and each thread's loads to four
// (forward) or two pairs (backward) of 16-byte rows in flight.
//
// Reductions are deterministic and use no float atomics.  Each thread
// keeps (count, mean, M2) per channel, folding in four rows at a time by
// Chan's merge (not E[x^2] - E[x]^2, which cancels where |mean| >> std);
// the CTA merges its threads in a fixed tree (shuffles, then its warps
// in order) and writes one partial per channel; the last CTA of a
// channel block to arrive (an integer ticket) merges the slabs' partials
// in slab order, whoever arrived last, and resets its ticket counter for
// the next launch.  The backward's sums go the same way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;             // CTAs an SM (the plan's CTAS_PER_SM)
constexpr int kUnrollFwd = 4;             // rows of x a thread loads at once
constexpr int kUnrollBwd = 2;             // rows of dy and x a thread loads at once
constexpr int kPartBatch = 2;             // slab partials a thread of the last CTA loads at once

// The type x's values accumulate in, and the per-channel values' type.
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
  const void* x;   // (R, C)
  const void* dy;  // (R, C), the backward's
  void* out;       // y (forward) or dx (backward), (R, C)
  long long R;
  int C;
  long long rows_per_slab;
  int nslabs;
  A* part;         // (2, nslabs, C) partials
  int* tickets;    // one per channel block, 0 between launches
  A* stats;        // (3, C): mean, invstd, biased var
  const A* weight;
  const A* bias;
  A* grads;        // (2, C): the weight's and the bias's gradients
  A* running_mean;
  A* running_var;
  long long* num_batches_tracked;
  A keep, momentum, eps, inv_n;
  int update, relu, need_dx;
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

// 16 bytes of a slab partial, written by other CTAs: through L2.
__device__ __forceinline__ void load16_cg(const float* p, float* v) {
  const float4 u = __ldcg(reinterpret_cast<const float4*>(p));
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}
__device__ __forceinline__ void load16_cg(const double* p, double* v) {
  const double2 u = __ldcg(reinterpret_cast<const double2*>(p));
  v[0] = u.x;
  v[1] = u.y;
}

// VEC values of a slab partial.
template <typename A, int VEC>
__device__ __forceinline__ void load_partial(const A* p, A (&v)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; i += 16 / sizeof(A)) load16_cg(p + i, v + i);
}

// Rounded arithmetic of A, as the intrinsics name it.
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float max0(float v) { return fmaxf(v, 0.f); }
__device__ __forceinline__ double max0(double v) { return fmax(v, 0.0); }
__device__ __forceinline__ float root(float v) { return sqrtf(v); }
__device__ __forceinline__ double root(double v) { return sqrt(v); }

// v as stored in T, back in A: the value the ReLU's mask reads.
__device__ __forceinline__ float stored(float v, const float*) { return v; }
__device__ __forceinline__ float stored(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ double stored(double v, const double*) { return v; }

// y = x*a + b: a = weight*invstd, b = bias - mean*a.  Every kernel that
// needs y (the forward's store, the backward's mask) forms it here, so
// the mask is the stored output's sign bit for bit.
template <typename A>
__device__ __forceinline__ void affine(A mean, A invstd, A w, A b, A& a, A& c) {
  a = mul_rn(w, invstd);
  c = fma_rn(-mean, a, b);
}

template <typename A>
__device__ __forceinline__ A relu(A v) {
  return v <= A(0) ? A(0) : v;
}

// Chan's merge of (nb, mb, m2b) into (n, mean, m2), every channel of a
// thread at once (one count for them all).
template <typename A, int VEC>
__device__ __forceinline__ void merge(A& n, A (&mean)[VEC], A (&m2)[VEC], A nb,
                                      const A (&mb)[VEC], const A (&m2b)[VEC]) {
  const A total = n + nb;
  if (total == A(0)) return;
  const A f = nb / total;
  const A g = n * f;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const A d = mb[v] - mean[v];
    mean[v] = fma_rn(d, f, mean[v]);
    m2[v] = m2[v] + m2b[v] + d * (d * g);
  }
  n = total;
}

__device__ __forceinline__ int thread_id() { return threadIdx.y * blockDim.x + threadIdx.x; }

// The CTA's (n, mean, m2) per channel, merged in a fixed order: within a
// warp down the lanes that share the channel group (offsets 16 .. TX),
// then warp 0 takes the warps in order.  The result is in the threads of
// warp 0 whose lane < TX (thread (tx, 0), tx < TX); all threads call it.
template <typename A, int VEC>
__device__ void block_moments(A& n, A (&mean)[VEC], A (&m2)[VEC]) {
  __shared__ A s_n[kWarps][32];
  __shared__ A s_mean[kWarps][32 * VEC];
  __shared__ A s_m2[kWarps][32 * VEC];
  const int TX = blockDim.x;
  for (int off = 16; off >= TX; off >>= 1) {
    const A nb = __shfl_down_sync(0xffffffffu, n, off);
    A mb[VEC], m2b[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      mb[v] = __shfl_down_sync(0xffffffffu, mean[v], off);
      m2b[v] = __shfl_down_sync(0xffffffffu, m2[v], off);
    }
    merge<A, VEC>(n, mean, m2, nb, mb, m2b);
  }
  const int tid = thread_id(), warp = tid / 32, lane = tid % 32;
  if (lane < TX) {
    s_n[warp][lane] = n;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      s_mean[warp][lane * VEC + v] = mean[v];
      s_m2[warp][lane * VEC + v] = m2[v];
    }
  }
  __syncthreads();
  if (warp == 0 && lane < TX) {
    for (int w = 1; w < kWarps; ++w) {
      A mb[VEC], m2b[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        mb[v] = s_mean[w][lane * VEC + v];
        m2b[v] = s_m2[w][lane * VEC + v];
      }
      merge<A, VEC>(n, mean, m2, s_n[w][lane], mb, m2b);
    }
  }
  __syncthreads();
}

// The CTA's sums per channel (two per channel), in the same fixed order.
template <typename A, int VEC>
__device__ void block_sums(A (&s1)[VEC], A (&s2)[VEC]) {
  __shared__ A s_a[kWarps][32 * VEC];
  __shared__ A s_b[kWarps][32 * VEC];
  const int TX = blockDim.x;
  for (int off = 16; off >= TX; off >>= 1) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      s1[v] += __shfl_down_sync(0xffffffffu, s1[v], off);
      s2[v] += __shfl_down_sync(0xffffffffu, s2[v], off);
    }
  }
  const int tid = thread_id(), warp = tid / 32, lane = tid % 32;
  if (lane < TX) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      s_a[warp][lane * VEC + v] = s1[v];
      s_b[warp][lane * VEC + v] = s2[v];
    }
  }
  __syncthreads();
  if (warp == 0 && lane < TX) {
    for (int w = 1; w < kWarps; ++w) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        s1[v] += s_a[w][lane * VEC + v];
        s2[v] += s_b[w][lane * VEC + v];
      }
    }
  }
  __syncthreads();
}

// After each thread of warp 0 (lane < TX) wrote this CTA's partial: true
// in every thread of the CTA that arrived last in its channel block, which
// then reads every partial of the block (through L2) and resets the ticket.
__device__ bool arrived_last(int* ticket, int nslabs) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (thread_id() == 0) s_last = atomicAdd(ticket, 1) == nslabs - 1;
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

template <typename A>
__device__ __forceinline__ long long slab_rows(const Args<A>& g, int slab) {
  const long long first = slab * g.rows_per_slab;
  return min(g.R, first + g.rows_per_slab) - first;
}

template <typename T, int VEC, typename A = typename AccOf<T>::type>
__global__ void __launch_bounds__(kThreads, kMinBlocks) bn_fwd_stats_kernel(Args<A> g) {
  const int TX = blockDim.x, TY = blockDim.y, tx = threadIdx.x, ty = threadIdx.y;
  const int C = g.C, c0 = (blockIdx.x * TX + tx) * VEC, slab = blockIdx.y;
  const bool active = c0 < C;
  const long long begin = slab * g.rows_per_slab;
  const long long end = begin + slab_rows(g, slab);
  A n = 0, mean[VEC], m2[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) mean[v] = m2[v] = 0;
  if (active) {
    const T* x = static_cast<const T*>(g.x) + c0;
    long long r = begin + ty;
    for (; r + (kUnrollFwd - 1) * TY < end; r += kUnrollFwd * TY) {
      A x4[kUnrollFwd][VEC];
#pragma unroll
      for (int u = 0; u < kUnrollFwd; ++u) Vec<T, VEC>::load(x + (r + u * TY) * C, x4[u]);
      A cm[VEC], cm2[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        A s = 0;
#pragma unroll
        for (int u = 0; u < kUnrollFwd; ++u) s += x4[u][v];
        const A m = s * (A(1) / kUnrollFwd);
        A q = 0;
#pragma unroll
        for (int u = 0; u < kUnrollFwd; ++u) {
          const A d = x4[u][v] - m;
          q = fma_rn(d, d, q);
        }
        cm[v] = m;
        cm2[v] = q;
      }
      merge<A, VEC>(n, mean, m2, A(kUnrollFwd), cm, cm2);
    }
    for (; r < end; r += TY) {
      A x1[VEC], zero[VEC];
      Vec<T, VEC>::load(x + r * C, x1);
#pragma unroll
      for (int v = 0; v < VEC; ++v) zero[v] = 0;
      merge<A, VEC>(n, mean, m2, A(1), x1, zero);
    }
  }
  block_moments<A, VEC>(n, mean, m2);
  const bool writer = thread_id() < TX && active;  // thread (tx, 0)
  A* part_mean = g.part;
  A* part_m2 = g.part + static_cast<long long>(g.nslabs) * C;
  if (writer) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      part_mean[static_cast<long long>(slab) * C + c0 + v] = mean[v];
      part_m2[static_cast<long long>(slab) * C + c0 + v] = m2[v];
    }
  }
  if (!arrived_last(g.tickets + blockIdx.x, g.nslabs)) return;

  n = 0;
#pragma unroll
  for (int v = 0; v < VEC; ++v) mean[v] = m2[v] = 0;
  if (active) {
    for (int s0 = ty; s0 < g.nslabs; s0 += kPartBatch * TY) {
      A mb[kPartBatch][VEC], m2b[kPartBatch][VEC];
#pragma unroll
      for (int u = 0; u < kPartBatch; ++u) {
        const long long at = static_cast<long long>(s0 + u * TY) * C + c0;
        if (s0 + u * TY < g.nslabs) {
          load_partial<A, VEC>(part_mean + at, mb[u]);
          load_partial<A, VEC>(part_m2 + at, m2b[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kPartBatch; ++u) {
        const int s = s0 + u * TY;
        if (s < g.nslabs) merge<A, VEC>(n, mean, m2, A(slab_rows(g, s)), mb[u], m2b[u]);
      }
    }
  }
  block_moments<A, VEC>(n, mean, m2);
  if (writer) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int c = c0 + v;
      const A var = max0(m2[v] / n);
      g.stats[c] = mean[v];
      g.stats[C + c] = A(1) / root(var + g.eps);
      g.stats[2 * C + c] = var;
      if (g.update) {
        g.running_mean[c] = fma_rn(g.momentum, mean[v], mul_rn(g.running_mean[c], g.keep));
        g.running_var[c] = fma_rn(g.momentum, var, mul_rn(g.running_var[c], g.keep));
      }
    }
  }
  if (thread_id() == 0) {
    g.tickets[blockIdx.x] = 0;
    if (blockIdx.x == 0 && g.update) *g.num_batches_tracked += 1;
  }
}

// The per-channel affine form (a, c) of y = x*a + c for this thread's channels.
template <typename A, int VEC>
__device__ __forceinline__ void load_affine(const Args<A>& g, int c0, A (&a)[VEC], A (&c)[VEC]) {
#pragma unroll
  for (int v = 0; v < VEC; ++v)
    affine(g.stats[c0 + v], g.stats[g.C + c0 + v], g.weight[c0 + v], g.bias[c0 + v], a[v], c[v]);
}

template <typename T, int VEC, typename A = typename AccOf<T>::type>
__global__ void __launch_bounds__(kThreads, kMinBlocks) bn_fwd_apply_kernel(Args<A> g) {
  const int TX = blockDim.x, TY = blockDim.y;
  const int C = g.C, c0 = (blockIdx.x * TX + threadIdx.x) * VEC;
  if (c0 >= C) return;
  const long long begin = blockIdx.y * g.rows_per_slab;
  const long long end = begin + slab_rows(g, blockIdx.y);
  A a[VEC], c[VEC];
  load_affine<A, VEC>(g, c0, a, c);
  const T* x = static_cast<const T*>(g.x) + c0;
  T* y = static_cast<T*>(g.out) + c0;
  long long r = begin + threadIdx.y;
  for (; r + (kUnrollFwd - 1) * TY < end; r += kUnrollFwd * TY) {
    A x4[kUnrollFwd][VEC];
#pragma unroll
    for (int u = 0; u < kUnrollFwd; ++u) Vec<T, VEC>::load(x + (r + u * TY) * C, x4[u]);
#pragma unroll
    for (int u = 0; u < kUnrollFwd; ++u) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const A o = fma_rn(x4[u][v], a[v], c[v]);
        x4[u][v] = g.relu ? relu(o) : o;
      }
      Vec<T, VEC>::store(y + (r + u * TY) * C, x4[u]);
    }
  }
  for (; r < end; r += TY) {
    A x1[VEC];
    Vec<T, VEC>::load(x + r * C, x1);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const A o = fma_rn(x1[v], a[v], c[v]);
      x1[v] = g.relu ? relu(o) : o;
    }
    Vec<T, VEC>::store(y + r * C, x1);
  }
}

// dz: dy, or with the ReLU dy where the stored y = x*a + c is > 0.
template <typename T, typename A>
__device__ __forceinline__ A masked(const Args<A>& g, A dy, A x, A a, A c) {
  return (g.relu && !(stored(fma_rn(x, a, c), static_cast<const T*>(nullptr)) > A(0))) ? A(0)
                                                                                     : dy;
}

template <typename T, int VEC, typename A = typename AccOf<T>::type>
__global__ void __launch_bounds__(kThreads, kMinBlocks) bn_bwd_reduce_kernel(Args<A> g) {
  const int TX = blockDim.x, TY = blockDim.y, tx = threadIdx.x, ty = threadIdx.y;
  const int C = g.C, c0 = (blockIdx.x * TX + tx) * VEC, slab = blockIdx.y;
  const bool active = c0 < C;
  const long long begin = slab * g.rows_per_slab;
  const long long end = begin + slab_rows(g, slab);
  A s1[VEC], s2[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) s1[v] = s2[v] = 0;
  if (active) {
    A mean[VEC], a[VEC], c[VEC];
    load_affine<A, VEC>(g, c0, a, c);
#pragma unroll
    for (int v = 0; v < VEC; ++v) mean[v] = g.stats[c0 + v];
    const T* x = static_cast<const T*>(g.x) + c0;
    const T* dy = static_cast<const T*>(g.dy) + c0;
    long long r = begin + ty;
    for (; r + (kUnrollBwd - 1) * TY < end; r += kUnrollBwd * TY) {
      A x2[kUnrollBwd][VEC], d2[kUnrollBwd][VEC];
#pragma unroll
      for (int u = 0; u < kUnrollBwd; ++u) {
        Vec<T, VEC>::load(x + (r + u * TY) * C, x2[u]);
        Vec<T, VEC>::load(dy + (r + u * TY) * C, d2[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnrollBwd; ++u) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const A dz = masked<T>(g, d2[u][v], x2[u][v], a[v], c[v]);
          s1[v] += dz;
          s2[v] = fma_rn(dz, x2[u][v] - mean[v], s2[v]);
        }
      }
    }
    for (; r < end; r += TY) {
      A x1[VEC], d1[VEC];
      Vec<T, VEC>::load(x + r * C, x1);
      Vec<T, VEC>::load(dy + r * C, d1);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const A dz = masked<T>(g, d1[v], x1[v], a[v], c[v]);
        s1[v] += dz;
        s2[v] = fma_rn(dz, x1[v] - mean[v], s2[v]);
      }
    }
  }
  block_sums<A, VEC>(s1, s2);
  const bool writer = thread_id() < TX && active;
  A* part1 = g.part;
  A* part2 = g.part + static_cast<long long>(g.nslabs) * C;
  if (writer) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      part1[static_cast<long long>(slab) * C + c0 + v] = s1[v];
      part2[static_cast<long long>(slab) * C + c0 + v] = s2[v];
    }
  }
  if (!arrived_last(g.tickets + blockIdx.x, g.nslabs)) return;

#pragma unroll
  for (int v = 0; v < VEC; ++v) s1[v] = s2[v] = 0;
  if (active) {
    for (int s0 = ty; s0 < g.nslabs; s0 += kPartBatch * TY) {
      A a[kPartBatch][VEC], b[kPartBatch][VEC];
#pragma unroll
      for (int u = 0; u < kPartBatch; ++u) {
        const long long at = static_cast<long long>(s0 + u * TY) * C + c0;
        if (s0 + u * TY < g.nslabs) {
          load_partial<A, VEC>(part1 + at, a[u]);
          load_partial<A, VEC>(part2 + at, b[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kPartBatch; ++u) {
        if (s0 + u * TY < g.nslabs) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            s1[v] += a[u][v];
            s2[v] += b[u][v];
          }
        }
      }
    }
  }
  block_sums<A, VEC>(s1, s2);
  if (writer) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      g.grads[c0 + v] = s2[v] * g.stats[C + c0 + v];  // sum(dz * xhat)
      g.grads[C + c0 + v] = s1[v];                    // sum(dz)
    }
  }
  if (thread_id() == 0) g.tickets[blockIdx.x] = 0;
}

template <typename T, int VEC, typename A = typename AccOf<T>::type>
__global__ void __launch_bounds__(kThreads, kMinBlocks) bn_bwd_apply_kernel(Args<A> g) {
  const int TX = blockDim.x, TY = blockDim.y;
  const int C = g.C, c0 = (blockIdx.x * TX + threadIdx.x) * VEC;
  if (c0 >= C) return;
  const long long begin = blockIdx.y * g.rows_per_slab;
  const long long end = begin + slab_rows(g, blockIdx.y);
  // dx = a*(dz - k) - q*(x - mean): k = mean(dz), q = a*invstd*mean(dz*xhat).
  A a[VEC], c[VEC], mean[VEC], k[VEC], q[VEC];
  load_affine<A, VEC>(g, c0, a, c);
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    mean[v] = g.stats[c0 + v];
    k[v] = g.grads[C + c0 + v] * g.inv_n;
    q[v] = a[v] * g.stats[C + c0 + v] * (g.grads[c0 + v] * g.inv_n);
  }
  const T* x = static_cast<const T*>(g.x) + c0;
  const T* dy = static_cast<const T*>(g.dy) + c0;
  T* dx = static_cast<T*>(g.out) + c0;
  long long r = begin + threadIdx.y;
  for (; r + (kUnrollBwd - 1) * TY < end; r += kUnrollBwd * TY) {
    A x2[kUnrollBwd][VEC], d2[kUnrollBwd][VEC];
#pragma unroll
    for (int u = 0; u < kUnrollBwd; ++u) {
      Vec<T, VEC>::load(x + (r + u * TY) * C, x2[u]);
      Vec<T, VEC>::load(dy + (r + u * TY) * C, d2[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnrollBwd; ++u) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const A dz = masked<T>(g, d2[u][v], x2[u][v], a[v], c[v]);
        d2[u][v] = fma_rn(-q[v], x2[u][v] - mean[v], a[v] * (dz - k[v]));
      }
      Vec<T, VEC>::store(dx + (r + u * TY) * C, d2[u]);
    }
  }
  for (; r < end; r += TY) {
    A x1[VEC], d1[VEC];
    Vec<T, VEC>::load(x + r * C, x1);
    Vec<T, VEC>::load(dy + r * C, d1);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const A dz = masked<T>(g, d1[v], x1[v], a[v], c[v]);
      d1[v] = fma_rn(-q[v], x1[v] - mean[v], a[v] * (dz - k[v]));
    }
    Vec<T, VEC>::store(dx + r * C, d1);
  }
}

// The launch geometry the host's plan (ops/bn_kernels.py) hands over, in
// this order: type (0 f32, 1 bf16, 2 f64), R, C, tx, cblocks, nslabs,
// rows_per_slab.
struct Geometry {
  long long type, R, C, tx, cblocks, nslabs, rows_per_slab;
  dim3 grid() const { return dim3(static_cast<unsigned>(cblocks), static_cast<unsigned>(nslabs)); }
  dim3 block() const { return dim3(static_cast<unsigned>(tx), static_cast<unsigned>(kThreads / tx)); }
};

// The C interface's pointers and scalars, typed for x's type T.
struct Call {
  const void *x, *dy;
  void *out, *part;
  int* tickets;
  const void *stats, *weight, *bias;
  void *grads, *running_mean, *running_var;
  long long* num_batches_tracked;
  double keep, momentum, eps;
  int update, relu, need_dx;
};

template <typename T, typename A = typename AccOf<T>::type>
Args<A> make_args(const Geometry& geo, const Call& k) {
  Args<A> g = {};
  g.x = k.x;
  g.dy = k.dy;
  g.out = k.out;
  g.R = geo.R;
  g.C = static_cast<int>(geo.C);
  g.rows_per_slab = geo.rows_per_slab;
  g.nslabs = static_cast<int>(geo.nslabs);
  g.part = static_cast<A*>(k.part);
  g.tickets = k.tickets;
  g.stats = static_cast<A*>(const_cast<void*>(k.stats));
  g.weight = static_cast<const A*>(k.weight);
  g.bias = static_cast<const A*>(k.bias);
  g.grads = static_cast<A*>(k.grads);
  g.running_mean = static_cast<A*>(k.running_mean);
  g.running_var = static_cast<A*>(k.running_var);
  g.num_batches_tracked = k.num_batches_tracked;
  g.keep = static_cast<A>(k.keep);
  g.momentum = static_cast<A>(k.momentum);
  g.eps = static_cast<A>(k.eps);
  g.inv_n = static_cast<A>(1.0 / static_cast<double>(geo.R));
  g.update = k.update;
  g.relu = k.relu;
  g.need_dx = k.need_dx;
  return g;
}

template <typename T, int VEC>
int forward(const Geometry& geo, const Call& k, cudaStream_t s) {
  const auto g = make_args<T>(geo, k);
  bn_fwd_stats_kernel<T, VEC><<<geo.grid(), geo.block(), 0, s>>>(g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bn_fwd_apply_kernel<T, VEC><<<geo.grid(), geo.block(), 0, s>>>(g);
  return cudaGetLastError();
}

template <typename T, int VEC>
int backward(const Geometry& geo, const Call& k, cudaStream_t s) {
  const auto g = make_args<T>(geo, k);
  bn_bwd_reduce_kernel<T, VEC><<<geo.grid(), geo.block(), 0, s>>>(g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !g.need_dx) return e;
  bn_bwd_apply_kernel<T, VEC><<<geo.grid(), geo.block(), 0, s>>>(g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Both launch on `stream` and return cudaGetLastError() (0 on success).
// `geometry` (host memory, 7 int64: see Geometry) describes x, dy, y and
// dx: (R, C) row-major (channels_last), f32, bf16 or f64 (type), 16-byte
// aligned, C a multiple of 16 bytes' values; the grid is (cblocks,
// nslabs) CTAs of (tx, 256/tx) threads, slab s holding rows
// [s*rows_per_slab, (s+1)*rows_per_slab) of R, and cblocks * tx covers
// C's 16-byte channel groups.  The per-channel values (part, stats,
// weight, bias, grads, running_mean, running_var) are f32 for f32 and
// bf16 x, f64 for f64 x.  `part` holds 2 * nslabs * C of them and
// `tickets` cblocks ints, 0 on entry and on return.  `stats` is (3, C):
// mean, invstd, biased variance.  All other pointers are device
// pointers; nothing is allocated here.

// bn_fwd_stats then bn_fwd_apply: y, stats and (update) the running
// statistics and num_batches_tracked (int64), with
// running = running*keep + momentum*batch.
int zs3_bn_forward(const long long* geometry, const void* x, void* y, void* part, int* tickets,
                   void* stats, const void* weight, const void* bias, void* running_mean,
                   void* running_var, long long* num_batches_tracked, double keep,
                   double momentum, double eps, int update, int relu, void* stream) {
  const Geometry& geo = *reinterpret_cast<const Geometry*>(geometry);
  Call k = {};
  k.x = x;
  k.out = y;
  k.part = part;
  k.tickets = tickets;
  k.stats = stats;
  k.weight = weight;
  k.bias = bias;
  k.running_mean = running_mean;
  k.running_var = running_var;
  k.num_batches_tracked = num_batches_tracked;
  k.keep = keep;
  k.momentum = momentum;
  k.eps = eps;
  k.update = update;
  k.relu = relu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (geo.type) {
    case 1: return forward<__nv_bfloat16, 8>(geo, k, s);
    case 2: return forward<double, 2>(geo, k, s);
    default: return forward<float, 4>(geo, k, s);
  }
}

// bn_bwd_reduce, then (need_dx) bn_bwd_apply: grads = (sum(dz*xhat),
// sum(dz)), the weight's and the bias's gradients, and dx.
int zs3_bn_backward(const long long* geometry, const void* dy, const void* x, void* dx,
                    void* part, int* tickets, const void* stats, const void* weight,
                    const void* bias, void* grads, int relu, int need_dx, void* stream) {
  const Geometry& geo = *reinterpret_cast<const Geometry*>(geometry);
  Call k = {};
  k.x = x;
  k.dy = dy;
  k.out = dx;
  k.part = part;
  k.tickets = tickets;
  k.stats = stats;
  k.weight = weight;
  k.bias = bias;
  k.grads = grads;
  k.relu = relu;
  k.need_dx = need_dx;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (geo.type) {
    case 1: return backward<__nv_bfloat16, 8>(geo, k, s);
    case 2: return backward<double, 2>(geo, k, s);
    default: return backward<float, 4>(geo, k, s);
  }
}

const char* zs3_bn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
