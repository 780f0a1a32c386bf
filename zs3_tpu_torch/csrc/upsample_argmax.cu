// Fused bilinear upsample + argmax over classes (eval path), for sm_90a.
//
// Replaces the TPU kernel zs3_tpu/ops/pallas_eval.py::_kernel (entered
// through upsample_argmax and predict_labels): for logits (B, HI, WI, C)
// f32 NHWC it writes labels (B, HO, WO) int32 with
//     labels = argmax_c(resize_bilinear(logits, (HO, WO), align_corners))
// where the first maximum wins (strict '>'), as jnp.argmax and the
// Pallas kernel do.
//
// Bound on an H100 SXM: memory.  The function must read the logits once
// and write the labels once, B * (HI*WI*C*4 + HO*WO*4) bytes: 2.45 MB per
// image at 129x129x21 -> 513x513, so about 2.9 us at B=4 and 11.7 us at
// B=16 at 3.35 TB/s.  It does about 6 flops per class per output pixel
// (two taps, each a multiply and an add, plus the compare), far below
// the f32 rate, so bytes bound it.
//
// How the design meets the bound: the full-resolution logits, which the
// plain version materialises (22 MB of f32 per image at 513^2 x 21),
// never reach device memory.  Each row of the interpolation matrix has at
// most two nonzeros, so the host passes compact tap tables (lo, hi,
// w_lo, w_hi) per output row and per output column instead of the dense
// matrices.  One block handles one (image, output row): it blends the
// two source rows lo(o) and hi(o) along H into shared memory (WI*C
// floats, 10.8 KB at the main-path shape; the rows are contiguous, so
// the loads coalesce, and neighbouring output rows share source rows in
// L2), then its threads run over output columns, blend along W per class
// (H first, then W, the order of the JAX package) and keep a running
// argmax in registers.  Products and sums use __fmul_rn/__fadd_rn so the
// compiler cannot contract them into FMAs: each tap is
// fl(fl(w_lo*a) + fl(w_hi*b)) whatever the compiler does; a dense
// product that fuses may differ from it by an ulp, which can flip a
// near-tie between two classes and nothing else.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float blend(float wa, float a, float wb, float b) {
  return __fadd_rn(__fmul_rn(wa, a), __fmul_rn(wb, b));
}

__global__ void __launch_bounds__(kThreads)
upsample_argmax_kernel(const float* __restrict__ logits, int HI, int WI, int C,
                       const int* __restrict__ h_idx,
                       const float* __restrict__ h_w, int HO,
                       const int* __restrict__ w_idx,
                       const float* __restrict__ w_w, int WO,
                       int* __restrict__ out) {
  extern __shared__ float row[];  // (WI, C): source rows blended along H
  const long long blk = blockIdx.x;
  const int o = static_cast<int>(blk % HO);
  const long long b = blk / HO;
  const int n = WI * C;
  const float* image = logits + b * static_cast<long long>(HI) * n;
  const float* row_lo = image + static_cast<long long>(h_idx[o]) * n;
  const float* row_hi = image + static_cast<long long>(h_idx[HO + o]) * n;
  const float wh_lo = h_w[o];
  const float wh_hi = h_w[HO + o];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    row[i] = blend(wh_lo, row_lo[i], wh_hi, row_hi[i]);
  }
  __syncthreads();

  int* dst = out + (b * HO + o) * static_cast<long long>(WO);
  for (int j = threadIdx.x; j < WO; j += blockDim.x) {
    const float* a = row + w_idx[j] * C;
    const float* c = row + w_idx[WO + j] * C;
    const float wa = w_w[j];
    const float wc = w_w[WO + j];
    float best = blend(wa, a[0], wc, c[0]);
    int arg = 0;
    for (int k = 1; k < C; ++k) {
      const float v = blend(wa, a[k], wc, c[k]);
      if (v > best) {  // strict: the first maximum wins
        best = v;
        arg = k;
      }
    }
    dst[j] = arg;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// h_idx/h_w hold HO lo entries then HO hi entries; w_idx/w_w likewise
// for WO.  All pointers are device pointers; nothing is allocated here.
int zs3_upsample_argmax(const float* logits, int B, int HI, int WI, int C,
                        const int* h_idx, const float* h_w, int HO,
                        const int* w_idx, const float* w_w, int WO,
                        int* out, void* stream) {
  const size_t smem = static_cast<size_t>(WI) * C * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        upsample_argmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned int blocks = static_cast<unsigned int>(
      static_cast<long long>(B) * HO);
  upsample_argmax_kernel<<<blocks, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      logits, HI, WI, C, h_idx, h_w, HO, w_idx, w_w, WO, out);
  return static_cast<int>(cudaGetLastError());
}

const char* zs3_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
