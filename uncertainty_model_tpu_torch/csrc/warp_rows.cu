// Horizontal stereo warp of NHWC rows and its gradient, for Hopper (sm_90a).
//
// Replaces the TPU kernels uncertainty_model_tpu/ops/pallas/warp.py
// ::_fwd_kernel (launched by _warp_rows_fwd_impl) and ::_bwd_kernel
// (launched by _warp_rows_bwd, the custom VJP of warp_rows).  For rows r,
// output columns j, source columns k and channels c:
//
//   out[r, j, c] = sum_k max(0, 1 - |x[r, j] - k|) * src[r, k, c]
//
// i.e. a 2-tap lerp at x0 = floor(x) (weight 1 - t) and x0 + 1 (weight t),
// t = x - x0, where a tap outside [0, W) contributes zero (grid_sample's
// zeros padding).  The gradient:
//
//   dsrc[r, k, c] = sum_j M[j, k] * dout[r, j, c]           (M^T dout)
//   dx[r, j]      = sum_c dout[r, j, c] * (tap(x0 + 1) - tap(x0))[c]
//
// which is the gather form's own derivative: the slope is +1 at floor + 1
// and -1 at floor on the half-open window (x - 1, x + 1], integer x
// included.  x is in pixel units; the chain from the disparity stays in
// autograd.  Everything is f32; src, dout, out and dsrc are contiguous
// (R, W, C), x and dx contiguous (R, W).
//
// What bounds it: bytes.  The forward reads x and src and writes out once:
// 4 * (2C + 1) bytes per (row, column); the backward reads x, src and dout
// and writes dsrc and dx: 4 * (3C + 2).  The arithmetic (a few flops per
// channel) is far below the card's f32 rate.
//
// Design.  The TPU kernels build a (W, W) one-hot matrix and contract it
// on the MXU, only to avoid XLA's scatter; here a gather and a scatter are
// cheap, so the design is direct:
// - forward: one thread per output pixel; two gathers of C channels from
//   the row, which the row's neighbouring threads share through L1;
// - backward: one block per row.  The row's dsrc (W * C floats, 8 KB at
//   the flagship's widest row) accumulates in shared memory with shared
//   atomics and is written to device memory once; no global atomics.  dx
//   is a per-pixel gather.  The shared atomics make dsrc's summation order
//   vary from run to run (a tap receives only the few pixels that sample
//   next to it), so dsrc is not bitwise reproducible; dx and out are.
// Each product and sum is rounded separately (__fmul_rn/__fadd_rn, no FMA
// contraction), so out and dx follow the plain PyTorch version's
// arithmetic.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

struct Taps {
  int x0, x1;    // clamped source columns
  float w0, w1;  // their weights, 0 where the tap is outside [0, W)
  bool v0, v1;
};

__device__ __forceinline__ Taps taps(float x, int W) {
  const float x0f = floorf(x);
  const float t = __fsub_rn(x, x0f);
  Taps k;
  // compare in float: x may be far outside int range
  k.v0 = x0f >= 0.f && x0f <= (float)(W - 1);
  k.v1 = x0f >= -1.f && x0f <= (float)(W - 2);
  k.x0 = k.v0 ? (int)x0f : 0;
  k.x1 = k.v1 ? (int)x0f + 1 : 0;
  k.w0 = __fsub_rn(1.f, t);
  k.w1 = t;
  return k;
}

template <int kC>
__global__ void __launch_bounds__(kThreads)
warp_rows_fwd(const float* __restrict__ x, const float* __restrict__ src,
              float* __restrict__ out, long long pixels, int W, int Crt) {
  const int C = kC > 0 ? kC : Crt;
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= pixels) return;
  const long long r = p / W;
  const Taps k = taps(x[p], W);
  const float* row = src + r * W * C;
  float* o = out + p * C;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const float a = k.v0 ? row[(size_t)k.x0 * C + c] : 0.f;
    const float b = k.v1 ? row[(size_t)k.x1 * C + c] : 0.f;
    o[c] = __fadd_rn(__fmul_rn(a, k.w0), __fmul_rn(b, k.w1));
  }
}

template <int kC>
__global__ void __launch_bounds__(kThreads)
warp_rows_bwd(const float* __restrict__ x, const float* __restrict__ src,
              const float* __restrict__ dout, float* __restrict__ dsrc,
              float* __restrict__ dx, int W, int Crt) {
  extern __shared__ float acc[];  // (W, C) of this row
  const int C = kC > 0 ? kC : Crt;
  const int n = W * C;
  const size_t r = blockIdx.x;
  for (int i = threadIdx.x; i < n; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  const float* xr = x + r * W;
  const float* row = src + r * n;
  const float* g = dout + r * n;
  for (int j = threadIdx.x; j < W; j += kThreads) {
    const Taps k = taps(xr[j], W);
    float slope = 0.f;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const float gc = g[(size_t)j * C + c];
      const float a = k.v0 ? row[(size_t)k.x0 * C + c] : 0.f;
      const float b = k.v1 ? row[(size_t)k.x1 * C + c] : 0.f;
      slope = __fadd_rn(slope, __fmul_rn(gc, __fsub_rn(b, a)));
      if (k.v0) atomicAdd(&acc[k.x0 * C + c], __fmul_rn(k.w0, gc));
      if (k.v1) atomicAdd(&acc[k.x1 * C + c], __fmul_rn(k.w1, gc));
    }
    dx[r * W + j] = slope;
  }
  __syncthreads();
  float* d = dsrc + r * n;
  for (int i = threadIdx.x; i < n; i += kThreads) d[i] = acc[i];
}

template <int kC>
cudaError_t launch_fwd(const float* x, const float* src, float* out, int R,
                       int W, int C, cudaStream_t stream) {
  const long long pixels = (long long)R * W;
  const unsigned blocks = (unsigned)((pixels + kThreads - 1) / kThreads);
  warp_rows_fwd<kC><<<blocks, kThreads, 0, stream>>>(x, src, out, pixels, W,
                                                     C);
  return cudaGetLastError();
}

template <int kC>
cudaError_t launch_bwd(const float* x, const float* src, const float* dout,
                       float* dsrc, float* dx, int R, int W, int C,
                       cudaStream_t stream) {
  const size_t smem = (size_t)W * C * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        warp_rows_bwd<kC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  warp_rows_bwd<kC><<<R, kThreads, smem, stream>>>(x, src, dout, dsrc, dx, W,
                                                   C);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success).  Preconditions
// (checked by the Python wrapper): R, W, C >= 1, f32 contiguous tensors on
// one device; for the backward W * C * 4 bytes fit in a block's shared
// memory (232,448 bytes).
extern "C" int umt_warp_rows_fwd(const void* x, const void* src, void* out,
                                 int R, int W, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* sf = static_cast<const float*>(src);
  float* of = static_cast<float*>(out);
  switch (C) {
    case 1: return launch_fwd<1>(xf, sf, of, R, W, C, s);
    case 4: return launch_fwd<4>(xf, sf, of, R, W, C, s);
    default: return launch_fwd<0>(xf, sf, of, R, W, C, s);
  }
}

extern "C" int umt_warp_rows_bwd(const void* x, const void* src,
                                 const void* dout, void* dsrc, void* dx,
                                 int R, int W, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* sf = static_cast<const float*>(src);
  const float* gf = static_cast<const float*>(dout);
  float* df = static_cast<float*>(dsrc);
  float* dxf = static_cast<float*>(dx);
  switch (C) {
    case 1: return launch_bwd<1>(xf, sf, gf, df, dxf, R, W, C, s);
    case 4: return launch_bwd<4>(xf, sf, gf, df, dxf, R, W, C, s);
    default: return launch_bwd<0>(xf, sf, gf, df, dxf, R, W, C, s);
  }
}
