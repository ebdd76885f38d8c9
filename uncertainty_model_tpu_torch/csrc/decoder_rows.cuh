// The row kernel of the fused decoder-stage glue, shared by assemble_z
// (assemble_z.cu) and by se_squeeze and the gated assemble
// (decoder_fused.cu).  Each instantiation compiles only its own mode.
//
// One block per (batch, output row).  Threads walk the row's NHWC channels
// contiguously, so loads and stores coalesce; blockDim.x is a multiple of
// Cso, so each thread keeps one z channel for the whole row (its gate and
// its running sum stay in registers).  The half-resolution rows a block
// reads (two skip rows, two disp rows, one xc row) are shared with the
// neighbouring row's block through L2.
//
// The z block is z = elu(se + up2(skip_h) + bias) rounded to the storage
// type, where se is se_fm, or sum_ci fm[ci] * k_fm[ci, c] folded in f32.
// The upsample reads per-shape tap tables from the host (ops/resize.py
// lerp_taps) and rounds each operation on its own, so it is bit-identical
// to the plain PyTorch upsample.  Sums for the SE mean take z as stored,
// per row in a fixed order through shared memory into a (B, H, Cso) f32
// partial; se_mean then sums the partials over H in order: no atomics, the
// result is deterministic.
#pragma once

#include <cstddef>

#include "common.cuh"

namespace umt {

enum RowMode {
  kAssembleZ = 0,      // write [z | xup | disp], sum z
  kSqueeze = 1,        // sum z, write nothing else
  kAssembleGated = 2,  // write [z * gate | xup | disp]
};

// taps: int32 [y_lo(H) | y_hi(H) | x_lo(W) | x_hi(W)]
// fracs: f32 [y_frac(H) | x_frac(W)]
template <typename T, int Mode>
__global__ void decoder_rows(const T* __restrict__ se,
                             const float* __restrict__ kfm,
                             const T* __restrict__ skip,
                             const T* __restrict__ xc,
                             const T* __restrict__ disp,
                             const float* __restrict__ bias,
                             const T* __restrict__ gates,
                             const int* __restrict__ taps,
                             const float* __restrict__ fracs,
                             T* __restrict__ cat, float* __restrict__ partial,
                             int H, int W, int cso, int cu, int cd, int cf) {
  extern __shared__ float red[];
  const int y = blockIdx.x;
  const int b = blockIdx.y;
  const int h2 = H / 2;
  const int w2 = W / 2;
  const int ccat = cso + cu + cd;
  const int y0 = taps[y];
  const int y1 = taps[H + y];
  const float wy = fracs[y];
  const int* x0s = taps + 2 * H;
  const int* x1s = taps + 2 * H + W;
  const float* wxs = fracs + H;
  const size_t row = (size_t)b * H + y;
  T* out = cat + row * W * ccat;

  // z block
  {
    const T* s0 = skip + ((size_t)b * h2 + y0) * w2 * cso;
    const T* s1 = skip + ((size_t)b * h2 + y1) * w2 * cso;
    const int c = threadIdx.x % cso;
    const float bc = bias[c];
    float g = 0.f;
    if (Mode == kAssembleGated) g = Io<T>::load(gates + (size_t)b * cso + c);
    float acc = 0.f;
    for (int t = threadIdx.x; t < W * cso; t += blockDim.x) {
      const int x = t / cso;
      const size_t xa = (size_t)x0s[x] * cso + c;
      const size_t xb = (size_t)x1s[x] * cso + c;
      const float ua = lerp(Io<T>::load(s0 + xa), Io<T>::load(s1 + xa), wy);
      const float ub = lerp(Io<T>::load(s0 + xb), Io<T>::load(s1 + xb), wy);
      const float up = lerp(ua, ub, wxs[x]);
      const size_t pix = row * W + x;
      float f;
      if (cf > 0) {
        const T* fm = se + pix * cf;
        f = __fmul_rn(Io<T>::load(fm), kfm[c]);
        for (int ci = 1; ci < cf; ++ci) {
          f = __fadd_rn(f, __fmul_rn(Io<T>::load(fm + ci), kfm[ci * cso + c]));
        }
      } else {
        f = Io<T>::load(se + pix * cso + c);
      }
      const float z = Io<T>::round(elu(__fadd_rn(__fadd_rn(f, up), bc)));
      if (Mode == kAssembleGated) {
        Io<T>::store(out + (size_t)x * ccat + c, __fmul_rn(z, g));
      } else {
        if (Mode == kAssembleZ) Io<T>::store(out + (size_t)x * ccat + c, z);
        acc += z;
      }
    }
    if (Mode != kAssembleGated) {
      red[threadIdx.x] = acc;
      __syncthreads();
      if (threadIdx.x < cso) {
        float s = 0.f;
        for (int k = threadIdx.x; k < blockDim.x; k += cso) s += red[k];
        partial[row * cso + threadIdx.x] = s;
      }
    }
  }
  if (Mode == kSqueeze) return;

  // upsample block: pixel shuffle of elu(xc), phase-major channels
  {
    const int py = y & 1;
    const T* xr = xc + ((size_t)b * h2 + (y >> 1)) * w2 * 4 * cu;
    for (int t = threadIdx.x; t < W * cu; t += blockDim.x) {
      const int x = t / cu;
      const int c = t - x * cu;
      const float v =
          Io<T>::load(xr + (size_t)(x >> 1) * 4 * cu + (py * 2 + (x & 1)) * cu + c);
      Io<T>::store(out + (size_t)x * ccat + cso + c, elu(v));
    }
  }

  // disparity block: up2(disp_h)
  if (cd > 0) {
    const T* d0 = disp + ((size_t)b * h2 + y0) * w2 * cd;
    const T* d1 = disp + ((size_t)b * h2 + y1) * w2 * cd;
    for (int t = threadIdx.x; t < W * cd; t += blockDim.x) {
      const int x = t / cd;
      const int c = t - x * cd;
      const size_t xa = (size_t)x0s[x] * cd + c;
      const size_t xb = (size_t)x1s[x] * cd + c;
      const float ua = lerp(Io<T>::load(d0 + xa), Io<T>::load(d1 + xa), wy);
      const float ub = lerp(Io<T>::load(d0 + xb), Io<T>::load(d1 + xb), wy);
      Io<T>::store(out + (size_t)x * ccat + cso + cu + c, lerp(ua, ub, wxs[x]));
    }
  }
}

// mean[b, c] = sum over rows y, in order, of partial[b, y, c] / (H * W)
__global__ void se_mean(const float* __restrict__ partial,
                        float* __restrict__ mean, int H, int cso,
                        float pixels) {
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < cso; c += blockDim.x) {
    float s = 0.f;
    for (int y = 0; y < H; ++y) s += partial[((size_t)b * H + y) * cso + c];
    mean[(size_t)b * cso + c] = s / pixels;
  }
}

// threads of a row block: a multiple of cso, about 256
inline int row_threads(int cso) { return cso * (cso < 256 ? 256 / cso : 1); }

// The row kernel, then (for the modes that sum z) the ordered mean.
template <typename T, int Mode>
cudaError_t launch_rows(const void* se, const void* kfm, const void* skip,
                        const void* xc, const void* disp, const void* bias,
                        const void* gates, const void* taps,
                        const void* fracs, void* cat, void* partial,
                        void* mean, int B, int H, int W, int cso, int cu,
                        int cd, int cf, cudaStream_t stream) {
  const int threads = row_threads(cso);
  const dim3 grid(H, B);
  decoder_rows<T, Mode><<<grid, threads, threads * sizeof(float), stream>>>(
      static_cast<const T*>(se), static_cast<const float*>(kfm),
      static_cast<const T*>(skip), static_cast<const T*>(xc),
      static_cast<const T*>(disp), static_cast<const float*>(bias),
      static_cast<const T*>(gates), static_cast<const int*>(taps),
      static_cast<const float*>(fracs), static_cast<T*>(cat),
      static_cast<float*>(partial), H, W, cso, cu, cd, cf);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || Mode == kAssembleGated) return err;
  const int mthreads = cso < 1024 ? ((cso + 31) / 32) * 32 : 1024;
  se_mean<<<B, mthreads, 0, stream>>>(static_cast<const float*>(partial),
                                      static_cast<float*>(mean), H, cso,
                                      (float)H * (float)W);
  return cudaGetLastError();
}

}  // namespace umt
