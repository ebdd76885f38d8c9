// Fused decoder-stage glue of the serving forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel uncertainty_model_tpu/ops/pallas/decoder_fused.py
// ::_assemble_z_pallas (body _assemble_z_kernel).  For one fused decoder
// stage it writes, in one pass over the data, the concat tensor
//
//   cat  = [ elu(se + up2(skip_h) + bias) | pixel_shuffle(elu(xc)) | up2(disp_h) ]
//   mean = mean over pixels of the first (z) block, f32, per (batch, channel)
//
// where se is se_fm, or sum_ci fm[ci] * k_fm[ci, c] folded in f32 when the
// stage's feature map is narrow (the 3-channel image at full resolution),
// up2 is the exact align-corners 2x bilinear upsample and xc carries
// phase-major channels ((2*(y&1) + (x&1)) * Cu + c).  All tensors are NHWC
// and contiguous; arithmetic is f32 whatever the storage type.
//
// What bounds it: bytes.  Per image at the flagship's shapes in bf16 it
// reads se_fm (or the image), skip_h, xc and disp_h once and writes cat
// once: 5.85 MB at dec2 (64x128, Cso 128, Cu 32), 11.86 MB at dec3
// (128x256, Cso 64, Cu 16), 16.78 MB at dec4 (256x512, Cso 32, Cu 8, fold
// cf=3) — 34.5 MB, about 1.32 ms for the three launches at batch 128 at
// 3.35 TB/s.  The arithmetic (three lerps and an expm1 per z element) is
// far below the card's f32 rate.
//
// Design: one block per (batch, output row).  Threads walk the row's NHWC
// channels contiguously, so loads and stores coalesce; the half-resolution
// rows a block reads (two skip rows, two disp rows, one xc row) are shared
// with the neighbouring row's block through L2.  The TPU design (batch in
// lanes, tens-of-MB VMEM blocks) does not carry over.
//
// The upsample reads per-shape tap tables from the host (ops/resize.py
// lerp_taps, the _lerp_coeffs fractions), and each lerp is a + w * (b - a)
// with separately rounded operations (__fsub_rn/__fmul_rn/__fadd_rn, no FMA
// contraction), so it is bit-identical to the plain PyTorch upsample.
//
// The SE mean uses no atomics: each block sums its row per channel in
// registers and then in shared memory in a fixed order and writes a
// (B, H, Cso) f32 partial; a second small kernel sums the partials over H
// in order.  The result is deterministic.  The summed values are z as
// stored (rounded to the output type), as in the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

__device__ __forceinline__ float lerp(float a, float b, float w) {
  return __fadd_rn(a, __fmul_rn(w, __fsub_rn(b, a)));
}

__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : expm1f(v);
}

// taps: int32 [y_lo(H) | y_hi(H) | x_lo(W) | x_hi(W)]
// fracs: f32 [y_frac(H) | x_frac(W)]
template <typename T>
__global__ void assemble_z_rows(const T* __restrict__ se,
                                const float* __restrict__ kfm,
                                const T* __restrict__ skip,
                                const T* __restrict__ xc,
                                const T* __restrict__ disp,
                                const float* __restrict__ bias,
                                const int* __restrict__ taps,
                                const float* __restrict__ fracs,
                                T* __restrict__ cat,
                                float* __restrict__ partial,
                                int H, int W, int cso, int cu, int cd,
                                int cf) {
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

  // z block: blockDim.x is a multiple of cso, so each thread keeps one
  // channel for the whole row and its running sum stays in a register
  {
    const T* s0 = skip + ((size_t)b * h2 + y0) * w2 * cso;
    const T* s1 = skip + ((size_t)b * h2 + y1) * w2 * cso;
    const int c = threadIdx.x % cso;
    const float bc = bias[c];
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
      Io<T>::store(out + (size_t)x * ccat + c, z);
      acc += z;
    }
    red[threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.x < cso) {
      float s = 0.f;
      for (int k = threadIdx.x; k < blockDim.x; k += cso) s += red[k];
      partial[row * cso + threadIdx.x] = s;
    }
  }

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

template <typename T>
cudaError_t launch(const void* se, const void* kfm, const void* skip,
                   const void* xc, const void* disp, const void* bias,
                   const void* taps, const void* fracs, void* cat,
                   void* partial, void* mean, int B, int H, int W, int cso,
                   int cu, int cd, int cf, cudaStream_t stream) {
  const int per = cso < 256 ? 256 / cso : 1;
  const int threads = cso * per;
  const dim3 grid(H, B);
  assemble_z_rows<T><<<grid, threads, threads * sizeof(float), stream>>>(
      static_cast<const T*>(se), static_cast<const float*>(kfm),
      static_cast<const T*>(skip), static_cast<const T*>(xc),
      static_cast<const T*>(disp), static_cast<const float*>(bias),
      static_cast<const int*>(taps), static_cast<const float*>(fracs),
      static_cast<T*>(cat), static_cast<float*>(partial), H, W, cso, cu, cd,
      cf);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int mthreads = cso < 1024 ? ((cso + 31) / 32) * 32 : 1024;
  se_mean<<<B, mthreads, 0, stream>>>(static_cast<const float*>(partial),
                                      static_cast<float*>(mean), H, cso,
                                      (float)H * (float)W);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  cf > 0 selects the in-kernel fold
// (se is then the raw (B, H, W, cf) feature map and kfm is (cf, cso) f32);
// cd == 0 means no disparity input.  Returns the CUDA error code of the
// launches (0 on success).  Preconditions (checked by the Python wrapper):
// H and W even, 1 <= cso <= 1024, every pointer on one device.
extern "C" int umt_assemble_z(int dtype, const void* se, const void* kfm,
                              const void* skip, const void* xc,
                              const void* disp, const void* bias,
                              const void* taps, const void* fracs, void* cat,
                              void* partial, void* mean, int B, int H, int W,
                              int cso, int cu, int cd, int cf, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(se, kfm, skip, xc, disp, bias, taps, fracs, cat,
                         partial, mean, B, H, W, cso, cu, cd, cf, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(se, kfm, skip, xc, disp, bias, taps, fracs,
                                 cat, partial, mean, B, H, W, cso, cu, cd, cf,
                                 s);
  }
  return cudaErrorInvalidValue;
}
