// The input of a reflect-padded 3x3 conv, written once, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package pads with jnp.pad inside its
// _reflect_conv and leaves the copy to XLA.  It was added to replace the
// port's index gather (ops/pad.py::reflect_pad2d, an advanced-index read
// of every element through two index tensors) in the serving decoder, and
// with it two more passes over the same tensors: the SE gate multiply of
// the fused stages' iconv input, and cuDNN's copy of an NHWC input whose
// channel count is not a multiple of 8 into a channel-padded buffer.
//
//   out[b, r, j, c] = x[b, reflect(r - 1, H), reflect(j - 1, W), c]
//                     (* scale[b, c])                    for c < C
//   out[b, r, j, c] = 0                                  for C <= c < Cp
//
// with x (B, H, W, C) and out (B, H + 2, W + 2, Cp) NHWC, Cp a multiple of
// 8 (16 bytes of bf16), and reflect numpy's rule for a pad of 1: -1 -> 1,
// n -> n - 2, and a size-1 dimension repeats its one index.  The product
// is the f32 product rounded once to the storage type, as PyTorch
// multiplies two bf16 (or two f32) tensors, so the output equals the plain
// version (ops/pad.py::reflect_pad_plain) bit for bit.
//
// What bounds it: bytes.  It reads B H W C elements (and B C of scale) and
// writes B (H + 2) (W + 2) Cp: at the flagship's dec4 iconv input in bf16
// at b128, (128, 256, 512, 44) -> (128, 258, 514, 48), 1.48 + 1.63 GB,
// 0.93 ms at 3.35 TB/s.
//
// Design: one block a padded output row (b, r), its source row chosen by
// the row reflect; its threads walk the row's 16-byte output vectors,
// neighbouring threads on neighbouring vectors, so every store is a whole
// aligned 16-byte vector (Cp % 8 == 0 keeps each output pixel aligned) and
// a warp's stores are one contiguous run.  Each vector's source channels
// are loaded in chunks as wide as C's alignment allows (16 bytes where C
// is a multiple of a vector, 8 bytes at C = 44, 84 or 164 in bf16);
// chunks at or past C are left zero, so the loads of an interior pixel run
// contiguously along the source row.  The column reflect is index
// arithmetic; there are no index tensors.  Each thread forms two vectors
// before it stores either, to keep more loads in flight.  The grid is the
// output's rows, so the same launch serves any batch.

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using umt::Io;

constexpr int kThreads = 256;

template <int kBytes>
struct Bits;
template <>
struct Bits<16> {
  using type = uint4;
};
template <>
struct Bits<8> {
  using type = uint2;
};
template <>
struct Bits<4> {
  using type = unsigned int;
};
template <>
struct Bits<2> {
  using type = unsigned short;
};

// numpy's reflect rule for a pad of 1 on a dimension of n, at i in [-1, n]
__device__ __forceinline__ int reflect1(int i, int n) {
  if (n == 1) return 0;
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// output vector t of the row whose source row is src: channels c0 ..
// c0 + kVec - 1 of output column t / cv
template <typename T, int kLoad, bool kScale>
__device__ __forceinline__ uint4 pad_vector(const T* __restrict__ src,
                                            const T* __restrict__ sc, int t,
                                            int cv, int W, int C) {
  constexpr int kVec = 16 / sizeof(T);
  using Chunk = typename Bits<kLoad * sizeof(T)>::type;
  const int j = t / cv;
  const int c0 = (t - j * cv) * kVec;
  const T* p = src + (size_t)reflect1(j - 1, W) * C;
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int k = 0; k < kVec; k += kLoad) {
    const int c = c0 + k;
    if (c < C) {
      const Chunk raw = *reinterpret_cast<const Chunk*>(p + c);
      const T* v = reinterpret_cast<const T*>(&raw);
      if constexpr (kScale) {
        const Chunk sraw = *reinterpret_cast<const Chunk*>(sc + c);
        const T* s = reinterpret_cast<const T*>(&sraw);
#pragma unroll
        for (int l = 0; l < kLoad; ++l)
          Io<T>::store(e + k + l,
                       __fmul_rn(Io<T>::load(v + l), Io<T>::load(s + l)));
      } else {
#pragma unroll
        for (int l = 0; l < kLoad; ++l) e[k + l] = v[l];
      }
    }
  }
  return u;
}

// x (B, H, W, C), scale (B, C) or null, out (B, H + 2, W + 2, Cp); one
// block a row of out
template <typename T, int kLoad, bool kScale>
__global__ void __launch_bounds__(kThreads)
    reflect_pad_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                       T* __restrict__ out, int H, int W, int C, int Cp) {
  constexpr int kVec = 16 / sizeof(T);
  const int Hp = H + 2;
  const int b = blockIdx.x / Hp;
  const int r = blockIdx.x - b * Hp;
  const int cv = Cp / kVec;
  const int n = (W + 2) * cv;
  const T* src = x + ((size_t)b * H + reflect1(r - 1, H)) * (size_t)W * C;
  const T* sc = kScale ? scale + (size_t)b * C : nullptr;
  uint4* dst = reinterpret_cast<uint4*>(
      out + ((size_t)b * Hp + r) * (size_t)(W + 2) * Cp);
  for (int t = threadIdx.x; t < n; t += 2 * kThreads) {
    const int t2 = t + kThreads;
    const uint4 u = pad_vector<T, kLoad, kScale>(src, sc, t, cv, W, C);
    if (t2 < n) {
      const uint4 u2 = pad_vector<T, kLoad, kScale>(src, sc, t2, cv, W, C);
      dst[t] = u;
      dst[t2] = u2;
    } else {
      dst[t] = u;
    }
  }
}

template <typename T, int kLoad, bool kScale>
int launch_as(const void* x, const void* scale, void* out, int B, int H, int W,
              int C, int Cp, cudaStream_t s) {
  reflect_pad_kernel<T, kLoad, kScale><<<B * (H + 2), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<T*>(out), H, W, C, Cp);
  return cudaGetLastError();
}

// the widest chunk (elements, a power of two up to a vector) that divides C
template <typename T, bool kScale, int kLoad = 16 / sizeof(T)>
int launch(const void* x, const void* scale, void* out, int B, int H, int W,
           int C, int Cp, cudaStream_t s) {
  if constexpr (kLoad > 1) {
    if (C % kLoad != 0)
      return launch<T, kScale, kLoad / 2>(x, scale, out, B, H, W, C, Cp, s);
  }
  return launch_as<T, kLoad, kScale>(x, scale, out, B, H, W, C, Cp, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (B, H, W, C), scale (B, C) or null,
// out (B, H + 2, W + 2, Cp), all in that type.  Preconditions (checked by
// the Python wrapper): every tensor contiguous, 16-byte aligned and on one
// device; B, H, W, C >= 1; C <= Cp and Cp % 8 == 0; B (H + 2) < 2^31.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int umt_reflect_pad(int dtype, const void* x, const void* scale,
                               void* out, int B, int H, int W, int C, int Cp,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool scaled = scale != nullptr;
  if (dtype == 0)
    return scaled ? launch<float, true>(x, scale, out, B, H, W, C, Cp, s)
                  : launch<float, false>(x, scale, out, B, H, W, C, Cp, s);
  if (dtype == 1)
    return scaled ? launch<bf16, true>(x, scale, out, B, H, W, C, Cp, s)
                  : launch<bf16, false>(x, scale, out, B, H, W, C, Cp, s);
  return cudaErrorInvalidValue;
}
