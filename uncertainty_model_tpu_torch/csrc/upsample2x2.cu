// Exact 2x align-corners bilinear upsample of NHWC tensors, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel uncertainty_model_tpu/ops/pallas/upsample.py
// ::_upsample2x2_pallas, which runs two Pallas kernels: a column pass
// (_col_kernel) writing an intermediate y1 (B, H, 2W, C) in the input's
// type, then a row pass (_row_kernel) of banded (8, 16) @ (16, 2W*C)
// matmuls.  Here both passes are fused in registers and y1 never reaches
// device memory, with the same arithmetic as the plain version
// (ops/upsample.py::upsample2x2_plain):
//
//   column pass, in f32, at source rows lo[r] and hi[r] of output row r:
//     y1[2j]   = x[j-1] + fe[j] * (x[j]   - x[j-1])
//     y1[2j+1] = x[j]   + fo[j] * (x[j+1] - x[j])        (edges replicated)
//   each rounded to the storage type, as the TPU kernel stores y1;
//   row pass, in f32, one rounding at the end:
//     out[r] = (1 - f[r]) * y1[lo[r]] + f[r] * y1[hi[r]]
//   or ((1 - f) + f) * y1[lo] where lo == hi (a 1-row input), the band's
//   one weight.
//
// Every operation is rounded on its own (__fadd_rn/__fmul_rn, no FMA), as
// the plain version's separate PyTorch operations are.  The taps (fe, fo;
// lo, hi, 1 - f, f) come from the host, from the port's _lerp_coeffs.
//
// What bounds it: bytes.  Each input element is read once and each output
// written once, 5 B H W C elements: (64, 128, 256, 32) in bf16 moves
// 0.67 GB, 0.20 ms at 3.35 TB/s, against 24 f32 operations per output pair.
//
// Design: one thread per (batch, output row, source column, 16-byte
// channel vector).  It reads the three neighbouring source columns of its
// two source rows (six vector loads; neighbours in a warp share them
// through L1), forms both output columns 2j and 2j+1 of its output row,
// and writes them as two 16-byte stores; neighbouring threads hold
// neighbouring channel vectors, then columns, so each warp's loads and
// stores are contiguous runs.  Channel counts that are not a multiple of a
// 16-byte vector take the same path one element at a time.

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using umt::Io;

constexpr int kThreads = 256;

template <typename T, int kVec>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  if constexpr (kVec * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int l = 0; l < kVec; ++l) f[l] = Io<T>::load(e + l);
  } else {
#pragma unroll
    for (int l = 0; l < kVec; ++l) f[l] = Io<T>::load(p + l);
  }
}

template <typename T, int kVec>
__device__ __forceinline__ void store_vec(T* p, const float* f) {
  if constexpr (kVec * sizeof(T) == 16) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int l = 0; l < kVec; ++l) Io<T>::store(e + l, f[l]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int l = 0; l < kVec; ++l) Io<T>::store(p + l, f[l]);
  }
}

// the column pass at one source row: y1[2j] and y1[2j+1], rounded to T
template <typename T, int kVec>
__device__ __forceinline__ void column_pass(const T* row, int jm, int j,
                                            int jp, int C, float we, float wo,
                                            float* even, float* odd) {
  float a[kVec], m[kVec], n[kVec];
  load_vec<T, kVec>(row + (size_t)jm * C, a);
  load_vec<T, kVec>(row + (size_t)j * C, m);
  load_vec<T, kVec>(row + (size_t)jp * C, n);
#pragma unroll
  for (int l = 0; l < kVec; ++l) {
    even[l] = Io<T>::round(umt::lerp(a[l], m[l], we));
    odd[l] = Io<T>::round(umt::lerp(m[l], n[l], wo));
  }
}

__device__ __forceinline__ float row_pass(float y_lo, float y_hi, float w_lo,
                                          float w_hi, bool one_tap) {
  return one_tap ? __fmul_rn(__fadd_rn(w_lo, w_hi), y_lo)
                 : __fadd_rn(__fmul_rn(w_lo, y_lo), __fmul_rn(w_hi, y_hi));
}

// x (B, H, W, C) -> out (B, 2H, 2W, C).  col: (W, 2) f32, the even and odd
// fractions of source column j; lo, hi: (2H,) source rows of output row r;
// roww: (2H, 2) f32, (1 - f, f) of output row r.
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
    upsample2x2_kernel(const T* __restrict__ x, T* __restrict__ out,
                       const float* __restrict__ col,
                       const int* __restrict__ lo, const int* __restrict__ hi,
                       const float* __restrict__ roww, int H, int W, int C,
                       long long total) {
  const int cv = C / kVec;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int v = (int)(idx % cv);
    long long rest = idx / cv;
    const int j = (int)(rest % W);
    rest /= W;
    const int r = (int)(rest % (2 * H));
    const long long b = rest / (2 * H);
    const int jm = j > 0 ? j - 1 : 0;
    const int jp = j + 1 < W ? j + 1 : W - 1;
    const float we = col[2 * j];
    const float wo = col[2 * j + 1];
    const int r_lo = lo[r];
    const int r_hi = hi[r];
    const float w_lo = roww[2 * r];
    const float w_hi = roww[2 * r + 1];
    const bool one_tap = r_lo == r_hi;
    const size_t row_stride = (size_t)W * C;
    const T* src = x + (size_t)b * H * row_stride + (size_t)v * kVec;

    float e_lo[kVec], o_lo[kVec], e_hi[kVec], o_hi[kVec];
    column_pass<T, kVec>(src + r_lo * row_stride, jm, j, jp, C, we, wo, e_lo,
                         o_lo);
    if (one_tap) {
#pragma unroll
      for (int l = 0; l < kVec; ++l) {
        e_hi[l] = e_lo[l];
        o_hi[l] = o_lo[l];
      }
    } else {
      column_pass<T, kVec>(src + r_hi * row_stride, jm, j, jp, C, we, wo,
                           e_hi, o_hi);
    }
#pragma unroll
    for (int l = 0; l < kVec; ++l) {
      e_lo[l] = row_pass(e_lo[l], e_hi[l], w_lo, w_hi, one_tap);
      o_lo[l] = row_pass(o_lo[l], o_hi[l], w_lo, w_hi, one_tap);
    }
    T* dst = out + (((size_t)b * 2 * H + r) * 2 * W + 2 * (size_t)j) * C +
             (size_t)v * kVec;
    store_vec<T, kVec>(dst, e_lo);
    store_vec<T, kVec>(dst + C, o_lo);
  }
}

template <typename T>
int launch(const void* x, void* out, const void* col, const void* lo,
           const void* hi, const void* roww, int B, int H, int W, int C,
           cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vector = C % kVec == 0;
  const long long total = (long long)B * 2 * H * W * (vector ? C / kVec : C);
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < (1LL << 30) ? want : (1LL << 30));
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const float* c = static_cast<const float*>(col);
  const int* l = static_cast<const int*>(lo);
  const int* h = static_cast<const int*>(hi);
  const float* rw = static_cast<const float*>(roww);
  if (vector) {
    upsample2x2_kernel<T, kVec>
        <<<blocks, kThreads, 0, s>>>(xt, ot, c, l, h, rw, H, W, C, total);
  } else {
    upsample2x2_kernel<T, 1>
        <<<blocks, kThreads, 0, s>>>(xt, ot, c, l, h, rw, H, W, C, total);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (B, H, W, C) and out (B, 2H, 2W, C)
// in that type; col (W, 2) f32, lo and hi (2H,) int32, roww (2H, 2) f32 as
// described above.  Preconditions (checked by the Python wrapper): every
// tensor contiguous, 16-byte aligned and on one device; B, H, W, C >= 1.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int umt_upsample2x2(int dtype, const void* x, void* out,
                               const void* col, const void* lo,
                               const void* hi, const void* roww, int B, int H,
                               int W, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, out, col, lo, hi, roww, B, H, W, C, s);
  if (dtype == 1) return launch<bf16>(x, out, col, lo, hi, roww, B, H, W, C, s);
  return cudaErrorInvalidValue;
}
