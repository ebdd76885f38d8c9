// Stride-1 conv + bias + ELU for Hopper (sm_90a), in two compile-time
// modes that share everything but the staging of the input.
//
// Gated (kGated = true) replaces the TPU kernel
// uncertainty_model_tpu/ops/pallas/conv.py::_gated_conv_elu_pallas (body
// _gated_kernel), the space-to-depth encoder stages' interior conv.  With
// n = 1..4 zero-padded NHWC inputs x_m (B, H+2p, Wp, C), gates g_m, an HWIO
// kernel w (k, k, C, Co) and a bias, it writes
//
//   out[b,i,j,:] = ELU( sum_{u,v} (sum_m g_m x_m)[b, i+u, j+v, :] @ w[u,v] + bias )
//
// (B, H, W, Co).  The gated sum is formed in the storage type in the plain
// version's order — g_0 x_0, then + g_m x_m for m = 1..n-1, every product
// and sum rounded on its own (__fmul_rn/__fadd_rn, no FMA contraction) —
// so the matrix operands equal the plain version's and only the f32
// summation order of the conv differs.
//
// Plain (kGated = false) replaces conv.py::_conv_elu_pallas (body _kernel):
// one UNPADDED input x (B, H, W, C), no gate, the SAME zero-pad conv
//
//   out[b,i,j,:] = ELU( sum_{u,v} x[b, i+u-p, j+v-p, :] @ w[u,v] + bias )
//
// The halo is staged from the unpadded tensor and the rows and columns
// outside [0, H) x [0, W) are written as zeros while staging, so no padded
// copy reaches device memory (the TPU kernel pads with jnp.pad first).  The
// operand is the input itself, not 1 * x.
//
// In both modes bias and ELU are applied in f32, with one rounding at the
// end.
//
// What bounds it: operations.  On the flagship's s2d path (256x512 input)
// stage 0 runs 5x5 taps on a 64x128 grid with C = Co = 128 and stage 1
// 3x3 taps on 32x64 with C = Co = 256, four launches each: 2.34 TFLOP a
// forward at batch 64 in bf16, 2.4 ms at the tensor cores' 989 TFLOP/s,
// against about 0.7 GB (0.2 ms) for a stage-0 launch with four inputs.  The
// native encoder's interior convs (the plain mode at batch 64: 7x7 C=32 on
// 128x256 down to 3x3 C=256 on 16x32) are 0.1-0.2 TFLOP a call.
//
// Design (bf16): an implicit GEMM on the tensor cores, nvcuda::wmma
// 16x16x16 from shared memory with f32 accumulators in registers.  A
// block of 8 warps owns 64 output columns of one output row and 128
// output channels (each warp a 32x32 tile).  It stages its halo — k input
// rows by 64+k-1 columns by C channels — into shared memory once (forming
// the gated sum on the way in the gated mode, so no gated tensor ever
// reaches device memory), and each tap's A operand is a strided view of
// the halo.  The weights stream through a double buffer, one (tap,
// input-channel chunk of up to 128) slice at a time, with cp.async.  The
// TPU design (whole padded rows of a batch element in VMEM, one MXU matmul
// per tap) does not carry over.  The halo and the two weight slices take
// 170-180 KB at the s2d path's shapes, so one block runs per SM; wgmma,
// TMA and a deeper pipeline are later work.
//
// Design (f32, the f32 checks): the same halo, then FMA on the CUDA cores
// (no TF32), a block of 256 threads owning 32 output columns by 64
// channels, each thread 2 columns by 4 channels.

#include <mma.h>

#include <cstddef>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using umt::Io;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;
constexpr int kMaxInputs = 4;
constexpr int kSmemLimit = 232448;

template <typename T>
struct Args {
  const T* x[kMaxInputs];
  const T* gates;  // (n,) in the storage type; unused when not gated
  const T* w;      // (k, k, C, Co)
  const float* bias;  // (Co,)
  T* out;          // (B, H, W, Co)
  int n, H, W, C, Co, k;
  // the inputs are (B, Hin, Win, C); output (i, j) at tap (u, v) reads
  // input (i + u - pad, j + v - pad): gated, the pre-padded inputs with
  // Hin = H+k-1, Win = Wp and pad 0; plain, the unpadded input with
  // Hin = H, Win = W and pad (k-1)/2
  int Hin, Win, pad;
};

// Input rows i-pad .. i-pad+k-1 and columns j0-pad .. j0-pad+hw-1 into
// shared memory as [row][column][cp] in the storage type: the gated sum of
// the inputs, or the one input as it is.  Rows and columns outside the
// input read as zero: the SAME conv's zero pad, or (gated) columns at or
// beyond Wp, which feed only output columns at or beyond W, not stored.
template <typename T, bool kGated>
__device__ void stage_halo(const Args<T>& a, T* halo, int b, int i, int j0,
                           int hw, int cp) {
  constexpr int kVec = 16 / sizeof(T);
  const int cv = a.C / kVec;
  const int total = a.k * hw * cv;
  float g[kMaxInputs];
#pragma unroll
  for (int m = 0; m < kMaxInputs; ++m) {
    g[m] = kGated && m < a.n ? Io<T>::load(a.gates + m) : 0.f;
  }
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int v = t % cv;
    const int q = (t / cv) % hw;
    const int r = t / cv / hw;
    const int row = i + r - a.pad;
    const int col = j0 + q - a.pad;
    uint4 packed = make_uint4(0, 0, 0, 0);
    if (row >= 0 && row < a.Hin && col >= 0 && col < a.Win) {
      const size_t off =
          (((size_t)b * a.Hin + row) * a.Win + col) * a.C + (size_t)v * kVec;
      uint4 in = *reinterpret_cast<const uint4*>(a.x[0] + off);
      if constexpr (kGated) {
        float s[kVec];
        const T* e = reinterpret_cast<const T*>(&in);
#pragma unroll
        for (int l = 0; l < kVec; ++l) {
          s[l] = Io<T>::round(__fmul_rn(g[0], Io<T>::load(e + l)));
        }
#pragma unroll
        for (int m = 1; m < kMaxInputs; ++m) {
          if (m < a.n) {
            in = *reinterpret_cast<const uint4*>(a.x[m] + off);
#pragma unroll
            for (int l = 0; l < kVec; ++l) {
              const float p =
                  Io<T>::round(__fmul_rn(g[m], Io<T>::load(e + l)));
              s[l] = Io<T>::round(__fadd_rn(s[l], p));
            }
          }
        }
        T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
        for (int l = 0; l < kVec; ++l) Io<T>::store(o + l, s[l]);
      } else {
        packed = in;
      }
    }
    *reinterpret_cast<uint4*>(halo + ((size_t)r * hw + q) * cp + v * kVec) =
        packed;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores

constexpr int kTW = 64;         // output columns of a block
constexpr int kTN = 128;        // output channels of a block
constexpr int kLdb = kTN + 16;  // weight slice row stride (elements)
constexpr int kLde = kTN + 4;   // epilogue tile row stride (floats)

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// step s of the K loop: tap s / (C / kc), input channels
// [(s % (C / kc)) * kc, + kc), output channels [n0, n0 + kTN) -> wt (kc x kLdb)
__device__ void load_weights(const Args<bf16>& a, bf16* wt, int s, int kc,
                             int n0) {
  const int nchunk = a.C / kc;
  const int tap = s / nchunk;
  const int c0 = (s % nchunk) * kc;
  const int total = kc * (kTN / 8);
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int r = t / (kTN / 8);
    const int col = (t % (kTN / 8)) * 8;
    bf16* dst = wt + r * kLdb + col;
    if (n0 + col < a.Co) {
      cp_async16(dst, a.w + ((size_t)tap * a.C + c0 + r) * a.Co + n0 + col);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
}

template <bool kGated>
__global__ void __launch_bounds__(kThreads)
    gated_conv_bf16(Args<bf16> a, int kc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hw = kTW + a.k - 1;
  const int cp = a.C + 16;
  bf16* halo = reinterpret_cast<bf16*>(smem);
  bf16* wts = halo + (size_t)a.k * hw * cp;
  const int tiles = (a.W + kTW - 1) / kTW;
  int blk = blockIdx.x;
  const int j0 = (blk % tiles) * kTW;
  blk /= tiles;
  const int i = blk % a.H;
  const int b = blk / a.H;
  const int n0 = blockIdx.y * kTN;
  const int nchunk = a.C / kc;
  const int steps = a.k * a.k * nchunk;

  load_weights(a, wts, 0, kc, n0);
  cp_async_commit();
  stage_halo<bf16, kGated>(a, halo, b, i, j0, hw, cp);

  const int warp = threadIdx.x / 32;
  const int wm = warp / 4;  // 2 x 4 warps, each 32 columns x 32 channels
  const int wn = warp % 4;
  const bool active = n0 + wn * 32 < a.Co;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) wmma::fill_fragment(acc[mi][ni], 0.f);
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_all();
    __syncthreads();  // slice s landed; every warp is done with slice s-1
    if (s + 1 < steps) {
      load_weights(a, wts + ((s + 1) & 1) * kc * kLdb, s + 1, kc, n0);
      cp_async_commit();
    }
    if (!active) continue;
    const int tap = s / nchunk;
    const int u = tap / a.k;
    const int v = tap % a.k;
    const int c0 = (s % nchunk) * kc;
    const bf16* wt = wts + (s & 1) * kc * kLdb;
    const bf16* arow = halo + ((size_t)u * hw + wm * 32 + v) * cp + c0;
    for (int kk = 0; kk < kc; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        wmma::load_matrix_sync(fa[mi], arow + (size_t)mi * 16 * cp + kk, cp);
      }
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        wmma::load_matrix_sync(fb[ni], wt + kk * kLdb + wn * 32 + ni * 16,
                               kLdb);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          wmma::mma_sync(acc[mi][ni], fa[mi], fb[ni], acc[mi][ni]);
        }
      }
    }
  }
  __syncthreads();  // the halo and weights are dead: reuse for the epilogue

  float* epi = reinterpret_cast<float*>(smem);
  if (active) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        wmma::store_matrix_sync(
            epi + (wm * 32 + mi * 16) * kLde + wn * 32 + ni * 16,
            acc[mi][ni], kLde, wmma::mem_row_major);
      }
    }
  }
  __syncthreads();
  bf16* out = a.out + ((size_t)b * a.H + i) * a.W * a.Co;
  for (int t = threadIdx.x; t < kTW * kTN; t += blockDim.x) {
    const int m = t / kTN;
    const int nn = t % kTN;
    const int j = j0 + m;
    const int n = n0 + nn;
    if (j < a.W && n < a.Co) {
      const float y = __fadd_rn(epi[m * kLde + nn], a.bias[n]);
      Io<bf16>::store(out + (size_t)j * a.Co + n, umt::elu(y));
    }
  }
}

int bf16_chunk(int c) {
  for (int kc = 128; kc > 16; kc /= 2) {
    if (c % kc == 0) return kc;
  }
  return 16;
}

size_t bf16_smem(int k, int c) {
  const size_t halo = (size_t)k * (kTW + k - 1) * (c + 16) * sizeof(bf16);
  const size_t wts = 2 * (size_t)bf16_chunk(c) * kLdb * sizeof(bf16);
  const size_t epi = (size_t)kTW * kLde * sizeof(float);
  return halo + wts > epi ? halo + wts : epi;
}

// ---------------------------------------------------------------------------
// f32: CUDA cores

constexpr int kTWf = 32;  // output columns of a block
constexpr int kTNf = 64;  // output channels of a block

template <bool kGated>
__global__ void __launch_bounds__(kThreads) gated_conv_f32(Args<float> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hw = kTWf + a.k - 1;
  const int cp = a.C + 4;
  float* halo = reinterpret_cast<float*>(smem);
  const int tiles = (a.W + kTWf - 1) / kTWf;
  int blk = blockIdx.x;
  const int j0 = (blk % tiles) * kTWf;
  blk /= tiles;
  const int i = blk % a.H;
  const int b = blk / a.H;
  stage_halo<float, kGated>(a, halo, b, i, j0, hw, cp);
  __syncthreads();

  const int tx = threadIdx.x % 16;  // 4 output channels each
  const int ty = threadIdx.x / 16;  // output columns ty and ty + 16
  const int n = blockIdx.y * kTNf + tx * 4;
  if (n >= a.Co) return;
  float acc[2][4] = {};
  for (int u = 0; u < a.k; ++u) {
    for (int v = 0; v < a.k; ++v) {
      const float* h0 = halo + ((size_t)u * hw + ty + v) * cp;
      const float* h1 = h0 + 16 * cp;
      const float* wp = a.w + (size_t)(u * a.k + v) * a.C * a.Co + n;
      for (int c = 0; c < a.C; c += 4) {
        const float4 x0 = *reinterpret_cast<const float4*>(h0 + c);
        const float4 x1 = *reinterpret_cast<const float4*>(h1 + c);
        const float xs0[4] = {x0.x, x0.y, x0.z, x0.w};
        const float xs1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float4 wv = __ldg(
              reinterpret_cast<const float4*>(wp + (size_t)(c + cc) * a.Co));
          acc[0][0] += xs0[cc] * wv.x;
          acc[0][1] += xs0[cc] * wv.y;
          acc[0][2] += xs0[cc] * wv.z;
          acc[0][3] += xs0[cc] * wv.w;
          acc[1][0] += xs1[cc] * wv.x;
          acc[1][1] += xs1[cc] * wv.y;
          acc[1][2] += xs1[cc] * wv.z;
          acc[1][3] += xs1[cc] * wv.w;
        }
      }
    }
  }
  const float4 bv = *reinterpret_cast<const float4*>(a.bias + n);
  const float bias[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int j = j0 + ty + 16 * p;
    if (j < a.W) {
      float4 o;
      o.x = umt::elu(__fadd_rn(acc[p][0], bias[0]));
      o.y = umt::elu(__fadd_rn(acc[p][1], bias[1]));
      o.z = umt::elu(__fadd_rn(acc[p][2], bias[2]));
      o.w = umt::elu(__fadd_rn(acc[p][3], bias[3]));
      *reinterpret_cast<float4*>(
          a.out + (((size_t)b * a.H + i) * a.W + j) * a.Co + n) = o;
    }
  }
}

size_t f32_smem(int k, int c) {
  return (size_t)k * (kTWf + k - 1) * (c + 4) * sizeof(float);
}

template <typename T>
Args<T> make_args(const void* const* xs, const void* gates, const void* w,
                  const void* bias, void* out, int n, int H, int W, int Hin,
                  int Win, int pad, int C, int Co, int k) {
  Args<T> a;
  for (int m = 0; m < kMaxInputs; ++m) {
    a.x[m] = static_cast<const T*>(m < n ? xs[m] : xs[0]);
  }
  a.gates = static_cast<const T*>(gates);
  a.w = static_cast<const T*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<T*>(out);
  a.n = n;
  a.H = H;
  a.W = W;
  a.C = C;
  a.Co = Co;
  a.k = k;
  a.Hin = Hin;
  a.Win = Win;
  a.pad = pad;
  return a;
}

template <bool kGated>
int launch(int dtype, const void* const* xs, const void* gates,
           const void* w, const void* bias, void* out, int n, int B, int H,
           int W, int Hin, int Win, int pad, int C, int Co, int k,
           cudaStream_t s) {
  if (dtype == 1) {
    const size_t smem = bf16_smem(k, C);
    if (smem > kSmemLimit || C % 16 || Co % 16) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        gated_conv_bf16<kGated>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H * ((W + kTW - 1) / kTW), (Co + kTN - 1) / kTN);
    gated_conv_bf16<kGated><<<grid, kThreads, smem, s>>>(
        make_args<bf16>(xs, gates, w, bias, out, n, H, W, Hin, Win, pad, C,
                        Co, k),
        bf16_chunk(C));
    return cudaGetLastError();
  }
  if (dtype == 0) {
    const size_t smem = f32_smem(k, C);
    if (smem > kSmemLimit || C % 4 || Co % 4) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        gated_conv_f32<kGated>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H * ((W + kTWf - 1) / kTWf), (Co + kTNf - 1) / kTNf);
    gated_conv_f32<kGated><<<grid, kThreads, smem, s>>>(make_args<float>(
        xs, gates, w, bias, out, n, H, W, Hin, Win, pad, C, Co, k));
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Shared memory a launch needs, in bytes, in either mode (the wrapper
// refuses shapes above the card's 227 KB a block).  dtype: 0 = float32,
// 1 = bfloat16.
extern "C" long long umt_gated_conv_elu_smem(int dtype, int k, int C) {
  return dtype == 1 ? (long long)bf16_smem(k, C) : (long long)f32_smem(k, C);
}

// xs: n (1..4) pointers to (B, H+k-1, Wp, C) inputs; gates (n,) and w
// (k, k, C, Co) in the storage type; bias (Co,) f32; out (B, H, W, Co).
// Preconditions (checked by the Python wrapper): every tensor contiguous,
// 16-byte aligned and on one device; W + k - 1 <= Wp; bf16: C and Co
// multiples of 16; f32: C and Co multiples of 4.  Returns the CUDA error
// code of the launch (0 on success).
extern "C" int umt_gated_conv_elu(int dtype, const void* const* xs,
                                  const void* gates, const void* w,
                                  const void* bias, void* out, int n, int B,
                                  int H, int Wp, int W, int C, int Co, int k,
                                  void* stream) {
  if (n < 1 || n > kMaxInputs) return cudaErrorInvalidValue;
  return launch<true>(dtype, xs, gates, w, bias, out, n, B, H, W, H + k - 1,
                      Wp, 0, C, Co, k, static_cast<cudaStream_t>(stream));
}

// The SAME zero-pad conv of one unpadded input x (B, H, W, C) with w
// (k, k, C, Co) in the storage type and bias (Co,) f32 into out (B, H, W,
// Co), under the same preconditions.
extern "C" int umt_conv_elu(int dtype, const void* x, const void* w,
                            const void* bias, void* out, int B, int H, int W,
                            int C, int Co, int k, void* stream) {
  const void* xs[1] = {x};
  return launch<false>(dtype, xs, nullptr, w, bias, out, 1, B, H, W, H, W,
                       (k - 1) / 2, C, Co, k,
                       static_cast<cudaStream_t>(stream));
}
