// Horizontal stereo warp of NHWC rows and its gradient, for Hopper (sm_90a),
// for a group of up to 8 problems in one launch.
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
// channel) is far below the card's f32 rate.  A training step warps 8
// images at 4 scales (the full scale carries three quarters of the bytes,
// the smallest a few hundred KB), so a launch per problem paid a launch's
// fixed cost for each small one.
//
// Design.  The TPU kernels build a (W, W) one-hot matrix and contract it
// on the MXU, only to avoid XLA's scatter; here a gather and a scatter are
// cheap, so the design is direct:
// - one launch per group: a table of up to 8 problems (pointers, R, W, the
//   problem's first block) is passed by value as the kernel's parameter
//   (456 bytes of the 4 KB parameter space: no copy to the device, no
//   allocation), and each block finds its problem from the table's block
//   prefix (__grid_constant__: read in place, never copied to local
//   memory).  All problems of a group share C;
// - forward: a block takes 512 pixels of one problem, two a thread; each
//   pixel gathers its two taps from the row, which neighbouring threads
//   share through L1.  At C = 4 a tap is one 16-byte load and the output
//   one 16-byte store (every pointer of the group 16-byte aligned, checked
//   on the host); other C load and store a float at a time (C = 1, the
//   uncertainty term's, compiled for its C);
// - backward: a block takes max(1, 512 / W) rows of one problem (a 64-wide
//   row no longer idles most of a block).  The rows' dsrc accumulates in
//   shared memory, channel-major (C, W) per row so that neighbouring
//   pixels' atomics fall in neighbouring banks, with shared atomics, and is
//   zero-filled and written out once (16-byte stores at C = 4); no global
//   atomics.  dx is a per-pixel gather, written once.  The shared atomics
//   make dsrc's summation order vary from run to run (a tap receives only
//   the few pixels that sample next to it), so dsrc is not bitwise
//   reproducible; dx and out are.
// Each product and sum is rounded separately (__fmul_rn/__fadd_rn, no FMA
// contraction), so out and dx follow the plain PyTorch version's
// arithmetic.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxProblems = 8;
constexpr int kFwdPixels = 2;          // forward: pixels a thread takes
constexpr int kBwdTilePixels = 512;    // backward: pixels a block aims at
constexpr int kMaxSharedBytes = 232448;
constexpr int kEntries = 7;  // host table: x, src, dout, out, dx, R, W

struct Problem {
  const float* x;     // (R, W)
  const float* src;   // (R, W, C)
  const float* dout;  // (R, W, C); backward only
  float* out;         // forward: out; backward: dsrc; (R, W, C)
  float* dx;          // (R, W); backward only
  int rows, width;
  int rows_per_tile;  // backward: rows a block holds
  int first_tile;     // the problem's first block
};

struct Table {
  Problem p[kMaxProblems];
  int n, C;
};

struct Taps {
  int x0, x1;    // clamped source columns
  float w0, w1;  // their weights
  bool v0, v1;   // whether the tap lies inside [0, W)
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

// The problem that block `tile` belongs to: the last whose first block is
// at or before it.
__device__ __forceinline__ const Problem& problem_of(const Table& t,
                                                    int tile) {
  int i = 0;
#pragma unroll
  for (int k = 1; k < kMaxProblems; ++k)
    if (k < t.n && tile >= t.p[k].first_tile) i = k;
  return t.p[i];
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float lerp(float a, float w0, float b, float w1) {
  return __fadd_rn(__fmul_rn(a, w0), __fmul_rn(b, w1));
}

// One channel of a pixel's backward: adds its two dsrc terms to the
// channel's shared row `acc_c` and returns dx's running sum with this
// channel's term, g * (b - a), added.
__device__ __forceinline__ float bwd_channel(float* acc_c, const Taps& k,
                                             float g, float a, float b,
                                             float slope) {
  if (k.v0) atomicAdd(acc_c + k.x0, __fmul_rn(k.w0, g));
  if (k.v1) atomicAdd(acc_c + k.x1, __fmul_rn(k.w1, g));
  return __fadd_rn(slope, __fmul_rn(g, __fsub_rn(b, a)));
}

// kC = 4: 16-byte taps and outputs; kC = 1 and 0 (any C): a float at a
// time.
template <int kC>
__global__ void __launch_bounds__(kThreads)
warp_rows_fwd(const __grid_constant__ Table t) {
  const int C = kC > 0 ? kC : t.C;
  const Problem& pr = problem_of(t, blockIdx.x);
  const int W = pr.width;
  const int pixels = pr.rows * W;
  const int base = (blockIdx.x - pr.first_tile) * (kThreads * kFwdPixels);
#pragma unroll
  for (int i = 0; i < kFwdPixels; ++i) {
    const int p = base + i * kThreads + threadIdx.x;
    if (p >= pixels) break;
    const Taps k = taps(__ldg(pr.x + p), W);
    const float* row = pr.src + (p - p % W) * C;
    if constexpr (kC == 4) {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 a = k.v0 ? load4(row + 4 * k.x0) : z;
      const float4 b = k.v1 ? load4(row + 4 * k.x1) : z;
      *reinterpret_cast<float4*>(pr.out + 4 * p) = make_float4(
          lerp(a.x, k.w0, b.x, k.w1), lerp(a.y, k.w0, b.y, k.w1),
          lerp(a.z, k.w0, b.z, k.w1), lerp(a.w, k.w0, b.w, k.w1));
    } else {
      float* o = pr.out + p * C;
      for (int c = 0; c < C; ++c) {
        const float a = k.v0 ? __ldg(row + k.x0 * C + c) : 0.f;
        const float b = k.v1 ? __ldg(row + k.x1 * C + c) : 0.f;
        o[c] = lerp(a, k.w0, b, k.w1);
      }
    }
  }
}

template <int kC>
__global__ void __launch_bounds__(kThreads)
warp_rows_bwd(const __grid_constant__ Table t) {
  extern __shared__ float4 acc4[];  // (rows, C, W) of this block's rows
  float* acc = reinterpret_cast<float*>(acc4);
  const int C = kC > 0 ? kC : t.C;
  const Problem& pr = problem_of(t, blockIdx.x);
  const int W = pr.width;
  const int row0 = (blockIdx.x - pr.first_tile) * pr.rows_per_tile;
  const int npix = min(pr.rows_per_tile, pr.rows - row0) * W;
  const int n = npix * C;
  for (int i = threadIdx.x; i < (n + 3) / 4; i += kThreads)
    acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int first = row0 * W;  // the block's first pixel
  const float* src = pr.src + first * C;
  const float* g = pr.dout + first * C;
  for (int i = threadIdx.x; i < npix; i += kThreads) {
    const int rw = i - i % W;  // the pixel's row start, in pixels
    const Taps k = taps(__ldg(pr.x + first + i), W);
    const float* row = src + rw * C;
    float* a_row = acc + rw * C;  // channel c at a_row[c * W + column]
    float slope = 0.f;
    if constexpr (kC == 4) {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 gv = load4(g + 4 * i);
      const float4 a = k.v0 ? load4(row + 4 * k.x0) : z;
      const float4 b = k.v1 ? load4(row + 4 * k.x1) : z;
      slope = bwd_channel(a_row, k, gv.x, a.x, b.x, slope);
      slope = bwd_channel(a_row + W, k, gv.y, a.y, b.y, slope);
      slope = bwd_channel(a_row + 2 * W, k, gv.z, a.z, b.z, slope);
      slope = bwd_channel(a_row + 3 * W, k, gv.w, a.w, b.w, slope);
    } else {
      for (int c = 0; c < C; ++c) {
        const float a = k.v0 ? __ldg(row + k.x0 * C + c) : 0.f;
        const float b = k.v1 ? __ldg(row + k.x1 * C + c) : 0.f;
        slope = bwd_channel(a_row + c * W, k, __ldg(g + i * C + c), a, b,
                            slope);
      }
    }
    pr.dx[first + i] = slope;
  }
  __syncthreads();

  // (rows, C, W) in shared memory -> (rows, W, C) in device memory
  float* d = pr.out + first * C;
  if constexpr (kC == 4) {
    for (int i = threadIdx.x; i < npix; i += kThreads) {
      const float* a = acc + (i - i % W) * 4 + i % W;
      reinterpret_cast<float4*>(d)[i] =
          make_float4(a[0], a[W], a[2 * W], a[3 * W]);
    }
  } else if constexpr (kC == 1) {  // the two layouts agree
    for (int i = threadIdx.x; i < n; i += kThreads) d[i] = acc[i];
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int p = i / C, c = i - p * C;
      d[i] = acc[(p - p % W) * C + c * W + p % W];
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Fills `t` from the host table `e` (kEntries int64 per problem) and
// returns the grid's block count, or -1 where a problem breaks the
// preconditions.  `smem` gets the backward's shared bytes, `vec` whether
// every operand is 16-byte aligned.
long long fill_table(Table& t, int n, const long long* e, int C,
                     bool backward, size_t* smem, bool* vec) {
  if (n < 1 || n > kMaxProblems || C < 1) return -1;
  t.n = n;
  t.C = C;
  *smem = 0;
  *vec = true;
  long long tiles = 0;
  for (int i = 0; i < n; ++i, e += kEntries) {
    Problem& p = t.p[i];
    p.x = reinterpret_cast<const float*>(e[0]);
    p.src = reinterpret_cast<const float*>(e[1]);
    p.dout = reinterpret_cast<const float*>(e[2]);
    p.out = reinterpret_cast<float*>(e[3]);
    p.dx = reinterpret_cast<float*>(e[4]);
    const long long R = e[5], W = e[6];
    if (R < 1 || W < 1 || R * W * C > INT_MAX) return -1;
    p.rows = (int)R;
    p.width = (int)W;
    p.first_tile = (int)tiles;
    *vec = *vec && aligned16(p.src) && aligned16(p.out) &&
           (!backward || aligned16(p.dout));
    if (backward) {
      long long rpt = kBwdTilePixels / W;
      if (rpt < 1) rpt = 1;
      if (rpt > R) rpt = R;
      const long long fit = kMaxSharedBytes / (4 * W * C);
      if (fit < 1) return -1;
      if (rpt > fit) rpt = fit;
      p.rows_per_tile = (int)rpt;
      const size_t bytes = (size_t)(rpt * W * C * 4 + 15) / 16 * 16;
      if (bytes > *smem) *smem = bytes;
      tiles += (R + rpt - 1) / rpt;
    } else {
      p.rows_per_tile = 0;
      tiles += (R * W + kThreads * kFwdPixels - 1) / (kThreads * kFwdPixels);
    }
    if (tiles > INT_MAX) return -1;
  }
  return tiles;
}

template <int kC>
cudaError_t launch_bwd(const Table& t, unsigned tiles, size_t smem,
                       cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        warp_rows_bwd<kC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  warp_rows_bwd<kC><<<tiles, kThreads, smem, stream>>>(t);
  return cudaGetLastError();
}

}  // namespace

// One launch for a group of n (1-8) problems that share C.  `table` holds
// 7 int64 per problem: the addresses of x, src, dout, out (the backward's
// dsrc) and dx (0 where a direction does not use them), then R and W.
// Returns the CUDA error code of the launch (0 on success;
// cudaErrorInvalidValue where the table breaks a precondition: R, W >= 1,
// R * W * C < 2^31, and for the backward a row's W * C * 4 bytes fit in a
// block's shared memory, 232,448 bytes).  The wrapper checks that the
// tensors are f32, contiguous and on one device.
extern "C" int umt_warp_rows_fwd(int n, const long long* table, int C,
                                 void* stream) {
  Table t;
  size_t smem;
  bool vec;
  const long long tiles = fill_table(t, n, table, C, false, &smem, &vec);
  if (tiles < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 4 && vec)
    warp_rows_fwd<4><<<(unsigned)tiles, kThreads, 0, s>>>(t);
  else if (C == 1)
    warp_rows_fwd<1><<<(unsigned)tiles, kThreads, 0, s>>>(t);
  else
    warp_rows_fwd<0><<<(unsigned)tiles, kThreads, 0, s>>>(t);
  return cudaGetLastError();
}

extern "C" int umt_warp_rows_bwd(int n, const long long* table, int C,
                                 void* stream) {
  Table t;
  size_t smem;
  bool vec;
  const long long tiles = fill_table(t, n, table, C, true, &smem, &vec);
  if (tiles < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 4 && vec) return launch_bwd<4>(t, (unsigned)tiles, smem, s);
  if (C == 1) return launch_bwd<1>(t, (unsigned)tiles, smem, s);
  return launch_bwd<0>(t, (unsigned)tiles, smem, s);
}
