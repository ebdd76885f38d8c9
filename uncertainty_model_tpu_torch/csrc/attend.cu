// The core of EfficientAttention in the serving forward, for Hopper
// (sm_90a): both softmaxes, the per-head context and its application, with
// the keys, queries and values read once and the output written once.
//
// Replaces no TPU kernel: the JAX package leaves its serving attention to
// XLA.  It replaces the port's plain chain (ops/attend.py::attend_plain):
// the keys' softmax over the tokens and the queries' over each head's
// channels, each written in f32 and cast back to the storage type, then
// two einsums that permute their operands into batched-matmul layouts and
// the result back.
//
// With keys K, queries Q and values V (B, N, C) token maps, C = H D, head
// h on channels h D .. h D + D - 1, and per image and head
//
//   ctx[k, v] = sum_n exp(K[n, k] - mk) V[n, v] / sum_n exp(K[n, k] - mk)
//   out[n, v] = sum_k exp(Q[n, k] - mq) ctx[k, v] / sum_k exp(Q[n, k] - mq)
//
// mk is the max over the tokens of K[., k] and mq the max over k of
// Q[n, .] ("window" and "slice"), or 0 ("nomax", which overflows where
// exp does, as the plain version does; the keys and the queries choose
// apart).  All arithmetic is f32: out is rounded once to the storage type.
//
// What bounds it: bytes.  At b128 the flagship's five stages read K, Q and
// V and write out, 4 x 520.1 MB = 2.08 GB, 621 us at 3.35 TB/s; their
// products, 4 B N H D^2 = 10.7 GFLOP, are f32 FMAs on the CUDA cores.
//
// Design: three launches a call, two where one chunk covers an image's
// tokens (ops/attend.py::plan_attend chooses the chunks from B N and the
// card's SM count; they are checked here).  Every exponential is exp2 of
// one FMA (exp_off).
// 1. attend_context: a block a (chunk of tokens, group of Hg heads,
//    image).  Its 256 threads form lanes of Hg (D/4) (D/V) threads, each
//    thread a 4 x V block (k, v) of one head's context (V = 8 where D >= 8,
//    else 4); a lane takes every lanes-th token of the chunk, four at a
//    time, loading each token's 4 keys and V values of its block
//    (neighbouring threads on neighbouring channels) while the four before
//    are computed.  A thread keeps per k the running max, the sum of
//    exp(K - max) and its 4 x V block of sum exp(K - max) V, rescaled when
//    the max rises (the online softmax).
//    The lanes merge in shared memory at the block's max; the block writes
//    its partials (max, sum, context) or, as the image's only chunk, the
//    normalised context.
// 2. attend_combine (more than one chunk): a thread a context entry; the
//    chunks' partials of its (head, k) row rescaled to the row's global
//    max and summed, divided by the sum: the keys' softmax over all the
//    tokens.
// 3. attend_apply: a block a (chunk of tokens, group, image), the group's
//    normalised context in shared memory (in registers where D <= 8); the
//    D/4 threads of a (token, head) each load 4 of its query logits,
//    exponentiate them, share the max, the sum and the weights by warp
//    shuffles, and write 4 outputs of the product with the context.

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;

// four consecutive elements of a T row: loaded as raw bits (so that a
// step's loads can be issued before the step before it is done), as f32
template <typename T>
struct Quad;

template <>
struct Quad<float> {
  using Raw = float4;
  static __device__ __forceinline__ Raw raw(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float4 f32(Raw r) { return r; }
  static __device__ __forceinline__ void store(float* p, float4 q) {
    *reinterpret_cast<float4*>(p) = q;
  }
};

template <>
struct Quad<bf16> {
  using Raw = uint2;
  static __device__ __forceinline__ Raw raw(const bf16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ float4 f32(Raw u) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void store(bf16* p, float4 q) {
    __nv_bfloat162 a = __floats2bfloat162_rn(q.x, q.y);
    __nv_bfloat162 b = __floats2bfloat162_rn(q.z, q.w);
    uint2 u;
    u.x = *reinterpret_cast<unsigned*>(&a);
    u.y = *reinterpret_cast<unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

// exp(x - m) as exp2(x log2(e) - m log2(e)): one FMA and the SFU's exp2
// (ex2.approx, relative error under 2^-22; results below 2^-126 flush to
// 0, as no softmax weight that small moves an f32 sum); mlog2e = m log2(e),
// shared by a softmax's elements
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp_off(float x, float mlog2e) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(fmaf(x, kLog2e, -mlog2e)));
  return y;
}

// the v columns of a context thread's block: 4 k x kVr v, wider where the
// head allows, so that fewer threads exponentiate the same keys
template <int D>
constexpr int kVr = D >= 8 ? 8 : 4;

// the apply's row stride of a head's context in shared memory, padded so
// that the heads a quarter warp reads lie in distinct banks
template <int D>
constexpr int kApplyStride = D * D + (D % 32 > 4 ? D % 32 : 4);

// K, V (B, N, C); grid (chunks, H / Hg, B).  Writes the normalised context
// ctx (B, H / Hg, Hg D D) where chunks == 1, else the partials acc (B,
// H / Hg, chunks, Hg D D), row max pm and row sum ps (B, H / Hg, chunks,
// Hg D).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    attend_context(const T* __restrict__ keys, const T* __restrict__ values,
                   float* __restrict__ ctx, float* __restrict__ pacc,
                   float* __restrict__ pm, float* __restrict__ ps, int N,
                   int H, int Hg, int chunk, bool with_max) {
  using Raw = typename Quad<T>::Raw;
  constexpr int kV = kVr<D>;     // v columns a thread
  constexpr int kQ = kV / 4;     // value quads a token
  constexpr int kKT = D / 4;     // k blocks a head
  constexpr int kVT = D / kV;    // v blocks a head
  const int C = H * D;
  const int per_lane = Hg * kKT * kVT;
  const int lanes = blockDim.x / per_lane;
  const int rows = Hg * D;  // the group's (head, k) rows
  const int E = rows * D;   // the group's context entries
  const int lane = threadIdx.x / per_lane;
  const int r = threadIdx.x - lane * per_lane;
  const int hl = r / (kKT * kVT);
  const int kt = r / kVT - hl * kKT;
  const int vt = r - (r / kVT) * kVT;
  const int chunks = gridDim.x, j = blockIdx.x, g = blockIdx.y;
  const size_t unit = (size_t)blockIdx.z * gridDim.y + g;
  const int n0 = j * chunk;
  const int n1 = min(N, n0 + chunk);
  const int row0 = hl * D + kt * 4;  // the thread's first row in the group
  const size_t head = (size_t)blockIdx.z * N * C + (g * Hg + hl) * D;
  const T* kp = keys + head + kt * 4;
  const T* vp = values + head + vt * kV;

  // m: the running max of each k (0 without one), moff = m log2(e)
  float m[4], moff[4], s[4], acc[4][kV];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m[k] = with_max ? -INFINITY : 0.f;
    moff[k] = with_max ? -INFINITY : 0.f;
    s[k] = 0.f;
#pragma unroll
    for (int v = 0; v < kV; ++v) acc[k][v] = 0.f;
  }

  // a step: the lane's tokens n, n + lanes, n + 2 lanes, n + 3 lanes, whose
  // loads are issued while the step before is computed
  Raw kr[4], vr[4][kQ];
  auto fetch = [&](int n) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const size_t at = (size_t)min(n + u * lanes, n1 - 1) * C;
      kr[u] = Quad<T>::raw(kp + at);
#pragma unroll
      for (int q = 0; q < kQ; ++q) vr[u][q] = Quad<T>::raw(vp + at + 4 * q);
    }
  };
  if (n0 + lane < n1) fetch(n0 + lane);
  for (int n = n0 + lane; n < n1; n += 4 * lanes) {
    const int valid = min(4, (n1 - n + lanes - 1) / lanes);
    float4 x[4];
    Raw vcur[4][kQ];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      x[u] = Quad<T>::f32(kr[u]);
#pragma unroll
      for (int q = 0; q < kQ; ++q) vcur[u][q] = vr[u][q];
    }
    if (n + 4 * lanes < n1) fetch(n + 4 * lanes);
    if (with_max) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float mx = m[k];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (u < valid) mx = fmaxf(mx, (&x[u].x)[k]);
        if (mx > m[k]) {
          const float f = exp_off(m[k], mx * kLog2e);
          s[k] *= f;
#pragma unroll
          for (int v = 0; v < kV; ++v) acc[k][v] *= f;
          m[k] = mx;
          moff[k] = mx * kLog2e;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u < valid) {
        float y[kV];
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const float4 f = Quad<T>::f32(vcur[u][q]);
          y[4 * q] = f.x;
          y[4 * q + 1] = f.y;
          y[4 * q + 2] = f.z;
          y[4 * q + 3] = f.w;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float e = exp_off((&x[u].x)[k], moff[k]);
          s[k] += e;
#pragma unroll
          for (int v = 0; v < kV; ++v) acc[k][v] = fmaf(e, y[v], acc[k][v]);
        }
      }
    }
  }

  // the lanes merge at the block's max of each row (0 without one)
  extern __shared__ float4 smem4[];
  float* lane_m = reinterpret_cast<float*>(smem4);  // [lanes][rows]
  float* lane_s = lane_m + lanes * rows;             // [lanes][rows]
  float* lane_acc = lane_s + lanes * rows;           // [lanes][E]
  float* blk_m = lane_acc + lanes * E;               // [rows]
  float* blk_s = blk_m + rows;                       // [rows]
  const bool writer = vt == 0;  // one of the threads of a row
  if (writer) {
#pragma unroll
    for (int k = 0; k < 4; ++k) lane_m[lane * rows + row0 + k] = m[k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    float mx = -INFINITY;
    for (int l = 0; l < lanes; ++l) mx = fmaxf(mx, lane_m[l * rows + i]);
    blk_m[i] = mx;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float f = exp_off(m[k], blk_m[row0 + k] * kLog2e);
    s[k] *= f;
#pragma unroll
    for (int v = 0; v < kV; ++v) acc[k][v] *= f;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (writer) lane_s[lane * rows + row0 + k] = s[k];
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      *reinterpret_cast<float4*>(lane_acc + lane * E + (row0 + k) * D +
                                 vt * kV + 4 * q) =
          make_float4(acc[k][4 * q], acc[k][4 * q + 1], acc[k][4 * q + 2],
                      acc[k][4 * q + 3]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    float t = 0.f;
    for (int l = 0; l < lanes; ++l) t += lane_s[l * rows + i];
    blk_s[i] = t;
  }
  __syncthreads();
  if (chunks == 1) {
    for (int i = threadIdx.x; i < E; i += blockDim.x) {
      float a = 0.f;
      for (int l = 0; l < lanes; ++l) a += lane_acc[l * E + i];
      ctx[unit * E + i] = a / blk_s[i / D];
    }
    return;
  }
  const size_t p = unit * chunks + j;
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    float a = 0.f;
    for (int l = 0; l < lanes; ++l) a += lane_acc[l * E + i];
    pacc[p * E + i] = a;
  }
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    pm[p * rows + i] = blk_m[i];
    ps[p * rows + i] = blk_s[i];
  }
}

// the chunks' partials of an (image, group) -> its normalised context;
// grid (E / kThreads rounded up, B H / Hg), a thread an entry, each block
// first finding the global max and sum of the rows its entries lie in
// (under "nomax" every partial's max is 0, and so every factor 1)
__global__ void __launch_bounds__(kThreads)
    attend_combine(const float* __restrict__ pacc, const float* __restrict__ pm,
                   const float* __restrict__ ps, float* __restrict__ ctx,
                   int rows, int D, int chunks) {
  extern __shared__ float4 smem4[];
  float* row_m = reinterpret_cast<float*>(smem4);  // [kThreads / D + 1]
  float* row_s = row_m + kThreads / D + 1;
  const size_t unit = blockIdx.y;
  const int E = rows * D;
  const int e0 = blockIdx.x * kThreads;
  const int r0 = e0 / D;
  const int nrows = min(rows, (min(E, e0 + kThreads) - 1) / D + 1) - r0;
  const float* um = pm + unit * chunks * rows;
  const float* us = ps + unit * chunks * rows;
  const float* ua = pacc + unit * chunks * E;
  for (int i = threadIdx.x; i < nrows; i += blockDim.x) {
    const int row = r0 + i;
    // unrolled, so that a thread's loads of the chunks are in flight at once
    float mx = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < chunks; ++c) mx = fmaxf(mx, um[c * rows + row]);
    const float off = mx * kLog2e;
    float t = 0.f;
#pragma unroll 8
    for (int c = 0; c < chunks; ++c)
      t += us[c * rows + row] * exp_off(um[c * rows + row], off);
    row_m[i] = off;
    row_s[i] = t;
  }
  __syncthreads();
  const int i = e0 + threadIdx.x;
  if (i >= E) return;
  const int row = i / D;
  const float off = row_m[row - r0];
  float a = 0.f;
#pragma unroll 8
  for (int c = 0; c < chunks; ++c)
    a += ua[(size_t)c * E + i] * exp_off(um[c * rows + row], off);
  ctx[unit * E + i] = a / row_s[row - r0];
}

// Q (B, N, C), ctx (B, H / Hg, Hg D D) -> out (B, N, C); grid (blocks,
// H / Hg, B).  The D / 4 threads of a (token, head) are neighbouring
// lanes of a warp: each takes the exponentials of its own 4 logits, the
// max and the sum go round them by shuffles, and so does each weight to
// the product.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attend_apply(const T* __restrict__ queries, const float* __restrict__ ctx,
                 T* __restrict__ out, int N, int H, int Hg, int block,
                 bool with_max) {
  using Raw = typename Quad<T>::Raw;
  constexpr int kT = D / 4;
  constexpr int kStride = kApplyStride<D>;
  constexpr bool kRegs = D <= 8;      // the thread's context in registers
  constexpr int kU = 4;              // tokens a step
  const int C = H * D;
  const int per_lane = Hg * kT;
  const int lanes = blockDim.x / per_lane;
  const int lane = threadIdx.x / per_lane;
  const int r = threadIdx.x - lane * per_lane;
  const int hl = r / kT;
  const int vt = r - hl * kT;
  const int E = Hg * D * D;

  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);
  const float* src = ctx + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * E;
  for (int i = threadIdx.x; i < E; i += blockDim.x)
    cs[(i / (D * D)) * kStride + i % (D * D)] = src[i];
  __syncthreads();
  const float* mine = cs + hl * kStride + vt * 4;  // row k at mine + k D
  float4 creg[kRegs ? D : 1];
  if constexpr (kRegs) {
#pragma unroll
    for (int k = 0; k < D; ++k)
      creg[k] = *reinterpret_cast<const float4*>(mine + k * D);
  }

  const int n0 = blockIdx.x * block;
  const int n1 = min(N, n0 + block);
  const size_t head =
      (size_t)blockIdx.z * N * C + (blockIdx.y * Hg + hl) * D + vt * 4;
  const T* qp = queries + head;
  T* op = out + head;
  // every lane of a warp runs every step (the shuffles take them all); a
  // token past the end is computed on the last token's logits, not stored
  Raw qr[kU];
  auto fetch = [&](int base) {
#pragma unroll
    for (int u = 0; u < kU; ++u)
      qr[u] = Quad<T>::raw(
          qp + (size_t)min(base + u * lanes + lane, n1 - 1) * C);
  };
  fetch(n0);
  for (int base = n0; base < n1; base += kU * lanes) {
    Raw cur[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) cur[u] = qr[u];
    if (base + kU * lanes < n1) fetch(base + kU * lanes);
    // each token's weights: the exponentials of the thread's 4 logits over
    // the head's sum
    float w[kU][4];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const float4 q = Quad<T>::f32(cur[u]);
      float moff = 0.f;
      if (with_max) {
        float mq = fmaxf(fmaxf(q.x, q.y), fmaxf(q.z, q.w));
#pragma unroll
        for (int o = kT / 2; o > 0; o /= 2)
          mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, o, kT));
        moff = mq * kLog2e;
      }
      w[u][0] = exp_off(q.x, moff);
      w[u][1] = exp_off(q.y, moff);
      w[u][2] = exp_off(q.z, moff);
      w[u][3] = exp_off(q.w, moff);
      float sum = (w[u][0] + w[u][1]) + (w[u][2] + w[u][3]);
#pragma unroll
      for (int o = kT / 2; o > 0; o /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, o, kT);
      const float inv = 1.f / sum;
#pragma unroll
      for (int i = 0; i < 4; ++i) w[u][i] *= inv;
    }
    // the product: each context row read once for the step's tokens, each
    // weight passed from the thread that holds it
    float4 o[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) o[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int from = 0; from < kT; ++from) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = from * 4 + i;
        float4 c;
        if constexpr (kRegs) {
          c = creg[k];
        } else {
          c = *reinterpret_cast<const float4*>(mine + k * D);
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const float wk =
              kT > 1 ? __shfl_sync(0xffffffffu, w[u][i], from, kT) : w[u][i];
          o[u].x = fmaf(wk, c.x, o[u].x);
          o[u].y = fmaf(wk, c.y, o[u].y);
          o[u].z = fmaf(wk, c.z, o[u].z);
          o[u].w = fmaf(wk, c.w, o[u].w);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = base + u * lanes + lane;
      if (t < n1) Quad<T>::store(op + (size_t)t * C, o[u]);
    }
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T, int D>
int launch(bool keys_max, bool queries_max, const void* keys,
           const void* queries, const void* values, void* out, float* work,
           int B, int N, int H, int Hg, int chunk, int block,
           cudaStream_t s) {
  constexpr int kT = D / 4;
  const int G = H / Hg;
  const int rows = Hg * D;
  const int E = rows * D;
  const int chunks = ceil_div(N, chunk);
  const int blocks = ceil_div(N, block);
  const int per_lane = Hg * kT * (D / kVr<D>);
  const int lanes = kThreads / per_lane;
  const int per_lane_a = Hg * kT;
  const int lanes_a = kThreads / per_lane_a;
  float* ctx = work;
  float* pacc = ctx + (size_t)B * G * E;
  float* pm = pacc + (size_t)B * G * chunks * E;
  float* ps = pm + (size_t)B * G * chunks * rows;
  const T* k = static_cast<const T*>(keys);
  const T* v = static_cast<const T*>(values);
  const dim3 grid(chunks, G, B);
  const size_t smem = (2 * lanes * rows + lanes * E + 2 * rows) * sizeof(float);
  attend_context<T, D><<<grid, lanes * per_lane, smem, s>>>(
      k, v, ctx, pacc, pm, ps, N, H, Hg, chunk, keys_max);
  int err = cudaGetLastError();
  if (err != 0) return err;
  if (chunks > 1) {
    const dim3 cgrid(ceil_div(E, kThreads), B * G);
    const size_t csmem = 2 * (kThreads / D + 1) * sizeof(float);
    attend_combine<<<cgrid, kThreads, csmem, s>>>(pacc, pm, ps, ctx, rows, D,
                                                  chunks);
    err = cudaGetLastError();
    if (err != 0) return err;
  }
  const dim3 agrid(blocks, G, B);
  const size_t asmem = Hg * kApplyStride<D> * sizeof(float);
  attend_apply<T, D><<<agrid, lanes_a * per_lane_a, asmem, s>>>(
      static_cast<const T*>(queries), ctx, static_cast<T*>(out), N, H, Hg,
      block, queries_max);
  return cudaGetLastError();
}

template <typename T>
int launch_d(int D, bool keys_max, bool queries_max, const void* keys,
             const void* queries, const void* values, void* out, float* work,
             int B, int N, int H, int Hg, int chunk, int block,
             cudaStream_t s) {
  switch (D) {
    case 4:
      return launch<T, 4>(keys_max, queries_max, keys, queries, values, out,
                          work, B, N, H, Hg, chunk, block, s);
    case 8:
      return launch<T, 8>(keys_max, queries_max, keys, queries, values, out,
                          work, B, N, H, Hg, chunk, block, s);
    case 16:
      return launch<T, 16>(keys_max, queries_max, keys, queries, values, out,
                           work, B, N, H, Hg, chunk, block, s);
    case 32:
      return launch<T, 32>(keys_max, queries_max, keys, queries, values, out,
                           work, B, N, H, Hg, chunk, block, s);
    case 64:
      return launch<T, 64>(keys_max, queries_max, keys, queries, values, out,
                           work, B, N, H, Hg, chunk, block, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The f32 workspace ``work`` that a call needs, in floats: the context
// (B H D D) and, where the tokens take more than one chunk, the chunks'
// partials; -1 for a plan this file refuses.
extern "C" long long umt_attend_work(int B, int N, int H, int D, int Hg,
                                     int chunk) {
  if (B < 1 || B > 65535 || N < 1 || H < 1 || Hg < 1 || H % Hg != 0 ||
      (long long)B * (H / Hg) > 65535 || chunk < 1 || D < 4 || D > 64 ||
      (D & (D - 1)) != 0 ||
      kThreads % (Hg * (D / 4) * (D >= 8 ? D / 8 : 1)) != 0)
    return -1;
  const long long units = (long long)B * (H / Hg);
  const long long rows = (long long)Hg * D;
  const long long chunks = ceil_div(N, chunk);
  long long floats = units * rows * D;
  if (chunks > 1) floats += units * chunks * (rows * D + 2 * rows);
  return floats;
}

// dtype: 0 = float32, 1 = bfloat16.  keys, queries, values and out (B, N,
// C = H D) in that type; work umt_attend_work(...) f32 floats.  keys_max
// and queries_max: 1 subtracts the max in that softmax ("window",
// "slice"), 0 does not ("nomax").  Hg heads a block (H % Hg == 0, Hg
// (D/4) (D/V) divides 256, B H / Hg <= 65535), chunk tokens a context block and
// block tokens an apply block.  Preconditions checked by the Python wrapper: every tensor
// contiguous, 16-byte aligned and on one device.  Returns the CUDA error
// code of the launches (0 on success).
extern "C" int umt_attend(int dtype, int keys_max, int queries_max,
                          const void* keys, const void* queries,
                          const void* values, void* out, void* work, int B,
                          int N, int H, int D, int Hg, int chunk, int block,
                          void* stream) {
  if (umt_attend_work(B, N, H, D, Hg, chunk) < 0 || block < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  if (dtype == 0)
    return launch_d<float>(D, keys_max, queries_max, keys, queries, values,
                           out, w, B, N, H, Hg, chunk, block, s);
  if (dtype == 1)
    return launch_d<bf16>(D, keys_max, queries_max, keys, queries, values,
                          out, w, B, N, H, Hg, chunk, block, s);
  return cudaErrorInvalidValue;
}
