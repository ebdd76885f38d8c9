// The row kernel of the fused decoder-stage glue, shared by assemble_z
// (assemble_z.cu) and by se_squeeze and the gated assemble
// (decoder_fused.cu).  Each instantiation compiles only its own mode.
//
// One block per (batch, output row pair 2i and 2i+1, column tile); the
// tiling is planned in Python (ops/decoder_fused.py::plan_rows) and
// checked here against the same shared-memory count.  Per block:
//
//   1. the three half-resolution skip rows the pair reads (i-1, i, i+1,
//      clamped), over the tile's columns and their 1-column halo, come into
//      shared memory by bulk asynchronous copies on one mbarrier (or by
//      thread copies where a row is not 16-byte aligned); the disparity
//      rows likewise; the fold's k_fm too;
//   2. for each output row, every thread takes V contiguous z channels of
//      one pixel (16 bytes: 8 bf16 or 4 f32), with its bias, gate and SE
//      sums fixed in registers; se_fm is read from device memory with
//      16-byte loads, U pixels' worth in flight; the 2x taps of each row
//      and column come from the per-shape tap table;
//   3. z, the pixel-shuffled xc and the upsampled disparity are assembled
//      in a shared-memory copy of the output row, which is then written
//      once with coalesced 16-byte stores (narrower where the row is not
//      16-byte aligned);
//   4. the SE sums go through shared memory into a (B, blocks, Cso) f32
//      partial; the last block of a batch to finish (an atomic count) sums
//      the partials in a fixed order, so the mean is deterministic.
//
// The z block is z = elu(se + up2(skip_h) + bias) rounded to the storage
// type, where se is se_fm, or sum_ci fm[ci] * k_fm[ci, c] folded in f32 in
// order.  Each operation is rounded on its own, as the plain PyTorch
// version computes it, so the two agree bit for bit.  The upsample reads
// the per-shape tap table (ops/decoder_fused.py::_tap_tables): in f32 the
// exact lerp x[lo] + frac (x[hi] - x[lo]); in bf16 the JAX package's
// weights, x[lo] bf16(1 - frac) + x[hi] bf16(frac).
#pragma once

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace umt {

enum RowMode {
  kAssembleZ = 0,      // write [z | xup | disp], sum z
  kSqueeze = 1,        // sum z, write nothing else
  kAssembleGated = 2,  // write [z * gate | xup | disp]
};

constexpr int kRowPixelsInFlight = 4;  // U: se_fm loads in flight a thread
constexpr int kFoldInFlight = 4;       // folded channels a pixel loaded early
// blocks an SM a row block of 16-byte vectors is sized for (up to 128
// registers a thread); one channel a thread takes up to 1,024 threads
constexpr int kRowBlocksPerSM = 2;

struct RowArgs {
  const void* se;      // (B, H, W, cf or cso)
  const float* kfm;    // (cf, cso) or null
  const void* skip;    // (B, H/2, W/2, cso)
  const void* xc;      // (B, H/2, W/2, 4 cu)
  const void* disp;    // (B, H/2, W/2, cd) or null
  const float* bias;   // (cso)
  const void* gates;   // (B, cso), storage type
  const int4* taps;    // (H + W): lo, hi, weight a, weight b (f32 bits)
  void* cat;           // (B, H, W, cso + cu + cd)
  float* partial;      // (B, blocks a batch, cso)
  float* mean;         // (B, cso)
  int* count;          // (B), zero
  int H, W, cso, cu, cd, cf;
  int cols;            // output columns per tile
  int halo_cols;       // staged half-resolution columns per tile, at most
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// shared-memory layout of a block, in bytes from the start: skip rows,
// disparity rows, the output row, k_fm, the SE sums, the mbarrier
struct RowSmem {
  size_t skip, disp, out, kfm, red, bar, total;
  __host__ __device__ RowSmem(int mode, int itemsize, int cols, int halo_cols,
                              int cso, int cu, int cd, int cf, int threads,
                              int vec) {
    const bool writes = mode != kSqueeze;
    skip = 0;
    disp = skip + align16((size_t)3 * halo_cols * cso * itemsize);
    out = disp + (writes ? align16((size_t)3 * halo_cols * cd * itemsize) : 0);
    kfm = out + (writes ? align16((size_t)cols * (cso + cu + cd) * itemsize) : 0);
    red = kfm + align16((size_t)cf * cso * 4);
    bar = red + (mode != kAssembleGated ? align16((size_t)threads * vec * 4) : 0);
    total = bar + 16;
  }
};

// elu with expm1f evaluated whatever the sign, so that the compiler can
// interleave the independent evaluations of a thread's channels instead of
// branching around each; the same value as common.cuh's elu
__device__ __forceinline__ float elu_unbranched(float v) {
  const float e = expm1f(v);
  return v > 0.f ? v : e;
}

// the 2x tap: f32 the exact lerp (wa = frac); bf16 the JAX package's
// two-tap form (wa = bf16(1 - frac), wb = bf16(frac)); each operation
// rounded on its own
template <typename T>
__device__ __forceinline__ float tap2(float lo, float hi, float wa, float wb) {
  if constexpr (std::is_same<T, float>::value) {
    return lerp(lo, hi, wa);
  } else {
    return __fadd_rn(__fmul_rn(lo, wa), __fmul_rn(hi, wb));
  }
}

// V values of the storage type at p as floats, read 16 bytes at a time
// where V values fill that (p then 16-byte aligned): bf16 V = 8, f32 V a
// multiple of 4
template <typename T, int V>
__device__ __forceinline__ void unpack(const T* p, float (&v)[V]) {
  if constexpr (std::is_same<T, float>::value && V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + i);
      v[i] = u.x; v[i + 1] = u.y; v[i + 2] = u.z; v[i + 3] = u.w;
    }
  } else if constexpr (V * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = Io<T>::load(p + i);
  }
}

// the bits of lane e of a 16-byte vector held as four 32-bit words, as a
// float, and back (bf16: two lanes a word)
template <typename T>
__device__ __forceinline__ float lane_get(const uint32_t (&w)[4], int e) {
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(w[e]);
  } else {
    return __uint_as_float((e & 1) ? (w[e >> 1] & 0xffff0000u) : (w[e >> 1] << 16));
  }
}

template <typename T>
__device__ __forceinline__ void lane_set(uint32_t (&w)[4], int e, float v) {
  if constexpr (std::is_same<T, float>::value) {
    w[e] = __float_as_uint(v);
  } else {
    const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    w[e >> 1] = (e & 1) ? ((w[e >> 1] & 0xffffu) | (b << 16))
                        : ((w[e >> 1] & 0xffff0000u) | b);
  }
}

// V values loaded from device memory by the read-only path: one 16-byte
// load where V values fill it, else V loads
template <typename T, int V, bool Wide = V * sizeof(T) == 16>
struct Raw {
  T v[V];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
  __device__ __forceinline__ void to_floats(float (&f)[V]) const {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = Io<T>::load(v + i);
  }
};

template <typename T, int V>
struct Raw<T, V, true> {
  uint4 u;
  __device__ __forceinline__ void load(const T* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void to_floats(float (&f)[V]) const {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = lane_get<T>(w, i);
  }
};

// copy n elements of T from device memory to shared memory by the block's
// threads (the path for rows that are not 16-byte aligned)
template <typename T>
__device__ __forceinline__ void thread_copy(T* dst, const T* src, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = src[k];
}

// write `bytes` from shared memory (16-byte aligned) to device memory with
// the widest stores both ends allow
__device__ __forceinline__ void store_row(char* dst, const char* src,
                                          size_t bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if ((a | bytes) % 16 == 0) {
    for (size_t k = threadIdx.x; k < bytes / 16; k += blockDim.x) {
      reinterpret_cast<uint4*>(dst)[k] = reinterpret_cast<const uint4*>(src)[k];
    }
  } else if ((a | bytes) % 8 == 0) {
    for (size_t k = threadIdx.x; k < bytes / 8; k += blockDim.x) {
      reinterpret_cast<uint2*>(dst)[k] = reinterpret_cast<const uint2*>(src)[k];
    }
  } else if ((a | bytes) % 4 == 0) {
    for (size_t k = threadIdx.x; k < bytes / 4; k += blockDim.x) {
      reinterpret_cast<uint32_t*>(dst)[k] =
          reinterpret_cast<const uint32_t*>(src)[k];
    }
  } else {
    for (size_t k = threadIdx.x; k < bytes / 2; k += blockDim.x) {
      reinterpret_cast<uint16_t*>(dst)[k] =
          reinterpret_cast<const uint16_t*>(src)[k];
    }
  }
}

// V values into shared memory at o (V-aligned), rounded to T: in bf16 two
// or four at a time where the row's channel count allows
template <typename T, int V>
__device__ __forceinline__ void put(T* o, const float (&v)[V], int ccat) {
  if constexpr (V == 8 && std::is_same<T, __nv_bfloat16>::value) {
    uint32_t w[V / 2];
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    if (ccat % 4 == 0) {
#pragma unroll
      for (int i = 0; i < V / 4; ++i) {
        reinterpret_cast<uint2*>(o)[i] = make_uint2(w[2 * i], w[2 * i + 1]);
      }
      return;
    }
    if (ccat % 2 == 0) {
#pragma unroll
      for (int i = 0; i < V / 2; ++i) reinterpret_cast<uint32_t*>(o)[i] = w[i];
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) Io<T>::store(o + e, v[e]);
}

template <typename T, int Mode, int V>
__global__ void __launch_bounds__(V == 1 ? 1024 : 256,
                                  V == 1 ? 1 : kRowBlocksPerSM)
decoder_rows(const RowArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x, pair = blockIdx.y, b = blockIdx.z;
  const int H = a.H, W = a.W, cso = a.cso, cu = a.cu, cd = a.cd, cf = a.cf;
  const int h2 = H / 2, w2 = W / 2, ccat = cso + cu + cd;
  const int G = cso / V;  // threads a pixel's z block takes
  const RowSmem L(Mode, sizeof(T), a.cols, a.halo_cols, cso, cu, cd, cf,
                  blockDim.x, V);
  T* S = reinterpret_cast<T*>(smem + L.skip);
  T* D = reinterpret_cast<T*>(smem + L.disp);
  T* O = reinterpret_cast<T*>(smem + L.out);
  float* K = reinterpret_cast<float*>(smem + L.kfm);
  float* red = reinterpret_cast<float*>(smem + L.red);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);

  const int c0 = tile * a.cols;
  const int wcur = min(a.cols, W - c0);
  const int s0 = max(c0 / 2 - 1, 0);
  const int ncur = min((c0 + wcur) / 2, w2 - 1) - s0 + 1;
  const int r0 = max(pair - 1, 0);
  const int hs = a.halo_cols;  // row stride of the staged rows, in columns

  // 1. stage the skip rows (bulk copies on the mbarrier), the disparity
  // rows and k_fm
  const T* skip = static_cast<const T*>(a.skip);
  // 16-byte aligned skip rows come by bulk copies, others by the threads
  const bool bulk = reinterpret_cast<uintptr_t>(skip) % 16 == 0 &&
                    cso * sizeof(T) % 16 == 0;
  if (bulk && threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (bulk && threadIdx.x == 0) {
    const uint32_t bytes = (uint32_t)(ncur * cso * sizeof(T));
    mbar_arrive_expect_tx(bar, 3 * bytes);
    for (int k = 0; k < 3; ++k) {
      const int r = min(r0 + k, h2 - 1);
      bulk_copy_g2s(S + (size_t)k * hs * cso,
                    skip + ((size_t)(b * h2 + r) * w2 + s0) * cso, bytes, bar);
    }
  }
  if (!bulk) {
    for (int k = 0; k < 3; ++k) {
      const int r = min(r0 + k, h2 - 1);
      thread_copy(S + (size_t)k * hs * cso,
                  skip + ((size_t)(b * h2 + r) * w2 + s0) * cso, ncur * cso);
    }
  }
  if (Mode != kSqueeze && cd > 0) {
    const T* disp = static_cast<const T*>(a.disp);
    for (int k = 0; k < 3; ++k) {
      const int r = min(r0 + k, h2 - 1);
      thread_copy(D + (size_t)k * hs * cd,
                  disp + ((size_t)(b * h2 + r) * w2 + s0) * cd, ncur * cd);
    }
  }
  for (int k = threadIdx.x; k < cf * cso; k += blockDim.x) K[k] = a.kfm[k];

  // this thread's z channels, fixed for the block (blockDim % G == 0)
  const int cg = (threadIdx.x % G) * V;
  float bias[V], gate[V], acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    bias[e] = a.bias[cg + e];
    gate[e] = Mode == kAssembleGated
                  ? Io<T>::load(static_cast<const T*>(a.gates) + (size_t)b * cso + cg + e)
                  : 0.f;
    acc[e] = 0.f;
  }
  __syncthreads();
  if (bulk) mbar_wait(bar, 0);

  const T* se = static_cast<const T*>(a.se);
  const int4* ctaps = a.taps + H;
  const int items = wcur * G;
  const int step = blockDim.x;
  for (int py = 0; py < 2; ++py) {
    const int y = 2 * pair + py;
    const size_t row = (size_t)b * H + y;
    const int4 ty = __ldg(a.taps + y);
    const float wya = __int_as_float(ty.z), wyb = __int_as_float(ty.w);

    const T* Slo = S + (size_t)(ty.x - r0) * hs * cso;
    const T* Shi = S + (size_t)(ty.y - r0) * hs * cso;

    // 2. the z block: U pixels' taps and se_fm (or the folded feature
    // map's channels) loaded first, then computed
    for (int base = threadIdx.x; base < items; base += kRowPixelsInFlight * step) {
      Raw<T, V> raw[kRowPixelsInFlight];
      int4 tx[kRowPixelsInFlight];
      float fmv[kRowPixelsInFlight][kFoldInFlight];
#pragma unroll
      for (int u = 0; u < kRowPixelsInFlight; ++u) {
        const int it = base + u * step;
        if (it < items) {
          const int x = c0 + it / G;
          tx[u] = __ldg(ctaps + x);
          if (cf == 0) {
            raw[u].load(se + (row * W + x) * cso + cg);
          } else {
#pragma unroll
            for (int ci = 0; ci < kFoldInFlight; ++ci) {
              if (ci < cf) fmv[u][ci] = Io<T>::load(se + (row * W + x) * cf + ci);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kRowPixelsInFlight; ++u) {
        const int it = base + u * step;
        if (it >= items) break;
        const int xl = it / G;
        const float wxa = __int_as_float(tx[u].z), wxb = __int_as_float(tx[u].w);
        float f[V];
        if (cf == 0) {
          raw[u].to_floats(f);
        } else {
          // the fold, in order: f = fm[0] k[0] + fm[1] k[1] + ...
          const T* fm = se + (row * W + c0 + xl) * cf;
#pragma unroll
          for (int ci = 0; ci < kFoldInFlight; ++ci) {
            if (ci < cf) {
              float k[V];
              unpack<float, V>(K + ci * cso + cg, k);
#pragma unroll
              for (int e = 0; e < V; ++e) {
                const float t = __fmul_rn(fmv[u][ci], k[e]);
                f[e] = ci == 0 ? t : __fadd_rn(f[e], t);
              }
            }
          }
          for (int ci = kFoldInFlight; ci < cf; ++ci) {
            const float fc = Io<T>::load(fm + ci);
            float k[V];
            unpack<float, V>(K + ci * cso + cg, k);
#pragma unroll
            for (int e = 0; e < V; ++e) f[e] = __fadd_rn(f[e], __fmul_rn(fc, k[e]));
          }
        }
        float s00[V], s01[V], s10[V], s11[V];
        unpack<T, V>(Slo + (size_t)(tx[u].x - s0) * cso + cg, s00);
        unpack<T, V>(Shi + (size_t)(tx[u].x - s0) * cso + cg, s10);
        unpack<T, V>(Slo + (size_t)(tx[u].y - s0) * cso + cg, s01);
        unpack<T, V>(Shi + (size_t)(tx[u].y - s0) * cso + cg, s11);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float ua = tap2<T>(s00[e], s10[e], wya, wyb);
          const float ub = tap2<T>(s01[e], s11[e], wya, wyb);
          const float up = tap2<T>(ua, ub, wxa, wxb);
          const float z = Io<T>::round(elu_unbranched(__fadd_rn(__fadd_rn(f[e], up), bias[e])));
          if (Mode != kAssembleGated) acc[e] += z;
          f[e] = Mode == kAssembleGated ? __fmul_rn(z, gate[e]) : z;
        }
        if (Mode != kSqueeze) put<T, V>(O + (size_t)xl * ccat + cg, f, ccat);
      }
    }
    if (Mode == kSqueeze) continue;

    // 3. the upsample block (pixel shuffle of elu(xc), phase-major
    // channels) and the disparity block, then the row out
    {
      const T* xr = static_cast<const T*>(a.xc) + ((size_t)b * h2 + pair) * w2 * 4 * cu;
      if (V > 1 && cu % V == 0 && reinterpret_cast<uintptr_t>(xr) % 16 == 0) {
        const int gu = cu / V;
        for (int it = threadIdx.x; it < wcur * gu; it += step) {
          const int xl = it / gu;
          const int c = (it - xl * gu) * V;
          const int x = c0 + xl;
          Raw<T, V> r;
          r.load(xr + (size_t)(x >> 1) * 4 * cu + (py * 2 + (x & 1)) * cu + c);
          float v[V];
          r.to_floats(v);
#pragma unroll
          for (int e = 0; e < V; ++e) v[e] = elu_unbranched(v[e]);
          put<T, V>(O + (size_t)xl * ccat + cso + c, v, ccat);
        }
      } else {
        for (int it = threadIdx.x; it < wcur * cu; it += step) {
          const int xl = it / cu;
          const int c = it - xl * cu;
          const int x = c0 + xl;
          const float v = Io<T>::load(xr + (size_t)(x >> 1) * 4 * cu + (py * 2 + (x & 1)) * cu + c);
          Io<T>::store(O + (size_t)xl * ccat + cso + c, elu(v));
        }
      }
    }
    if (cd > 0) {
      const T* Dlo = D + (size_t)(ty.x - r0) * hs * cd;
      const T* Dhi = D + (size_t)(ty.y - r0) * hs * cd;
      for (int it = threadIdx.x; it < wcur * cd; it += step) {
        const int xl = it / cd;
        const int c = it - xl * cd;
        const int4 tx = __ldg(ctaps + c0 + xl);
        const int xa = (tx.x - s0) * cd + c, xb = (tx.y - s0) * cd + c;
        const float ua = tap2<T>(Io<T>::load(Dlo + xa), Io<T>::load(Dhi + xa), wya, wyb);
        const float ub = tap2<T>(Io<T>::load(Dlo + xb), Io<T>::load(Dhi + xb), wya, wyb);
        Io<T>::store(O + (size_t)xl * ccat + cso + cu + c,
                     tap2<T>(ua, ub, __int_as_float(tx.z), __int_as_float(tx.w)));
      }
    }
    __syncthreads();
    store_row(reinterpret_cast<char*>(static_cast<T*>(a.cat) + (row * W + c0) * ccat),
              reinterpret_cast<const char*>(O), (size_t)wcur * ccat * sizeof(T));
    __syncthreads();
  }
  if (Mode == kAssembleGated) return;

  // 4. the SE sums: this block's, then the batch's mean by its last block
  const int blocks = gridDim.x * gridDim.y;
  const int slot = blockIdx.y * gridDim.x + blockIdx.x;
#pragma unroll
  for (int e = 0; e < V; ++e) red[threadIdx.x * V + e] = acc[e];
  __syncthreads();
  for (int c = threadIdx.x; c < cso; c += blockDim.x) {
    const int g = c / V, e = c - g * V;
    float s = 0.f;
    for (int k = g; k < (int)blockDim.x; k += G) s += red[k * V + e];
    a.partial[((size_t)b * blocks + slot) * cso + c] = s;
  }
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (threadIdx.x == 0) last = atomicAdd(a.count + b, 1) == blocks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // a fixed-order tree: `segs` threads a channel each sum a fixed run of
  // the partials in order, then one sums the runs in order
  const int segs = max(1, (int)blockDim.x / cso);
  const int run = (blocks + segs - 1) / segs;
  for (int t = threadIdx.x; t < segs * cso; t += blockDim.x) {
    const int c = t % cso, sg = t / cso;
    float s = 0.f;
    for (int k = sg * run; k < min(blocks, (sg + 1) * run); ++k) {
      s += __ldcg(a.partial + ((size_t)b * blocks + k) * cso + c);
    }
    red[t] = s;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cso; c += blockDim.x) {
    float s = 0.f;
    for (int sg = 0; sg < segs; ++sg) s += red[sg * cso + c];
    a.mean[(size_t)b * cso + c] = s / ((float)H * (float)W);
  }
}

// The row kernel's launch, the plan from Python re-checked: the block's
// threads a multiple of Cso / V, the shared memory the same count.
template <typename T, int Mode, int V>
cudaError_t launch_rows_v(const RowArgs& a, int B, int threads, int smem_bytes,
                          cudaStream_t stream) {
  if (a.cso % V != 0 || threads % (a.cso / V) != 0 || threads > 1024 ||
      a.cols < 2 || a.cols % 2 != 0 || a.halo_cols < min(a.cols / 2 + 2, a.W / 2)) {
    return cudaErrorInvalidConfiguration;
  }
  const RowSmem L(Mode, sizeof(T), a.cols, a.halo_cols, a.cso, a.cu, a.cd,
                  a.cf, threads, V);
  if ((size_t)smem_bytes != L.total) {
    return cudaErrorInvalidValue;
  }
  auto kernel = decoder_rows<T, Mode, V>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.W + a.cols - 1) / a.cols, a.H / 2, B);
  kernel<<<grid, threads, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

// vec: the z channels a thread takes, 16 / sizeof(T) or 1
template <typename T, int Mode>
cudaError_t launch_rows(const RowArgs& a, int B, int threads, int vec,
                        int smem_bytes, cudaStream_t stream) {
  if (vec == 1) return launch_rows_v<T, Mode, 1>(a, B, threads, smem_bytes, stream);
  if (vec == 16 / (int)sizeof(T)) {
    return launch_rows_v<T, Mode, 16 / sizeof(T)>(a, B, threads, smem_bytes, stream);
  }
  return cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16
template <int Mode>
cudaError_t dispatch_rows(int dtype, const RowArgs& a, int B, int threads,
                          int vec, int smem_bytes, cudaStream_t stream) {
  if (dtype == 0) {
    return launch_rows<float, Mode>(a, B, threads, vec, smem_bytes, stream);
  }
  if (dtype == 1) {
    return launch_rows<__nv_bfloat16, Mode>(a, B, threads, vec, smem_bytes,
                                            stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace umt
