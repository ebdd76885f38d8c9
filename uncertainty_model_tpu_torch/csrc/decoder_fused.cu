// The decoder pipelines' other glue kernels, for Hopper (sm_90a):
//
//   gate_z      replaces uncertainty_model_tpu/ops/pallas/decoder_fused.py
//               ::_gate_z_pallas (body _gate_kernel): cat[..., :Cso] *= gates,
//               in place, channels >= Cso untouched;
//   se_squeeze  replaces ::_se_squeeze_pallas (body _squeeze_kernel): the
//               (B, Cso) f32 mean over pixels of z = elu(se + up2(skip_h)
//               + bias), z never written;
//   assemble    replaces ::_assemble_pallas (body _assemble_kernel): the
//               concat tensor [z * gates | pixel_shuffle(elu(xc)) | up2(disp_h)]
//               written once, already gated.
//
// se_squeeze and assemble are the row kernel of decoder_rows.cuh (the one
// assemble_z runs) in its kSqueeze and kAssembleGated modes, so z is the
// same arithmetic in all three: assemble's z block is round(z * gate) with
// z as assemble_z stores it, and assemble(g) == gate_z(assemble_z(), g)
// bit for bit.  se_squeeze sums z as stored, like assemble_z, in the same
// deterministic order.
//
// What bounds them: bytes (per image at the flagship's fused stages in
// bf16).  gate_z reads and writes the z block, 2 * 2 * H*W*Cso bytes: 4.2,
// 8.4 and 16.8 MB at dec2, dec3 and dec4; but each pixel's z block is a
// run of Cso channels of a Ccat-channel pixel (64 of 88 bytes at dec4), and
// the gaps (72, 40, 24 bytes) are narrower than two 32-byte sectors at dec3
// and dec4, so the memory moves nearly the whole tensor there.  se_squeeze
// reads se_fm (or the image) and skip_h: 2.6, 5.2 and 2.9 MB (dec4 folds a
// 3-channel image and is bound by the z elements' f32 work instead).
// assemble moves what assemble_z does.
//
// gate_z's design: each batch's slab of the concat tensor is walked as one
// flat array of 16-byte vectors, cut into equal chunks, one a block, the
// grid as many blocks as the card holds at once (132 SMs on an H100).  A
// vector's first channel c0 (its flat index mod Ccat) is carried from
// vector to vector by a fixed step; the block first tabulates, in shared
// memory, for every c0 its lanes' gates and the mask of its z lanes, so a
// vector costs a table read and one multiply a lane.  Vectors without a z
// lane are skipped, a vector that straddles Cso is read whole and only its
// z lanes are stored; four vectors are in flight a thread.  A slab
// whose start is not 16-byte aligned takes its ragged head and tail
// element by element (ops/decoder_fused.py::gate_z_walk models the walk).

#include <algorithm>
#include <cstdint>

#include "decoder_rows.cuh"

namespace {

constexpr int kGateVectorsInFlight = 4;
constexpr int kGateThreads = 256;
constexpr size_t kGateMaxSmem = 232448;  // a block's shared memory on an H100

// the lanes of `mask` of a 16-byte vector held as four words, stored to p
// (16-byte aligned) in the widest aligned pieces the mask allows
template <typename T>
__device__ __forceinline__ void store_lanes(T* p, const uint32_t (&w)[4],
                                            unsigned mask) {
  constexpr int VE = 16 / sizeof(T);
  constexpr int LW = 4 / sizeof(T);  // lanes a word
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // 8-byte halves
    const unsigned hm = (mask >> (h * VE / 2)) & ((1u << (VE / 2)) - 1);
    if (hm == (1u << (VE / 2)) - 1) {
      reinterpret_cast<uint2*>(p)[h] = make_uint2(w[2 * h], w[2 * h + 1]);
      continue;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {  // words
      const int wi = 2 * h + q;
      const unsigned wm = (mask >> (wi * LW)) & ((1u << LW) - 1);
      if (wm == (1u << LW) - 1) {
        reinterpret_cast<uint32_t*>(p)[wi] = w[wi];
      } else if (LW == 2 && wm != 0) {
        umt::Io<T>::store(p + wi * LW + (wm == 2u),
                          umt::lane_get<T>(w, wi * LW + (wm == 2u)));
      }
    }
  }
}

// the bytes of gate_z's shared-memory tables for a Ccat-channel tensor: for
// each channel c0 a vector may start at, the gates of its lanes (f32) and
// the mask of its z lanes
template <typename T>
constexpr size_t gate_table_bytes(int ccat) {
  return (size_t)ccat * (16 / sizeof(T)) * 4 + (size_t)ccat;
}

// one batch's slab of n elements (H W Ccat) a grid row; chunk elements (a
// multiple of the vector's) a block
template <typename T>
__global__ void __launch_bounds__(kGateThreads)
gate_z_flat(T* __restrict__ cat, const T* __restrict__ gates, int n, int ccat,
            int cso, int chunk) {
  constexpr int VE = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  float* tab = reinterpret_cast<float*>(smem);        // [ccat][VE]
  unsigned char* lanes = smem + (size_t)ccat * VE * 4;  // [ccat]
  const int b = blockIdx.y;
  const T* gb = gates + (size_t)b * cso;
  for (int c0 = threadIdx.x; c0 < ccat; c0 += blockDim.x) {
    unsigned mask = 0;
    int c = c0;
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      float g = 0.f;
      if (c < cso) {
        mask |= 1u << e;
        g = umt::Io<T>::load(gb + c);
      }
      tab[c0 * VE + e] = g;
      if (++c == ccat) c = 0;
    }
    lanes[c0] = (unsigned char)mask;
  }
  __syncthreads();
  T* slab = cat + (size_t)b * n;
  const int lo = blockIdx.x * chunk;
  const int hi = min(lo + chunk, n);
  // slab + f is 16-byte aligned where (m + f) % VE == 0
  const int m = (int)((reinterpret_cast<uintptr_t>(slab) / sizeof(T)) % VE);
  const int a0 = min(lo + (VE - (m + lo) % VE) % VE, hi);
  const int a1 = max(hi - (m + hi) % VE, a0);
  // the ragged head and tail, element by element
  for (int k = threadIdx.x; k < 2 * VE; k += blockDim.x) {
    const int f = k < VE ? lo + k : a1 + k - VE;
    if ((k < VE && f >= a0) || f >= hi) continue;
    const int c = f % ccat;
    if (c < cso) umt::Io<T>::store(slab + f, __fmul_rn(umt::Io<T>::load(slab + f), tab[c * VE]));
  }

  // the vectors: a vector's first channel follows from the thread's
  // previous one by a fixed step; its lanes' gates and z mask come from
  // the tables
  const int nv = (a1 - a0) / VE;
  const int dc = (int)(((long long)blockDim.x * VE) % ccat);
  int cbase = (a0 + (int)threadIdx.x * VE) % ccat;
  for (int base = threadIdx.x; base < nv; base += kGateVectorsInFlight * blockDim.x) {
    uint4 v[kGateVectorsInFlight];
    unsigned mask[kGateVectorsInFlight];
    int c0[kGateVectorsInFlight];
#pragma unroll
    for (int u = 0; u < kGateVectorsInFlight; ++u) {
      const int k = base + u * blockDim.x;
      c0[u] = cbase;
      cbase += dc;
      if (cbase >= ccat) cbase -= ccat;
      mask[u] = k < nv ? lanes[c0[u]] : 0u;
      if (mask[u]) v[u] = *reinterpret_cast<const uint4*>(slab + a0 + k * VE);
    }
#pragma unroll
    for (int u = 0; u < kGateVectorsInFlight; ++u) {
      if (!mask[u]) continue;
      T* p = slab + a0 + (base + u * blockDim.x) * VE;
      const float* g = tab + c0[u] * VE;
      uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        umt::lane_set<T>(w, e, __fmul_rn(umt::lane_get<T>(w, e), g[e]));
      }
      if (mask[u] == (1u << VE) - 1) {
        *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
        // a vector that straddles Cso: its z lanes only, in aligned
        // pieces of 8, 4 or 2 bytes
        store_lanes<T>(p, w, mask[u]);
      }
    }
  }
}

// the grid: as many blocks as the card holds at once (132 SMs on an
// H100), shared out evenly over the batches' slabs
template <typename T>
cudaError_t launch_gate_z(void* cat, const void* gates, int B, int n, int ccat,
                          int cso, cudaStream_t stream) {
  const size_t smem = gate_table_bytes<T>(ccat);
  if (cso > ccat || n % ccat != 0 || smem > kGateMaxSmem) {
    return cudaErrorInvalidValue;
  }
  constexpr int VE = 16 / sizeof(T);
  auto kernel = gate_z_flat<T>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kGateThreads, smem);
  }
  if (err != cudaSuccess) return err;
  const int vectors = (n + VE - 1) / VE;
  const int most = (vectors + kGateThreads * kGateVectorsInFlight - 1) /
                   (kGateThreads * kGateVectorsInFlight);
  const int per_batch = std::max(1, std::min(most, sms * per_sm / B));
  const int chunk = (vectors + per_batch - 1) / per_batch * VE;
  kernel<<<dim3((n + chunk - 1) / chunk, B), kGateThreads, smem, stream>>>(
      static_cast<T*>(cat), static_cast<const T*>(gates), n, ccat, cso, chunk);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the CUDA error code of the
// launch (0 on success).  Preconditions (checked by the Python wrappers):
// 1 <= cso <= 1024, every pointer on one device, gates (B, cso) in the
// storage type; the plans come from ops/decoder_fused.py (plan_gate_z,
// plan_rows) and are re-checked here.

extern "C" int umt_gate_z(int dtype, void* cat, const void* gates, int B,
                          int n, int ccat, int cso, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_gate_z<float>(cat, gates, B, n, ccat, cso, s);
  if (dtype == 1) {
    return launch_gate_z<__nv_bfloat16>(cat, gates, B, n, ccat, cso, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" int umt_se_squeeze(int dtype, const void* se, const void* kfm,
                              const void* skip, const void* bias,
                              const void* taps, void* partial, void* mean,
                              void* count, int B, int H, int W, int cso,
                              int cf, int cols, int halo_cols, int threads,
                              int vec, int smem, void* stream) {
  const umt::RowArgs a{se, static_cast<const float*>(kfm), skip, nullptr,
                       nullptr, static_cast<const float*>(bias), nullptr,
                       static_cast<const int4*>(taps), nullptr,
                       static_cast<float*>(partial), static_cast<float*>(mean),
                       static_cast<int*>(count), H, W, cso, 0, 0, cf, cols,
                       halo_cols};
  return umt::dispatch_rows<umt::kSqueeze>(
      dtype, a, B, threads, vec, smem, static_cast<cudaStream_t>(stream));
}

extern "C" int umt_assemble(int dtype, const void* se, const void* kfm,
                            const void* skip, const void* gates,
                            const void* xc, const void* disp,
                            const void* bias, const void* taps, void* cat,
                            int B, int H, int W, int cso, int cu, int cd,
                            int cf, int cols, int halo_cols, int threads,
                            int vec, int smem, void* stream) {
  const umt::RowArgs a{se, static_cast<const float*>(kfm), skip, xc, disp,
                       static_cast<const float*>(bias), gates,
                       static_cast<const int4*>(taps), cat, nullptr, nullptr,
                       nullptr, H, W, cso, cu, cd, cf, cols, halo_cols};
  return umt::dispatch_rows<umt::kAssembleGated>(
      dtype, a, B, threads, vec, smem, static_cast<cudaStream_t>(stream));
}
