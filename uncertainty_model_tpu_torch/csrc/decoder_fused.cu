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
// deterministic order (a (B, H, Cso) partial, then an ordered pass).
//
// What bounds them: bytes (per image at the flagship's fused stages in
// bf16).  gate_z reads and writes only the z block: 2 * 2 * H*W*Cso bytes,
// 4.2, 8.4 and 16.8 MB at dec2, dec3 and dec4; each pixel's z block is a
// strided run of Cso channels of a Ccat-channel row (64 of 88 bytes at
// dec4), so part of every sector it touches is wasted.  se_squeeze reads
// se_fm (or the image) and skip_h: 2.6, 5.2 and 2.9 MB (dec4 folds a
// 3-channel image and may be bound by the fold's operations instead).
// assemble moves what assemble_z does.
//
// Design: gate_z has assemble_z's block shape — one block per (batch,
// row), blockDim a multiple of Cso, each thread one channel with its gate
// in a register, contiguous channels per warp.

#include "decoder_rows.cuh"

namespace {

template <typename T>
__global__ void gate_z_rows(T* __restrict__ cat, const T* __restrict__ gates,
                            int H, int W, int ccat, int cso) {
  const int y = blockIdx.x;
  const int b = blockIdx.y;
  const int c = threadIdx.x % cso;
  const float g = umt::Io<T>::load(gates + (size_t)b * cso + c);
  T* row = cat + ((size_t)b * H + y) * W * ccat;
  for (int t = threadIdx.x; t < W * cso; t += blockDim.x) {
    T* p = row + (size_t)(t / cso) * ccat + c;
    umt::Io<T>::store(p, __fmul_rn(umt::Io<T>::load(p), g));
  }
}

template <typename T>
cudaError_t launch_gate_z(void* cat, const void* gates, int B, int H, int W,
                          int ccat, int cso, cudaStream_t stream) {
  gate_z_rows<T><<<dim3(H, B), umt::row_threads(cso), 0, stream>>>(
      static_cast<T*>(cat), static_cast<const T*>(gates), H, W, ccat, cso);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the CUDA error code of the
// launches (0 on success).  Preconditions (checked by the Python wrappers):
// 1 <= cso <= 1024, H and W even for the row kernels, every pointer on one
// device, gates (B, cso) in the storage type.

extern "C" int umt_gate_z(int dtype, void* cat, const void* gates, int B,
                          int H, int W, int ccat, int cso, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_gate_z<float>(cat, gates, B, H, W, ccat, cso, s);
  if (dtype == 1) {
    return launch_gate_z<__nv_bfloat16>(cat, gates, B, H, W, ccat, cso, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" int umt_se_squeeze(int dtype, const void* se, const void* kfm,
                              const void* skip, const void* bias,
                              const void* taps, const void* fracs,
                              void* partial, void* mean, int B, int H, int W,
                              int cso, int cf, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return umt::launch_rows<float, umt::kSqueeze>(
        se, kfm, skip, nullptr, nullptr, bias, nullptr, taps, fracs, nullptr,
        partial, mean, B, H, W, cso, 0, 0, cf, s);
  }
  if (dtype == 1) {
    return umt::launch_rows<__nv_bfloat16, umt::kSqueeze>(
        se, kfm, skip, nullptr, nullptr, bias, nullptr, taps, fracs, nullptr,
        partial, mean, B, H, W, cso, 0, 0, cf, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" int umt_assemble(int dtype, const void* se, const void* kfm,
                            const void* skip, const void* gates,
                            const void* xc, const void* disp,
                            const void* bias, const void* taps,
                            const void* fracs, void* cat, int B, int H, int W,
                            int cso, int cu, int cd, int cf, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return umt::launch_rows<float, umt::kAssembleGated>(
        se, kfm, skip, xc, disp, bias, gates, taps, fracs, cat, nullptr,
        nullptr, B, H, W, cso, cu, cd, cf, s);
  }
  if (dtype == 1) {
    return umt::launch_rows<__nv_bfloat16, umt::kAssembleGated>(
        se, kfm, skip, xc, disp, bias, gates, taps, fracs, cat, nullptr,
        nullptr, B, H, W, cso, cu, cd, cf, s);
  }
  return cudaErrorInvalidValue;
}
