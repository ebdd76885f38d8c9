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
// up2 is the align-corners 2x bilinear upsample (bf16: with the JAX
// package's bf16 weights) and xc carries phase-major channels
// ((2*(y&1) + (x&1)) * Cu + c).  All tensors are NHWC and contiguous;
// arithmetic is f32 whatever the storage type.
//
// What bounds it: bytes, and at dec4 nearly as much the f32 work of each z
// element (three two-tap lerps, the fold and an expm1).  Per image at the
// flagship's shapes in bf16 it reads se_fm (or the image), skip_h, xc and
// disp_h once and writes cat once: 5.85 MB at dec2 (64x128, Cso 128, Cu
// 32), 11.86 MB at dec3 (128x256, Cso 64, Cu 16), 16.78 MB at dec4
// (256x512, Cso 32, Cu 8, fold cf=3).
//
// Design: the row kernel of decoder_rows.cuh in its kAssembleZ mode — a
// block per output row pair, its skip rows staged by bulk copies, 16-byte
// loads and stores, each output row assembled in shared memory and written
// once, and the SE mean finished by the last block of each batch in a
// fixed order (deterministic, no second launch).  The TPU design (batch in
// lanes, tens-of-MB VMEM blocks) does not carry over.

#include "decoder_rows.cuh"

// The plan (cols, halo_cols, threads, vec, smem) comes from
// ops/decoder_fused.py::plan_rows; the kernel re-checks it.  cf > 0 selects
// the in-kernel fold (se is then the raw (B, H, W, cf) feature map and kfm
// (cf, cso) f32); cd == 0 means no disparity input; count is B zeroed
// int32.  Returns the CUDA error code of the launch (0 on success).
extern "C" int umt_assemble_z(int dtype, const void* se, const void* kfm,
                              const void* skip, const void* xc,
                              const void* disp, const void* bias,
                              const void* taps, void* cat, void* partial,
                              void* mean, void* count, int B, int H, int W,
                              int cso, int cu, int cd, int cf, int cols,
                              int halo_cols, int threads, int vec, int smem,
                              void* stream) {
  const umt::RowArgs a{se, static_cast<const float*>(kfm), skip, xc, disp,
                       static_cast<const float*>(bias), nullptr,
                       static_cast<const int4*>(taps), cat,
                       static_cast<float*>(partial), static_cast<float*>(mean),
                       static_cast<int*>(count), H, W, cso, cu, cd, cf, cols,
                       halo_cols};
  return umt::dispatch_rows<umt::kAssembleZ>(
      dtype, a, B, threads, vec, smem, static_cast<cudaStream_t>(stream));
}
