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
// Design: the row kernel of decoder_rows.cuh in its kAssembleZ mode — one
// block per (batch, output row), threads on contiguous NHWC channels, so
// loads and stores coalesce.  The TPU design (batch in lanes, tens-of-MB
// VMEM blocks) does not carry over.  The SE mean uses no atomics: a
// (B, H, Cso) f32 partial, then an ordered pass over H; it is
// deterministic, and sums z as stored, as the plain version does.

#include "decoder_rows.cuh"

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
    return umt::launch_rows<float, umt::kAssembleZ>(
        se, kfm, skip, xc, disp, bias, nullptr, taps, fracs, cat, partial,
        mean, B, H, W, cso, cu, cd, cf, s);
  }
  if (dtype == 1) {
    return umt::launch_rows<__nv_bfloat16, umt::kAssembleZ>(
        se, kfm, skip, xc, disp, bias, nullptr, taps, fracs, cat, partial,
        mean, B, H, W, cso, cu, cd, cf, s);
  }
  return cudaErrorInvalidValue;
}
