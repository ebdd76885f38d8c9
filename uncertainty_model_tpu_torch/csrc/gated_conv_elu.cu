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
// 128x256 down to 3x3 C=512 on 8x16) are 0.04-0.2 TFLOP a call.
//
// Design (bf16): an implicit GEMM on wgmma, warp-specialised and
// persistent (see the section below), against what held a simpler tiling
// back (PERF.md): weights re-read for every few pixels, staging that
// nothing overlaps, a halo of all C channels that bounds C.
//   - a 256-pixel tile (16 x 16 at the flagship's shapes; the planner in
//     ops/conv.py picks it) feeds each weight slice to 4x the pixels;
//   - the weights arrive by bulk (TMA) copies into a ring of slices, so
//     the consumers wait only when the ring runs dry;
//   - the K loop runs over 64-channel chunks, then taps: a chunk's halo
//     lands once and serves all k*k taps, and the next chunk is staged
//     while the current one is multiplied, so C no longer bounds shared
//     memory;
//   - mbarriers replace block-wide barriers; two consumer warpgroups keep
//     two wgmma groups each in flight; one block an SM walks its tiles,
//     so a tile's staging overlaps the previous tile's MMAs and epilogue.
// What bounds it now: the gated stager (the raw inputs' cp.async ring and
// the bf16x2 gated sums) where n > 1, then the MMA loop itself, and the
// epilogue (bias, ELU, stores: a large share at the small native convs).
// Shared memory (ring, two halo chunks, the gated raw-input ring, 1 KB
// slack), at the flagship's shapes: s2d stage 0 (k 5), gated: 3 x 16 KB +
// 2 x 20x20x64 bf16 (50 KB) + 4-5 x 15-16 KB = 218,192-229,456 B; s2d
// stage 1 (k 3): 3 x 16 KB + 2 x 18x18x64 (41 KB) + 5-6 x 15-16 KB =
// 216,144-226,384 B; native enc2-enc4 (k 3, C 128-512): 8 x 16 KB + 2 x
// 41 KB = 216,224 B; native enc0 (k 7, C = Co = 32): 8 x 2 KB + 2 x
// 22x22x32 (31 KB) = 81,056 B; native enc1 (k 5, C = Co = 64): 8 x 8 KB +
// 2 x 20x20x64 = 169,120 B; all within 232,448.
//
// Design (f32, the f32 checks): the same halo, then FMA on the CUDA cores
// (no TF32), a block of 256 threads owning 32 output columns by 64
// channels, each thread 2 columns by 4 channels.

#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace umt;

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
// bf16: wgmma, warp-specialised, persistent
//
// A block of kThreadsTc threads owns kTileM = 256 output pixels — `rows`
// output rows by `tw` columns (tw = 8, 16 or 32) of one batch element —
// by N output channels (N = 32, 64 or 128; Co is split into ceil(Co / N)
// tiles).  The tile is four 8 x 8 pixel blocks, the M = 64
// rows of one wgmma each.
//   warpgroup 0, the producer: warp 0 streams the weight slices through a
//     ring of `stages` buffers, one bulk (TMA) copy a slice; warps 1-3
//     stage the halo into a double buffer, one input-channel chunk at a
//     time.
//   warpgroups 1-2, the consumers: two pixel blocks each, f32 accumulators
//     in registers; every wgmma reads A and B from shared memory.
// The K loop runs over input-channel chunks of kc = 64, 32 or 16, and
// within a chunk over the k*k taps, kc / 16 wgmma steps a tap, one commit
// group a tap, the next tap's group issued before the last one is waited
// for.  A weight slice is the (tap, chunk) block of the packed weights,
// N x kc bf16 K-major and pre-swizzled by the wrapper
// (ops/conv.py::pack_weights).  A halo chunk is (rows + k - 1) x (tw + k -
// 1) pixels by kc channels, stored channel-octet-major: the 16 bytes of
// octet j of pixel p at (j * P + p) * 16, P the pixel count rounded up to
// 8.  So a pixel block's 8 rows of 8 pixels are 8 runs of 16-byte rows,
// one halo row apart: the no-swizzle wgmma layout (8 x 16-byte core
// matrices), 8-row groups (tw + k - 1) * 16 bytes apart, K octets P * 16
// apart.  Tap (u, v)'s A operand is that layout moved by (u * (tw + k - 1)
// + v) * 16 bytes: a shift is a change of the descriptor's address.

constexpr int kConsumers = 2;
constexpr int kThreadsTc = 128 * (kConsumers + 1);
constexpr int kTileM = 128 * kConsumers;
constexpr int kHaloThreads = 96;  // producer warps 1-3
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kProducerRegs = 88;  // setmaxnreg: 128 * 88 + 256 * 208 = 384 * 168
constexpr int kConsumerRegs = 208;
constexpr int kMaxRing = 8;  // gated: raw input pieces in flight, plus one

struct TcArgs {
  const bf16* x[kMaxInputs];
  const bf16* gates;
  const bf16* w;  // packed: (Co tiles, C / kc, k * k, N, kc), swizzled
  const float* bias;
  bf16* out;
  int n, B, H, W, C, Co, k;
  int Hin, Win, pad;  // as in Args
  int rows, tw, kc, stages, ring;
};

__host__ __device__ constexpr unsigned align1024(unsigned v) {
  return (v + 1023u) & ~1023u;
}

// halo pixels of a chunk, rounded up to 8
__host__ __device__ inline int tc_halo_pixels(int rows, int tw, int k) {
  return ((rows + k - 1) * (tw + k - 1) + 7) / 8 * 8;
}

// gated: halo pixels of a piece of raw input, all n inputs of it in one
// scratch slot of 15-16 KB at kc = 64
__host__ __device__ inline int tc_piece_pixels(int n) {
  return (128 / n) & ~7;
}

// The block's shared memory, in bytes: 1024 of alignment slack, the weight
// ring, the halo double buffer, the gated stager's ring of `ring` raw
// pieces of `inputs` inputs (none in the plain mode) and the barriers.
// ops/conv.py::plan_conv computes the same number.
__host__ __device__ inline unsigned tc_weight_slice(int n, int kc) {
  return align1024(n * kc * 2);
}
__host__ __device__ inline unsigned tc_halo_bytes(int rows, int tw, int k,
                                                  int kc) {
  return align1024(tc_halo_pixels(rows, tw, k) * kc * 2);
}
__host__ __device__ inline unsigned tc_slot_bytes(int inputs, int kc) {
  return inputs * tc_piece_pixels(inputs) * kc * 2;
}
__host__ __device__ inline unsigned tc_scratch_bytes(int inputs, int kc,
                                                     int ring) {
  return inputs ? align1024(ring * tc_slot_bytes(inputs, kc)) : 0;
}
__host__ __device__ inline unsigned tc_smem(int rows, int tw, int n, int kc,
                                            int stages, int k, int inputs,
                                            int ring) {
  return 1024 + stages * tc_weight_slice(n, kc) +
         2 * tc_halo_bytes(rows, tw, k, kc) +
         tc_scratch_bytes(inputs, kc, ring) + 8 * (2 * stages + 4);
}

// The block's tiles: tile t is Co tile t % co_tiles of pixel tile
// t / co_tiles (so the Co tiles of one pixel tile run side by side and
// share its input in L2); a pixel tile is `rows` x `tw` pixels of one batch
// element.  Block x takes tiles x, x + gridDim.x, ...
struct Tiles {
  int co_tiles, tiles_w, tiles_h, count;
  __device__ Tiles(const TcArgs& a, int n_tile) {
    co_tiles = (a.Co + n_tile - 1) / n_tile;
    tiles_w = (a.W + a.tw - 1) / a.tw;
    tiles_h = (a.H + a.rows - 1) / a.rows;
    count = co_tiles * tiles_w * tiles_h * a.B;
  }
  // (batch, first row, first column, Co tile) of tile t
  __device__ void at(const TcArgs& a, int t, int& b, int& i0, int& j0,
                     int& co) const {
    co = t % co_tiles;
    t /= co_tiles;
    j0 = (t % tiles_w) * a.tw;
    t /= tiles_w;
    i0 = (t % tiles_h) * a.rows;
    b = t / tiles_h;
  }
};

// Halo pixel p's octet j at chunk c0 in the inputs, or -1 outside them
// (the SAME pad, or the rows and columns past a padded input's end, which
// feed only outputs past H or W)
__device__ __forceinline__ long long input_offset(const TcArgs& a, int b,
                                                  int i0, int j0, int p, int j,
                                                  int c0) {
  const int hw = a.tw + a.k - 1;
  if (p >= (a.rows + a.k - 1) * hw) return -1;
  const int row = i0 + p / hw - a.pad;
  const int col = j0 + p % hw - a.pad;
  if (row < 0 || row >= a.Hin || col < 0 || col >= a.Win) return -1;
  return (((long long)b * a.Hin + row) * a.Win + col) * a.C + c0 + j * 8;
}

// Warps 1-3 of the producer: every input-channel chunk of the block's
// tiles into the halo double buffer.  In the halo, unit e of a chunk is
// octet j of pixel p, 8 consecutive units being 8 consecutive pixels of
// one octet (conflict-free 16-byte stores).
//   Plain: cp.async straight from the unpadded input, zero-filled outside
//     it (the SAME pad), a chunk at a time.
//   Gated: the raw inputs arrive by cp.async in pieces of `piece` pixels
//     (all n inputs, all octets: one slot of a ring of `ring`), ring - 1
//     pieces ahead of the one being combined, across chunk and tile
//     boundaries.  Each thread copies the units it will combine, so it
//     waits only for its own copies (no barrier among the stagers); it
//     then forms each unit's gated sum in the plain version's order,
//     g0 x0 + g1 x1 + ..., with bf16x2 instructions: each product and
//     each sum rounded once to bf16, as the plain version's f32 operations
//     rounded to bf16 are (the f32 product of two bf16 values is exact,
//     and so is their f32 sum wherever its rounding could matter).
// Either way the writes are made visible to wgmma (the async proxy)
// before the chunk is signalled.
template <bool kGated>
__device__ void produce_halo(const TcArgs& a, const Tiles& tiles,
                             uint32_t halo, unsigned hbytes, uint32_t scratch,
                             uint64_t* hfull, uint64_t* hempty, int t) {
  const int P = tc_halo_pixels(a.rows, a.tw, a.k);
  const int vpp = a.kc / 8;  // 16-byte octets a pixel
  const int nchunks = a.C / a.kc;
  const int my_tiles =
      (tiles.count - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  if constexpr (!kGated) {
    const int units = P * vpp;
    for (int gq = 0; gq < my_tiles * nchunks; ++gq) {
      int b, i0, j0, co;
      tiles.at(a, blockIdx.x + (gq / nchunks) * gridDim.x, b, i0, j0, co);
      const int c0 = (gq % nchunks) * a.kc;
      const int buf = gq & 1;
      if (gq >= 2) mbar_wait(&hempty[buf], ((gq >> 1) - 1) & 1);
      const uint32_t dst = halo + buf * hbytes;
      for (int e = t; e < units; e += kHaloThreads) {
        const int group = e / 8;
        const int j = group % vpp;
        const int p = group / vpp * 8 + e % 8;
        const long long off = input_offset(a, b, i0, j0, p, j, c0);
        cp_async16_zfill(dst + (j * P + p) * 16, a.x[0] + (off >= 0 ? off : 0),
                         off >= 0);
      }
      cp_async_wait_all();
      fence_proxy_async();
      mbar_arrive(&hfull[buf]);
    }
  } else {
    const int n = a.n;
    const int piece = tc_piece_pixels(n);
    const int npix = (a.rows + a.k - 1) * (a.tw + a.k - 1);
    const int pieces = (npix + piece - 1) / piece;  // a chunk's
    const int total = my_tiles * nchunks * pieces;
    const unsigned slot = tc_slot_bytes(n, a.kc);
    const int piece_units = piece * vpp;
    const int ring = a.ring;
    uint32_t g[kMaxInputs];  // each gate twice, as a bf16 pair
#pragma unroll
    for (int m = 0; m < kMaxInputs; ++m) {
      const unsigned short bits =
          m < n ? *reinterpret_cast<const unsigned short*>(a.gates + m) : 0;
      g[m] = bits * 0x10001u;
    }
    // piece s: (tile, chunk, first pixel)
    auto locate = [&](int s, int& b, int& i0, int& j0, int& gq, int& p0) {
      gq = s / pieces;
      p0 = (s % pieces) * piece;
      int co;
      tiles.at(a, blockIdx.x + (gq / nchunks) * gridDim.x, b, i0, j0, co);
    };
    // unit e of a piece: octet j of its pixel pl (8 consecutive units, 8
    // consecutive pixels of one octet); input m's copy of it sits at
    // (m * piece_units + e) * 16 in the piece's slot
    auto unit = [&](int e, int& j, int& pl) {
      const int group = e / 8;
      j = group % vpp;
      pl = group / vpp * 8 + e % 8;
    };
    auto issue = [&](int s) {
      if (s < total) {
        int b, i0, j0, gq, p0;
        locate(s, b, i0, j0, gq, p0);
        const int c0 = (gq % nchunks) * a.kc;
        const uint32_t dst = scratch + (s % ring) * slot;
        for (int e = t; e < piece_units; e += kHaloThreads) {
          int j, pl;
          unit(e, j, pl);
          const long long off = input_offset(a, b, i0, j0, p0 + pl, j, c0);
#pragma unroll
          for (int m = 0; m < kMaxInputs; ++m) {
            if (m < n) {
              const bf16* x = m == 0 ? a.x[0] : m == 1 ? a.x[1]
                            : m == 2 ? a.x[2] : a.x[3];
              cp_async16_zfill(dst + (m * piece_units + e) * 16,
                               x + (off >= 0 ? off : 0), off >= 0);
            }
          }
        }
      }
      cp_async_commit();
    };
    for (int s = 0; s < ring - 1; ++s) issue(s);
    for (int s = 0; s < total; ++s) {
      cp_async_wait_pending(ring - 2);  // this thread's copies of piece s
      issue(s + ring - 1);  // into the slot this thread combined last
      int b, i0, j0, gq, p0;
      locate(s, b, i0, j0, gq, p0);
      const int buf = gq & 1;
      if (p0 == 0 && gq >= 2) mbar_wait(&hempty[buf], ((gq >> 1) - 1) & 1);
      const uint32_t src = scratch + (s % ring) * slot;
      const uint32_t dst = halo + buf * hbytes;
      for (int e = t; e < piece_units; e += kHaloThreads) {
        int j, pl;
        unit(e, j, pl);
        if (p0 + pl >= npix) continue;
        uint32_t sum[4];
#pragma unroll
        for (int m = 0; m < kMaxInputs; ++m) {
          if (m < n) {
            uint32_t in[4];
            asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                         : "=r"(in[0]), "=r"(in[1]), "=r"(in[2]), "=r"(in[3])
                         : "r"(src + (m * piece_units + e) * 16));
#pragma unroll
            for (int l = 0; l < 4; ++l) {
              const uint32_t prod = bf16x2_mul(g[m], in[l]);
              sum[l] = m == 0 ? prod : bf16x2_add(sum[l], prod);
            }
          }
        }
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                         dst + (j * P + p0 + pl) * 16),
                     "r"(sum[0]), "r"(sum[1]), "r"(sum[2]), "r"(sum[3])
                     : "memory");
      }
      if (p0 + piece >= npix) {  // the chunk's last piece
        fence_proxy_async();
        mbar_arrive(&hfull[buf]);
      }
    }
    cp_async_wait_all();
  }
}

// Within each quad of lanes (lane % 4 = q), out[s] of lane q = in[q] of
// lane s: four bf16 pairs of one 8-channel group gathered into the lane
// that stores them as one 16-byte vector
__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}
__device__ __forceinline__ void quad_transpose(const uint32_t (&in)[4],
                                               uint32_t (&out)[4], int q) {
#pragma unroll
  for (int s = 0; s < 4; ++s) out[s] = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    // read lane q + d, which sends what its reader (lane its own - d) wants
    const int src = (q + d) & 3;
    const uint32_t got = __shfl_sync(0xffffffffu, pick4(in, (q - d) & 3),
                                     (threadIdx.x & 31 & ~3) | src);
#pragma unroll
    for (int s = 0; s < 4; ++s) out[s] = s == src ? got : out[s];
  }
}

template <bool kGated, int kN, int kKc>
__global__ void __launch_bounds__(kThreadsTc, 1)
    gated_conv_wgmma(const TcArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const int k = a.k;
  const int nchunks = a.C / a.kc;
  const int slices = nchunks * k * k;
  const unsigned wslice = tc_weight_slice(kN, a.kc);
  const unsigned hbytes = tc_halo_bytes(a.rows, a.tw, k, a.kc);
  const uint32_t wring = smem_u32(smem);
  const uint32_t halo = wring + a.stages * wslice;
  const uint32_t scratch = halo + 2 * hbytes;
  const unsigned scratch_bytes =
      kGated ? tc_scratch_bytes(a.n, a.kc, a.ring) : 0;
  uint64_t* wfull = reinterpret_cast<uint64_t*>(smem + a.stages * wslice +
                                                2 * hbytes + scratch_bytes);
  uint64_t* wempty = wfull + a.stages;
  uint64_t* hfull = wempty + a.stages;
  uint64_t* hempty = hfull + 2;
  const Tiles tiles(a, kN);

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&wfull[s], 1);
      mbar_init(&wempty[s], kConsumerWarps);
    }
    for (int h = 0; h < 2; ++h) {
      mbar_init(&hfull[h], kHaloThreads);
      mbar_init(&hempty[h], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0) {
        // weight slices in consumer order (tile, chunk, tap), `stages` ahead
        const uint32_t bytes = kN * a.kc * 2;
        int gs = 0;
        for (int t = blockIdx.x; t < tiles.count; t += gridDim.x) {
          const bf16* src = a.w + (size_t)(t % tiles.co_tiles) * slices * kN * a.kc;
          for (int s = 0; s < slices; ++s, ++gs) {
            const int st = gs % a.stages;
            if (gs >= a.stages) {
              mbar_wait(&wempty[st], ((gs / a.stages) - 1) & 1);
            }
            mbar_arrive_expect_tx(&wfull[st], bytes);
            bulk_copy_g2s(smem + st * wslice, src + (size_t)s * kN * a.kc,
                          bytes, &wfull[st]);
          }
        }
      }
    } else {
      produce_halo<kGated>(a, tiles, halo, hbytes, scratch, hfull, hempty,
                           threadIdx.x - 32);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  // consumer warpgroup cw owns pixel blocks 2cw and 2cw + 1 of each tile;
  // block g is rows 8 (g / (tw / 8)) .. + 7, columns 8 (g % (tw / 8)) .. + 7
  const int cw = wg - 1;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32 % 4;
  const int hw = a.tw + k - 1;
  const uint32_t P = tc_halo_pixels(a.rows, a.tw, k);
  int block_row[2], block_col[2];
  uint32_t block_px[2];  // the halo pixel of the block's corner at tap (0, 0)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = 2 * cw + h;
    block_row[h] = 8 * (g / (a.tw / 8));
    block_col[h] = 8 * (g % (a.tw / 8));
    block_px[h] = block_row[h] * hw + block_col[h];
  }

  int stage = 0;
  uint32_t phase = 0;
  int gq = 0;  // chunks begun, over the block's tiles
  float acc[2][kN / 2];
  for (int t = blockIdx.x; t < tiles.count; t += gridDim.x) {
    int b, i0, j0, co;
    tiles.at(a, t, b, i0, j0, co);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) acc[h][i] = 0.f;
    }
    int prev_stage = -1;      // the slice of the group in flight
    int prev_chunk_end = -1;  // its halo buffer, if it ends a chunk
    for (int q = 0; q < nchunks; ++q, ++gq) {
      mbar_wait(&hfull[gq & 1], (gq >> 1) & 1);
      const uint32_t hbase = halo + (gq & 1) * hbytes;
      for (int u = 0; u < k; ++u) {
        for (int v = 0; v < k; ++v) {
          mbar_wait(&wfull[stage], phase);
          const uint64_t bdesc = kmajor_desc(wring + stage * wslice, kKc * 2);
          const uint32_t shift = u * hw + v;
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kKc / 16; ++ks) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t addr =
                  hbase + (2 * ks * P + block_px[h] + shift) * 16;
              Mma<kN>::run(acc[h], interleave_desc(addr, P * 16, hw * 16),
                           bdesc + ks * 2);
            }
          }
          wgmma_commit();
          // the previous tap's group has completed: free its slice (and
          // its halo buffer after a chunk's last tap)
          wgmma_wait<1>();
          if (prev_stage >= 0 && lane == 0) {
            mbar_arrive(&wempty[prev_stage]);
            if (prev_chunk_end >= 0) mbar_arrive(&hempty[prev_chunk_end]);
          }
          prev_stage = stage;
          prev_chunk_end = u == k - 1 && v == k - 1 ? (gq & 1) : -1;
          if (++stage == a.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    wgmma_wait<0>();
    keep(acc[0]);
    keep(acc[1]);
    if (lane == 0) {  // the tile's last slice and halo chunk
      mbar_arrive(&wempty[prev_stage]);
      mbar_arrive(&hempty[prev_chunk_end]);
    }

    // epilogue: bias and ELU in f32, one rounding; fragment element 4c +
    // 2r + e is (row 16 * warp + lane / 4 + 8r of the block, channel 8c +
    // 2 (lane % 4) + e); block row m is pixel (m / 8, m % 8) of the block.
    // Each quad of lanes swaps its values so that every lane stores one
    // 8-channel group as a 16-byte vector.
    const int n0 = co * kN;
    const int q = lane % 4;
#pragma unroll
    for (int w = 0; w < kN / 32; ++w) {
      float bias[4][2];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int n = n0 + 8 * (4 * w + jj) + 2 * q;
        bias[jj][0] = n < a.Co ? a.bias[n] : 0.f;
        bias[jj][1] = n < a.Co ? a.bias[n + 1] : 0.f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t y[4], t[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int c = 4 * w + jj;
            __nv_bfloat162 v;
            v.x = __float2bfloat16_rn(
                umt::elu(__fadd_rn(acc[h][4 * c + 2 * r], bias[jj][0])));
            v.y = __float2bfloat16_rn(
                umt::elu(__fadd_rn(acc[h][4 * c + 2 * r + 1], bias[jj][1])));
            y[jj] = *reinterpret_cast<uint32_t*>(&v);
          }
          quad_transpose(y, t, q);
          const int m = warp * 16 + lane / 4 + 8 * r;
          const int i = i0 + block_row[h] + m / 8;
          const int j = j0 + block_col[h] + m % 8;
          const int n = n0 + 8 * (4 * w + q);
          if (i < a.H && j < a.W && n < a.Co) {
            *reinterpret_cast<uint4*>(
                a.out + (((size_t)b * a.H + i) * a.W + j) * a.Co + n) =
                make_uint4(t[0], t[1], t[2], t[3]);
          }
        }
      }
    }
  }
}

template <bool kGated, int kN, int kKc>
cudaError_t launch_tc(const TcArgs& a, unsigned smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      gated_conv_wgmma<kGated, kN, kKc>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  // persistent: at most one block an SM, each walking its tiles
  const long long tiles = (long long)a.B * ((a.H + a.rows - 1) / a.rows) *
                          ((a.W + a.tw - 1) / a.tw) * ((a.Co + kN - 1) / kN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  gated_conv_wgmma<kGated, kN, kKc><<<grid, kThreadsTc, smem, s>>>(a);
  return cudaGetLastError();
}

template <bool kGated, int kN>
cudaError_t launch_tc(const TcArgs& a, unsigned smem, cudaStream_t s) {
  switch (a.kc) {
    case 16: return launch_tc<kGated, kN, 16>(a, smem, s);
    case 32: return launch_tc<kGated, kN, 32>(a, smem, s);
    default: return launch_tc<kGated, kN, 64>(a, smem, s);
  }
}

// A plan (rows x tw pixels by n channels a block, kc-channel chunks, a
// ring of `stages` weight slices, gated: a ring of `ring` raw pieces) the
// kernel takes within a block's shared memory
bool tc_plan_ok(int C, int Co, int k, int rows, int tw, int n, int kc,
                int stages, int inputs, int ring) {
  const bool tw_ok = tw == 8 || tw == 16 || tw == 32;
  const bool n_ok = n == 32 || n == 64 || n == 128;
  const bool kc_ok = (kc == 16 || kc == 32 || kc == 64) && C % kc == 0;
  const bool ring_ok = inputs ? ring >= 2 && ring <= kMaxRing : ring == 0;
  return tw_ok && rows * tw == kTileM && n_ok && kc_ok && ring_ok &&
         stages >= 2 && stages <= 8 && C % 16 == 0 && Co % 16 == 0 &&
         tc_smem(rows, tw, n, kc, stages, k, inputs, ring) <=
             (unsigned)kSmemLimit;
}

template <bool kGated>
int launch_bf16(const void* const* xs, const void* gates, const void* w,
                const void* bias, void* out, int n, int B, int H, int W,
                int Hin, int Win, int pad, int C, int Co, int k,
                const int* plan, cudaStream_t s) {
  const int rows = plan[0], tw = plan[1], nt = plan[2], kc = plan[3],
            stages = plan[4], ring = plan[5];
  const int inputs = kGated ? n : 0;
  if (!tc_plan_ok(C, Co, k, rows, tw, nt, kc, stages, inputs, ring) ||
      plan[6] != (int)tc_smem(rows, tw, nt, kc, stages, k, inputs, ring)) {
    return cudaErrorInvalidValue;
  }
  TcArgs a;
  for (int m = 0; m < kMaxInputs; ++m) {
    a.x[m] = static_cast<const bf16*>(m < n ? xs[m] : xs[0]);
  }
  a.gates = static_cast<const bf16*>(gates);
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
  a.n = n;
  a.B = B;
  a.H = H;
  a.W = W;
  a.C = C;
  a.Co = Co;
  a.k = k;
  a.Hin = Hin;
  a.Win = Win;
  a.pad = pad;
  a.rows = rows;
  a.tw = tw;
  a.kc = kc;
  a.stages = stages;
  a.ring = ring;
  const unsigned smem = plan[6];
  switch (nt) {
    case 32: return launch_tc<kGated, 32>(a, smem, s);
    case 64: return launch_tc<kGated, 64>(a, smem, s);
    default: return launch_tc<kGated, 128>(a, smem, s);
  }
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
int launch_f32(const void* const* xs, const void* gates, const void* w,
               const void* bias, void* out, int n, int B, int H, int W,
               int Hin, int Win, int pad, int C, int Co, int k,
               cudaStream_t s) {
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

// dtype 1 (bf16): `plan` is (rows, tw, n, kc, stages, ring, shared memory
// bytes) from ops/conv.py::plan_conv, refused unless the kernel takes it
// and its shared memory is the kernel's own count; dtype 0 (f32) ignores it
template <bool kGated>
int launch(int dtype, const void* const* xs, const void* gates,
           const void* w, const void* bias, void* out, int n, int B, int H,
           int W, int Hin, int Win, int pad, int C, int Co, int k,
           const int* plan, cudaStream_t s) {
  if (dtype == 1) {
    return launch_bf16<kGated>(xs, gates, w, bias, out, n, B, H, W, Hin, Win,
                               pad, C, Co, k, plan, s);
  }
  if (dtype == 0) {
    return launch_f32<kGated>(xs, gates, w, bias, out, n, B, H, W, Hin, Win,
                              pad, C, Co, k, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// xs: n (1..4) pointers to (B, H+k-1, Wp, C) inputs; gates (n,) in the
// storage type; w: f32, the HWIO kernel (k, k, C, Co); bf16, the packed
// weights of ops/conv.py::pack_weights; bias (Co,) f32; out (B, H, W, Co);
// plan: seven ints (see launch).  Preconditions (checked by the Python
// wrapper): every tensor contiguous, 16-byte aligned and on one device;
// W + k - 1 <= Wp; bf16: C and Co multiples of 16; f32: multiples of 4.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int umt_gated_conv_elu(int dtype, const void* const* xs,
                                  const void* gates, const void* w,
                                  const void* bias, void* out, int n, int B,
                                  int H, int Wp, int W, int C, int Co, int k,
                                  const int* plan, void* stream) {
  if (n < 1 || n > kMaxInputs) return cudaErrorInvalidValue;
  return launch<true>(dtype, xs, gates, w, bias, out, n, B, H, W, H + k - 1,
                      Wp, 0, C, Co, k, plan,
                      static_cast<cudaStream_t>(stream));
}

// The SAME zero-pad conv of one unpadded input x (B, H, W, C) with the
// weights as above and bias (Co,) f32 into out (B, H, W, Co), under the
// same preconditions.
extern "C" int umt_conv_elu(int dtype, const void* x, const void* w,
                            const void* bias, void* out, int B, int H, int W,
                            int C, int Co, int k, const int* plan,
                            void* stream) {
  const void* xs[1] = {x};
  return launch<false>(dtype, xs, nullptr, w, bias, out, 1, B, H, W, H, W,
                       (k - 1) / 2, C, Co, k, plan,
                       static_cast<cudaStream_t>(stream));
}
