// Host-side PNG pixel decode and the PIL-compatible resize of the port's
// data pipeline (the port of the JAX package's native/stereo_loader.cc,
// without libpng).
//
// Python (data/native.py) reads the file, checks the chunks and inflates
// the concatenated IDAT data with the standard library's zlib; this file
// does the rest, with no header outside the C++ standard library:
//
//   umt_png_to_rgb8: undo the per-row filters (types 0-4) and expand every
//     colour type (gray, RGB, palette, gray + alpha, RGBA; 1- to 16-bit) to
//     8-bit RGB, as libpng does after png_set_strip_16 (16-bit samples keep
//     their high byte), png_set_palette_to_rgb, png_set_expand_gray_1_2_4_to_8,
//     png_set_gray_to_rgb and png_set_strip_alpha;
//   umt_resize_rgb8: the separable triangle-filter resize to float32 [0, 1]
//     of native/stereo_loader.cc (triangle_coeffs, resize_to_float), with
//     the same double accumulation in the same order, so that its floats
//     equal the JAX package's native backend (PIL's Image.BILINEAR within
//     PIL's rounding to uint8 between the passes).
//
// Both return 0 on success, else an error code that data/native.py turns
// into an IOError naming the file.  Neither allocates memory the caller
// sees: the output buffers are the caller's.

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {

enum Status {
  kOk = 0,
  kBadHeader = 1,    // colour type / bit depth PNG does not define
  kShortData = 2,    // fewer inflated bytes than the rows need
  kBadFilter = 3,    // a row's filter type is not 0-4
};

int channels_of(int color_type) {
  switch (color_type) {
    case 0: return 1;  // gray
    case 2: return 3;  // RGB
    case 3: return 1;  // palette index
    case 4: return 2;  // gray + alpha
    case 6: return 4;  // RGBA
    default: return 0;
  }
}

bool valid_depth(int color_type, int bit_depth) {
  switch (color_type) {
    case 0:
      return bit_depth == 1 || bit_depth == 2 || bit_depth == 4 ||
             bit_depth == 8 || bit_depth == 16;
    case 3:
      return bit_depth == 1 || bit_depth == 2 || bit_depth == 4 ||
             bit_depth == 8;
    case 2: case 4: case 6:
      return bit_depth == 8 || bit_depth == 16;
    default:
      return false;
  }
}

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

// Undo one row's filter in place; `prev` is the previous row, already
// unfiltered (all zeros above the first row).
bool unfilter_row(int filter, uint8_t* row, const uint8_t* prev,
                  size_t rowbytes, size_t bpp) {
  switch (filter) {
    case 0:
      return true;
    case 1:
      for (size_t i = bpp; i < rowbytes; ++i) row[i] += row[i - bpp];
      return true;
    case 2:
      for (size_t i = 0; i < rowbytes; ++i) row[i] += prev[i];
      return true;
    case 3:
      for (size_t i = 0; i < bpp; ++i) row[i] += prev[i] >> 1;
      for (size_t i = bpp; i < rowbytes; ++i)
        row[i] += static_cast<uint8_t>((row[i - bpp] + prev[i]) >> 1);
      return true;
    case 4:
      for (size_t i = 0; i < bpp; ++i) row[i] += prev[i];  // paeth(0, b, 0)
      for (size_t i = bpp; i < rowbytes; ++i)
        row[i] += paeth(row[i - bpp], prev[i], prev[i - bpp]);
      return true;
    default:
      return false;
  }
}

// Sample `x` of a row packed at `bit_depth` < 8 bits, most significant
// bits first.
inline int packed_sample(const uint8_t* row, int x, int bit_depth) {
  int bit = x * bit_depth;
  int shift = 8 - bit_depth - (bit & 7);
  return (row[bit >> 3] >> shift) & ((1 << bit_depth) - 1);
}

// One unfiltered row -> `width` RGB8 pixels.
void expand_row(const uint8_t* row, int width, int bit_depth, int color_type,
                const uint8_t* palette, uint8_t* out) {
  if (bit_depth < 8) {  // gray or palette, 1/2/4-bit
    int gray_scale = 255 / ((1 << bit_depth) - 1);
    for (int x = 0; x < width; ++x) {
      int v = packed_sample(row, x, bit_depth);
      uint8_t* px = out + 3 * x;
      if (color_type == 3) {
        px[0] = palette[3 * v];
        px[1] = palette[3 * v + 1];
        px[2] = palette[3 * v + 2];
      } else {
        px[0] = px[1] = px[2] = static_cast<uint8_t>(v * gray_scale);
      }
    }
    return;
  }
  // 8- or 16-bit samples: a 16-bit sample keeps its high (first) byte
  const int step = bit_depth / 8;
  const int channels = channels_of(color_type);
  for (int x = 0; x < width; ++x) {
    const uint8_t* s = row + static_cast<size_t>(x) * channels * step;
    uint8_t* px = out + 3 * x;
    if (color_type == 3) {
      px[0] = palette[3 * s[0]];
      px[1] = palette[3 * s[0] + 1];
      px[2] = palette[3 * s[0] + 2];
    } else if (channels <= 2) {  // gray, gray + alpha
      px[0] = px[1] = px[2] = s[0];
    } else {  // RGB, RGBA
      px[0] = s[0];
      px[1] = s[step];
      px[2] = s[2 * step];
    }
  }
}

// native/stereo_loader.cc's ResampleCoeffs and triangle_coeffs, unchanged.
struct ResampleCoeffs {
  std::vector<int> bounds;     // 2 per output pixel: (xmin, xsize)
  std::vector<double> coeffs;  // ksize per output pixel
  int ksize = 0;
};

ResampleCoeffs triangle_coeffs(int in_size, int out_size) {
  ResampleCoeffs rc;
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;  // triangle filter support = 1
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

  rc.ksize = ksize;
  rc.bounds.resize(out_size * 2);
  rc.coeffs.resize(static_cast<size_t>(out_size) * ksize);

  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &rc.coeffs[static_cast<size_t>(xx) * ksize];
    int x = 0;
    for (; x < xmax; ++x) {
      double arg = (x + xmin - center + 0.5) * ss;
      double w = arg < 0 ? 1.0 + arg : 1.0 - arg;  // triangle
      if (w < 0) w = 0;
      k[x] = w;
      ww += w;
    }
    for (int i = 0; i < xmax; ++i)
      if (ww != 0.0) k[i] /= ww;
    for (; x < ksize; ++x) k[x] = 0;
    rc.bounds[xx * 2] = xmin;
    rc.bounds[xx * 2 + 1] = xmax;
  }
  return rc;
}

}  // namespace

extern "C" {

// `raw`: the inflated IDAT stream of a non-interlaced PNG, `height` rows of
// a filter byte and the row's bytes.  Writes (height, width, 3) uint8 to
// `out`.  `palette`: 256 RGB entries (entries past the PLTE chunk zero, as
// libpng reads an index past its palette).
int umt_png_to_rgb8(const uint8_t* raw, int64_t raw_len, int width,
                    int height, int bit_depth, int color_type,
                    const uint8_t* palette, uint8_t* out) {
  const int channels = channels_of(color_type);
  if (width <= 0 || height <= 0 || channels == 0 ||
      !valid_depth(color_type, bit_depth))
    return kBadHeader;
  const size_t bits = static_cast<size_t>(width) * channels * bit_depth;
  const size_t rowbytes = (bits + 7) / 8;
  const size_t bpp = (static_cast<size_t>(channels) * bit_depth + 7) / 8;
  if (raw_len < 0 ||
      static_cast<size_t>(raw_len) < (rowbytes + 1) * static_cast<size_t>(height))
    return kShortData;

  std::vector<uint8_t> rows(2 * rowbytes, 0);
  uint8_t* prev = rows.data();
  uint8_t* cur = rows.data() + rowbytes;
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = raw + static_cast<size_t>(y) * (rowbytes + 1);
    for (size_t i = 0; i < rowbytes; ++i) cur[i] = src[1 + i];
    if (!unfilter_row(src[0], cur, prev, rowbytes, bpp)) return kBadFilter;
    expand_row(cur, width, bit_depth, color_type, palette,
               out + static_cast<size_t>(y) * width * 3);
    uint8_t* t = prev;
    prev = cur;
    cur = t;
  }
  return kOk;
}

// native/stereo_loader.cc's resize_to_float: an (in_h, in_w, 3) uint8 image
// -> (out_h, out_w, 3) float32 in [0, 1], the horizontal pass first.
int umt_resize_rgb8(const uint8_t* rgb, int in_h, int in_w, int out_h,
                    int out_w, float* out) {
  if (in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0) return kBadHeader;
  ResampleCoeffs cx = triangle_coeffs(in_w, out_w);
  ResampleCoeffs cy = triangle_coeffs(in_h, out_h);

  // horizontal pass: (in_h, out_w, 3) floats
  std::vector<float> tmp(static_cast<size_t>(in_h) * out_w * 3);
  for (int y = 0; y < in_h; ++y) {
    const uint8_t* row = rgb + static_cast<size_t>(y) * in_w * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * out_w * 3;
    for (int xx = 0; xx < out_w; ++xx) {
      int xmin = cx.bounds[xx * 2], xsize = cx.bounds[xx * 2 + 1];
      const double* k = &cx.coeffs[static_cast<size_t>(xx) * cx.ksize];
      double acc[3] = {0, 0, 0};
      for (int x = 0; x < xsize; ++x) {
        const uint8_t* px = row + (xmin + x) * 3;
        acc[0] += px[0] * k[x];
        acc[1] += px[1] * k[x];
        acc[2] += px[2] * k[x];
      }
      trow[xx * 3 + 0] = static_cast<float>(acc[0]);
      trow[xx * 3 + 1] = static_cast<float>(acc[1]);
      trow[xx * 3 + 2] = static_cast<float>(acc[2]);
    }
  }

  // vertical pass + normalise to [0, 1]
  const float inv255 = 1.0f / 255.0f;
  for (int yy = 0; yy < out_h; ++yy) {
    int ymin = cy.bounds[yy * 2], ysize = cy.bounds[yy * 2 + 1];
    const double* k = &cy.coeffs[static_cast<size_t>(yy) * cy.ksize];
    float* orow = out + static_cast<size_t>(yy) * out_w * 3;
    for (int xx = 0; xx < out_w * 3; ++xx) {
      double acc = 0;
      for (int y = 0; y < ysize; ++y)
        acc += tmp[static_cast<size_t>(ymin + y) * out_w * 3 + xx] * k[y];
      // PIL clips and rounds to uint8 between the passes; this keeps the
      // float and clips it to the valid range
      float v = static_cast<float>(acc);
      if (v < 0) v = 0;
      if (v > 255.0f) v = 255.0f;
      orow[xx] = v * inv255;
    }
  }
  return kOk;
}

}  // extern "C"
