// sphloader — native data-loading hot path for sph_retina_tpu.
//
// The reference delegates image IO to torch's C++ DataLoader workers; this
// is the TPU-native equivalent: JPEG/PNG decode (libjpeg/libpng), bilinear
// resize to the ERP chart, ImageNet normalization and optional horizontal
// flip, fused in one pass over the rows, with a std::thread batch API that
// runs fully outside the Python GIL (callers use ctypes).
//
// C ABI:
//   int sph_load_image(path, out, H, W, mean3, std3, flip) -> 0 on success
//   int sph_load_batch(paths, n, out, H, W, mean3, std3, flips, n_threads)
//   int sph_load_image_u8(path, out, H, W, flip)
//   int sph_load_batch_u8(paths, n, out, H, W, flips, n_threads)
//   int sph_load_image_yuv(path, out, H, W, flip)
//   int sph_load_batch_yuv(paths, n, out, H, W, flips, n_threads)
//
// `out` is float32 NHWC (normalized) or uint8 NHWC (_u8 variants — for the
// ship-uint8 / normalize-on-device pipeline: 4x fewer host->device bytes,
// the (x-mean)/std runs inside the jitted step and fuses into conv1).
//
// The _yuv variants emit a packed I420 chart of shape (H*3/2, W) uint8:
// rows [0,H) = Y, rows [H, H*3/2) = the chroma strip with U in columns
// [0, W/2) and V in [W/2, W), each at (H/2, W/2). JPEG sources are 4:2:0
// already, so shipping subsampled chroma loses nothing the encoder kept —
// and halves host->device bytes again (1.5 B/px vs 3). The jitted step
// upsamples chroma bilinearly and converts BT.601 full-range YCbCr->RGB
// (engine.train.maybe_normalize_images), fusing into conv1 under XLA.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <cmath>
#include <atomic>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Image {
  std::vector<unsigned char> data;  // RGB8, row-major
  int h = 0, w = 0;
};

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

bool decode_jpeg(FILE* f, Image* img, int target_h, int target_w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  // DCT-domain downscale: when the target chart is smaller than the source,
  // decode at the smallest n/8 scale whose output still covers the target
  // (bilinear then refines the remainder). Decoding 2048x4096 -> 512x1024
  // this way skips ~94% of the IDCT + color-convert work.
  if (target_h > 0 && target_w > 0) {
    int num = 8;
    while (num > 1) {
      long sw = ((long)cinfo.image_width * (num - 1) + 7) / 8;
      long sh = ((long)cinfo.image_height * (num - 1) + 7) / 8;
      if (sw < target_w || sh < target_h) break;
      --num;
    }
    cinfo.scale_num = num;
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  img->w = cinfo.output_width;
  img->h = cinfo.output_height;
  img->data.resize(size_t(img->w) * img->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = img->data.data() + size_t(cinfo.output_scanline) * img->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_png(FILE* f, Image* img) {
  png_byte header[8];
  if (fread(header, 1, 8, f) != 8 || png_sig_cmp(header, 0, 8)) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);
  png_set_expand(png);           // palette/gray/low-bit -> 8-bit
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  img->w = png_get_image_width(png, info);
  img->h = png_get_image_height(png, info);
  img->data.resize(size_t(img->w) * img->h * 3);
  std::vector<png_bytep> rows(img->h);
  for (int y = 0; y < img->h; ++y)
    rows[y] = img->data.data() + size_t(y) * img->w * 3;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool load_rgb(const char* path, Image* img, int target_h = 0,
              int target_w = 0) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  unsigned char magic[2] = {0, 0};
  if (fread(magic, 1, 2, f) != 2) {
    fclose(f);
    return false;
  }
  rewind(f);
  bool ok = false;
  if (magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(f, img, target_h, target_w);
  } else if (magic[0] == 0x89 && magic[1] == 'P') {
    ok = decode_png(f, img);
  }
  fclose(f);
  return ok && img->w > 0 && img->h > 0;
}

// Per-column bilinear sampling table: source indices and weight, computed
// once per image instead of once per output pixel per row.
struct ColTab {
  std::vector<int> x0, x1;
  std::vector<float> wx;
  ColTab(int ow, int iw) : x0(ow), x1(ow), wx(ow) {
    const float sx = float(iw) / ow;
    for (int x = 0; x < ow; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int i0 = (int)floorf(fx);
      wx[x] = fx - i0;
      x0[x] = i0 < 0 ? 0 : (i0 >= iw ? iw - 1 : i0);
      int i1 = i0 + 1;
      x1[x] = i1 < 0 ? 0 : (i1 >= iw ? iw - 1 : i1);
    }
  }
};

// Fused bilinear resize + normalize + optional horizontal flip.
void resize_normalize(const Image& img, float* out, int oh, int ow,
                      const float* mean, const float* stdv, int flip) {
  const float sy = float(img.h) / oh;
  const float inv_std[3] = {1.f / stdv[0], 1.f / stdv[1], 1.f / stdv[2]};
  if (img.h == oh && img.w == ow) {  // identity geometry: normalize only
    for (int y = 0; y < oh; ++y) {
      const unsigned char* irow = img.data.data() + size_t(y) * ow * 3;
      float* orow = out + size_t(y) * ow * 3;
      for (int x = 0; x < ow; ++x) {
        const unsigned char* p = irow + (flip ? (ow - 1 - x) : x) * 3;
        float* o = orow + x * 3;
        o[0] = (p[0] - mean[0]) * inv_std[0];
        o[1] = (p[1] - mean[1]) * inv_std[1];
        o[2] = (p[2] - mean[2]) * inv_std[2];
      }
    }
    return;
  }
  ColTab ct(ow, img.w);
  for (int y = 0; y < oh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = (int)floorf(fy);
    float wy = fy - y0;
    int y0c = y0 < 0 ? 0 : (y0 >= img.h ? img.h - 1 : y0);
    int y1c = y0 + 1 < 0 ? 0 : (y0 + 1 >= img.h ? img.h - 1 : y0 + 1);
    const unsigned char* r0 = img.data.data() + size_t(y0c) * img.w * 3;
    const unsigned char* r1 = img.data.data() + size_t(y1c) * img.w * 3;
    float* orow = out + size_t(y) * ow * 3;
    for (int x = 0; x < ow; ++x) {
      int xd = flip ? (ow - 1 - x) : x;
      const int x0c = ct.x0[x] * 3, x1c = ct.x1[x] * 3;
      const float wx = ct.wx[x];
      for (int c = 0; c < 3; ++c) {
        float top = r0[x0c + c] * (1 - wx) + r0[x1c + c] * wx;
        float bot = r1[x0c + c] * (1 - wx) + r1[x1c + c] * wx;
        float v = top * (1 - wy) + bot * wy;
        orow[xd * 3 + c] = (v - mean[c]) * inv_std[c];
      }
    }
  }
}

// Bilinear resize + optional horizontal flip, rounded back to uint8 (the
// same quantization PIL's uint8 resize applies, so the device-normalized
// values match the PIL-decode path bit for bit).
void resize_u8(const Image& img, unsigned char* out, int oh, int ow,
               int flip) {
  if (img.h == oh && img.w == ow) {  // identity geometry: copy (or flip-copy)
    if (!flip) {
      memcpy(out, img.data.data(), size_t(oh) * ow * 3);
      return;
    }
    for (int y = 0; y < oh; ++y) {
      const unsigned char* irow = img.data.data() + size_t(y) * ow * 3;
      unsigned char* orow = out + size_t(y) * ow * 3;
      for (int x = 0; x < ow; ++x) {
        const unsigned char* p = irow + (ow - 1 - x) * 3;
        unsigned char* o = orow + x * 3;
        o[0] = p[0]; o[1] = p[1]; o[2] = p[2];
      }
    }
    return;
  }
  const float sy = float(img.h) / oh;
  ColTab ct(ow, img.w);
  for (int y = 0; y < oh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = (int)floorf(fy);
    float wy = fy - y0;
    int y0c = y0 < 0 ? 0 : (y0 >= img.h ? img.h - 1 : y0);
    int y1c = y0 + 1 < 0 ? 0 : (y0 + 1 >= img.h ? img.h - 1 : y0 + 1);
    const unsigned char* r0 = img.data.data() + size_t(y0c) * img.w * 3;
    const unsigned char* r1 = img.data.data() + size_t(y1c) * img.w * 3;
    unsigned char* orow = out + size_t(y) * ow * 3;
    for (int x = 0; x < ow; ++x) {
      int xd = flip ? (ow - 1 - x) : x;
      const int x0c = ct.x0[x] * 3, x1c = ct.x1[x] * 3;
      const float wx = ct.wx[x];
      for (int c = 0; c < 3; ++c) {
        float top = r0[x0c + c] * (1 - wx) + r0[x1c + c] * wx;
        float bot = r1[x0c + c] * (1 - wx) + r1[x1c + c] * wx;
        float v = top * (1 - wy) + bot * wy;
        v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
        orow[xd * 3 + c] = (unsigned char)(v + 0.5f);
      }
    }
  }
}

// --- YUV420 (I420-packed) path ------------------------------------------
//
// Decode straight to YCbCr (libjpeg skips its YCbCr->RGB conversion; PNGs
// are converted here with the same JFIF full-range matrix), then resample
// Y at full target resolution and Cb/Cr at half resolution into one packed
// (H*3/2, W) uint8 chart.

bool decode_jpeg_ycbcr(FILE* f, Image* img, int target_h, int target_w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  // Grayscale JPEGs have no chroma planes; request YCbCr only when the
  // source has them (libjpeg synthesizes Cb=Cr=128 otherwise via RGB).
  cinfo.out_color_space =
      cinfo.jpeg_color_space == JCS_GRAYSCALE ? JCS_GRAYSCALE : JCS_YCbCr;
  if (target_h > 0 && target_w > 0) {
    int num = 8;
    while (num > 1) {
      long sw = ((long)cinfo.image_width * (num - 1) + 7) / 8;
      long sh = ((long)cinfo.image_height * (num - 1) + 7) / 8;
      if (sw < target_w || sh < target_h) break;
      --num;
    }
    cinfo.scale_num = num;
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  img->w = cinfo.output_width;
  img->h = cinfo.output_height;
  img->data.resize(size_t(img->w) * img->h * 3);
  if (cinfo.out_color_space == JCS_GRAYSCALE) {
    std::vector<unsigned char> gray(img->w);
    while (cinfo.output_scanline < cinfo.output_height) {
      unsigned char* grow = gray.data();
      int y = cinfo.output_scanline;
      jpeg_read_scanlines(&cinfo, &grow, 1);
      unsigned char* orow = img->data.data() + size_t(y) * img->w * 3;
      for (int x = 0; x < img->w; ++x) {
        orow[x * 3] = gray[x];
        orow[x * 3 + 1] = 128;
        orow[x * 3 + 2] = 128;
      }
    }
  } else {
    while (cinfo.output_scanline < cinfo.output_height) {
      unsigned char* row =
          img->data.data() + size_t(cinfo.output_scanline) * img->w * 3;
      jpeg_read_scanlines(&cinfo, &row, 1);
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Raw-data decode: libjpeg hands back the post-IDCT component planes at
// their NATIVE sampling (Y full-res, Cb/Cr subsampled for 4:2:0) — no
// chroma upsample, no color conversion, and for the common
// already-4:2:0-at-target case the planes below are memcpy'd straight
// into the packed chart. This is the speed-of-light JPEG->I420 path; the
// interleaved decode_jpeg_ycbcr path (which upsamples chroma to full res
// only for us to subsample it again) remains as the fallback for
// grayscale/odd sampling factors and when DCT scaling is engaged (raw
// mode + scaling interplay varies across libjpeg builds).
struct Plane {
  std::vector<unsigned char> data;  // row-major, padded rows at the tail
  int h = 0, w = 0;                 // real (downsampled) dims
};

bool decode_jpeg_raw_planes(FILE* f, Plane planes[3]) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK ||
      cinfo.jpeg_color_space != JCS_YCbCr || cinfo.num_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_YCbCr;
  cinfo.raw_data_out = TRUE;
  cinfo.do_fancy_upsampling = FALSE;
  jpeg_start_decompress(&cinfo);

  const int mcu_rows = cinfo.max_v_samp_factor * DCTSIZE;
  JSAMPROW rowptr[3][16];
  JSAMPARRAY comp_rows[3] = {rowptr[0], rowptr[1], rowptr[2]};
  int comp_mcu[3];
  for (int c = 0; c < 3; ++c) {
    const jpeg_component_info& ci = cinfo.comp_info[c];
    planes[c].w = ci.downsampled_width;
    planes[c].h = ci.downsampled_height;
    comp_mcu[c] = ci.v_samp_factor * DCTSIZE;
    if (comp_mcu[c] > 16) {  // cannot happen for baseline JPEG; be safe
      jpeg_destroy_decompress(&cinfo);
      return false;
    }
    // pad the buffer so the last iMCU row's pointers stay in bounds
    const size_t padded_h =
        (size_t(planes[c].h) + comp_mcu[c] - 1) / comp_mcu[c] * comp_mcu[c];
    planes[c].data.resize(padded_h * planes[c].w);
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    for (int c = 0; c < 3; ++c) {
      const size_t base =
          size_t(cinfo.output_scanline) * comp_mcu[c] / mcu_rows;
      for (int r = 0; r < comp_mcu[c]; ++r) {
        rowptr[c][r] = planes[c].data.data() + (base + r) * planes[c].w;
      }
    }
    if (jpeg_read_raw_data(&cinfo, comp_rows, mcu_rows) == 0) {
      jpeg_destroy_decompress(&cinfo);
      return false;
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// JFIF full-range RGB -> YCbCr, in place (PNG sources).
void rgb_to_ycbcr(Image* img) {
  unsigned char* p = img->data.data();
  const size_t n = size_t(img->w) * img->h;
  for (size_t i = 0; i < n; ++i, p += 3) {
    const float r = p[0], g = p[1], b = p[2];
    float yv = 0.299f * r + 0.587f * g + 0.114f * b;
    float cb = 128.f - 0.168736f * r - 0.331264f * g + 0.5f * b;
    float cr = 128.f + 0.5f * r - 0.418688f * g - 0.081312f * b;
    p[0] = (unsigned char)(yv < 0 ? 0 : (yv > 255 ? 255 : yv + 0.5f));
    p[1] = (unsigned char)(cb < 0 ? 0 : (cb > 255 ? 255 : cb + 0.5f));
    p[2] = (unsigned char)(cr < 0 ? 0 : (cr > 255 ? 255 : cr + 0.5f));
  }
}

bool load_ycbcr(const char* path, Image* img, int target_h, int target_w) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  unsigned char magic[2] = {0, 0};
  if (fread(magic, 1, 2, f) != 2) {
    fclose(f);
    return false;
  }
  rewind(f);
  bool ok = false;
  if (magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg_ycbcr(f, img, target_h, target_w);
  } else if (magic[0] == 0x89 && magic[1] == 'P') {
    ok = decode_png(f, img);
    if (ok) rgb_to_ycbcr(img);
  }
  fclose(f);
  return ok && img->w > 0 && img->h > 0;
}

// Bilinear-resample one interleaved channel to (th, tw), writing uint8 with
// output stride `ostride` (1 for plane-packed output).
void resample_channel_u8(const Image& img, int ch, unsigned char* out, int th,
                         int tw, int flip) {
  const float sy = float(img.h) / th;
  ColTab ct(tw, img.w);
  for (int y = 0; y < th; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = (int)floorf(fy);
    float wy = fy - y0;
    int y0c = y0 < 0 ? 0 : (y0 >= img.h ? img.h - 1 : y0);
    int y1c = y0 + 1 < 0 ? 0 : (y0 + 1 >= img.h ? img.h - 1 : y0 + 1);
    const unsigned char* r0 = img.data.data() + size_t(y0c) * img.w * 3 + ch;
    const unsigned char* r1 = img.data.data() + size_t(y1c) * img.w * 3 + ch;
    unsigned char* orow = out + size_t(y) * tw;
    for (int x = 0; x < tw; ++x) {
      int xd = flip ? (tw - 1 - x) : x;
      const int x0c = ct.x0[x] * 3, x1c = ct.x1[x] * 3;
      const float wx = ct.wx[x];
      float top = r0[x0c] * (1 - wx) + r0[x1c] * wx;
      float bot = r1[x0c] * (1 - wx) + r1[x1c] * wx;
      float v = top * (1 - wy) + bot * wy;
      v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
      orow[xd] = (unsigned char)(v + 0.5f);
    }
  }
}

// Bilinear-resample one stride-1 plane to (th, tw) with output stride
// `ostride`; fast row copy (or reversed copy under flip) when the plane is
// already at target size.
void resample_plane_u8(const Plane& p, unsigned char* out, int th, int tw,
                       int ostride, int flip) {
  if (p.h == th && p.w == tw) {
    for (int y = 0; y < th; ++y) {
      const unsigned char* src = p.data.data() + size_t(y) * p.w;
      unsigned char* orow = out + size_t(y) * ostride;
      if (!flip) {
        memcpy(orow, src, tw);
      } else {
        for (int x = 0; x < tw; ++x) orow[tw - 1 - x] = src[x];
      }
    }
    return;
  }
  const float sy = float(p.h) / th;
  ColTab ct(tw, p.w);
  for (int y = 0; y < th; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = (int)floorf(fy);
    float wy = fy - y0;
    int y0c = y0 < 0 ? 0 : (y0 >= p.h ? p.h - 1 : y0);
    int y1c = y0 + 1 < 0 ? 0 : (y0 + 1 >= p.h ? p.h - 1 : y0 + 1);
    const unsigned char* r0 = p.data.data() + size_t(y0c) * p.w;
    const unsigned char* r1 = p.data.data() + size_t(y1c) * p.w;
    unsigned char* orow = out + size_t(y) * ostride;
    for (int x = 0; x < tw; ++x) {
      int xd = flip ? (tw - 1 - x) : x;
      const float wx = ct.wx[x];
      float top = r0[ct.x0[x]] * (1 - wx) + r0[ct.x1[x]] * wx;
      float bot = r1[ct.x0[x]] * (1 - wx) + r1[ct.x1[x]] * wx;
      float v = top * (1 - wy) + bot * wy;
      v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
      orow[xd] = (unsigned char)(v + 0.5f);
    }
  }
}

bool is_jpeg_file(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  unsigned char magic[2] = {0, 0};
  size_t got = fread(magic, 1, 2, f);
  fclose(f);
  return got == 2 && magic[0] == 0xFF && magic[1] == 0xD8;
}

}  // namespace

extern "C" {

// Packed-I420 loaders: `out` holds (oh*3/2, ow) uint8 — see file header.
// oh and ow must be even.
int sph_load_image_yuv(const char* path, unsigned char* out, int oh, int ow,
                       int flip) {
  if (oh % 2 || ow % 2) return 2;
  // Fast path: raw-plane decode (native 4:2:0, no chroma round trip).
  if (is_jpeg_file(path)) {
    Plane planes[3];
    FILE* f = fopen(path, "rb");
    bool ok = f && decode_jpeg_raw_planes(f, planes);
    if (f) fclose(f);
    if (ok && planes[0].w > 0 && planes[0].h > 0) {
      unsigned char* yplane = out;
      unsigned char* uplane = out + size_t(oh) * ow;
      resample_plane_u8(planes[0], yplane, oh, ow, ow, flip);
      resample_plane_u8(planes[1], uplane, oh / 2, ow / 2, ow, flip);
      resample_plane_u8(planes[2], uplane + ow / 2, oh / 2, ow / 2, ow,
                        flip);
      return 0;
    }
  }
  Image img;
  if (!load_ycbcr(path, &img, oh, ow)) return 1;
  unsigned char* yplane = out;
  unsigned char* uplane = out + size_t(oh) * ow;
  // Chroma strip rows are full-width (ow); U occupies columns [0, ow/2),
  // V occupies [ow/2, ow). Resample row-by-row with stride ow.
  resample_channel_u8(img, 0, yplane, oh, ow, flip);
  // U/V planes are (oh/2, ow/2) but live inside a stride-ow strip: resample
  // into a contiguous scratch then interleave rows.
  const int ch2 = oh / 2, cw2 = ow / 2;
  std::vector<unsigned char> scratch(size_t(ch2) * cw2 * 2);
  resample_channel_u8(img, 1, scratch.data(), ch2, cw2, flip);
  resample_channel_u8(img, 2, scratch.data() + size_t(ch2) * cw2, ch2, cw2,
                      flip);
  for (int y = 0; y < ch2; ++y) {
    memcpy(uplane + size_t(y) * ow, scratch.data() + size_t(y) * cw2, cw2);
    memcpy(uplane + size_t(y) * ow + cw2,
           scratch.data() + size_t(ch2) * cw2 + size_t(y) * cw2, cw2);
  }
  return 0;
}

int sph_load_batch_yuv(const char** paths, int n, unsigned char* out, int oh,
                       int ow, const int* flips, int n_threads) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0), failed(0);
  const size_t stride = size_t(oh) * 3 / 2 * ow;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      unsigned char* dst = out + size_t(i) * stride;
      if (sph_load_image_yuv(paths[i], dst, oh, ow,
                             flips ? flips[i] : 0) != 0) {
        failed.fetch_add(1);
        memset(dst, 0, stride);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failed.load();
}

int sph_load_image(const char* path, float* out, int oh, int ow,
                   const float* mean, const float* stdv, int flip) {
  Image img;
  if (!load_rgb(path, &img, oh, ow)) return 1;
  resize_normalize(img, out, oh, ow, mean, stdv, flip);
  return 0;
}

int sph_load_batch(const char** paths, int n, float* out, int oh, int ow,
                   const float* mean, const float* stdv, const int* flips,
                   int n_threads) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0), failed(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      float* dst = out + size_t(i) * oh * ow * 3;
      if (sph_load_image(paths[i], dst, oh, ow, mean, stdv,
                         flips ? flips[i] : 0) != 0) {
        failed.fetch_add(1);
        memset(dst, 0, size_t(oh) * ow * 3 * sizeof(float));
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failed.load();
}

int sph_load_image_u8(const char* path, unsigned char* out, int oh, int ow,
                      int flip) {
  Image img;
  if (!load_rgb(path, &img, oh, ow)) return 1;
  resize_u8(img, out, oh, ow, flip);
  return 0;
}

int sph_load_batch_u8(const char** paths, int n, unsigned char* out, int oh,
                      int ow, const int* flips, int n_threads) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0), failed(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      unsigned char* dst = out + size_t(i) * oh * ow * 3;
      if (sph_load_image_u8(paths[i], dst, oh, ow,
                            flips ? flips[i] : 0) != 0) {
        failed.fetch_add(1);
        memset(dst, 0, size_t(oh) * ow * 3);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failed.load();
}

}  // extern "C"
