// Native decode plane: whole columns of JPEG, PNG, .npy and zlib(.npy)
// cells decoded straight into a preallocated (N, ...) batch array, one C
// call per column, outside the interpreter lock.
//
// A copy of petastorm_tpu/native/pt_decode.cc (the functions and their
// arithmetic are the same, so both produce the same bytes), with each
// library family guarded by __has_include: a host without libjpeg's or
// libpng's headers builds a library without that family's functions, and
// petastorm_tpu_torch/native.py reports which functions the library holds
// (capabilities()).  The PT_HAVE_* macros tell the build which libraries
// to link.
//
// C ABI (ctypes, petastorm_tpu_torch/native.py); every function returns 0
// on success, or (index + 1) of the first cell that failed or did not
// match the batch's shape, or -1 when scratch memory ran out:
//   pt_jpeg_decode_batch(srcs, lens, n, dst, h, w, c)         [libjpeg]
//   pt_jpeg_decode_resize_batch(srcs, lens, n, dst, h, w, c)  [libjpeg]
//   pt_png_decode_batch(srcs, lens, n, dst, h, w, c)          [libpng]
//   pt_png_decode_resize_batch(srcs, lens, n, dst, h, w, c)   [libpng]
//   pt_zlib_npy_decompress_batch(srcs, lens, n, dst, cell_bytes,
//                                expected_hdr, expected_hdr_len) [zlib]
//   pt_npy_copy_batch(srcs, lens, n, dst, cell_bytes,
//                     expected_hdr, expected_hdr_len)
// The .npy functions check that each cell's header dict starts with
// expected_hdr, the exact "{'descr': ..., 'fortran_order': False,
// 'shape': ...," prefix np.save writes for the batch's dtype and cell
// shape, so Fortran-ordered, reshaped or foreign-dtype cells are rejected
// and left to the caller's np.load.

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>

#if __has_include(<jpeglib.h>)
#include <jpeglib.h>
#define PT_HAVE_JPEG 1
#else
#define PT_HAVE_JPEG 0
#endif
#if __has_include(<png.h>)
#include <png.h>
#define PT_HAVE_PNG 1
#else
#define PT_HAVE_PNG 0
#endif
#if __has_include(<zlib.h>)
#include <zlib.h>
#define PT_HAVE_ZLIB 1
#else
#define PT_HAVE_ZLIB 0
#endif

namespace {

#if PT_HAVE_JPEG
struct ErrorMgr {
  jpeg_error_mgr pub;
  std::jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  std::longjmp(err->jump, 1);
}

void emit_message(j_common_ptr, int) {}  // silence corrupt-stream warnings

// Decode one JPEG into dst (h*w*c, C-contiguous). Returns true on success
// with exact dimension match.
bool decode_one(const uint8_t* src, size_t len, uint8_t* dst,
                unsigned h, unsigned w, unsigned c) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = emit_message;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(src),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  // Strict channel match with the schema: libjpeg would happily expand
  // grayscale to RGB (or fold color to gray), but the cv2 fallback raises on
  // such cells — the two paths must agree, so reject and let python decide.
  if ((c == 1) != (cinfo.num_components == 1)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = (c == 1) ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_width != w || cinfo.output_height != h ||
      static_cast<unsigned>(cinfo.output_components) != c) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  const size_t stride = static_cast<size_t>(w) * c;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = dst + stride * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

#endif  // PT_HAVE_JPEG

#if PT_HAVE_JPEG || PT_HAVE_PNG
// Separable fixed-point bilinear resize, half-pixel-center convention (the
// same sampling grid cv2.resize INTER_LINEAR uses; rounding differs by a
// couple of LSB — the python cv2 fallback is the semantic reference, this
// is its fast approximation and is documented as such).  Two passes with a
// two-row cache: horizontal interpolation to 15-bit intermediates (7-bit
// weights), then vertical blend — all int32, no float in the hot loop.
struct ResizeScratch {
  int* xtap = nullptr;        // per output x: src index pair
  int* wx = nullptr;          // per output x: 7-bit right-tap weight
  int32_t* rows = nullptr;    // 2 cached h-interpolated rows
  int cached[2] = {-1, -1};   // src row indices currently in the cache
  unsigned dw = 0, ch = 0;
  bool ok = false;

  ResizeScratch(unsigned dw_, unsigned ch_) : dw(dw_), ch(ch_) {
    xtap = new (std::nothrow) int[dw * 2];
    wx = new (std::nothrow) int[dw];
    rows = new (std::nothrow) int32_t[2 * static_cast<size_t>(dw) * ch];
    ok = xtap != nullptr && wx != nullptr && rows != nullptr;
  }
  ~ResizeScratch() {
    delete[] xtap;
    delete[] wx;
    delete[] rows;
  }
};

void hinterp_row(const uint8_t* src_row, int32_t* out, const int* xtap,
                 const int* wx, unsigned dw, unsigned ch) {
  for (unsigned x = 0; x < dw; ++x) {
    const size_t o0 = static_cast<size_t>(xtap[2 * x]) * ch;
    const size_t o1 = static_cast<size_t>(xtap[2 * x + 1]) * ch;
    const int w1 = wx[x], w0 = 128 - w1;
    for (unsigned k = 0; k < ch; ++k) {
      out[x * ch + k] = w0 * src_row[o0 + k] + w1 * src_row[o1 + k];
    }
  }
}

void resize_bilinear(const uint8_t* src, unsigned sh, unsigned sw,
                     uint8_t* dst, unsigned dh, unsigned dw, unsigned ch,
                     ResizeScratch* rs) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, static_cast<size_t>(sh) * sw * ch);
    return;
  }
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;
  for (unsigned x = 0; x < dw; ++x) {
    float fx = (x + 0.5f) * sx - 0.5f;
    if (fx < 0) fx = 0;
    int ix = static_cast<int>(fx);
    if (ix > static_cast<int>(sw) - 2) ix = static_cast<int>(sw) - 2;
    if (ix < 0) ix = 0;
    rs->xtap[2 * x] = ix;
    rs->xtap[2 * x + 1] = (sw > 1) ? ix + 1 : ix;
    float frac = fx - ix;
    if (frac < 0) frac = 0;
    if (frac > 1) frac = 1;
    rs->wx[x] = static_cast<int>(frac * 128.0f + 0.5f);
  }
  rs->cached[0] = rs->cached[1] = -1;
  const size_t sstride = static_cast<size_t>(sw) * ch;
  const size_t rstride = static_cast<size_t>(dw) * ch;
  for (unsigned y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int iy = static_cast<int>(fy);
    if (iy > static_cast<int>(sh) - 2) iy = static_cast<int>(sh) - 2;
    if (iy < 0) iy = 0;
    const int iy1 = (sh > 1) ? iy + 1 : iy;
    float frac = fy - iy;
    if (frac < 0) frac = 0;
    if (frac > 1) frac = 1;
    const int wy1 = static_cast<int>(frac * 128.0f + 0.5f);
    const int wy0 = 128 - wy1;
    int32_t* r0;
    int32_t* r1;
    // Two-row cache: consecutive output rows share source rows on
    // upscale, and iy1 of row y is often iy of row y+1 on mild downscale.
    if (rs->cached[0] == iy) {
      r0 = rs->rows;
    } else if (rs->cached[1] == iy) {
      r0 = rs->rows + rstride;
    } else {
      r0 = (rs->cached[0] == iy1) ? rs->rows + rstride : rs->rows;
      hinterp_row(src + sstride * iy, r0, rs->xtap, rs->wx, dw, ch);
      rs->cached[(r0 == rs->rows) ? 0 : 1] = iy;
    }
    if (rs->cached[0] == iy1) {
      r1 = rs->rows;
    } else if (rs->cached[1] == iy1) {
      r1 = rs->rows + rstride;
    } else {
      r1 = (r0 == rs->rows) ? rs->rows + rstride : rs->rows;
      hinterp_row(src + sstride * iy1, r1, rs->xtap, rs->wx, dw, ch);
      rs->cached[(r1 == rs->rows) ? 0 : 1] = iy1;
    }
    uint8_t* out = dst + static_cast<size_t>(y) * rstride;
    for (size_t i = 0; i < rstride; ++i) {
      // 15-bit h-interp * 7-bit v-weight = 22 bits; +rounding >>14.
      out[i] = static_cast<uint8_t>(
          (wy0 * r0[i] + wy1 * r1[i] + (1 << 13)) >> 14);
    }
  }
}

// Grow-on-demand scratch buffer (shared by the fused resize paths).
// Returns false on allocation failure; existing contents are discarded.
bool grow_scratch(uint8_t** scratch, size_t* cap, size_t need) {
  if (need <= *cap) return true;
  delete[] *scratch;
  *scratch = new (std::nothrow) uint8_t[need];
  *cap = (*scratch == nullptr) ? 0 : need;
  return *scratch != nullptr;
}

#endif  // PT_HAVE_JPEG || PT_HAVE_PNG

#if PT_HAVE_PNG
// Shared PNG header validation: begin_read + the 8-bit/no-alpha/channel
// rejections BOTH png entry points must agree on, and the output format
// request.  On false the image has been freed and the cell must fall
// back to python.
bool png_begin_validated(png_image* image, const uint8_t* src, size_t len,
                         int c) {
  std::memset(image, 0, sizeof(*image));
  image->version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(image, src, len)) {
    png_image_free(image);
    return false;
  }
  const bool src_color = (image->format & PNG_FORMAT_FLAG_COLOR) != 0;
  const bool src_alpha = (image->format & PNG_FORMAT_FLAG_ALPHA) != 0;
  const bool src_16bit = (image->format & PNG_FORMAT_FLAG_LINEAR) != 0;
  if (src_16bit || src_alpha || src_color != (c == 3)) {
    png_image_free(image);
    return false;
  }
  image->format = (c == 1) ? PNG_FORMAT_GRAY : PNG_FORMAT_RGB;
  return true;
}

#endif  // PT_HAVE_PNG

#if PT_HAVE_JPEG
// Decode one JPEG of ANY source size at the coarsest DCT scale that still
// covers (target_h, target_w), into a growable scratch buffer.  DCT-domain
// scaling makes a 1/2-scale decode cost ~1/4 of a full decode — the fused
// decode+resize win for datasets stored larger than the training
// resolution (e.g. raw ImageNet ~500x375 -> 224x224).
bool decode_one_scaled(const uint8_t* src, size_t len, uint8_t** scratch,
                       size_t* scratch_cap, unsigned* sh, unsigned* sw,
                       unsigned target_h, unsigned target_w, unsigned c) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = emit_message;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(src),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  if ((c == 1) != (cinfo.num_components == 1)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = (c == 1) ? JCS_GRAYSCALE : JCS_RGB;
  // Deep power-of-two scales only (1/8, 1/4): measured on this class of
  // host, the reduced IDCTs are scalar while the full 8x8 path is SIMD, so
  // 1/2-scale decode is SLOWER than full-size decode and intermediate
  // ratios (e.g. 5/8 -> 10x10 IDCT) are worse still; only >=4x linear
  // reductions win.  Anything shallower decodes full-size and leans on
  // the fixed-point resize.
  unsigned num = 8;
  const unsigned pow2_scales[2] = {1u, 2u};
  for (unsigned k : pow2_scales) {
    const unsigned skw = (cinfo.image_width * k + 7) / 8;
    const unsigned skh = (cinfo.image_height * k + 7) / 8;
    if (skw >= target_w && skh >= target_h) {
      num = k;
      break;
    }
  }
  cinfo.scale_num = num;
  cinfo.scale_denom = 8;
  jpeg_start_decompress(&cinfo);
  *sh = cinfo.output_height;
  *sw = cinfo.output_width;
  const size_t need =
      static_cast<size_t>(*sh) * *sw * cinfo.output_components;
  if (!grow_scratch(scratch, scratch_cap, need)) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  const size_t stride = static_cast<size_t>(*sw) * cinfo.output_components;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = *scratch + stride * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

#endif  // PT_HAVE_JPEG

}  // namespace

extern "C" {

#if PT_HAVE_JPEG

// Fused decode + resize: each JPEG (ANY source size) lands as an exactly
// (h, w, c) image in the caller's (N, H, W, C) batch.  DCT-scaled decode
// (coarsest 1/8-step scale covering the target) + separable bilinear.
// Same return contract as pt_jpeg_decode_batch.
int pt_jpeg_decode_resize_batch(const uint8_t** srcs, const size_t* lens,
                                int n, uint8_t* dst, int h, int w, int c) {
  const size_t img_bytes = static_cast<size_t>(h) * w * c;
  uint8_t* scratch = nullptr;
  size_t scratch_cap = 0;
  ResizeScratch rs(static_cast<unsigned>(w), static_cast<unsigned>(c));
  if (!rs.ok) return -1;
  int failed = 0;
  for (int i = 0; i < n; ++i) {
    unsigned sh = 0, sw = 0;
    if (!decode_one_scaled(srcs[i], lens[i], &scratch, &scratch_cap, &sh, &sw,
                           static_cast<unsigned>(h), static_cast<unsigned>(w),
                           static_cast<unsigned>(c))) {
      failed = i + 1;
      break;
    }
    resize_bilinear(scratch, sh, sw, dst + img_bytes * i,
                    static_cast<unsigned>(h), static_cast<unsigned>(w),
                    static_cast<unsigned>(c), &rs);
  }
  delete[] scratch;
  return failed;
}

int pt_jpeg_decode_batch(const uint8_t** srcs, const size_t* lens, int n,
                         uint8_t* dst, int h, int w, int c) {
  const size_t img_bytes = static_cast<size_t>(h) * w * c;
  for (int i = 0; i < n; ++i) {
    if (!decode_one(srcs[i], lens[i], dst + img_bytes * i,
                    static_cast<unsigned>(h), static_cast<unsigned>(w),
                    static_cast<unsigned>(c))) {
      return i + 1;
    }
  }
  return 0;
}

#endif  // PT_HAVE_JPEG

#if PT_HAVE_PNG
// Batch PNG -> grayscale/RGB decode via libpng's simplified API, straight
// into the caller's (N, H, W, C) uint8 batch slice (the PNG sibling of
// pt_jpeg_decode_batch; reference analog petastorm/codecs.py ::
// CompressedImageCodec.decode via cv2.imdecode + BGR->RGB pass).
// Rejections (caller falls back to cv2, keeping the two paths bit-identical):
//   * 16-bit sources (the simplified API would rescale; cv2 preserves raw
//     samples into uint16 — a different dtype entirely);
//   * channel-count mismatch with the schema (gray vs color vs alpha) —
//     libpng would happily convert, but the cv2 path errors, and the two
//     paths must agree.
int pt_png_decode_batch(const uint8_t** srcs, const size_t* lens, int n,
                        uint8_t* dst, int h, int w, int c) {
  const size_t img_bytes = static_cast<size_t>(h) * w * c;
  for (int i = 0; i < n; ++i) {
    png_image image;
    if (!png_begin_validated(&image, srcs[i], lens[i], c)) {
      return i + 1;
    }
    if (image.width != static_cast<png_uint_32>(w) ||
        image.height != static_cast<png_uint_32>(h)) {
      png_image_free(&image);
      return i + 1;
    }
    if (!png_image_finish_read(&image, nullptr, dst + img_bytes * i,
                               static_cast<png_int_32>(w * c), nullptr)) {
      png_image_free(&image);
      return i + 1;
    }
  }
  return 0;
}

// PNG sibling of pt_jpeg_decode_resize_batch: libpng has no scaled
// decode, so this is a full decode into scratch + the shared fixed-point
// bilinear — the point is keeping PNG columns on the fused zero-per-row
// columnar path, not decode savings.  Same rejections as
// pt_png_decode_batch (16-bit, alpha, channel mismatch).
int pt_png_decode_resize_batch(const uint8_t** srcs, const size_t* lens,
                               int n, uint8_t* dst, int h, int w, int c) {
  const size_t img_bytes = static_cast<size_t>(h) * w * c;
  uint8_t* scratch = nullptr;
  size_t scratch_cap = 0;
  ResizeScratch rs(static_cast<unsigned>(w), static_cast<unsigned>(c));
  if (!rs.ok) return -1;
  int failed = 0;
  for (int i = 0; i < n; ++i) {
    png_image image;
    if (!png_begin_validated(&image, srcs[i], lens[i], c)) {
      failed = i + 1;
      break;
    }
    const size_t need =
        static_cast<size_t>(image.height) * image.width * c;
    if (!grow_scratch(&scratch, &scratch_cap, need)) {
      png_image_free(&image);
      failed = -1;
      break;
    }
    const unsigned sh = image.height, sw = image.width;
    if (!png_image_finish_read(&image, nullptr, scratch,
                               static_cast<png_int_32>(sw * c), nullptr)) {
      png_image_free(&image);
      failed = i + 1;
      break;
    }
    resize_bilinear(scratch, sh, sw, dst + img_bytes * i,
                    static_cast<unsigned>(h), static_cast<unsigned>(w),
                    static_cast<unsigned>(c), &rs);
  }
  delete[] scratch;
  return failed;
}

#endif  // PT_HAVE_PNG

#if PT_HAVE_ZLIB
int pt_zlib_npy_decompress_batch(const uint8_t** srcs, const size_t* lens,
                                 int n, uint8_t* dst, size_t cell_bytes,
                                 const char* expected_hdr,
                                 size_t expected_hdr_len) {
  // Scratch holds one inflated .npy: magic(6) + version(2) + header-len
  // field (<=4) + header (<=64KiB, 64-byte aligned in practice) + data.
  const size_t scratch_cap = cell_bytes + 65536 + 16;
  uint8_t* scratch = new (std::nothrow) uint8_t[scratch_cap];
  if (scratch == nullptr) return -1;
  int failed = 0;
  for (int i = 0; i < n; ++i) {
    uLongf out_len = static_cast<uLongf>(scratch_cap);
    int rc = uncompress(scratch, &out_len, srcs[i],
                        static_cast<uLong>(lens[i]));
    if (rc != Z_OK || out_len < 10 ||
        std::memcmp(scratch, "\x93NUMPY", 6) != 0) {
      failed = i + 1;
      break;
    }
    const uint8_t major = scratch[6];
    size_t hdr_off, hlen;
    if (major == 1) {
      hdr_off = 10;
      hlen = scratch[8] | (scratch[9] << 8);
    } else if (major == 2 || major == 3) {
      if (out_len < 12) { failed = i + 1; break; }
      hdr_off = 12;
      hlen = static_cast<size_t>(scratch[8]) |
             (static_cast<size_t>(scratch[9]) << 8) |
             (static_cast<size_t>(scratch[10]) << 16) |
             (static_cast<size_t>(scratch[11]) << 24);
    } else {
      failed = i + 1;
      break;
    }
    const size_t data_off = hdr_off + hlen;
    if (out_len != data_off + cell_bytes ||  // payload size mismatch
        hlen < expected_hdr_len ||           // header can't hold the prefix
        std::memcmp(scratch + hdr_off, expected_hdr, expected_hdr_len) != 0) {
      failed = i + 1;  // fortran_order / shape / dtype differs from schema
      break;
    }
    std::memcpy(dst + cell_bytes * i, scratch + data_off, cell_bytes);
  }
  delete[] scratch;
  return failed;
}

#endif  // PT_HAVE_ZLIB

// Raw .npy sibling of pt_zlib_npy_decompress_batch: NdarrayCodec cells
// store np.save bytes UNCOMPRESSED, so the delivery-plane hot path for
// pre-decoded tensor datasets (the north-star streaming feed once JPEG
// is out of the loop) is header-validate + one memcpy per cell.  Doing
// the whole column in one GIL-free call replaces a python np.load
// (BytesIO + format dispatch + allocation) per cell.  Same contract and
// same expected-header prefix rejection as the zlib variant.
int pt_npy_copy_batch(const uint8_t** srcs, const size_t* lens, int n,
                      uint8_t* dst, size_t cell_bytes,
                      const char* expected_hdr, size_t expected_hdr_len) {
  for (int i = 0; i < n; ++i) {
    const uint8_t* p = srcs[i];
    const size_t len = lens[i];
    if (len < 10 || std::memcmp(p, "\x93NUMPY", 6) != 0) return i + 1;
    const uint8_t major = p[6];
    size_t hdr_off, hlen;
    if (major == 1) {
      hdr_off = 10;
      hlen = static_cast<size_t>(p[8]) | (static_cast<size_t>(p[9]) << 8);
    } else if (major == 2 || major == 3) {
      if (len < 12) return i + 1;
      hdr_off = 12;
      hlen = static_cast<size_t>(p[8]) | (static_cast<size_t>(p[9]) << 8) |
             (static_cast<size_t>(p[10]) << 16) |
             (static_cast<size_t>(p[11]) << 24);
    } else {
      return i + 1;
    }
    if (len < hdr_off + hlen) return i + 1;
    const size_t data_off = hdr_off + hlen;
    if (len != data_off + cell_bytes ||     // payload size mismatch
        hlen < expected_hdr_len ||          // header can't hold the prefix
        std::memcmp(p + hdr_off, expected_hdr, expected_hdr_len) != 0) {
      return i + 1;  // fortran_order / shape / dtype differs from schema
    }
    std::memcpy(dst + cell_bytes * i, p + data_off, cell_bytes);
  }
  return 0;
}

}  // extern "C"
