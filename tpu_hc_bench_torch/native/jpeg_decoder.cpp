// Native JPEG decode + crop + bilinear resize for the ImageNet pipeline.
//
// A copy of the JAX package's decoder for the port: one C call turns a JPEG
// byte string into a ready [size, size, 3] uint8 crop, skipping the
// PIL/Python object churn of a pure-Python path.  Uses the system
// libjpeg(-turbo) and its DCT scaling (decode directly at 1/2, 1/4, 1/8
// resolution when the target is small -- most of the speedup on large
// ImageNet photos).  The crop and resize are crop_resize.h's, which the
// nvJPEG decoder (nvjpeg_decoder.cpp) shares.
//
// C ABI (ctypes, like tfrecord_reader.cpp):
//   thb_jpeg_dims(buf, len, &w, &h)            -> 0 on success
//   thb_decode_crop_resize(buf, len, cx, cy, cw, ch, out_size, flip, out)
//       decode, crop [cx, cy, cw, ch] (full-resolution coordinates),
//       bilinear-resize to [out_size, out_size, 3], optional horizontal
//       flip; out must hold out_size*out_size*3 bytes.  -> 0 on success.
//
// Built by tpu_hc_bench_torch.native at first use (g++ ... -ljpeg).

#include <csetjmp>
#include <cstdint>
#include <cstdio>   // jpeglib.h needs FILE declared first
#include <cstring>
#include <vector>

#include <jpeglib.h>

#include "crop_resize.h"

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode `buf` to RGB.  Picks the largest libjpeg DCT scale denominator in
// {1, 2, 4, 8} that keeps the decoded crop at least `min_crop` pixels on
// both axes (0 disables scaling).  Returns false on any libjpeg error.
bool decode_rgb(const uint8_t* buf, size_t len, int min_crop_w,
                int min_crop_h, int full_cw, int full_ch,
                std::vector<uint8_t>& pixels, int& w, int& h, int& denom) {
  jpeg_decompress_struct cinfo;
  ErrMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  denom = 1;
  if (min_crop_w > 0 && min_crop_h > 0) {
    for (int d = 2; d <= 8; d *= 2) {
      if (full_cw / d >= min_crop_w && full_ch / d >= min_crop_h) denom = d;
    }
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  w = cinfo.output_width;
  h = cinfo.output_height;
  pixels.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = pixels.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

}  // namespace

extern "C" {

int thb_jpeg_dims(const uint8_t* buf, size_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int thb_decode_crop_resize(const uint8_t* buf, size_t len, int cx, int cy,
                           int cw, int ch, int out_size, int flip,
                           uint8_t* out) {
  if (cw <= 0 || ch <= 0 || out_size <= 0) return 2;
  std::vector<uint8_t> pixels;
  int w = 0, h = 0, denom = 1;
  if (!decode_rgb(buf, len, out_size, out_size, cw, ch, pixels, w, h,
                  denom)) {
    return 1;
  }
  return thb_crop_resize_rgb(pixels.data(), w, h, denom, cx, cy, cw, ch,
                             out_size, flip, out);
}

}  // extern "C"
