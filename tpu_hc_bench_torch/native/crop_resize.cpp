// C entry point of crop_resize.h for a decoder that decodes elsewhere: the
// pil decoder of tpu_hc_bench_torch.native decodes with PIL (its bundled
// libjpeg-turbo, DCT-scaled through Image.draft) and hands the RGB pixels
// here, so its crops take the same arithmetic as the libjpeg decoder's.
// Needs no libjpeg headers.
//
// C ABI (ctypes):
//   thb_crop_resize(pixels, w, h, denom, cx, cy, cw, ch, out_size, flip, out)
//       pixels: w x h x 3 uint8, decoded at 1/denom of the full resolution;
//       crop [cx, cy, cw, ch] in full-resolution coordinates, bilinear
//       resize to [out_size, out_size, 3], optional horizontal flip.
//       -> 0, or 2 on a crop outside the image.
//
// Built by tpu_hc_bench_torch.native at first use (g++, no libraries).

#include "crop_resize.h"

extern "C" int thb_crop_resize(const uint8_t* pixels, int w, int h,
                               int denom, int cx, int cy, int cw, int ch,
                               int out_size, int flip, uint8_t* out) {
  if (w <= 0 || h <= 0 || denom <= 0 || cw <= 0 || ch <= 0 || out_size <= 0)
    return 2;
  return thb_crop_resize_rgb(pixels, w, h, denom, cx, cy, cw, ch, out_size,
                             flip, out);
}
