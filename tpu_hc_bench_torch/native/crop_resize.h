// Crop + bilinear resize + optional flip of a decoded RGB image, shared by
// the two JPEG decoders of the port (jpeg_decoder.cpp on libjpeg,
// nvjpeg_decoder.cpp on nvJPEG), so both produce the same pixels from the
// same decoded image.  The arithmetic is the JAX package's
// thb_decode_crop_resize, unchanged.

#pragma once

#include <cstddef>
#include <cstdint>

// `pixels` is a w x h RGB image decoded at 1/denom of the JPEG's full
// resolution; [cx, cy, cw, ch] is the crop in full-resolution coordinates.
// Writes out_size x out_size x 3 bytes to `out`.  -> 0, or 2 on a crop that
// falls outside the image.
inline int thb_crop_resize_rgb(const uint8_t* pixels, int w, int h, int denom,
                               int cx, int cy, int cw, int ch, int out_size,
                               int flip, uint8_t* out) {
  // crop coordinates in the (possibly DCT-downscaled) image
  int sx = cx / denom, sy = cy / denom;
  int sw = cw / denom, sh = ch / denom;
  if (sw < 1) sw = 1;
  if (sh < 1) sh = 1;
  if (sx + sw > w) sx = w - sw;
  if (sy + sh > h) sy = h - sh;
  if (sx < 0 || sy < 0) return 2;

  // bilinear resize crop -> out_size x out_size (align-corners=false,
  // matching PIL/TF conventions)
  const float scale_x = static_cast<float>(sw) / out_size;
  const float scale_y = static_cast<float>(sh) / out_size;
  for (int oy = 0; oy < out_size; ++oy) {
    float fy = (oy + 0.5f) * scale_y - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    if (y0 > sh - 1) y0 = sh - 1;
    int y1 = y0 + 1 > sh - 1 ? sh - 1 : y0 + 1;
    float wy = fy - y0;
    const uint8_t* row0 = pixels + (static_cast<size_t>(sy + y0) * w + sx) * 3;
    const uint8_t* row1 = pixels + (static_cast<size_t>(sy + y1) * w + sx) * 3;
    for (int ox = 0; ox < out_size; ++ox) {
      float fx = (ox + 0.5f) * scale_x - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      if (x0 > sw - 1) x0 = sw - 1;
      int x1 = x0 + 1 > sw - 1 ? sw - 1 : x0 + 1;
      float wx = fx - x0;
      int out_x = flip ? (out_size - 1 - ox) : ox;
      uint8_t* dst = out + (static_cast<size_t>(oy) * out_size + out_x) * 3;
      for (int c = 0; c < 3; ++c) {
        float top = row0[x0 * 3 + c] * (1 - wx) + row0[x1 * 3 + c] * wx;
        float bot = row1[x0 * 3 + c] * (1 - wx) + row1[x1 * 3 + c] * wx;
        float v = top * (1 - wy) + bot * wy;
        dst[c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
  return 0;
}
