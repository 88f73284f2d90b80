// JPEG decode on the GPU with nvJPEG (CUDA toolkit), then the same crop +
// bilinear resize + flip as jpeg_decoder.cpp (crop_resize.h), for machines
// that have a CUDA toolkit but no libjpeg headers.
//
// nvJPEG decodes the whole image at full resolution into device memory
// (interleaved RGB); the image comes back to the host and is cropped and
// resized there.  nvJPEG has no DCT scaling, so the crop is always resized
// from the full-resolution image (libjpeg's decoder resizes from a 1/2,
// 1/4 or 1/8 scale decode when the crop is at least twice the output size):
// at those sizes the two decoders' crops differ by more than rounding.
//
// One nvjpegHandle_t for the process; decode states (an nvJPEG state, a
// stream and a device buffer) are kept in a pool and handed to one call at
// a time, so the threads of a decode pool run concurrently without a
// thread-local state to tear down at thread exit.
//
// C ABI (ctypes), the names and contracts of jpeg_decoder.cpp's:
//   thb_jpeg_set_device(device)                 -> 0; the CUDA device
//       every later call decodes on (default 0)
//   thb_jpeg_dims(buf, len, &w, &h)             -> 0 on success, 1 when
//       nvJPEG cannot parse the stream, 3 on a CUDA/nvJPEG setup error
//   thb_decode_crop_resize(buf, len, cx, cy, cw, ch, out_size, flip, out)
//       -> 0 on success, 1 when nvJPEG cannot decode the stream, 2 on a
//       bad crop, 3 on a CUDA/nvJPEG setup or copy error
//
// Built by tpu_hc_bench_torch.native at first use (g++ ... -lnvjpeg
// -lcudart against $CUDA_HOME).

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

#include <cuda_runtime_api.h>
#include <nvjpeg.h>

#include "crop_resize.h"

namespace {

struct DecodeState {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* dev = nullptr;
  size_t cap = 0;
};

std::mutex g_mu;
nvjpegHandle_t g_handle = nullptr;
int g_device = 0;
std::vector<DecodeState*> g_free;  // states no call holds

bool handle_ready() {
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_handle) return true;
  if (cudaSetDevice(g_device) != cudaSuccess) return false;
  return nvjpegCreateSimple(&g_handle) == NVJPEG_STATUS_SUCCESS;
}

// A free state, or a new one; nullptr on a setup error.
DecodeState* take_state() {
  {
    std::lock_guard<std::mutex> lock(g_mu);
    if (!g_free.empty()) {
      DecodeState* s = g_free.back();
      g_free.pop_back();
      return s;
    }
  }
  auto* s = new DecodeState();
  if (nvjpegJpegStateCreate(g_handle, &s->state) != NVJPEG_STATUS_SUCCESS ||
      cudaStreamCreateWithFlags(&s->stream, cudaStreamNonBlocking) !=
          cudaSuccess) {
    delete s;  // a half-made state is not reused (its parts leak)
    return nullptr;
  }
  return s;
}

void give_back(DecodeState* s) {
  std::lock_guard<std::mutex> lock(g_mu);
  g_free.push_back(s);
}

// Decode `buf` to a w x h interleaved RGB image in `pixels` (host).
int decode_rgb(DecodeState* s, const uint8_t* buf, size_t len,
               std::vector<uint8_t>& pixels, int& w, int& h) {
  int nc = 0;
  nvjpegChromaSubsampling_t sub;
  int ws[NVJPEG_MAX_COMPONENT] = {0}, hs[NVJPEG_MAX_COMPONENT] = {0};
  if (nvjpegGetImageInfo(g_handle, buf, len, &nc, &sub, ws, hs) !=
      NVJPEG_STATUS_SUCCESS) {
    return 1;
  }
  w = ws[0];
  h = hs[0];
  if (w <= 0 || h <= 0) return 1;
  const size_t need = static_cast<size_t>(w) * h * 3;
  if (need > s->cap) {
    if (s->dev) cudaFree(s->dev);
    s->dev = nullptr;
    s->cap = 0;
    if (cudaMalloc(reinterpret_cast<void**>(&s->dev), need) != cudaSuccess) {
      return 3;
    }
    s->cap = need;
  }
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = s->dev;
  img.pitch[0] = static_cast<unsigned int>(w) * 3;
  if (nvjpegDecode(g_handle, s->state, buf, len, NVJPEG_OUTPUT_RGBI, &img,
                   s->stream) != NVJPEG_STATUS_SUCCESS) {
    // clear whatever the failed decode left queued on the stream
    cudaStreamSynchronize(s->stream);
    return 1;
  }
  pixels.resize(need);
  if (cudaMemcpyAsync(pixels.data(), s->dev, need, cudaMemcpyDeviceToHost,
                      s->stream) != cudaSuccess ||
      cudaStreamSynchronize(s->stream) != cudaSuccess) {
    return 3;
  }
  return 0;
}

}  // namespace

extern "C" {

int thb_jpeg_set_device(int device) {
  std::lock_guard<std::mutex> lock(g_mu);
  g_device = device;
  return 0;
}

int thb_jpeg_dims(const uint8_t* buf, size_t len, int* w, int* h) {
  if (!handle_ready()) return 3;
  int nc = 0;
  nvjpegChromaSubsampling_t sub;
  int ws[NVJPEG_MAX_COMPONENT] = {0}, hs[NVJPEG_MAX_COMPONENT] = {0};
  if (nvjpegGetImageInfo(g_handle, buf, len, &nc, &sub, ws, hs) !=
      NVJPEG_STATUS_SUCCESS) {
    return 1;
  }
  *w = ws[0];
  *h = hs[0];
  return 0;
}

int thb_decode_crop_resize(const uint8_t* buf, size_t len, int cx, int cy,
                           int cw, int ch, int out_size, int flip,
                           uint8_t* out) {
  if (cw <= 0 || ch <= 0 || out_size <= 0) return 2;
  if (!handle_ready()) return 3;
  if (cudaSetDevice(g_device) != cudaSuccess) return 3;
  DecodeState* s = take_state();
  if (!s) return 3;
  std::vector<uint8_t> pixels;
  int w = 0, h = 0;
  int rc = decode_rgb(s, buf, len, pixels, w, h);
  give_back(s);
  if (rc) return rc;
  return thb_crop_resize_rgb(pixels.data(), w, h, 1, cx, cy, cw, ch, out_size,
                             flip, out);
}

}  // extern "C"
