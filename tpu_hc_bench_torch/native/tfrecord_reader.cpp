// Native TFRecord scanner: CRC32C (slicing-by-8) + record indexing.
//
// A copy of the JAX package's scanner for the port's input pipeline.  It
// scans TFRecord shards, verifies the masked CRC32C framing, and returns
// (offset, length) indices so the Python pipeline can slice records out of
// one buffer-read, instead of framing and checking every record in Python
// (pure-Python CRC32C runs at ~1 MB/s; this at ~GB/s).
//
// C ABI (consumed via ctypes from tpu_hc_bench_torch.native):
//   uint32_t thb_crc32c(const uint8_t* data, uint64_t len);
//   uint32_t thb_masked_crc32c(const uint8_t* data, uint64_t len);
//   int64_t  thb_index_file(const char* path, int verify,
//                           uint64_t** offsets, uint64_t** lengths);
//     -> record count (>=0), or -errno-style negative on error;
//        *offsets/*lengths are malloc'd arrays the caller frees with
//        thb_free.  offsets point at record *payload* start.
//   void     thb_free(void* p);

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// CRC32C, slicing-by-8
// ---------------------------------------------------------------------------

uint32_t g_table[8][256];
bool g_init = false;

void init_tables() {
  const uint32_t poly = 0x82F63B78u;  // reflected Castagnoli
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int k = 0; k < 8; ++k) crc = (crc & 1) ? (crc >> 1) ^ poly : crc >> 1;
    g_table[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = g_table[0][i];
    for (int s = 1; s < 8; ++s) {
      crc = g_table[0][crc & 0xFF] ^ (crc >> 8);
      g_table[s][i] = crc;
    }
  }
  g_init = true;
}

inline uint32_t crc32c_impl(const uint8_t* p, uint64_t len) {
  if (!g_init) init_tables();
  uint32_t crc = 0xFFFFFFFFu;
  while (len >= 8) {
    uint64_t chunk;
    memcpy(&chunk, p, 8);
    crc ^= static_cast<uint32_t>(chunk);
    uint32_t hi = static_cast<uint32_t>(chunk >> 32);
    crc = g_table[7][crc & 0xFF] ^ g_table[6][(crc >> 8) & 0xFF] ^
          g_table[5][(crc >> 16) & 0xFF] ^ g_table[4][crc >> 24] ^
          g_table[3][hi & 0xFF] ^ g_table[2][(hi >> 8) & 0xFF] ^
          g_table[1][(hi >> 16) & 0xFF] ^ g_table[0][hi >> 24];
    p += 8;
    len -= 8;
  }
  while (len--) crc = g_table[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

inline uint32_t mask_crc(uint32_t crc) {
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

}  // namespace

extern "C" {

uint32_t thb_crc32c(const uint8_t* data, uint64_t len) {
  return crc32c_impl(data, len);
}

uint32_t thb_masked_crc32c(const uint8_t* data, uint64_t len) {
  return mask_crc(crc32c_impl(data, len));
}

int64_t thb_index_file(const char* path, int verify, uint64_t** offsets_out,
                       uint64_t** lengths_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -static_cast<int64_t>(errno ? errno : 1);

  std::vector<uint64_t> offsets, lengths;
  std::vector<uint8_t> buf;
  uint64_t pos = 0;
  int64_t err = 0;

  for (;;) {
    uint8_t header[12];
    size_t got = fread(header, 1, 12, f);
    if (got == 0) break;  // clean EOF
    if (got < 12) { err = -EIO; break; }
    uint64_t length;
    uint32_t len_crc;
    memcpy(&length, header, 8);
    memcpy(&len_crc, header + 8, 4);
    if (verify && mask_crc(crc32c_impl(header, 8)) != len_crc) {
      err = -EBADMSG; break;
    }
    uint64_t payload_off = pos + 12;
    if (verify) {
      buf.resize(length);
      if (fread(buf.data(), 1, length, f) != length) { err = -EIO; break; }
      uint32_t data_crc;
      if (fread(&data_crc, 1, 4, f) != 4) { err = -EIO; break; }
      if (mask_crc(crc32c_impl(buf.data(), length)) != data_crc) {
        err = -EBADMSG; break;
      }
    } else {
      if (fseek(f, static_cast<long>(length) + 4, SEEK_CUR) != 0) {
        err = -EIO; break;
      }
    }
    offsets.push_back(payload_off);
    lengths.push_back(length);
    pos = payload_off + length + 4;
  }
  fclose(f);
  if (err) return err;

  auto* off = static_cast<uint64_t*>(malloc(offsets.size() * sizeof(uint64_t)));
  auto* len = static_cast<uint64_t*>(malloc(lengths.size() * sizeof(uint64_t)));
  if ((!off || !len) && !offsets.empty()) {
    free(off); free(len);
    return -ENOMEM;
  }
  memcpy(off, offsets.data(), offsets.size() * sizeof(uint64_t));
  memcpy(len, lengths.data(), lengths.size() * sizeof(uint64_t));
  *offsets_out = off;
  *lengths_out = len;
  return static_cast<int64_t>(offsets.size());
}

void thb_free(void* p) { free(p); }

}  // extern "C"
