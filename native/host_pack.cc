// libimagepipe_host: native host-side decode/pack helpers.
//
// The device does the pixel math; the host side still has real native work:
// unpacking camera bitstreams (12/14-bit packed little/big-endian rows into
// u16 planes) and staging/interleave conversions. The reference delegates
// this to the rawloader crate's Rust decoders (SURVEY.md L0); here it's a
// small C library bound via ctypes (imagepipe_tpu/native.py), with numpy
// fallbacks when the library isn't built.

#include <cstdint>
#include <cstring>

extern "C" {

// 12-bit packed, little-endian bit order (2 pixels in 3 bytes):
// byte0 = p0[7:0]; byte1 = p1[3:0]<<4 | p0[11:8]; byte2 = p1[11:4].
void unpack_12le(const uint8_t* src, uint16_t* dst, int64_t npix) {
  int64_t i = 0, o = 0;
  for (; o + 2 <= npix; o += 2, i += 3) {
    uint32_t b0 = src[i], b1 = src[i + 1], b2 = src[i + 2];
    dst[o] = (uint16_t)(((b1 & 0x0f) << 8) | b0);
    dst[o + 1] = (uint16_t)((b2 << 4) | (b1 >> 4));
  }
  if (o < npix) {
    uint32_t b0 = src[i], b1 = src[i + 1];
    dst[o] = (uint16_t)(((b1 & 0x0f) << 8) | b0);
  }
}

// 12-bit packed, big-endian bit order (DNG/TIFF default FillOrder):
// byte0 = p0[11:4]; byte1 = p0[3:0]<<4 | p1[11:8]; byte2 = p1[7:0].
void unpack_12be(const uint8_t* src, uint16_t* dst, int64_t npix) {
  int64_t i = 0, o = 0;
  for (; o + 2 <= npix; o += 2, i += 3) {
    uint32_t b0 = src[i], b1 = src[i + 1], b2 = src[i + 2];
    dst[o] = (uint16_t)((b0 << 4) | (b1 >> 4));
    dst[o + 1] = (uint16_t)(((b1 & 0x0f) << 8) | b2);
  }
  if (o < npix) {
    uint32_t b0 = src[i], b1 = src[i + 1];
    dst[o] = (uint16_t)((b0 << 4) | (b1 >> 4));
  }
}

// 14-bit packed big-endian (4 pixels in 7 bytes).
void unpack_14be(const uint8_t* src, uint16_t* dst, int64_t npix) {
  int64_t i = 0, o = 0;
  for (; o + 4 <= npix; o += 4, i += 7) {
    uint64_t v = 0;
    for (int k = 0; k < 7; k++) v = (v << 8) | src[i + k];
    dst[o] = (uint16_t)((v >> 42) & 0x3fff);
    dst[o + 1] = (uint16_t)((v >> 28) & 0x3fff);
    dst[o + 2] = (uint16_t)((v >> 14) & 0x3fff);
    dst[o + 3] = (uint16_t)(v & 0x3fff);
  }
  // Tail pixels (rows are normally multiples of 4; handle stragglers bitwise)
  int bit = 0;
  for (; o < npix; o++) {
    uint32_t acc = 0;
    for (int k = 0; k < 14; k++) {
      int64_t byte = i + ((bit + k) >> 3);
      int off = 7 - ((bit + k) & 7);
      acc = (acc << 1) | ((src[byte] >> off) & 1);
    }
    dst[o] = (uint16_t)acc;
    bit += 14;
  }
}

// 16-bit big-endian -> host order.
void swap_16be(const uint8_t* src, uint16_t* dst, int64_t npix) {
  for (int64_t i = 0; i < npix; i++)
    dst[i] = (uint16_t)((src[i * 2] << 8) | src[i * 2 + 1]);
}

// Interleaved u8 RGB -> planar f32 [3][h*w], scaled 1/255.
void rgb8_to_planar_f32(const uint8_t* src, float* dst, int64_t npix) {
  float* r = dst;
  float* g = dst + npix;
  float* b = dst + 2 * npix;
  for (int64_t i = 0; i < npix; i++) {
    r[i] = src[i * 3 + 0] * (1.0f / 255.0f);
    g[i] = src[i * 3 + 1] * (1.0f / 255.0f);
    b[i] = src[i * 3 + 2] * (1.0f / 255.0f);
  }
}

}  // extern "C"
