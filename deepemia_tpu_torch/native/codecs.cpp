// Byte-loop decoders of the TIFF compressions that zlib does not cover
// (C ABI, ctypes-loaded by deepemia_tpu_torch/native/__init__.py):
// LZW (compression 5, libtiff's MSB-first codes with the early code-width
// change) and PackBits (compression 32773).
//
// Built on first use: g++ -O2 -shared -fPIC codecs.cpp -o
// build/torch_native/libcodecs-<hash>.so
//
// Each decoder writes at most `cap` bytes into `dst` and returns the count
// written, or a negative code: -1 a code that refers past the table (corrupt
// stream), -2 old-style (LSB-first) LZW, which this decoder does not read.
// A stream that ends early returns the bytes it decoded; the caller checks
// the count against what the strip must hold.

#include <cstdint>

extern "C" {

int64_t lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  if (n >= 2 && src[0] == 0 && (src[1] & 1)) return -2;
  const int kClear = 256, kEoi = 257, kMaxCode = 4096;
  // every table entry is (prefix entry, last byte, length); strings are
  // written back to front from the chain
  static thread_local int16_t prefix[kMaxCode];
  static thread_local uint8_t suffix[kMaxCode];
  static thread_local uint8_t first[kMaxCode];
  static thread_local uint16_t length[kMaxCode];
  for (int i = 0; i < 256; ++i) {
    prefix[i] = -1; suffix[i] = (uint8_t)i; first[i] = (uint8_t)i; length[i] = 1;
  }
  int64_t out = 0;
  uint64_t bits = 0;  // bit buffer, MSB first
  int nbits = 0;
  int64_t pos = 0;
  int width = 9, next = 258, old = -1;
  while (true) {
    while (nbits < width && pos < n) {
      bits = (bits << 8) | src[pos++];
      nbits += 8;
    }
    if (nbits < width) break;  // stream ended without EOI
    int code = (int)((bits >> (nbits - width)) & ((1u << width) - 1));
    nbits -= width;
    if (code == kEoi) break;
    if (code == kClear) {
      width = 9; next = 258; old = -1;
      continue;
    }
    int entry;
    if (old < 0) {
      if (code > 255) return -1;
      entry = code;
    } else if (code < next) {
      entry = code;
      if (next < kMaxCode) {
        prefix[next] = (int16_t)old; suffix[next] = first[code];
        first[next] = first[old]; length[next] = (uint16_t)(length[old] + 1);
        ++next;
      }
    } else if (code == next && next < kMaxCode) {
      prefix[next] = (int16_t)old; suffix[next] = first[old];
      first[next] = first[old]; length[next] = (uint16_t)(length[old] + 1);
      entry = next++;
    } else {
      return -1;
    }
    int len = length[entry];
    // a string that runs past the buffer is cut, as libtiff cuts it
    int64_t end = out + len;
    int e = entry;
    for (int64_t k = end - 1; k >= out; --k) {
      if (k < cap) dst[k] = suffix[e];
      e = prefix[e];
    }
    out = end < cap ? end : cap;
    if (out >= cap) break;
    old = entry;
    // early change: the width grows one code before the table fills it
    if (next + 1 >= (1 << width) && width < 12) ++width;
  }
  return out;
}

int64_t packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  int64_t pos = 0, out = 0;
  while (pos < n && out < cap) {
    int h = (int8_t)src[pos++];
    if (h >= 0) {
      for (int k = 0; k <= h && pos < n && out < cap; ++k) dst[out++] = src[pos++];
    } else if (h != -128) {
      if (pos >= n) break;
      uint8_t v = src[pos++];
      for (int k = 0; k < 1 - h && out < cap; ++k) dst[out++] = v;
    }
  }
  return out;
}

}  // extern "C"
