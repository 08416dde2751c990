// Byte-loop decoders of the TIFF compressions that zlib does not cover
// (C ABI, ctypes-loaded by deepemia_tpu_torch/native/__init__.py):
// LZW (compression 5, libtiff's MSB-first codes with the early code-width
// change) and PackBits (compression 32773); and the JPEG decoder of
// read_image (jpeg_decode, below the TIFF decoders).
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

// ---------------------------------------------------------------------------
// JPEG: jpeg_decode returns the pixels cv2.imread(path, cv2.IMREAD_COLOR)
// returns with OpenCV 5.0's libjpeg-turbo 3.1 (before the EXIF orientation,
// which read_image applies), as [H, W, 3] BGR bytes. It follows libjpeg's
// own decoder step for step:
//   * markers (jdmarker.c): SOF0/SOF1 (sequential Huffman) and SOF2
//     (progressive Huffman) at 8-bit precision, DQT with 8- or 16-bit
//     entries (held as the 16-bit ISLOW_MULT_TYPE of a SIMD build), DHT
//     (jpeg_make_d_derived_tbl's checks), DRI, APP0 JFIF and APP14 Adobe
//     (the colour-space guess of jdapimin.c), quantization tables latched
//     at a component's first scan (jdinput.c);
//   * entropy decoding (jdhuff.c, jdphuff.c): a bit reader that stops at a
//     marker and then supplies zero bits, an MCU left all zero once the data
//     has run out (the gray of a truncated file), restart markers with
//     jpeg_resync_to_restart, the four progressive passes with EOBRUN;
//   * the integer IDCT (jidctint.c jpeg_idct_islow), whose output indexes
//     the range-limit table through RANGE_MASK (x & 1023, so an overflowed
//     sample wraps as libjpeg's does);
//   * upsampling (jdsample.c): the fancy (triangle) filters h2v1, h2v2 and
//     h1v2 (plain replication when a row holds two samples or fewer),
//     replication for other integral ratios; edge rows repeat (jdmainct.c's
//     context rows);
//   * colour (jdcolor.c): the fixed-point YCbCr -> RGB tables, RGB as is,
//     gray replicated; the caller may set the colour space, as libtiff sets
//     jpeg_color_space for the JPEG strips and tiles of a TIFF (tif_jpeg.c
//     JPEGPreDecode: YCbCr converted to RGB, any other photometric as
//     stored).
// Not decoded, each with its own status: arithmetic coding, lossless and
// hierarchical processes (SOF3, SOF5-7, SOF9-15), 12-bit precision, two or
// four components (CMYK, YCCK), and a progressive image whose scans leave
// any of the first ten coefficients unrefined, which libjpeg would smooth
// across blocks (jdcoefct.c decompress_smooth_data).

#include <algorithm>
#include <vector>

namespace {
namespace jpg {

enum Status {
  kOk = 0, kNeedBuffer = 1, kCorrupt = -1, kBadCoding = -2, kBadColor = -3, kBadPrecision = -4,
  kBadSmoothing = -5,
};

struct Fail {
  int status;
};

[[noreturn]] void fail(int status) { throw Fail{status}; }

// zigzag position -> natural index, with libjpeg's 16 extra entries that
// absorb a run past 63 in corrupt data
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huff {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[256];  // 8-bit lookahead: (length << 8) | symbol, 0 for longer codes
};

void derive(Huff& h, bool dc) {
  if (!h.defined) fail(kCorrupt);  // JERR_NO_HUFF_TABLE
  uint8_t size[257];
  int code_of[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < h.bits[l]; ++i) {
      if (p >= 256) fail(kCorrupt);
      size[p++] = (uint8_t)l;
    }
  }
  size[p] = 0;
  const int nsym = p;
  int code = 0, si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code_of[p++] = code++;
    if ((int64_t)code >= ((int64_t)1 << si)) fail(kCorrupt);
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (h.bits[l]) {
      h.valoffset[l] = p - code_of[p];
      p += h.bits[l];
      h.maxcode[l] = code_of[p - 1];
    } else {
      h.maxcode[l] = -1;
    }
  }
  h.valoffset[17] = 0;
  h.maxcode[17] = 0xFFFFF;
  std::fill(h.look, h.look + 256, 0);
  p = 0;
  for (int l = 1; l <= 8; ++l) {
    for (int i = 0; i < h.bits[l]; ++i, ++p) {
      const int lookbits = code_of[p] << (8 - l);
      for (int c = 0; c < (1 << (8 - l)); ++c) h.look[lookbits + c] = (uint16_t)((l << 8) | h.vals[p]);
    }
  }
  if (dc) {
    for (int i = 0; i < nsym; ++i) {
      if (h.vals[i] > 15) fail(kCorrupt);
    }
  }
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;          // Huffman tables of the current scan
  int bw = 0, bh = 0;          // blocks holding samples (ceil(width / 8))
  int bw_mcu = 0, bh_mcu = 0;  // blocks in the MCU-padded plane
  int width = 0, height = 0;   // downsampled size
  bool latched = false;
  int16_t quant[64] = {};      // natural order, as ISLOW_MULT_TYPE
  int coef_bits[64];
  std::vector<int16_t> coef;   // [bh_mcu][bw_mcu][64], natural order
  int last_dc = 0;
  int16_t* block(int by, int bx) { return coef.data() + ((size_t)by * bw_mcu + bx) * 64; }
};

struct Decoder {
  const uint8_t* d;
  size_t n, pos = 0;
  // frame
  bool progressive = false, saw_sof = false, saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  int color = -1;  // the caller's colour space: -1 guess (jdapimin.c), 0 YCbCr, 1 as stored
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[4];
  uint16_t qt[4][64] = {};
  bool qt_defined[4] = {};
  Huff dc_tab[4], ac_tab[4];
  int restart_interval = 0;
  // scan
  int ns = 0, scomp[4] = {}, ss = 0, se = 63, ah = 0, al = 0;
  // bit reader
  uint64_t acc = 0;
  int nbits = 0;
  int unread_marker = 0;  // a marker the reader stopped at (jdmarker.c's unread_marker)
  bool insufficient = false;
  int eobrun = 0, next_restart = 0;

  // -- bytes and markers --------------------------------------------------
  bool at_end() const { return pos >= n; }
  int byte() {  // past the end, libjpeg's source inserts an EOI
    if (pos >= n) throw Fail{kCorrupt};
    return d[pos++];
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  // next_marker(): skip garbage to 0xFF, then fill bytes; EOF reads as EOI
  int next_marker() {
    for (;;) {
      if (pos >= n) return 0xD9;
      int c = d[pos++];
      if (c != 0xFF) continue;
      while (pos < n && d[pos] == 0xFF) ++pos;
      if (pos >= n) return 0xD9;
      c = d[pos++];
      if (c != 0) return c;
    }
  }

  // -- bit reader (jdhuff.c jpeg_fill_bit_buffer) -------------------------
  void fill() {
    while (nbits <= 56 && unread_marker == 0) {
      if (pos >= n) {
        unread_marker = 0xD9;
        break;
      }
      int c = d[pos++];
      if (c == 0xFF) {
        do {
          if (pos >= n) {
            c = -1;
            break;
          }
          c = d[pos++];
        } while (c == 0xFF);
        if (c == -1) {
          unread_marker = 0xD9;
          break;
        }
        if (c == 0) {
          c = 0xFF;
        } else {
          unread_marker = c;
          break;
        }
      }
      acc |= (uint64_t)c << (56 - nbits);
      nbits += 8;
    }
  }
  // n bits; past the data they are zeros and the MCU is the last decoded
  int bits(int k) {
    if (k == 0) return 0;
    if (nbits < k) {
      fill();
      if (nbits < k) {
        insufficient = true;
        nbits = k;
      }
    }
    const int v = (int)(acc >> (64 - k));
    acc <<= k;
    nbits -= k;
    return v;
  }
  int bit() { return bits(1); }
  int decode(const Huff& h) {
    if (nbits < 8) fill();
    if (nbits >= 8) {
      const uint16_t e = h.look[acc >> 56];
      if (e) {
        const int l = e >> 8;
        acc <<= l;
        nbits -= l;
        return e & 0xFF;
      }
    }
    int code = 0, l = 0;
    do {
      code = (code << 1) | bit();
      ++l;
    } while (code > h.maxcode[l]);
    if (l > 16) return 0;  // JWRN_HUFF_BAD_CODE: a zero, as libjpeg fakes one
    return h.vals[code + h.valoffset[l]];
  }
  static int extend(int r, int s) { return r < (1 << (s - 1)) ? r + (int)((~0u << s) + 1) : r; }

  // -- restarts (jdhuff.c process_restart, jdmarker.c read_restart_marker)
  void process_restart() {
    acc = 0;
    nbits = 0;
    if (unread_marker == 0) unread_marker = next_marker();
    const int desired = 0xD0 + next_restart;
    if (unread_marker == desired) {
      unread_marker = 0;
    } else {
      resync(desired);
    }
    next_restart = (next_restart + 1) & 7;
    for (int i = 0; i < ncomp; ++i) comp[i].last_dc = 0;
    eobrun = 0;
    if (unread_marker == 0) insufficient = false;
  }
  void resync(int desired) {  // jpeg_resync_to_restart
    for (;;) {
      const int m = unread_marker;
      int action;
      if (m < 0xC0) {
        action = 2;
      } else if (m < 0xD0 || m > 0xD7) {
        action = 3;
      } else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7)) {
        action = 3;
      } else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action == 1) {
        unread_marker = 0;
        return;
      }
      if (action == 3) return;
      unread_marker = next_marker();
    }
  }

  // -- marker segments -----------------------------------------------------
  void read_dqt() {
    int len = u16() - 2;
    while (len > 0) {
      const int pq_tq = byte();
      const int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) fail(kCorrupt);
      for (int i = 0; i < 64; ++i) qt[tq][kNatural[i]] = (uint16_t)(pq ? u16() : byte());
      qt_defined[tq] = true;
      len -= 65 + (pq ? 64 : 0);
    }
    if (len != 0) fail(kCorrupt);
  }
  void read_dht() {
    int len = u16() - 2;
    while (len > 16) {
      const int tc_th = byte();
      const int tc = tc_th >> 4, th = tc_th & 15;
      uint8_t counts[17] = {};
      int total = 0;
      for (int l = 1; l <= 16; ++l) total += counts[l] = (uint8_t)byte();
      if (total > 256 || total > len - 17) fail(kCorrupt);
      Huff& h = (tc ? ac_tab : dc_tab)[th & 3];
      if (th > 3 || tc > 1) fail(kCorrupt);
      std::copy(counts, counts + 17, h.bits);
      std::fill(h.vals, h.vals + 256, 0);
      for (int i = 0; i < total; ++i) h.vals[i] = (uint8_t)byte();
      h.defined = true;
      len -= 17 + total;
    }
    if (len != 0) fail(kCorrupt);
  }
  void read_sof(int marker, bool alloc) {
    if (saw_sof) fail(kCorrupt);
    saw_sof = true;
    const int len = u16();
    const int precision = byte();
    height = u16();
    width = u16();
    ncomp = byte();
    if (len != 8 + ncomp * 3) fail(kCorrupt);
    if (precision != 8) fail(kBadPrecision);
    progressive = marker == 0xC2;
    if (height <= 0 || width <= 0 || ncomp <= 0) fail(kCorrupt);  // a DNL height is refused too
    if (ncomp != 1 && ncomp != 3) fail(kBadColor);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = byte();
      const int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail(kCorrupt);
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; alloc && i < ncomp; ++i) {
      Component& c = comp[i];
      c.width = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.height = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.bw = (c.width + 7) / 8;
      c.bh = (c.height + 7) / 8;
      c.bw_mcu = mcux * c.h;
      c.bh_mcu = mcuy * c.v;
      c.coef.assign((size_t)c.bw_mcu * c.bh_mcu * 64, 0);
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
  }
  void skip_segment() {
    const int len = u16();
    if (len < 2 || pos + (len - 2) > n) fail(kCorrupt);
    pos += len - 2;
  }
  void read_app(int marker) {
    const int len = u16();
    if (len < 2 || pos + (len - 2) > n) fail(kCorrupt);
    const uint8_t* p = d + pos;
    const int m = len - 2;
    if (marker == 0xE0 && m >= 14 && std::equal(p, p + 5, (const uint8_t*)"JFIF\0")) saw_jfif = true;
    if (marker == 0xEE && m >= 12 && std::equal(p, p + 5, (const uint8_t*)"Adobe")) {
      saw_adobe = true;
      adobe_transform = p[11];
    }
    pos += m;
  }
  void read_sos() {
    if (!saw_sof) fail(kCorrupt);
    const int len = u16();
    ns = byte();
    if (len != 6 + ns * 2 || ns < 1 || ns > 4) fail(kCorrupt);
    for (int i = 0; i < ns; ++i) {
      const int id = byte(), t = byte();
      int k = 0;
      while (k < ncomp && comp[k].id != id) ++k;
      if (k == ncomp) fail(kCorrupt);
      for (int j = 0; j < i; ++j) {
        if (scomp[j] == k) fail(kCorrupt);
      }
      scomp[i] = k;
      comp[k].td = t >> 4;
      comp[k].ta = t & 15;
      if (comp[k].td > 3 || comp[k].ta > 3) fail(kCorrupt);
    }
    ss = byte();
    se = byte();
    const int a = byte();
    ah = a >> 4;
    al = a & 15;
    if (progressive) {
      const bool dc = ss == 0;
      if (dc ? se != 0 : (ss > se || se > 63 || ns != 1)) fail(kCorrupt);
      if ((ah != 0 && al != ah - 1) || al > 13) fail(kCorrupt);
    } else {
      ss = 0;
      se = 63;
    }
    if (ns > 1) {
      int blocks = 0;
      for (int i = 0; i < ns; ++i) blocks += comp[scomp[i]].h * comp[scomp[i]].v;
      if (blocks > 10) fail(kCorrupt);  // JERR_BAD_MCU_SIZE
    }
    for (int i = 0; i < ns; ++i) {  // latch_quant_tables
      Component& c = comp[scomp[i]];
      if (!c.latched) {
        if (!qt_defined[c.tq]) fail(kCorrupt);
        for (int j = 0; j < 64; ++j) c.quant[j] = (int16_t)qt[c.tq][j];
        c.latched = true;
      }
    }
  }

  // -- entropy-coded segments ---------------------------------------------
  void decode_block_sequential(Component& c, int16_t* blk) {
    int s = decode(dc_tab[c.td]);
    if (s) s = extend(bits(s), s);
    s = (int)((unsigned)s + (unsigned)c.last_dc);
    c.last_dc = s;
    blk[0] = (int16_t)s;
    const Huff& act = ac_tab[c.ta];
    for (int k = 1; k < 64; ++k) {
      s = decode(act);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        r = bits(s);
        blk[kNatural[k]] = (int16_t)extend(r, s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }
  void dc_first(Component& c, int16_t* blk) {
    int s = decode(dc_tab[c.td]);
    if (s) s = extend(bits(s), s);
    s = (int)((unsigned)s + (unsigned)c.last_dc);
    c.last_dc = s;
    blk[0] = (int16_t)((unsigned)s << al);
  }
  void dc_refine(int16_t* blk) {
    if (bit()) blk[0] = (int16_t)(blk[0] | (1 << al));
  }
  void ac_first(Component& c, int16_t* blk) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const Huff& t = ac_tab[c.ta];
    for (int k = ss; k <= se; ++k) {
      int s = decode(t);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        r = bits(s);
        blk[kNatural[k]] = (int16_t)((unsigned)extend(r, s) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += bits(r);
        --eobrun;
        break;
      }
    }
  }
  void refine_coef(int16_t* coef, int p1, int m1) {
    if (bit() && (*coef & p1) == 0) *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
  }
  void ac_refine(Component& c, int16_t* blk) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    const Huff& t = ac_tab[c.ta];
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int s = decode(t);
        int r = s >> 4;
        s &= 15;
        if (s) {
          s = bit() ? p1 : m1;  // a size other than 1 is JWRN_HUFF_BAD_CODE, read the same
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += bits(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            refine_coef(coef, p1, m1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) refine_coef(coef, p1, m1);
      }
      --eobrun;
    }
  }
  void decode_unit(Component& c, int16_t* blk) {
    if (!progressive) {
      decode_block_sequential(c, blk);
    } else if (ss == 0) {
      if (ah == 0) {
        dc_first(c, blk);
      } else {
        dc_refine(blk);
      }
    } else if (ah == 0) {
      ac_first(c, blk);
    } else {
      ac_refine(c, blk);
    }
  }
  void decode_scan() {
    for (int i = 0; i < ns; ++i) {
      Component& c = comp[scomp[i]];
      c.last_dc = 0;
      if (!progressive) {
        derive(dc_tab[c.td], true);
        derive(ac_tab[c.ta], false);
      } else if (ss == 0) {
        if (ah == 0) derive(dc_tab[c.td], true);
      } else {
        derive(ac_tab[c.ta], false);
      }
      for (int k = ss; k <= se; ++k) c.coef_bits[k] = al;
    }
    acc = 0;
    nbits = 0;
    unread_marker = 0;
    insufficient = false;
    eobrun = 0;
    next_restart = 0;
    int restarts_to_go = restart_interval;
    if (ns == 1) {
      Component& c = comp[scomp[0]];
      for (int by = 0; by < c.bh; ++by) {
        for (int bx = 0; bx < c.bw; ++bx) {
          if (restart_interval) {
            if (restarts_to_go == 0) {
              process_restart();
              restarts_to_go = restart_interval;
            }
          }
          if (!insufficient) decode_unit(c, c.block(by, bx));
          if (restart_interval) --restarts_to_go;
        }
      }
    } else {
      for (int my = 0; my < mcuy; ++my) {
        for (int mx = 0; mx < mcux; ++mx) {
          if (restart_interval) {
            if (restarts_to_go == 0) {
              process_restart();
              restarts_to_go = restart_interval;
            }
          }
          if (!insufficient) {
            for (int i = 0; i < ns; ++i) {
              Component& c = comp[scomp[i]];
              for (int y = 0; y < c.v; ++y) {
                for (int x = 0; x < c.h; ++x) decode_unit(c, c.block(my * c.v + y, mx * c.h + x));
              }
            }
          }
          if (restart_interval) --restarts_to_go;
        }
      }
    }
  }

  // -- the whole stream (jdmarker.c read_markers) ----------------------------
  // With header_only, stops after the frame header.
  void run(bool header_only) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail(kCorrupt);
    pos = 2;
    bool saw_scan = false;
    int marker = next_marker();
    for (;;) {
      if (marker == 0xD9) break;  // EOI, or the end of the file
      if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 && marker != 0xC8 && marker != 0xCC) {
        if (marker != 0xC0 && marker != 0xC1 && marker != 0xC2) {
          coding = marker;
          fail(kBadCoding);
        }
        read_sof(marker, !header_only);
        if (header_only) return;
      } else if (marker == 0xC4) {
        read_dht();
      } else if (marker == 0xCC) {
        coding = marker;
        fail(kBadCoding);  // arithmetic conditioning
      } else if (marker == 0xDB) {
        read_dqt();
      } else if (marker == 0xDD) {
        if (u16() != 4) fail(kCorrupt);
        restart_interval = u16();
      } else if (marker == 0xDA) {
        if (header_only) fail(kCorrupt);  // a scan before the frame header
        read_sos();
        saw_scan = true;
        decode_scan();
        if (unread_marker != 0) {
          marker = unread_marker;
          unread_marker = 0;
          continue;
        }
      } else if (marker >= 0xE0 && marker <= 0xEF) {
        read_app(marker);
      } else if (marker == 0xDC || marker == 0xFE) {
        skip_segment();  // DNL (after the frame's height), COM
      } else if ((marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) {
        // a stray restart marker or TEM: no length
      } else {
        fail(kCorrupt);  // SOI again, DHP, EXP, JPGn, RESn: JERR_UNKNOWN_MARKER
      }
      marker = next_marker();
    }
    if (!saw_scan || header_only) fail(kCorrupt);  // JERR_NO_IMAGE
    if (progressive) check_smoothing();
  }
  int coding = 0;

  // libjpeg smooths a progressive image (jdcoefct.c smoothing_ok) when every
  // component's DC is at least partly known and any of the first ten
  // coefficients of any component is not fully refined
  void check_smoothing() {
    static const int kQ[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < ncomp; ++i) {
      const Component& c = comp[i];
      if (!c.latched) return;
      for (int q : kQ) {
        if (c.quant[q] == 0) return;
      }
      if (c.coef_bits[0] < 0) return;
      for (int k = 1; k < 10; ++k) useful |= c.coef_bits[k] != 0;
    }
    if (useful) fail(kBadSmoothing);
  }

  // -- IDCT (jidctint.c jpeg_idct_islow) -----------------------------------
  static uint8_t range_limit(int64_t x) {  // IDCT_range_limit[x & RANGE_MASK]
    int v = (int)(x & 1023);
    if (v >= 512) v -= 1024;
    v += 128;
    return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
  }
  static void idct(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633,
                  F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
    const int CB = 13, P1 = 2;
    auto descale = [](int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; };
    int ws[64];
    for (int c = 0; c < 8; ++c) {
      const int16_t* ip = in + c;
      const int16_t* qp = q + c;
      int* wp = ws + c;
      if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
        const int dc = (int)((unsigned)(ip[0] * qp[0]) << P1);
        for (int r = 0; r < 8; ++r) wp[r * 8] = dc;
        continue;
      }
      int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = ip[0] * qp[0];
      z3 = ip[32] * qp[32];
      int64_t tmp0 = (int64_t)((uint64_t)(z2 + z3) << CB);
      int64_t tmp1 = (int64_t)((uint64_t)(z2 - z3) << CB);
      const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
      tmp0 = ip[56] * qp[56];
      tmp1 = ip[40] * qp[40];
      tmp2 = ip[24] * qp[24];
      tmp3 = ip[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      wp[0] = (int)descale(t10 + tmp3, CB - P1);
      wp[56] = (int)descale(t10 - tmp3, CB - P1);
      wp[8] = (int)descale(t11 + tmp2, CB - P1);
      wp[48] = (int)descale(t11 - tmp2, CB - P1);
      wp[16] = (int)descale(t12 + tmp1, CB - P1);
      wp[40] = (int)descale(t12 - tmp1, CB - P1);
      wp[24] = (int)descale(t13 + tmp0, CB - P1);
      wp[32] = (int)descale(t13 - tmp0, CB - P1);
    }
    for (int r = 0; r < 8; ++r) {
      const int* wp = ws + r * 8;
      uint8_t* op = out + (size_t)r * stride;
      if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 && wp[7] == 0) {
        const uint8_t dc = range_limit(descale(wp[0], P1 + 3));
        for (int c = 0; c < 8; ++c) op[c] = dc;
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = (int64_t)((uint64_t)((int64_t)wp[0] + wp[4]) << CB);
      int64_t tmp1 = (int64_t)((uint64_t)((int64_t)wp[0] - wp[4]) << CB);
      const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = CB + P1 + 3;
      op[0] = range_limit(descale(t10 + tmp3, sh));
      op[7] = range_limit(descale(t10 - tmp3, sh));
      op[1] = range_limit(descale(t11 + tmp2, sh));
      op[6] = range_limit(descale(t11 - tmp2, sh));
      op[2] = range_limit(descale(t12 + tmp1, sh));
      op[5] = range_limit(descale(t12 - tmp1, sh));
      op[3] = range_limit(descale(t13 + tmp0, sh));
      op[4] = range_limit(descale(t13 - tmp0, sh));
    }
  }

  // -- upsampling (jdsample.c) ---------------------------------------------
  // plane: the component's samples, pitch bw_mcu * 8; out: width x height
  void upsample(const Component& c, const uint8_t* plane, uint8_t* out) const {
    const int pitch = c.bw_mcu * 8;
    const int hr = hmax / c.h, vr = vmax / c.v;
    const int dw = c.width, dh = c.height;
    const int ow = dw * hr;  // may pass the image width by up to hr - 1
    std::vector<uint8_t> row(ow);
    auto in_row = [&](int r) { return plane + (size_t)std::min(std::max(r, 0), dh - 1) * pitch; };
    auto put = [&](int y, const uint8_t* src) {
      if (y < height) std::copy(src, src + width, out + (size_t)y * width);
    };
    if (hr == 1 && vr == 1) {
      for (int y = 0; y < height; ++y) put(y, in_row(y));
    } else if (hr == 2 && vr == 1 && dw > 2) {  // h2v1_fancy_upsample
      for (int y = 0; y < dh; ++y) {
        const uint8_t* ip = in_row(y);
        uint8_t* op = row.data();
        int v = ip[0];
        *op++ = (uint8_t)v;
        *op++ = (uint8_t)((v * 3 + ip[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          v = ip[x] * 3;
          *op++ = (uint8_t)((v + ip[x - 1] + 1) >> 2);
          *op++ = (uint8_t)((v + ip[x + 1] + 2) >> 2);
        }
        v = ip[dw - 1];
        *op++ = (uint8_t)((v * 3 + ip[dw - 2] + 1) >> 2);
        *op++ = (uint8_t)v;
        put(y, row.data());
      }
    } else if (hr == 2 && vr == 2 && dw > 2) {  // h2v2_fancy_upsample
      for (int y = 0; y < dh; ++y) {
        for (int half = 0; half < 2; ++half) {
          const uint8_t* i0 = in_row(y);
          const uint8_t* i1 = in_row(half == 0 ? y - 1 : y + 1);
          uint8_t* op = row.data();
          int this_sum = i0[0] * 3 + i1[0];
          int next_sum = i0[1] * 3 + i1[1];
          *op++ = (uint8_t)((this_sum * 4 + 8) >> 4);
          *op++ = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
          int last_sum = this_sum;
          this_sum = next_sum;
          for (int x = 2; x < dw; ++x) {
            next_sum = i0[x] * 3 + i1[x];
            *op++ = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
            *op++ = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
            last_sum = this_sum;
            this_sum = next_sum;
          }
          *op++ = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
          *op++ = (uint8_t)((this_sum * 4 + 7) >> 4);
          put(2 * y + half, row.data());
        }
      }
    } else if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < dh; ++y) {
        for (int half = 0; half < 2; ++half) {
          const uint8_t* i0 = in_row(y);
          const uint8_t* i1 = in_row(half == 0 ? y - 1 : y + 1);
          const int bias = half == 0 ? 1 : 2;
          for (int x = 0; x < dw; ++x) row[x] = (uint8_t)((i0[x] * 3 + i1[x] + bias) >> 2);
          put(2 * y + half, row.data());
        }
      }
    } else {  // h2v1_upsample, h2v2_upsample, int_upsample: replication
      for (int y = 0; y < dh; ++y) {
        const uint8_t* ip = in_row(y);
        for (int x = 0; x < dw; ++x) std::fill(row.begin() + x * hr, row.begin() + (x + 1) * hr, ip[x]);
        for (int k = 0; k < vr; ++k) put(y * vr + k, row.data());
      }
    }
  }

  // -- pixels ---------------------------------------------------------------
  void output(uint8_t* bgr) {
    std::vector<uint8_t> full[3];
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v) fail(kCorrupt);  // JERR_FRACT_SAMPLE_NOTIMPL
      // a component no scan carried keeps zero coefficients (and a zero
      // table, jddctmgr.c): it reads as 128
      const int pitch = c.bw_mcu * 8;
      std::vector<uint8_t> plane((size_t)pitch * c.bh_mcu * 8);
      for (int by = 0; by < c.bh; ++by) {
        for (int bx = 0; bx < c.bw; ++bx) idct(c.block(by, bx), c.quant, plane.data() + (size_t)by * 8 * pitch + bx * 8, pitch);
      }
      full[i].resize((size_t)width * height);
      upsample(c, plane.data(), full[i].data());
    }
    const size_t npix = (size_t)width * height;
    if (ncomp == 1) {
      for (size_t p = 0; p < npix; ++p) bgr[3 * p] = bgr[3 * p + 1] = bgr[3 * p + 2] = full[0][p];
      return;
    }
    bool rgb = false;  // jdapimin.c default_decompress_parms
    if (color >= 0) {
      rgb = color == 1;
    } else if (saw_jfif) {
      rgb = false;
    } else if (saw_adobe) {
      rgb = adobe_transform == 0;
    } else {
      rgb = comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
    }
    if (rgb) {
      for (size_t p = 0; p < npix; ++p) {
        bgr[3 * p] = full[2][p];
        bgr[3 * p + 1] = full[1][p];
        bgr[3 * p + 2] = full[0][p];
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table, ycc_rgb_convert
    const int kScale = 16;
    const int64_t half = (int64_t)1 << (kScale - 1);
    auto fix = [](double x) { return (int64_t)(x * (1 << 16) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (size_t p = 0; p < npix; ++p) {
      const int y = full[0][p], cb = full[1][p], cr = full[2][p];
      bgr[3 * p + 2] = clamp(y + cr_r[cr]);
      bgr[3 * p + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> kScale));
      bgr[3 * p] = clamp(y + cb_b[cb]);
    }
  }
};

}  // namespace jpg
}  // namespace

extern "C" {

// meta[0..3] = height, width, components, the SOF marker of a coding it does
// not decode; `color` the colour space of three components (-1: guessed from
// the JFIF and Adobe markers and the component ids, 0: YCbCr, 1: as stored,
// R, G, B). Returns 0 with the pixels in `out` (height * width * 3 BGR
// bytes); 1 when `out` is null or smaller than that (meta filled); or a
// negative status: -1 corrupt or truncated before its first scan (cv2 reads
// nothing), -2 a coding it does not decode (meta[3]), -3 two or four
// components, -4 a precision other than 8 bits, -5 block smoothing.
int jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out, int64_t cap, int32_t* meta, int color) {
  jpg::Decoder dec;
  dec.color = color;
  dec.d = data;
  dec.n = (size_t)size;
  meta[0] = meta[1] = meta[2] = meta[3] = 0;
  try {
    dec.run(out == nullptr);
    meta[0] = dec.height;
    meta[1] = dec.width;
    meta[2] = dec.ncomp;
    if (out == nullptr || cap < (int64_t)dec.width * dec.height * 3) return jpg::kNeedBuffer;
    dec.output(out);
    return jpg::kOk;
  } catch (const jpg::Fail& f) {
    meta[3] = dec.coding;
    return f.status;
  } catch (const std::bad_alloc&) {
    return jpg::kCorrupt;
  }
}

}  // extern "C"
