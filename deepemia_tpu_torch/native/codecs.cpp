// Byte-loop decoders of the TIFF compressions that zlib does not cover
// (C ABI, ctypes-loaded by deepemia_tpu_torch/native/__init__.py):
// LZW (compression 5, libtiff's MSB-first codes with the early code-width
// change, and its old-style LSB-first ones), PackBits (compression 32773)
// and CCITT fax (fax_decode); the JPEG decoder of read_image (jpeg_decode,
// below the TIFF decoders); and, at the end, the Radiance HDR scanlines,
// GIF's LZW and the float-to-8-bit step of ops/containers.py.
//
// Built on first use: g++ -O2 -shared -fPIC codecs.cpp -o
// build/torch_native/libcodecs-<hash>.so
//
// Each decoder writes at most `cap` bytes into `dst` and returns the count
// written. A stream that ends early returns the bytes it decoded, and so does
// a corrupt LZW stream (a code past the table), which also sets *corrupt:
// libtiff keeps what a failed codec wrote, and the caller checks the count
// against what the strip must hold.

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <utility>
#include <vector>

extern "C" {

int64_t lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap, int32_t* corrupt, int32_t old_style) {
  *corrupt = 0;
  // old-style LZW (LZWDecodeCompat): LSB-first codes that widen when the
  // table fills; the caller tells it as libtiff does (ops/image.py)
  const bool compat = old_style != 0;
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
  uint64_t bits = 0;  // bit buffer, MSB first (LSB first in compat)
  int nbits = 0;
  int64_t pos = 0;
  int width = 9, next = 258, old = -1;
  bool cleared = false;
  while (true) {
    while (nbits < width && pos < n) {
      bits = compat ? bits | ((uint64_t)src[pos++] << nbits) : (bits << 8) | src[pos++];
      nbits += 8;
    }
    if (nbits < width) break;  // stream ended without EOI
    int code;
    if (compat) {
      code = (int)(bits & ((1u << width) - 1));
      bits >>= width;
    } else {
      code = (int)((bits >> (nbits - width)) & ((1u << width) - 1));
    }
    nbits -= width;
    if (!compat && !cleared && code != kClear) {  // libtiff 4.7 reads no code before the first Clear
      *corrupt = 1;
      break;
    }
    if (code == kEoi) break;
    if (code == kClear) {
      cleared = true;
      width = 9; next = 258; old = -1;
      continue;
    }
    int entry;
    if (old < 0) {
      if (code > 255) {
        *corrupt = 1;
        break;
      }
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
      *corrupt = 1;
      break;
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
    // early change: the width grows one code before the table fills it (in compat, when it fills)
    if (next + (compat ? 0 : 1) >= (1 << width) && width < 12) ++width;
  }
  return out;
}

int64_t packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  int64_t pos = 0, out = 0;
  while (pos < n && out < cap) {
    int h = (int8_t)src[pos++];
    if (h >= 0) {  // a literal run that the data does not hold whole ends the strip, uncopied
      const int64_t m = std::min<int64_t>(h + 1, cap - out);
      if (pos + m > n) break;
      for (int64_t k = 0; k < m; ++k) dst[out++] = src[pos++];
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
// CCITT fax (TIFF compressions 2, 3, 4 and 32771): fax_decode follows
// libtiff's tif_fax3.c/tif_fax3.h step for step, its damaged-data paths
// included, since OpenCV reads a strip the decoder gives up on as the
// decoder left it (TIFFReadRGBAStrip does not stop on errors):
//   * the bits come LSB first through a byte map (reversed for FillOrder 1)
//     into a 32-bit accumulator; at the end of the data a code is padded
//     with zero bits while any bit is left (NeedBits8/NeedBits16);
//   * the state tables of mkg3states.c: a 7-bit 2D mode table, a 12-bit
//     white and a 13-bit black run table, whose unlisted entries consume no
//     bits; 11 zero bits are an EOL in the run tables, 7 in the mode table;
//   * rows are run lengths, white first, bounded by libtiff's run arrays,
//     repaired at the row's end (CLEANUP_RUNS) and filled by
//     _TIFFFax3fillruns, which clips them to the row in place (the clipped
//     row is the next one's reference);
//   * Fax3DecodeRLE (byte- or word-aligned rows, no EOLs), Fax3Decode1D and
//     Fax3Decode2D (an EOL before every row, found by SYNC_EOL; 2D rows
//     tagged by the bit after it; where the data ends before an EOL's
//     closing bit, libtiff 4.7 sets FAXMODE_NOEOL and decodes that row again
//     from the strip's first bit, and the rest without EOLs) and Fax4Decode
//     (an EOL ends the strip).
// Each returns 1, or -1 where libtiff's decoder returns -1; either way the
// rows it wrote stand and the rest keep what the caller put there.

namespace {
namespace fax {

enum State { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW, S_MakeUpB, S_MakeUp,
             S_EOL };

struct Ent {
  uint8_t state = S_Null, width = 0;
  uint32_t param = 0;
};

// (code, MSB first; run length or mode parameter)
struct Code {
  const char* bits;
  uint32_t param;
};

const Code kWhiteTerm[] = {
    {"00110101", 0}, {"000111", 1}, {"0111", 2}, {"1000", 3}, {"1011", 4}, {"1100", 5}, {"1110", 6},
    {"1111", 7}, {"10011", 8}, {"10100", 9}, {"00111", 10}, {"01000", 11}, {"001000", 12}, {"000011", 13},
    {"110100", 14}, {"110101", 15}, {"101010", 16}, {"101011", 17}, {"0100111", 18}, {"0001100", 19},
    {"0001000", 20}, {"0010111", 21}, {"0000011", 22}, {"0000100", 23}, {"0101000", 24}, {"0101011", 25},
    {"0010011", 26}, {"0100100", 27}, {"0011000", 28}, {"00000010", 29}, {"00000011", 30}, {"00011010", 31},
    {"00011011", 32}, {"00010010", 33}, {"00010011", 34}, {"00010100", 35}, {"00010101", 36},
    {"00010110", 37}, {"00010111", 38}, {"00101000", 39}, {"00101001", 40}, {"00101010", 41},
    {"00101011", 42}, {"00101100", 43}, {"00101101", 44}, {"00000100", 45}, {"00000101", 46},
    {"00001010", 47}, {"00001011", 48}, {"01010010", 49}, {"01010011", 50}, {"01010100", 51},
    {"01010101", 52}, {"00100100", 53}, {"00100101", 54}, {"01011000", 55}, {"01011001", 56},
    {"01011010", 57}, {"01011011", 58}, {"01001010", 59}, {"01001011", 60}, {"00110010", 61},
    {"00110011", 62}, {"00110100", 63}};
const Code kWhiteMakeUp[] = {
    {"11011", 64}, {"10010", 128}, {"010111", 192}, {"0110111", 256}, {"00110110", 320}, {"00110111", 384},
    {"01100100", 448}, {"01100101", 512}, {"01101000", 576}, {"01100111", 640}, {"011001100", 704},
    {"011001101", 768}, {"011010010", 832}, {"011010011", 896}, {"011010100", 960}, {"011010101", 1024},
    {"011010110", 1088}, {"011010111", 1152}, {"011011000", 1216}, {"011011001", 1280}, {"011011010", 1344},
    {"011011011", 1408}, {"010011000", 1472}, {"010011001", 1536}, {"010011010", 1600}, {"011000", 1664},
    {"010011011", 1728}};
const Code kBlackTerm[] = {
    {"0000110111", 0}, {"010", 1}, {"11", 2}, {"10", 3}, {"011", 4}, {"0011", 5}, {"0010", 6},
    {"00011", 7}, {"000101", 8}, {"000100", 9}, {"0000100", 10}, {"0000101", 11}, {"0000111", 12},
    {"00000100", 13}, {"00000111", 14}, {"000011000", 15}, {"0000010111", 16}, {"0000011000", 17},
    {"0000001000", 18}, {"00001100111", 19}, {"00001101000", 20}, {"00001101100", 21},
    {"00000110111", 22}, {"00000101000", 23}, {"00000010111", 24}, {"00000011000", 25},
    {"000011001010", 26}, {"000011001011", 27}, {"000011001100", 28}, {"000011001101", 29},
    {"000001101000", 30}, {"000001101001", 31}, {"000001101010", 32}, {"000001101011", 33},
    {"000011010010", 34}, {"000011010011", 35}, {"000011010100", 36}, {"000011010101", 37},
    {"000011010110", 38}, {"000011010111", 39}, {"000001101100", 40}, {"000001101101", 41},
    {"000011011010", 42}, {"000011011011", 43}, {"000001010100", 44}, {"000001010101", 45},
    {"000001010110", 46}, {"000001010111", 47}, {"000001100100", 48}, {"000001100101", 49},
    {"000001010010", 50}, {"000001010011", 51}, {"000000100100", 52}, {"000000110111", 53},
    {"000000111000", 54}, {"000000100111", 55}, {"000000101000", 56}, {"000001011000", 57},
    {"000001011001", 58}, {"000000101011", 59}, {"000000101100", 60}, {"000001011010", 61},
    {"000001100110", 62}, {"000001100111", 63}};
const Code kBlackMakeUp[] = {
    {"0000001111", 64}, {"000011001000", 128}, {"000011001001", 192}, {"000001011011", 256},
    {"000000110011", 320}, {"000000110100", 384}, {"000000110101", 448}, {"0000001101100", 512},
    {"0000001101101", 576}, {"0000001001010", 640}, {"0000001001011", 704}, {"0000001001100", 768},
    {"0000001001101", 832}, {"0000001110010", 896}, {"0000001110011", 960}, {"0000001110100", 1024},
    {"0000001110101", 1088}, {"0000001110110", 1152}, {"0000001110111", 1216}, {"0000001010010", 1280},
    {"0000001010011", 1344}, {"0000001010100", 1408}, {"0000001010101", 1472}, {"0000001011010", 1536},
    {"0000001011011", 1600}, {"0000001100100", 1664}, {"0000001100101", 1728}};
const Code kMakeUp[] = {  // both colours
    {"00000001000", 1792}, {"00000001100", 1856}, {"00000001101", 1920}, {"000000010010", 1984},
    {"000000010011", 2048}, {"000000010100", 2112}, {"000000010101", 2176}, {"000000010110", 2240},
    {"000000010111", 2304}, {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}};

struct Tables {
  Ent main[128], white[4096], black[8192];
  // mkg3states.c FillTable: every index whose low `width` bits are the code, LSB first
  static void fill(Ent* t, int size, const char* bits, uint32_t param, int state) {
    int width = 0, code = 0;
    for (; bits[width]; ++width) code |= (bits[width] - '0') << width;
    for (int i = code; i < (1 << size); i += 1 << width) t[i] = Ent{(uint8_t)state, (uint8_t)width, param};
  }
  template <int N>
  static void fill(Ent* t, int size, const Code (&codes)[N], int state) {
    for (const Code& c : codes) fill(t, size, c.bits, c.param, state);
  }
  Tables() {
    fill(main, 7, "0001", 0, S_Pass);
    fill(main, 7, "001", 0, S_Horiz);
    fill(main, 7, "1", 0, S_V0);
    fill(main, 7, "011", 1, S_VR);
    fill(main, 7, "000011", 2, S_VR);
    fill(main, 7, "0000011", 3, S_VR);
    fill(main, 7, "010", 1, S_VL);
    fill(main, 7, "000010", 2, S_VL);
    fill(main, 7, "0000010", 3, S_VL);
    fill(main, 7, "0000001", 0, S_Ext);
    fill(main, 7, "0000000", 0, S_EOL);
    fill(white, 12, kWhiteTerm, S_TermW);
    fill(white, 12, kWhiteMakeUp, S_MakeUpW);
    fill(white, 12, kMakeUp, S_MakeUp);
    fill(white, 12, "00000000000", 0, S_EOL);
    fill(black, 13, kBlackTerm, S_TermB);
    fill(black, 13, kBlackMakeUp, S_MakeUpB);
    fill(black, 13, kMakeUp, S_MakeUp);
    fill(black, 13, "00000000000", 0, S_EOL);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

enum Mode { kRle, kRlew, kG3, kG4 };

// _TIFFFax3fillruns: white runs clear bits, black runs set them, each
// clipped to the row (in place)
void fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int black = 0; black < 2; ++black) {
      uint32_t run = runs[black];
      if (x + run > lastx || run > lastx) runs[black] = run = lastx - x;
      for (uint32_t k = x; k < x + run; ++k) {
        if (black) {
          buf[k >> 3] |= (uint8_t)(0x80 >> (k & 7));
        } else {
          buf[k >> 3] &= (uint8_t)~(0x80 >> (k & 7));
        }
      }
      x += runs[black];
    }
  }
}

struct Decoder {
  const uint8_t* cp;
  const uint8_t* ep;
  const uint8_t* base;
  uint8_t bitmap[256];
  uint32_t BitAcc = 0;
  int BitsAvail = 0, EOLcnt = 0;
  bool noeol = false;  // FAXMODE_NOEOL: set where SYNC_EOL finds no EOL before the data ends
  int64_t rows;
  uint32_t lastx, nruns, rowbytes;
  std::vector<uint32_t> runs;
  uint32_t* curruns;
  uint32_t* refruns;
  const Tables& T = tables();

  int run(uint8_t* buf, Mode mode, bool is2d);
  int rle(uint8_t* buf, bool word);
  int g3_1d(uint8_t* buf);
  int g3_2d(uint8_t* buf);
  int g4(uint8_t* buf);
};

#define EndOfData() (cp >= ep)
#define NeedBits8(n, eoflab)                                 \
  do {                                                       \
    if (BitsAvail < (n)) {                                   \
      if (EndOfData()) {                                     \
        if (BitsAvail == 0) goto eoflab;                     \
        BitsAvail = (n);                                     \
      } else {                                               \
        BitAcc |= ((uint32_t)bitmap[*cp++]) << BitsAvail;    \
        BitsAvail += 8;                                      \
      }                                                      \
    }                                                        \
  } while (0)
#define NeedBits16(n, eoflab)                                 \
  do {                                                        \
    if (BitsAvail < (n)) {                                    \
      if (EndOfData()) {                                      \
        if (BitsAvail == 0) goto eoflab;                      \
        BitsAvail = (n);                                      \
      } else {                                                \
        BitAcc |= ((uint32_t)bitmap[*cp++]) << BitsAvail;     \
        if ((BitsAvail += 8) < (n)) {                         \
          if (EndOfData()) {                                  \
            BitsAvail = (n);                                  \
          } else {                                            \
            BitAcc |= ((uint32_t)bitmap[*cp++]) << BitsAvail; \
            BitsAvail += 8;                                   \
          }                                                   \
        }                                                     \
      }                                                       \
    }                                                         \
  } while (0)
#define GetBits(n) (BitAcc & ((1u << (n)) - 1))
#define ClrBits(n)     \
  do {                 \
    BitsAvail -= (n);  \
    BitAcc >>= (n);    \
  } while (0)
#define LOOKUP8(wid, tab, eoflab)        \
  do {                                   \
    NeedBits8(wid, eoflab);              \
    TabEnt = (tab) + GetBits(wid);       \
    ClrBits(TabEnt->width);              \
  } while (0)
#define LOOKUP16(wid, tab, eoflab)       \
  do {                                   \
    NeedBits16(wid, eoflab);             \
    TabEnt = (tab) + GetBits(wid);       \
    ClrBits(TabEnt->width);              \
  } while (0)
#define SETVALUE(x)                                    \
  do {                                                 \
    if (pa >= thisrun + nruns) return -1;              \
    *pa++ = RunLength + (uint32_t)(x);                 \
    a0 += (int32_t)(x);                                \
    RunLength = 0;                                     \
  } while (0)
// the end of a row: a row that came out short or long is cut or padded
#define CLEANUP_RUNS()                                           \
  do {                                                           \
    if (RunLength) SETVALUE(0);                                  \
    if (a0 != (int32_t)lastx) {                                  \
      while (a0 > (int32_t)lastx && pa > thisrun) a0 -= *--pa;   \
      if (a0 < (int32_t)lastx) {                                 \
        if (a0 < 0) a0 = 0;                                      \
        if ((pa - thisrun) & 1) SETVALUE(0);                     \
        SETVALUE(lastx - a0);                                    \
      } else if (a0 > (int32_t)lastx) {                          \
        SETVALUE(lastx);                                         \
        SETVALUE(0);                                             \
      }                                                          \
    }                                                            \
  } while (0)
// one row of white/black run codes (done1d: the row ends; eoflab: the data did)
#define EXPAND1D(eoflab)                                         \
  do {                                                           \
    for (;;) {                                                   \
      for (;;) {                                                 \
        LOOKUP16(12, T.white, eof1d);                            \
        switch (TabEnt->state) {                                 \
          case S_EOL: EOLcnt = 1; goto done1d;                   \
          case S_TermW: SETVALUE(TabEnt->param); goto doneWhite1d; \
          case S_MakeUpW: case S_MakeUp:                         \
            a0 += TabEnt->param; RunLength += TabEnt->param; break; \
          default: goto done1d;                                  \
        }                                                        \
      }                                                          \
    doneWhite1d:                                                 \
      if (a0 >= (int32_t)lastx) goto done1d;                     \
      for (;;) {                                                 \
        LOOKUP16(13, T.black, eof1d);                            \
        switch (TabEnt->state) {                                 \
          case S_EOL: EOLcnt = 1; goto done1d;                   \
          case S_TermB: SETVALUE(TabEnt->param); goto doneBlack1d; \
          case S_MakeUpB: case S_MakeUp:                         \
            a0 += TabEnt->param; RunLength += TabEnt->param; break; \
          default: goto done1d;                                  \
        }                                                        \
      }                                                          \
    doneBlack1d:                                                 \
      if (a0 >= (int32_t)lastx) goto done1d;                     \
      if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;             \
    }                                                            \
  eof1d:                                                         \
    CLEANUP_RUNS();                                              \
    goto eoflab;                                                 \
  done1d:                                                        \
    CLEANUP_RUNS();                                              \
  } while (0)
// b1: the first change on the reference row right of a0 of the other colour
#define CHECK_b1                                                 \
  do {                                                           \
    if (pa != thisrun) {                                         \
      while (b1 <= a0 && b1 < (int32_t)lastx) {                  \
        if (pb + 1 >= refruns + nruns) return -1;                \
        b1 += pb[0] + pb[1];                                     \
        pb += 2;                                                 \
      }                                                          \
    }                                                            \
  } while (0)
#define EXPAND2D(eoflab)                                                     \
  do {                                                                       \
    while (a0 < (int32_t)lastx) {                                            \
      if (pa >= thisrun + nruns) return -1;                                  \
      LOOKUP8(7, T.main, eof2d);                                             \
      switch (TabEnt->state) {                                               \
        case S_Pass:                                                         \
          CHECK_b1;                                                          \
          if (pb + 1 >= refruns + nruns) return -1;                          \
          b1 += *pb++;                                                       \
          RunLength += b1 - a0;                                              \
          a0 = b1;                                                           \
          b1 += *pb++;                                                       \
          break;                                                             \
        case S_Horiz:                                                        \
          if ((pa - thisrun) & 1) {                                          \
            for (;;) {                                                       \
              LOOKUP16(13, T.black, eof2d);                                  \
              switch (TabEnt->state) {                                       \
                case S_TermB: SETVALUE(TabEnt->param); goto doneWhite2da;    \
                case S_MakeUpB: case S_MakeUp:                               \
                  a0 += TabEnt->param; RunLength += TabEnt->param; break;    \
                default: goto eol2d;                                         \
              }                                                              \
            }                                                                \
          doneWhite2da:;                                                     \
            for (;;) {                                                       \
              LOOKUP16(12, T.white, eof2d);                                  \
              switch (TabEnt->state) {                                       \
                case S_TermW: SETVALUE(TabEnt->param); goto doneBlack2da;    \
                case S_MakeUpW: case S_MakeUp:                               \
                  a0 += TabEnt->param; RunLength += TabEnt->param; break;    \
                default: goto eol2d;                                         \
              }                                                              \
            }                                                                \
          doneBlack2da:;                                                     \
          } else {                                                           \
            for (;;) {                                                       \
              LOOKUP16(12, T.white, eof2d);                                  \
              switch (TabEnt->state) {                                       \
                case S_TermW: SETVALUE(TabEnt->param); goto doneWhite2db;    \
                case S_MakeUpW: case S_MakeUp:                               \
                  a0 += TabEnt->param; RunLength += TabEnt->param; break;    \
                default: goto eol2d;                                         \
              }                                                              \
            }                                                                \
          doneWhite2db:;                                                     \
            for (;;) {                                                       \
              LOOKUP16(13, T.black, eof2d);                                  \
              switch (TabEnt->state) {                                       \
                case S_TermB: SETVALUE(TabEnt->param); goto doneBlack2db;    \
                case S_MakeUpB: case S_MakeUp:                               \
                  a0 += TabEnt->param; RunLength += TabEnt->param; break;    \
                default: goto eol2d;                                         \
              }                                                              \
            }                                                                \
          doneBlack2db:;                                                     \
          }                                                                  \
          CHECK_b1;                                                          \
          break;                                                             \
        case S_V0:                                                           \
          CHECK_b1;                                                          \
          SETVALUE(b1 - a0);                                                 \
          if (pb >= refruns + nruns) return -1;                              \
          b1 += *pb++;                                                       \
          break;                                                             \
        case S_VR:                                                           \
          CHECK_b1;                                                          \
          SETVALUE(b1 - a0 + TabEnt->param);                                 \
          if (pb >= refruns + nruns) return -1;                              \
          b1 += *pb++;                                                       \
          break;                                                             \
        case S_VL:                                                           \
          CHECK_b1;                                                          \
          if (b1 < (int32_t)(a0 + TabEnt->param)) goto eol2d;                \
          SETVALUE(b1 - a0 - TabEnt->param);                                 \
          b1 -= *--pb;                                                       \
          break;                                                             \
        case S_Ext:                                                          \
          *pa++ = lastx - a0;                                                \
          goto eol2d;                                                        \
        case S_EOL:                                                          \
          *pa++ = lastx - a0;                                                \
          NeedBits8(4, eof2d);                                               \
          ClrBits(4);                                                        \
          EOLcnt = 1;                                                        \
          goto eol2d;                                                        \
        default:                                                             \
          goto eol2d;                                                        \
      }                                                                      \
    }                                                                        \
    if (RunLength) {                                                         \
      if (RunLength + a0 < lastx) {                                          \
        NeedBits8(1, eof2d);                                                 \
        if (!GetBits(1)) goto eol2d;                                         \
        ClrBits(1);                                                          \
      }                                                                      \
      SETVALUE(0);                                                           \
    }                                                                        \
    goto eol2d;                                                              \
  eof2d:                                                                     \
    CLEANUP_RUNS();                                                          \
    goto eoflab;                                                             \
  eol2d:                                                                     \
    CLEANUP_RUNS();                                                          \
  } while (0)
// skip to the bit after the next EOL (11 or more zeros, then a one); with
// no EOL before the data ends, go on without EOLs from the strip's start
#define SYNC_EOL(eoflab)                     \
  do {                                       \
    if (!noeol) {                            \
      if (EOLcnt == 0) {                     \
        for (;;) {                           \
          NeedBits16(11, eoflab);            \
          if (GetBits(11) == 0) break;       \
          ClrBits(1);                        \
        }                                    \
      }                                      \
      for (;;) {                             \
        NeedBits8(8, noEOLFound);            \
        if (GetBits(8)) break;               \
        ClrBits(8);                          \
      }                                      \
      while (GetBits(1) == 0) ClrBits(1);    \
      ClrBits(1);                            \
      EOLcnt = 0;                            \
      break;                                 \
    noEOLFound:                              \
      noeol = true;                          \
      cp = base;                             \
      BitAcc = 0;                            \
      BitsAvail = 0;                         \
      EOLcnt = 0;                            \
    }                                        \
  } while (0)

int Decoder::rle(uint8_t* buf, bool word) {  // Fax3DecodeRLE
  const Ent* TabEnt;
  uint32_t* thisrun = curruns;
  for (int64_t line = 0; line < rows; ++line, buf += rowbytes) {
    int32_t a0 = 0;
    uint32_t RunLength = 0;
    uint32_t* pa = thisrun;
    EXPAND1D(EOFRLE);
    fill_runs(buf, thisrun, pa, lastx);
    {
      const int pad = BitsAvail & (word ? 15 : 7);  // to the next byte (word) of the data
      ClrBits(pad);
      if (word && BitsAvail == 0 && ((cp - base) & 1)) ++cp;
    }
    continue;
  EOFRLE:
    fill_runs(buf, thisrun, pa, lastx);
    return -1;
  }
  return 1;
}

int Decoder::g3_1d(uint8_t* buf) {  // Fax3Decode1D
  const Ent* TabEnt;
  uint32_t* thisrun = curruns;
  for (int64_t line = 0; line < rows; ++line, buf += rowbytes) {
    int32_t a0 = 0;
    uint32_t RunLength = 0;
    uint32_t* pa = thisrun;
    SYNC_EOL(EOF1D);
    EXPAND1D(EOF1Da);
    fill_runs(buf, thisrun, pa, lastx);
    continue;
  EOF1D:
    CLEANUP_RUNS();
  EOF1Da:
    fill_runs(buf, thisrun, pa, lastx);
    return -1;
  }
  return 1;
}

int Decoder::g3_2d(uint8_t* buf) {  // Fax3Decode2D
  const Ent* TabEnt;
  for (int64_t line = 0; line < rows; ++line, buf += rowbytes) {
    int32_t a0 = 0, b1;
    uint32_t RunLength = 0;
    uint32_t* thisrun = curruns;
    uint32_t* pa = thisrun;
    uint32_t* pb;
    int is1d;
    SYNC_EOL(EOF2D);
    NeedBits8(1, EOF2D);
    is1d = GetBits(1);
    ClrBits(1);
    pb = refruns;
    b1 = *pb++;
    if (is1d) {
      EXPAND1D(EOF2Da);
    } else {
      EXPAND2D(EOF2Da);
    }
    fill_runs(buf, thisrun, pa, lastx);
    if (pa < thisrun + nruns) SETVALUE(0);  // the imaginary change of the reference row
    std::swap(curruns, refruns);
    continue;
  EOF2D:
    CLEANUP_RUNS();
  EOF2Da:
    fill_runs(buf, thisrun, pa, lastx);
    return -1;
  }
  return 1;
}

int Decoder::g4(uint8_t* buf) {  // Fax4Decode
  const Ent* TabEnt;
  for (int64_t line = 0; line < rows; ++line, buf += rowbytes) {
    int32_t a0 = 0, b1;
    uint32_t RunLength = 0;
    uint32_t* thisrun = curruns;
    uint32_t* pa = thisrun;
    uint32_t* pb = refruns;
    b1 = *pb++;
    EXPAND2D(EOFG4);
    if (EOLcnt) goto EOFG4;
    fill_runs(buf, thisrun, pa, lastx);
    SETVALUE(0);  // the imaginary change of the reference row
    std::swap(curruns, refruns);
    continue;
  EOFG4:
    NeedBits16(13, BADG4);
  BADG4:
    ClrBits(13);
    fill_runs(buf, thisrun, pa, lastx);
    return line ? 1 : -1;  // a strip that ends in EOFB (or early) keeps its rows
  }
  return 1;
}

#undef EndOfData
#undef NeedBits8
#undef NeedBits16
#undef GetBits
#undef ClrBits
#undef LOOKUP8
#undef LOOKUP16
#undef SETVALUE
#undef CLEANUP_RUNS
#undef EXPAND1D
#undef CHECK_b1
#undef EXPAND2D
#undef SYNC_EOL

}  // namespace fax
}  // namespace

extern "C" {

// One strip or tile of `rows` rows of `width` pixels in TIFF compression
// `compression` (2 CCITT RLE, 3 Group 3, 4 Group 4, 32771 CCITT RLEW) ->
// `dst`, packed rows of (width + 7) / 8 bytes, MSB first, a black run's
// bits set. `options` is T4Options (bit 0: 2D rows); `lsb_first` is
// FillOrder 2. Returns 1, or -1 where libtiff's decoder gives up (the rows
// written stand), or -2 for arguments it cannot take.
int fax_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t rows, int64_t width, int compression,
               int options, int lsb_first) {
  if (width <= 0 || width > (1 << 24) || rows < 0) return -2;
  fax::Decoder d;
  d.cp = d.base = src;
  d.ep = src + n;
  for (int i = 0; i < 256; ++i) {  // TIFFGetBitRevTable: the reader takes bits LSB first
    int r = 0;
    for (int b = 0; b < 8; ++b) r |= ((i >> b) & 1) << (7 - b);
    d.bitmap[i] = (uint8_t)(lsb_first ? i : r);
  }
  d.rows = rows;
  d.lastx = (uint32_t)width;
  d.rowbytes = (uint32_t)((width + 7) / 8);
  const bool two_d = compression == 4 || (compression == 3 && (options & 1));
  d.nruns = (uint32_t)((width + 1 + 31) / 32 * 32) * (two_d ? 2 : 1);  // Fax3SetupState
  d.runs.assign((size_t)d.nruns * 2, 0);
  d.curruns = d.runs.data();
  d.refruns = d.runs.data() + d.nruns;
  d.refruns[0] = (uint32_t)width;  // Fax3PreDecode: an all-white reference row
  d.refruns[1] = 0;
  switch (compression) {
    case 2: return d.rle(dst, false);
    case 32771: return d.rle(dst, true);
    case 3: return two_d ? d.g3_2d(dst) : d.g3_1d(dst);
    case 4: return d.g4(dst);
    default: return -2;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JPEG: jpeg_decode returns the pixels cv2.imread(path, cv2.IMREAD_COLOR)
// returns with OpenCV 5.0's libjpeg-turbo 3.1 (before the EXIF orientation,
// which read_image applies), as [H, W, 3] BGR bytes. It follows libjpeg's
// own decoder step for step:
//   * markers (jdmarker.c): SOF0/SOF1 (sequential Huffman), SOF2
//     (progressive Huffman), SOF3 (lossless), SOF9 and SOF10 (sequential
//     and progressive arithmetic) at 8-bit precision, DQT with 8- or 16-bit
//     entries (held as the 16-bit ISLOW_MULT_TYPE of a SIMD build), DHT
//     (jpeg_make_d_derived_tbl's checks), DAC, DRI, APP0 JFIF and APP14
//     Adobe (the colour-space guess of jdapimin.c), quantization tables
//     latched at a component's first scan (jdinput.c); past the end of the
//     data the source's EOI, again and again (a header cut short reads
//     it); a sequential scan of every component ends the reading, as
//     OpenCV has the image before libjpeg reads on;
//   * entropy decoding (jdhuff.c, jdphuff.c): a bit reader that stops at a
//     marker and then supplies zero bits, an MCU left all zero once the data
//     has run out (the gray of a truncated file), restart markers with
//     jpeg_resync_to_restart, the four progressive passes with EOBRUN;
//     arithmetic decoding (jdarith.c): the QM decoder, DC and AC
//     statistics with DAC's conditioning, zeros after a marker, a bad code
//     ending the work until the next restart; lossless (jdlhuff.c,
//     jdlossls.c): the seven predictors, the point transform, restarts;
//   * block smoothing (jdcoefct.c decompress_smooth_data, libjpeg-turbo
//     3.1's 5x5 window) of a progressive image whose first ten
//     coefficients are not all refined;
//   * the integer IDCT (jidctint.c jpeg_idct_islow) as OpenCV's SIMD build
//     runs it (jidctint-avx2.asm): 16-bit dequantized coefficients (vpmullw
//     keeps the low half of each product), 16-bit sums where it adds words,
//     a block whose coefficient rows 1-7 are zero taken from its DC row
//     alone, the column pass's outputs saturated to 16 bits, the row
//     pass's to a byte (vpackssdw, vpacksswb); it differs from the C
//     version only where corrupt data overflows these;
//   * upsampling (jdsample.c): the fancy (triangle) filters h2v1, h2v2 and
//     h1v2 (plain replication when a row holds two samples or fewer),
//     replication for other integral ratios; edge rows repeat (jdmainct.c's
//     context rows);
//   * colour (jdcolor.c): the fixed-point YCbCr -> RGB tables, RGB as is,
//     gray replicated; the caller may set the colour space, as libtiff sets
//     jpeg_color_space for the JPEG strips and tiles of a TIFF (tif_jpeg.c
//     JPEGPreDecode: YCbCr converted to RGB, any other photometric as
//     stored).
//   * four components: libjpeg's CMYK (YCCK converted by its tables),
//     then OpenCV's CMYK to BGR for Adobe's inverted CMYK.
// Not decoded, each with its own status, as OpenCV does not read them
// either: hierarchical processes and arithmetic-coded lossless (SOF5-7,
// SOF11, SOF13-15), 12-bit precision, two components, and a lossless
// frame whose colour libjpeg-turbo would have to convert (gray, YCbCr or
// YCCK).

#include <algorithm>
#include <vector>

namespace {
namespace jpg {

enum Status {
  kOk = 0, kNeedBuffer = 1, kCorrupt = -1, kBadCoding = -2, kBadColor = -3, kBadPrecision = -4,
  kLosslessColor = -5,
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
      if (h.vals[i] > 16) fail(kCorrupt);  // 16: the lossless category of 32768
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
  int prev_bits[10] = {};      // coef_bits[1..9] before the component's last scan
  int cur_latch[10], prev_latch[10];  // smoothing_ok's latches of the two
  std::vector<int16_t> coef;   // [bh_mcu][bw_mcu][64], natural order
  std::vector<int32_t> diff;   // lossless: [bh_mcu][bw_mcu] sample differences
  int predictor = 1, pt = 0, rows_per_mcu = 1;  // lossless: its scan's Ss, Al and sample rows per MCU row
  std::vector<uint8_t> first_rows;  // lossless: MCU rows undifferenced as the first of a scan
  int last_dc = 0, dc_context = 0;
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
  // block smoothing (jdcoefct.c): scans read, the last iMCU row a scan
  // completed with data left (last_good_iMCU_row), whether to smooth
  int scan_number = 0, last_good_row = 0;
  bool smooth = false;
  // arithmetic coding (jdarith.c): conditioning from DAC (defaults L 0, U 1,
  // Kx 5), statistics bins per table, the C and A registers and the bit
  // counter ct (-16 before the first two bytes, -1 after a bad code)
  bool arith = false, lossless = false;
  std::vector<uint8_t> restart_row;  // lossless: MCU rows that start the scan or a restart interval
  int dc_L[16] = {}, dc_U[16] = {1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
  int ac_K[16] = {5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5};
  uint8_t dc_stats[16][64], ac_stats[16][256], fixed_bin = 113;
  int64_t ac_c = 0, ac_a = 0;
  int ac_ct = -16, eoi_phase = 0;

  // -- bytes and markers --------------------------------------------------
  bool at_end() const { return pos >= n; }
  int byte() {  // past the end, libjpeg's stdio source inserts EOI after EOI (JWRN_JPEG_EOF)
    if (pos < n) return d[pos++];
    return eoi_phase++ & 1 ? 0xD9 : 0xFF;
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
  void read_dac() {  // jdmarker.c get_dac
    int len = u16() - 2;
    while (len > 0) {
      const int index = byte(), val = byte();
      len -= 2;
      if (index >= 32) fail(kCorrupt);  // JERR_DAC_INDEX: 16 DC tables, then 16 AC tables
      if (index >= 16) {
        ac_K[index - 16] = val;
      } else {
        dc_L[index] = val & 15;
        dc_U[index] = val >> 4;
        if (dc_L[index] > dc_U[index]) fail(kCorrupt);  // JERR_DAC_VALUE
      }
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
    progressive = marker == 0xC2 || marker == 0xCA;
    lossless = marker == 0xC3;
    arith = marker == 0xC9 || marker == 0xCA;
    if (height <= 0 || width <= 0 || ncomp <= 0) fail(kCorrupt);  // a DNL height is refused too
    if (ncomp == 2 || ncomp > 4) fail(kBadColor);  // libjpeg has no colour space for two
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
    const int unit = lossless ? 1 : 8;  // a lossless "block" is one sample
    mcux = (width + unit * hmax - 1) / (unit * hmax);
    mcuy = (height + unit * vmax - 1) / (unit * vmax);
    for (int i = 0; alloc && i < ncomp; ++i) {
      Component& c = comp[i];
      c.width = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.height = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.bw = (c.width + unit - 1) / unit;
      c.bh = (c.height + unit - 1) / unit;
      c.bw_mcu = mcux * c.h;
      c.bh_mcu = mcuy * c.v;
      if (lossless) {
        c.diff.assign((size_t)c.bw_mcu * c.bh_mcu, 0);
      } else {
        c.coef.assign((size_t)c.bw_mcu * c.bh_mcu * 64, 0);
      }
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
  }
  // a segment that runs past the end is skipped to it (skip_input_data),
  // where the source's EOI follows
  void skip_segment() {
    const int len = u16();
    if (len < 2) fail(kCorrupt);
    pos = std::min(pos + (len - 2), n);
  }
  void read_app(int marker) {
    const int len = u16();
    if (len < 2) fail(kCorrupt);
    const uint8_t* p = d + pos;
    const int m = (int)std::min((size_t)(len - 2), n - std::min(pos, n));
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
    }
    ss = byte();
    se = byte();
    const int a = byte();
    ah = a >> 4;
    al = a & 15;
    if (lossless) {  // jdlossls.c: Ss the predictor, Al the point transform
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8) fail(kCorrupt);
    } else if (progressive) {
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
    for (int i = 0; i < ns && !lossless; ++i) {  // latch_quant_tables
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
  // -- arithmetic decoding (jdarith.c, jaricom.c) ---------------------------
  // Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS, ITU
  // T.81 Table D.2; entry 113 is the fixed probability 0.5
  static int64_t aritab(int i) {
    static const uint16_t kQe[114] = {
        0x5a1d, 0x2586, 0x1114, 0x080b, 0x03d8, 0x01da, 0x00e5, 0x006f, 0x0036, 0x001a, 0x000d, 0x0006, 0x0003,
        0x0001, 0x5a7f, 0x3f25, 0x2cf2, 0x207c, 0x17b9, 0x1182, 0x0cef, 0x09a1, 0x072f, 0x055c, 0x0406, 0x0303,
        0x0240, 0x01b1, 0x0144, 0x00f5, 0x00b7, 0x008a, 0x0068, 0x004e, 0x003b, 0x002c, 0x5ae1, 0x484c, 0x3a0d,
        0x2ef1, 0x261f, 0x1f33, 0x19a8, 0x1518, 0x1177, 0x0e74, 0x0bfb, 0x09f8, 0x0861, 0x0706, 0x05cd, 0x04de,
        0x040f, 0x0363, 0x02d4, 0x025c, 0x01f8, 0x01a4, 0x0160, 0x0125, 0x00f6, 0x00cb, 0x00ab, 0x008f, 0x5b12,
        0x4d04, 0x412c, 0x37d8, 0x2fe8, 0x293c, 0x2379, 0x1edf, 0x1aa9, 0x174e, 0x1424, 0x119c, 0x0f6b, 0x0d51,
        0x0bb6, 0x0a40, 0x5832, 0x4d1c, 0x438e, 0x3bdd, 0x34ee, 0x2eae, 0x299a, 0x2516, 0x5570, 0x4ca9, 0x44d9,
        0x3e22, 0x3824, 0x32b4, 0x2e17, 0x56a8, 0x4f46, 0x47e5, 0x41cf, 0x3c3d, 0x375e, 0x5231, 0x4c0f, 0x4639,
        0x415e, 0x5627, 0x50e7, 0x4b85, 0x5597, 0x504f, 0x5a10, 0x5522, 0x59eb, 0x5a1d};
    static const uint8_t kLps[114] = {
        1,  14, 16, 18, 20, 23, 25, 28, 30, 33, 35, 9,  10, 12, 15, 36, 38, 39, 40, 42, 43, 45, 46, 48,
        49, 51, 52, 54, 56, 57, 59, 60, 62, 63, 32, 33, 37, 64, 65, 67, 68, 69, 70, 72, 73, 74, 75, 77,
        78, 79, 48, 50, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 61, 61, 65, 80, 81, 82, 83, 84, 86, 87,
        87, 72, 72, 74, 74, 75, 77, 77, 80, 88, 89, 90, 91, 92, 93, 86, 88, 95, 96, 97, 99, 99, 93, 95,
        101, 102, 103, 104, 99, 105, 106, 107, 103, 105, 108, 109, 110, 111, 110, 112, 112, 113};
    static const uint8_t kMps[114] = {
        1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 13, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
        25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 9,  37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48,
        49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 32, 65, 66, 67, 68, 69, 70, 71, 72,
        73, 74, 75, 76, 77, 78, 79, 48, 81, 82, 83, 84, 85, 86, 87, 71, 89, 90, 91, 92, 93, 94, 86, 96,
        97, 98, 99, 100, 93, 102, 103, 104, 99, 106, 107, 103, 109, 107, 111, 109, 111, 113};
    struct Table {
      int64_t v[114];
      Table() {
        for (int k = 0; k < 114; ++k) {
          const bool sw = k == 0 || k == 14 || k == 36 || k == 64 || k == 80 || k == 88 || k == 95 || k == 105 ||
                          k == 110 || k == 112;
          v[k] = ((int64_t)kQe[k] << 16) | ((int64_t)kMps[k] << 8) | ((int64_t)sw << 7) | kLps[k];
        }
      }
    };
    static const Table table;
    return table.v[i];
  }
  int arith_decode(uint8_t* st) {
    while (ac_a < 0x8000) {  // renormalization and data input, D.2.6
      if (--ac_ct < 0) {
        int data;
        if (unread_marker) {
          data = 0;
        } else {
          data = byte();
          if (data == 0xFF) {
            do data = byte(); while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              unread_marker = data;  // a marker in the data: zeros from here on
              data = 0;
            }
          }
        }
        ac_c = (ac_c << 8) | data;
        if ((ac_ct += 8) < 0) {
          if (++ac_ct == 0) ac_a = 0x8000;  // two initial bytes read
        }
      }
      ac_a <<= 1;
    }
    int sv = *st;
    int64_t qe = aritab(sv & 0x7F);
    const int nl = (int)(qe & 0xFF);
    qe >>= 8;
    const int nm = (int)(qe & 0xFF);
    qe >>= 8;
    int64_t temp = ac_a - qe;
    ac_a = temp;
    temp <<= ac_ct;
    if (ac_c >= temp) {
      ac_c -= temp;
      if (ac_a < qe) {
        ac_a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        ac_a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (ac_a < 0x8000) {
      if (ac_a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  // the DC difference (F.1.4.4.1, Figures F.19-F.24) added to the predictor
  bool arith_dc(Component& c) {
    const int tbl = c.td;
    uint8_t* st = dc_stats[tbl] + c.dc_context;
    if (arith_decode(st) == 0) {
      c.dc_context = 0;
      return true;
    }
    const int sign = arith_decode(st + 1);
    st += 2 + sign;
    int m = arith_decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ac_ct = -1;  // JWRN_ARITH_BAD_CODE: magnitude overflow
          return false;
        }
        st += 1;
      }
    }
    if (m < (int)((1L << dc_L[tbl]) >> 1)) {
      c.dc_context = 0;
    } else if (m > (int)((1L << dc_U[tbl]) >> 1)) {
      c.dc_context = 12 + sign * 4;
    } else {
      c.dc_context = 4 + sign * 4;
    }
    int v = m;
    st += 14;
    while (m >>= 1) {
      if (arith_decode(st)) v |= m;
    }
    v += 1;
    if (sign) v = -v;
    c.last_dc = (c.last_dc + v) & 0xffff;
    return true;
  }
  // one nonzero AC value's sign, magnitude category and bits (F.21-F.24)
  bool arith_ac_value(int tbl, int k, uint8_t* st, int* out) {
    const int sign = arith_decode(&fixed_bin);
    st += 2;
    int m = arith_decode(st);
    if (m != 0 && arith_decode(st)) {
      m <<= 1;
      st = ac_stats[tbl] + (k <= ac_K[tbl] ? 189 : 217);
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ac_ct = -1;
          return false;
        }
        st += 1;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1) {
      if (arith_decode(st)) v |= m;
    }
    v += 1;
    *out = sign ? -v : v;
    return true;
  }
  // coefficients k0..k1 (F.20): -> false after a bad code
  bool arith_ac(Component& c, int16_t* blk, int k0, int k1, int shift) {
    const int tbl = c.ta;
    for (int k = k0; k <= k1; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (arith_decode(st)) break;  // EOB
      while (arith_decode(st + 1) == 0) {
        st += 3;
        if (++k > k1) {
          ac_ct = -1;  // spectral overflow
          return false;
        }
      }
      int v;
      if (!arith_ac_value(tbl, k, st, &v)) return false;
      blk[kNatural[k]] = (int16_t)((unsigned)v << shift);
    }
    return true;
  }
  void arith_ac_refine(Component& c, int16_t* blk) {
    const int tbl = c.ta;
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;
    for (; kex > 0; --kex) {
      if (blk[kNatural[kex]]) break;
    }
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && arith_decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {  // previously nonzero: a correction bit
          if (arith_decode(st + 2)) *coef = (int16_t)(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (arith_decode(st + 1)) {  // newly nonzero
          *coef = (int16_t)(arith_decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) {
          ac_ct = -1;
          return;
        }
      }
    }
  }
  // jdarith.c start_pass / process_restart: the scan's statistics cleared
  void arith_reset() {
    for (int i = 0; i < ns; ++i) {
      Component& c = comp[scomp[i]];
      if (!progressive || (ss == 0 && ah == 0)) {
        std::fill(dc_stats[c.td], dc_stats[c.td] + 64, 0);
        c.last_dc = 0;
        c.dc_context = 0;
      }
      if (!progressive || ss) std::fill(ac_stats[c.ta], ac_stats[c.ta] + 256, 0);
    }
    ac_c = 0;
    ac_a = 0;
    ac_ct = -16;
  }
  void arith_restart() {
    if (unread_marker == 0) unread_marker = next_marker();
    const int desired = 0xD0 + next_restart;
    if (unread_marker == desired) {
      unread_marker = 0;
    } else {
      resync(desired);
    }
    next_restart = (next_restart + 1) & 7;
    arith_reset();
  }
  void arith_unit(Component& c, int16_t* blk) {
    if (!progressive) {
      if (!arith_dc(c)) return;
      blk[0] = (int16_t)c.last_dc;
      arith_ac(c, blk, 1, 63, 0);
    } else if (ss == 0) {
      if (ah == 0) {
        if (arith_dc(c)) blk[0] = (int16_t)((unsigned)c.last_dc << al);
      } else if (arith_decode(&fixed_bin)) {
        blk[0] = (int16_t)(blk[0] | (1 << al));
      }
    } else if (ah == 0) {
      arith_ac(c, blk, ss, se, al);
    } else {
      arith_ac_refine(c, blk);
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
  // jdlhuff.c / jddiffct.c: each sample's difference, Huffman-coded as a
  // DC difference (category 16: 32768, no bits); restarts only at MCU row
  // starts; an MCU row that starts after the data ran out stays zero and
  // restarts the prediction, so the rest of the scan reads as the initial
  // predictor
  void lossless_scan() {
    Component& c0 = comp[scomp[0]];
    const int per_row = ns == 1 ? c0.bw : mcux, rows = ns == 1 ? c0.bh : mcuy;
    if (restart_interval % per_row) fail(kCorrupt);  // JERR_BAD_RESTART
    for (int i = 0; i < ns; ++i) {
      Component& c = comp[scomp[i]];
      if (c.td > 3) fail(kCorrupt);
      derive(dc_tab[c.td], true);
      c.predictor = ss;
      c.pt = al;
      c.rows_per_mcu = ns == 1 ? 1 : c.v;
      c.first_rows.assign(rows, 0);
      std::fill(c.diff.begin(), c.diff.end(), 0);
    }
    acc = 0;
    nbits = 0;
    unread_marker = 0;
    insufficient = false;
    next_restart = 0;
    int restarts_to_go = restart_interval;
    for (int my = 0; my < rows; ++my) {
      bool first = my == 0;
      if (restart_interval && restarts_to_go == 0) {
        process_restart();
        restarts_to_go = restart_interval;
        first = true;
      }
      if (restart_interval) restarts_to_go -= per_row;
      if (insufficient) first = true;  // the row is left zero and the undifferencer restarted
      for (int i = 0; i < ns; ++i) comp[scomp[i]].first_rows[my] = first;
      if (insufficient) continue;
      for (int mx = 0; mx < per_row; ++mx) {
        for (int i = 0; i < ns; ++i) {
          Component& c = comp[scomp[i]];
          const int h = ns == 1 ? 1 : c.h, v = ns == 1 ? 1 : c.v;
          for (int y = 0; y < v; ++y) {
            for (int x = 0; x < h; ++x) {
              int s = decode(dc_tab[c.td]);
              if (s == 16) {
                s = 32768;
              } else if (s) {
                s = extend(bits(s), s);
              }
              c.diff[(size_t)(my * v + y) * c.bw_mcu + mx * h + x] = s;
            }
          }
        }
      }
    }
  }
  // jdlossls.c: undifference the component's rows (the first of a scan or
  // restart interval from the initial predictor 2^(7 - Pt) and its left
  // neighbours, its first sample from the one above, the rest by the
  // scan's predictor, all modulo 2^16), then scale by the point transform
  void undifference(const Component& c, uint8_t* plane, int pitch) const {
    std::vector<int> prev(c.width), cur(c.width);
    for (int r = 0; r < c.height; ++r) {
      const int32_t* dr = c.diff.data() + (size_t)r * c.bw_mcu;
      const bool first = r % c.rows_per_mcu == 0 && c.first_rows[r / c.rows_per_mcu];
      if (first) {
        int ra = (dr[0] + (1 << (7 - c.pt))) & 0xFFFF;
        cur[0] = ra;
        for (int x = 1; x < c.width; ++x) cur[x] = ra = (dr[x] + ra) & 0xFFFF;
      } else {
        int rb = prev[0], ra = (dr[0] + rb) & 0xFFFF;
        cur[0] = ra;
        for (int x = 1; x < c.width; ++x) {
          const int rc = rb;
          rb = prev[x];
          int p;
          switch (c.predictor) {
            case 1: p = ra; break;
            case 2: p = rb; break;
            case 3: p = rc; break;
            case 4: p = ra + rb - rc; break;
            case 5: p = ra + ((rb - rc) >> 1); break;
            case 6: p = rb + ((ra - rc) >> 1); break;
            default: p = (ra + rb) >> 1; break;
          }
          cur[x] = ra = (dr[x] + p) & 0xFFFF;
        }
      }
      for (int x = 0; x < c.width; ++x) plane[(size_t)r * pitch + x] = (uint8_t)(cur[x] << c.pt);
      std::swap(prev, cur);
    }
  }

  void decode_scan() {
    if (lossless) {
      lossless_scan();
      return;
    }
    for (int i = 0; i < ns; ++i) {
      Component& c = comp[scomp[i]];
      c.last_dc = 0;
      // the tables the scan uses (jdhuff.c, jdphuff.c start_pass: 4 Huffman tables; 16 arithmetic ones)
      const bool dc = !progressive || (ss == 0 && ah == 0), ac = !progressive || ss > 0;
      if (!arith && ((dc && c.td > 3) || (ac && c.ta > 3))) fail(kCorrupt);
      if (!arith && dc) derive(dc_tab[c.td], true);
      if (!arith && ac) derive(ac_tab[c.ta], false);
      if (progressive) {  // jdphuff.c / jdarith.c start_pass: the previous bits, then this scan's
        for (int k = 1; k < 10; ++k) c.prev_bits[k] = scan_number > 1 ? c.coef_bits[k] : 0;
      }
      for (int k = ss; k <= se; ++k) c.coef_bits[k] = al;
    }
    acc = 0;
    nbits = 0;
    unread_marker = 0;
    insufficient = false;
    eobrun = 0;
    next_restart = 0;
    if (arith) arith_reset();
    int restarts_to_go = restart_interval;
    // one MCU: its blocks in order; an arithmetic scan after a bad code
    // (ct -1) skips them until the next restart
    auto unit = [&](Component& c, int16_t* blk) {
      if (!arith) {
        decode_unit(c, blk);
      } else if (ac_ct != -1) {
        arith_unit(c, blk);
      }
    };
    auto restart = [&]() {
      if (restart_interval) {
        if (restarts_to_go == 0) {
          if (arith) {
            arith_restart();
          } else {
            process_restart();
          }
          restarts_to_go = restart_interval;
        }
        --restarts_to_go;
      }
    };
    if (ns == 1) {  // an iMCU row is v block rows of the component
      Component& c = comp[scomp[0]];
      for (int by = 0; by < c.bh; ++by) {
        for (int bx = 0; bx < c.bw; ++bx) {
          restart();
          if (insufficient) continue;
          last_good_row = by / c.v;
          unit(c, c.block(by, bx));
        }
      }
    } else {
      for (int my = 0; my < mcuy; ++my) {
        for (int mx = 0; mx < mcux; ++mx) {
          restart();
          if (insufficient) continue;
          last_good_row = my;
          for (int i = 0; i < ns; ++i) {
            Component& c = comp[scomp[i]];
            for (int y = 0; y < c.v; ++y) {
              for (int x = 0; x < c.h; ++x) unit(c, c.block(my * c.v + y, mx * c.h + x));
            }
          }
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
        if (marker != 0xC0 && marker != 0xC1 && marker != 0xC2 && marker != 0xC3 && marker != 0xC9 &&
            marker != 0xCA) {
          coding = marker;
          fail(kBadCoding);
        }
        read_sof(marker, !header_only);
        if (header_only) return;
      } else if (marker == 0xC4) {
        read_dht();
      } else if (marker == 0xCC) {
        read_dac();
      } else if (marker == 0xDB) {
        read_dqt();
      } else if (marker == 0xDD) {
        if (u16() != 4) fail(kCorrupt);
        restart_interval = u16();
      } else if (marker == 0xDA) {
        if (header_only) fail(kCorrupt);  // a scan before the frame header
        read_sos();
        saw_scan = true;
        ++scan_number;
        decode_scan();
        // one sequential scan of every component: libjpeg decodes it while
        // it outputs the rows, and OpenCV has the image before any marker
        // after it is read
        if (!progressive && ns == ncomp) break;
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
    smooth = progressive && smoothing_ok();
  }
  int coding = 0;

  // -- block smoothing (jdcoefct.c, libjpeg-turbo 3.1) -----------------------
  // smoothing_ok: every component's quantization table latched with the DC
  // and the first nine AC values nonzero, its DC at least partly known, and
  // any of the first nine AC coefficients of any component not fully refined
  bool smoothing_ok() {
    static const int kQ[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (!c.latched) return false;
      for (int q : kQ) {
        if (c.quant[q] == 0) return false;
      }
      if (c.coef_bits[0] < 0) return false;
      c.cur_latch[0] = c.coef_bits[0];
      for (int k = 1; k < 10; ++k) {
        c.cur_latch[k] = c.coef_bits[k];
        c.prev_latch[k] = scan_number > 1 ? c.prev_bits[k] : -1;
        useful |= c.coef_bits[k] != 0;
      }
    }
    return useful;
  }
  // decompress_smooth_data: the block at (by, bx) of `c` in iMCU row `row`,
  // its first nine AC coefficients (and with no AC data at all, its DC)
  // estimated from the DC values of the 5x5 blocks around it where they are
  // zero and not fully known
  void smooth_block(Component& c, int row, int block_row, int bx, int16_t* ws) const {
    const int total_rows = mcuy;
    int block_rows = c.v;
    if (row == total_rows - 1) {
      block_rows = c.bh % c.v;
      if (block_rows == 0) block_rows = c.v;
    }
    // libjpeg's row arithmetic, which counts the last iMCU row's block rows for every row
    const int image_block_row = row * block_rows + block_row, image_block_rows = block_rows * total_rows;
    const int by = row * c.v + block_row;
    const int r0 = by, r_1 = image_block_row > 0 ? by - 1 : r0, r_2 = image_block_row > 1 ? by - 2 : r_1;
    const int r1 = image_block_row < image_block_rows - 1 ? by + 1 : r0;
    const int r2 = image_block_row < image_block_rows - 2 ? by + 2 : r1;
    const int rows_[5] = {r_2, r_1, r0, r1, r2};
    const int last_col = c.bw - 1;
    // the columns of the sliding window: bx - 2 .. bx + 2 as libjpeg's registers hold them
    int cols[5];
    for (int k = 0; k < 5; ++k) {
      int x = bx - 2 + k;
      cols[k] = x < 0 ? 0 : x > last_col ? last_col : x;
    }
    int DC[26];
    for (int rr = 0; rr < 5; ++rr) {
      for (int k = 0; k < 5; ++k) {
        DC[rr * 5 + k + 1] = c.block(rows_[rr], cols[k])[0];
      }
    }
    const int* bits = row > last_good_row ? c.prev_latch : c.cur_latch;
    const bool change_dc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 && bits[4] == -1 && bits[5] == -1 &&
                           bits[6] == -1 && bits[7] == -1 && bits[8] == -1 && bits[9] == -1;
    const int64_t Q00 = c.quant[0];
    auto estimate = [&](int zz, int at, int64_t sum) {
      const int Al = bits[zz];
      if (Al == 0 || ws[at] != 0) return;
      const int64_t q = c.quant[at];
      const int64_t num = Q00 * sum;
      int pred;
      if (num >= 0) {
        pred = (int)(((q << 7) + num) / (q << 8));
        if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
      } else {
        pred = (int)(((q << 7) - num) / (q << 8));
        if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
        pred = -pred;
      }
      ws[at] = (int16_t)pred;
    };
    const int* D = DC;
    if (change_dc) {
      estimate(1, 1, -D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] - 13 * D[9] + 3 * D[10] - 3 * D[11] +
                         38 * D[12] - 38 * D[14] + 3 * D[15] - 3 * D[16] + 13 * D[17] - 13 * D[19] + 3 * D[20] -
                         D[21] - D[22] + D[24] + D[25]);
      estimate(2, 8, -D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] + 13 * D[7] + 38 * D[8] + 13 * D[9] -
                         D[10] + D[16] - 13 * D[17] - 38 * D[18] - 13 * D[19] + D[20] + D[21] + 3 * D[22] +
                         3 * D[23] + 3 * D[24] + D[25]);
      estimate(3, 16, D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] - 14 * D[13] - 5 * D[14] + 2 * D[17] +
                          7 * D[18] + 2 * D[19] + D[23]);
      estimate(4, 9, -D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] + 9 * D[19] + D[21] - D[25]);
      estimate(5, 2, 2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] - 14 * D[13] + 7 * D[14] + D[15] +
                         2 * D[17] - 5 * D[18] + 2 * D[19]);
      estimate(6, 3, D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19]);
      estimate(7, 10, D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19]);
      estimate(8, 17, D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19]);
      estimate(9, 24, D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19]);
      const int64_t num = Q00 * (-2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] - 6 * D[6] + 6 * D[7] +
                                 42 * D[8] + 6 * D[9] - 6 * D[10] - 8 * D[11] + 42 * D[12] + 152 * D[13] +
                                 42 * D[14] - 8 * D[15] - 6 * D[16] + 6 * D[17] + 42 * D[18] + 6 * D[19] -
                                 6 * D[20] - 2 * D[21] - 6 * D[22] - 8 * D[23] - 6 * D[24] - 2 * D[25]);
      const int pred = num >= 0 ? (int)(((Q00 << 7) + num) / (Q00 << 8)) : -(int)(((Q00 << 7) - num) / (Q00 << 8));
      ws[0] = (int16_t)pred;
    } else {
      estimate(1, 1, -7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15]);
      estimate(2, 8, -7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23]);
      estimate(3, 16, -D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23]);
      estimate(4, 9, D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] - D[20] + D[22] - D[24] + D[4] - D[6] +
                         10 * D[7] - 10 * D[9]);
      estimate(5, 2, -D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15]);
    }
  }

  // -- IDCT (jidctint.c jpeg_idct_islow) -----------------------------------
  static int sat16(int64_t x) { return (int)(x < -32768 ? -32768 : x > 32767 ? 32767 : x); }
  static uint8_t range_limit(int64_t x) {  // a sample, saturated to -128..127, + 128
    return (uint8_t)((x < -128 ? -128 : x > 127 ? 127 : x) + 128);
  }
  // one 8-point pass of jidctint-avx2.asm on 16-bit inputs: in0 +- in4,
  // in7 + in3 and in5 + in1 wrap at 16 bits (vpaddw), the products (vpmaddwd)
  // and the rest do not -> the eight outputs before their descale
  static void idct_pass(const int* i, int64_t* o) {
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633,
                  F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
    auto w16 = [](int v) { return (int64_t)(int16_t)v; };
    const int64_t tmp3 = i[2] * (F0541 + F0765) + i[6] * F0541, tmp2 = i[2] * F0541 + i[6] * (F0541 - F1847);
    const int64_t tmp0 = w16(i[0] + i[4]) * 8192, tmp1 = w16(i[0] - i[4]) * 8192;  // << CONST_BITS
    const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    const int64_t z3 = w16(i[7] + i[3]), z4 = w16(i[5] + i[1]);
    const int64_t z3p = z3 * (F1175 - F1961) + z4 * F1175, z4p = z3 * F1175 + z4 * (F1175 - F0390);
    const int64_t o7 = i[7] * (F0298 - F0899) - i[1] * F0899 + z3p, o1 = i[7] * -F0899 + i[1] * (F1501 - F0899) + z4p;
    const int64_t o5 = i[5] * (F2053 - F2562) - i[3] * F2562 + z4p, o3 = i[5] * -F2562 + i[3] * (F3072 - F2562) + z3p;
    o[0] = t10 + o1;
    o[7] = t10 - o1;
    o[1] = t11 + o3;
    o[6] = t11 - o3;
    o[2] = t12 + o5;
    o[5] = t12 - o5;
    o[3] = t13 + o7;
    o[4] = t13 - o7;
  }
  static void idct(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
    auto descale = [](int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; };
    int ws[64], col[8];
    int64_t o[8];
    bool ac_rows = false;  // the SIMD pass 1 skips a block whose rows 1-7 are all zero
    for (int k = 8; k < 64 && !ac_rows; ++k) ac_rows = in[k] != 0;
    for (int c = 0; c < 8; ++c) {
      if (!ac_rows) {  // (dequantized DC << PASS1_BITS) in 16 bits (vpmullw, vpsllw)
        const int dc = (int16_t)((int16_t)(in[c] * q[c]) * 4);
        for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
        continue;
      }
      for (int r = 0; r < 8; ++r) col[r] = (int16_t)(in[r * 8 + c] * q[r * 8 + c]);  // vpmullw
      idct_pass(col, o);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = sat16(descale(o[r], 11));  // vpackssdw
    }
    for (int r = 0; r < 8; ++r) {
      idct_pass(ws + r * 8, o);
      uint8_t* op = out + (size_t)r * stride;
      for (int c = 0; c < 8; ++c) op[c] = range_limit(descale(o[c], 18));  // vpackssdw, vpacksswb, + 128
    }
  }


  // -- upsampling (jdsample.c) ---------------------------------------------
  // plane: the component's samples, pitch bw_mcu * 8; out: width x height
  void upsample(const Component& c, const uint8_t* plane, uint8_t* out) const {
    const int pitch = c.bw_mcu * (lossless ? 1 : 8);
    const int hr = hmax / c.h, vr = vmax / c.v;
    const bool fancy = !lossless;  // libjpeg-turbo replicates lossless samples
    const int dw = c.width, dh = c.height;
    const int ow = dw * hr;  // may pass the image width by up to hr - 1
    std::vector<uint8_t> row(ow);
    auto in_row = [&](int r) { return plane + (size_t)std::min(std::max(r, 0), dh - 1) * pitch; };
    auto put = [&](int y, const uint8_t* src) {
      if (y < height) std::copy(src, src + width, out + (size_t)y * width);
    };
    if (hr == 1 && vr == 1) {
      for (int y = 0; y < height; ++y) put(y, in_row(y));
    } else if (fancy && hr == 2 && vr == 1 && dw > 2) {  // h2v1_fancy_upsample
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
    } else if (fancy && hr == 2 && vr == 2 && dw > 2) {  // h2v2_fancy_upsample
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
    } else if (fancy && hr == 1 && vr == 2) {  // h1v2_fancy_upsample
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
    std::vector<uint8_t> full[4];
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v) fail(kCorrupt);  // JERR_FRACT_SAMPLE_NOTIMPL
      // a component no scan carried keeps zero coefficients (and a zero
      // table, jddctmgr.c): it reads as 128
      const int pitch = c.bw_mcu * (lossless ? 1 : 8);
      std::vector<uint8_t> plane((size_t)pitch * c.bh_mcu * (lossless ? 1 : 8));
      if (lossless && !c.first_rows.empty()) undifference(c, plane.data(), pitch);
      for (int by = 0; !lossless && by < c.bh; ++by) {
        for (int bx = 0; bx < c.bw; ++bx) {
          const int16_t* blk = c.block(by, bx);
          int16_t ws[64];
          if (smooth) {
            std::copy(blk, blk + 64, ws);
            smooth_block(c, by / c.v, by % c.v, bx, ws);
            blk = ws;
          }
          idct(blk, c.quant, plane.data() + (size_t)by * 8 * pitch + bx * 8, pitch);
        }
      }
      full[i].resize((size_t)width * height);
      upsample(c, plane.data(), full[i].data());
    }
    const size_t npix = (size_t)width * height;
    if (ncomp == 1) {
      // libjpeg-turbo converts no colour in a lossless frame: OpenCV's gray to BGR fails there
      if (lossless) fail(kLosslessColor);
      for (size_t p = 0; p < npix; ++p) bgr[3 * p] = bgr[3 * p + 1] = bgr[3 * p + 2] = full[0][p];
      return;
    }
    // jdapimin.c default_decompress_parms: the colour space of 3 or 4 components
    bool rgb = false, ycck = false;
    if (ncomp == 4) {
      ycck = saw_adobe && adobe_transform != 0;  // Adobe transform 2 (or unknown): YCCK; else CMYK
    } else if (color >= 0) {
      rgb = color == 1;
    } else if (saw_jfif) {
      rgb = false;
    } else if (saw_adobe) {
      rgb = adobe_transform == 0;
    } else {  // by the component ids: 'R', 'G', 'B' is RGB, others YCbCr; a lossless frame is RGB
      rgb = lossless || (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66);
    }
    if (lossless && (ncomp == 3 ? !rgb : ycck)) fail(kLosslessColor);
    if (rgb) {
      for (size_t p = 0; p < npix; ++p) {
        bgr[3 * p] = full[2][p];
        bgr[3 * p + 1] = full[1][p];
        bgr[3 * p + 2] = full[0][p];
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table, ycc_rgb_convert (and ycck_cmyk_convert)
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
    if (ncomp == 4 && color == 1) {  // a TIFF's JPEG strip: the four samples as stored (JCS_UNKNOWN)
      for (size_t p = 0; p < npix; ++p) {
        for (int k = 0; k < 4; ++k) bgr[4 * p + k] = full[k][p];
      }
      return;
    }
    if (ncomp == 4) {
      // libjpeg's CMYK (YCCK converted: 255 - R, G, B of its Y, Cb, Cr; K
      // as is), then OpenCV's icvCvt_CMYK2BGR_8u_C4C3R for Adobe's
      // inverted CMYK: each of C, M, Y -> k - ((255 - v) * k >> 8)
      for (size_t p = 0; p < npix; ++p) {
        int c = full[0][p], m = full[1][p], y = full[2][p];
        const int k = full[3][p];
        if (ycck) {
          const int luma = c, cb = m, cr = y;
          c = clamp(255 - (luma + cr_r[cr]));
          m = clamp(255 - (luma + (int)((cb_g[cb] + cr_g[cr]) >> kScale)));
          y = clamp(255 - (luma + cb_b[cb]));
        }
        bgr[3 * p + 2] = (uint8_t)(k - ((255 - c) * k >> 8));
        bgr[3 * p + 1] = (uint8_t)(k - ((255 - m) * k >> 8));
        bgr[3 * p] = (uint8_t)(k - ((255 - y) * k >> 8));
      }
      return;
    }
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
// R, G, B; and with four, as stored too). Returns 0 with the pixels in `out`
// (height * width * 3 BGR bytes, or the four samples of a pixel with
// `color` 1); 1 when `out` is null or smaller than that (meta filled); or a
// negative status: -1 corrupt or truncated before its first scan (cv2 reads
// nothing), -2 a process it does not decode (meta[3]), -3 two components,
// -4 a precision other than 8 bits, -5 a lossless frame in gray, YCbCr or
// YCCK.
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
    const int channels = dec.ncomp == 4 && color == 1 ? 4 : 3;
    if (out == nullptr || cap < (int64_t)dec.width * dec.height * channels) return jpg::kNeedBuffer;
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

// ---------------------------------------------------------------------------
// Radiance HDR scanlines, as rgbe.cpp's RGBE_ReadPixels_RLE reads them (the
// reader of OpenCV's grfmt_hdr.cpp): a width below 8 or past 32767 is read
// flat; otherwise each scanline starts 2, 2, width (16 bits, high byte below
// 128) and holds its four channels one after another, each as runs (a count
// past 128: count - 128 copies of the next byte) and literal stretches (a
// count of 1 to 128, then that many bytes). A scanline that does not start
// so is read flat, with every pixel after it. A count of 0, a run past the
// channel's end, a wrong width or data that ends early fails the file.
// ---------------------------------------------------------------------------

extern "C" {

int hdr_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t width, int64_t height) {
  const int64_t total = width * height;
  int64_t pos = 0;
  auto flat = [&](int64_t from) -> int {
    const int64_t need = (total - from) * 4;
    if (n - pos < need) return -1;
    std::copy(src + pos, src + pos + need, dst + from * 4);
    return 0;
  };
  if (width < 8 || width > 0x7fff) return flat(0);
  std::vector<uint8_t> line((size_t)width * 4);
  for (int64_t y = 0; y < height; ++y) {
    if (n - pos < 4) return -1;
    const uint8_t* p = src + pos;
    if (p[0] != 2 || p[1] != 2 || (p[2] & 0x80)) return flat(y * width);
    if (((p[2] << 8) | p[3]) != width) return -1;
    pos += 4;
    uint8_t* q = line.data();
    for (int c = 0; c < 4; ++c) {
      uint8_t* end = line.data() + (c + 1) * width;
      while (q < end) {
        if (n - pos < 2) return -1;
        const int a = src[pos], b = src[pos + 1];
        pos += 2;
        if (a > 128) {
          const int count = a - 128;
          if (count > end - q) return -1;
          std::fill(q, q + count, (uint8_t)b);
          q += count;
        } else {
          const int count = a;
          if (count == 0 || count > end - q) return -1;
          *q++ = (uint8_t)b;
          if (count > 1) {
            if (n - pos < count - 1) return -1;
            std::copy(src + pos, src + pos + count - 1, q);
            pos += count - 1;
            q += count - 1;
          }
        }
      }
    }
    uint8_t* row = dst + y * width * 4;
    for (int64_t x = 0; x < width; ++x)
      for (int c = 0; c < 4; ++c) row[x * 4 + c] = line[c * width + x];
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// GIF LZW, as OpenCV 5.0's GifDecoder::lzwDecode reads it: LSB-first codes
// of min_size + 1 bits, widening (up to 12) when the next table entry reaches
// 1 << width, read byte by byte from the frame's data sub-blocks (`src`
// starts at the first block's length byte). A Clear resets the table; an End
// resets it too and stops the codes of that byte, and decoding goes on while
// data is left. A code that arrives once the frame holds all its pixels ends
// the frame: read if its sub-block has no bytes left, refused otherwise. A
// code past the entry being built fails, and so does a frame whose strings
// fall short of its pixels or run past them. Returns 0 or -1.
// ---------------------------------------------------------------------------

extern "C" {

int gif_lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t npix, int min_size) {
  if (min_size < 2 || min_size > 11 || n < 1) return -1;
  const int clear = 1 << min_size, end = clear + 1, kMax = 4096;
  // entry i's string: its prefix entry's string, then suffix; first[] is its first byte
  std::vector<int16_t> prefix(kMax + 1, -1);
  std::vector<uint8_t> suffix(kMax + 1, 0), first(kMax + 1, 0);
  std::vector<int32_t> length(kMax + 1, 1);
  for (int i = 0; i < clear; ++i) { suffix[i] = (uint8_t)i; first[i] = (uint8_t)i; }
  int width = min_size + 1, next = end, prev = -1;
  int64_t idx = 0, pos = 0;
  uint32_t bits = 0;
  int nbits = 0;
  int block = src[pos++];
  while (block) {
    if (nbits < width) {
      if (pos >= n) return -1;
      bits |= (uint32_t)src[pos++] << nbits;
      nbits += 8;
      --block;
    }
    while (nbits >= width) {
      const int code = (int)(bits & ((1u << width) - 1));
      bits >>= width;
      nbits -= width;
      if (code == clear || code == end) {
        width = min_size + 1;
        next = end;
        prev = -1;
        if (code == end) break;
        continue;
      }
      if (idx == npix) return block == 0 ? 0 : -1;
      if (prev < 0) {
        if (code >= clear) return -1;
        next = end + 1;
      } else {
        if (code > next) return -1;
        // complete the entry being built: the previous string, then this one's first byte
        prefix[next] = (int16_t)prev;
        suffix[next] = code == next ? first[prev] : first[code];
        first[next] = first[prev];
        length[next] = length[prev] + 1;
        if (next < kMax) ++next;
      }
      // the string back to front from its chain (only the part inside the frame is kept)
      const int64_t n = length[code];
      int64_t at = idx + n - 1;
      for (int c = code; c >= 0; c = prefix[c], --at)
        if (at < npix) dst[at] = suffix[c];
      idx += n;
      prev = code;
      if (next == (1 << width) && width < 12) ++width;
    }
    if (block == 0) {
      if (pos >= n) return -1;
      block = src[pos++];
    }
  }
  return idx == npix ? 0 : -1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Float samples to 8 bits as OpenCV's convertTo (saturate_cast<uchar> of
// float) makes them: v * scale in float32, rounded half to even, 0 where
// the rounding leaves int32 (NaN and the infinities too, as cvRound gives
// INT_MIN there), else clamped to 0..255. `rgbe` decodes Radiance pixels
// (R, G, B, E; rgbe2float: mantissa * 2^(E - 136), 0 where E is 0, then
// x255) into B, G, R; otherwise `src` holds float32 R, G, B to scale.
// ---------------------------------------------------------------------------

extern "C" {

void float_to_u8(const void* src, int64_t pixels, int rgbe, float scale, uint8_t* dst) {
  auto put = [](float v) -> uint8_t {
    const float r = std::nearbyint(v);
    if (!(r >= -2147483648.0f && r < 2147483648.0f)) return 0;
    return (uint8_t)(r < 0.0f ? 0.0f : r > 255.0f ? 255.0f : r);
  };
  if (rgbe) {
    const uint8_t* p = (const uint8_t*)src;
    float f[256];
    for (int e = 0; e < 256; ++e) f[e] = e ? (float)std::ldexp(1.0, e - 136) : 0.0f;
    for (int64_t i = 0; i < pixels; ++i, p += 4, dst += 3) {
      const float m = f[p[3]];
      for (int c = 0; c < 3; ++c) dst[c] = put((float)p[2 - c] * m * 255.0f);
    }
  } else {
    const float* p = (const float*)src;
    for (int64_t i = 0; i < 3 * pixels; ++i) dst[i] = put(p[i] * scale);
  }
}

}  // extern "C"
