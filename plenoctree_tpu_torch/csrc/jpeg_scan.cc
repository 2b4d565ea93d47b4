// Entropy decoding of one JPEG scan (Huffman, 8-bit), for utils/jpeg.py.
//
// The sequential, DC-first, DC-refine, AC-first and AC-refine decoders of
// libjpeg's jdhuff.c and jdphuff.c, filling int16 coefficient blocks in
// natural order. utils/jpeg.py parses the markers and lays the scan out:
// slot_comp[i] is the scan component of MCU slot i and mcu_blocks[m * bpm
// + i] the block (a row of 64 coefficients in that component's array) it
// fills. Its pure-Python decoder is this routine's oracle: both give the
// same coefficients, and raise (here: return a negative code) on the same
// faults.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC (utils/jpeg.py does it at first
// use, into build/native/).

#include <cstdint>
#include <cstring>

namespace {

// jpeg_natural_order, with 16 extra entries of 63 that absorb a run past
// the end of a corrupt block as libjpeg's table does.
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum Kind { kSequential = 0, kDcFirst, kDcRefine, kAcFirst, kAcRefine };
enum Error { kTruncated = 1, kBadCode = 2, kBadRestart = 3, kBadDc = 4 };

constexpr int kLookBits = 9;

// A canonical Huffman table: a 9-bit lookahead, then libjpeg's maxcode
// search for longer codes.
struct Table {
  int32_t maxcode[18];
  int32_t valoffset[17];
  uint8_t vals[256];
  uint8_t look_len[1 << kLookBits];  // 0: longer than kLookBits
  uint8_t look_sym[1 << kLookBits];

  void build(const int32_t* src) {
    if (!src[0]) return;  // the scan does not use this table
    const int32_t* bits = src + 1;
    for (int i = 0; i < 256; i++) vals[i] = static_cast<uint8_t>(src[17 + i]);
    std::memset(look_len, 0, sizeof(look_len));
    int32_t code = 0, k = 0;
    for (int len = 1; len <= 16; len++) {
      int n = bits[len - 1];
      maxcode[len] = -1;
      valoffset[len] = 0;
      if (n) {
        valoffset[len] = k - code;
        for (int j = 0; j < n; j++, code++, k++) {
          if (len <= kLookBits) {
            int shift = kLookBits - len;
            for (int f = 0; f < (1 << shift); f++) {
              int idx = (code << shift) | f;
              look_len[idx] = static_cast<uint8_t>(len);
              look_sym[idx] = vals[k];
            }
          }
        }
        maxcode[len] = code - 1;
      }
      code <<= 1;
    }
    maxcode[17] = 0xFFFFF;
  }
};

// MSB-first bits of the entropy-coded data with 0xFF00 unstuffed. At a
// marker (or the end of the buffer) it appends zero bits and counts them;
// consuming one of those is the truncation error.
struct Reader {
  const uint8_t* d;
  int64_t n;
  int64_t pos;
  uint64_t acc = 0;
  int bits = 0;
  int fake = 0;
  bool at_marker = false;
  int err = 0;

  void fill() {
    while (bits <= 56) {
      if (!at_marker) {
        if (pos >= n) {
          at_marker = true;
        } else {
          uint8_t b = d[pos];
          if (b == 0xFF) {
            if (pos + 1 < n && d[pos + 1] == 0) {
              pos += 2;
            } else {
              at_marker = true;
            }
          } else {
            pos++;
          }
          if (!at_marker) {
            acc = (acc << 8) | b;
            bits += 8;
            continue;
          }
        }
      }
      acc <<= 8;
      bits += 8;
      fake += 8;
    }
  }
  uint32_t peek(int k) {
    if (bits < k) fill();
    return static_cast<uint32_t>((acc >> (bits - k)) & ((1u << k) - 1));
  }
  void skip(int k) {
    bits -= k;
    if (bits < fake) err = kTruncated;
  }
  int get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return static_cast<int>(v);
  }
  int decode(const Table& t) {
    uint32_t look = peek(kLookBits);
    int len = t.look_len[look];
    if (len) {
      skip(len);
      return t.look_sym[look];
    }
    len = kLookBits + 1;  // every shorter code is in the lookahead
    int32_t code = static_cast<int32_t>(peek(len));
    while (len <= 16 && code > t.maxcode[len]) {
      len++;
      code = static_cast<int32_t>(peek(len));
    }
    if (len > 16) {
      err = kBadCode;
      skip(16);
      return 0;
    }
    skip(len);
    return t.vals[(code + t.valoffset[len]) & 0xFF];
  }
  // Drop the buffered bits, skip to the next marker, which must be
  // RST<expect>.
  bool restart(int expect) {
    int64_t p = pos;
    while (p + 1 < n && !(d[p] == 0xFF && d[p + 1] != 0x00 && d[p + 1] != 0xFF)) p++;
    if (p + 1 >= n || d[p + 1] != 0xD0 + expect) {
      err = kBadRestart;
      return false;
    }
    pos = p + 2;
    acc = 0;
    bits = fake = 0;
    at_marker = false;
    return true;
  }
};

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r; }

}  // namespace

extern "C" int64_t pn_jpeg_scan(const uint8_t* data, int64_t size, int64_t pos, int32_t ncomp,
                                int16_t** coefs, const int32_t* tables,
                                const int32_t* slot_comp, int64_t n_mcu, int32_t bpm,
                                const int32_t* mcu_blocks, int32_t restart, int32_t kind,
                                int32_t ss, int32_t se, int32_t al) {
  Table dc[4], ac[4];
  for (int c = 0; c < ncomp && c < 4; c++) {
    dc[c].build(tables + (2 * c) * 273);
    ac[c].build(tables + (2 * c + 1) * 273);
  }
  Reader br{data, size, pos};
  int last_dc[4] = {0, 0, 0, 0};
  int eobrun = 0;
  int next_rst = 0;
  const int p1 = 1 << al;
  const int m1 = -1 * (1 << al);
  for (int64_t m = 0; m < n_mcu; m++) {
    if (restart && m && m % restart == 0) {
      if (!br.restart(next_rst)) return -br.err;
      next_rst = (next_rst + 1) & 7;
      last_dc[0] = last_dc[1] = last_dc[2] = last_dc[3] = 0;
      eobrun = 0;
    }
    for (int i = 0; i < bpm; i++) {
      const int c = slot_comp[i];
      int16_t* blk = coefs[c] + 64 * static_cast<int64_t>(mcu_blocks[m * bpm + i]);
      if (kind == kSequential || kind == kDcFirst) {
        int s = br.decode(dc[c]);
        if (s > 15) return -kBadDc;
        if (s) s = extend(br.get(s), s);
        last_dc[c] += s;
        blk[0] = static_cast<int16_t>(last_dc[c] * (1 << al));
        if (kind == kSequential) {
          const Table& t = ac[c];
          for (int k = 1; k < 64; k++) {
            int rs = br.decode(t);
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
              k += r;
              blk[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s));
            } else {
              if (r != 15) break;
              k += 15;
            }
          }
        }
      } else if (kind == kDcRefine) {
        if (br.get(1)) blk[0] = static_cast<int16_t>(blk[0] | p1);
      } else if (kind == kAcFirst) {
        if (eobrun > 0) {
          eobrun--;
          continue;
        }
        const Table& t = ac[c];
        for (int k = ss; k <= se; k++) {
          int rs = br.decode(t);
          int r = rs >> 4, s = rs & 15;
          if (s) {
            k += r;
            blk[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s) * (1 << al));
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = (1 << r) + (r ? br.get(r) : 0) - 1;
            break;
          }
        }
      } else {  // kAcRefine: jdphuff.c decode_mcu_AC_refine
        const Table& t = ac[c];
        int k = ss;
        if (eobrun == 0) {
          for (; k <= se; k++) {
            int rs = br.decode(t);
            int r = rs >> 4, s = rs & 15;
            if (s) {
              s = br.get(1) ? p1 : m1;
            } else if (r != 15) {
              eobrun = (1 << r) + (r ? br.get(r) : 0);
              break;
            }
            for (; k <= se; k++) {
              int16_t* coef = blk + kNatural[k];
              if (*coef != 0) {
                if (br.get(1) && (*coef & p1) == 0)
                  *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
              } else if (--r < 0) {
                break;
              }
            }
            if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
          }
        }
        if (eobrun > 0) {
          for (; k <= se; k++) {
            int16_t* coef = blk + kNatural[k];
            if (*coef != 0 && br.get(1) && (*coef & p1) == 0)
              *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
          }
          eobrun--;
        }
      }
      if (br.err) return -br.err;
    }
  }
  return br.pos;
}
