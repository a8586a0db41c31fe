// Host entropy encoder for the device DCT sink: a baseline JPEG from
// quantized DCT coefficient blocks, with no libjpeg.
//
// Port of fc_encode_jpeg_coeffs (native/fanlin_codec.cpp), which runs
// libjpeg's jpeg_set_defaults + jpeg_set_quality(q, TRUE) +
// jpeg_write_coefficients on YCbCr 4:2:0 blocks. The card's machine has
// no libjpeg, so this file writes the same bytes libjpeg-turbo does:
//
//   * markers (jcmarker.c): SOI; a JFIF APP0 (version 1.01, units 0,
//     density 1x1, no thumbnail); one DQT per table (luma 0, chroma
//     1), 8-bit, in zigzag order; SOF0 with components 1, 2, 3 sampled
//     2x2, 1x1, 1x1 on tables 0, 1, 1; one DHT per table in the order
//     the scan header emits them (DC0, AC0, DC1, AC1), the Annex K
//     standard tables; SOS over the three components; EOI;
//   * the quant tables are jpeg_set_quality's IJG scaling of the Annex
//     K tables, clamped to 1-255 (force_baseline);
//   * one interleaved scan of MCUs of 4 Y + Cb + Cr blocks
//     (jctrans.c compress_output): only ceil(w/8) x ceil(h/8) luma and
//     ceil(w/16) x ceil(h/16) chroma blocks are read from the MCU-padded
//     grids; a luma position past the true block counts in an edge MCU
//     is a dummy block, AC zero and DC equal to the DC of the block
//     before it in the MCU's block order;
//   * Huffman coding as jchuff.c encode_one_block: DC differences per
//     component, runs of 16 zeros as ZRL, EOB after the last non-zero;
//     0xFF bytes stuffed with 0x00; the last byte padded with 1 bits.
//
// Coefficients come in natural order and are zigzagged on write. A DC
// difference over 11 bits or an AC value over 10 bits is refused
// (libjpeg's JERR_BAD_DCT_COEF; libjpeg-turbo's SIMD encoder skips that
// check and writes a stream that does not decode to the input).
//
// Built with the host compiler by fanlin_tpu_torch/ops/_build.py
// (build_host) and bound in fanlin_tpu_torch/engine/jpeg_encode.py.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// natural index of each zigzag position
const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// JPEG Annex K base quant tables, natural order
const int kBaseLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kBaseChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3 standard Huffman tables: code counts per length 1-16, then
// the symbols
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

const int kMaxCoefBits = 10;  // MAX_COEF_BITS for 8-bit samples

struct Spec {
  const uint8_t* bits;
  const uint8_t* vals;
  int nvals;
};

// jpeg_make_c_derived_tbl: code and length of each symbol
struct HuffCodes {
  unsigned code[256] = {};
  int size[256] = {};
  explicit HuffCodes(const Spec& s) {
    unsigned c = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < s.bits[len - 1]; ++i, ++k) {
        code[s.vals[k]] = c++;
        size[s.vals[k]] = len;
      }
      c <<= 1;
    }
  }
};

// Bit writer with jchuff.c's byte stuffing and 1-bit padding.
class BitWriter {
 public:
  explicit BitWriter(std::vector<uint8_t>& out) : out_(out) {}
  void put(unsigned code, int size) {
    acc_ = (acc_ << size) | (code & ((1u << size) - 1));
    nbits_ += size;
    while (nbits_ >= 8) {
      nbits_ -= 8;
      const uint8_t b = static_cast<uint8_t>(acc_ >> nbits_);
      out_.push_back(b);
      if (b == 0xFF) out_.push_back(0);
    }
    acc_ &= (1ull << nbits_) - 1;
  }
  void flush() { put(0x7F, 7); }  // fill the final byte with ones

 private:
  std::vector<uint8_t>& out_;
  uint64_t acc_ = 0;
  int nbits_ = 0;
};

int nbits_of(int v) {
  int n = 0;
  for (unsigned a = static_cast<unsigned>(v < 0 ? -v : v); a; a >>= 1) ++n;
  return n;
}

struct Refused {};

// jchuff.c encode_one_block (the C path, range checks included)
void encode_block(BitWriter& bw, const int16_t* blk, int& last_dc,
                  const HuffCodes& dc, const HuffCodes& ac) {
  int temp = blk[0] - last_dc;
  last_dc = blk[0];
  int n = nbits_of(temp);
  if (n > kMaxCoefBits + 1) throw Refused{};
  bw.put(dc.code[n], dc.size[n]);
  if (n) bw.put(static_cast<unsigned>(temp < 0 ? temp - 1 : temp), n);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    temp = blk[kZigzag[k]];
    if (temp == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    n = nbits_of(temp);
    if (n > kMaxCoefBits) throw Refused{};
    const int sym = (run << 4) + n;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(static_cast<unsigned>(temp < 0 ? temp - 1 : temp), n);
    run = 0;
  }
  if (run > 0) bw.put(ac.code[0], ac.size[0]);
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 0xFF));
}

void marker(std::vector<uint8_t>& o, int m) {
  o.push_back(0xFF);
  o.push_back(static_cast<uint8_t>(m));
}

void emit_dqt(std::vector<uint8_t>& o, int index, const int* base, int scale) {
  marker(o, 0xDB);
  put16(o, 2 + 1 + 64);
  o.push_back(static_cast<uint8_t>(index));  // 8-bit precision
  for (int k = 0; k < 64; ++k) {
    long t = (static_cast<long>(base[kZigzag[k]]) * scale + 50) / 100;
    if (t <= 0) t = 1;
    if (t > 255) t = 255;  // force_baseline
    o.push_back(static_cast<uint8_t>(t));
  }
}

void emit_dht(std::vector<uint8_t>& o, int index, const Spec& s) {
  marker(o, 0xC4);
  put16(o, 2 + 1 + 16 + s.nvals);
  o.push_back(static_cast<uint8_t>(index));
  o.insert(o.end(), s.bits, s.bits + 16);
  o.insert(o.end(), s.vals, s.vals + s.nvals);
}

void encode(const int16_t* const planes[3], int width, int height, int quality,
            std::vector<uint8_t>& o) {
  if (quality < 1) quality = 1;
  if (quality > 100) quality = 100;
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  const Spec dc_luma{kDcLumaBits, kDcVals, 12}, dc_chroma{kDcChromaBits, kDcVals, 12};
  const Spec ac_luma{kAcLumaBits, kAcLumaVals, 162};
  const Spec ac_chroma{kAcChromaBits, kAcChromaVals, 162};

  marker(o, 0xD8);
  marker(o, 0xE0);  // JFIF APP0
  put16(o, 16);
  static const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  o.insert(o.end(), jfif, jfif + 14);
  emit_dqt(o, 0, kBaseLuma, scale);
  emit_dqt(o, 1, kBaseChroma, scale);
  marker(o, 0xC0);  // SOF0
  put16(o, 8 + 3 * 3);
  o.push_back(8);
  put16(o, height);
  put16(o, width);
  o.push_back(3);
  static const uint8_t comps[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  o.insert(o.end(), comps, comps + 9);
  emit_dht(o, 0x00, dc_luma);
  emit_dht(o, 0x10, ac_luma);
  emit_dht(o, 0x01, dc_chroma);
  emit_dht(o, 0x11, ac_chroma);
  marker(o, 0xDA);  // SOS
  put16(o, 6 + 2 * 3);
  static const uint8_t sos[10] = {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  o.insert(o.end(), sos, sos + 10);

  const HuffCodes hdc[2] = {HuffCodes(dc_luma), HuffCodes(dc_chroma)};
  const HuffCodes hac[2] = {HuffCodes(ac_luma), HuffCodes(ac_chroma)};
  const int mcu_cols = (width + 15) / 16, mcu_rows = (height + 15) / 16;
  const int yw = mcu_cols * 2;                         // padded luma grid width
  const int ybw = (width + 7) / 8, ybh = (height + 7) / 8;  // true luma blocks
  int16_t dummy[4][64] = {};
  int last_dc[3] = {0, 0, 0};
  BitWriter bw(o);
  for (int my = 0; my < mcu_rows; ++my) {
    for (int mx = 0; mx < mcu_cols; ++mx) {
      const int16_t* prev = nullptr;
      for (int by = 0; by < 2; ++by) {
        for (int bx = 0; bx < 2; ++bx) {
          const int r = my * 2 + by, c = mx * 2 + bx;
          const int16_t* blk;
          if (r < ybh && c < ybw) {
            blk = planes[0] + (static_cast<size_t>(r) * yw + c) * 64;
          } else {
            int16_t* d = dummy[by * 2 + bx];
            d[0] = prev[0];
            blk = d;
          }
          encode_block(bw, blk, last_dc[0], hdc[0], hac[0]);
          prev = blk;
        }
      }
      for (int ci = 1; ci < 3; ++ci) {
        const int16_t* blk =
            planes[ci] + (static_cast<size_t>(my) * mcu_cols + mx) * 64;
        encode_block(bw, blk, last_dc[ci], hdc[1], hac[1]);
      }
    }
  }
  bw.flush();
  marker(o, 0xD9);
}

}  // namespace

extern "C" {

// Entropy-encode quantized DCT coefficient blocks (int16, natural order,
// 64 per block) over the MCU-padded 4:2:0 grids: y is
// (2 * ceil(h/16)) x (2 * ceil(w/16)) blocks, cb and cr
// ceil(h/16) x ceil(w/16). quality (clamped to 1-100) must be the one the
// coefficients were quantized with. *out receives a malloc'd JPEG (free
// with fanlin_free). Returns 0; 1 when a coefficient is out of baseline
// range; 2 for bad dimensions; 3 when out of memory.
int fanlin_encode_jpeg_coeffs(const int16_t* y, const int16_t* cb,
                              const int16_t* cr, int width, int height,
                              int quality, uint8_t** out, size_t* out_len) {
  if (width < 1 || height < 1 || width > 65535 || height > 65535) return 2;
  try {
    std::vector<uint8_t> o;
    const int16_t* const planes[3] = {y, cb, cr};
    encode(planes, width, height, quality, o);
    uint8_t* buf = static_cast<uint8_t*>(malloc(o.size()));
    if (buf == nullptr) return 3;
    memcpy(buf, o.data(), o.size());
    *out = buf;
    *out_len = o.size();
    return 0;
  } catch (const Refused&) {
    return 1;
  } catch (...) {
    return 3;
  }
}

void fanlin_free(void* p) { free(p); }

}  // extern "C"
