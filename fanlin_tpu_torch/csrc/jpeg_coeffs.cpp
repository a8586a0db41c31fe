// Host entropy reader for the coefficient decode: a JPEG's quantized
// DCT coefficients and quant tables, with no libjpeg.
//
// Port of fc_read_jpeg_coeffs (native/fanlin_codec.cpp), which runs
// libjpeg's jpeg_read_coefficients. The card's machine has no libjpeg,
// so this file reimplements the parts of libjpeg-turbo's marker reader
// (jdmarker.c), input controller (jdinput.c), sequential Huffman
// decoder (jdhuff.c) and progressive Huffman decoder (jdphuff.c) that
// a baseline, extended-sequential or progressive 8-bit Huffman stream
// reaches, and gives the same coefficients on every stream libjpeg
// reads:
//
//   * block grids are libjpeg's: width_in_blocks =
//     ceil(ceil(W * h_i / h_max) / 8) per component; interleaved scans
//     decode whole MCUs (dummy blocks past the grid are decoded and
//     dropped), non-interleaved scans cover exactly the grid;
//   * restart intervals reset the DC predictors; a missing or
//     misnumbered RSTn resyncs as jpeg_resync_to_restart does;
//   * once the entropy data runs out (a marker, or the end of the
//     buffer, which reads as FF D9 like jpeg_mem_src's fake EOI), the
//     current MCU decodes on zero bits and the rest of the restart
//     interval stays zero (jdhuff's insufficient_data);
//   * an invalid Huffman code decodes as 0 after 17 bits;
//   * the quant tables reported are those defined at EOI;
//   * progressive scans (SOF2): DC first and refine, AC first and
//     refine with EOB runs, successive approximation and restart
//     intervals, each scan writing into the one coefficient grid per
//     component as jpeg_read_coefficients does; an interleaved DC scan
//     decodes whole MCUs (dummy blocks included), an AC scan covers
//     exactly the grid; coefficients of scans that never arrive stay 0.
//
// Lossless, arithmetic, 12-bit, DHT-less streams (libjpeg substitutes
// its standard tables) and anything else it does not parse return
// non-zero, and the caller decodes pixels. Like
// fc_read_jpeg_coeffs it returns 2 for CMYK/YCCK/RGB colour spaces,
// sampling layouts outside 4:2:0/4:2:2/4:4:0/4:4:4, per-component
// chroma quant tables and coefficient planes over 512 MiB.
//
// Output: two calls. The header call parses the markers up to the first
// SOS and gives the dims, each component's true block grid, the layout
// and the coding process (or the refusal). The decode call parses them
// again, counts the scans it decodes and writes each component's true
// grid straight into a plane the caller owns (a pointer and a row stride
// in blocks each), so no coefficient is copied:
// a block is zeroed just before the first scan that covers its
// component visits it (the stream sets only its non-zero coefficients,
// and a caller's plane may hold anything), a component no scan covers
// is zeroed at the end, and the dummy blocks of an interleaved scan past
// a grid are decoded into one scratch block and dropped.
//
// With `four` set, both calls take the 4-component form
// (fc_read_jpeg_coeffs4, native/fanlin_codec.cpp:678-770): the colour space of libjpeg's
// default_decompress_parms for four components (no Adobe marker or
// Adobe transform 0: CMYK; any other transform: YCCK), plain CMYK with
// every component 1x1, YCCK with comp0 and comp3 at 1x1 or 2x2 and the
// chroma 1x1, comp2 sharing comp1's quant table and comp3 comp0's, and
// the allocation gate at 4.0 (4:4:4) or 2.5 (4:2:0) planes. It returns 2
// for every other layout and for streams of 1 or 3 components.
//
// Speed: the bit reader keeps 57-64 bits buffered (jdhuff's layout),
// Huffman codes up to 8 bits decode through a 256-entry lookup, and an
// AC coefficient whose code and magnitude bits fit in 9 bits decodes
// through one 512-entry lookup (value, run and length together). Both
// lookups only shortcut what the bit-by-bit decode gives.
//
// Built with the host compiler by fanlin_tpu_torch/ops/_build.py
// (build_host) and bound in fanlin_tpu_torch/engine/jpeg_coeffs.py.

#include <cstdint>
#include <cstring>

namespace {

const double kMaxDecodeAlloc = 512.0 * 1024.0 * 1024.0;  // FC_MAX_DECODE_ALLOC
const int kMaxDimension = 65500;                          // JPEG_MAX_DIMENSION
const int kMinGetBits = 57;                               // BIT_BUF_SIZE - 7

// zigzag index -> natural index, with libjpeg's 16 extra entries so a
// corrupt run length past 63 writes to position 63
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Fail {
  int rc;
};

[[noreturn]] void fail(int rc = 1) { throw Fail{rc}; }

// A Huffman table as jpeg_make_d_derived_tbl derives it. A table that
// does not derive (JERR_BAD_HUFF_TABLE) fails only when a scan uses it,
// as in libjpeg.
struct HuffTable {
  bool defined = false;
  bool valid = false;
  uint8_t bits[17];
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t lookup[256];  // (length << 8) | symbol for codes <= 8 bits, else 9 << 8
  // AC tables: for a 9-bit lookahead whose code and magnitude bits fit
  // in it, (value << 16) | (run << 8) | bits used; else 0
  int32_t fast_ac[512];
};

bool derive(HuffTable& t, bool is_dc) {
  int huffsize[257];
  unsigned huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < t.bits[l]; ++i) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  const int numsymbols = p;
  unsigned code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1u << si)) return false;  // JERR_BAD_HUFF_TABLE
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (t.bits[l]) {
      t.valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
      p += t.bits[l];
      t.maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0xFFFFF;
  for (int i = 0; i < 256; ++i) t.lookup[i] = 9 << 8;
  p = 0;
  for (int l = 1; l <= 8; ++l) {
    for (int i = 1; i <= t.bits[l]; ++i, ++p) {
      const int look = huffcode[p] << (8 - l);
      for (int ctr = 1 << (8 - l); ctr > 0; --ctr) {
        t.lookup[look + (1 << (8 - l)) - ctr] =
            static_cast<uint16_t>((l << 8) | t.vals[p]);
      }
    }
  }
  if (is_dc) {
    for (int i = 0; i < numsymbols; ++i) {
      if (t.vals[i] > 15) return false;
    }
  }
  for (int i = 0; i < 512; ++i) t.fast_ac[i] = 0;
  if (is_dc) return true;
  p = 0;
  for (int l = 1; l <= 9; ++l) {
    for (int i = 1; i <= t.bits[l]; ++i, ++p) {
      const int run = t.vals[p] >> 4, size = t.vals[p] & 15;
      if (size == 0 || l + size > 9) continue;  // EOB, ZRL, long
      for (int rest = 0; rest < (1 << (9 - l)); ++rest) {
        const int look = (static_cast<int>(huffcode[p]) << (9 - l)) | rest;
        const int r = rest >> (9 - l - size);
        const int v = r < (1 << (size - 1)) ? r - (1 << size) + 1 : r;
        t.fast_ac[look] = static_cast<int32_t>(
            (static_cast<uint32_t>(v) << 16) | (run << 8) | (l + size));
      }
    }
  }
  return true;
}

struct Component {
  int id, h, v, tq;
  int wib, hib;      // width_in_blocks, height_in_blocks
  int dc_tbl, ac_tbl;
  int16_t* dst = nullptr;  // the caller's plane: hib rows of wib blocks,
  size_t stride = 0;       // `stride` blocks apart, natural order
  bool seen = false;       // a scan has covered it (its blocks zeroed)

  int16_t* block(int by, int bx) const {
    return dst + (static_cast<size_t>(by) * stride + bx) * 64;
  }
};

class Reader {
 public:
  Reader(const uint8_t* data, size_t len) : d_(data), n_(len) {}

  // Parse up to the first SOS: 0 and info[0..8] = width, height, ybw,
  // ybh, cbw, cbh, subsamp, ycck (fc_read_jpeg_coeffs' layout, or with
  // four fc_read_jpeg_coeffs4's), progressive, else the refusal.
  int header(bool four, int* info);
  // After header: decode every scan into the planes (one per component,
  // comp0 first; one for gray), give the quant tables at EOI and count
  // the scans decoded. rows and cols must be each component's true grid,
  // strides at least cols.
  int decode(int16_t* const* planes, const int* strides, const int* rows,
             const int* cols, uint16_t* qtables, int* scans);

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;

  // jpeg_mem_src: past the end the source yields a fake EOI, again
  // and again. Marker segments are read through it too, so a segment
  // cut by the end of the data parses on FF D9 bytes as libjpeg's does.
  int byte() {
    const size_t p = pos_++;
    if (p < n_) return d_[p];
    return ((p - n_) & 1) ? 0xD9 : 0xFF;
  }
  int two_bytes() {
    const int hi = byte();
    return (hi << 8) | byte();
  }
  // skip_input_data: moves on through the same virtual stream
  void skip(long count) {
    if (count > 0) pos_ += static_cast<size_t>(count);
  }

  // marker state
  bool saw_soi_ = false, saw_sof_ = false, saw_jfif_ = false;
  bool saw_adobe_ = false;
  int adobe_transform_ = 0;
  int unread_marker_ = 0;
  int next_restart_num_ = 0;
  int restart_interval_ = 0;
  bool multiple_scans_ = false;
  bool progressive_ = false;
  bool is_gray_ = false;

  // frame
  int width_ = 0, height_ = 0, ncomp_ = 0;
  int max_h_ = 1, max_v_ = 1;
  Component comp_[4];
  bool qdefined_[4] = {false, false, false, false};
  uint16_t qtbl_[4][64];
  HuffTable dc_[4], ac_[4];

  // scan: its components, spectral band [ss_, se_] and successive
  // approximation bits (ah_, al_)
  int scan_n_ = 0;
  Component* scan_[4];
  int ss_ = 0, se_ = 63, ah_ = 0, al_ = 0;
  // entropy state, reset at each scan and restart
  int last_dc_[4] = {0, 0, 0, 0};
  unsigned eobrun_ = 0;

  // bit reader (jdhuff.c's bitread state)
  uint64_t buf_ = 0;
  int bits_left_ = 0;
  bool insufficient_ = false;

  int16_t scratch_[64];  // where dummy blocks past a grid decode

  int read_markers();  // returns the marker that stopped it: SOS or EOI
  int next_marker();
  void first_marker();
  void get_sof(int marker);
  void get_dht();
  void get_dqt();
  void get_dri();
  void get_sos();
  void get_app(int marker);
  void skip_variable();
  void initial_setup();
  void decode_scan();
  template <typename F>
  void for_each_mcu(bool skip_when_insufficient, F&& decode);
  void process_restart();
  void read_restart_marker();
  void resync_to_restart(int desired);

  void fill(int nbits);
  int get_bits(int n) {
    if (bits_left_ < n) fill(n);
    bits_left_ -= n;
    return static_cast<int>((buf_ >> bits_left_) & ((1u << n) - 1));
  }
  int huff_decode(const HuffTable& t);
  void decode_block(int16_t* block, const HuffTable& dc, const HuffTable& ac,
                    int* last_dc);
  // jdphuff.c's four MCU decoders, one block at a time
  void dc_first(int16_t* block, const HuffTable& dc, int* last_dc);
  void dc_refine(int16_t* block);
  void ac_first(int16_t* block, const HuffTable& ac);
  void ac_refine(int16_t* block, const HuffTable& ac);
};

void Reader::first_marker() {
  const int c = byte();
  const int c2 = byte();
  if (c != 0xFF || c2 != 0xD8) fail();  // JERR_NO_SOI
  unread_marker_ = c2;
}

int Reader::next_marker() {
  int c;
  for (;;) {
    c = byte();
    while (c != 0xFF) c = byte();  // skip garbage (libjpeg warns)
    do {
      c = byte();
    } while (c == 0xFF);
    if (c != 0) break;  // FF 00: stuffed data, keep looking
  }
  unread_marker_ = c;
  return c;
}

void Reader::skip_variable() {
  skip(two_bytes() - 2L);
}

void Reader::get_app(int marker) {
  // APP0 (JFIF) and APP14 (Adobe) decide the colour space
  // (jdmarker.c get_interesting_appn / examine_app0 / examine_app14)
  long length = two_bytes() - 2L;
  const int numtoread = length >= 14 ? 14 : (length > 0 ? int(length) : 0);
  uint8_t p[14];
  for (int i = 0; i < numtoread; ++i) p[i] = static_cast<uint8_t>(byte());
  length -= numtoread;
  if (marker == 0xE0) {
    if (numtoread >= 14 && p[0] == 'J' && p[1] == 'F' && p[2] == 'I' &&
        p[3] == 'F' && p[4] == 0)
      saw_jfif_ = true;
  } else if (marker == 0xEE) {
    if (numtoread >= 12 && p[0] == 'A' && p[1] == 'd' && p[2] == 'o' &&
        p[3] == 'b' && p[4] == 'e') {
      saw_adobe_ = true;
      adobe_transform_ = p[11];
    }
  }
  skip(length);
}

void Reader::get_sof(int marker) {
  // baseline, extended sequential, progressive; not lossless or
  // arithmetic
  if (marker != 0xC0 && marker != 0xC1 && marker != 0xC2) fail();
  if (saw_sof_) fail();  // JERR_SOF_DUPLICATE
  progressive_ = marker == 0xC2;
  const int length = two_bytes();
  if (byte() != 8) fail();  // data precision
  height_ = two_bytes();
  width_ = two_bytes();
  ncomp_ = byte();
  if (height_ <= 0 || width_ <= 0 || ncomp_ <= 0) fail();  // (no DNL)
  if (ncomp_ > 4) fail(2);
  if (length != 8 + ncomp_ * 3) fail();
  for (int ci = 0; ci < ncomp_; ++ci) {
    Component& c = comp_[ci];
    c.id = byte();
    const int s = byte();
    c.h = s >> 4;
    c.v = s & 15;
    c.tq = byte();
    for (int pi = 0; pi < ci; ++pi) {
      if (comp_[pi].id == c.id) fail();
    }
  }
  saw_sof_ = true;
}

void Reader::get_dht() {
  long length = two_bytes() - 2L;
  while (length > 16) {
    int index = byte();
    HuffTable t;
    t.bits[0] = 0;
    int count = 0;
    for (int i = 1; i <= 16; ++i) {
      t.bits[i] = static_cast<uint8_t>(byte());
      count += t.bits[i];
    }
    length -= 1 + 16;
    if (count > 256 || count > length) fail();  // JERR_BAD_HUFF_TABLE
    for (int i = 0; i < count; ++i) t.vals[i] = static_cast<uint8_t>(byte());
    for (int i = count; i < 256; ++i) t.vals[i] = 0;
    length -= count;
    const bool is_ac = index & 0x10;
    index &= ~0x10;
    if (index < 0 || index >= 4) fail();  // JERR_DHT_INDEX
    t.defined = true;
    t.valid = derive(t, !is_ac);
    (is_ac ? ac_ : dc_)[index] = t;
  }
  if (length != 0) fail();  // JERR_BAD_LENGTH
}

void Reader::get_dqt() {
  long length = two_bytes() - 2L;
  while (length > 0) {
    --length;
    const int n = byte();
    const int prec = n >> 4;
    const int idx = n & 15;
    if (idx >= 4 || prec > 1) fail();
    for (int i = 0; i < 64; ++i) {
      const int v = prec ? two_bytes() : byte();
      qtbl_[idx][kNatural[i]] = static_cast<uint16_t>(v);
    }
    qdefined_[idx] = true;
    length -= 64 * (prec + 1);
  }
  if (length != 0) fail();  // JERR_BAD_LENGTH
}

void Reader::get_dri() {
  if (two_bytes() != 4) fail();
  restart_interval_ = two_bytes();
}

void Reader::get_sos() {
  if (!saw_sof_) fail();  // JERR_SOS_NO_SOF
  const int length = two_bytes();
  const int n = byte();
  if (length != n * 2 + 6 || n < 1 || n > 4) fail();
  for (int i = 0; i < n; ++i) {
    const int cc = byte();
    const int c = byte();
    Component* found = nullptr;
    for (int ci = 0; ci < ncomp_; ++ci) {
      if (comp_[ci].id == cc) found = &comp_[ci];
    }
    if (found == nullptr) fail();
    for (int pi = 0; pi < i; ++pi) {
      if (scan_[pi] == found) fail();
    }
    found->dc_tbl = c >> 4;
    found->ac_tbl = c & 15;
    scan_[i] = found;
  }
  ss_ = byte();
  se_ = byte();
  const int a = byte();
  ah_ = a >> 4;
  al_ = a & 15;
  // a sequential scan with other values only warns
  // (JWRN_NOT_SEQUENTIAL), and jdhuff decodes all 64 coefficients
  if (progressive_) {
    // jdphuff.c start_pass_phuff_decoder: JERR_BAD_PROGRESSION
    bool bad = ss_ == 0 ? se_ != 0 : (ss_ > se_ || se_ > 63 || n != 1);
    if (ah_ != 0 && al_ != ah_ - 1) bad = true;
    if (al_ > 13) bad = true;
    if (bad) fail();
  }
  scan_n_ = n;
  next_restart_num_ = 0;
}

// jdinput.c initial_setup, at the first SOS
void Reader::initial_setup() {
  if (width_ > kMaxDimension || height_ > kMaxDimension) fail();
  max_h_ = max_v_ = 1;
  for (int ci = 0; ci < ncomp_; ++ci) {
    const Component& c = comp_[ci];
    if (c.h <= 0 || c.h > 4 || c.v <= 0 || c.v > 4) fail();
    if (c.h > max_h_) max_h_ = c.h;
    if (c.v > max_v_) max_v_ = c.v;
  }
  for (int ci = 0; ci < ncomp_; ++ci) {
    Component& c = comp_[ci];
    const long long w = static_cast<long long>(width_) * c.h;
    const long long h = static_cast<long long>(height_) * c.v;
    c.wib = static_cast<int>((w + max_h_ * 8 - 1) / (max_h_ * 8));
    c.hib = static_cast<int>((h + max_v_ * 8 - 1) / (max_v_ * 8));
  }
  multiple_scans_ = scan_n_ < ncomp_ || progressive_;
}

// Read markers until SOS or EOI (jdmarker.c read_markers).
int Reader::read_markers() {
  for (;;) {
    if (unread_marker_ == 0) {
      if (!saw_soi_) {
        first_marker();
      } else {
        next_marker();
      }
    }
    const int m = unread_marker_;
    unread_marker_ = 0;
    switch (m) {
      case 0xD8:
        if (saw_soi_) fail();
        saw_soi_ = true;
        break;
      case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC5: case 0xC6:
      case 0xC7: case 0xC8: case 0xC9: case 0xCA: case 0xCB: case 0xCD:
      case 0xCE: case 0xCF:
        get_sof(m);
        break;
      case 0xDA:
        get_sos();
        return m;
      case 0xD9:
        return m;
      case 0xC4:
        get_dht();
        break;
      case 0xDB:
        get_dqt();
        break;
      case 0xDD:
        get_dri();
        break;
      case 0xE0: case 0xEE:
        get_app(m);
        break;
      case 0xE1: case 0xE2: case 0xE3: case 0xE4: case 0xE5: case 0xE6:
      case 0xE7: case 0xE8: case 0xE9: case 0xEA: case 0xEB: case 0xEC:
      case 0xED: case 0xEF: case 0xFE: case 0xDC:
        skip_variable();  // other APPn, COM, DNL
        break;
      case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5:
      case 0xD6: case 0xD7: case 0x01:
        break;  // parameterless
      default:
        fail();  // DAC (arithmetic), unknown markers
    }
  }
}

// jdhuff.c jpeg_fill_bit_buffer: load bytes up to a marker; past it,
// supply zero bits and flag the data as insufficient.
void Reader::fill(int nbits) {
  if (unread_marker_ == 0) {
    while (bits_left_ < kMinGetBits) {
      int c = byte();
      if (c == 0xFF) {
        do {
          c = byte();
        } while (c == 0xFF);
        if (c == 0) {
          c = 0xFF;
        } else {
          unread_marker_ = c;
          break;
        }
      }
      buf_ = (buf_ << 8) | static_cast<unsigned>(c);
      bits_left_ += 8;
    }
  }
  if (unread_marker_ != 0 && nbits > bits_left_) {
    insufficient_ = true;
    buf_ <<= kMinGetBits - bits_left_;
    bits_left_ = kMinGetBits;
  }
}

// HUFF_DECODE + jpeg_huff_decode
int Reader::huff_decode(const HuffTable& t) {
  int l = 1;
  if (bits_left_ < 8) fill(0);
  if (bits_left_ >= 8) {
    const int look = static_cast<int>((buf_ >> (bits_left_ - 8)) & 0xFF);
    const int nb = t.lookup[look] >> 8;
    if (nb <= 8) {
      bits_left_ -= nb;
      return t.lookup[look] & 0xFF;
    }
    l = 9;
  }
  int32_t code = get_bits(l);
  while (code > t.maxcode[l]) {
    code = (code << 1) | get_bits(1);
    ++l;
  }
  if (l > 16) return 0;  // JWRN_HUFF_BAD_CODE: fake a zero
  return t.vals[code + t.valoffset[l]];
}

inline int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r + (-(1 << s) + 1) : r;
}

void Reader::decode_block(int16_t* block, const HuffTable& dc,
                          const HuffTable& ac, int* last_dc) {
  int s = huff_decode(dc);
  if (s) s = extend(get_bits(s), s);
  s = static_cast<int>(static_cast<unsigned>(s) +
                       static_cast<unsigned>(*last_dc));
  *last_dc = s;
  block[0] = static_cast<int16_t>(s);
  for (int k = 1; k < 64; ++k) {
    // fast path: code and magnitude within the next 9 bits
    if (bits_left_ < 9) fill(0);
    if (bits_left_ >= 9) {
      const int32_t e = ac.fast_ac[(buf_ >> (bits_left_ - 9)) & 511];
      if (e) {
        bits_left_ -= e & 255;
        k += (e >> 8) & 15;
        block[kNatural[k]] = static_cast<int16_t>(e >> 16);
        continue;
      }
    }
    s = huff_decode(ac);
    int r = s >> 4;
    s &= 15;
    if (s) {
      k += r;
      block[kNatural[k]] = static_cast<int16_t>(extend(get_bits(s), s));
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

void Reader::resync_to_restart(int desired) {
  int marker = unread_marker_;
  for (;;) {
    int action;
    if (marker < 0xC0) {
      action = 2;
    } else if (marker < 0xD0 || marker > 0xD7) {
      action = 3;
    } else if (marker == 0xD0 + ((desired + 1) & 7) ||
               marker == 0xD0 + ((desired + 2) & 7)) {
      action = 3;
    } else if (marker == 0xD0 + ((desired - 1) & 7) ||
               marker == 0xD0 + ((desired - 2) & 7)) {
      action = 2;
    } else {
      action = 1;
    }
    if (action == 1) {
      unread_marker_ = 0;
      return;
    }
    if (action == 3) return;
    marker = next_marker();
  }
}

void Reader::read_restart_marker() {
  if (unread_marker_ == 0) next_marker();
  if (unread_marker_ == 0xD0 + next_restart_num_) {
    unread_marker_ = 0;
  } else {
    resync_to_restart(next_restart_num_);
  }
  next_restart_num_ = (next_restart_num_ + 1) & 7;
}

void Reader::process_restart() {
  bits_left_ = 0;
  read_restart_marker();
  if (unread_marker_ == 0) insufficient_ = false;
}

// Walk the scan's MCUs in stream order, handling restart intervals,
// and call decode(block, i) for each block of scan component i. A
// non-interleaved scan covers exactly the component's block grid; an
// interleaved one covers whole MCUs, so blocks past the grid (inside
// the grid's padding to whole MCUs) are decoded too, into scratch_.
// With skip_when_insufficient, an MCU that starts after the data ran out
// is left as it is (jdhuff/jdphuff's insufficient_data). The first scan
// that covers a component zeroes each of its blocks as it reaches it,
// skipped or not: every scan of a component covers its whole grid.
template <typename F>
void Reader::for_each_mcu(bool skip_when_insufficient, F&& decode) {
  buf_ = 0;
  bits_left_ = 0;
  insufficient_ = false;
  eobrun_ = 0;
  for (int i = 0; i < 4; ++i) last_dc_[i] = 0;
  int restarts_to_go = restart_interval_;
  bool fresh[4];
  for (int i = 0; i < scan_n_; ++i) fresh[i] = !scan_[i]->seen;
  auto mcu_start = [&]() {
    if (restart_interval_ && restarts_to_go == 0) {
      process_restart();
      for (int i = 0; i < 4; ++i) last_dc_[i] = 0;
      eobrun_ = 0;
      restarts_to_go = restart_interval_;
    }
    if (restart_interval_) --restarts_to_go;
    return !(skip_when_insufficient && insufficient_);
  };
  auto visit = [&](int i, int by, int bx, bool run) {
    const Component& c = *scan_[i];
    int16_t* block;
    if (by < c.hib && bx < c.wib) {
      block = c.block(by, bx);
      if (fresh[i]) memset(block, 0, 64 * sizeof(int16_t));
    } else {
      block = scratch_;
      memset(block, 0, sizeof(scratch_));
    }
    if (run) decode(block, i);
  };

  if (scan_n_ == 1) {
    const Component& c = *scan_[0];
    for (int by = 0; by < c.hib; ++by) {
      for (int bx = 0; bx < c.wib; ++bx) visit(0, by, bx, mcu_start());
    }
  } else {
    int blocks = 0;
    for (int i = 0; i < scan_n_; ++i) blocks += scan_[i]->h * scan_[i]->v;
    if (blocks > 10) fail();  // D_MAX_BLOCKS_IN_MCU
    const int mcus_x = (width_ + max_h_ * 8 - 1) / (max_h_ * 8);
    const int mcus_y = (height_ + max_v_ * 8 - 1) / (max_v_ * 8);
    for (int my = 0; my < mcus_y; ++my) {
      for (int mx = 0; mx < mcus_x; ++mx) {
        const bool run = mcu_start();
        for (int i = 0; i < scan_n_; ++i) {
          const Component& c = *scan_[i];
          for (int yy = 0; yy < c.v; ++yy) {
            for (int xx = 0; xx < c.h; ++xx) {
              visit(i, my * c.v + yy, mx * c.h + xx, run);
            }
          }
        }
      }
    }
  }
  for (int i = 0; i < scan_n_; ++i) scan_[i]->seen = true;
}

// jdphuff.c decode_mcu_DC_first, one block
void Reader::dc_first(int16_t* block, const HuffTable& dc, int* last_dc) {
  int s = huff_decode(dc);
  if (s) s = extend(get_bits(s), s);
  const long long v = static_cast<long long>(*last_dc) + s;
  if (v > INT32_MAX || v < INT32_MIN) fail();  // JERR_BAD_DCT_COEF
  *last_dc = static_cast<int>(v);
  block[0] = static_cast<int16_t>(static_cast<unsigned>(v) << al_);
}

// decode_mcu_DC_refine: the next bit of the two's-complement DC value
void Reader::dc_refine(int16_t* block) {
  if (get_bits(1)) block[0] = static_cast<int16_t>(block[0] | (1 << al_));
}

// decode_mcu_AC_first, with the sequential path's 9-bit lookup for
// codes whose magnitude bits fit in it
void Reader::ac_first(int16_t* block, const HuffTable& ac) {
  if (eobrun_ > 0) {  // a band of zeroes
    --eobrun_;
    return;
  }
  for (int k = ss_; k <= se_; ++k) {
    if (bits_left_ < 9) fill(0);
    if (bits_left_ >= 9) {
      const int32_t e = ac.fast_ac[(buf_ >> (bits_left_ - 9)) & 511];
      if (e) {
        bits_left_ -= e & 255;
        k += (e >> 8) & 15;
        block[kNatural[k]] = static_cast<int16_t>(
            static_cast<unsigned>(e >> 16) << al_);
        continue;
      }
    }
    int s = huff_decode(ac);
    const int r = s >> 4;
    s &= 15;
    if (s) {
      k += r;
      block[kNatural[k]] = static_cast<int16_t>(
          static_cast<unsigned>(extend(get_bits(s), s)) << al_);
    } else if (r == 15) {  // ZRL
      k += 15;
    } else {  // EOBr: a run of 2^r + appended bits bands, this one included
      eobrun_ = 1u << r;
      if (r) eobrun_ += get_bits(r);
      --eobrun_;
      break;
    }
  }
}

// decode_mcu_AC_refine: correction bits for the coefficients already
// non-zero, and newly non-zero coefficients of magnitude 1 << al_
void Reader::ac_refine(int16_t* block, const HuffTable& ac) {
  const int p1 = 1 << al_;
  const int m1 = -p1;
  auto correct = [&](int16_t* coef) {
    if (get_bits(1) && (*coef & p1) == 0) {
      *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
    }
  };
  int k = ss_;
  if (eobrun_ == 0) {
    for (; k <= se_; ++k) {
      int s = huff_decode(ac);
      int r = s >> 4;
      s &= 15;
      if (s) {  // the size should be 1 (libjpeg warns otherwise)
        s = get_bits(1) ? p1 : m1;
      } else if (r != 15) {
        eobrun_ = 1u << r;
        if (r) eobrun_ += get_bits(r);
        break;  // the rest of the band is the EOB run's
      }
      // skip the already-non-zero coefficients (correcting each) and r
      // zero ones
      do {
        int16_t* coef = block + kNatural[k];
        if (*coef != 0) {
          correct(coef);
        } else if (--r < 0) {
          break;  // the target zero coefficient
        }
        ++k;
      } while (k <= se_);
      if (s) block[kNatural[k]] = static_cast<int16_t>(s);
    }
  }
  if (eobrun_ > 0) {
    for (; k <= se_; ++k) {
      int16_t* coef = block + kNatural[k];
      if (*coef != 0) correct(coef);
    }
    --eobrun_;
  }
}

void Reader::decode_scan() {
  // tables the scan uses must be defined (JERR_NO_HUFF_TABLE /
  // JERR_NO_QUANT_TABLE); a DC refinement scan uses none
  const bool dc_scan = ss_ == 0, refine = ah_ != 0;
  for (int i = 0; i < scan_n_; ++i) {
    const Component& c = *scan_[i];
    const bool need_dc = !progressive_ || (dc_scan && !refine);
    const bool need_ac = !progressive_ || !dc_scan;
    if ((need_dc && (c.dc_tbl >= 4 || !dc_[c.dc_tbl].defined ||
                     !dc_[c.dc_tbl].valid)) ||
        (need_ac && (c.ac_tbl >= 4 || !ac_[c.ac_tbl].defined ||
                     !ac_[c.ac_tbl].valid)) ||
        c.tq >= 4 || !qdefined_[c.tq])
      fail();
  }
  if (!progressive_) {
    for_each_mcu(true, [&](int16_t* block, int i) {
      const Component& c = *scan_[i];
      decode_block(block, dc_[c.dc_tbl], ac_[c.ac_tbl], &last_dc_[i]);
    });
  } else if (dc_scan && !refine) {
    for_each_mcu(true, [&](int16_t* block, int i) {
      dc_first(block, dc_[scan_[i]->dc_tbl], &last_dc_[i]);
    });
  } else if (dc_scan) {
    // reads on past the end of the data: the zero bits change nothing
    for_each_mcu(false, [&](int16_t* block, int) { dc_refine(block); });
  } else if (!refine) {
    const HuffTable& ac = ac_[scan_[0]->ac_tbl];
    for_each_mcu(true, [&](int16_t* block, int) { ac_first(block, ac); });
  } else {
    const HuffTable& ac = ac_[scan_[0]->ac_tbl];
    for_each_mcu(true, [&](int16_t* block, int) { ac_refine(block, ac); });
  }
}

int Reader::header(bool four, int* info) {
  if (read_markers() != 0xDA) fail();  // JERR_NO_IMAGE
  // jdapimin.c default_decompress_parms: the colour space
  bool ycck = false;
  if (four) {
    if (ncomp_ != 4) return 2;
    ycck = saw_adobe_ && adobe_transform_ != 0;
  } else if (ncomp_ == 1) {
    is_gray_ = true;
  } else if (ncomp_ == 3) {
    bool ycc = true;
    if (saw_jfif_) {
      ycc = true;
    } else if (saw_adobe_) {
      ycc = adobe_transform_ != 0;
    } else {
      ycc = !(comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66);
    }
    if (!ycc) return 2;
  } else {
    return 2;
  }
  int subsamp = 400;
  if (four) {
    const Component* c = comp_;
    const bool full = c[0].h == 1 && c[0].v == 1;
    const bool half = c[0].h == 2 && c[0].v == 2;
    const bool ok = (full || (ycck && half)) && c[1].h == 1 && c[1].v == 1 &&
                    c[2].h == 1 && c[2].v == 1 && c[3].h == c[0].h &&
                    c[3].v == c[0].v && c[2].tq == c[1].tq &&
                    c[3].tq == c[0].tq;
    if (!ok) return 2;
    subsamp = full ? 444 : 420;
  } else if (!is_gray_) {
    const Component* c = comp_;
    const int h0 = c[0].h, v0 = c[0].v;
    const bool ok = ((h0 == 1 || h0 == 2) && (v0 == 1 || v0 == 2)) &&
                    c[1].h == 1 && c[1].v == 1 && c[2].h == 1 &&
                    c[2].v == 1 && c[1].tq == c[2].tq;
    if (!ok) return 2;
    subsamp = h0 == 2 ? (v0 == 2 ? 420 : 422) : (v0 == 2 ? 440 : 444);
  }
  {
    const double wp = width_ + 15.0, hp = height_ + 15.0;
    const double scale = four ? (subsamp == 444 ? 4.0 : 2.5)
                         : subsamp == 400 ? 1.0
                         : subsamp == 420 ? 1.5
                         : subsamp == 444 ? 3.0
                                          : 2.0;
    if (wp * hp * scale * sizeof(int16_t) > kMaxDecodeAlloc) return 2;
  }
  initial_setup();
  info[0] = width_;
  info[1] = height_;
  info[2] = comp_[0].wib;
  info[3] = comp_[0].hib;
  info[4] = is_gray_ ? 0 : comp_[1].wib;
  info[5] = is_gray_ ? 0 : comp_[1].hib;
  info[6] = subsamp;
  info[7] = ycck ? 1 : 0;
  info[8] = progressive_ ? 1 : 0;
  return 0;
}

int Reader::decode(int16_t* const* planes, const int* strides,
                   const int* rows, const int* cols, uint16_t* qtables,
                   int* scans) {
  const int nplanes = is_gray_ ? 1 : ncomp_;
  for (int ci = 0; ci < nplanes; ++ci) {
    Component& c = comp_[ci];
    if (planes[ci] == nullptr || rows[ci] != c.hib || cols[ci] != c.wib ||
        strides[ci] < cols[ci])
      return 4;
    c.dst = planes[ci];
    c.stride = static_cast<size_t>(strides[ci]);
  }
  *scans = 0;
  for (;;) {
    decode_scan();
    ++*scans;
    const int m = read_markers();
    if (m == 0xD9) break;
    if (!multiple_scans_) fail();  // JERR_EOI_EXPECTED
  }
  const int tq[2] = {comp_[0].tq, is_gray_ ? comp_[0].tq : comp_[1].tq};
  for (int t = 0; t < (is_gray_ ? 1 : 2); ++t) {
    if (tq[t] >= 4 || !qdefined_[tq[t]]) return 2;
  }
  // a component no scan reached (the data ended first) stays zero
  for (int ci = 0; ci < nplanes; ++ci) {
    const Component& c = comp_[ci];
    for (int by = 0; !c.seen && by < c.hib; ++by) {
      memset(c.block(by, 0), 0, static_cast<size_t>(c.wib) * 64 *
                                    sizeof(int16_t));
    }
  }
  for (int i = 0; i < 64; ++i) {
    qtables[i] = qtbl_[tq[0]][i];
    qtables[64 + i] = qtbl_[tq[1]][i];
  }
  return 0;
}

}  // namespace

extern "C" {

// Parse a JPEG's header (markers up to the first SOS): 0 and info[0..8]
// = width, height, ybw, ybh, cbw, cbh, subsamp, ycck, progressive; the
// true block grids are y ybh x ybw, cb and cr cbh x cbw, and with four k
// ybh x ybw. subsamp is 420, 422, 440 or 444, 400 for gray (cbw = cbh =
// 0); with four (the CMYK / YCCK form of fc_read_jpeg_coeffs4) 444 or 420
// and ycck 0 or 1 (the Adobe transform), else ycck is 0. progressive is
// the coding process: 0 for SOF0 and SOF1, 1 for SOF2. Non-zero when the
// caller should decode pixels instead (2: a colour space, layout or size
// that fc_read_jpeg_coeffs, or fc_read_jpeg_coeffs4 with four, refuses;
// with four also a stream of 1 or 3 components).
int fanlin_jpeg_coeffs_header(const uint8_t* data, size_t len, int four,
                              int* info) {
  try {
    Reader r(data, len);
    return r.header(four != 0, info);
  } catch (const Fail& f) {
    return f.rc;
  } catch (...) {
    return 3;
  }
}

// Entropy-decode a JPEG into the caller's planes: one per component
// (y, cb, cr, then k with four; y alone for gray), plane i holding
// rows[i] x cols[i] blocks of 64 int16 in natural order, strides[i]
// blocks from one row to the next. rows and cols must be the true grids
// fanlin_jpeg_coeffs_header gives (4 otherwise); every block of them is
// written, zeros included. qtables = the luma then the chroma quant
// table at EOI (comp0's then comp1's with four), natural order; scans =
// the number of scans decoded (1 for an interleaved sequential stream,
// one per scan of a progressive script). Returns 0, or non-zero as
// fanlin_jpeg_coeffs_header, and for a stream that fails inside its
// scans: the planes then hold nothing to read.
int fanlin_jpeg_coeffs_decode(const uint8_t* data, size_t len, int four,
                              int16_t* const* planes, const int* strides,
                              const int* rows, const int* cols,
                              uint16_t* qtables, int* scans) {
  try {
    Reader r(data, len);
    int info[9];
    const int rc = r.header(four != 0, info);
    return rc != 0 ? rc
                   : r.decode(planes, strides, rows, cols, qtables, scans);
  } catch (const Fail& f) {
    return f.rc;
  } catch (...) {
    return 3;
  }
}

}  // extern "C"
