// JPEG to BGR uint8, the counterpart of cv2.imread(path, IMREAD_COLOR) on a
// JPEG with libjpeg-turbo's default decompression settings, bit for bit:
//
//  - Huffman-coded 8-bit frames: baseline (SOF0), extended sequential (SOF1)
//    and progressive (SOF2: spectral selection and successive approximation,
//    DC and AC, first and refinement scans, EOB runs), restart intervals;
//  - 1 component (gray, repeated into B, G, R) or 3 (YCbCr), with the luma
//    at the frame's largest sampling factors and each chroma component at
//    4:4:4, 4:2:2 (h2v1), 4:2:0 (h2v2) or 4:4:0 (h1v2) against it;
//  - jidctint.c's JDCT_ISLOW integer IDCT with its range-limit table,
//    jdsample.c's "fancy" triangle upsampling (h2v1 and h2v2 only for
//    chroma wider than 2 samples, else replication; h1v2 always), the
//    integer YCbCr -> RGB tables of jdcolor.c;
//  - the Exif orientation (tags 2-8, either TIFF byte order) of the first
//    APP1 segment that starts "Exif\0\0", as OpenCV applies it for
//    IMREAD_COLOR.
//
// Everything else returns kUnsupported: arithmetic coding, lossless and
// hierarchical frames, 12- and 16-bit samples, 2 or 4 components (CMYK /
// YCCK), an RGB-coded 3-component frame (Adobe transform 0 or component ids
// 'R', 'G', 'B'), other sampling layouts, a DNL height, more than 2^30
// pixels, and a progressive file whose scans leave any of the first ten
// coefficients of a component short of full precision (libjpeg then smooths
// across blocks). Truncated or corrupt data returns kCorrupt where libjpeg
// would warn and fill in: entropy data that runs into a marker or the end,
// a missing or misnumbered restart marker, a missing EOI.
//
// No state outside a call; the C entries catch every exception.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

enum Status { kOk = 0, kUnsupported = 1, kCorrupt = 2 };

struct Error {
  Status status;
  std::string message;
};

[[noreturn]] void unsupported(const std::string& m) { throw Error{kUnsupported, m}; }
[[noreturn]] void corrupt(const std::string& m) { throw Error{kCorrupt, m}; }

// zigzag index -> natural index, 16 extra entries for runs past the end
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  uint16_t look[1 << kLookBits] = {};  // (length << 8) | symbol, 0: longer

  void build(const uint8_t counts[17], const uint8_t* symbols, int n) {
    std::memcpy(vals, symbols, n);
    int code = 0, p = 0;
    int codes[256];
    for (int l = 1; l <= 16; ++l) {
      if (counts[l] == 0) {
        maxcode[l] = -1;
      } else {
        valoffset[l] = p - code;
        for (int i = 0; i < counts[l]; ++i) codes[p++] = code++;
        maxcode[l] = code - 1;
      }
      if (code >= (1 << l)) corrupt("bad Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLookBits; ++l) {
      for (int i = 0; i < counts[l]; ++i, ++p) {
        int base = codes[p] << (kLookBits - l);
        for (int j = 0; j < (1 << (kLookBits - l)); ++j)
          look[base + j] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    }
    defined = true;
  }
};

// The entropy-coded bits of one scan. Bytes are taken up to the next marker
// (FF followed by anything but 00) or the end; past it the reader feeds
// zero bits and counts them, and consuming one of them is corrupt data.
struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint64_t acc = 0;
  int bits = 0;
  int phantom = 0;  // zero bits appended after the marker or the end
  bool at_marker = false;

  BitReader(const uint8_t* data, size_t size, size_t start) : d(data), n(size), pos(start) {}

  void fill() {
    while (bits <= 56) {
      uint32_t b = 0;
      if (!at_marker) {
        if (pos >= n) {
          at_marker = true;
        } else if (d[pos] == 0xFF) {
          if (pos + 1 < n && d[pos + 1] == 0x00) {
            b = 0xFF;
            pos += 2;
          } else {
            at_marker = true;
          }
        } else {
          b = d[pos++];
        }
      }
      if (at_marker) phantom += 8;
      acc = (acc << 8) | b;
      bits += 8;
    }
  }
  uint32_t peek(int k) {
    if (bits < k) fill();
    return static_cast<uint32_t>(acc >> (bits - k)) & ((1u << k) - 1);
  }
  void skip(int k) {
    bits -= k;
    if (bits < phantom) corrupt("entropy-coded data ends early (truncated or corrupt)");
  }
  int get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return static_cast<int>(v);
  }
  int decode(const Huffman& h) {
    uint32_t look = peek(16);
    uint16_t e = h.look[look >> (16 - kLookBits)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    for (int l = kLookBits + 1; l <= 16; ++l) {
      int32_t code = static_cast<int32_t>(look >> (16 - l));
      if (code <= h.maxcode[l]) {
        skip(l);
        return h.vals[(h.valoffset[l] + code) & 0xFF];
      }
    }
    corrupt("bad Huffman code");
  }
  // Drop the bits of this interval and pass the restart marker RSTn.
  void restart(int n_expected) {
    acc = 0;
    bits = phantom = 0;
    at_marker = false;
    if (pos + 1 >= n || d[pos] != 0xFF || d[pos + 1] != 0xD0 + n_expected)
      corrupt("missing or misnumbered restart marker");
    pos += 2;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;  // downsampled width and height (libjpeg's)
  int bw = 0, bh = 0;  // blocks a row and rows of blocks, padded to MCUs
  int td = 0, ta = 0;  // table selectors of the current scan
  bool quant_latched = false;
  uint16_t quant[64] = {};  // natural order
  std::vector<int16_t> coef;
  int coef_bits[64];
  int last_dc = 0;
  std::vector<uint8_t> plane;  // bw * 8 wide, bh * 8 high
};

// jdmaster.c's prepare_range_limit_table, post-IDCT part: index by
// (value & 1023) for value in the IDCT's signed domain.
struct Tables {
  uint8_t idct_limit[1024];
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  Tables() {
    for (int x = 0; x < 1024; ++x) {
      uint8_t v;
      if (x < 128) v = static_cast<uint8_t>(x + 128);
      else if (x < 512) v = 255;
      else if (x < 896) v = 0;
      else v = static_cast<uint8_t>(x - 896);
      idct_limit[x] = v;
    }
    const int64_t one_half = int64_t(1) << 15;
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = static_cast<int32_t>(-fix(0.71414) * x);
      cb_g[i] = static_cast<int32_t>(-fix(0.34414) * x + one_half);
    }
  }
};

const Tables kTables;

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// jidctint.c jpeg_idct_islow, 8-bit samples
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  constexpr int kConst = 13, kPass1 = 2;
  constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270, F0_899 = 7373,
                    F1_175 = 9633, F1_501 = 12299, F1_847 = 15137, F1_961 = 16069,
                    F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
  auto descale = [](int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; };
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 &&
        ip[48] == 0 && ip[56] == 0) {
      int dc = (ip[0] * qp[0]) * (1 << kPass1);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConst);
    int64_t tmp1 = (z2 - z3) * (1 << kConst);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConst - kPass1;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, s));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, s));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, s));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, s));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, s));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, s));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, s));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, s));
  }
  const uint8_t* lim = kTables.idct_limit;
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 &&
        wp[7] == 0) {
      uint8_t dc = lim[static_cast<int>(descale(wp[0], kPass1 + 3)) & 1023];
      std::memset(op, dc, 8);
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (1 << kConst);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (1 << kConst);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConst + kPass1 + 3;
    op[0] = lim[static_cast<int>(descale(tmp10 + tmp3, s)) & 1023];
    op[7] = lim[static_cast<int>(descale(tmp10 - tmp3, s)) & 1023];
    op[1] = lim[static_cast<int>(descale(tmp11 + tmp2, s)) & 1023];
    op[6] = lim[static_cast<int>(descale(tmp11 - tmp2, s)) & 1023];
    op[2] = lim[static_cast<int>(descale(tmp12 + tmp1, s)) & 1023];
    op[5] = lim[static_cast<int>(descale(tmp12 - tmp1, s)) & 1023];
    op[3] = lim[static_cast<int>(descale(tmp13 + tmp0, s)) & 1023];
    op[4] = lim[static_cast<int>(descale(tmp13 - tmp0, s)) & 1023];
  }
}

inline int u16be(const uint8_t* p) { return (p[0] << 8) | p[1]; }

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) : d_(data), n_(size) {}

  // Reads the markers up to the first SOS: the frame header, the tables,
  // the Exif orientation. Returns the output height and width.
  void header(int* out_h, int* out_w) {
    if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) corrupt("not a JPEG (no SOI)");
    pos_ = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xDA) break;
      if (m == 0xD9) corrupt("EOI before the first scan");
      segment(m);
    }
    if (!have_frame_) corrupt("no frame header before the first scan");
    bool swap = orientation_ >= 5;
    *out_h = swap ? width_ : height_;
    *out_w = swap ? height_ : width_;
  }

  void decode(uint8_t* out, int out_h, int out_w) {
    int h, w;
    header(&h, &w);
    if (h != out_h || w != out_w) corrupt("output shape does not match the header");
    allocate();
    for (;;) {
      scan();  // pos_ is after the SOS marker
      int m;
      for (;;) {
        m = next_marker();
        if (m == 0xDA || m == 0xD9) break;
        segment(m);
      }
      if (m == 0xD9) break;
    }
    if (progressive_) check_no_smoothing();
    for (int c = 0; c < ncomp_; ++c) reconstruct(comp_[c]);
    convert(out);
  }

 private:
  const uint8_t* d_;
  size_t n_, pos_ = 0;
  bool have_frame_ = false, progressive_ = false;
  int height_ = 0, width_ = 0, ncomp_ = 0, max_h_ = 1, max_v_ = 1;
  int mcux_ = 0, mcuy_ = 0;
  int restart_interval_ = 0, orientation_ = 1;
  bool saw_jfif_ = false, saw_adobe_ = false, saw_exif_ = false;
  int adobe_transform_ = -1;
  uint16_t qt_[4][64] = {};
  bool qt_defined_[4] = {};
  Huffman dc_[4], ac_[4];
  Component comp_[3];

  // The next marker code at pos_, after any fill bytes; bytes that are not
  // a marker are skipped as libjpeg skips them (with a warning).
  int next_marker() {
    for (;;) {
      while (pos_ < n_ && d_[pos_] != 0xFF) ++pos_;
      while (pos_ < n_ && d_[pos_] == 0xFF) ++pos_;
      if (pos_ >= n_) corrupt("data ends before EOI (truncated)");
      int m = d_[pos_++];
      if (m != 0x00) return m;
    }
  }

  const uint8_t* segment_body(int* len) {
    if (pos_ + 2 > n_) corrupt("truncated marker segment");
    int l = u16be(d_ + pos_);
    if (l < 2 || pos_ + l > n_) corrupt("bad marker segment length");
    *len = l - 2;
    const uint8_t* body = d_ + pos_ + 2;
    pos_ += l;
    return body;
  }

  void segment(int m) {
    if (m == 0xD8) corrupt("a second SOI");
    if (m >= 0xD0 && m <= 0xD7) return;  // a stray RSTn, no length
    if (m == 0x01) return;
    int len;
    const uint8_t* b = segment_body(&len);
    switch (m) {
      case 0xC0: case 0xC1: case 0xC2: frame(m, b, len); return;
      case 0xC3: unsupported("lossless JPEG (SOF3)");
      case 0xC5: case 0xC6: case 0xC7: unsupported("hierarchical JPEG (SOF5-7)");
      case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        unsupported("arithmetic-coded JPEG (SOF9-15)");
      case 0xCC: unsupported("arithmetic-coded JPEG (DAC)");
      case 0xC4: huffman_tables(b, len); return;
      case 0xDB: quant_tables(b, len); return;
      case 0xDD:
        if (len < 2) corrupt("bad DRI");
        restart_interval_ = u16be(b);
        return;
      case 0xDC: unsupported("JPEG with a DNL marker");
      case 0xE0:
        if (len >= 5 && std::memcmp(b, "JFIF\0", 5) == 0) saw_jfif_ = true;
        return;
      case 0xE1:
        if (!saw_exif_ && len >= 6 && std::memcmp(b, "Exif\0\0", 6) == 0) {
          saw_exif_ = true;
          exif(b + 6, len - 6);
        }
        return;
      case 0xEE:
        if (len >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
          saw_adobe_ = true;
          adobe_transform_ = b[11];
        }
        return;
      default: return;  // APPn, COM, JPGn: skipped
    }
  }

  void frame(int m, const uint8_t* b, int len) {
    if (have_frame_) corrupt("a second frame header");
    if (len < 6) corrupt("bad SOF");
    int precision = b[0];
    if (precision != 8) unsupported(std::to_string(precision) + "-bit JPEG");
    height_ = u16be(b + 1);
    width_ = u16be(b + 3);
    ncomp_ = b[5];
    if (height_ == 0) unsupported("JPEG with a DNL height");
    if (width_ == 0) corrupt("zero width");
    if (ncomp_ != 1 && ncomp_ != 3) {
      unsupported(std::to_string(ncomp_) + "-component JPEG" +
                  (ncomp_ == 4 ? " (CMYK / YCCK)" : ""));
    }
    if (static_cast<int64_t>(height_) * width_ > (int64_t(1) << 30))
      unsupported("more than 2^30 pixels");
    if (len < 6 + 3 * ncomp_) corrupt("bad SOF");
    progressive_ = m == 0xC2;
    for (int c = 0; c < ncomp_; ++c) {
      Component& k = comp_[c];
      k.id = b[6 + 3 * c];
      k.h = b[7 + 3 * c] >> 4;
      k.v = b[7 + 3 * c] & 15;
      k.tq = b[8 + 3 * c];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3) corrupt("bad component");
      max_h_ = std::max(max_h_, k.h);
      max_v_ = std::max(max_v_, k.v);
    }
    if (ncomp_ == 3) {
      bool rgb = false;
      if (!saw_jfif_ && saw_adobe_) rgb = adobe_transform_ == 0;
      else if (!saw_jfif_) rgb = comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66;
      if (rgb) unsupported("RGB-coded 3-component JPEG");
      if (comp_[0].h != max_h_ || comp_[0].v != max_v_) unsupported("sampling layout");
      for (int c = 1; c < 3; ++c) {
        int rh = max_h_ / comp_[c].h, rv = max_v_ / comp_[c].v;
        bool ok = max_h_ % comp_[c].h == 0 && max_v_ % comp_[c].v == 0 && rh <= 2 && rv <= 2;
        if (!ok) unsupported("sampling layout");
      }
    }
    mcux_ = (width_ + 8 * max_h_ - 1) / (8 * max_h_);
    mcuy_ = (height_ + 8 * max_v_ - 1) / (8 * max_v_);
    for (int c = 0; c < ncomp_; ++c) {
      Component& k = comp_[c];
      k.dw = static_cast<int>((static_cast<int64_t>(width_) * k.h + max_h_ - 1) / max_h_);
      k.dh = static_cast<int>((static_cast<int64_t>(height_) * k.v + max_v_ - 1) / max_v_);
      k.bw = mcux_ * k.h;
      k.bh = mcuy_ * k.v;
      for (int i = 0; i < 64; ++i) k.coef_bits[i] = -1;
    }
    have_frame_ = true;
  }

  void huffman_tables(const uint8_t* b, int len) {
    int p = 0;
    while (p < len) {
      if (p + 17 > len) corrupt("bad DHT");
      int tc = b[p] >> 4, th = b[p] & 15;
      if (tc > 1 || th > 3) corrupt("bad DHT table id");
      uint8_t counts[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; ++l) total += counts[l] = b[p + l];
      p += 17;
      if (total > 256 || p + total > len) corrupt("bad DHT");
      (tc ? ac_ : dc_)[th].build(counts, b + p, total);
      p += total;
    }
  }

  void quant_tables(const uint8_t* b, int len) {
    int p = 0;
    while (p < len) {
      int pq = b[p] >> 4, tq = b[p] & 15;
      if (pq > 1 || tq > 3) corrupt("bad DQT");
      int need = 1 + 64 * (pq + 1);
      if (p + need > len) corrupt("bad DQT");
      for (int i = 0; i < 64; ++i) {
        int v = pq ? u16be(b + p + 1 + 2 * i) : b[p + 1 + i];
        qt_[tq][kNatural[i]] = static_cast<uint16_t>(v);
      }
      qt_defined_[tq] = true;
      p += need;
    }
  }

  // The Exif APP1's TIFF header: tag 0x0112 of IFD0.
  void exif(const uint8_t* t, int len) {
    if (len < 8) return;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return;
    auto u16 = [&](int o) { return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1]; };
    auto u32 = [&](int o) {
      return le ? uint32_t(t[o]) | uint32_t(t[o + 1]) << 8 | uint32_t(t[o + 2]) << 16 |
                      uint32_t(t[o + 3]) << 24
                : uint32_t(t[o]) << 24 | uint32_t(t[o + 1]) << 16 | uint32_t(t[o + 2]) << 8 |
                      uint32_t(t[o + 3]);
    };
    if (u16(2) != 0x2A) return;
    uint32_t ifd = u32(4);
    if (ifd + 2 > static_cast<uint32_t>(len)) return;
    int count = u16(static_cast<int>(ifd));
    for (int i = 0; i < count; ++i) {
      uint32_t e = ifd + 2 + 12 * i;
      if (e + 12 > static_cast<uint32_t>(len)) return;
      if (u16(static_cast<int>(e)) == 0x0112) {
        int o = u16(static_cast<int>(e) + 8);
        if (o >= 1 && o <= 8) orientation_ = o;
        return;
      }
    }
  }

  void allocate() {
    for (int c = 0; c < ncomp_; ++c) {
      Component& k = comp_[c];
      k.coef.assign(static_cast<size_t>(k.bw) * k.bh * 64, 0);
    }
  }

  void scan() {
    int len;
    const uint8_t* b = segment_body(&len);
    if (len < 1) corrupt("bad SOS");
    int ns = b[0];
    if (ns < 1 || ns > ncomp_ || len < 4 + 2 * ns) corrupt("bad SOS");
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      int id = b[1 + 2 * i];
      Component* k = nullptr;
      for (int c = 0; c < ncomp_; ++c)
        if (comp_[c].id == id) k = &comp_[c];
      if (k == nullptr) corrupt("scan names an unknown component");
      k->td = b[2 + 2 * i] >> 4;
      k->ta = b[2 + 2 * i] & 15;
      if (k->td > 3 || k->ta > 3) corrupt("bad table selector");
      sc[i] = k;
    }
    int ss = b[1 + 2 * ns], se = b[2 + 2 * ns];
    int ah = b[3 + 2 * ns] >> 4, al = b[3 + 2 * ns] & 15;
    if (progressive_) {
      bool bad = false;
      if (ss == 0) bad = se != 0;
      else bad = se < ss || se > 63 || ns != 1;
      if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
      if (bad) corrupt("bad progression parameters");
    } else {  // a sequential scan's Ss, Se, Ah, Al are ignored, as in libjpeg
      ss = 0;
      se = 63;
      ah = al = 0;
    }
    for (int i = 0; i < ns; ++i) {
      Component* k = sc[i];
      if (!k->quant_latched) {
        if (!qt_defined_[k->tq]) corrupt("quantization table not defined");
        std::memcpy(k->quant, qt_[k->tq], sizeof(k->quant));
        k->quant_latched = true;
      }
      for (int j = ss; j <= se; ++j) k->coef_bits[j] = al;
      bool need_dc = !progressive_ || (ss == 0 && ah == 0);
      bool need_ac = !progressive_ || ss > 0;
      if (need_dc && !dc_[k->td].defined) corrupt("Huffman table not defined");
      if (need_ac && !ac_[k->ta].defined) corrupt("Huffman table not defined");
      k->last_dc = 0;
    }
    BitReader br(d_, n_, pos_);
    int eobrun = 0;
    int restarts_to_go = restart_interval_, next_rst = 0;
    auto maybe_restart = [&]() {
      if (restart_interval_ == 0) return;
      if (restarts_to_go == 0) {
        br.restart(next_rst);
        next_rst = (next_rst + 1) & 7;
        for (int i = 0; i < ns; ++i) sc[i]->last_dc = 0;
        eobrun = 0;
        restarts_to_go = restart_interval_;
      }
      --restarts_to_go;
    };
    auto block = [&](Component* k, int by, int bx) {
      int16_t* blk = k->coef.data() + (static_cast<size_t>(by) * k->bw + bx) * 64;
      if (!progressive_) decode_sequential(br, *k, blk);
      else if (ss == 0 && ah == 0) dc_first(br, *k, blk, al);
      else if (ss == 0) { if (br.get(1)) blk[0] |= static_cast<int16_t>(1 << al); }
      else if (ah == 0) ac_first(br, *k, blk, ss, se, al, &eobrun);
      else ac_refine(br, *k, blk, ss, se, al, &eobrun);
    };
    if (ns == 1) {
      Component* k = sc[0];
      int wb = (k->dw + 7) / 8, hb = (k->dh + 7) / 8;
      for (int by = 0; by < hb; ++by)
        for (int bx = 0; bx < wb; ++bx) {
          maybe_restart();
          block(k, by, bx);
        }
    } else {
      for (int my = 0; my < mcuy_; ++my)
        for (int mx = 0; mx < mcux_; ++mx) {
          maybe_restart();
          for (int i = 0; i < ns; ++i) {
            Component* k = sc[i];
            for (int v = 0; v < k->v; ++v)
              for (int h = 0; h < k->h; ++h) block(k, my * k->v + v, mx * k->h + h);
          }
        }
    }
    pos_ = br.pos;
  }

  void decode_sequential(BitReader& br, Component& k, int16_t* blk) {
    int s = br.decode(dc_[k.td]);
    if (s > 15) corrupt("bad DC difference size");
    int diff = s ? extend(br.get(s), s) : 0;
    k.last_dc += diff;
    blk[0] = static_cast<int16_t>(k.last_dc);
    const Huffman& ac = ac_[k.ta];
    for (int i = 1; i < 64; ++i) {
      int rs = br.decode(ac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        i += r;
        blk[kNatural[i]] = static_cast<int16_t>(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
  }

  void dc_first(BitReader& br, Component& k, int16_t* blk, int al) {
    int s = br.decode(dc_[k.td]);
    if (s > 15) corrupt("bad DC difference size");
    int diff = s ? extend(br.get(s), s) : 0;
    k.last_dc += diff;
    blk[0] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(k.last_dc) << al));
  }

  void ac_first(BitReader& br, Component& k, int16_t* blk, int ss, int se, int al, int* eobrun) {
    if (*eobrun > 0) {
      --*eobrun;
      return;
    }
    const Huffman& ac = ac_[k.ta];
    for (int i = ss; i <= se; ++i) {
      int rs = br.decode(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        i += r;
        int v = extend(br.get(s), s);
        blk[kNatural[i]] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(v) << al));
      } else if (r == 15) {
        i += 15;
      } else {
        *eobrun = 1 << r;
        if (r) *eobrun += br.get(r);
        --*eobrun;
        break;
      }
    }
  }

  void ac_refine(BitReader& br, Component& k, int16_t* blk, int ss, int se, int al, int* eobrun) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int i = ss;
    if (*eobrun == 0) {
      const Huffman& ac = ac_[k.ta];
      for (; i <= se; ++i) {
        int rs = br.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;  // the size is 1 in a valid stream
        } else if (r != 15) {
          *eobrun = 1 << r;
          if (r) *eobrun += br.get(r);
          break;
        }
        do {
          int16_t* c = blk + kNatural[i];
          if (*c != 0) {
            if (br.get(1) && (*c & p1) == 0) *c = static_cast<int16_t>(*c + (*c >= 0 ? p1 : m1));
          } else if (--r < 0) {
            break;
          }
          ++i;
        } while (i <= se);
        if (s) blk[kNatural[i]] = static_cast<int16_t>(s);
      }
    }
    if (*eobrun > 0) {
      for (; i <= se; ++i) {
        int16_t* c = blk + kNatural[i];
        if (*c != 0 && br.get(1) && (*c & p1) == 0)
          *c = static_cast<int16_t>(*c + (*c >= 0 ? p1 : m1));
      }
      --*eobrun;
    }
  }

  // jdcoefct.c's smoothing_ok: libjpeg smooths a progressive image across
  // blocks while any of the first ten coefficients is short of precision.
  void check_no_smoothing() {
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    for (int c = 0; c < ncomp_; ++c) {
      const Component& k = comp_[c];
      if (!k.quant_latched) return;
      for (int i = 0; i < 10; ++i)
        if (k.quant[kPos[i]] == 0) return;
      if (k.coef_bits[0] < 0) return;
    }
    for (int c = 0; c < ncomp_; ++c)
      for (int i = 1; i < 10; ++i)
        if (comp_[c].coef_bits[i] != 0)
          unsupported("progressive JPEG with incomplete scans (block smoothing)");
  }

  void reconstruct(Component& k) {
    int stride = k.bw * 8;
    k.plane.assign(static_cast<size_t>(stride) * k.bh * 8, 0);
    int wb = std::min(k.bw, (k.dw + 7) / 8), hb = std::min(k.bh, (k.dh + 7) / 8);
    for (int by = 0; by < hb; ++by)
      for (int bx = 0; bx < wb; ++bx)
        idct_islow(k.coef.data() + (static_cast<size_t>(by) * k.bw + bx) * 64, k.quant,
                   k.plane.data() + static_cast<size_t>(by) * 8 * stride + bx * 8, stride);
    k.coef.clear();
    k.coef.shrink_to_fit();
  }

  // One output row of chroma component k (rows y of the image) in `row`,
  // jdsample.c's upsampling; the plane's rows past dh repeat its last row.
  void upsample_row(const Component& k, int y, uint8_t* row) const {
    const int rh = max_h_ / k.h, rv = max_v_ / k.v;
    const int stride = k.bw * 8, dw = k.dw;
    const uint8_t* plane = k.plane.data();
    if (rv == 1) {
      const uint8_t* in = plane + static_cast<size_t>(y) * stride;
      if (rh == 1) {
        std::memcpy(row, in, width_);
      } else if (dw > 2) {  // h2v1 fancy
        row[0] = in[0];
        row[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          int v = in[x] * 3;
          row[2 * x] = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
          row[2 * x + 1] = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
        }
        row[2 * dw - 2] = static_cast<uint8_t>((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
        row[2 * dw - 1] = in[dw - 1];
      } else {
        for (int x = 0; x < dw; ++x) row[2 * x] = row[2 * x + 1] = in[x];
      }
      return;
    }
    const int cy = y >> 1;
    const bool lower = y & 1;
    if (rh == 2 && dw <= 2) {  // h2v2 by replication
      const uint8_t* in = plane + static_cast<size_t>(cy) * stride;
      for (int x = 0; x < dw; ++x) row[2 * x] = row[2 * x + 1] = in[x];
      return;
    }
    const int ny = lower ? std::min(cy + 1, k.dh - 1) : std::max(cy - 1, 0);
    const uint8_t* in0 = plane + static_cast<size_t>(cy) * stride;
    const uint8_t* in1 = plane + static_cast<size_t>(ny) * stride;
    if (rh == 1) {  // h1v2 fancy
      const int bias = lower ? 2 : 1;
      for (int x = 0; x < dw; ++x) row[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
      return;
    }
    // h2v2 fancy
    int last = in0[0] * 3 + in1[0];
    int cur = last;
    int next = in0[1] * 3 + in1[1];
    row[0] = static_cast<uint8_t>((cur * 4 + 8) >> 4);
    row[1] = static_cast<uint8_t>((cur * 3 + next + 7) >> 4);
    last = cur;
    cur = next;
    for (int x = 1; x < dw - 1; ++x) {
      next = in0[x + 1] * 3 + in1[x + 1];
      row[2 * x] = static_cast<uint8_t>((cur * 3 + last + 8) >> 4);
      row[2 * x + 1] = static_cast<uint8_t>((cur * 3 + next + 7) >> 4);
      last = cur;
      cur = next;
    }
    row[2 * dw - 2] = static_cast<uint8_t>((cur * 3 + last + 8) >> 4);
    row[2 * dw - 1] = static_cast<uint8_t>((cur * 4 + 7) >> 4);
  }

  // Color conversion into BGR, then the Exif orientation (OpenCV's order:
  // transpose first for 5-8, then the flip).
  void convert(uint8_t* out) const {
    const int H = height_, W = width_;
    const bool swap = orientation_ >= 5;
    const int ow = swap ? H : W;
    bool flip_x = false, flip_y = false;
    switch (orientation_) {
      case 2: flip_x = true; break;
      case 3: flip_x = flip_y = true; break;
      case 4: flip_y = true; break;
      case 6: flip_x = true; break;
      case 7: flip_x = flip_y = true; break;
      case 8: flip_y = true; break;
      default: break;
    }
    const int oh = swap ? W : H;
    std::vector<uint8_t> cb(static_cast<size_t>(W) + 16), cr(static_cast<size_t>(W) + 16);
    std::vector<uint8_t> bgr(static_cast<size_t>(W) * 3);
    const Component& y0 = comp_[0];
    const int ystride = y0.bw * 8;
    for (int y = 0; y < H; ++y) {
      const uint8_t* yr = y0.plane.data() + static_cast<size_t>(y) * ystride;
      if (ncomp_ == 1) {
        for (int x = 0; x < W; ++x) bgr[3 * x] = bgr[3 * x + 1] = bgr[3 * x + 2] = yr[x];
      } else {
        upsample_row(comp_[1], y, cb.data());
        upsample_row(comp_[2], y, cr.data());
        for (int x = 0; x < W; ++x) {
          int Y = yr[x], b = cb[x], r = cr[x];
          bgr[3 * x + 2] = clamp255(Y + kTables.cr_r[r]);
          bgr[3 * x + 1] = clamp255(Y + ((kTables.cb_g[b] + kTables.cr_g[r]) >> 16));
          bgr[3 * x + 0] = clamp255(Y + kTables.cb_b[b]);
        }
      }
      // output position of source pixel (y, x): transpose, then flip
      for (int x = 0; x < W; ++x) {
        int oy = swap ? x : y, ox = swap ? y : x;
        if (flip_x) ox = ow - 1 - ox;
        if (flip_y) oy = oh - 1 - oy;
        uint8_t* o = out + (static_cast<size_t>(oy) * ow + ox) * 3;
        o[0] = bgr[3 * x];
        o[1] = bgr[3 * x + 1];
        o[2] = bgr[3 * x + 2];
      }
    }
  }
};

int finish(const Error& e, char* msg, int32_t msg_len) {
  if (msg && msg_len > 0) std::snprintf(msg, static_cast<size_t>(msg_len), "%s", e.message.c_str());
  return e.status;
}

template <typename F>
int guarded(char* msg, int32_t msg_len, F f) {
  try {
    f();
    return kOk;
  } catch (const Error& e) {
    return finish(e, msg, msg_len);
  } catch (const std::bad_alloc&) {
    return finish(Error{kUnsupported, "out of memory"}, msg, msg_len);
  } catch (...) {
    return finish(Error{kCorrupt, "unexpected error"}, msg, msg_len);
  }
}

}  // namespace

extern "C" {

// Output height and width (after the Exif orientation) into hw[0], hw[1].
int llvod_jpeg_header(const uint8_t* data, int64_t size, int32_t* hw, char* msg, int32_t msg_len) {
  return guarded(msg, msg_len, [&] {
    Decoder dec(data, static_cast<size_t>(size));
    int h, w;
    dec.header(&h, &w);
    hw[0] = h;
    hw[1] = w;
  });
}

// Decodes into out, BGR uint8 [h, w, 3] as llvod_jpeg_header gave them.
int llvod_jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out, int32_t h, int32_t w,
                      char* msg, int32_t msg_len) {
  return guarded(msg, msg_len, [&] {
    Decoder dec(data, static_cast<size_t>(size));
    dec.decode(out, h, w);
  });
}

}  // extern "C"
