// JPEG decoder: baseline and extended Huffman (SOF0, SOF1) and progressive
// (SOF2) 8-bit JPEG with one or three components, written to give the
// pixels libjpeg-turbo gives with its default settings:
//
// - the islow integer IDCT (jidctint.c) and its post-IDCT range limit;
// - fancy (triangular) chroma upsampling for 2h1v, 1h2v and 2h2v
//   sampling (jdsample.c), box replication for other integral factors and
//   for 2h rows of at most two samples; the edge rows are repeated;
// - jdcolor.c's fixed-point YCbCr -> RGB tables; RGB when an Adobe marker
//   says so or the component ids spell "RGB" (jdapimin.c's guess);
// - Huffman tables 0 and 1 default to Annex K's where a stream defines
//   none (Motion-JPEG frames; libjpeg-turbo's std_huff_tables).
//
// EXIF orientation is not applied.  Arithmetic coding, 12-bit samples,
// lossless and hierarchical frames, and 2- or 4-component images raise.
// A stream that ends before its EOI marker raises.  Progressive images are
// decoded once all scans are in, without libjpeg's block smoothing (which
// only acts where a scan script leaves a low coefficient unrefined).
//
// C interface (every call is reentrant: no static mutable state):
//   gfnerf_jpeg_info(data, n, out3, err, errlen): width, height, channels
//   gfnerf_jpeg_decode(data, n, out, out_size, err, errlen): (H, W[, 3])
// both return 0, or 1 with a message in err.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <stdexcept>
#include <string>
#include <vector>

#include "jpeg_tables.h"

namespace gfjpeg {
namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};
[[noreturn]] void fail(const std::string& msg) { throw Error(msg); }

const char* const kTruncated =
    "truncated JPEG: the data ends before the EOI marker";

// A Huffman table in libjpeg's derived form (jdhuff.c): codes of up to 9
// bits through a lookup, longer ones by maxcode/valoffset per length.
constexpr int kLookBits = 9;
struct HuffTable {
  bool defined = false;
  uint8_t look_len[1 << kLookBits];
  uint8_t look_val[1 << kLookBits];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

void build_huff(HuffTable* t, const uint8_t bits[17], const uint8_t* vals,
                int nvals) {
  uint8_t size[257];
  uint32_t code[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < bits[l]; ++i) size[p++] = uint8_t(l);
  size[p] = 0;
  if (p != nvals) fail("corrupt JPEG: bad Huffman table");
  uint32_t c = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1u << si)) fail("corrupt JPEG: bad Huffman table");
    c <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l]) {
      t->valoffset[l] = p - int32_t(code[p]);
      p += bits[l];
      t->maxcode[l] = int32_t(code[p - 1]);
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0xFFFFF;
  std::memset(t->vals, 0, sizeof(t->vals));
  std::memcpy(t->vals, vals, size_t(nvals));
  std::memset(t->look_len, 0, sizeof(t->look_len));
  std::memset(t->look_val, 0, sizeof(t->look_val));
  p = 0;
  for (int l = 1; l <= kLookBits; ++l) {
    for (int i = 0; i < bits[l]; ++i, ++p) {
      int look = int(code[p]) << (kLookBits - l);
      for (int k = 1 << (kLookBits - l); k > 0; --k, ++look) {
        t->look_len[look] = uint8_t(l);
        t->look_val[look] = vals[p];
      }
    }
  }
  t->defined = true;
}

// Entropy-coded data, most significant bit first.  0xFF00 is a 0xFF data
// byte and fill bytes 0xFF are skipped; at a marker or at the end of the
// data the reader supplies zero bits (libjpeg's fill_bit_buffer) and keeps
// the marker for the caller.
struct BitReader {
  const uint8_t* data;
  size_t n;
  size_t pos;
  uint64_t acc = 0;
  int cnt = 0;
  int marker = 0;
  bool at_end = false;

  BitReader(const uint8_t* d, size_t len, size_t start)
      : data(d), n(len), pos(start) {}

  void fill() {
    while (cnt <= 56) {
      uint64_t b = 0;
      if (!marker && !at_end) {
        if (pos >= n) {
          at_end = true;
        } else {
          b = data[pos++];
          if (b == 0xFF) {
            size_t q = pos;
            while (q < n && data[q] == 0xFF) ++q;
            if (q >= n) {
              at_end = true;
              b = 0;
              pos = q;
            } else if (data[q] == 0) {
              pos = q + 1;
            } else {
              marker = data[q];
              pos = q + 1;
              b = 0;
            }
          }
        }
      }
      acc |= b << (56 - cnt);
      cnt += 8;
    }
  }
  inline uint32_t peek(int k) {
    if (cnt < k) fill();
    return uint32_t(acc >> (64 - k));
  }
  inline void skip(int k) {
    acc <<= k;
    cnt -= k;
  }
  inline int get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return int(v);
  }
  inline int decode(const HuffTable& t) {
    if (cnt < 32) fill();
    uint32_t look = uint32_t(acc >> (64 - kLookBits));
    int len = t.look_len[look];
    if (len) {
      skip(len);
      return t.look_val[look];
    }
    for (int l = kLookBits + 1; l <= 16; ++l) {
      int32_t code = int32_t(acc >> (64 - l));
      if (code <= t.maxcode[l]) {
        skip(l);
        return t.vals[(t.valoffset[l] + code) & 0xFF];
      }
    }
    skip(17);  // a code longer than 16 bits: libjpeg warns and reads 0
    return 0;
  }
  void reset() {
    acc = 0;
    cnt = 0;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + int((~0u) << s) + 1 : v;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int width = 0, height = 0;  // samples of the component
  int bw = 0, bh = 0;         // coefficient blocks across and down
  bool latched = false;
  int32_t quant[64];          // natural order, latched at the first scan
  int coef_bits[64];          // progressive: the last scan's Al, -1 before
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
  std::vector<uint8_t> plane; // (bh * 8) rows of (bw * 8) samples
  int dc_tbl = 0, ac_tbl = 0;
  int last_dc = 0;
};

inline uint8_t idct_limit(int64_t x) {
  int idx = int(x & 1023);
  if (idx < 128) return uint8_t(idx + 128);
  if (idx < 512) return 255;
  if (idx < 896) return 0;
  return uint8_t(idx - 896);
}

// jidctint.c's jpeg_idct_islow: dequantize, columns then rows
void idct_islow(const int16_t* in, const int32_t* q, uint8_t* out,
                size_t stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const int32_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int dc = int(int64_t(ip[0]) * qp[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(ip[16]) * qp[16];
    int64_t z3 = int64_t(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(ip[0]) * qp[0];
    z3 = int64_t(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(ip[56]) * qp[56];
    tmp1 = int64_t(ip[40]) * qp[40];
    tmp2 = int64_t(ip[24]) * qp[24];
    tmp3 = int64_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = int(descale(tmp10 + tmp3, sh));
    wp[56] = int(descale(tmp10 - tmp3, sh));
    wp[8] = int(descale(tmp11 + tmp2, sh));
    wp[48] = int(descale(tmp11 - tmp2, sh));
    wp[16] = int(descale(tmp12 + tmp1, sh));
    wp[40] = int(descale(tmp12 - tmp1, sh));
    wp[24] = int(descale(tmp13 + tmp0, sh));
    wp[32] = int(descale(tmp13 - tmp0, sh));
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = idct_limit(descale(tmp10 + tmp3, sh));
    op[7] = idct_limit(descale(tmp10 - tmp3, sh));
    op[1] = idct_limit(descale(tmp11 + tmp2, sh));
    op[6] = idct_limit(descale(tmp11 - tmp2, sh));
    op[2] = idct_limit(descale(tmp12 + tmp1, sh));
    op[5] = idct_limit(descale(tmp12 - tmp1, sh));
    op[3] = idct_limit(descale(tmp13 + tmp0, sh));
    op[4] = idct_limit(descale(tmp13 - tmp0, sh));
  }
}

inline uint8_t clamp255(int x) {
  return uint8_t(x < 0 ? 0 : (x > 255 ? 255 : x));
}

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t n) : data_(data), n_(n) {
    build_huff(&dc_[0], kDcLumaBits, kDcLumaVals, 12);
    build_huff(&dc_[1], kDcChromaBits, kDcChromaVals, 12);
    build_huff(&ac_[0], kAcLumaBits, kAcLumaVals, 162);
    build_huff(&ac_[1], kAcChromaBits, kAcChromaVals, 162);
  }

  // read up to the frame header (headers_only) or decode the whole file
  void run(bool headers_only) {
    if (n_ < 2 || data_[0] != 0xFF || data_[1] != 0xD8)
      fail("not a JPEG: no SOI marker");
    pos_ = 2;
    int pending = 0;
    for (;;) {
      int m = pending ? pending : next_marker();
      pending = 0;
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        parse_sof(m);
        if (headers_only) return;
      } else if (m == 0xC3) {
        fail("lossless JPEG (SOF3) is not supported");
      } else if (m == 0xC5 || m == 0xC6 || m == 0xC7) {
        fail("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) +
             ") is not supported");
      } else if (m == 0xCC || (m >= 0xC9 && m <= 0xCF && m != 0xCC)) {
        fail("arithmetic coding (" +
             (m == 0xCC ? std::string("DAC")
                        : "SOF" + std::to_string(m - 0xC0)) +
             ") is not supported");
      } else if (m == 0xC4) {
        parse_dht();
      } else if (m == 0xDB) {
        parse_dqt();
      } else if (m == 0xDD) {
        size_t start, len;
        segment(&start, &len);
        if (len < 2) fail("corrupt JPEG: bad DRI segment");
        restart_interval_ = (data_[start] << 8) | data_[start + 1];
      } else if (m == 0xDA) {
        if (!frame_) fail("corrupt JPEG: a scan before the frame header");
        if (headers_only) return;
        pending = decode_scan();
      } else if (m == 0xD9) {
        if (!frame_) fail("corrupt JPEG: EOI before the frame header");
        if (headers_only) return;
        if (scans_ == 0) fail("corrupt JPEG: no scan before EOI");
        return;
      } else if (m == 0xDC) {
        fail("DNL markers (height given after the scan) are not supported");
      } else if (m == 0xD8) {
        fail("corrupt JPEG: a second SOI marker");
      } else if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) {
        // TEM and stray RSTn stand alone
      } else {
        size_t start, len;
        segment(&start, &len);
        if (m == 0xE0 && len >= 14 && std::memcmp(data_ + start, "JFIF\0", 5)
                                          == 0)
          jfif_ = true;
        if (m == 0xEE && len >= 12 &&
            std::memcmp(data_ + start, "Adobe", 5) == 0) {
          adobe_ = true;
          adobe_transform_ = data_[start + 11];
        }
      }
    }
  }

  int width() const { return width_; }
  int height() const { return height_; }
  int channels() const { return ncomp_ == 1 ? 1 : 3; }

  // IDCT, upsample, colour-convert into out: (H, W) or (H, W, 3)
  void output(uint8_t* out) {
    for (int c = 0; c < ncomp_; ++c) {
      Component& comp = comps_[c];
      size_t stride = size_t(comp.bw) * 8;
      comp.plane.assign(stride * size_t(comp.bh) * 8, 0);
      for (int by = 0; by < comp.bh; ++by)
        for (int bx = 0; bx < comp.bw; ++bx)
          idct_islow(&comp.coef[(size_t(by) * comp.bw + bx) * 64],
                     comp.quant,
                     &comp.plane[size_t(by) * 8 * stride + size_t(bx) * 8],
                     stride);
      std::vector<int16_t>().swap(comp.coef);
    }
    const size_t W = size_t(width_);
    if (ncomp_ == 1) {
      const Component& comp = comps_[0];
      for (int y = 0; y < height_; ++y)
        std::memcpy(out + size_t(y) * W,
                    &comp.plane[size_t(y) * size_t(comp.bw) * 8], W);
      return;
    }
    std::vector<uint8_t> rows[3];
    for (int c = 0; c < 3; ++c) rows[c].assign(W + 32, 0);
    bool rgb = colour_rgb();
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = int((fix16(1.40200) * x + kOneHalf) >> kScaleBits);
      cb_b[i] = int((fix16(1.77200) * x + kOneHalf) >> kScaleBits);
      cr_g[i] = -fix16(0.71414) * x;
      cb_g[i] = -fix16(0.34414) * x + kOneHalf;
    }
    for (int y = 0; y < height_; ++y) {
      const uint8_t* src[3];
      for (int c = 0; c < 3; ++c) src[c] = upsample_row(c, y, &rows[c]);
      uint8_t* op = out + size_t(y) * W * 3;
      if (rgb) {
        for (size_t x = 0; x < W; ++x) {
          op[3 * x] = src[0][x];
          op[3 * x + 1] = src[1][x];
          op[3 * x + 2] = src[2][x];
        }
        continue;
      }
      for (size_t x = 0; x < W; ++x) {
        int yy = src[0][x], cb = src[1][x], cr = src[2][x];
        op[3 * x] = clamp255(yy + cr_r[cr]);
        op[3 * x + 1] =
            clamp255(yy + int((cb_g[cb] + cr_g[cr]) >> kScaleBits));
        op[3 * x + 2] = clamp255(yy + cb_b[cb]);
      }
    }
  }

 private:
  const uint8_t* data_;
  size_t n_;
  size_t pos_ = 0;
  bool frame_ = false, progressive_ = false;
  int width_ = 0, height_ = 0, ncomp_ = 0, maxh_ = 1, maxv_ = 1;
  int mcux_ = 0, mcuy_ = 0;
  Component comps_[3];
  int32_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  HuffTable dc_[4], ac_[4];
  int restart_interval_ = 0;
  int scans_ = 0;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = 0;
  int colour_ = -1;  // latched at the first scan: 1 RGB, 0 YCbCr

  int next_marker() {
    for (;;) {
      while (pos_ < n_ && data_[pos_] != 0xFF) ++pos_;
      while (pos_ < n_ && data_[pos_] == 0xFF) ++pos_;
      if (pos_ >= n_) fail(kTruncated);
      int m = data_[pos_++];
      if (m != 0) return m;
    }
  }

  // the payload of a marker segment: [start, start + len)
  void segment(size_t* start, size_t* len) {
    if (pos_ + 2 > n_) fail(kTruncated);
    size_t l = (size_t(data_[pos_]) << 8) | data_[pos_ + 1];
    if (l < 2) fail("corrupt JPEG: a segment shorter than its length field");
    if (pos_ + l > n_) fail(kTruncated);
    *start = pos_ + 2;
    *len = l - 2;
    pos_ += l;
  }

  bool colour_rgb() const {
    if (colour_ >= 0) return colour_ == 1;
    if (jfif_) return false;
    if (adobe_) return adobe_transform_ == 0;
    return comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66;
  }

  void parse_sof(int m) {
    if (frame_) fail("corrupt JPEG: more than one frame header");
    size_t s, len;
    segment(&s, &len);
    if (len < 6) fail("corrupt JPEG: bad SOF segment");
    int precision = data_[s];
    height_ = (data_[s + 1] << 8) | data_[s + 2];
    width_ = (data_[s + 3] << 8) | data_[s + 4];
    ncomp_ = data_[s + 5];
    if (precision != 8)
      fail(std::to_string(precision) +
           "-bit samples are not supported (12-bit JPEG): 8-bit only");
    if (height_ == 0)
      fail("DNL markers (height given after the scan) are not supported");
    if (width_ == 0) fail("corrupt JPEG: width 0");
    if (ncomp_ == 4) fail("4-component JPEG (CMYK/YCCK) is not supported");
    if (ncomp_ != 1 && ncomp_ != 3)
      fail(std::to_string(ncomp_) + "-component JPEG is not supported");
    if (len != size_t(6 + 3 * ncomp_))
      fail("corrupt JPEG: bad SOF segment length");
    maxh_ = maxv_ = 1;
    for (int c = 0; c < ncomp_; ++c) {
      Component& comp = comps_[c];
      comp.id = data_[s + 6 + 3 * c];
      comp.h = data_[s + 7 + 3 * c] >> 4;
      comp.v = data_[s + 7 + 3 * c] & 15;
      comp.tq = data_[s + 8 + 3 * c];
      if (comp.h < 1 || comp.h > 4 || comp.v < 1 || comp.v > 4)
        fail("corrupt JPEG: bad sampling factors");
      if (comp.tq > 3) fail("corrupt JPEG: bad quantization table index");
      maxh_ = std::max(maxh_, comp.h);
      maxv_ = std::max(maxv_, comp.v);
    }
    mcux_ = (width_ + 8 * maxh_ - 1) / (8 * maxh_);
    mcuy_ = (height_ + 8 * maxv_ - 1) / (8 * maxv_);
    for (int c = 0; c < ncomp_; ++c) {
      Component& comp = comps_[c];
      if (maxh_ % comp.h || maxv_ % comp.v)
        fail("fractional chroma sampling is not supported");
      comp.width = int((int64_t(width_) * comp.h + maxh_ - 1) / maxh_);
      comp.height = int((int64_t(height_) * comp.v + maxv_ - 1) / maxv_);
      comp.bw = mcux_ * comp.h;
      comp.bh = mcuy_ * comp.v;
      comp.coef.assign(size_t(comp.bw) * size_t(comp.bh) * 64, 0);
      std::fill(comp.coef_bits, comp.coef_bits + 64, -1);
    }
    progressive_ = m == 0xC2;
    frame_ = true;
  }

  void parse_dht() {
    size_t s, len;
    segment(&s, &len);
    size_t p = s, end = s + len;
    while (p < end) {
      if (p + 17 > end) fail("corrupt JPEG: bad DHT segment");
      int tc = data_[p] >> 4, th = data_[p] & 15;
      if (tc > 1 || th > 3) fail("corrupt JPEG: bad Huffman table index");
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int l = 1; l <= 16; ++l) {
        bits[l] = data_[p + l];
        count += bits[l];
      }
      if (count > 256 || p + 17 + size_t(count) > end)
        fail("corrupt JPEG: bad DHT segment");
      const uint8_t* vals = data_ + p + 17;
      if (tc == 0)
        for (int i = 0; i < count; ++i)
          if (vals[i] > 15) fail("corrupt JPEG: bad Huffman table");
      build_huff(tc == 0 ? &dc_[th] : &ac_[th], bits, vals, count);
      p += 17 + size_t(count);
    }
  }

  void parse_dqt() {
    size_t s, len;
    segment(&s, &len);
    size_t p = s, end = s + len;
    while (p < end) {
      int pq = data_[p] >> 4, tq = data_[p] & 15;
      if (tq > 3 || pq > 1) fail("corrupt JPEG: bad DQT segment");
      size_t need = 1 + 64 * size_t(pq + 1);
      if (p + need > end) fail("corrupt JPEG: bad DQT segment");
      for (int i = 0; i < 64; ++i)
        qt_[tq][kNaturalOrder[i]] =
            pq ? (data_[p + 1 + 2 * i] << 8) | data_[p + 2 + 2 * i]
               : data_[p + 1 + i];
      qt_defined_[tq] = true;
      p += need;
    }
  }

  // one scan; returns the marker that ended it, or 0 if none was met
  int decode_scan() {
    size_t s, len;
    segment(&s, &len);
    if (len < 1) fail("corrupt JPEG: bad SOS segment");
    int ns = data_[s];
    if (ns < 1 || ns > ncomp_ || len != size_t(4 + 2 * ns))
      fail("corrupt JPEG: bad SOS segment");
    int idx[4];
    for (int i = 0; i < ns; ++i) {
      int cid = data_[s + 1 + 2 * i];
      int k = -1;
      for (int c = 0; c < ncomp_; ++c)
        if (comps_[c].id == cid) k = c;
      if (k < 0) fail("corrupt JPEG: a scan names an unknown component");
      idx[i] = k;
      comps_[k].dc_tbl = data_[s + 2 + 2 * i] >> 4;
      comps_[k].ac_tbl = data_[s + 2 + 2 * i] & 15;
      if (comps_[k].dc_tbl > 3 || comps_[k].ac_tbl > 3)
        fail("corrupt JPEG: bad Huffman table index");
    }
    int ss = data_[s + 1 + 2 * ns], se = data_[s + 2 + 2 * ns];
    int ah = data_[s + 3 + 2 * ns] >> 4, al = data_[s + 3 + 2 * ns] & 15;
    if (colour_ < 0 && ncomp_ == 3) colour_ = colour_rgb() ? 1 : 0;
    if (progressive_) {
      bool bad = false;
      if (ss == 0) {
        if (se != 0) bad = true;
      } else {
        if (se < ss || se > 63 || ns != 1) bad = true;
      }
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail("corrupt JPEG: bad progressive scan parameters");
      for (int i = 0; i < ns; ++i)
        for (int k = ss; k <= se; ++k) comps_[idx[i]].coef_bits[k] = al;
    }
    if (ns > 1) {
      int blocks = 0;
      for (int i = 0; i < ns; ++i)
        blocks += comps_[idx[i]].h * comps_[idx[i]].v;
      if (blocks > 10) fail("corrupt JPEG: more than 10 blocks an MCU");
    }
    for (int i = 0; i < ns; ++i) {
      Component& comp = comps_[idx[i]];
      if (!comp.latched) {
        if (!qt_defined_[comp.tq])
          fail("corrupt JPEG: a quantization table used before its DQT");
        std::copy(qt_[comp.tq], qt_[comp.tq] + 64, comp.quant);
        comp.latched = true;
      }
      bool need_dc = !progressive_ || (ss == 0 && ah == 0);
      bool need_ac = !progressive_ || ss > 0;
      if ((need_dc && !dc_[comp.dc_tbl].defined) ||
          (need_ac && !ac_[comp.ac_tbl].defined))
        fail("corrupt JPEG: a Huffman table used before its DHT");
      comp.last_dc = 0;
    }
    ++scans_;

    BitReader br(data_, n_, pos_);
    int eobrun = 0;
    int mode = !progressive_ ? 0
               : ss == 0     ? (ah == 0 ? 1 : 2)
                             : (ah == 0 ? 3 : 4);
    auto block = [&](Component& comp, int16_t* blk) {
      switch (mode) {
        case 0: decode_sequential(&br, comp, blk); break;
        case 1: {
          int t = br.decode(dc_[comp.dc_tbl]);
          int diff = t ? extend(br.get(t), t) : 0;
          comp.last_dc = int(unsigned(comp.last_dc) + unsigned(diff));
          blk[0] = int16_t(unsigned(comp.last_dc) << al);
          break;
        }
        case 2:
          if (br.get(1)) blk[0] = int16_t(blk[0] | (1 << al));
          break;
        case 3: decode_ac_first(&br, comp, blk, ss, se, al, &eobrun); break;
        default: decode_ac_refine(&br, comp, blk, ss, se, al, &eobrun);
      }
    };
    int rst_next = 0;
    int64_t mcus;
    int nbx = 0;
    if (ns == 1) {
      Component& comp = comps_[idx[0]];
      nbx = (comp.width + 7) / 8;
      mcus = int64_t(nbx) * ((comp.height + 7) / 8);
    } else {
      mcus = int64_t(mcux_) * mcuy_;
    }
    for (int64_t k = 0; k < mcus; ++k) {
      if (restart_interval_ && k > 0 && k % restart_interval_ == 0) {
        br.reset();
        if (!br.marker) {
          pos_ = br.pos;
          br.marker = next_marker();
        }
        if (br.marker != 0xD0 + rst_next)
          fail("corrupt JPEG: expected restart marker RST" +
               std::to_string(rst_next));
        rst_next = (rst_next + 1) & 7;
        br.marker = 0;
        br.at_end = false;
        for (int i = 0; i < ns; ++i) comps_[idx[i]].last_dc = 0;
        eobrun = 0;
      }
      if (ns == 1) {
        Component& comp = comps_[idx[0]];
        int64_t by = k / nbx, bx = k % nbx;
        block(comp, &comp.coef[(size_t(by) * comp.bw + size_t(bx)) * 64]);
      } else {
        int64_t my = k / mcux_, mx = k % mcux_;
        for (int i = 0; i < ns; ++i) {
          Component& comp = comps_[idx[i]];
          for (int yy = 0; yy < comp.v; ++yy)
            for (int xx = 0; xx < comp.h; ++xx) {
              size_t by = size_t(my) * comp.v + yy;
              size_t bx = size_t(mx) * comp.h + xx;
              block(comp, &comp.coef[(by * comp.bw + bx) * 64]);
            }
        }
      }
    }
    pos_ = br.pos;
    if (br.at_end && !br.marker) fail(kTruncated);
    return br.marker;
  }

  void decode_sequential(BitReader* br, Component& comp, int16_t* blk) {
    const HuffTable& dct = dc_[comp.dc_tbl];
    const HuffTable& act = ac_[comp.ac_tbl];
    int t = br->decode(dct);
    int diff = t ? extend(br->get(t), t) : 0;
    comp.last_dc = int(unsigned(comp.last_dc) + unsigned(diff));
    blk[0] = int16_t(comp.last_dc);
    for (int k = 1; k < 64; ++k) {
      int rs = br->decode(act);
      int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        blk[kNaturalOrder[k]] = int16_t(extend(br->get(sz), sz));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void decode_ac_first(BitReader* br, Component& comp, int16_t* blk, int ss,
                       int se, int al, int* eobrun) {
    if (*eobrun > 0) {
      --*eobrun;
      return;
    }
    const HuffTable& act = ac_[comp.ac_tbl];
    for (int k = ss; k <= se; ++k) {
      int rs = br->decode(act);
      int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        int v = extend(br->get(sz), sz);
        blk[kNaturalOrder[k]] = int16_t(unsigned(v) << al);
      } else {
        if (r == 15) {
          k += 15;
        } else {
          *eobrun = 1 << r;
          if (r) *eobrun += br->get(r);
          --*eobrun;
          break;
        }
      }
    }
  }

  // T.81 G.1.2.3, as jdphuff.c's decode_mcu_AC_refine
  void decode_ac_refine(BitReader* br, Component& comp, int16_t* blk,
                        int ss, int se, int al, int* eobrun) {
    const int p1 = 1 << al;
    const int m1 = int(~0u << al);
    const HuffTable& act = ac_[comp.ac_tbl];
    int k = ss;
    if (*eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = br->decode(act);
        int r = rs >> 4, sz = rs & 15;
        int val = 0;
        if (sz) {
          val = br->get(1) ? p1 : m1;
        } else if (r != 15) {
          *eobrun = 1 << r;
          if (r) *eobrun += br->get(r);
          break;
        }
        do {
          int16_t* c = blk + kNaturalOrder[k];
          if (*c != 0) {
            if (br->get(1) && (*c & p1) == 0)
              *c = int16_t(*c >= 0 ? *c + p1 : *c + m1);
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= se);
        if (val) blk[kNaturalOrder[k]] = int16_t(val);
      }
    }
    if (*eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* c = blk + kNaturalOrder[k];
        if (*c != 0 && br->get(1) && (*c & p1) == 0)
          *c = int16_t(*c >= 0 ? *c + p1 : *c + m1);
      }
      --*eobrun;
    }
  }

  // row y of component c at full size (jdsample.c's methods)
  const uint8_t* upsample_row(int c, int y, std::vector<uint8_t>* buf) {
    const Component& comp = comps_[c];
    const size_t stride = size_t(comp.bw) * 8;
    const int fh = maxh_ / comp.h, fv = maxv_ / comp.v;
    const int dw = comp.width;
    auto row = [&](int r) { return &comp.plane[size_t(r) * stride]; };
    uint8_t* out = buf->data();
    if (fh == 1 && fv == 1) return row(y);
    if (fh == 1 && fv == 2) {
      int k = y >> 1;
      const uint8_t* near = row(k);
      bool lower = y & 1;
      const uint8_t* far =
          row(lower ? std::min(k + 1, comp.height - 1) : std::max(k - 1, 0));
      int bias = lower ? 2 : 1;
      for (int x = 0; x < dw; ++x) out[x] = uint8_t((near[x] * 3 + far[x] + bias) >> 2);
      return out;
    }
    if (fh == 2 && fv == 1) {
      const uint8_t* in = row(y);
      if (dw <= 2) {
        for (int x = 0; x < dw; ++x) out[2 * x] = out[2 * x + 1] = in[x];
        return out;
      }
      out[0] = in[0];
      out[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; ++x) {
        int v = in[x] * 3;
        out[2 * x] = uint8_t((v + in[x - 1] + 1) >> 2);
        out[2 * x + 1] = uint8_t((v + in[x + 1] + 2) >> 2);
      }
      out[2 * dw - 2] = uint8_t((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
      out[2 * dw - 1] = in[dw - 1];
      return out;
    }
    if (fh == 2 && fv == 2 && dw > 2) {
      int k = y >> 1;
      const uint8_t* in0 = row(k);
      const uint8_t* in1 = row((y & 1) ? std::min(k + 1, comp.height - 1)
                                       : std::max(k - 1, 0));
      int last = in0[0] * 3 + in1[0];
      int cur = last;
      int next = in0[1] * 3 + in1[1];
      out[0] = uint8_t((cur * 4 + 8) >> 4);
      out[1] = uint8_t((cur * 3 + next + 7) >> 4);
      last = cur;
      cur = next;
      for (int x = 1; x < dw - 1; ++x) {
        next = in0[x + 1] * 3 + in1[x + 1];
        out[2 * x] = uint8_t((cur * 3 + last + 8) >> 4);
        out[2 * x + 1] = uint8_t((cur * 3 + next + 7) >> 4);
        last = cur;
        cur = next;
      }
      out[2 * dw - 2] = uint8_t((cur * 3 + last + 8) >> 4);
      out[2 * dw - 1] = uint8_t((cur * 4 + 7) >> 4);
      return out;
    }
    // box replication by any integral factors
    const uint8_t* in = row(y / fv);
    for (int x = 0; x < dw; ++x)
      for (int j = 0; j < fh; ++j) out[size_t(x) * fh + j] = in[x];
    return out;
  }
};

void set_error(char* err, int64_t errlen, const char* msg) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", msg);
}

}  // namespace
}  // namespace gfjpeg

extern "C" {

int gfnerf_jpeg_info(const uint8_t* data, int64_t n, int32_t* out3,
                     char* err, int64_t errlen) {
  try {
    gfjpeg::Decoder dec(data, size_t(n));
    dec.run(true);
    out3[0] = dec.width();
    out3[1] = dec.height();
    out3[2] = dec.channels();
    return 0;
  } catch (const std::bad_alloc&) {
    gfjpeg::set_error(err, errlen, "out of memory");
  } catch (const std::exception& e) {
    gfjpeg::set_error(err, errlen, e.what());
  }
  return 1;
}

int gfnerf_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out,
                       int64_t out_size, char* err, int64_t errlen) {
  try {
    gfjpeg::Decoder dec(data, size_t(n));
    dec.run(false);
    int64_t need = int64_t(dec.width()) * dec.height() * dec.channels();
    if (need != out_size)
      throw gfjpeg::Error("output buffer of " + std::to_string(out_size) +
                          " bytes for an image of " + std::to_string(need));
    dec.output(out);
    return 0;
  } catch (const std::bad_alloc&) {
    gfjpeg::set_error(err, errlen, "out of memory");
  } catch (const std::exception& e) {
    gfjpeg::set_error(err, errlen, e.what());
  }
  return 1;
}

}  // extern "C"
