// Baseline JPEG encoder: 8-bit grey or RGB, JFIF, chroma at 4:4:4 or
// 4:2:0, the islow forward DCT (jfdctint.c), T.81 Annex K's quantisation
// tables scaled by the IJG quality formula, and Annex K's Huffman tables.
//
// - RGB -> YCbCr with jccolor.c's fixed-point tables;
// - the image is padded to whole MCUs by repeating its last column and
//   row; 4:2:0 chroma is the 2x2 box average with jcsample.c's
//   alternating 1, 2 rounding bias;
// - a coefficient is DCT / (8 q) rounded half away from zero.
//
// C interface (reentrant: no static mutable state):
//   gfnerf_jpeg_encode_bound(w, h, channels, subsample420): bytes enough
//   gfnerf_jpeg_encode(px, w, h, channels, quality, subsample420, out, cap,
//                      err, errlen): the file's length, or -1 with a
//                      message in err.

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

struct HuffCodes {
  uint32_t code[256];
  uint8_t size[256];
};

void build_codes(HuffCodes* t, const uint8_t bits[17], const uint8_t* vals) {
  std::memset(t->size, 0, sizeof(t->size));
  std::memset(t->code, 0, sizeof(t->code));
  uint32_t c = 0;
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l]; ++i, ++p) {
      t->code[vals[p]] = c++;
      t->size[vals[p]] = uint8_t(l);
    }
    c <<= 1;
  }
}

// quality 1-100 -> the table in natural order (jcparam.c)
void scale_quant(const uint8_t base[64], int quality, int out[64]) {
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long v = (long(base[i]) * scale + 50) / 100;
    out[i] = int(std::min(255L, std::max(1L, v)));
  }
}

class Writer {
 public:
  Writer(uint8_t* out, int64_t cap) : out_(out), cap_(cap) {}
  void byte(int b) {
    if (n_ >= cap_) fail("encoder output buffer too small");
    out_[n_++] = uint8_t(b);
  }
  void u16(int v) {
    byte(v >> 8);
    byte(v & 0xFF);
  }
  void bytes(const uint8_t* p, size_t k) {
    for (size_t i = 0; i < k; ++i) byte(p[i]);
  }
  // entropy-coded bits, MSB first, with 0xFF stuffed by 0x00
  void bits(uint32_t v, int k) {
    acc_ = (acc_ << k) | (v & ((1u << k) - 1));
    cnt_ += k;
    while (cnt_ >= 8) {
      int b = int((acc_ >> (cnt_ - 8)) & 0xFF);
      byte(b);
      if (b == 0xFF) byte(0);
      cnt_ -= 8;
    }
  }
  void flush_bits() {
    if (cnt_ > 0) bits(0x7F, 8 - cnt_);  // pad with 1 bits
  }
  int64_t size() const { return n_; }

 private:
  uint8_t* out_;
  int64_t cap_;
  int64_t n_ = 0;
  uint64_t acc_ = 0;
  int cnt_ = 0;
};

// jfdctint.c's jpeg_fdct_islow on samples - 128; out scaled up by 8
void fdct_islow(int32_t d[64]) {
  for (int r = 0; r < 8; ++r) {
    int32_t* p = d + 8 * r;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int32_t((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = int32_t((tmp10 - tmp11) * (1 << kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int sh = kConstBits - kPass1Bits;
    p[2] = int32_t(descale(z1 + tmp13 * FIX_0_765366865, sh));
    p[6] = int32_t(descale(z1 + tmp12 * -FIX_1_847759065, sh));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = int32_t(descale(tmp4 + z1 + z3, sh));
    p[5] = int32_t(descale(tmp5 + z2 + z4, sh));
    p[3] = int32_t(descale(tmp6 + z2 + z3, sh));
    p[1] = int32_t(descale(tmp7 + z1 + z4, sh));
  }
  for (int c = 0; c < 8; ++c) {
    int32_t* p = d + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int32_t(descale(tmp10 + tmp11, kPass1Bits));
    p[32] = int32_t(descale(tmp10 - tmp11, kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int sh = kConstBits + kPass1Bits;
    p[16] = int32_t(descale(z1 + tmp13 * FIX_0_765366865, sh));
    p[48] = int32_t(descale(z1 + tmp12 * -FIX_1_847759065, sh));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = int32_t(descale(tmp4 + z1 + z3, sh));
    p[40] = int32_t(descale(tmp5 + z2 + z4, sh));
    p[24] = int32_t(descale(tmp6 + z2 + z3, sh));
    p[8] = int32_t(descale(tmp7 + z1 + z4, sh));
  }
}

struct Plane {
  int w = 0, h = 0;  // padded to whole blocks
  std::vector<uint8_t> px;
};

int nbits_of(int v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

class Encoder {
 public:
  Encoder(const uint8_t* px, int w, int h, int channels, int quality,
          bool s420)
      : px_(px), w_(w), h_(h), nc_(channels), s420_(s420 && channels == 3) {
    scale_quant(kLumaQuant, quality, q_[0]);
    scale_quant(kChromaQuant, quality, q_[1]);
    build_codes(&dc_[0], kDcLumaBits, kDcLumaVals);
    build_codes(&dc_[1], kDcChromaBits, kDcChromaVals);
    build_codes(&ac_[0], kAcLumaBits, kAcLumaVals);
    build_codes(&ac_[1], kAcChromaBits, kAcChromaVals);
  }

  int64_t encode(uint8_t* out, int64_t cap) {
    make_planes();
    Writer wr(out, cap);
    headers(&wr);
    const int mcu = s420_ ? 16 : 8;
    const int mx = (w_ + mcu - 1) / mcu, my = (h_ + mcu - 1) / mcu;
    int last_dc[3] = {0, 0, 0};
    int32_t blk[64];
    for (int j = 0; j < my; ++j) {
      for (int i = 0; i < mx; ++i) {
        if (s420_) {
          for (int yy = 0; yy < 2; ++yy)
            for (int xx = 0; xx < 2; ++xx)
              block(&wr, planes_[0], (2 * i + xx) * 8, (2 * j + yy) * 8, 0,
                    blk, &last_dc[0]);
          block(&wr, planes_[1], i * 8, j * 8, 1, blk, &last_dc[1]);
          block(&wr, planes_[2], i * 8, j * 8, 1, blk, &last_dc[2]);
        } else {
          for (int c = 0; c < nc_; ++c)
            block(&wr, planes_[c], i * 8, j * 8, c ? 1 : 0, blk,
                  &last_dc[c]);
        }
      }
    }
    wr.flush_bits();
    wr.u16(0xFFD9);
    return wr.size();
  }

 private:
  const uint8_t* px_;
  int w_, h_, nc_;
  bool s420_;
  int q_[2][64];
  HuffCodes dc_[2], ac_[2];
  Plane planes_[3];

  // colour-converted planes, padded by repeating the last column and row
  void make_planes() {
    const int mcu = s420_ ? 16 : 8;
    const int pw = (w_ + mcu - 1) / mcu * mcu, ph = (h_ + mcu - 1) / mcu * mcu;
    for (int c = 0; c < nc_; ++c) {
      planes_[c].w = pw;
      planes_[c].h = ph;
      planes_[c].px.assign(size_t(pw) * ph, 0);
    }
    int64_t tab[8][256];
    for (int i = 0; i < 256; ++i) {
      tab[0][i] = fix16(0.29900) * i;
      tab[1][i] = fix16(0.58700) * i;
      tab[2][i] = fix16(0.11400) * i + kOneHalf;
      tab[3][i] = -fix16(0.16874) * i;
      tab[4][i] = -fix16(0.33126) * i;
      tab[5][i] = fix16(0.50000) * i + (int64_t(128) << kScaleBits) +
                  kOneHalf - 1;
      tab[6][i] = -fix16(0.41869) * i;
      tab[7][i] = -fix16(0.08131) * i;
    }
    for (int y = 0; y < ph; ++y) {
      const uint8_t* row = px_ + size_t(std::min(y, h_ - 1)) * w_ * nc_;
      for (int x = 0; x < pw; ++x) {
        const uint8_t* p = row + size_t(std::min(x, w_ - 1)) * nc_;
        size_t o = size_t(y) * pw + x;
        if (nc_ == 1) {
          planes_[0].px[o] = p[0];
          continue;
        }
        int r = p[0], g = p[1], b = p[2];
        planes_[0].px[o] = uint8_t((tab[0][r] + tab[1][g] + tab[2][b]) >>
                                   kScaleBits);
        planes_[1].px[o] = uint8_t((tab[3][r] + tab[4][g] + tab[5][b]) >>
                                   kScaleBits);
        planes_[2].px[o] = uint8_t((tab[5][r] + tab[6][g] + tab[7][b]) >>
                                   kScaleBits);
      }
    }
    if (!s420_) return;
    for (int c = 1; c < 3; ++c) {
      Plane half;
      half.w = pw / 2;
      half.h = ph / 2;
      half.px.assign(size_t(half.w) * half.h, 0);
      const std::vector<uint8_t>& f = planes_[c].px;
      for (int y = 0; y < half.h; ++y) {
        int bias = 1;
        const uint8_t* r0 = &f[size_t(2 * y) * pw];
        const uint8_t* r1 = r0 + pw;
        for (int x = 0; x < half.w; ++x) {
          half.px[size_t(y) * half.w + x] = uint8_t(
              (r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >>
              2);
          bias ^= 3;
        }
      }
      planes_[c] = std::move(half);
    }
  }

  void headers(Writer* wr) {
    static constexpr uint8_t kJfif[] = {'J', 'F', 'I', 'F', 0, 1, 1, 0,
                                        0,   1,   0,   1,   0, 0};
    wr->u16(0xFFD8);
    wr->u16(0xFFE0);
    wr->u16(2 + sizeof(kJfif));
    wr->bytes(kJfif, sizeof(kJfif));
    const int nq = nc_ == 1 ? 1 : 2;
    wr->u16(0xFFDB);
    wr->u16(2 + 65 * nq);
    for (int t = 0; t < nq; ++t) {
      wr->byte(t);
      for (int i = 0; i < 64; ++i) wr->byte(q_[t][kNaturalOrder[i]]);
    }
    wr->u16(0xFFC0);
    wr->u16(8 + 3 * nc_);
    wr->byte(8);
    wr->u16(h_);
    wr->u16(w_);
    wr->byte(nc_);
    for (int c = 0; c < nc_; ++c) {
      wr->byte(c + 1);
      wr->byte(c == 0 && s420_ ? 0x22 : 0x11);
      wr->byte(c ? 1 : 0);
    }
    const uint8_t* bits[4] = {kDcLumaBits, kAcLumaBits, kDcChromaBits,
                              kAcChromaBits};
    const uint8_t* vals[4] = {kDcLumaVals, kAcLumaVals, kDcChromaVals,
                              kAcChromaVals};
    const int cls[4] = {0x00, 0x10, 0x01, 0x11};
    const int nt = nc_ == 1 ? 2 : 4;
    int len = 2;
    for (int t = 0; t < nt; ++t) {
      int count = 0;
      for (int l = 1; l <= 16; ++l) count += bits[t][l];
      len += 17 + count;
    }
    wr->u16(0xFFC4);
    wr->u16(len);
    for (int t = 0; t < nt; ++t) {
      wr->byte(cls[t]);
      int count = 0;
      for (int l = 1; l <= 16; ++l) {
        wr->byte(bits[t][l]);
        count += bits[t][l];
      }
      wr->bytes(vals[t], size_t(count));
    }
    wr->u16(0xFFDA);
    wr->u16(6 + 2 * nc_);
    wr->byte(nc_);
    for (int c = 0; c < nc_; ++c) {
      wr->byte(c + 1);
      wr->byte(c ? 0x11 : 0x00);
    }
    wr->byte(0);
    wr->byte(63);
    wr->byte(0);
  }

  void block(Writer* wr, const Plane& p, int x0, int y0, int t,
             int32_t* blk, int* last_dc) {
    for (int r = 0; r < 8; ++r) {
      const uint8_t* src = &p.px[size_t(y0 + r) * p.w + x0];
      for (int c = 0; c < 8; ++c) blk[8 * r + c] = int32_t(src[c]) - 128;
    }
    fdct_islow(blk);
    int zz[64];
    for (int k = 0; k < 64; ++k) {
      int n = kNaturalOrder[k];
      int d = q_[t][n] << 3;
      int v = blk[n];
      zz[k] = v < 0 ? -((-v + (d >> 1)) / d) : (v + (d >> 1)) / d;
    }
    int diff = zz[0] - *last_dc;
    *last_dc = zz[0];
    int mag = diff < 0 ? -diff : diff;
    int nb = nbits_of(mag);
    wr->bits(dc_[t].code[nb], dc_[t].size[nb]);
    if (nb) wr->bits(uint32_t(diff < 0 ? diff - 1 : diff), nb);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int v = zz[k];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        wr->bits(ac_[t].code[0xF0], ac_[t].size[0xF0]);
        run -= 16;
      }
      mag = v < 0 ? -v : v;
      nb = nbits_of(mag);
      int sym = (run << 4) + nb;
      wr->bits(ac_[t].code[sym], ac_[t].size[sym]);
      wr->bits(uint32_t(v < 0 ? v - 1 : v), nb);
      run = 0;
    }
    if (run > 0) wr->bits(ac_[t].code[0], ac_[t].size[0]);
  }
};

void set_error(char* err, int64_t errlen, const char* msg) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", msg);
}

}  // namespace
}  // namespace gfjpeg

extern "C" {

int64_t gfnerf_jpeg_encode_bound(int32_t w, int32_t h, int32_t channels,
                                 int32_t subsample420) {
  const int mcu = subsample420 && channels == 3 ? 16 : 8;
  int64_t pw = (int64_t(w) + mcu - 1) / mcu * mcu;
  int64_t ph = (int64_t(h) + mcu - 1) / mcu * mcu;
  int64_t blocks = pw * ph / 64 * (channels == 1 ? 1 : 3);
  // at most 16 + 10 bits for each of 64 coefficients, doubled by stuffing
  return 1024 + blocks * 420;
}

int64_t gfnerf_jpeg_encode(const uint8_t* px, int32_t w, int32_t h,
                           int32_t channels, int32_t quality,
                           int32_t subsample420, uint8_t* out, int64_t cap,
                           char* err, int64_t errlen) {
  try {
    if (w < 1 || h < 1 || w > 65535 || h > 65535)
      throw gfjpeg::Error("JPEG sizes are 1 to 65535 pixels a side");
    if (channels != 1 && channels != 3)
      throw gfjpeg::Error("1 (grey) or 3 (RGB) channels expected");
    if (quality < 1 || quality > 100)
      throw gfjpeg::Error("quality must be 1-100");
    gfjpeg::Encoder enc(px, w, h, channels, quality, subsample420 != 0);
    return enc.encode(out, cap);
  } catch (const std::bad_alloc&) {
    gfjpeg::set_error(err, errlen, "out of memory");
  } catch (const std::exception& e) {
    gfjpeg::set_error(err, errlen, e.what());
  }
  return -1;
}

}  // extern "C"
