// Baseline JPEG decoder with a plain C interface (loaded through ctypes).
//
// Decodes what libjpeg-turbo, and so Pillow's `np.asarray(Image.open(f))`,
// returns for the same file, equal in every bit: 8-bit sequential
// Huffman-coded frames (SOF0, SOF1), one component (gray) or three
// (YCbCr), sampling factors up to 2 x 2, restart intervals, sizes that are
// not a multiple of the MCU, interleaved and non-interleaved scans. It
// follows libjpeg's defaults:
//   - the ISLOW integer IDCT (jidctint.c) and its post-IDCT range limit;
//   - "fancy" triangle upsampling for h2v1, h1v2 and h2v2 (jdsample.c),
//     edges replicated as jdmainct.c's context rows do, box upsampling
//     where libjpeg takes it (a subsampled width of at most two samples,
//     other integral factors);
//   - the fixed-point YCbCr->RGB tables of jdcolor.c.
// Everything else is refused with a message that names it: progressive
// (SOF2), lossless, hierarchical and arithmetic-coded frames, 12-bit
// samples, CMYK/YCCK (four components), RGB stored without a transform
// (an Adobe marker with transform 0, or R/G/B component ids), DNL.
//
// Interface:
//   int gmf_jpeg_info(data, len, int dims[3], err, errlen)
//     -> 0, dims = {height, width, channels (1 or 3)}
//   int gmf_jpeg_decode(data, len, out, outlen, err, errlen)
//     -> 0, out = uint8 [height, width(, 3)] row-major
// Both return -1 and write a message into err on failure.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct JpegError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError(msg); }

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valptr[17] = {};
  int32_t mincode[17] = {};
  uint16_t look[1 << kLookBits] = {};  // (length << 8) | symbol, 0 = longer

  void build(const uint8_t counts[16], const uint8_t* symbols, int n) {
    std::memcpy(vals, symbols, n);
    // Annex C: code lengths and codes in order
    uint16_t codes[256];
    uint8_t sizes[256];
    int k = 0;
    for (int len = 1; len <= 16; len++)
      for (int i = 0; i < counts[len - 1]; i++) sizes[k++] = (uint8_t)len;
    uint32_t code = 0;
    int si = n ? sizes[0] : 0;
    for (int p = 0; p < n;) {
      while (p < n && sizes[p] == si) {
        codes[p++] = (uint16_t)code;
        code++;
      }
      if (code >= (1u << si)) fail("bad Huffman table (code overflow)");
      code <<= 1;
      si++;
    }
    // F.2.2.3's decoding tables
    int p = 0;
    for (int len = 1; len <= 16; len++) {
      if (counts[len - 1]) {
        valptr[len] = p;
        mincode[len] = codes[p];
        p += counts[len - 1];
        maxcode[len] = codes[p - 1];
      } else {
        maxcode[len] = -1;
      }
    }
    maxcode[17] = 0x7fffffff;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int len = 1; len <= kLookBits; len++)
      for (int i = 0; i < counts[len - 1]; i++, p++) {
        int base = codes[p] << (kLookBits - len);
        for (int j = 0; j < (1 << (kLookBits - len)); j++)
          look[base + j] = (uint16_t)((len << 8) | vals[p]);
      }
    defined = true;
  }
};

// The entropy-coded bit stream: bytes with 0xFF00 unstuffed; at a marker
// it supplies zero bits, and consuming one of them is an error.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int n = 0;         // bits held in acc (the low n bits)
  int fake = 0;      // of these, the low `fake` bits are zero fill
  int marker = 0;    // the marker that stopped the stream, 0 if none yet

  BitReader(const uint8_t* p_, const uint8_t* end_) : p(p_), end(end_) {}

  void fill() {
    while (n <= 56) {
      int c = 0;
      bool real = false;
      if (!marker && p < end) {
        c = *p++;
        real = true;
        if (c == 0xFF) {
          int c2 = -1;
          while (p < end) {
            c2 = *p++;
            if (c2 != 0xFF) break;
          }
          if (c2 == 0) {
            c = 0xFF;
          } else {
            marker = c2 < 0 ? 0xD9 : c2;  // a stream cut short reads as EOI
            c = 0;
            real = false;
          }
        }
      } else if (!marker) {
        marker = 0xD9;
      }
      acc = (acc << 8) | (uint64_t)c;
      n += 8;
      if (!real) fake += 8;  // zero fill follows only a marker
    }
  }
  int peek(int k) {
    if (n < k) fill();
    return (int)((acc >> (n - k)) & ((1u << k) - 1));
  }
  void skip(int k) {
    n -= k;
    if (n < fake) fail("truncated or corrupt entropy-coded data");
  }
  int get(int k) {
    if (k == 0) return 0;
    int v = peek(k);
    skip(k);
    return v;
  }
  int decode(const Huffman& h) {
    int look = h.look[peek(kLookBits)];
    if (look) {
      skip(look >> 8);
      return look & 0xFF;
    }
    int code = peek(kLookBits);
    int len = kLookBits;
    skip(kLookBits);
    while (code > h.maxcode[len]) {
      code = (code << 1) | get(1);
      if (++len > 16) fail("corrupt Huffman code in the entropy-coded data");
    }
    return h.vals[h.valptr[len] + code - h.mincode[len]];
  }
  static int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }
  // restart: drop the bits left of this interval and read RSTn
  void restart(int expected) {
    if (!marker) {
      // the padding bits and the marker are still ahead
      while (p < end) {
        int c = *p++;
        if (c != 0xFF) continue;
        while (p < end && *p == 0xFF) p++;
        if (p >= end) break;
        int c2 = *p++;
        if (c2 != 0) {
          marker = c2;
          break;
        }
      }
    }
    if (marker != 0xD0 + expected)
      fail("restart marker RST" + std::to_string(expected) +
           " missing in the entropy-coded data");
    acc = 0;
    n = fake = 0;
    marker = 0;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int dw = 0, dh = 0;  // downsampled (component) width and height
  int bw = 0, bh = 0;  // blocks across and down, padded to whole MCUs
  std::vector<int16_t> coef;  // [bh * bw][64], natural order
};

struct Decoder {
  const uint8_t* data;
  size_t len;
  size_t pos = 0;
  uint16_t qt[4][64] = {};  // natural order
  bool qt_defined[4] = {};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  int height = 0, width = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  Component comp[4];
  bool scanned = false;

  Decoder(const uint8_t* d, size_t l) : data(d), len(l) {}

  int byte() {
    if (pos >= len) fail("truncated file (unexpected end of data)");
    return data[pos++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  // the next marker code, skipping fill bytes (and, as libjpeg does with a
  // warning, any garbage before it)
  int next_marker() {
    for (;;) {
      int c = byte();
      if (c != 0xFF) continue;
      do c = byte(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  void parse_header(bool stop_at_frame) {
    if (len < 2 || data[0] != 0xFF || data[1] != 0xD8)
      fail("not a JPEG file (no SOI marker)");
    pos = 2;
    int m = next_marker();
    for (;;) {
      if (m == 0xD9) {
        if (!scanned) fail("EOI before any scan");
        return;
      }
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        read_frame(m);
        if (stop_at_frame) return;
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xCC) {
        fail("arithmetic coding (DAC marker) is not supported");
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        int l = word();
        if (l != 4) fail("bad DRI marker length");
        restart_interval = word();
      } else if (m == 0xDA) {
        if (!frame) fail("SOS before any SOF marker");
        m = read_scan();
        scanned = true;
        continue;
      } else if (m == 0xDC) {
        fail("DNL marker (height defined after the scan) is not supported");
      } else if (m >= 0xD0 && m <= 0xD7) {
        // a stray restart marker outside a scan: libjpeg ignores it
      } else if (m == 0xE0 || m == 0xEE) {
        read_app(m);
      } else if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0x01 ||
                 (m >= 0xF0 && m <= 0xFD)) {
        skip_segment();
      } else {
        char buf[64];
        std::snprintf(buf, sizeof(buf), "unknown marker 0xFF%02X", m);
        fail(buf);
      }
      m = next_marker();
    }
  }

  void skip_segment() {
    int l = word();
    if (l < 2 || pos + (l - 2) > len) fail("bad marker segment length");
    pos += l - 2;
  }

  void read_app(int m) {
    int l = word();
    if (l < 2 || pos + (l - 2) > len) fail("bad APP marker length");
    const uint8_t* s = data + pos;
    int n = l - 2;
    if (m == 0xE0 && n >= 5 && std::memcmp(s, "JFIF\0", 5) == 0) jfif = true;
    if (m == 0xEE && n >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = s[11];
    }
    pos += n;
  }

  void read_dqt() {
    int l = word() - 2;
    while (l > 0) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) fail("bad DQT table id");
      if (pq > 1) fail("bad DQT precision");
      for (int k = 0; k < 64; k++)
        qt[tq][kZigzag[k]] = (uint16_t)(pq ? word() : byte());
      qt_defined[tq] = true;
      l -= 1 + 64 * (pq ? 2 : 1);
    }
    if (l != 0) fail("bad DQT marker length");
  }

  void read_dht() {
    int l = word() - 2;
    while (l > 0) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad DHT table class or id");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; i++) {
        counts[i] = (uint8_t)byte();
        total += counts[i];
      }
      if (total > 256) fail("bad DHT table (more than 256 symbols)");
      uint8_t sym[256];
      for (int i = 0; i < total; i++) sym[i] = (uint8_t)byte();
      (tc ? ac[th] : dc[th]).build(counts, sym, total);
      l -= 17 + total;
    }
    if (l != 0) fail("bad DHT marker length");
  }

  void read_frame(int m) {
    if (frame) fail("more than one SOF marker");
    switch (m) {
      case 0xC0:
      case 0xC1:
        break;
      case 0xC2:
        fail("progressive JPEG (SOF2) is not supported");
      case 0xC3:
        fail("lossless JPEG (SOF3) is not supported");
      case 0xC5:
      case 0xC6:
      case 0xC7:
        fail("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) +
             ") is not supported");
      default:
        fail("arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) +
             ") is not supported");
    }
    int l = word();
    int precision = byte();
    if (precision != 8)
      fail(std::to_string(precision) +
           "-bit samples are not supported (8-bit only)");
    height = word();
    width = word();
    ncomp = byte();
    if (height == 0) fail("DNL marker (height defined after the scan) is not supported");
    if (width == 0) fail("zero image width");
    if (ncomp == 4) fail("CMYK/YCCK JPEG (four components) is not supported");
    if (ncomp != 1 && ncomp != 3)
      fail(std::to_string(ncomp) + "-component JPEG is not supported");
    if (l != 8 + 3 * ncomp) fail("bad SOF marker length");
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2)
        fail("sampling factors " + std::to_string(c.h) + "x" +
             std::to_string(c.v) + " are not supported (at most 2x2)");
      if (c.tq > 3) fail("bad quantization table id in SOF");
    }
    if (ncomp == 1) comp[0].h = comp[0].v = 1;  // one component: no MCU
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; i++) {
      hmax = std::max(hmax, comp[i].h);
      vmax = std::max(vmax, comp[i].v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v)
        fail("non-integral sampling ratios are not supported");
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
    frame = true;
  }

  void decode_block(BitReader& br, Component& c, int bx, int by, int& pred) {
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int16_t* blk = &c.coef[((size_t)by * c.bw + bx) * 64];
    int s = br.decode(hd);
    if (s > 16) fail("corrupt DC coefficient");
    int diff = s ? BitReader::extend(br.get(s), s) : 0;
    pred += diff;
    blk[0] = (int16_t)pred;
    for (int k = 1; k < 64; k++) {
      int rs = br.decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt AC coefficient run");
        blk[kZigzag[k]] = (int16_t)BitReader::extend(br.get(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // returns the marker that ends the scan
  int read_scan() {
    int l = word();
    int ns = byte();
    if (ns < 1 || ns > ncomp || l != 6 + 2 * ns) fail("bad SOS marker");
    Component* sc[4];
    for (int i = 0; i < ns; i++) {
      int cid = byte();
      int t = byte();
      Component* found = nullptr;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == cid) found = &comp[j];
      if (!found) fail("SOS names a component the frame lacks");
      found->td = t >> 4;
      found->ta = t & 15;
      if (found->td > 3 || found->ta > 3) fail("bad Huffman table id in SOS");
      if (!dc[found->td].defined || !ac[found->ta].defined)
        fail("SOS uses an undefined Huffman table");
      if (!qt_defined[found->tq])
        fail("a component's quantization table is undefined");
      sc[i] = found;
    }
    int ss = byte(), se = byte(), ahal = byte();
    if (ss != 0 || se != 63 || ahal != 0)
      fail("spectral selection or successive approximation (progressive "
           "scan) is not supported");

    BitReader br(data + pos, data + len);
    int preds[4] = {0, 0, 0, 0};
    int restarts_seen = 0;
    auto maybe_restart = [&](long done, long total) {
      if (restart_interval && done % restart_interval == 0 && done < total) {
        br.restart(restarts_seen & 7);
        restarts_seen++;
        preds[0] = preds[1] = preds[2] = preds[3] = 0;
      }
    };
    if (ns == 1) {
      // non-interleaved: one block a MCU over the component's own extent
      Component& c = *sc[0];
      int bx_n = (c.dw + 7) / 8, by_n = (c.dh + 7) / 8;
      long total = (long)bx_n * by_n, done = 0;
      for (int by = 0; by < by_n; by++)
        for (int bx = 0; bx < bx_n; bx++) {
          decode_block(br, c, bx, by, preds[0]);
          maybe_restart(++done, total);
        }
    } else {
      long total = (long)mcux * mcuy, done = 0;
      for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
          for (int i = 0; i < ns; i++) {
            Component& c = *sc[i];
            for (int v = 0; v < c.v; v++)
              for (int h = 0; h < c.h; h++)
                decode_block(br, c, mx * c.h + h, my * c.v + v, preds[i]);
          }
          maybe_restart(++done, total);
        }
    }
    // resume the marker walk after the entropy-coded data
    pos = (size_t)(br.p - data);
    if (br.marker) return br.marker;
    return next_marker();
  }
};

// ---- jidctint.c: jpeg_idct_islow ------------------------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

// jdmaster.c's post-IDCT range limit: the output masked to 10 bits, read
// as a signed offset from 128 and clamped to [0, 255]
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; i++) {
      int x = i < 512 ? i : i - 1024;
      int v = x + 128;
      t[i] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int col = 0; col < 8; col++) {
    const int16_t* ip = in + col;
    const uint16_t* qp = q + col;
    int* wp = ws + col;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int dc = (int)((int64_t)ip[0] * qp[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; r++) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int64_t)ip[16] * qp[16];
    int64_t z3 = (int64_t)ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
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
    wp[0] = (int)descale(tmp10 + tmp3, sh);
    wp[56] = (int)descale(tmp10 - tmp3, sh);
    wp[8] = (int)descale(tmp11 + tmp2, sh);
    wp[48] = (int)descale(tmp11 - tmp2, sh);
    wp[16] = (int)descale(tmp12 + tmp1, sh);
    wp[40] = (int)descale(tmp12 - tmp1, sh);
    wp[24] = (int)descale(tmp13 + tmp0, sh);
    wp[32] = (int)descale(tmp13 - tmp0, sh);
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int row = 0; row < 8; row++) {
    const int* wp = ws + 8 * row;
    uint8_t* op = out + (size_t)row * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      uint8_t dc = kRange.t[(int)descale(wp[0], kPass1Bits + 3) & 1023];
      for (int c = 0; c < 8; c++) op[c] = dc;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << kConstBits);
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
    op[0] = kRange.t[(int)descale(tmp10 + tmp3, sh) & 1023];
    op[7] = kRange.t[(int)descale(tmp10 - tmp3, sh) & 1023];
    op[1] = kRange.t[(int)descale(tmp11 + tmp2, sh) & 1023];
    op[6] = kRange.t[(int)descale(tmp11 - tmp2, sh) & 1023];
    op[2] = kRange.t[(int)descale(tmp12 + tmp1, sh) & 1023];
    op[5] = kRange.t[(int)descale(tmp12 - tmp1, sh) & 1023];
    op[3] = kRange.t[(int)descale(tmp13 + tmp0, sh) & 1023];
    op[4] = kRange.t[(int)descale(tmp13 - tmp0, sh) & 1023];
  }
}

// one component's samples, [bh * 8][bw * 8]
std::vector<uint8_t> component_plane(const Decoder& d, const Component& c) {
  int stride = c.bw * 8;
  std::vector<uint8_t> plane((size_t)stride * c.bh * 8);
  const uint16_t* q = d.qt[c.tq];
  for (int by = 0; by < c.bh; by++)
    for (int bx = 0; bx < c.bw; bx++)
      idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], q,
                 &plane[(size_t)by * 8 * stride + bx * 8], stride);
  return plane;
}

// ---- jdsample.c: upsampling to [height][width] ----------------------------

std::vector<uint8_t> upsample(const Decoder& d, const Component& c,
                              const std::vector<uint8_t>& plane) {
  const int W = d.width, H = d.height;
  const int sx = d.hmax / c.h, sy = d.vmax / c.v;
  const int stride = c.bw * 8;
  const int dw = c.dw, dh = c.dh;
  std::vector<uint8_t> out((size_t)W * H);
  // jdmainct.c's context rows: above row 0 is row 0, below the last real
  // row is that row again
  auto row = [&](int y) {
    if (y < 0) y = 0;
    if (y > dh - 1) y = dh - 1;
    return &plane[(size_t)y * stride];
  };
  if (sx == 1 && sy == 1) {
    for (int y = 0; y < H; y++) std::memcpy(&out[(size_t)y * W], row(y), W);
    return out;
  }
  std::vector<uint8_t> line((size_t)2 * dw + 2);
  if (sx == 2 && sy == 1 && dw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < H; y++) {
      const uint8_t* in = row(y);
      uint8_t* o = line.data();
      int v = in[0];
      *o++ = (uint8_t)v;
      *o++ = (uint8_t)((v * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; x++) {
        v = in[x] * 3;
        *o++ = (uint8_t)((v + in[x - 1] + 1) >> 2);
        *o++ = (uint8_t)((v + in[x + 1] + 2) >> 2);
      }
      v = in[dw - 1];
      *o++ = (uint8_t)((v * 3 + in[dw - 2] + 1) >> 2);
      *o++ = (uint8_t)v;
      std::memcpy(&out[(size_t)y * W], line.data(), W);
    }
    return out;
  }
  if (sx == 1 && sy == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < H; y++) {
      int iy = y >> 1;
      const uint8_t* in0 = row(iy);
      const uint8_t* in1 = row((y & 1) ? iy + 1 : iy - 1);
      int bias = (y & 1) ? 2 : 1;
      uint8_t* o = &out[(size_t)y * W];
      for (int x = 0; x < W; x++) o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
    }
    return out;
  }
  if (sx == 2 && sy == 2 && dw > 2) {  // h2v2_fancy_upsample
    for (int y = 0; y < H; y++) {
      int iy = y >> 1;
      const uint8_t* in0 = row(iy);
      const uint8_t* in1 = row((y & 1) ? iy + 1 : iy - 1);
      uint8_t* o = line.data();
      int thiscol = in0[0] * 3 + in1[0];
      int nextcol = in0[1] * 3 + in1[1];
      *o++ = (uint8_t)((thiscol * 4 + 8) >> 4);
      *o++ = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
      int lastcol = thiscol;
      thiscol = nextcol;
      for (int x = 2; x < dw; x++) {
        nextcol = in0[x] * 3 + in1[x];
        *o++ = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
        *o++ = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
        lastcol = thiscol;
        thiscol = nextcol;
      }
      *o++ = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
      *o++ = (uint8_t)((thiscol * 4 + 7) >> 4);
      std::memcpy(&out[(size_t)y * W], line.data(), W);
    }
    return out;
  }
  // box upsampling (h2v1_upsample, h2v2_upsample, int_upsample)
  for (int y = 0; y < H; y++) {
    const uint8_t* in = row(y / sy);
    uint8_t* o = &out[(size_t)y * W];
    for (int x = 0; x < W; x++) o[x] = in[x / sx];
  }
  return out;
}

// ---- jdcolor.c: ycc_rgb_convert -------------------------------------------

struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int kScale = 16;
    const int64_t half = (int64_t)1 << (kScale - 1);
    auto fix = [&](double x) { return (int64_t)(x * (1L << kScale) + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (int)((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

void decode(const uint8_t* data, size_t len, uint8_t* out, size_t outlen,
            int dims[3]) {
  Decoder d(data, len);
  d.parse_header(out == nullptr);
  if (!d.frame) fail("no SOF marker");
  int channels = d.ncomp == 1 ? 1 : 3;
  dims[0] = d.height;
  dims[1] = d.width;
  dims[2] = channels;
  if (out == nullptr) return;
  if (d.ncomp == 3 && !d.jfif) {
    if (d.adobe && d.adobe_transform == 0)
      fail("Adobe transform 0 (RGB stored without a colour transform) is "
           "not supported");
    if (!d.adobe && d.comp[0].id == 'R' && d.comp[1].id == 'G' &&
        d.comp[2].id == 'B')
      fail("RGB component ids (no colour transform) are not supported");
  }
  size_t need = (size_t)d.height * d.width * channels;
  if (outlen < need) fail("output buffer too small");
  std::vector<uint8_t> planes[3];
  for (int i = 0; i < d.ncomp; i++)
    planes[i] = upsample(d, d.comp[i], component_plane(d, d.comp[i]));
  if (channels == 1) {
    std::memcpy(out, planes[0].data(), need);
    return;
  }
  const size_t n = (size_t)d.height * d.width;
  for (size_t i = 0; i < n; i++) {
    int y = planes[0][i], cb = planes[1][i], cr = planes[2][i];
    out[3 * i + 0] = clamp255(y + kYcc.cr_r[cr]);
    out[3 * i + 1] =
        clamp255(y + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
    out[3 * i + 2] = clamp255(y + kYcc.cb_b[cb]);
  }
}

int run(const uint8_t* data, size_t len, uint8_t* out, size_t outlen,
        int dims[3], char* err, int errlen) {
  try {
    decode(data, len, out, outlen, dims);
    return 0;
  } catch (const std::exception& e) {
    if (err && errlen > 0) std::snprintf(err, errlen, "%s", e.what());
    return -1;
  }
}

}  // namespace

extern "C" {

int gmf_jpeg_info(const uint8_t* data, size_t len, int* dims, char* err,
                  int errlen) {
  return run(data, len, nullptr, 0, dims, err, errlen);
}

int gmf_jpeg_decode(const uint8_t* data, size_t len, uint8_t* out,
                    size_t outlen, char* err, int errlen) {
  int dims[3];
  return run(data, len, out, outlen, dims, err, errlen);
}

}  // extern "C"
