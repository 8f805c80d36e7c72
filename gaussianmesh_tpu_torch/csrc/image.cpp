// The host image codecs of the training path: baseline JPEG decoding, PNG
// row unfiltering and PIL's bicubic resampling pass, each returning the
// bytes of its plain numpy version in `io/jpeg.py`, `io/png.py` and
// `io/resample.py` (which are themselves PIL 12's bits, checked against
// PIL by the tests). The parsing of markers, chunks and filter
// coefficients stays in Python: it is per file or per output size, not per
// sample.
//
// - gm_jpeg_scan: one scan's entropy-coded data -> the zig-zag
//   coefficients of each block it codes, DC undifferenced within each
//   restart interval. Huffman symbols are found by one lookup in a 16-bit
//   peek table per table; bits past the end of an interval read as zeros,
//   and an interval that needs them is truncated.
// - gm_jpeg_scan_progressive: one scan of a progressive (SOF2) file, the
//   four decoders of libjpeg's `jdphuff.c` (DC first, DC refine, AC first,
//   AC refine), added into the coefficients of the scans before it.
// - gm_jpeg_lossless: one scan of a lossless (SOF3) file: Huffman-coded
//   differences, restart markers and `jdpred.c`'s predictors in one walk.
// - gm_jpeg_arith_scan / gm_jpeg_arith_encode: one scan of an
//   arithmetic-coded file (SOF9 sequential, SOF10 progressive), decoded
//   into the coefficients gm_jpeg_scan fills, or coded from them: T.81
//   Annex D's QM coder and the models of F.1.4.4 / G.1.3, step for step as
//   libjpeg-turbo's `jdarith.c` and `jcarith.c`.
// - gm_jpeg_planes: dequantisation, libjpeg-turbo's islow IDCT
//   (`jidctint.c`), fancy upsampling (`jdsample.c`) and the fixed-point
//   YCbCr -> RGB tables (`jdcolor.c`), cropped to the frame; four
//   components (CMYK, inverted CMYK, YCCK) to RGB as PIL converts CMYK.
// - gm_png_unfilter: PNG filters 0-4 row after row over bytes.
// - gm_resample_pass: one 8-bit bicubic pass of `Resample.c` along an axis.
// - gm_lzw_decode / gm_lzw_encode: LZW as TIFF (MSB first, the code width
//   growing one code early) and GIF (LSB first, no early change) code it,
//   for `io/lzw.py`.
// - gm_packbits_decode: TIFF's PackBits (compression 32773), `io/tiff.py`.
// - gm_bmp_rle: a BMP's RLE8 / RLE4 pixel data, `io/bmp.py`.
// - gm_tga_rle: a Targa file's run-length packets, `io/tga.py`.
// - gm_qoi_decode: a QOI stream's ops, `io/qoi.py`.
// - gm_sgi_rle: an SGI image's run-length rows, `io/sgi.py`.
// - gm_pcx_rle: a PCX file's run-length rows, `io/pcx.py`.
// - gm_icns_rle: an icns legacy image's run-length planes, `io/icns.py`.
// - gm_sun_rle: a Sun raster's byte-encoded (type 2) data, `io/sun.py`.
// - gm_msp_rle: a Windows Paint (MSP v2) file's row map and run-length
//   rows, `io/msp.py`.
// - gm_fli_frame: an FLI / FLC frame's chunks, `io/fli.py`.
// - gm_bc1_decode / gm_bcn_decode: BC1-BC7 blocks as PIL's `bcn` decoder
//   gives them (BC6H but for fault B38), and BLP's own DXT1 / DXT3 / DXT5
//   rules, `io/bcn.py` (FTEX, DDS and BLP textures).
//
// Integer arithmetic wraps as numpy's int32 does (built with -fwrapv), so
// even out-of-range coefficients of a corrupt file give the plain
// version's bytes. Single-threaded within a call, as PIL is.
//
// Host code, not a TPU kernel: built by `ops/_cuda.py::host_library` with
// g++, loaded with ctypes (which releases the GIL around each call).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// entry-point status codes (io/jpeg.py and io/png.py name them)
constexpr int kOk = 0;
constexpr int kTruncated = 1;       // an interval's data ends early
constexpr int kNoCode = 2;          // no Huffman code matches
constexpr int kFewIntervals = 3;    // fewer restart intervals than the scan needs
constexpr int kBadMagnitude = 4;    // a DC magnitude category over 16
constexpr int kBadFilter = 5;       // a PNG filter type over 4
constexpr int kBadRefine = 6;       // an AC refinement's new coefficient of size other than 1
constexpr int kPastTable = 7;       // an LZW code past the table's next free entry
constexpr int kOverflow = 8;        // decoded data past the size of the strip or frame
constexpr int kBadLiteral = 9;      // an LZW encoder's input byte of min_bits or more bits
constexpr int kNoRoom = 10;         // an LZW encoder's output past its buffer
constexpr int kChannelLeft = 11;    // an icns plane's count not met exactly
constexpr int kRowCorrupt = 12;     // an MSP run cut by the end of its row
constexpr int kArithMagnitude = 13; // an arithmetic-coded magnitude past 2^15
constexpr int kArithRun = 14;       // an arithmetic-coded run of zeros past Se
constexpr int kArithRange = 15;     // an encoder's value past 16 magnitude bits

constexpr int kLzwMaxBits = 12;     // LZW codes of 12 bits, a table of 4,096 entries
constexpr int kLzwTable = 1 << kLzwMaxBits;

// zig-zag position -> natural (row-major) index in the 8x8 block
constexpr int kZigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// A Huffman table as a 65,536-entry peek table: the code length << 8 | the
// symbol of every 16-bit window that starts with a code word, 0 where none
// does (jpeg._decode_tables' `slow` table: codes in Annex C order, a code
// word that overflows its length clipped off the table's end).
struct Huffman {
  std::vector<uint16_t> peek = std::vector<uint16_t>(1 << 16, 0);
  // the entries of code words of up to kFastBits bits by the window's first
  // kFastBits bits (0 where the code word is longer: look in `peek`)
  static constexpr int kFastBits = 9;
  uint16_t fast[1 << kFastBits];

  Huffman(const int32_t* bits, int n_vals, const uint8_t* vals) {
    int64_t code = 0;
    int k = 0;
    for (int length = 1; length <= 16; ++length) {
      for (int i = 0; i < bits[length - 1] && k < n_vals; ++i, ++k) {
        const int64_t lo = code << (16 - length);
        const int64_t hi = std::min<int64_t>((code + 1) << (16 - length), 1 << 16);
        for (int64_t w = lo; w < hi; ++w)
          peek[w] = static_cast<uint16_t>(length << 8 | vals[k]);
        ++code;
      }
      code <<= 1;
    }
    for (int i = 0; i < (1 << kFastBits); ++i) {
      const uint16_t e = peek[i << (16 - kFastBits)];
      fast[i] = (e >> 8) <= kFastBits ? e : 0;
    }
  }

  uint16_t lookup(uint32_t window16) const {
    const uint16_t e = fast[window16 >> (16 - kFastBits)];
    return e ? e : peek[window16];
  }
};

// One restart interval's unstuffed bytes, read MSB first through a 64-bit
// buffer; bytes past the end read as zeros (the padding of
// jpeg._windows). `p` counts the bits consumed.
class Bits {
 public:
  Bits(const uint8_t* data, int64_t n) : data_(data), n_(n) {}

  // Before a symbol: false where the plain walk's window W[p >> 3] would
  // be past its table (an IndexError there: the interval is truncated).
  // Else at least 32 bits are buffered, a code word and its value bits.
  bool ready() {
    if ((p >> 3) > n_ + 1) return false;
    if (nbits_ <= 32 && pos_ + 4 <= n_) {
      const uint8_t* b = data_ + pos_;
      acc_ |= static_cast<uint64_t>(uint32_t(b[0]) << 24 | uint32_t(b[1]) << 16 |
                                    uint32_t(b[2]) << 8 | b[3]) << (32 - nbits_);
      pos_ += 4;
      nbits_ += 32;
    }
    while (nbits_ <= 56) {
      acc_ |= static_cast<uint64_t>(pos_ < n_ ? data_[pos_] : 0) << (56 - nbits_);
      ++pos_;
      nbits_ += 8;
    }
    return true;
  }
  uint32_t peek16() const { return static_cast<uint32_t>(acc_ >> 48); }
  uint32_t take(int n) {           // n in 1..16
    const uint32_t v = static_cast<uint32_t>(acc_ >> (64 - n));
    acc_ <<= n;
    nbits_ -= n;
    p += n;
    return v;
  }
  int64_t p = 0;

 private:
  const uint8_t* data_;
  int64_t n_;
  int64_t pos_ = 0;
  uint64_t acc_ = 0;
  int nbits_ = 0;
};

// The next symbol: -> status and its symbol, the code word consumed.
inline int symbol(Bits& in, const Huffman& t, int* sym) {
  if (!in.ready()) return kTruncated;
  const uint16_t e = t.lookup(in.peek16());
  if ((e >> 8) == 0) return kNoCode;
  in.take(e >> 8);
  *sym = e & 0xFF;
  return kOk;
}

// `s` (1..16) magnitude bits, extended to their signed value (F.2.2.1).
inline int32_t value(Bits& in, int s) {
  const int32_t x = static_cast<int32_t>(in.take(s));
  return x < (1 << (s - 1)) ? x - ((1 << s) - 1) : x;
}

// One pass of `jidctint.c` over 8 inputs g[0], g[stride], ... -> the 8
// outputs descaled by `shift`, written at out[0], out[stride], ...
inline void idct_1d(const int32_t* g, int stride, int shift, int32_t* out) {
  const int32_t g0 = g[0], g1 = g[stride], g2 = g[2 * stride], g3 = g[3 * stride];
  const int32_t g4 = g[4 * stride], g5 = g[5 * stride], g6 = g[6 * stride],
                g7 = g[7 * stride];
  int32_t z1 = (g2 + g6) * 4433;
  const int32_t tmp2 = z1 + g6 * -15137;
  const int32_t tmp3 = z1 + g2 * 6270;
  const int32_t tmp0 = (g0 + g4) * 8192;
  const int32_t tmp1 = (g0 - g4) * 8192;
  const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int32_t t0 = g7, t1 = g5, t2 = g3, t3 = g1;
  z1 = t0 + t3;
  int32_t z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
  const int32_t z5 = (z3 + z4) * 9633;
  t0 *= 2446;
  t1 *= 16819;
  t2 *= 25172;
  t3 *= 12299;
  z1 *= -7373;
  z2 *= -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  const int32_t half = 1 << (shift - 1);
  out[0] = (tmp10 + t3 + half) >> shift;
  out[stride] = (tmp11 + t2 + half) >> shift;
  out[2 * stride] = (tmp12 + t1 + half) >> shift;
  out[3 * stride] = (tmp13 + t0 + half) >> shift;
  out[4 * stride] = (tmp13 - t0 + half) >> shift;
  out[5 * stride] = (tmp12 - t1 + half) >> shift;
  out[6 * stride] = (tmp11 - t2 + half) >> shift;
  out[7 * stride] = (tmp10 - t3 + half) >> shift;
}

// One component's blocks (nby x nbx, zig-zag) -> its sample plane
// (nby * 8, nbx * 8), as jpeg._idct: dequantised in int32, columns then
// rows, clamped to -128..127 and shifted to 0..255.
void idct_plane(const int32_t* coef, const int32_t* q, int nby, int nbx,
                std::vector<uint8_t>* plane) {
  const int64_t w = static_cast<int64_t>(nbx) * 8;
  plane->resize(static_cast<size_t>(nby) * 8 * w);
  int32_t nat[64], ws[64], out[64];
  for (int by = 0; by < nby; ++by)
    for (int bx = 0; bx < nbx; ++bx) {
      const int32_t* zz = coef + (static_cast<int64_t>(by) * nbx + bx) * 64;
      uint8_t* dst = plane->data() + static_cast<int64_t>(by) * 8 * w + bx * 8;
      int32_t ac = 0;
      for (int k = 1; k < 64; ++k) ac |= zz[k];
      const int32_t dc = zz[0] * q[0];
      if (ac == 0 && dc < (1 << 16) && dc >= -(1 << 16)) {
        // both passes' shortcuts below: every sample (4 DC + 16) >> 5
        const uint8_t v = static_cast<uint8_t>(
            std::min(std::max((4 * dc + 16) >> 5, -128), 127) + 128);
        for (int r = 0; r < 8; ++r) std::memset(dst + r * w, v, 8);
        continue;
      }
      for (int k = 0; k < 64; ++k) nat[kZigzag[k]] = zz[k] * q[k];
      for (int c = 0; c < 8; ++c) {
        const int32_t* g = nat + c;
        // a column of zero AC terms and a DC term whose << 13 cannot wrap:
        // the full pass gives DC * 4 in every row
        if ((g[8] | g[16] | g[24] | g[32] | g[40] | g[48] | g[56]) == 0 &&
            g[0] < (1 << 18) && g[0] >= -(1 << 18)) {
          for (int r = 0; r < 8; ++r) ws[8 * r + c] = g[0] * 4;
        } else {
          idct_1d(g, 8, 11, ws + c);    // 13 - PASS1_BITS
        }
      }
      for (int r = 0; r < 8; ++r) {
        const int32_t* g = ws + 8 * r;
        // the same shortcut along a row: (DC * 8192 + 2^17) >> 18 everywhere
        if ((g[1] | g[2] | g[3] | g[4] | g[5] | g[6] | g[7]) == 0 &&
            g[0] < (1 << 18) && g[0] >= -(1 << 18)) {
          for (int c = 0; c < 8; ++c) out[8 * r + c] = (g[0] + 16) >> 5;
        } else {
          idct_1d(g, 1, 18, out + 8 * r);   // 13 + 2 + 3
        }
      }
      for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 8; ++c)
          dst[r * w + c] = static_cast<uint8_t>(std::min(std::max(out[8 * r + c], -128), 127) + 128);
    }
}

// Row y of `jdsample.c`'s upsampling by (ry, rx), each 1 or 2, of the
// (rows x cols) corner of a plane of row stride `stride` -> the first
// cols * rx samples of `out` (jpeg._upsample, one output row).
void upsample_row(const uint8_t* p, int64_t stride, int rows, int cols, int ry, int rx,
                  int64_t y, int32_t* cs, int32_t* out) {
  const int sy = static_cast<int>(y / ry);
  const uint8_t* row = p + sy * stride;
  if (rx == 2 && cols > 2) {
    // h2v2: vertical sums 3 * this + the nearer row, then a 1/16 triangle
    // along the row; h2v1: the row itself, then 1/4
    int bias0 = 1, bias1 = 2, shift = 2;
    if (ry == 2) {
      const int ny = (y & 1) ? std::min(sy + 1, rows - 1) : std::max(sy - 1, 0);
      const uint8_t* near = p + ny * stride;
      for (int x = 0; x < cols; ++x) cs[x] = 3 * row[x] + near[x];
      bias0 = 8, bias1 = 7, shift = 4;
    } else {
      for (int x = 0; x < cols; ++x) cs[x] = row[x];
    }
    for (int x = 0; x < cols; ++x) {
      const int32_t left = cs[x > 0 ? x - 1 : 0], right = cs[x < cols - 1 ? x + 1 : x];
      out[2 * x] = (3 * cs[x] + left + bias0) >> shift;
      out[2 * x + 1] = (3 * cs[x] + right + bias1) >> shift;
    }
    return;
  }
  if (ry == 2 && rx == 1) {         // h1v2
    const int ny = (y & 1) ? std::min(sy + 1, rows - 1) : std::max(sy - 1, 0);
    const uint8_t* near = p + ny * stride;
    const int bias = (y & 1) ? 2 : 1;
    for (int x = 0; x < cols; ++x) out[x] = (3 * row[x] + near[x] + bias) >> 2;
    return;
  }
  // 1:1, or h2v1 / h2v2 at widths of 1-2 (replicated)
  if (rx == 1) {
    for (int x = 0; x < cols; ++x) out[x] = row[x];
  } else {
    for (int x = 0; x < cols; ++x) out[2 * x] = out[2 * x + 1] = row[x];
  }
}

inline uint8_t clip255(int32_t v) { return static_cast<uint8_t>(std::min(std::max(v, 0), 255)); }

// The restart intervals of the entropy-coded data at the start of `data` (n
// bytes): [start, end) spans, in `cuts`, of the runs between RSTn markers
// up to the first other marker (jpeg._entropy_segments). -> the bytes the
// data spans.
int64_t split_intervals(const uint8_t* data, int64_t n, std::vector<int64_t>* cuts) {
  cuts->assign(1, 0);
  int64_t end = n;
  for (int64_t i = 0; i + 1 < n; ++i) {
    if (data[i] != 0xFF) continue;
    const uint8_t next = data[i + 1];
    if (next == 0) continue;
    if (next >= 0xD0 && next <= 0xD7) {
      cuts->push_back(i);
      cuts->push_back(i + 2);
      ++i;
      continue;
    }
    end = i;
    break;
  }
  cuts->push_back(end);
  return end;
}

// Interval `it`'s bytes with the stuffed zeros removed, into `seg`.
void unstuff(const uint8_t* data, const std::vector<int64_t>& cuts, int it,
             std::vector<uint8_t>* seg) {
  const int64_t a = cuts[2 * it], b = cuts[2 * it + 1];
  seg->clear();
  for (int64_t i = a; i < b; ++i)
    if (!(i > a && data[i] == 0 && data[i - 1] == 0xFF)) seg->push_back(data[i]);
}

std::vector<Huffman> huffman_tables(const int32_t* tables, const uint8_t* vals,
                                    int vals_stride, int n_tables) {
  std::vector<Huffman> huff;
  huff.reserve(n_tables);
  for (int t = 0; t < n_tables; ++t)
    huff.emplace_back(tables + 17 * t + 1, tables[17 * t],
                      vals + static_cast<int64_t>(t) * vals_stride);
  return huff;
}

// The width of the LZW code that follows an entry count of `next` (TIFF's
// code width grows one code early): the least width past the literals'
// with next + early < 2^width, 12 at most.
inline int lzw_width(int next, int min_bits, int early) {
  int w = min_bits + 1;
  while (w < kLzwMaxBits && next + early >= (1 << w)) ++w;
  return w;
}


// ---- BCn blocks (io/bcn.py)

constexpr int kBc7Modes[8][10] = {  // subsets, partition, rotation, index selection,
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0},  // colour and alpha bits, unique and shared
    {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},  // p-bits, index bits, second index bits
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};
constexpr uint16_t kBc7Part2[64] = {
    0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80, 0xC800, 0xFFEC, 0xFE80,
    0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000, 0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310,
    0x3100, 0x8CCE, 0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C, 0xAAAA,
    0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A, 0x73CE, 0x13C8, 0x324C, 0x3BDC,
    0x6996, 0xC33C, 0x9966, 0x0660, 0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6,
    0x639C, 0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22};
constexpr uint32_t kBc7Part3[64] = {
    0xAA685050, 0x6A5A5040, 0x5A5A4200, 0x5450A0A8, 0xA5A50000, 0xA0A05050, 0x5555A0A0,
    0x5A5A5050, 0xAA550000, 0xAA555500, 0xAAAA5500, 0x90909090, 0x94949494, 0xA4A4A4A4,
    0xA9A59450, 0x2A0A4250, 0xA5945040, 0x0A425054, 0xA5A5A500, 0x55A0A0A0, 0xA8A85454,
    0x6A6A4040, 0xA4A45000, 0x1A1A0500, 0x0050A4A4, 0xAAA59090, 0x14696914, 0x69691400,
    0xA08585A0, 0xAA821414, 0x50A4A450, 0x6A5A0200, 0xA9A58000, 0x5090A0A8, 0xA8A09050,
    0x24242424, 0x00AA5500, 0x24924924, 0x24499224, 0x50A50A50, 0x500AA550, 0xAAAA4444,
    0x66660000, 0xA5A0A5A0, 0x50A050A0, 0x69286928, 0x44AAAA44, 0x66666600, 0xAA444444,
    0x54A854A8, 0x95809580, 0x96969600, 0xA85454A8, 0x80959580, 0xAA141414, 0x96960000,
    0xAAAA1414, 0xA05050A0, 0xA0A5A5A0, 0x96000000, 0x40804080, 0xA9A8A9A8, 0xAAAAAA44,
    0x2A4A5254};
constexpr uint8_t kBc7Anchor2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2, 8, 2, 2, 8, 8, 15,
    2, 8, 2, 2, 8, 8, 2, 2, 15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6, 6, 2, 6, 8,
    15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15};
constexpr uint8_t kBc7Anchor3a[64] = {
    3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3, 3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6,
    8, 5, 15, 15, 8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15, 3, 15, 5, 5, 5, 8,
    5, 10, 5, 10, 8, 13, 15, 12, 3, 3};
constexpr uint8_t kBc7Anchor3b[64] = {
    15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8, 15, 8, 15, 3, 15, 8, 15, 8, 3,
    15, 6, 10, 15, 15, 10, 8, 15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8, 15, 3,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8};
constexpr uint8_t kBc7Weights2[4] = {0, 21, 43, 64};
constexpr uint8_t kBc7Weights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
constexpr uint8_t kBc7Weights4[16] = {0, 4, 9, 13, 17, 21, 26, 30,
                                      34, 38, 43, 47, 51, 55, 60, 64};

inline const uint8_t* bc7_weights(int bits) {
  return bits == 2 ? kBc7Weights2 : bits == 3 ? kBc7Weights3 : kBc7Weights4;
}

// `count` bits of a 16-byte block from bit `at`, the lowest first
inline int block_bits(const uint8_t* p, int at, int count) {
  int v = 0;
  for (int k = 0; k < count; ++k) v |= (p[(at + k) >> 3] >> ((at + k) & 7) & 1) << k;
  return v;
}

// A BC1 colour block -> px[16][4] RGBA: 565 channels replicated (or shifted
// up, BLP's rule); four colours where c0 > c1 or `four`, else three and
// transparent black.
void bc1_colour(const uint8_t* p, bool four, bool shift, int px[16][4]) {
  const int c0 = p[0] | p[1] << 8, c1 = p[2] | p[3] << 8;
  const uint32_t lut = static_cast<uint32_t>(p[4]) | static_cast<uint32_t>(p[5]) << 8 |
                       static_cast<uint32_t>(p[6]) << 16 | static_cast<uint32_t>(p[7]) << 24;
  four = four || c0 > c1;
  int col[4][4];
  for (int k = 0; k < 2; ++k) {
    const int v = k ? c1 : c0;
    const int r = v >> 11 & 31, g = v >> 5 & 63, b = v & 31;
    col[k][0] = shift ? r << 3 : r << 3 | r >> 2;
    col[k][1] = shift ? g << 2 : g << 2 | g >> 4;
    col[k][2] = shift ? b << 3 : b << 3 | b >> 2;
    col[k][3] = 255;
  }
  for (int ch = 0; ch < 3; ++ch) {
    col[2][ch] = four ? (2 * col[0][ch] + col[1][ch]) / 3 : (col[0][ch] + col[1][ch]) / 2;
    col[3][ch] = four ? (col[0][ch] + 2 * col[1][ch]) / 3 : 0;
  }
  col[2][3] = 255;
  col[3][3] = four ? 255 : 0;
  for (int i = 0; i < 16; ++i)
    for (int ch = 0; ch < 4; ++ch) px[i][ch] = col[lut >> (2 * i) & 3][ch];
}

// A BC4 block -> px[16][ch]: two ends (int8 + 128 where `sign`), eight
// levels (a0 > a1) or six, 0 and 255, each pixel's 3-bit index.
void bc4_channel(const uint8_t* p, bool sign, int ch, int px[16][4]) {
  const int a0 = sign ? static_cast<int8_t>(p[0]) + 128 : p[0];
  const int a1 = sign ? static_cast<int8_t>(p[1]) + 128 : p[1];
  int lv[8] = {a0, a1};
  for (int k = 2; k < 8; ++k) {
    if (a0 > a1) lv[k] = ((8 - k) * a0 + (k - 1) * a1) / 7;
    else lv[k] = k == 6 ? 0 : k == 7 ? 255 : ((6 - k) * a0 + (k - 1) * a1) / 5;
  }
  uint64_t bits = 0;
  for (int k = 0; k < 6; ++k) bits |= static_cast<uint64_t>(p[2 + k]) << (8 * k);
  for (int i = 0; i < 16; ++i) px[i][ch] = lv[bits >> (3 * i) & 7];
}

// A BC7 block -> px[16][4] RGBA, as PIL's `decode_bc7_block`.
void bc7_block(const uint8_t* p, int px[16][4]) {
  if (p[0] == 0) {                          // the reserved mode: opaque black
    for (int i = 0; i < 16; ++i) px[i][0] = px[i][1] = px[i][2] = 0, px[i][3] = 255;
    return;
  }
  int m = 0;
  while (!(p[0] >> m & 1)) ++m;
  const int* md = kBc7Modes[m];
  const int ns = md[0], cb = md[4], ab = md[5], ib = md[8], ib2 = md[9];
  int at = m + 1;
  const int part = block_bits(p, at, md[1]);
  at += md[1];
  const int rot = block_bits(p, at, md[2]);
  at += md[2];
  const int sel = block_bits(p, at, md[3]);
  at += md[3];
  const int ne = 2 * ns;
  int ep[6][4];
  for (int ch = 0; ch < 4; ++ch)
    for (int e = 0; e < ne; ++e) {
      const int b = ch < 3 ? cb : ab;
      ep[e][ch] = b ? block_bits(p, at, b) : 255;
      at += b;
    }
  const int nch = ab ? 4 : 3;
  int cbits = cb, abits = ab;
  if (md[6] || md[7]) {
    ++cbits;
    if (ab) ++abits;
    for (int e = 0; e < ne; e += md[6] ? 1 : 2) {
      const int bit = block_bits(p, at++, 1);
      for (int f = e; f < e + (md[6] ? 1 : 2); ++f)
        for (int ch = 0; ch < nch; ++ch) ep[f][ch] = ep[f][ch] << 1 | bit;
    }
  }
  for (int e = 0; e < ne; ++e)
    for (int ch = 0; ch < nch; ++ch) {
      const int b = ch < 3 ? cbits : abits;
      const int v = ep[e][ch] << (8 - b) & 255;
      ep[e][ch] = v | v >> b;
    }
  const uint8_t* cw = bc7_weights(ib);
  const uint8_t* aw = bc7_weights(ib2 ? ib2 : ib);
  int ci = at, ai = at + 16 * ib - ns;
  for (int i = 0; i < 16; ++i) {
    const int s = ns == 2 ? kBc7Part2[part] >> i & 1
                          : ns == 3 ? kBc7Part3[part] >> (2 * i) & 3 : 0;
    const bool anchor = i == 0 || (ns == 2 && i == kBc7Anchor2[part]) ||
                        (ns == 3 && (i == kBc7Anchor3a[part] || i == kBc7Anchor3b[part]));
    const int w0 = ib - anchor;
    const int i0 = block_bits(p, ci, w0);
    ci += w0;
    int wc = cw[i0], wa = cw[i0];
    if (ab && ib2) {
      const int w1 = ib2 - (i == 0);
      const int i1 = block_bits(p, ai, w1);
      ai += w1;
      wc = sel ? aw[i1] : cw[i0];
      wa = sel ? cw[i0] : aw[i1];
    }
    for (int ch = 0; ch < 4; ++ch) {
      const int w = ch < 3 ? wc : wa;
      px[i][ch] = ((64 - w) * ep[2 * s][ch] + w * ep[2 * s + 1][ch] + 32) >> 6;
    }
    if (rot) std::swap(px[i][rot - 1], px[i][3]);
  }
}

// ---- BC6H (io/bcn.py's _BC6H_MODES: the same table)

struct Bc6Mode {
  int value, mode_bits, regions, transformed, bits, delta[3];
  const char* layout;  // endpoint fields after the mode bits, in stream order
};
constexpr Bc6Mode kBc6Modes[14] = {
    {0x00, 2, 2, 1, 10, {5, 5, 5}, "gy4 by4 bz4 rw0:9 gw0:9 bw0:9 rx0:4 gz4 gy0:3 gx0:4 bz0 "
                                   "gz0:3 bx0:4 bz1 by0:3 ry0:4 bz2 rz0:4 bz3"},
    {0x01, 2, 2, 1, 7, {6, 6, 6}, "gy5 gz4 gz5 rw0:6 bz0 bz1 by4 gw0:6 by5 bz2 gy4 bw0:6 bz3 "
                                  "bz5 bz4 rx0:5 gy0:3 gx0:5 gz0:3 bx0:5 by0:3 ry0:5 rz0:5"},
    {0x02, 5, 2, 1, 11, {5, 4, 4}, "rw0:9 gw0:9 bw0:9 rx0:4 rw10 gy0:3 gx0:3 gw10 bz0 gz0:3 "
                                   "bx0:3 bw10 bz1 by0:3 ry0:4 bz2 rz0:4 bz3"},
    {0x06, 5, 2, 1, 11, {4, 5, 4}, "rw0:9 gw0:9 bw0:9 rx0:3 rw10 gz4 gy0:3 gx0:4 gw10 gz0:3 "
                                   "bx0:3 bw10 bz1 by0:3 ry0:3 bz0 bz2 rz0:3 gy4 bz3"},
    {0x0A, 5, 2, 1, 11, {4, 4, 5}, "rw0:9 gw0:9 bw0:9 rx0:3 rw10 by4 gy0:3 gx0:3 gw10 bz0 "
                                   "gz0:3 bx0:4 bw10 by0:3 ry0:3 bz1 bz2 rz0:3 bz4 bz3"},
    {0x0E, 5, 2, 1, 9, {5, 5, 5}, "rw0:8 by4 gw0:8 gy4 bw0:8 bz4 rx0:4 gz4 gy0:3 gx0:4 bz0 "
                                  "gz0:3 bx0:4 bz1 by0:3 ry0:4 bz2 rz0:4 bz3"},
    {0x12, 5, 2, 1, 8, {6, 5, 5}, "rw0:7 gz4 by4 gw0:7 bz2 gy4 bw0:7 bz3 bz4 rx0:5 gy0:3 "
                                  "gx0:4 bz0 gz0:3 bx0:4 bz1 by0:3 ry0:5 rz0:5"},
    {0x16, 5, 2, 1, 8, {5, 6, 5}, "rw0:7 bz0 by4 gw0:7 gy5 gy4 bw0:7 gz5 bz4 rx0:4 gz4 gy0:3 "
                                  "gx0:5 gz0:3 bx0:4 bz1 by0:3 ry0:4 bz2 rz0:4 bz3"},
    {0x1A, 5, 2, 1, 8, {5, 5, 6}, "rw0:7 bz1 by4 gw0:7 by5 gy4 bw0:7 bz5 bz4 rx0:4 gz4 gy0:3 "
                                  "gx0:4 bz0 gz0:3 bx0:5 by0:3 ry0:4 bz2 rz0:4 bz3"},
    {0x1E, 5, 2, 0, 6, {6, 6, 6}, "rw0:5 gz4 bz0 bz1 by4 gw0:5 gy5 by5 bz2 gy4 bw0:5 gz5 bz3 "
                                  "bz5 bz4 rx0:5 gy0:3 gx0:5 gz0:3 bx0:5 by0:3 ry0:5 rz0:5"},
    {0x03, 5, 1, 0, 10, {10, 10, 10}, "rw0:9 gw0:9 bw0:9 rx0:9 gx0:9 bx0:9"},
    {0x07, 5, 1, 1, 11, {9, 9, 9}, "rw0:9 gw0:9 bw0:9 rx0:8 rw10 gx0:8 gw10 bx0:8 bw10"},
    {0x0B, 5, 1, 1, 12, {8, 8, 8}, "rw0:9 gw0:9 bw0:9 rx0:7 rw11:10 gx0:7 gw11:10 bx0:7 "
                                   "bw11:10"},
    {0x0F, 5, 1, 1, 16, {4, 4, 4}, "rw0:9 gw0:9 bw0:9 rx0:3 rw15:10 gx0:3 gw15:10 bx0:3 "
                                   "bw15:10"},
};

// Each mode's layout as (endpoint slot 3 e + channel, bit) pairs, parsed once.
struct Bc6Fields {
  int n[14] = {};
  uint8_t slot[14][82], bit[14][82];
  Bc6Fields() {
    for (int m = 0; m < 14; ++m) {
      const char* c = kBc6Modes[m].layout;
      while (*c) {
        const int ch = c[0] == 'r' ? 0 : c[0] == 'g' ? 1 : 2;
        const int e = c[1] == 'w' ? 0 : c[1] == 'x' ? 1 : c[1] == 'y' ? 2 : 3;
        char* end;
        const int a = static_cast<int>(std::strtol(c + 2, &end, 10));
        int b = a;
        if (*end == ':') b = static_cast<int>(std::strtol(end + 1, &end, 10));
        for (int k = a;; k += b >= a ? 1 : -1) {
          slot[m][n[m]] = static_cast<uint8_t>(3 * e + ch);
          bit[m][n[m]++] = static_cast<uint8_t>(k);
          if (k == b) break;
        }
        c = *end ? end + 1 : end;
      }
    }
  }
};

inline int32_t sign_extend(int32_t v, int bits) {
  return v & (1 << (bits - 1)) ? v - (1 << bits) : v;
}

int32_t bc6_unquantize(int32_t v, int bits, bool sign) {
  if (!sign) {
    if (bits >= 15) return v;
    if (v == 0) return 0;
    if (v == (1 << bits) - 1) return 0xFFFF;
    return ((v << 15) + 0x4000) >> (bits - 1);
  }
  if (bits >= 16) return v;
  int32_t m = v < 0 ? -v : v;
  if (m != 0) m = m >= (1 << (bits - 1)) - 1 ? 0x7FFF : ((m << 15) + 0x4000) >> (bits - 1);
  return v < 0 ? -m : m;
}

// A half float's bits -> PIL's 8 bits: floor(255 h) in float32, h clamped
// to [0, 1] (a negative half reads 0).
struct HalfTo8 {
  uint8_t v[1 << 16];
  HalfTo8() {
    for (uint32_t h = 0; h < (1u << 16); ++h) {
      const uint32_t e = h >> 10 & 31, m = h & 1023;
      const float f = e == 0 ? std::ldexp(static_cast<float>(m), -24)
                             : std::ldexp(static_cast<float>(m | 1024), static_cast<int>(e) - 25);
      v[h] = h & 0x8000 ? 0 : e == 31 || f > 1.0f ? 255 : static_cast<uint8_t>(f * 255.0f);
    }
  }
};

// A blended value -> its half float, the definition's last step.
inline uint32_t bc6_half(int32_t v, bool sign) {
  if (sign) return v < 0 ? 0x8000u | static_cast<uint32_t>((-v * 31) >> 5) : (v * 31) >> 5;
  return static_cast<uint32_t>((v * 31) >> 6) & 0xFFFF;
}

// A BC6H block -> px[16][0..2] RGB, as io/bcn.py's _bc6h: PIL's `bcn`
// decoder (no + 32 in the blend, C11) but for fault B38 (the transformed
// endpoints sign-extended under BC6HS, as the definition says).
void bc6h_block(const uint8_t* p, bool sign, int px[16][4]) {
  static const Bc6Fields fields;
  static const HalfTo8 to8;
  const int two = p[0] & 3, value = two < 2 ? two : p[0] & 31;
  int m = 0;
  while (m < 14 && kBc6Modes[m].value != value) ++m;
  if (m == 14) {                            // a reserved mode: black
    for (int i = 0; i < 16; ++i) px[i][0] = px[i][1] = px[i][2] = 0;
    return;
  }
  const Bc6Mode& md = kBc6Modes[m];
  uint64_t word[2] = {0, 0};
  for (int k = 0; k < 16; ++k) word[k >> 3] |= static_cast<uint64_t>(p[k]) << (8 * (k & 7));
  int32_t ep[12] = {0};
  for (int f = 0, at = md.mode_bits; f < fields.n[m]; ++f, ++at)
    ep[fields.slot[m][f]] |= static_cast<int32_t>(word[at >> 6] >> (at & 63) & 1)
                             << fields.bit[m][f];
  const int ne = 6 * md.regions, mask = (1 << md.bits) - 1;
  if (md.transformed)
    for (int e = 3; e < ne; ++e) ep[e] = (ep[e % 3] + sign_extend(ep[e], md.delta[e % 3])) & mask;
  for (int e = 0; e < ne; ++e) {
    if (sign) ep[e] = sign_extend(ep[e], md.bits);
    ep[e] = bc6_unquantize(ep[e], md.bits, sign);
  }
  const int part = md.regions == 2 ? block_bits(p, 77, 5) : 0;
  const int ib = md.regions == 2 ? 3 : 4;
  const uint8_t* wt = bc7_weights(ib);
  int ci = md.regions == 2 ? 82 : 65;
  for (int i = 0; i < 16; ++i) {
    const int s = md.regions == 2 ? kBc7Part2[part] >> i & 1 : 0;
    const bool anchor = i == 0 || (md.regions == 2 && i == kBc7Anchor2[part]);
    const int w = wt[block_bits(p, ci, ib - anchor)];
    ci += ib - anchor;
    for (int ch = 0; ch < 3; ++ch)
      px[i][ch] = to8.v[bc6_half((ep[6 * s + ch] * (64 - w) + ep[6 * s + 3 + ch] * w) >> 6, sign)];
  }
}

int bcn_decode(const uint8_t* data, int64_t n, int64_t width, int64_t height, int kind,
               int flags, uint8_t* out, int64_t* info) {
  const bool sign = flags & 1, shift = flags & 2;
  const int size = kind == 1 || kind == 4 ? 8 : 16;
  const int c = kind == 4 ? 1 : kind == 5 || kind == 6 ? 3 : 4;
  const int64_t bw = (width + 3) / 4, bh = (height + 3) / 4;
  const int64_t blocks = std::min(bw * bh, n / size);
  int px[16][4];
  for (int64_t b = 0; b < blocks; ++b) {
    const uint8_t* p = data + size * b;
    switch (kind) {
      case 1: bc1_colour(p, false, shift, px); break;
      case 2:
        bc1_colour(p + 8, true, shift, px);
        for (int i = 0; i < 16; ++i) px[i][3] = (p[i >> 1] >> (4 * (i & 1)) & 15) * 17;
        break;
      case 3:
        bc1_colour(p + 8, true, shift, px);
        bc4_channel(p, false, 3, px);
        break;
      case 4: bc4_channel(p, false, 0, px); break;
      case 5:
        bc4_channel(p, sign, 0, px);
        bc4_channel(p + 8, sign, 1, px);
        for (int i = 0; i < 16; ++i) px[i][2] = sign ? 128 : 0;
        break;
      case 6: bc6h_block(p, sign, px); break;
      default: bc7_block(p, px);
    }
    const int64_t y0 = b / bw * 4, x0 = b % bw * 4;
    for (int j = 0; j < 4 && y0 + j < height; ++j)
      for (int i = 0; i < 4 && x0 + i < width; ++i) {
        uint8_t* d = out + c * ((y0 + j) * width + x0 + i);
        for (int ch = 0; ch < c; ++ch) d[ch] = static_cast<uint8_t>(px[4 * j + i][ch]);
      }
  }
  info[0] = blocks;
  return blocks < bw * bh ? kTruncated : kOk;
}

// ---------------------------------------------------------------- QM coder

// T.81 Table D.2, packed as libjpeg's `jpeg_aritab`: Qe << 16 |
// Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS. Entry 113 is the
// fixed estimate of 0.5 (T.851) that signs and DC refinements are coded at.
constexpr int32_t kQe[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617, 0x00e50719,
    0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09, 0x00030d0a, 0x00010d0c,
    0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a, 0x0cef152b,
    0x09a1162d, 0x072f172e, 0x055c1830, 0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36,
    0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320,
    0x002c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d, 0x0861314e,
    0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633, 0x02d43734, 0x025c3835,
    0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39, 0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d,
    0x008f203d, 0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654,
    0x23794756, 0x1edf4857, 0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a,
    0x0d514e4b, 0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f, 0x44d95b60,
    0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266,
    0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367,
    0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171};

constexpr int kFixedBin = 113;
constexpr int kDcBins = 64, kAcBins = 256;

// The statistics of a scan: a DC area and an AC area for each of the four
// conditioning tables, and the fixed 0.5 bin (which never leaves state 113).
struct ArithStats {
  uint8_t dc[4][kDcBins];
  uint8_t ac[4][kAcBins];
  uint8_t fixed;
  void clear() {
    std::memset(dc, 0, sizeof(dc));
    std::memset(ac, 0, sizeof(ac));
    fixed = kFixedBin;
  }
};

// T.81 D.2 (`jdarith.c`'s arith_decode): one restart interval's unstuffed
// bytes, then zero bytes (the marker that ends the interval: D.2.6). Where
// the interval runs to the end of the data (no marker after it), a byte
// fetched past it sets `truncated` (libjpeg's source would have to wait for
// more data; PIL's cannot) and reads as zero.
class QmDecoder {
 public:
  QmDecoder(const uint8_t* seg, int64_t n, bool at_end) : seg_(seg), n_(n), at_end_(at_end) {}

  int decode(uint8_t* st) {
    while (a_ < 0x8000) {               // renormalisation and byte input (D.2.6)
      if (--ct_ < 0) {
        int data = 0;
        if (pos_ < n_) {
          data = seg_[pos_++];
        } else if (at_end_) {
          truncated = true;
        }
        c_ = (c_ << 8) | data;
        if ((ct_ += 8) < 0 && ++ct_ == 0) a_ = 0x8000;   // the two first bytes
      }
      a_ <<= 1;
    }
    int sv = *st;
    int64_t qe = kQe[sv & 0x7F];
    const int nl = qe & 0xFF, nm = (qe >> 8) & 0xFF;
    qe >>= 16;
    int64_t temp = a_ - qe;             // D.2.4 / D.2.5, the conditional exchanges
    a_ = temp;
    temp <<= ct_;
    if (c_ >= temp) {
      c_ -= temp;
      if (a_ < qe) {
        a_ = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a_ = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a_ < 0x8000) {
      if (a_ < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  bool truncated = false;

 private:
  const uint8_t* seg_;
  int64_t n_, pos_ = 0;
  bool at_end_;
  int64_t c_ = 0, a_ = 0;
  int ct_ = -16;                        // two bytes to fetch before the first decision
};

// T.81 D.1 (`jcarith.c`'s arith_encode and finish_pass): the C register
// with its carry into the byte before a run of 0xFF bytes, each 0xFF
// stuffed with 0x00, and a flush that drops trailing zero bytes.
class QmEncoder {
 public:
  explicit QmEncoder(std::vector<uint8_t>* out) : out_(out) {}

  void encode(uint8_t* st, int val) {
    const int sv = *st;
    int64_t qe = kQe[sv & 0x7F];
    const int nl = qe & 0xFF, nm = (qe >> 8) & 0xFF;
    qe >>= 16;
    a_ -= qe;
    if (val != (sv >> 7)) {             // the less probable symbol
      if (a_ >= qe) {
        c_ += a_;
        a_ = qe;
      }
      *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
    } else {                            // the more probable one
      if (a_ >= 0x8000) return;
      if (a_ < qe) {
        c_ += a_;
        a_ = qe;
      }
      *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
    }
    do {                                // renormalisation and byte output (D.1.6)
      a_ <<= 1;
      c_ <<= 1;
      if (--ct_ == 0) {
        const int64_t temp = c_ >> 19;
        if (temp > 0xFF) {              // a carry over the stacked 0xFF bytes
          if (buffer_ >= 0) {
            zeros();
            emit(buffer_ + 1);
          }
          zc_ += sc_;
          sc_ = 0;
          buffer_ = static_cast<int>(temp & 0xFF);
        } else if (temp == 0xFF) {
          ++sc_;
        } else {
          release();
          buffer_ = static_cast<int>(temp);
        }
        c_ &= 0x7FFFF;
        ct_ += 8;
      }
    } while (a_ < 0x8000);
  }

  void finish() {
    // the value in the interval with the most trailing zero bits (D.1.8)
    const int64_t temp = (a_ - 1 + c_) & 0xFFFF0000LL;
    c_ = temp < c_ ? temp + 0x8000 : temp;
    c_ <<= ct_;
    if (c_ & 0xF8000000LL) {            // one last carry
      if (buffer_ >= 0) {
        zeros();
        emit(buffer_ + 1);
      }
      zc_ += sc_;
      sc_ = 0;
    } else {
      release();
    }
    if (c_ & 0x7FFF800LL) {             // the last bytes, unless zero
      zeros();
      emit(static_cast<int>((c_ >> 19) & 0xFF));
      if (c_ & 0x7F800LL) emit(static_cast<int>((c_ >> 11) & 0xFF));
    }
  }

 private:
  void emit(int v) {                    // a byte, and the 0x00 that stuffs a 0xFF
    out_->push_back(static_cast<uint8_t>(v));
    if (v == 0xFF) out_->push_back(0);
  }
  void zeros() {                        // the pending zero bytes
    for (; zc_ > 0; --zc_) out_->push_back(0);
  }
  // the buffered byte (a zero one stays pending) and the stacked 0xFF bytes
  void release() {
    if (buffer_ == 0) {
      ++zc_;
    } else if (buffer_ > 0) {
      zeros();
      emit(buffer_);
    }
    if (sc_) {
      zeros();
      for (; sc_ > 0; --sc_) emit(0xFF);
    }
  }

  std::vector<uint8_t>* out_;
  int64_t c_ = 0, a_ = 0x10000, sc_ = 0, zc_ = 0;
  int ct_ = 11, buffer_ = -1;
};

// One DC difference (F.1.4.4.1; Figures F.19-F.24) at the statistics `dc`
// of its table, in the component's context (0 zero, 4 / 8 small + / -,
// 12 / 16 large + / -, by the magnitude class against the table's L and U).
int arith_dc(QmDecoder& d, uint8_t* dc, int* context, int lo, int hi, int32_t* diff) {
  uint8_t* st = dc + *context;
  if (d.decode(st) == 0) {
    *context = 0;
    *diff = 0;
    return kOk;
  }
  const int sign = d.decode(st + 1);
  st += 2 + sign;
  int m = d.decode(st);
  if (m) {
    st = dc + 20;                       // X1
    while (d.decode(st)) {
      if ((m <<= 1) == 0x8000) return kArithMagnitude;
      ++st;
    }
  }
  if (m < ((1 << lo) >> 1))
    *context = 0;
  else if (m > ((1 << hi) >> 1))
    *context = 12 + 4 * sign;
  else
    *context = 4 + 4 * sign;
  int32_t v = m;
  st += 14;                             // M_k of the last X_k
  while (m >>= 1)
    if (d.decode(st)) v |= m;
  v += 1;
  *diff = sign ? -v : v;
  return kOk;
}

// The rest of an AC value after its sign (Figures F.23 / F.24): `st` is
// the bin of the zero / nonzero decision at k; the magnitude chain's second
// set is by k against the table's Kx.
int arith_ac_value(QmDecoder& d, uint8_t* ac, uint8_t* st, int k, int kx, int sign,
                   int32_t* value) {
  st += 2;
  int m = d.decode(st);
  if (m && d.decode(st)) {
    m <<= 1;
    st = ac + (k <= kx ? 189 : 217);
    while (d.decode(st)) {
      if ((m <<= 1) == 0x8000) return kArithMagnitude;
      ++st;
    }
  }
  int32_t v = m;
  st += 14;
  while (m >>= 1)
    if (d.decode(st)) v |= m;
  v += 1;
  *value = sign ? -v : v;
  return kOk;
}

// An AC band k0..k1 of one block (F.1.4.4.2 / G.1.3.2's first scans): an
// end-of-block decision at 3 (k - 1), the zeros before the next value,
// its sign at the fixed bin, its magnitude; values shifted up by `al`.
int arith_ac_band(QmDecoder& d, ArithStats& s, int tab, int kx, int k0, int k1, int al,
                  int32_t* zz) {
  uint8_t* ac = s.ac[tab];
  for (int k = k0; k <= k1; ++k) {
    uint8_t* st = ac + 3 * (k - 1);
    if (d.decode(st)) break;            // end of block
    while (d.decode(st + 1) == 0) {
      st += 3;
      if (++k > k1) return kArithRun;
    }
    const int sign = d.decode(&s.fixed);
    int32_t v;
    const int status = arith_ac_value(d, ac, st, k, kx, sign, &v);
    if (status != kOk) return status;
    zz[k] = static_cast<int16_t>(static_cast<uint32_t>(v) << al);
  }
  return kOk;
}

// An AC refinement (G.1.3.3, `decode_mcu_AC_refine`): past the previous
// passes' last nonzero coefficient (EOBx) an end-of-block decision at each
// k; a coefficient nonzero before takes a correction bit, a zero one a
// decision whether it becomes +-2^al (its sign at the fixed bin).
int arith_ac_refine(QmDecoder& d, ArithStats& s, int tab, int ss, int se, int al,
                    int32_t* zz) {
  uint8_t* ac = s.ac[tab];
  const int32_t p1 = 1 << al, m1 = -p1;
  int kex = se;
  for (; kex > 0; --kex)
    if (zz[kex]) break;
  for (int k = ss; k <= se; ++k) {
    uint8_t* st = ac + 3 * (k - 1);
    if (k > kex && d.decode(st)) break;
    for (;;) {
      int32_t* c = zz + k;
      if (*c) {
        if (d.decode(st + 2)) *c = static_cast<int16_t>(*c + (*c < 0 ? m1 : p1));
        break;
      }
      if (d.decode(st + 1)) {
        *c = d.decode(&s.fixed) ? m1 : p1;
        break;
      }
      st += 3;
      if (++k > se) return kArithRun;
    }
  }
  return kOk;
}

// The encoder's side of arith_dc: difference v (0 codes as zero).
void encode_dc(QmEncoder& e, uint8_t* dc, int* context, int lo, int hi, int32_t v) {
  uint8_t* st = dc + *context;
  if (v == 0) {
    e.encode(st, 0);
    *context = 0;
    return;
  }
  e.encode(st, 1);
  if (v > 0) {
    e.encode(st + 1, 0);
    st += 2;
    *context = 4;
  } else {
    v = -v;
    e.encode(st + 1, 1);
    st += 3;
    *context = 8;
  }
  int m = 0;
  if (v -= 1) {
    e.encode(st, 1);
    m = 1;
    int32_t v2 = v;
    st = dc + 20;
    while (v2 >>= 1) {
      e.encode(st, 1);
      m <<= 1;
      ++st;
    }
  }
  e.encode(st, 0);
  if (m < ((1 << lo) >> 1))
    *context = 0;
  else if (m > ((1 << hi) >> 1))
    *context += 8;
  st += 14;
  while (m >>= 1) e.encode(st, (m & v) ? 1 : 0);
}

// The encoder's side of arith_ac_value: magnitude v >= 1 at k.
void encode_ac_value(QmEncoder& e, uint8_t* ac, uint8_t* st, int k, int kx, int32_t v) {
  st += 2;
  int m = 0;
  if (v -= 1) {
    e.encode(st, 1);
    m = 1;
    int32_t v2 = v;
    if (v2 >>= 1) {
      e.encode(st, 1);
      m <<= 1;
      st = ac + (k <= kx ? 189 : 217);
      while (v2 >>= 1) {
        e.encode(st, 1);
        m <<= 1;
        ++st;
      }
    }
  }
  e.encode(st, 0);
  st += 14;
  while (m >>= 1) e.encode(st, (m & v) ? 1 : 0);
}

// The encoder's side of arith_ac_band (`encode_mcu_AC_first`; k0 1, k1 63,
// al 0 for a sequential block): the magnitudes |zz[k]| >> al.
void encode_ac_band(QmEncoder& e, ArithStats& s, int tab, int kx, int k0, int k1, int al,
                    const int32_t* zz) {
  uint8_t* ac = s.ac[tab];
  auto mag = [&](int k) { return (zz[k] < 0 ? -zz[k] : zz[k]) >> al; };
  int ke = k1;
  for (; ke > 0; --ke)
    if (mag(ke)) break;
  int k = k0;
  for (; k <= ke; ++k) {
    uint8_t* st = ac + 3 * (k - 1);
    e.encode(st, 0);
    while (mag(k) == 0) {
      e.encode(st + 1, 0);
      st += 3;
      ++k;
    }
    e.encode(st + 1, 1);
    e.encode(&s.fixed, zz[k] < 0);
    encode_ac_value(e, ac, st, k, kx, mag(k));
  }
  if (k <= k1) e.encode(ac + 3 * (k - 1), 1);
}

// The encoder's side of arith_ac_refine (`encode_mcu_AC_refine`).
void encode_ac_refine(QmEncoder& e, ArithStats& s, int tab, int ss, int se, int ah, int al,
                      const int32_t* zz) {
  uint8_t* ac = s.ac[tab];
  auto mag = [&](int k, int shift) { return (zz[k] < 0 ? -zz[k] : zz[k]) >> shift; };
  int ke = se;
  for (; ke > 0; --ke)
    if (mag(ke, al)) break;
  int kex = ke;
  for (; kex > 0; --kex)
    if (mag(kex, ah)) break;
  int k = ss;
  for (; k <= ke; ++k) {
    uint8_t* st = ac + 3 * (k - 1);
    if (k > kex) e.encode(st, 0);
    for (;;) {
      const int32_t v = mag(k, al);
      if (v) {
        if (v >> 1) {
          e.encode(st + 2, v & 1);      // a correction bit
        } else {
          e.encode(st + 1, 1);          // newly nonzero, then its sign
          e.encode(&s.fixed, zz[k] < 0);
        }
        break;
      }
      e.encode(st + 1, 0);
      st += 3;
      ++k;
    }
  }
  if (k <= se) e.encode(ac + 3 * (k - 1), 1);
}

}  // namespace

extern "C" {

// One sequential scan. `data` (n bytes) is the file from the scan's first
// entropy-coded byte on. Its restart intervals are the runs between RSTn
// markers up to the first other marker, stuffed zeros removed (as
// jpeg._entropy_segments); fewer than ceil(n_mcus / interval) of them is
// kFewIntervals (their count in *n_found). Each MCU holds `per_mcu` blocks;
// block j of an MCU is of component slot comp[j] and uses DC table dc_tab[j]
// and AC table ac_tab[j] of `tables` ((n_tables, 17) int32: the number of
// symbols given, then the 16 counts of DHT) and `vals` ((n_tables,
// vals_stride) uint8). The i-th block of the scan goes to coef[dest[i] * 64]
// (zeroed first), 64 zig-zag int32. *used: the bytes the entropy-coded
// data spans.
int gm_jpeg_scan(const uint8_t* data, int64_t n, int n_mcus, int interval, int per_mcu,
                 const int32_t* comp, const int32_t* dc_tab, const int32_t* ac_tab,
                 const int32_t* tables, const uint8_t* vals, int vals_stride,
                 int n_tables, const int32_t* dest, int32_t* coef, int64_t* used,
                 int32_t* n_found) {
  std::vector<int64_t> cuts;
  *used = split_intervals(data, n, &cuts);
  const int n_seg = static_cast<int>(cuts.size() / 2);
  if (interval <= 0) interval = n_mcus;
  const int n_int = n_mcus > 0 ? (n_mcus + interval - 1) / interval : 0;
  *n_found = n_seg;
  if (n_seg < n_int) return kFewIntervals;

  const std::vector<Huffman> huff = huffman_tables(tables, vals, vals_stride, n_tables);
  std::vector<uint8_t> seg;
  int64_t block = 0;
  for (int it = 0; it < n_int; ++it) {
    // the interval's bytes, stuffed zeros removed, then zeros
    unstuff(data, cuts, it, &seg);
    const int64_t len = static_cast<int64_t>(seg.size());
    Bits in(seg.data(), len);
    int32_t pred[4] = {0, 0, 0, 0};     // DC predictors by component slot
    const int m = std::min(interval, n_mcus - it * interval);
    for (int mcu = 0; mcu < m; ++mcu)
      for (int j = 0; j < per_mcu; ++j, ++block) {
        int32_t* zz = coef + static_cast<int64_t>(dest[block]) * 64;
        std::memset(zz, 0, 64 * sizeof(int32_t));
        int sym, st;
        if ((st = symbol(in, huff[dc_tab[j]], &sym)) != kOk) return st;
        if (sym > 16) return kBadMagnitude;
        pred[comp[j]] += sym ? value(in, sym) : 0;
        zz[0] = pred[comp[j]];
        const Huffman& ac = huff[ac_tab[j]];
        for (int k = 1; k < 64; ++k) {
          if ((st = symbol(in, ac, &sym)) != kOk) return st;
          const int run = sym >> 4, s = sym & 15;
          if (s == 0) {
            if (run != 15) break;       // end of block
            k += 15;                    // ZRL: sixteen zeros
            continue;
          }
          k += run;
          const int32_t v = value(in, s);
          if (k < 64) zz[k] = v;
        }
      }
    const int64_t p = in.p;
    if (p > 8 * len) return kTruncated;
  }
  return kOk;
}

// One lossless (SOF3) scan: `data`, `n` and its restart intervals as
// gm_jpeg_scan's, an interval `rows_per` MCU rows of `mcux` MCUs (of mcuy).
// Each MCU holds per_mcu samples: sample j of scan component comp[j], at row
// dy[j] and column dx[j] of the component's hs x vs samples in the MCU,
// coded with table tab[j] of `tables` / `vals` (gm_jpeg_scan's packing).
// A difference is a category (16: 32768 with no bits; over 16 is
// kBadMagnitude), then its bits, extended; it goes to planes[c] (row
// stride stride[c], int32) at MCU row * vs + dy, MCU column * hs + dx. At
// the end of each MCU row its rows are undifferenced as `jdpred.c` does,
// mod 2^16: the first row of the scan and of each interval from
// 2^(7 - pt) then Ra; other rows' first sample from Rb, the rest by
// `predictor` (1 Ra, 2 Rb, 3 Rc, 4 Ra + Rb - Rc, 5 Ra + ((Rb - Rc) >> 1),
// 6 Rb + ((Ra - Rc) >> 1), 7 (Ra + Rb) >> 1). Truncated intervals and bad
// codes as gm_jpeg_scan's (io/jpeg.py's _lossless_plain).
int gm_jpeg_lossless(const uint8_t* data, int64_t n, int mcux, int mcuy, int rows_per,
                     int per_mcu, const int32_t* comp, const int32_t* dy, const int32_t* dx,
                     const int32_t* tab, const int32_t* tables, const uint8_t* vals,
                     int vals_stride, int n_tables, int n_comp, const int32_t* hs,
                     const int32_t* vs, int32_t* const* planes, const int64_t* stride,
                     int predictor, int pt, int64_t* used, int32_t* n_found) {
  std::vector<int64_t> cuts;
  *used = split_intervals(data, n, &cuts);
  const int n_seg = static_cast<int>(cuts.size() / 2);
  if (rows_per <= 0) rows_per = mcuy;
  const int n_int = mcuy > 0 ? (mcuy + rows_per - 1) / rows_per : 0;
  *n_found = n_seg;
  if (n_seg < n_int) return kFewIntervals;

  const std::vector<Huffman> huff = huffman_tables(tables, vals, vals_stride, n_tables);
  std::vector<uint8_t> seg;
  for (int it = 0; it < n_int; ++it) {
    unstuff(data, cuts, it, &seg);
    const int64_t len = static_cast<int64_t>(seg.size());
    Bits in(seg.data(), len);
    const int y_end = std::min(mcuy, (it + 1) * rows_per);
    for (int my = it * rows_per; my < y_end; ++my) {
      for (int mx = 0; mx < mcux; ++mx)
        for (int j = 0; j < per_mcu; ++j) {
          int sym, st;
          if ((st = symbol(in, huff[tab[j]], &sym)) != kOk) return st;
          if (sym > 16) return kBadMagnitude;
          const int c = comp[j];
          planes[c][(static_cast<int64_t>(my) * vs[c] + dy[j]) * stride[c] +
                    static_cast<int64_t>(mx) * hs[c] + dx[j]] =
              sym == 16 ? 32768 : sym ? value(in, sym) : 0;
        }
      // the MCU row's sample rows, each component's
      for (int c = 0; c < n_comp; ++c) {
        const int64_t width = static_cast<int64_t>(mcux) * hs[c];
        for (int r = 0; r < vs[c]; ++r) {
          int32_t* row = planes[c] + (static_cast<int64_t>(my) * vs[c] + r) * stride[c];
          if (my == it * rows_per && r == 0) {       // a first row: 1-D
            int32_t ra = 1 << (7 - pt);
            for (int64_t x = 0; x < width; ++x) row[x] = ra = (row[x] + ra) & 0xFFFF;
            continue;
          }
          const int32_t* prev = row - stride[c];
          int32_t rb = prev[0], ra = (row[0] + rb) & 0xFFFF;
          row[0] = ra;
          for (int64_t x = 1; x < width; ++x) {
            const int32_t rc = rb;
            rb = prev[x];
            int32_t p;
            switch (predictor) {
              case 1: p = ra; break;
              case 2: p = rb; break;
              case 3: p = rc; break;
              case 4: p = ra + rb - rc; break;
              case 5: p = ra + ((rb - rc) >> 1); break;
              case 6: p = rb + ((ra - rc) >> 1); break;
              default: p = (ra + rb) >> 1;
            }
            row[x] = ra = (row[x] + p) & 0xFFFF;
          }
        }
      }
    }
    if (in.p > 8 * len) return kTruncated;
  }
  return kOk;
}

// One scan of a progressive file: `data`, `n`, the intervals, `per_mcu`,
// `comp`, `tables`, `vals` and `dest` as gm_jpeg_scan's, block j of an MCU
// decoded with table tab[j] (DC for a DC first scan, AC for an AC scan;
// none for a DC refinement), by the decoder that spectral selection ss..se
// and successive approximation ah, al name (`jdphuff.c`, whose checks
// io/jpeg.py has made). Coefficients are set or refined in place, never
// zeroed: the frame's blocks start at zero and gather every scan. The DC
// predictors and the EOB run restart with each interval. Before each
// symbol and each raw bit the bit count is checked as gm_jpeg_scan's
// window is; past the interval's end bits read as zeros and the interval is
// truncated. An AC refinement's new coefficient of a size other than 1 is
// kBadRefine (libjpeg warns and goes on).
int gm_jpeg_scan_progressive(const uint8_t* data, int64_t n, int n_mcus, int interval,
                             int per_mcu, const int32_t* comp, const int32_t* tab,
                             const int32_t* tables, const uint8_t* vals, int vals_stride,
                             int n_tables, const int32_t* dest, int ss, int se, int ah,
                             int al, int32_t* coef, int64_t* used, int32_t* n_found) {
  std::vector<int64_t> cuts;
  *used = split_intervals(data, n, &cuts);
  const int n_seg = static_cast<int>(cuts.size() / 2);
  if (interval <= 0) interval = n_mcus;
  const int n_int = n_mcus > 0 ? (n_mcus + interval - 1) / interval : 0;
  *n_found = n_seg;
  if (n_seg < n_int) return kFewIntervals;

  const std::vector<Huffman> huff = huffman_tables(tables, vals, vals_stride, n_tables);
  const int32_t p1 = static_cast<int32_t>(1u << al), m1 = -p1;
  std::vector<uint8_t> seg;
  int64_t block = 0;
  for (int it = 0; it < n_int; ++it) {
    unstuff(data, cuts, it, &seg);
    const int64_t len = static_cast<int64_t>(seg.size());
    Bits in(seg.data(), len);
    int32_t pred[4] = {0, 0, 0, 0};
    int64_t eobrun = 0;
    const int m = std::min(interval, n_mcus - it * interval);
    for (int mcu = 0; mcu < m; ++mcu)
      for (int j = 0; j < per_mcu; ++j, ++block) {
        int32_t* zz = coef + static_cast<int64_t>(dest[block]) * 64;
        int sym, st;
        if (ss == 0 && ah == 0) {               // DC first
          if ((st = symbol(in, huff[tab[j]], &sym)) != kOk) return st;
          if (sym > 16) return kBadMagnitude;
          pred[comp[j]] += sym ? value(in, sym) : 0;
          zz[0] = pred[comp[j]] * p1;
        } else if (ss == 0) {                   // DC refine: one raw bit
          if (!in.ready()) return kTruncated;
          if (in.take(1)) zz[0] |= p1;
        } else if (ah == 0) {                   // AC first
          if (eobrun > 0) {
            --eobrun;
            continue;
          }
          const Huffman& ac = huff[tab[j]];
          for (int k = ss; k <= se; ++k) {
            if ((st = symbol(in, ac, &sym)) != kOk) return st;
            int r = sym >> 4;
            const int s = sym & 15;
            if (s) {
              k += r;
              zz[std::min(k, 63)] = value(in, s) * p1;
            } else if (r == 15) {
              k += 15;                          // ZRL
            } else {                            // EOBr: 2^r + r bits, this block one
              eobrun = int64_t{1} << r;
              if (r) eobrun += in.take(r);
              --eobrun;
              break;
            }
          }
        } else {                                // AC refine
          const Huffman& ac = huff[tab[j]];
          int k = ss;
          if (eobrun == 0) {
            for (; k <= se; ++k) {
              if ((st = symbol(in, ac, &sym)) != kOk) return st;
              int r = sym >> 4;
              int32_t s = sym & 15;
              if (s) {
                if (s != 1) return kBadRefine;
                s = in.take(1) ? p1 : m1;
              } else if (r != 15) {
                eobrun = int64_t{1} << r;
                if (r) eobrun += in.take(r);
                break;                          // the rest as the EOB run's
              }
              // past nonzero coefficients (a correction bit each) and r zero
              // ones, to the zero one the new coefficient takes
              do {
                int32_t* c = zz + k;
                if (*c != 0) {
                  if (!in.ready()) return kTruncated;
                  if (in.take(1) && (*c & p1) == 0) *c += *c >= 0 ? p1 : m1;
                } else if (--r < 0) {
                  break;
                }
                ++k;
              } while (k <= se);
              if (s) zz[std::min(k, 63)] = s;
            }
          }
          if (eobrun > 0) {
            // the band's remaining nonzero coefficients: a correction bit each
            for (; k <= se; ++k) {
              int32_t* c = zz + k;
              if (*c != 0) {
                if (!in.ready()) return kTruncated;
                if (in.take(1) && (*c & p1) == 0) *c += *c >= 0 ? p1 : m1;
              }
            }
            --eobrun;
          }
        }
      }
    if (in.p > 8 * len) return kTruncated;
  }
  return kOk;
}

// One scan of an arithmetic-coded file: sequential (SOF9) where
// `progressive` is 0, else the SOF10 decoder that ss, se, ah and al name.
// `data`, `n`, the intervals, `per_mcu`, `comp` and `dest` are as
// gm_jpeg_scan's; block j of an MCU is coded with DC conditioning table
// dc_tab[j] and AC table ac_tab[j] (0-3) under `cond` (L[4], U[4], Kx[4]).
// A sequential block is zeroed and set; a progressive scan adds to the
// coefficients of the scans before it. The statistics, the DC predictions
// and contexts and the coder restart with each interval. Each value is
// kept to 16 bits, as libjpeg's JCOEF keeps it. Where libjpeg warns ("bad
// arithmetic code") and leaves the rest of the interval zero, this returns
// kArithMagnitude (a magnitude past 2^15) or kArithRun (a run of zeros past
// Se); where an interval runs to the end of the data and the coder fetches
// a byte past it, kTruncated.
int gm_jpeg_arith_scan(const uint8_t* data, int64_t n, int n_mcus, int interval, int per_mcu,
                       const int32_t* comp, const int32_t* dc_tab, const int32_t* ac_tab,
                       const int32_t* dest, int progressive, int ss, int se, int ah, int al,
                       const int32_t* cond, int32_t* coef, int64_t* used, int32_t* n_found) {
  std::vector<int64_t> cuts;
  *used = split_intervals(data, n, &cuts);
  const int n_seg = static_cast<int>(cuts.size() / 2);
  if (interval <= 0) interval = n_mcus;
  const int n_int = n_mcus > 0 ? (n_mcus + interval - 1) / interval : 0;
  *n_found = n_seg;
  if (n_seg < n_int) return kFewIntervals;

  const int32_t *lo = cond, *hi = cond + 4, *kx = cond + 8;
  const int32_t p1 = static_cast<int32_t>(1u << al);
  ArithStats stats;
  std::vector<uint8_t> seg;
  int64_t block = 0;
  for (int it = 0; it < n_int; ++it) {
    unstuff(data, cuts, it, &seg);
    QmDecoder d(seg.data(), static_cast<int64_t>(seg.size()), cuts[2 * it + 1] == n);
    stats.clear();
    int32_t last[4] = {0, 0, 0, 0};     // DC predictions and contexts by component slot
    int context[4] = {0, 0, 0, 0};
    const int m = std::min(interval, n_mcus - it * interval);
    for (int mcu = 0; mcu < m; ++mcu)
      for (int j = 0; j < per_mcu; ++j, ++block) {
        int32_t* zz = coef + static_cast<int64_t>(dest[block]) * 64;
        const int c = comp[j], dt = dc_tab[j], at = ac_tab[j];
        int status = kOk;
        int32_t diff;
        if (!progressive) {
          std::memset(zz, 0, 64 * sizeof(int32_t));
          status = arith_dc(d, stats.dc[dt], &context[c], lo[dt], hi[dt], &diff);
          if (status == kOk) {
            last[c] = (last[c] + diff) & 0xFFFF;
            zz[0] = static_cast<int16_t>(last[c]);
            status = arith_ac_band(d, stats, at, kx[at], 1, 63, 0, zz);
          }
        } else if (ss == 0 && ah == 0) {        // DC first
          status = arith_dc(d, stats.dc[dt], &context[c], lo[dt], hi[dt], &diff);
          if (status == kOk) {
            last[c] = (last[c] + diff) & 0xFFFF;
            zz[0] = static_cast<int16_t>(static_cast<uint32_t>(last[c]) << al);
          }
        } else if (ss == 0) {                   // DC refinement: a bit at the fixed bin
          if (d.decode(&stats.fixed)) zz[0] = static_cast<int16_t>(zz[0] | p1);
        } else if (ah == 0) {                   // AC first
          status = arith_ac_band(d, stats, at, kx[at], ss, se, al, zz);
        } else {                                // AC refinement
          status = arith_ac_refine(d, stats, at, ss, se, al, zz);
        }
        if (d.truncated) return kTruncated;
        if (status != kOk) return status;
      }
  }
  return kOk;
}

// The encoder's side of gm_jpeg_arith_scan (`jcarith.c`): `blocks`
// ((n_mcus * per_mcu, 64) zig-zag int32, in the scan's order) with
// `comp`, `dc_tab`, `ac_tab`, `progressive`, `ss`, `se`, `ah`, `al` and
// `cond` as there -> the scan's entropy-coded data, with an RSTn marker
// (numbered 0-7 in turn) after each interval of `interval` MCUs but the
// last, into `out` (`cap` bytes). *n_out: its length (kNoRoom where that
// is past `cap`). A coefficient outside +-32767 is kArithRange.
int gm_jpeg_arith_encode(const int32_t* blocks, int n_mcus, int per_mcu, const int32_t* comp,
                         const int32_t* dc_tab, const int32_t* ac_tab, int progressive, int ss,
                         int se, int ah, int al, int interval, const int32_t* cond,
                         uint8_t* out, int64_t cap, int64_t* n_out) {
  const int64_t n_blocks = static_cast<int64_t>(n_mcus) * per_mcu;
  for (int64_t i = 0; i < 64 * n_blocks; ++i)
    if (blocks[i] > 32767 || blocks[i] < -32767) return kArithRange;
  if (interval <= 0) interval = n_mcus;
  const int32_t *lo = cond, *hi = cond + 4, *kx = cond + 8;
  ArithStats stats;
  std::vector<uint8_t> buf;
  int64_t block = 0;
  for (int it = 0; static_cast<int64_t>(it) * interval < n_mcus; ++it) {
    if (it) {
      buf.push_back(0xFF);
      buf.push_back(static_cast<uint8_t>(0xD0 + (it - 1) % 8));
    }
    stats.clear();
    int32_t last[4] = {0, 0, 0, 0};
    int context[4] = {0, 0, 0, 0};
    QmEncoder e(&buf);
    const int m = std::min(interval, n_mcus - it * interval);
    for (int mcu = 0; mcu < m; ++mcu)
      for (int j = 0; j < per_mcu; ++j, ++block) {
        const int32_t* zz = blocks + block * 64;
        const int c = comp[j], dt = dc_tab[j], at = ac_tab[j];
        if (!progressive) {
          encode_dc(e, stats.dc[dt], &context[c], lo[dt], hi[dt], zz[0] - last[c]);
          last[c] = zz[0];
          encode_ac_band(e, stats, at, kx[at], 1, 63, 0, zz);
        } else if (ss == 0 && ah == 0) {
          const int32_t v = zz[0] >> al;        // an arithmetic shift, as IRIGHT_SHIFT
          encode_dc(e, stats.dc[dt], &context[c], lo[dt], hi[dt], v - last[c]);
          last[c] = v;
        } else if (ss == 0) {
          e.encode(&stats.fixed, (zz[0] >> al) & 1);
        } else if (ah == 0) {
          encode_ac_band(e, stats, at, kx[at], ss, se, al, zz);
        } else {
          encode_ac_refine(e, stats, at, ss, se, ah, al, zz);
        }
      }
    e.finish();
  }
  *n_out = static_cast<int64_t>(buf.size());
  if (*n_out > cap) return kNoRoom;
  std::memcpy(out, buf.data(), buf.size());
  return kOk;
}

// The frame's planes -> the decoded image. Component c's blocks (nby[c] x
// nbx[c], zig-zag) start at coef[offset[c] * 64] with its table
// q[c * 64 ...] (zig-zag order); its samples are its (rows[c], cols[c])
// corner, upsampled by (ry[c], rx[c]) and cropped to height x width.
// color: 0 one gray plane -> (H, W); 1 YCbCr -> RGB; 2 the n_comp (3 or 4)
// planes as they are -> (H, W, n_comp); four planes to CMYK, then RGB -> (H, W, 3): 3 CMYK
// as stored, 4 inverted (PIL's `CMYK;I`), 5 YCCK (libjpeg's
// `ycck_cmyk_convert`, C = 255 - R of the YCbCr tables and so on, K as it
// is, which PIL then inverts: C = R, K = 255 - K). CMYK -> RGB is Pillow's
// `cmyk2rgb` (jpeg.cmyk_to_rgb): nk = 255 - K and R = nk - MULDIV255(C, nk),
// MULDIV255(a, b) = (((a * b + 128) >> 8) + a * b + 128) >> 8, G and B alike.
int gm_jpeg_planes(const int32_t* coef, int n_comp, const int64_t* offset,
                   const int32_t* nby, const int32_t* nbx, const int32_t* rows,
                   const int32_t* cols, const int32_t* ry, const int32_t* rx,
                   const int32_t* q, int height, int width, int color, uint8_t* out) {
  std::vector<std::vector<uint8_t>> plane(n_comp);
  std::vector<std::vector<int32_t>> line(n_comp);
  int64_t longest = 0;
  for (int c = 0; c < n_comp; ++c) {
    idct_plane(coef + offset[c] * 64, q + 64 * c, nby[c], nbx[c], &plane[c]);
    line[c].resize(static_cast<size_t>(cols[c]) * rx[c]);
    longest = std::max<int64_t>(longest, cols[c]);
  }
  std::vector<int32_t> cs(longest);
  // jdcolor.c's tables: 16-bit fixed point, ONE_HALF rounding
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    const int32_t x = i - 128;
    cr_r[i] = (91881 * x + 32768) >> 16;     // FIX(1.40200)
    cb_b[i] = (116130 * x + 32768) >> 16;    // FIX(1.77200)
    cr_g[i] = -46802 * x;                    // -FIX(0.71414)
    cb_g[i] = -22554 * x + 32768;            // -FIX(0.34414), ONE_HALF
  }
  const int64_t w = width;
  for (int64_t y = 0; y < height; ++y) {
    for (int c = 0; c < n_comp; ++c)
      upsample_row(plane[c].data(), static_cast<int64_t>(nbx[c]) * 8, rows[c], cols[c],
                   ry[c], rx[c], y, cs.data(), line[c].data());
    if (color == 0) {
      uint8_t* o = out + y * w;
      for (int64_t x = 0; x < w; ++x) o[x] = static_cast<uint8_t>(line[0][x]);
    } else if (color == 2) {
      uint8_t* o = out + y * w * n_comp;
      for (int64_t x = 0; x < w; ++x)
        for (int c = 0; c < n_comp; ++c)
          o[n_comp * x + c] = static_cast<uint8_t>(line[c][x]);
    } else if (color == 1) {
      const int32_t *yy = line[0].data(), *cb = line[1].data(), *cr = line[2].data();
      uint8_t* o = out + y * w * 3;
      for (int64_t x = 0; x < w; ++x) {
        o[3 * x] = clip255(yy[x] + cr_r[cr[x]]);
        o[3 * x + 1] = clip255(yy[x] + ((cb_g[cb[x]] + cr_g[cr[x]]) >> 16));
        o[3 * x + 2] = clip255(yy[x] + cb_b[cb[x]]);
      }
    } else {
      const int32_t *p0 = line[0].data(), *p1 = line[1].data(), *p2 = line[2].data(),
                    *p3 = line[3].data();
      uint8_t* o = out + y * w * 3;
      for (int64_t x = 0; x < w; ++x) {
        int32_t cmyk[4];
        if (color == 5) {
          cmyk[0] = clip255(p0[x] + cr_r[p2[x]]);
          cmyk[1] = clip255(p0[x] + ((cb_g[p1[x]] + cr_g[p2[x]]) >> 16));
          cmyk[2] = clip255(p0[x] + cb_b[p1[x]]);
          cmyk[3] = 255 - p3[x];
        } else {                                // 3 as stored, 4 inverted
          const int32_t* p[4] = {p0, p1, p2, p3};
          for (int c = 0; c < 4; ++c) cmyk[c] = color == 4 ? 255 - p[c][x] : p[c][x];
        }
        const int32_t nk = 255 - cmyk[3];
        for (int c = 0; c < 3; ++c) {
          const int32_t t = cmyk[c] * nk + 128;
          o[3 * x + c] = static_cast<uint8_t>(nk - (((t >> 8) + t) >> 8));
        }
      }
    }
  }
  return kOk;
}

// PNG rows (h, 1 + row_bytes): a filter type byte, then the filtered bytes
// -> out (h, row_bytes), each byte predicted from the reconstructed byte
// `bpp` to its left, the one above and the one above that, as libpng.
int gm_png_unfilter(const uint8_t* rows, int64_t h, int64_t row_bytes, int bpp,
                    uint8_t* out) {
  const std::vector<uint8_t> zero(row_bytes, 0);
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* src = rows + y * (row_bytes + 1);
    const uint8_t ft = src[0];
    ++src;
    uint8_t* cur = out + y * row_bytes;
    const uint8_t* up = y ? out + (y - 1) * row_bytes : zero.data();
    switch (ft) {
      case 0:
        std::memcpy(cur, src, row_bytes);
        break;
      case 1:
        for (int64_t i = 0; i < row_bytes; ++i)
          cur[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < row_bytes; ++i) cur[i] = static_cast<uint8_t>(src[i] + up[i]);
        break;
      case 3:
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          cur[i] = static_cast<uint8_t>(src[i] + ((a + up[i]) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0, b = up[i], c = i >= bpp ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = static_cast<uint8_t>(src[i] + pred);
        }
        break;
      default:
        return kBadFilter;
    }
  }
  return kOk;
}

// One pass of Resample.c's 8-bit resampler over an (h, w, c) uint8 image
// along `axis` (1: columns, to out_size; 0: rows, to out_size). Output i
// sums, from 1 << 21, source pixel min(xmin[i] + t, last) times
// k[i * ksize + t] for t = 0 .. ksize - 1 (the 22-bit fixed-point weights
// of resample.coefficients), shifted by 22 and clipped to 0..255.
int gm_resample_pass(const uint8_t* src, int64_t h, int64_t w, int64_t c, int axis,
                     int64_t out_size, const int32_t* xmin, const int32_t* k, int ksize,
                     uint8_t* dst) {
  constexpr int kPrecisionBits = 32 - 8 - 2;
  const int32_t start = 1 << (kPrecisionBits - 1);
  if (axis == 1) {
    const int64_t last = w - 1;
    int32_t acc[4];
    for (int64_t y = 0; y < h; ++y) {
      const uint8_t* row = src + y * w * c;
      uint8_t* o = dst + y * out_size * c;
      for (int64_t x = 0; x < out_size; ++x) {
        for (int ch = 0; ch < c; ++ch) acc[ch] = start;
        const int32_t* kx = k + x * ksize;
        for (int t = 0; t < ksize; ++t) {
          const uint8_t* px = row + std::min<int64_t>(xmin[x] + t, last) * c;
          for (int ch = 0; ch < c; ++ch) acc[ch] += px[ch] * kx[t];
        }
        for (int ch = 0; ch < c; ++ch) o[x * c + ch] = clip255(acc[ch] >> kPrecisionBits);
      }
    }
    return kOk;
  }
  const int64_t last = h - 1, n = w * c;
  std::vector<int32_t> acc(n);
  for (int64_t y = 0; y < out_size; ++y) {
    std::fill(acc.begin(), acc.end(), start);
    const int32_t* ky = k + y * ksize;
    for (int t = 0; t < ksize; ++t) {
      const uint8_t* row = src + std::min<int64_t>(xmin[y] + t, last) * n;
      const int32_t wt = ky[t];
      for (int64_t i = 0; i < n; ++i) acc[i] += row[i] * wt;
    }
    uint8_t* o = dst + y * n;
    for (int64_t i = 0; i < n; ++i) o[i] = clip255(acc[i] >> kPrecisionBits);
  }
  return kOk;
}

// LZW data (n bytes) -> out, at most out_size bytes: codes of min_bits + 1
// bits to 12, read MSB first (TIFF) or LSB first (GIF); Clear is
// 1 << min_bits, EOI the code after it; the width grows once the next free
// entry plus `early` (1 for TIFF) reaches 1 << width, and a full table (4,096
// entries) takes no more until a Clear. A code equal to the next free entry
// is the last string and its own first byte (KwKwK). Stops at EOI, where fewer
// bits are left than a code takes, or with out full. info: the bytes written,
// then (kPastTable) the code and the next free entry. A code past the next
// free entry, or the first code after a Clear past the literals, is
// kPastTable; a string that would run past out_size is kOverflow. The same
// walk as io/lzw.py::lzw_decode_plain.
int gm_lzw_decode(const uint8_t* data, int64_t n, int msb_first, int min_bits, int early,
                  uint8_t* out, int64_t out_size, int64_t* info) {
  const int clear = 1 << min_bits, eoi = clear + 1;
  int32_t prefix[kLzwTable], length[kLzwTable];
  uint8_t last[kLzwTable], first[kLzwTable];
  for (int i = 0; i < clear; ++i) {
    prefix[i] = -1;
    length[i] = 1;
    last[i] = first[i] = static_cast<uint8_t>(i);
  }
  int width = min_bits + 1, next = clear + 2, prev = -1, nacc = 0;
  uint64_t acc = 0;
  int64_t pos = 0, o = 0;
  info[0] = 0;
  while (o < out_size) {
    while (nacc < width) {
      if (pos == n) {
        info[0] = o;
        return kOk;
      }
      if (msb_first)
        acc = acc << 8 | data[pos++];
      else
        acc |= static_cast<uint64_t>(data[pos++]) << nacc;
      nacc += 8;
    }
    int code;
    if (msb_first) {
      code = static_cast<int>(acc >> (nacc - width)) & ((1 << width) - 1);
      nacc -= width;
      acc &= (uint64_t(1) << nacc) - 1;
    } else {
      code = static_cast<int>(acc) & ((1 << width) - 1);
      acc >>= width;
      nacc -= width;
    }
    if (code == clear) {
      width = min_bits + 1;
      next = clear + 2;
      prev = -1;
      continue;
    }
    if (code == eoi) break;
    const bool known = code < next;
    if (!known && !(code == next && prev >= 0)) {
      info[0] = o;
      info[1] = code;
      info[2] = next;
      return kPastTable;
    }
    const int base = known ? code : prev;
    const int64_t len = length[base] + (known ? 0 : 1);
    if (len > out_size - o) {
      info[0] = o;
      return kOverflow;
    }
    int64_t k = o + length[base] - 1;
    for (int c = base; c >= 0; c = prefix[c]) out[k--] = last[c];
    if (!known) out[o + len - 1] = first[prev];
    if (prev >= 0 && next < kLzwTable) {
      prefix[next] = prev;
      last[next] = first[base];
      first[next] = first[prev];
      length[next] = length[prev] + 1;
      ++next;
    }
    o += len;
    prev = code;
    if (next + early >= (1 << width) && width < kLzwMaxBits) ++width;
  }
  info[0] = o;
  return kOk;
}

// `data` (n bytes, each below 1 << min_bits) -> LZW in out (room for `cap`
// bytes), *n_out bytes: Clear first, then greedy matches over a hash of
// (prefix code, byte), a Clear once the next free entry reaches clear_at
// (4,094 as libtiff; 4,096: never, the table held full), the last
// match, EOI, the last byte's free bits zero. Each code takes the width the
// decoder reads it with (lzw_width of the entry count one behind the
// encoder's), EOI after the entry the decoder makes from the last code.
int gm_lzw_encode(const uint8_t* data, int64_t n, int msb_first, int min_bits, int early,
                  int clear_at, uint8_t* out, int64_t cap, int64_t* n_out) {
  constexpr int kSlots = 1 << 14;                // open addressing, load <= 1/4
  const int clear = 1 << min_bits, eoi = clear + 1;
  std::vector<int32_t> keys(kSlots, -1), codes(kSlots);
  std::vector<int32_t> used;                     // slots filled since the last Clear
  used.reserve(kLzwTable);
  uint64_t acc = 0;
  int nacc = 0;
  int64_t o = 0;
  int next = clear + 2;
  auto put = [&](int code) -> bool {
    const int w = lzw_width(next - 1, min_bits, early);
    if (msb_first) {
      acc = acc << w | static_cast<uint64_t>(code);
      nacc += w;
      while (nacc >= 8) {
        if (o == cap) return false;
        out[o++] = static_cast<uint8_t>(acc >> (nacc - 8));
        nacc -= 8;
      }
      acc &= (uint64_t(1) << nacc) - 1;
    } else {
      acc |= static_cast<uint64_t>(code) << nacc;
      nacc += w;
      while (nacc >= 8) {
        if (o == cap) return false;
        out[o++] = static_cast<uint8_t>(acc);
        acc >>= 8;
        nacc -= 8;
      }
    }
    return true;
  };
  auto slot = [&](int32_t key) {
    uint32_t h = (static_cast<uint32_t>(key) * 2654435761u) >> (32 - 14);
    while (keys[h] != -1 && keys[h] != key) h = (h + 1) & (kSlots - 1);
    return h;
  };
  *n_out = 0;
  for (int64_t i = 0; i < n; ++i)
    if (data[i] >= clear) return kBadLiteral;
  if (!put(clear)) return kNoRoom;
  if (n > 0) {
    int pre = data[0];
    for (int64_t i = 1; i < n; ++i) {
      const int32_t key = pre << 8 | data[i];
      const uint32_t h = slot(key);
      if (keys[h] == key) {
        pre = codes[h];
        continue;
      }
      if (!put(pre)) return kNoRoom;
      if (next < kLzwTable) {
        keys[h] = key;
        codes[h] = next++;
        used.push_back(static_cast<int32_t>(h));
      }
      if (next == clear_at && clear_at < kLzwTable) {
        if (!put(clear)) return kNoRoom;
        for (int32_t u : used) keys[u] = -1;
        used.clear();
        next = clear + 2;
      }
      pre = data[i];
    }
    if (!put(pre)) return kNoRoom;
    if (next < kLzwTable) ++next;
  }
  if (!put(eoi)) return kNoRoom;
  if (nacc > 0) {
    if (o == cap) return kNoRoom;
    out[o++] = static_cast<uint8_t>(msb_first ? acc << (8 - nacc) : acc);
  }
  *n_out = o;
  return kOk;
}

// TIFF PackBits (n bytes) -> out, at most out_size bytes (libtiff's
// PackBitsDecode): a header byte h as int8, then h + 1 literal bytes
// (h >= 0), one byte repeated 1 - h times (h < 0), or nothing (-128).
// Stops with out full or at the end of the data, a packet whose data runs
// past the end stopping it unwritten; a packet that would run past out_size
// is kOverflow. *n_out: the bytes written.
int gm_packbits_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_size,
                       int64_t* n_out) {
  int64_t i = 0, o = 0;
  *n_out = 0;
  while (i < n && o < out_size) {
    const int h = static_cast<int8_t>(data[i++]);
    if (h == -128) continue;
    const int64_t len = h < 0 ? 1 - h : h + 1;
    if (len > out_size - o) {
      *n_out = o;
      return kOverflow;
    }
    if (h < 0) {
      if (i == n) break;
      std::memset(out + o, data[i++], len);
    } else {
      if (len > n - i) break;
      std::memcpy(out + o, data + i, len);
      i += len;
    }
    o += len;
  }
  *n_out = o;
  return kOk;
}

// A BMP's RLE8 (rle4 0) or RLE4 data (n bytes from file offset `origin`) ->
// out, width * height palette indices in the order they are stored, as
// PIL's BmpRleDecoder walks it: pairs (count, value) are encoded runs, cut
// at the row's end (RLE4: the value's two nibbles in turn); (0, 0) pads the
// row with index 0, (0, 1) ends the bitmap, (0, 2, right, up) skips
// right + up * width pixels, left at 0 (PIL reads four bytes after the
// escape: fault B17); (0, k >= 3) is k absolute pixels from ceil(k / 2)
// bytes for RLE4 (PIL reads k // 2 of them: B17) or k for RLE8, then a
// byte to the next even file offset. Absolute runs are not cut at the row's
// end, and an encoded run that follows one in the same row is cut to none.
// Stops with out full, at the end of the bitmap or of the data. *n_out: the
// pixels written (fewer than width * height where the data ends first).
int gm_bmp_rle(const uint8_t* data, int64_t n, int64_t origin, int64_t width,
               int64_t height, int rle4, uint8_t* out, int64_t* n_out) {
  const int64_t total = width * height;
  int64_t len = 0, x = 0, i = 0;
  auto fill = [&](int64_t count, uint8_t v) {
    const int64_t k = std::min(count, total - len);
    if (k > 0) std::memset(out + len, v, k);
    len += count;
  };
  while (len < total) {
    if (i + 2 > n) break;
    int64_t count = data[i];
    const int byte = data[i + 1];
    i += 2;
    if (count) {
      if (x + count > width) count = std::max<int64_t>(0, width - x);
      if (rle4) {
        for (int64_t k = 0; k < count && len < total; ++k)
          out[len++] = static_cast<uint8_t>(k & 1 ? byte & 15 : byte >> 4);
      } else {
        fill(count, static_cast<uint8_t>(byte));
      }
      x += count;
    } else if (byte == 0) {
      fill((width - len % width) % width, 0);
      x = 0;
    } else if (byte == 1) {
      break;
    } else if (byte == 2) {
      if (i + 2 > n) break;
      fill(data[i] + data[i + 1] * width, 0);
      i += 2;
      x = len % width;
    } else {
      const int64_t nbytes = rle4 ? (byte + 1) / 2 : byte;
      const int64_t avail = std::min(nbytes, n - i);
      const int64_t pixels = rle4 ? std::min<int64_t>(byte, 2 * avail) : avail;
      for (int64_t k = 0; k < pixels && len < total; ++k)
        out[len++] = rle4 ? static_cast<uint8_t>(k & 1 ? data[i + k / 2] & 15
                                                       : data[i + k / 2] >> 4)
                          : data[i + k];
      i += avail;
      if (avail < nbytes) break;
      x += byte;
      if ((origin + i) & 1) ++i;
    }
  }
  *n_out = std::min(len, total);
  return kOk;
}

// A Targa file's RLE packets (n bytes) -> out, `total` bytes of rows of
// `row_bytes`, as PIL's TgaRleDecode walks them: a header byte h, then
// (h & 127) + 1 pixels of `pixel_bytes` each, one pixel repeated (h >= 128)
// or as many literal pixels. A literal packet may run on into the next
// rows; a repeated one that would cross the end of its row is kOverflow
// (PIL: buffer overrun). A packet whose bytes run past the data stops the
// walk unwritten. Stops with out full; pixels of a literal packet past it
// are read and dropped. *n_out: the bytes written.
int gm_tga_rle(const uint8_t* data, int64_t n, int pixel_bytes, int64_t row_bytes,
               int64_t total, uint8_t* out, int64_t* n_out) {
  int64_t i = 0, o = 0;
  *n_out = 0;
  while (o < total && i < n) {
    const int h = data[i];
    const int64_t nb = static_cast<int64_t>((h & 127) + 1) * pixel_bytes;
    if (h & 128) {
      if (n - i < 1 + pixel_bytes) break;
      if (o % row_bytes + nb > row_bytes) {
        *n_out = o;
        return kOverflow;
      }
      for (int64_t k = 0; k < nb; k += pixel_bytes)
        std::memcpy(out + o + k, data + i + 1, pixel_bytes);
      i += 1 + pixel_bytes;
      o += nb;
    } else {
      if (n - i < 1 + nb) break;
      const int64_t k = std::min(nb, total - o);
      std::memcpy(out + o, data + i + 1, k);
      i += 1 + nb;
      o += k;
    }
  }
  *n_out = o;
  return kOk;
}

// A QOI stream's ops (n bytes after the 14-byte header) -> out, `pixels`
// pixels of `channels` (3 or 4) bytes, as PIL's QoiDecoder reads them: the
// previous pixel starts as (0, 0, 0, 255) and the 64-entry index as zeros;
// RGB (0xFE) keeps the previous alpha, RGBA (0xFF), INDEX, DIFF and LUMA
// (wrapping mod 256) each set the previous pixel and its index entry at
// (3r + 5g + 7b + 11a) % 64; RUN repeats the previous pixel 1-62 times and
// touches no index entry (the format's reference decoder writes one; PIL
// does not, which differs only for a run before any other op). A 3-channel
// image keeps an RGBA op's alpha for its hashes and drops it from out. The
// pixels past a run that overfills out are dropped, and nothing after the
// last pixel is read (the end marker included). An op cut by the end of
// the data is kTruncated.
int gm_qoi_decode(const uint8_t* data, int64_t n, int channels, int64_t pixels,
                  uint8_t* out) {
  uint8_t index[64][4] = {};
  uint8_t px[4] = {0, 0, 0, 255};
  int64_t i = 0, o = 0;
  while (o < pixels) {
    if (i >= n) return kTruncated;
    const int b = data[i++];
    if (b == 0xFE || b == 0xFF) {
      const int k = b == 0xFE ? 3 : 4;
      if (n - i < k) return kTruncated;
      std::memcpy(px, data + i, k);
      i += k;
    } else if (b >> 6 == 0) {
      std::memcpy(px, index[b], 4);
    } else if (b >> 6 == 1) {
      px[0] = static_cast<uint8_t>(px[0] + ((b >> 4) & 3) - 2);
      px[1] = static_cast<uint8_t>(px[1] + ((b >> 2) & 3) - 2);
      px[2] = static_cast<uint8_t>(px[2] + (b & 3) - 2);
    } else if (b >> 6 == 2) {
      if (i >= n) return kTruncated;
      const int b2 = data[i++];
      const int dg = (b & 63) - 32;
      px[0] = static_cast<uint8_t>(px[0] + dg + (b2 >> 4) - 8);
      px[1] = static_cast<uint8_t>(px[1] + dg);
      px[2] = static_cast<uint8_t>(px[2] + dg + (b2 & 15) - 8);
    } else {
      for (int64_t r = std::min<int64_t>((b & 63) + 1, pixels - o); r > 0; --r, ++o)
        std::memcpy(out + o * channels, px, channels);
      continue;
    }
    std::memcpy(index[(px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64], px, 4);
    std::memcpy(out + o * channels, px, channels);
    ++o;
  }
  return kOk;
}

// An SGI image's RLE rows -> out, `ysize` rows of xsize * zsize samples of
// `bpc` bytes (1, or 2 big-endian), interleaved, in stored order (bottom
// first), as PIL's SgiRleDecode expands them. `data` is the file after its
// 512-byte header (n bytes); starts / lengths are its tables, one entry a
// row of each channel, channel after channel, offsets from the start of
// the file. One row buffer serves every row, so a row's samples that its
// data does not reach keep the row before's. Within a row's `length`
// (counted as packets, one a byte of it, as PIL counts them) each packet
// is a control byte (bpc 2: the low byte of a word) c: c & 127 == 0 ends
// the row; c & 128 copies c & 127 samples, else repeats the next sample
// c & 127 times. A control byte other than 0 on the last count stops the
// decode there, the rows from that one on left 0 (PIL returns what it
// has); a packet past the row's width, an offset before the header or a
// read that reaches the last byte of the data (PIL's bound is one short)
// is kOverflow.
int gm_sgi_rle(const uint8_t* data, int64_t n, const uint32_t* starts,
               const uint32_t* lengths, int64_t xsize, int64_t ysize, int zsize, int bpc,
               uint8_t* out) {
  const int64_t row = xsize * zsize * bpc;
  std::vector<uint8_t> buf(row, 0);
  const int64_t end = n - 1;             // the last byte, PIL's end_of_buffer
  for (int64_t y = 0; y < ysize; ++y) {
    for (int c = 0; c < zsize; ++c) {
      const int64_t at = starts[y + c * ysize];
      if (at < 512) return kOverflow;
      int64_t src = at - 512, x = 0;
      uint8_t* dest = buf.data() + c * bpc;
      int status = 0;
      // PIL passes the length on as a C int: one of 2^31 or more counts none
      for (int64_t left = static_cast<int32_t>(lengths[y + c * ysize]); left > 0; --left) {
        if (src + bpc - 1 > end) return kOverflow;
        const int pixel = data[src + bpc - 1];
        src += bpc;
        if (left == 1 && pixel != 0) {
          status = 1;
          break;
        }
        const int count = pixel & 127;
        if (count == 0) break;
        if (x + count > xsize) return kOverflow;
        x += count;
        if (pixel & 128) {
          if (src + int64_t{bpc} * count > end) return kOverflow;
          for (int k = 0; k < count; ++k, src += bpc, dest += zsize * bpc)
            std::memcpy(dest, data + src, bpc);
        } else {
          if (src + (bpc - 1) * 2 > end) return kOverflow;
          for (int k = 0; k < count; ++k, dest += zsize * bpc)
            std::memcpy(dest, data + src, bpc);
          src += bpc;
        }
      }
      if (status) return kOk;
    }
    std::memcpy(out + y * row, buf.data(), row);
  }
  return kOk;
}

// A PCX file's RLE data (n bytes) -> out, `rows` rows of `row_bytes`, as
// PIL's PcxDecode walks it: a byte b >= 0xC0 repeats the next byte b & 63
// times (0 writes nothing), any other byte is itself. A run that would
// cross the end of its row is kOverflow (PIL: buffer overrun); a run cut
// by the end of the data stops the walk. *n_out: the bytes written.
int gm_pcx_rle(const uint8_t* data, int64_t n, int64_t row_bytes, int64_t rows,
               uint8_t* out, int64_t* n_out) {
  const int64_t total = row_bytes * rows;
  int64_t i = 0, o = 0;
  *n_out = 0;
  while (o < total && i < n) {
    const int b = data[i];
    if ((b & 0xC0) == 0xC0) {
      if (n - i < 2) break;
      const int64_t count = b & 63;
      if (o % row_bytes + count > row_bytes) {
        *n_out = o;
        return kOverflow;
      }
      std::memset(out + o, data[i + 1], count);
      o += count;
      i += 2;
    } else {
      out[o++] = static_cast<uint8_t>(b);
      ++i;
    }
  }
  *n_out = o;
  return kOk;
}

// An icns legacy image's three planes (R, G, B), run-length coded as
// PIL's `IcnsImagePlugin.read_32` walks them from data[0:n): a control byte
// c of 0x80 or more repeats the next byte c - 125 times, any other is
// followed by c + 1 literal bytes; a plane ends once its count of `sizesq`
// bytes is met or passed, or at the end of the data, and the next plane
// starts at the byte after. out: 3 * sizesq bytes, plane after plane.
// Returns kOk; kChannelLeft where a plane's count ends other than at 0
// (PIL: "Error reading channel"; info[1] the bytes left, negative past
// the plane's end); kTruncated where a count is met with the data ended
// inside a run (PIL: the plane's buffer is not large enough). info[0]:
// the plane that failed (0 on success), info[2]: the bytes walked.
int gm_icns_rle(const uint8_t* data, int64_t n, int64_t sizesq, uint8_t* out,
                int64_t* info) {
  int64_t i = 0;
  info[0] = info[1] = 0;
  for (int plane = 0; plane < 3; ++plane) {
    uint8_t* dest = out + plane * sizesq;
    int64_t left = sizesq, got = 0;
    while (left > 0 && i < n) {
      const int c = data[i++];
      int64_t count, have;
      if (c & 0x80) {
        count = c - 125;
        have = i < n ? count : 0;
        if (have) {
          const int64_t room = std::max<int64_t>(0, std::min(have, sizesq - got));
          std::memset(dest + got, data[i++], room);
        }
      } else {
        count = c + 1;
        have = std::min(count, n - i);
        const int64_t room = std::max<int64_t>(0, std::min(have, sizesq - got));
        std::memcpy(dest + got, data + i, room);
        i += have;
      }
      got += have;
      left -= count;
    }
    info[0] = plane;
    info[1] = left;
    info[2] = i;
    if (left != 0) return kChannelLeft;
    if (got != sizesq) return kTruncated;
  }
  info[0] = info[1] = 0;
  return kOk;
}

// A Sun raster's byte-encoded data (RT_BYTE_ENCODED, type 2: the type-1
// raster, rows padded to 16 bits, coded as a byte stream) from data[0:n)
// -> out, at most `total` bytes: 0x80 0 is a literal 0x80, 0x80 c v is
// c + 1 copies of v, any other byte is itself. Runs cross rows freely; the
// walk stops once `total` bytes are written (the rest of a run and of the
// data unread) or at the end of the data (a packet the data cuts is
// dropped). info[0]: the bytes written, info[1]: the bytes consumed.
int gm_sun_rle(const uint8_t* data, int64_t n, int64_t total, uint8_t* out,
               int64_t* info) {
  int64_t i = 0, o = 0;
  while (o < total && i < n) {
    const int b = data[i];
    if (b != 0x80) {
      out[o++] = static_cast<uint8_t>(b);
      ++i;
    } else if (i + 1 < n && data[i + 1] == 0) {
      out[o++] = 0x80;
      i += 2;
    } else if (i + 2 < n) {
      const int64_t count = std::min<int64_t>(data[i + 1] + 1, total - o);
      std::memset(out + o, data[i + 2], count);
      o += count;
      i += 3;
    } else {
      break;
    }
  }
  info[0] = o;
  info[1] = i;
  return kOk;
}

// A Windows Paint v2 ("LinS") file's data after its 32-byte header,
// data[0:n): a map of `rows` little-endian 16-bit row lengths, then the
// rows, walked as PIL's MspDecoder walks them into one stream of bytes:
// a row of length 0 is `row_bytes` bytes of 0xFF; in a row, a byte 0 is
// followed by a count and a value (count copies), any other byte c by c
// literal bytes (as many of them as the row holds). The stream goes to
// out up to `total` bytes; info[0] counts all of it (rows are not held to
// row_bytes: a long row runs into the next, as PIL's does). Returns kOk;
// kTruncated where the map (info[1] = -1) or row info[1] runs past the
// data; kRowCorrupt where a run's count and value are cut by the end of
// row info[1].
int gm_msp_rle(const uint8_t* data, int64_t n, int64_t rows, int64_t row_bytes,
               int64_t total, uint8_t* out, int64_t* info) {
  int64_t o = 0;
  info[0] = 0;
  info[1] = -1;
  if (n < 2 * rows) return kTruncated;
  const auto put = [&](const uint8_t* src, int64_t count, int fill) {
    const int64_t room = std::max<int64_t>(0, std::min(count, total - o));
    if (room) {
      if (src)
        std::memcpy(out + o, src, room);
      else
        std::memset(out + o, fill, room);
    }
    o += count;
  };
  int64_t pos = 2 * rows;
  for (int64_t y = 0; y < rows; ++y) {
    const int64_t len = data[2 * y] | (data[2 * y + 1] << 8);
    info[1] = y;
    if (len == 0) {
      put(nullptr, row_bytes, 0xFF);
      continue;
    }
    if (pos + len > n) {
      info[0] = o;
      return kTruncated;
    }
    const uint8_t* row = data + pos;
    pos += len;
    for (int64_t k = 0; k < len;) {
      const int type = row[k++];
      if (type == 0) {
        if (k + 2 > len) {
          info[0] = o;
          return kRowCorrupt;
        }
        put(nullptr, row[k], row[k + 1]);
        k += 2;
      } else {
        put(row + k, std::min<int64_t>(type, len - k), 0);
        k += type;
      }
    }
  }
  info[0] = o;
  return kOk;
}


// An FLI / FLC frame, buf[0:n): PIL's `fli` decoder's one call on the bytes
// it has been handed so far, applied to the (height, width) plane `plane`
// (kept across calls). The frame's size (little-endian, unsigned) must be met,
// one pad byte aside, else kFliNeedMore; then each sub-chunk, whose reads
// are bounded by the frame's bytes left (not by the chunk's size): SS2 (7)
// and LC (12) deltas, BLACK (13), BRUN (15), COPY (16); palettes (4, 11)
// and the stamp (18) skipped. Returns kOk at the frame's end; kFliConsumed
// with info[0] the bytes before a COPY chunk the data cuts (PIL's decoder
// returns that count, then starts again there); kFliOverrun, kFliUnknown or
// kFliBroken where PIL's decoder fails with that code.
int gm_fli_frame(const uint8_t* buf, int64_t n, int64_t width, int64_t height,
                 uint8_t* plane, int64_t* info) {
  constexpr int kFliNeedMore = 1, kFliConsumed = 2, kFliOverrun = 3, kFliUnknown = 4,
                kFliBroken = 5;
  const auto u16 = [](const uint8_t* p) { return static_cast<int>(p[0] | p[1] << 8); };
  const auto i32 = [](const uint8_t* p) {
    return static_cast<int32_t>(static_cast<uint32_t>(p[0]) | static_cast<uint32_t>(p[1]) << 8 |
                                static_cast<uint32_t>(p[2]) << 16 |
                                static_cast<uint32_t>(p[3]) << 24);
  };
  info[0] = 0;
  if (n < 4) return kFliNeedMore;
  if (n + n % 2 < static_cast<int64_t>(static_cast<uint32_t>(i32(buf)))) return kFliNeedMore;
  if (n < 8) return kFliOverrun;
  if (u16(buf + 4) != 0xF1FA) return kFliUnknown;
  const int64_t w = width, h = height;
  const int chunks = u16(buf + 6);
  int64_t ptr = 16, left = n - 16;
  for (int c = 0; c < chunks; ++c) {
    if (left < 10) return kFliOverrun;
    const int64_t end = ptr + left;
    int64_t d = ptr + 6;
    switch (u16(buf + ptr + 4)) {
      case 4:
      case 11:
      case 18:
        break;
      case 7: {  // SS2: word deltas
        const int64_t lines = u16(buf + d);
        d += 2;
        int64_t y = 0, line = 0;
        for (; line < lines && y < h; ++line, ++y) {
          if (d + 2 > end) return kFliOverrun;
          int64_t packets = u16(buf + d);
          d += 2;
          uint8_t* row = plane + y * w;
          while (packets & 0x8000) {
            if (packets & 0x4000) {
              y += 65536 - packets;
              if (y >= h) return kFliOverrun;
              row = plane + y * w;
            } else {
              row[w - 1] = static_cast<uint8_t>(packets);
            }
            if (d + 2 > end) return kFliOverrun;
            packets = u16(buf + d);
            d += 2;
          }
          int64_t p = 0, x = 0;
          for (; p < packets; ++p) {
            if (d + 2 > end) return kFliOverrun;
            x += buf[d];
            if (buf[d + 1] >= 128) {
              if (d + 4 > end) return kFliOverrun;
              const int64_t i = 256 - buf[d + 1];
              if (x + 2 * i > w) break;
              for (int64_t j = 0; j < i; ++j) {
                row[x++] = buf[d + 2];
                row[x++] = buf[d + 3];
              }
              d += 4;
            } else {
              const int64_t i = 2 * static_cast<int64_t>(buf[d + 1]);
              if (x + i > w) break;
              if (d + 2 + i > end) return kFliOverrun;
              std::memcpy(row + x, buf + d + 2, i);
              d += 2 + i;
              x += i;
            }
          }
          if (p < packets) break;
        }
        if (line < lines) return kFliOverrun;
        break;
      }
      case 12: {  // LC: byte deltas
        int64_t y = u16(buf + d);
        const int64_t ymax = y + u16(buf + d + 2);
        d += 4;
        for (; y < ymax && y < h; ++y) {
          uint8_t* row = plane + y * w;
          if (d + 1 > end) return kFliOverrun;
          const int64_t packets = buf[d++];
          int64_t p = 0, x = 0, i = 0;
          for (; p < packets; ++p, x += i) {
            if (d + 2 > end) return kFliOverrun;
            x += buf[d];
            if (buf[d + 1] & 0x80) {
              i = 256 - buf[d + 1];
              if (x + i > w) break;
              if (d + 3 > end) return kFliOverrun;
              std::memset(row + x, buf[d + 2], i);
              d += 3;
            } else {
              i = buf[d + 1];
              if (x + i > w) break;
              if (d + 2 + i > end) return kFliOverrun;
              std::memcpy(row + x, buf + d + 2, i);
              d += 2 + i;
            }
          }
          if (p < packets) break;
        }
        if (y < ymax) return kFliOverrun;
        break;
      }
      case 13:  // BLACK
        std::memset(plane, 0, w * h);
        break;
      case 15:  // BRUN: byte runs
        for (int64_t y = 0; y < h; ++y) {
          uint8_t* row = plane + y * w;
          d += 1;  // the packet count, unread
          int64_t x = 0, i = 0;
          for (; x < w; x += i) {
            if (d + 2 > end) return kFliOverrun;
            if (buf[d] & 0x80) {
              i = 256 - buf[d];
              if (x + i > w) break;
              if (d + i + 1 > end) return kFliOverrun;
              std::memcpy(row + x, buf + d + 1, i);
              d += i + 1;
            } else {
              i = buf[d];
              if (x + i > w) break;
              std::memset(row + x, buf[d + 1], i);
              d += 2;
            }
          }
          if (x != w) return kFliOverrun;
        }
        break;
      case 16:  // COPY
        if (d + w * h > end) {
          info[0] = ptr;
          return kFliConsumed;
        }
        std::memcpy(plane, buf + d, w * h);
        break;
      default:
        return kFliUnknown;
    }
    const int32_t advance = i32(buf + ptr);
    if (advance == 0) return kFliBroken;
    if (advance < 0 || advance > left) return kFliOverrun;
    ptr += advance;
    left -= advance;
  }
  return kOk;
}

// BC1 (DXT1) blocks, data[0:n), decoded as PIL's `bcn` decoder (mode 1)
// decodes them into a (height, width, 4) RGBA image `out`: blocks of 8
// bytes, row-major over ceil(width / 4) x ceil(height / 4) 4 x 4 tiles;
// in each, two little-endian 565 colours (each channel's high bits
// replicated into its low ones), then 2-bit indices, pixel 0 in the low
// bits. c0 > c1 gives four opaque colours (c0, c1, (2 c0 + c1) / 3,
// (c0 + 2 c1) / 3); otherwise three and transparent black ((c0 + c1) / 2,
// then 0 0 0 0). The pixels past the right and bottom edges are dropped.
// Returns kOk, or kTruncated where the data holds fewer whole blocks than
// the image needs (info[0]: the blocks decoded).
int gm_bc1_decode(const uint8_t* data, int64_t n, int64_t width, int64_t height,
                  uint8_t* out, int64_t* info) {
  return bcn_decode(data, n, width, height, 1, 0, out, info);
}

// BCn blocks of `kind` (PIL's `bcn` decoder numbers: 1-7) decoded as
// `gm_bc1_decode` decodes BC1 into out (height, width, c): RGBA for BC1-BC3
// and BC7, L for BC4, RGB for BC5 (B 0, or 128 where signed) and BC6H
// (its 14 modes, unsigned or signed, to 8 bits as io/bcn.py says). BC2: 4-bit
// alphas x 17 then a four-colour BC1 block; BC3: a BC4 alpha block then
// the same; BC4: two ends, eight levels or six with 0 and 255, 3-bit
// indices; BC5: two BC4 blocks (R, G), their ends int8 + 128 where signed;
// BC7: its eight modes as PIL's `decode_bc7_block` reads them. flags: bit
// 0 BC5 / BC6H signed, bit 1 the 565 channels shifted up (BLP's own
// decoders).
// Returns kOk or kTruncated (info[0]: the blocks decoded).
int gm_bcn_decode(const uint8_t* data, int64_t n, int64_t width, int64_t height, int kind,
                  int flags, uint8_t* out, int64_t* info) {
  return bcn_decode(data, n, width, height, kind, flags, out, info);
}

}  // extern "C"
