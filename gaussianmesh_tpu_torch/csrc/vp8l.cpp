// Lossless WebP (VP8L) and WebP's alpha plane (ALPH), as libwebp 1.6 decodes
// them (the JAX reader opens dataset images with PIL, which reaches libwebp;
// the machines the port runs on have neither): the bit reader, the prefix
// codes, the colour cache, LZ77, the meta codes and the four transforms of
// `src/dec/vp8l_dec.c`, `src/utils/huffman_utils.c` and `src/dsp/lossless.c`,
// and the alpha filters of `src/dec/alpha_dec.c` / `src/dsp/filters.c`.
//
// - gm_vp8l_decode: a VP8L bitstream (the payload of a `VP8L` chunk, its pad
//   byte included, as libwebp's demuxer hands it on) -> ARGB pixels.
// - gm_alpha_decode: an `ALPH` chunk's payload -> the alpha plane of a
//   canvas: raw bytes or a header-less VP8L stream whose green is the
//   alpha, then the horizontal, vertical or gradient unfilter.
// - gm_vp8l_encode_image: one entropy-coded image (colour cache, meta codes,
//   prefix codes, LZ77 with plane-coded and long distances) appended to a
//   bit buffer; `io/vp8l.py` writes the header and the transforms around
//   it. For the tests and `chip_smoke.py`, which have no PIL to write WebPs
//   with.
//
// The end of the data: past the last byte the reader reads zeros (and, once
// its 64-bit window wraps, the window's own bits), and the end-of-stream
// flag is set and checked exactly where libwebp sets and checks it, so a
// file cut short raises, or decodes to other pixels, exactly where PIL does.
// A failure while the reader is past the end is reported as "cut short".
// `io/vp8l.py` holds the plain versions this file is held to byte for byte.
// The constant tables are the format's (the tests find each in libwebp's
// binary).
//
// Host code, not a TPU kernel: built by `ops/_cuda.py::host_library` with
// g++, loaded with ctypes.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <vector>

namespace {

// entry-point status codes (io/vp8l.py names them)
constexpr int kOk = 0;
constexpr int kCut = 1;             // the data ends before the image does
constexpr int kBadHeader = 2;       // signature or version
constexpr int kBadTransform = 3;    // a transform type met twice
constexpr int kBadCacheBits = 4;    // a colour cache of 0 or more than 11 bits
constexpr int kBadCode = 5;         // a prefix code libwebp refuses
constexpr int kBadCopy = 6;         // a backward reference before the start or past the end
constexpr int kBadAlphaHeader = 7;  // ALPH: compression, pre-processing or reserved bits
constexpr int kShortAlpha = 8;      // ALPH: no data, or raw data smaller than the canvas
constexpr int kNoRoom = 9;          // an encoder's output past its buffer

constexpr int NUM_LITERAL_CODES = 256;
constexpr int NUM_LENGTH_CODES = 24;
constexpr int NUM_DISTANCE_CODES = 40;
constexpr int CODE_TO_PLANE_CODES = 120;
constexpr int MAX_CACHE_BITS = 11;
constexpr int NUM_CODE_LENGTH_CODES = 19;
constexpr int MAX_CODE_LENGTH = 15;
constexpr int DEFAULT_CODE_LENGTH = 8;
constexpr int MAX_LENGTH = 4096;
constexpr uint32_t ARGB_BLACK = 0xff000000u;
constexpr uint32_t kHashMul = 0x1e35a7bdu;

enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };

// statistics slots (io/vp8l.py's STATS)
enum { S_PIXEL = 0, S_TRANSFORMS, S_ORDER, S_PRED_BITS, S_PRED_MODES, S_CROSS_BITS,
       S_PALETTE, S_PALETTE_BITS, S_CACHE_BITS, S_META_BITS, S_GROUPS, S_LITERALS,
       S_CACHE_HITS, S_COPIES, S_PLANE_COPIES, S_LONG_COPIES, S_SIMPLE1, S_SIMPLE2,
       S_NORMAL, S_REP16, S_REP17, S_REP18, S_MAX_SYMBOL, S_MAX_LEN, S_ALPHA_METHOD,
       S_ALPHA_FILTER, S_ALPHA_PRE, S_ALPHA_8B, NUM_STATS };

const uint8_t kCodeLengthCodeOrder[NUM_CODE_LENGTH_CODES] = {
    17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
const uint8_t kCodeLengthExtraBits[3] = {2, 3, 7};
const uint8_t kCodeLengthRepeatOffsets[3] = {3, 3, 11};
const uint16_t kAlphabetSize[5] = {NUM_LITERAL_CODES + NUM_LENGTH_CODES, 256, 256, 256,
                                   NUM_DISTANCE_CODES};
// distance codes 1-120 -> (dy << 4) | (8 - dx)
const uint8_t kCodeToPlane[CODE_TO_PLANE_CODES] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05,
    0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c,
    0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59,
    0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02,
    0x67, 0x69, 0x12, 0x1e, 0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b,
    0x32, 0x3e, 0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74,
    0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72,
    0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

inline int sub_sample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

// ------------------------------------------------------------ bit reader

// libwebp's VP8LBitReader: a 64-bit window `val` over bytes [pos - 8, pos),
// `bit_pos` bits of it consumed. Reads past the window see zeros until the
// shift count wraps (`bit_pos & 63`, as libwebp's prefetch).
struct BitReader {
  const uint8_t* buf;
  size_t len, pos;
  uint64_t val = 0;
  int bit_pos = 0;
  int eos = 0;

  BitReader(const uint8_t* b, size_t n) : buf(b), len(n) {
    const size_t k = std::min<size_t>(n, 8);
    for (size_t i = 0; i < k; ++i) val |= (uint64_t)b[i] << (8 * i);
    pos = k;
  }
  bool at_end() const { return eos || (pos == len && bit_pos > 64); }
  void set_end() { eos = 1; bit_pos = 0; }
  void shift() {
    while (bit_pos >= 8 && pos < len) {
      val >>= 8;
      val |= (uint64_t)buf[pos] << 56;
      ++pos;
      bit_pos -= 8;
    }
    if (at_end()) set_end();
  }
  uint32_t prefetch() const { return (uint32_t)(val >> (bit_pos & 63)); }
  void fill() { if (bit_pos >= 32) shift(); }
  uint32_t read(int n) {
    if (!eos && n <= 24) {
      const uint32_t v = prefetch() & ((1u << n) - 1);
      bit_pos += n;
      shift();
      return v;
    }
    set_end();
    return 0;
  }
};

// ------------------------------------------------------------ prefix codes

// A canonical prefix code: `single` >= 0 for a one-symbol code (reads no
// bits); else codes of up to 8 bits through a 256-entry table of the next 8
// bits, longer ones symbol by symbol (the first 8 bits from the window, the
// rest from the window 8 bits on, as libwebp's second-level lookup reads).
struct Code {
  int single = -1;
  int count[MAX_CODE_LENGTH + 1] = {0};
  std::vector<uint16_t> sorted;
  uint16_t root_sym[256];
  uint8_t root_len[256];
};

// libwebp's BuildHuffmanTable checks: -> kOk, or kBadCode for all-zero,
// over-subscribed or incomplete lengths (one used symbol is a code of 0 bits)
int build_code(const int* lengths, int n, Code* code) {
  int count[MAX_CODE_LENGTH + 1] = {0};
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > MAX_CODE_LENGTH) return kBadCode;
    ++count[lengths[s]];
  }
  if (count[0] == n) return kBadCode;
  int used = n - count[0];
  if (used == 1) {
    if (code != nullptr) {
      for (int s = 0; s < n; ++s)
        if (lengths[s]) code->single = s;
    }
    return kOk;
  }
  int left = 1;
  for (int len = 1; len <= MAX_CODE_LENGTH; ++len) {
    left <<= 1;
    left -= count[len];
    if (left < 0) return kBadCode;
  }
  if (left != 0) return kBadCode;
  if (code == nullptr) return kOk;
  std::memcpy(code->count, count, sizeof(count));
  code->count[0] = 0;
  code->sorted.clear();
  for (int len = 1; len <= MAX_CODE_LENGTH; ++len)
    for (int s = 0; s < n; ++s)
      if (lengths[s] == len) code->sorted.push_back((uint16_t)s);
  std::memset(code->root_len, 0, sizeof(code->root_len));
  int c = 0, k = 0;
  for (int len = 1; len <= MAX_CODE_LENGTH; ++len) {
    for (int i = 0; i < count[len]; ++i, ++c, ++k) {
      if (len <= 8) {
        int rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((c >> (len - 1 - b)) & 1) << b;
        for (int r = rev; r < 256; r += 1 << len) {
          code->root_sym[r] = code->sorted[k];
          code->root_len[r] = (uint8_t)len;
        }
      }
    }
    c <<= 1;
  }
  return kOk;
}

inline int read_symbol(BitReader& br, const Code& code) {
  if (code.single >= 0) return code.single;
  uint32_t v = br.prefetch();
  const int idx = v & 0xff;
  if (code.root_len[idx]) {
    br.bit_pos += code.root_len[idx];
    return code.root_sym[idx];
  }
  int c = 0, first = 0, index = 0;
  for (int len = 1; len <= 8; ++len) {
    c |= (v >> (len - 1)) & 1;
    first += code.count[len];
    index += code.count[len];
    first <<= 1;
    c <<= 1;
  }
  br.bit_pos += 8;
  v = br.prefetch();
  for (int len = 9; len <= MAX_CODE_LENGTH; ++len) {
    c |= (v >> (len - 9)) & 1;
    const int cnt = code.count[len];
    if (c - cnt < first) {
      br.bit_pos += len - 8;
      return code.sorted[index + (c - first)];
    }
    index += cnt;
    first += cnt;
    first <<= 1;
    c <<= 1;
  }
  return 0;                          // not reached: the code is complete
}

struct Group {
  Code codes[5];
};

// ------------------------------------------------------------ the decoder

struct Transform {
  int type = 0, bits = 0, xsize = 0;
  std::vector<uint32_t> data;
};

struct Decoder {
  BitReader br;
  int64_t* info;
  int width, height;
  unsigned seen = 0;
  std::vector<Transform> transforms;
  Decoder(const uint8_t* data, size_t n, int64_t* inf) : br(data, n), info(inf) {}
};

// ReadHuffmanCodeLengths + ReadHuffmanCode: -> kOk or a status
int read_code(Decoder& d, int alphabet, Code* code) {
  BitReader& br = d.br;
  std::vector<int> lengths(std::max(alphabet, 256), 0);
  const int simple = br.read(1);
  int ok = 1;
  if (simple) {
    const int num_symbols = br.read(1) + 1;
    const int first_bits = br.read(1) ? 8 : 1;
    lengths[br.read(first_bits)] = 1;
    if (num_symbols == 2) lengths[br.read(8)] = 1;
    ++d.info[num_symbols == 1 ? S_SIMPLE1 : S_SIMPLE2];
  } else {
    ++d.info[S_NORMAL];
    int ccl[NUM_CODE_LENGTH_CODES] = {0};
    const int num_codes = br.read(4) + 4;
    for (int i = 0; i < num_codes; ++i) ccl[kCodeLengthCodeOrder[i]] = br.read(3);
    Code lcode;
    ok = build_code(ccl, NUM_CODE_LENGTH_CODES, &lcode) == kOk;
    if (ok) {
      int max_symbol = alphabet;
      if (br.read(1)) {
        ++d.info[S_MAX_SYMBOL];
        const int length_nbits = 2 + 2 * br.read(3);
        max_symbol = 2 + br.read(length_nbits);
        if (max_symbol > alphabet) ok = 0;
      }
      int symbol = 0, prev = DEFAULT_CODE_LENGTH;
      while (ok && symbol < alphabet) {
        if (max_symbol-- == 0) break;
        br.fill();
        const int len = read_symbol(br, lcode);
        if (len < 16) {
          lengths[symbol++] = len;
          if (len != 0) prev = len;
        } else {
          const int slot = len - 16;
          ++d.info[S_REP16 + slot];
          const int repeat = br.read(kCodeLengthExtraBits[slot]) + kCodeLengthRepeatOffsets[slot];
          if (symbol + repeat > alphabet) {
            ok = 0;
          } else {
            const int v = len == 16 ? prev : 0;
            for (int r = 0; r < repeat; ++r) lengths[symbol++] = v;
          }
        }
      }
    }
  }
  ok = ok && !br.eos;
  if (!ok) return kBadCode;
  for (int s = 0; s < alphabet; ++s)
    d.info[S_MAX_LEN] = std::max<int64_t>(d.info[S_MAX_LEN], lengths[s]);
  return build_code(lengths.data(), alphabet, code);
}

inline int copy_value(int symbol, BitReader& br) {   // GetCopyDistance / GetCopyLength
  if (symbol < 4) return symbol + 1;
  const int extra = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra;
  return offset + br.read(extra) + 1;
}

inline int plane_to_distance(int xsize, int plane_code) {
  if (plane_code > CODE_TO_PLANE_CODES) return plane_code - CODE_TO_PLANE_CODES;
  const int dist_code = kCodeToPlane[plane_code - 1];
  const int yoffset = dist_code >> 4;
  const int xoffset = 8 - (dist_code & 0xf);
  const int dist = yoffset * xsize + xoffset;
  return dist >= 1 ? dist : 1;
}

struct Meta {
  int bits = 0, xsize = 0;
  std::vector<uint32_t> image;       // group per tile
  std::vector<Group> groups;
  std::vector<int> slot;             // group -> index into `groups`
  int cache_bits = 0;
  const Group& at(int x, int y) const {
    if (bits == 0) return groups[0];
    return groups[slot[image[(size_t)xsize * (y >> bits) + (x >> bits)]]];
  }
};

int decode_stream(Decoder& d, int xsize, int ysize, bool level0,
                  std::vector<uint32_t>& out, bool alpha);

// ReadHuffmanCodes: the meta codes' entropy image, then every group's five
// codes (groups that no tile uses are read and checked, not kept)
int read_codes(Decoder& d, int xsize, int ysize, int cache_bits, bool level0, Meta& m) {
  BitReader& br = d.br;
  int num_groups = 1;
  std::vector<char> used(1, 1);
  m.bits = 0;
  if (level0 && br.read(1)) {
    m.bits = 2 + br.read(3);
    m.xsize = sub_sample(xsize, m.bits);
    std::vector<uint32_t> img;
    const int st = decode_stream(d, m.xsize, sub_sample(ysize, m.bits), false, img, false);
    if (st) return st;
    m.image.resize(img.size());
    for (size_t i = 0; i < img.size(); ++i) {
      const int g = (img[i] >> 8) & 0xffff;
      m.image[i] = g;
      num_groups = std::max(num_groups, g + 1);
    }
    // libwebp keeps every group unless there are over 1000 or more than pixels
    const bool keep_all = num_groups <= 1000 && (int64_t)num_groups <= (int64_t)xsize * ysize;
    used.assign(num_groups, keep_all ? 1 : 0);
    for (uint32_t g : m.image) used[g] = 1;
    if (level0) {
      d.info[S_META_BITS] = m.bits;
      d.info[S_GROUPS] = num_groups;
    }
  }
  m.slot.assign(num_groups, -1);
  int kept = 0;
  for (int g = 0; g < num_groups; ++g)
    if (used[g]) m.slot[g] = kept++;
  m.groups.resize(kept);
  for (int g = 0; g < num_groups; ++g) {
    for (int j = 0; j < 5; ++j) {
      int alphabet = kAlphabetSize[j];
      if (j == 0 && cache_bits > 0) alphabet += 1 << cache_bits;
      const int st = read_code(d, alphabet, used[g] ? &m.groups[m.slot[g]].codes[j] : nullptr);
      if (st) return st;
    }
  }
  return kOk;
}

// DecodeImageData: the LZ77-coded pixels of one image, every read followed
// by libwebp's end-of-stream check
int decode_data(Decoder& d, const Meta& m, uint32_t* data, int width, int height) {
  BitReader& br = d.br;
  const int64_t total = (int64_t)width * height;
  int64_t pos = 0, last_cached = 0;
  int col = 0, row = 0;
  const int cache_size = m.cache_bits ? 1 << m.cache_bits : 0;
  std::vector<uint32_t> cache(cache_size, 0);
  const int shift = 32 - m.cache_bits;
  auto flush = [&]() {
    if (cache_size)
      while (last_cached < pos) {
        const uint32_t argb = data[last_cached++];
        cache[(argb * kHashMul) >> shift] = argb;
      }
  };
  int status = kOk;
  while (pos < total) {
    const Group& g = m.at(col, row);
    br.fill();
    const int code = read_symbol(br, g.codes[GREEN]);
    if (br.at_end()) break;
    if (code < NUM_LITERAL_CODES) {
      const int red = read_symbol(br, g.codes[RED]);
      br.fill();
      const int blue = read_symbol(br, g.codes[BLUE]);
      const int alpha = read_symbol(br, g.codes[ALPHA]);
      if (br.at_end()) break;
      data[pos++] = ((uint32_t)alpha << 24) | (red << 16) | (code << 8) | blue;
      ++d.info[S_LITERALS];
      if (++col >= width) {
        col = 0;
        ++row;
        flush();
      }
    } else if (code < NUM_LITERAL_CODES + NUM_LENGTH_CODES) {
      const int length = copy_value(code - NUM_LITERAL_CODES, br);
      const int dist_symbol = read_symbol(br, g.codes[DIST]);
      br.fill();
      const int dist_code = copy_value(dist_symbol, br);
      const int dist = plane_to_distance(width, dist_code);
      if (br.at_end()) break;
      if (pos < dist || total - pos < length) {
        status = kBadCopy;
        break;
      }
      for (int i = 0; i < length; ++i) data[pos + i] = data[pos + i - dist];
      ++d.info[S_COPIES];
      ++d.info[dist_code > CODE_TO_PLANE_CODES ? S_LONG_COPIES : S_PLANE_COPIES];
      pos += length;
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
      flush();
    } else {
      flush();
      data[pos++] = cache[code - NUM_LITERAL_CODES - NUM_LENGTH_CODES];
      ++d.info[S_CACHE_HITS];
      if (++col >= width) {
        col = 0;
        ++row;
        flush();
      }
    }
  }
  d.info[S_PIXEL] = pos;
  if (status) return status;
  br.eos = br.at_end();
  return br.eos ? kCut : kOk;
}

// DecodeAlphaData: an alpha stream that is one colour-indexing transform, no
// cache and one-symbol red, blue and alpha codes decodes green alone, and
// libwebp then only fails on the end of the data when pixels are left
int decode_alpha_8b(Decoder& d, const Meta& m, uint8_t* data, int width, int height) {
  BitReader& br = d.br;
  const int64_t end = (int64_t)width * height;
  int64_t pos = 0;
  int col = 0, row = 0, ok = 1;
  while (!br.eos && pos < end) {
    const Group& g = m.at(col, row);
    br.fill();
    const int code = read_symbol(br, g.codes[GREEN]);
    if (code < NUM_LITERAL_CODES) {
      data[pos++] = (uint8_t)code;
      ++d.info[S_LITERALS];
      if (++col >= width) {
        col = 0;
        ++row;
      }
    } else {
      const int length = copy_value(code - NUM_LITERAL_CODES, br);
      const int dist_symbol = read_symbol(br, g.codes[DIST]);
      br.fill();
      const int dist_code = copy_value(dist_symbol, br);
      const int dist = plane_to_distance(width, dist_code);
      if (pos >= dist && end - pos >= length) {
        for (int i = 0; i < length; ++i) data[pos + i] = data[pos + i - dist];
      } else {
        ok = 0;
        break;
      }
      ++d.info[S_COPIES];
      ++d.info[dist_code > CODE_TO_PLANE_CODES ? S_LONG_COPIES : S_PLANE_COPIES];
      pos += length;
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
    }
    br.eos = br.at_end();
  }
  br.eos = br.at_end();
  d.info[S_PIXEL] = pos;
  if (!ok) return kBadCopy;
  return (br.eos && pos < end) ? kCut : kOk;
}

// ReadTransform
int read_transform(Decoder& d, int* xsize) {
  BitReader& br = d.br;
  const int type = br.read(2);
  if (d.seen & (1u << type)) return kBadTransform;
  d.seen |= 1u << type;
  d.info[S_ORDER] |= (int64_t)type << (4 * d.info[S_TRANSFORMS]);
  ++d.info[S_TRANSFORMS];
  Transform t;
  t.type = type;
  t.xsize = *xsize;
  int st = kOk;
  if (type == PREDICTOR || type == CROSS_COLOR) {
    t.bits = br.read(3) + 2;
    d.info[type == PREDICTOR ? S_PRED_BITS : S_CROSS_BITS] = t.bits;
    st = decode_stream(d, sub_sample(t.xsize, t.bits), sub_sample(d.height, t.bits), false,
                       t.data, false);
  } else if (type == COLOR_INDEXING) {
    const int num_colors = br.read(8) + 1;
    t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
    d.info[S_PALETTE] = num_colors;
    d.info[S_PALETTE_BITS] = t.bits;
    *xsize = sub_sample(t.xsize, t.bits);
    std::vector<uint32_t> pal;
    st = decode_stream(d, num_colors, 1, false, pal, false);
    if (st == kOk) {                 // ExpandColorMap: delta-coded, zeros past the end
      const int final_num = 1 << (8 >> t.bits);
      std::vector<uint8_t> bytes(4 * (size_t)final_num, 0);
      const uint8_t* src = reinterpret_cast<const uint8_t*>(pal.data());
      for (int i = 0; i < 4; ++i) bytes[i] = src[i];
      for (int i = 4; i < 4 * num_colors; ++i) bytes[i] = (uint8_t)(src[i] + bytes[i - 4]);
      t.data.resize(final_num);
      std::memcpy(t.data.data(), bytes.data(), bytes.size());
    }
  }
  d.transforms.push_back(std::move(t));
  return st;
}

// DecodeImageStream: the transforms (level 0), the colour cache, the codes,
// then the pixels. `alpha`: the level-0 image of an ALPH stream, whose pixels
// may take libwebp's 8-bit path; `out` then holds one green byte a pixel.
int decode_stream(Decoder& d, int xsize, int ysize, bool level0,
                  std::vector<uint32_t>& out, bool alpha) {
  BitReader& br = d.br;
  int txsize = xsize;
  if (level0) {
    while (br.read(1)) {
      const int st = read_transform(d, &txsize);
      if (st) return st;
    }
  }
  Meta m;
  if (br.read(1)) {
    m.cache_bits = br.read(4);
    if (m.cache_bits < 1 || m.cache_bits > MAX_CACHE_BITS) return kBadCacheBits;
  }
  if (level0) d.info[S_CACHE_BITS] = m.cache_bits;
  int st = read_codes(d, txsize, ysize, m.cache_bits, level0, m);
  if (st) return st;
  if (alpha && d.transforms.size() == 1 && d.transforms[0].type == COLOR_INDEXING &&
      m.cache_bits == 0) {
    bool opt = true;
    for (const Group& g : m.groups)
      for (int j : {RED, BLUE, ALPHA})
        if (g.codes[j].single < 0) opt = false;
    if (opt) {
      d.info[S_ALPHA_8B] = 1;
      std::vector<uint8_t> idx((size_t)txsize * ysize);
      st = decode_alpha_8b(d, m, idx.data(), txsize, ysize);
      out.resize(idx.size());
      for (size_t i = 0; i < idx.size(); ++i) out[i] = (uint32_t)idx[i] << 8;
      return st;
    }
  }
  out.assign((size_t)txsize * ysize, 0);
  return decode_data(d, m, out.data(), txsize, ysize);
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
         (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }
inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {   // a = T, b = L, c = TL
  const int pa_minus_pb = sub3(a >> 24, b >> 24, c >> 24) +
                          sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                          sub3(a & 0xff, b & 0xff, c & 0xff);
  return pa_minus_pb <= 0 ? a : b;
}
inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline uint32_t clamped_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = (int)((c0 >> s) & 0xff) + (int)((c1 >> s) & 0xff) - (int)((c2 >> s) & 0xff);
    out |= (clip255((uint32_t)v) & 0xff) << s;
  }
  return out;
}
inline uint32_t clamped_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (ave >> s) & 0xff, b = (c2 >> s) & 0xff;
    out |= (clip255((uint32_t)(a + (a - b) / 2)) & 0xff) << s;
  }
  return out;
}

// libwebp's predictors 0-13; 14 and 15 are its padding sentinels, mode 0
inline uint32_t predict(int mode, const uint32_t* out, int i, int width) {
  const uint32_t L = out[i - 1], T = out[i - width], TL = out[i - width - 1],
                 TR = out[i - width + 1];
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select_pred(T, L, TL);
    case 12: return clamped_full(L, T, TL);
    case 13: return clamped_half(L, T, TL);
    default: return ARGB_BLACK;
  }
}

inline int delta(int8_t pred, int8_t color) { return ((int)pred * color) >> 5; }

// the inverse transforms, last read first -> the width x height image
void inverse_transforms(Decoder& d, std::vector<uint32_t>& img, int height) {
  for (int k = (int)d.transforms.size() - 1; k >= 0; --k) {
    const Transform& t = d.transforms[k];
    const int width = t.xsize;
    if (t.type == PREDICTOR) {
      std::vector<uint32_t> out(img.size());
      const int tiles = sub_sample(width, t.bits);
      for (int y = 0; y < height; ++y) {
        for (int x = 0; x < width; ++x) {
          const int i = y * width + x;
          uint32_t pred;
          if (y == 0) {
            pred = x == 0 ? ARGB_BLACK : out[i - 1];
          } else if (x == 0) {
            pred = out[i - width];
          } else {
            const int mode = (t.data[(y >> t.bits) * tiles + (x >> t.bits)] >> 8) & 0xf;
            d.info[S_PRED_MODES] |= 1 << mode;
            pred = predict(mode, out.data(), i, width);
          }
          out[i] = add_pixels(img[i], pred);
        }
      }
      img.swap(out);
    } else if (t.type == CROSS_COLOR) {
      const int tiles = sub_sample(width, t.bits);
      for (int y = 0; y < height; ++y) {
        for (int x = 0; x < width; ++x) {
          const uint32_t m = t.data[(y >> t.bits) * tiles + (x >> t.bits)];
          const uint32_t argb = img[y * width + x];
          const int8_t green = (int8_t)(argb >> 8);
          int new_red = (argb >> 16) & 0xff;
          int new_blue = argb & 0xff;
          new_red += delta((int8_t)(m & 0xff), green);
          new_red &= 0xff;
          new_blue += delta((int8_t)((m >> 8) & 0xff), green);
          new_blue += delta((int8_t)((m >> 16) & 0xff), (int8_t)new_red);
          new_blue &= 0xff;
          img[y * width + x] = (argb & 0xff00ff00u) | ((uint32_t)new_red << 16) | new_blue;
        }
      }
    } else if (t.type == SUBTRACT_GREEN) {
      for (uint32_t& p : img) {
        const uint32_t g = (p >> 8) & 0xff;
        p = (p & 0xff00ff00u) | ((((p & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu));
      }
    } else {
      const int in_width = sub_sample(width, t.bits);
      std::vector<uint32_t> out((size_t)width * height);
      const int bpp = 8 >> t.bits, mask = (1 << t.bits) - 1, pmask = (1 << bpp) - 1;
      for (int y = 0; y < height; ++y) {
        uint32_t packed = 0;
        for (int x = 0; x < width; ++x) {
          if ((x & mask) == 0) packed = (img[(size_t)y * in_width + (x >> t.bits)] >> 8) & 0xff;
          out[(size_t)y * width + x] = t.data[packed & pmask];
          packed >>= bpp;
        }
      }
      img.swap(out);
    }
  }
}

// ------------------------------------------------------------ alpha filters

void unfilter_alpha(uint8_t* a, int width, int height, int filter) {
  if (filter == 0) return;
  for (int y = 0; y < height; ++y) {
    uint8_t* out = a + (size_t)y * width;
    const uint8_t* prev = y ? out - width : nullptr;
    if (prev == nullptr || filter == 1) {           // horizontal (and every filter's row 0)
      uint8_t pred = prev == nullptr ? 0 : prev[0];
      for (int i = 0; i < width; ++i) {
        out[i] = (uint8_t)(pred + out[i]);
        pred = out[i];
      }
    } else if (filter == 2) {                        // vertical
      for (int i = 0; i < width; ++i) out[i] = (uint8_t)(prev[i] + out[i]);
    } else {                                         // gradient
      uint8_t top = prev[0], top_left = top, left = top;
      for (int i = 0; i < width; ++i) {
        top = prev[i];
        const int g = left + top - top_left;
        const int pred = (g & ~0xff) == 0 ? g : g < 0 ? 0 : 255;
        left = (uint8_t)(out[i] + pred);
        top_left = top;
        out[i] = left;
      }
    }
  }
}

// ------------------------------------------------------------ the encoder

struct BitWriter {
  uint8_t* buf;
  int64_t cap;
  int64_t pos;
  bool overflow = false;
  void put(uint32_t v, int n) {
    while (n > 0) {
      if ((pos >> 3) >= cap) {
        overflow = true;
        return;
      }
      const int b = pos & 7, take = std::min(8 - b, n);
      buf[pos >> 3] |= (uint8_t)((v & ((1u << take) - 1)) << b);
      v >>= take;
      n -= take;
      pos += take;
    }
  }
};

// code lengths of at most `limit` bits from counts (a Huffman tree, the
// counts raised to a growing floor until it fits); one used symbol gets 1
std::vector<int> code_lengths(const std::vector<uint64_t>& counts, int limit) {
  const int n = (int)counts.size();
  std::vector<int> lengths(n, 0);
  std::vector<int> used;
  for (int s = 0; s < n; ++s)
    if (counts[s]) used.push_back(s);
  if (used.empty()) return lengths;
  if (used.size() == 1) {
    lengths[used[0]] = 1;
    return lengths;
  }
  for (uint64_t floor = 1;; floor *= 2) {
    struct Node { uint64_t w; int parent; };
    std::vector<Node> nodes;
    typedef std::pair<uint64_t, int> Item;
    std::priority_queue<Item, std::vector<Item>, std::greater<Item>> heap;
    for (int s : used) {
      nodes.push_back({std::max(counts[s], floor), -1});
      heap.push({nodes.back().w, (int)nodes.size() - 1});
    }
    while (heap.size() > 1) {
      const Item a = heap.top(); heap.pop();
      const Item b = heap.top(); heap.pop();
      nodes.push_back({a.first + b.first, -1});
      const int p = (int)nodes.size() - 1;
      nodes[a.second].parent = p;
      nodes[b.second].parent = p;
      heap.push({nodes[p].w, p});
    }
    int deepest = 0;
    std::vector<int> depth(used.size());
    for (size_t i = 0; i < used.size(); ++i) {
      int dd = 0;
      for (int q = (int)i; nodes[q].parent >= 0; q = nodes[q].parent) ++dd;
      depth[i] = dd;
      deepest = std::max(deepest, dd);
    }
    if (deepest <= limit) {
      for (size_t i = 0; i < used.size(); ++i) lengths[used[i]] = depth[i];
      return lengths;
    }
  }
}

// a canonical code's bits per symbol, reversed for the LSB-first stream;
// a code of one used symbol writes nothing
struct WCode {
  std::vector<int> len;
  std::vector<uint32_t> bits;
  bool single = false;
  void make(const std::vector<int>& lengths) {
    len = lengths;
    bits.assign(len.size(), 0);
    int used = 0;
    for (int l : len) used += l > 0;
    single = used <= 1;
    int c = 0;
    for (int l = 1; l <= MAX_CODE_LENGTH; ++l) {
      for (size_t s = 0; s < len.size(); ++s) {
        if (len[s] != l) continue;
        uint32_t rev = 0;
        for (int b = 0; b < l; ++b) rev |= ((c >> (l - 1 - b)) & 1) << b;
        bits[s] = rev;
        ++c;
      }
      c <<= 1;
    }
  }
  void put(BitWriter& bw, int s) const {
    if (!single) bw.put(bits[s], len[s]);
  }
};

constexpr int kFlagLevel0 = 1;       // write the meta-code field
constexpr int kFlagMaxSymbol = 2;    // write max_symbol in normal codes
constexpr int kFlagNoSimple = 4;     // normal codes only

// one prefix code from its symbol counts: a simple code where 1 or 2 symbols
// below 256 are used, else a normal code with repeat codes 16 / 17 / 18
void write_code(BitWriter& bw, const std::vector<uint64_t>& counts, int flags,
                int64_t* stats, WCode& out) {
  const int n = (int)counts.size();
  std::vector<int> used;
  for (int s = 0; s < n; ++s)
    if (counts[s]) used.push_back(s);
  if (used.empty()) used.push_back(0);
  const bool simple = !(flags & kFlagNoSimple) && used.size() <= 2 && used.back() < 256;
  std::vector<int> lengths(n, 0);
  if (simple) {
    bw.put(1, 1);
    bw.put((uint32_t)used.size() - 1, 1);
    if (used[0] < 2) {
      bw.put(0, 1);
      bw.put(used[0], 1);
    } else {
      bw.put(1, 1);
      bw.put(used[0], 8);
    }
    if (used.size() == 2) bw.put(used[1], 8);
    for (int s : used) lengths[s] = 1;
    ++stats[used.size() == 1 ? S_SIMPLE1 : S_SIMPLE2];
    out.make(lengths);
    return;
  }
  ++stats[S_NORMAL];
  std::vector<uint64_t> c2 = counts;
  if (used.size() == 1 && c2[used[0]] == 0) c2[used[0]] = 1;
  lengths = code_lengths(c2, MAX_CODE_LENGTH);
  for (int l : lengths) stats[S_MAX_LEN] = std::max<int64_t>(stats[S_MAX_LEN], l);
  // the lengths as tokens (symbol, extra bits, extra value)
  struct Tok { int sym, nbits, value; bool zero; };
  std::vector<Tok> toks;
  int prev = DEFAULT_CODE_LENGTH;
  for (int i = 0; i < n;) {
    const int v = lengths[i];
    int run = 1;
    while (i + run < n && lengths[i + run] == v) ++run;
    i += run;
    if (v == 0) {
      while (run >= 3) {
        const int r = run >= 11 ? std::min(run, 138) : std::min(run, 10);
        toks.push_back(r >= 11 ? Tok{18, 7, r - 11, true} : Tok{17, 3, r - 3, true});
        run -= r;
      }
      for (; run > 0; --run) toks.push_back({0, 0, 0, true});
    } else {
      if (v != prev) {
        toks.push_back({v, 0, 0, false});
        prev = v;
        --run;
      }
      while (run >= 3) {
        const int r = std::min(run, 6);
        toks.push_back({16, 2, r - 3, false});
        run -= r;
      }
      for (; run > 0; --run) toks.push_back({v, 0, 0, false});
    }
  }
  int n_tok = (int)toks.size();
  bool use_max = false;
  if (flags & kFlagMaxSymbol) {
    int m = n_tok;
    while (m > 0 && toks[m - 1].zero) --m;
    if (m >= 2) {
      use_max = true;
      n_tok = m;
    }
  }
  std::vector<uint64_t> hist(NUM_CODE_LENGTH_CODES, 0);
  for (int i = 0; i < n_tok; ++i) ++hist[toks[i].sym];
  std::vector<int> ccl = code_lengths(hist, 7);
  WCode lcode;
  lcode.make(ccl);
  int n_ccl = NUM_CODE_LENGTH_CODES;
  while (n_ccl > 4 && ccl[kCodeLengthCodeOrder[n_ccl - 1]] == 0) --n_ccl;
  bw.put(0, 1);
  bw.put(n_ccl - 4, 4);
  for (int i = 0; i < n_ccl; ++i) bw.put(ccl[kCodeLengthCodeOrder[i]], 3);
  if (use_max) {
    int k = 0;
    while ((n_tok - 2) >= (1 << (2 + 2 * k))) ++k;
    bw.put(1, 1);
    bw.put(k, 3);
    bw.put(n_tok - 2, 2 + 2 * k);
    ++stats[S_MAX_SYMBOL];
  } else {
    bw.put(0, 1);
  }
  for (int i = 0; i < n_tok; ++i) {
    lcode.put(bw, toks[i].sym);
    if (toks[i].nbits) bw.put(toks[i].value, toks[i].nbits);
    if (toks[i].sym >= 16) ++stats[S_REP16 + toks[i].sym - 16];
  }
  out.make(lengths);
}

inline void prefix_encode(int value, int* code, int* nbits, int* extra) {
  const int d = value - 1;
  if (d < 4) {
    *code = d;
    *nbits = 0;
    *extra = 0;
    return;
  }
  int hb = 31 - __builtin_clz((unsigned)d);
  const int sb = (d >> (hb - 1)) & 1;
  *nbits = hb - 1;
  *extra = d & ((1 << *nbits) - 1);
  *code = 2 * hb + sb;
}

struct Token {
  uint8_t kind;                      // 0 literal, 1 cache, 2 copy
  uint32_t a, b;                     // argb | cache key | (length, distance code)
  int64_t pos;
};

int encode_image(const uint32_t* argb, int width, int height, int cache_bits, int lz77,
                 int meta_bits, const int32_t* groups, int flags, BitWriter& bw,
                 int64_t* stats) {
  const int64_t n = (int64_t)width * height;
  // the colour cache field
  if (cache_bits) {
    bw.put(1, 1);
    bw.put(cache_bits, 4);
  } else {
    bw.put(0, 1);
  }
  const int meta_xsize = groups ? sub_sample(width, meta_bits) : 0;
  int n_groups = 1;
  if (flags & kFlagLevel0) {
    if (groups) {
      const int tiles = meta_xsize * sub_sample(height, meta_bits);
      std::vector<uint32_t> img(tiles);
      for (int i = 0; i < tiles; ++i) {
        img[i] = ((uint32_t)groups[i] << 8) | ARGB_BLACK;
        n_groups = std::max(n_groups, groups[i] + 1);
      }
      bw.put(1, 1);
      bw.put(meta_bits - 2, 3);
      const int st = encode_image(img.data(), meta_xsize, sub_sample(height, meta_bits), 0,
                                  1, 0, nullptr, flags & ~kFlagLevel0, bw, stats);
      if (st) return st;
    } else {
      bw.put(0, 1);
    }
  }
  auto group_at = [&](int64_t p) -> int {
    if (!groups) return 0;
    const int x = (int)(p % width), y = (int)(p / width);
    return groups[(y >> meta_bits) * meta_xsize + (x >> meta_bits)];
  };
  // distance -> distance code: the smallest plane code giving it, else + 120
  const int64_t near = 8 * (int64_t)width + 8;
  std::vector<int> plane(near + 1, 0);
  for (int c = CODE_TO_PLANE_CODES; c >= 1; --c) {
    const int dist = plane_to_distance(width, c);
    if (dist <= near) plane[dist] = c;
  }
  // tokens: greedy LZ77 over three distances (the left pixel, the one above,
  // the one 16 rows up: plane-coded and long copies), then the cache
  std::vector<Token> toks;
  const int cache_size = cache_bits ? 1 << cache_bits : 0;
  std::vector<uint32_t> cache(cache_size, 0);
  const int cshift = 32 - cache_bits;
  auto insert = [&](int64_t p) {
    if (cache_size) cache[(argb[p] * kHashMul) >> cshift] = argb[p];
  };
  for (int64_t p = 0; p < n;) {
    int best_len = 0;
    int64_t best_dist = 0;
    if (lz77 && p + 1 < n) {
      const int64_t max_len = std::min<int64_t>(MAX_LENGTH, n - p);
      auto try_dist = [&](int64_t dist) {
        if (dist < 1 || dist > p) return;
        int len = 0;
        while (len < max_len && argb[p + len] == argb[p + len - dist]) ++len;
        if (len > best_len) {
          best_len = len;
          best_dist = dist;
        }
      };
      try_dist(1);
      try_dist(width);
      try_dist(16 * (int64_t)width);
    }
    if (best_len >= 3) {
      const int dcode = best_dist <= near && plane[best_dist]
                            ? plane[best_dist] : (int)best_dist + CODE_TO_PLANE_CODES;
      toks.push_back({2, (uint32_t)best_len, (uint32_t)dcode, p});
      for (int i = 0; i < best_len; ++i) insert(p + i);
      p += best_len;
      continue;
    }
    const uint32_t v = argb[p];
    if (cache_size && cache[(v * kHashMul) >> cshift] == v) {
      toks.push_back({1, (v * kHashMul) >> cshift, 0, p});
    } else {
      toks.push_back({0, v, 0, p});
    }
    insert(p);
    ++p;
  }
  // histograms per group
  const int green_size = NUM_LITERAL_CODES + NUM_LENGTH_CODES + cache_size;
  std::vector<std::vector<uint64_t>> hist(5 * (size_t)n_groups);
  for (int g = 0; g < n_groups; ++g)
    for (int j = 0; j < 5; ++j)
      hist[5 * g + j].assign(j == 0 ? green_size : kAlphabetSize[j], 0);
  for (const Token& t : toks) {
    std::vector<uint64_t>* h = &hist[5 * (size_t)group_at(t.pos)];
    if (t.kind == 0) {
      ++h[GREEN][(t.a >> 8) & 0xff];
      ++h[RED][(t.a >> 16) & 0xff];
      ++h[BLUE][t.a & 0xff];
      ++h[ALPHA][t.a >> 24];
    } else if (t.kind == 1) {
      ++h[GREEN][NUM_LITERAL_CODES + NUM_LENGTH_CODES + t.a];
    } else {
      int code, nb, ex;
      prefix_encode((int)t.a, &code, &nb, &ex);
      ++h[GREEN][NUM_LITERAL_CODES + code];
      prefix_encode((int)t.b, &code, &nb, &ex);
      ++h[DIST][code];
    }
  }
  std::vector<WCode> codes(5 * (size_t)n_groups);
  for (int g = 0; g < n_groups; ++g)
    for (int j = 0; j < 5; ++j) write_code(bw, hist[5 * g + j], flags, stats, codes[5 * g + j]);
  for (const Token& t : toks) {
    const WCode* c = &codes[5 * (size_t)group_at(t.pos)];
    if (t.kind == 0) {
      c[GREEN].put(bw, (t.a >> 8) & 0xff);
      c[RED].put(bw, (t.a >> 16) & 0xff);
      c[BLUE].put(bw, t.a & 0xff);
      c[ALPHA].put(bw, t.a >> 24);
      ++stats[S_LITERALS];
    } else if (t.kind == 1) {
      c[GREEN].put(bw, NUM_LITERAL_CODES + NUM_LENGTH_CODES + t.a);
      ++stats[S_CACHE_HITS];
    } else {
      int code, nb, ex;
      prefix_encode((int)t.a, &code, &nb, &ex);
      c[GREEN].put(bw, NUM_LITERAL_CODES + code);
      bw.put(ex, nb);
      prefix_encode((int)t.b, &code, &nb, &ex);
      c[DIST].put(bw, code);
      bw.put(ex, nb);
      ++stats[S_COPIES];
      ++stats[t.b > CODE_TO_PLANE_CODES ? S_LONG_COPIES : S_PLANE_COPIES];
    }
  }
  return bw.overflow ? kNoRoom : kOk;
}

}  // namespace

extern "C" {

// data, n: a VP8L bitstream (signature, 14-bit sizes, alpha bit, version,
// then the image); argb: width * height pixels (the caller read the sizes
// from the first 5 bytes); info: int64 statistics (io/vp8l.py's STATS)
int gm_vp8l_decode(const uint8_t* data, int64_t n, uint32_t* argb, int64_t* info) {
  std::memset(info, 0, sizeof(int64_t) * NUM_STATS);
  info[S_PIXEL] = -1;
  Decoder d(data, (size_t)n, info);
  BitReader& br = d.br;
  if (br.read(8) != 0x2f) return kBadHeader;
  d.width = br.read(14) + 1;
  d.height = br.read(14) + 1;
  br.read(1);
  if (br.read(3) != 0) return kBadHeader;
  if (br.eos) return kCut;
  std::vector<uint32_t> img;
  const int st = decode_stream(d, d.width, d.height, true, img, false);
  if (st) return br.at_end() ? kCut : st;      // a failure past the end: cut short
  inverse_transforms(d, img, d.height);
  std::memcpy(argb, img.data(), sizeof(uint32_t) * img.size());
  return kOk;
}

// data, n: an ALPH chunk's payload (header byte, then the data); width,
// height: the canvas; alpha: width * height bytes; info as gm_vp8l_decode's
int gm_alpha_decode(const uint8_t* data, int64_t n, int width, int height, uint8_t* alpha,
                    int64_t* info) {
  std::memset(info, 0, sizeof(int64_t) * NUM_STATS);
  info[S_PIXEL] = -1;
  if (n <= 1) return kShortAlpha;
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3,
            rsrv = data[0] >> 6;
  info[S_ALPHA_METHOD] = method;
  info[S_ALPHA_FILTER] = filter;
  info[S_ALPHA_PRE] = pre;
  if (method > 1 || pre > 1 || rsrv != 0) return kBadAlphaHeader;
  const int64_t size = (int64_t)width * height;
  if (method == 0) {
    if (n - 1 < size) return kShortAlpha;
    std::memcpy(alpha, data + 1, size);
  } else {
    Decoder d(data + 1, (size_t)(n - 1), info);
    d.width = width;
    d.height = height;
    std::vector<uint32_t> img;
    const int st = decode_stream(d, width, height, true, img, true);
    if (st) return d.br.at_end() ? kCut : st;
    inverse_transforms(d, img, height);
    for (int64_t i = 0; i < size; ++i) alpha[i] = (uint8_t)(img[i] >> 8);
  }
  unfilter_alpha(alpha, width, height, filter);
  return kOk;
}

// argb: width * height pixels; cache_bits 0-11; lz77 0/1; meta_bits 2-9 with
// groups (one per meta tile) or groups NULL; flags (kFlag*); the image is
// appended to out (cap bytes, zeroed) at bit *bitpos, which is advanced;
// stats accumulate as gm_vp8l_decode's info
int gm_vp8l_encode_image(const uint32_t* argb, int width, int height, int cache_bits,
                         int lz77, int meta_bits, const int32_t* groups, int flags,
                         uint8_t* out, int64_t cap, int64_t* bitpos, int64_t* stats) {
  BitWriter bw{out, cap, *bitpos};
  const int st = encode_image(argb, width, height, cache_bits, lz77, meta_bits, groups, flags,
                              bw, stats);
  *bitpos = bw.pos;
  return st;
}

}  // extern "C"
