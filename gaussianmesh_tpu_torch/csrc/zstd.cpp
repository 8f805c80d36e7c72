// Zstandard frames (RFC 8878), the codec of TIFF compression 50000, as
// libtiff's `ZSTDDecode` reads a strip through libzstd 1.5.7 (the JAX reader
// opens dataset images with PIL, which reaches libtiff; the machines the
// port runs on have neither, and Python 3.12 has no Zstandard module).
//
// - gm_zstd_decode: the first frame of a strip -> at most `size` bytes,
//   with libzstd's streaming rules (one pass where the header's content size
//   fits the output; otherwise the window limit, each block's limit, and a
//   stop once the output passes `size`); see `io/zstd.py`, whose
//   `decode_plain` this is held to byte for byte and status for status.
//   Every check sits where the plain walk has it.
// - gm_xxh64: XXH64 (the frame's content checksum is its low 32 bits).
// - gm_zstd_encode: one frame with its content size (single segment) and,
//   optionally, a checksum; per 128 KiB block a raw block where compressing
//   does not pay, an RLE block for one repeated byte, or a compressed block:
//   a greedy matcher over 4-byte hashes that tries the repeat offsets first,
//   literals Huffman-coded in 1 or 4 streams (weights direct or FSE-coded),
//   raw or RLE, and each sequence table FSE-coded, predefined or RLE, as
//   costs decide. For the tests and `chip_smoke.py`, which have no other
//   Zstandard writer; libzstd is its oracle in the tests.
//
// Host code, not a TPU kernel: built by `ops/_cuda.py::host_library` with
// g++, loaded with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// statuses (io/zstd.py's _ERRORS)
constexpr int kCut = 1, kMagic = 2, kReservedBit = 3, kWindowLog = 4, kWindow = 5,
              kDictionary = 6, kBlockType = 7, kBlockSize = 8, kOutput = 9,
              kLiterals = 10, kLiteralSize = 11, kTreeless = 12, kWeights = 13,
              kFseLog = 14, kFseSum = 15, kBitstream = 16, kSequences = 17,
              kRepeat = 18, kLiteralOverrun = 19, kOffset = 20, kContentSize = 21,
              kChecksum = 22, kLegacy = 23;
constexpr int kNoRoom = 24;                 // an encoder's output past its buffer

constexpr uint32_t kMagicNumber = 0xFD2FB528u;
constexpr uint32_t kSkippable = 0x184D2A50u, kSkippableMask = 0xFFFFFFF0u;
constexpr int64_t kWindowLimit = (int64_t(1) << 27) + 1;
constexpr int64_t kBlockMax = 1 << 17;
constexpr int64_t kWildcopy = 32;
constexpr int kHufLogMax = 12;

struct Error {
  int code;
  int64_t a, b;
};

[[noreturn]] void fail(int code, int64_t a = 0, int64_t b = 0) { throw Error{code, a, b}; }

uint64_t le(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

int bit_length(uint64_t v) { return v ? 64 - __builtin_clzll(v) : 0; }

// ---------------------------------------------------------------- tables
const int kLLBase[36] = {0,  1,  2,   3,   4,   5,   6,    7,    8,    9,     10,    11,
                         12, 13, 14,  15,  16,  18,  20,   22,   24,   28,    32,    40,
                         48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const int kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  1,  1,
                         1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,
                         17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,   30,
                         31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,   83,
                         99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const int kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                         0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                         2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
// per table (LL, OF, ML, Huffman weights): largest symbol, largest accuracy log
const int kMaxSymbol[4] = {35, 31, 52, 255};
const int kMaxLog[4] = {9, 8, 9, 6};

struct Cell {
  uint8_t sym, bits;
  int32_t base;
};

struct Fse {
  int log = 0;
  std::vector<Cell> cells;
};

// normalized counts (-1: "less than 1") -> the decoding table (RFC 8878 4.1.1)
Fse fse_table(const int16_t* norm, int nsym, int log) {
  int size = 1 << log, high = size - 1;
  std::vector<int> sym(size, 0), nxt(nsym);
  for (int s = 0; s < nsym; ++s) {
    nxt[s] = norm[s];
    if (norm[s] == -1) {
      sym[high--] = s;
      nxt[s] = 1;
    }
  }
  int pos = 0, step = (size >> 1) + (size >> 3) + 3;
  for (int s = 0; s < nsym; ++s)
    for (int i = 0; i < norm[s]; ++i) {
      sym[pos] = s;
      do pos = (pos + step) & (size - 1);
      while (pos > high);
    }
  Fse t;
  t.log = log;
  t.cells.resize(size);
  for (int u = 0; u < size; ++u) {
    int s = sym[u], state = nxt[s]++;
    int bits = log - (bit_length(state) - 1);
    t.cells[u] = Cell{uint8_t(s), uint8_t(bits), (state << bits) - size};
  }
  return t;
}

const Fse& predefined(int which) {
  static const Fse tables[3] = {fse_table(kLLDefault, 36, 6), fse_table(kOFDefault, 29, 5),
                                fse_table(kMLDefault, 53, 6)};
  return tables[which];
}

// ---------------------------------------------------------------- bits
// A bit stream read backward from its last byte's highest set bit; `left`
// bits remain. Past the start a read gives 0 and a lookup the bits of
// libzstd's 64-bit container (BIT_lookBitsFast, shifts taken mod 64).
struct Back {
  const uint8_t* d = nullptr;
  int64_t len = 0, left = 0;
  uint64_t first = 0;

  void init(const uint8_t* p, int64_t n) {
    if (n <= 0 || p[n - 1] == 0) fail(kBitstream);
    init_left(p, n, 8 * n - 9 + bit_length(p[n - 1]));
  }
  void init_left(const uint8_t* p, int64_t n, int64_t l) {
    d = p;
    len = n;
    left = l;
    first = le(p, int(std::min<int64_t>(n, 8)));
  }
  // bits [lo, lo + n) of the stream, n <= 32
  uint64_t extract(int64_t lo, int n) const {
    int64_t i = lo >> 3;
    uint64_t v;
    if (i + 8 <= len) {
      std::memcpy(&v, d + i, 8);  // little-endian hosts (x86-64, aarch64)
    } else {
      v = le(d + i, int(len - i));
    }
    return (v >> (lo & 7)) & ((uint64_t(1) << n) - 1);
  }
  uint64_t read(int n) {
    int64_t l = left;
    left -= n;
    if (l < n || n == 0) return 0;
    return extract(l - n, n);
  }
  uint32_t peek(int n) const {
    if (left >= n) return uint32_t(extract(left - n, n));
    if (left <= 0) return uint32_t((first << ((-left) & 63)) >> (64 - n));
    return uint32_t((first & ((uint64_t(1) << left) - 1)) << (n - left));
  }
};

// An FSE table description at d[pos, end) (libzstd's FSE_readNCount: fields
// LSB first, zeros past `end`) -> its decoding table; `pos` moves past it.
Fse read_ncount(const uint8_t* d, int64_t& pos, int64_t end, int which) {
  int max_symbol = kMaxSymbol[which], max_log = kMaxLog[which];
  int64_t bit = 4;
  int log = (pos < end ? d[pos] & 15 : 0) + 5;
  if (log > max_log) fail(kFseLog, log, max_log);
  auto field = [&](int width) -> int {
    int64_t at = pos * 8 + bit;
    int64_t i = at >> 3, j = std::min(end, (at + width + 7) >> 3);
    uint64_t v = j > i ? le(d + i, int(j - i)) : 0;
    return int((v >> (at & 7)) & ((uint64_t(1) << width) - 1));
  };
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  int16_t norm[256] = {0};
  int64_t count_n = 0;
  bool previous0 = false;
  while (remaining > 1 && count_n <= max_symbol) {
    if (previous0) {
      while (true) {
        int rep = field(2);
        bit += 2;
        count_n += rep;
        if (rep != 3) break;
      }
      if (count_n > max_symbol) break;
    }
    int v = field(nbits), top = 2 * threshold - 1 - remaining, count;
    if ((v & (threshold - 1)) < top) {
      count = v & (threshold - 1);
      bit += nbits - 1;
    } else {
      count = v & (2 * threshold - 1);
      if (count >= threshold) count -= top;
      bit += nbits;
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    norm[count_n++] = int16_t(count);
    previous0 = count == 0;
    while (remaining < threshold && remaining > 1) {
      nbits -= 1;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || count_n > max_symbol + 1) fail(kFseSum);
  int64_t after = pos + ((bit + 7) >> 3);
  if (after > end) fail(kFseSum);
  pos = after;
  return fse_table(norm, int(count_n), log);
}

// ---------------------------------------------------------------- literals
struct Huffman {
  int log = 0;
  std::vector<uint16_t> entry;  // per table entry: symbol | code bits << 8
};

struct State {
  bool have_huffman = false, fse_entropy = false;
  Huffman huffman;
  Fse tables[3];
  uint64_t rep[3] = {1, 4, 8};
};

// FSE-coded Huffman weights: two states over one backward stream until a
// state update reads past its start, 255 weights at most
std::vector<int> fse_weights(const uint8_t* d, int64_t n) {
  int64_t pos = 0;
  Fse t = read_ncount(d, pos, n, 3);
  Back bits;
  bits.init(d + pos, n - pos);
  uint64_t s[2];
  s[0] = bits.read(t.log);
  s[1] = bits.read(t.log);
  if (bits.left < 0) fail(kBitstream);
  std::vector<int> out;
  while (true)
    for (int a = 0; a < 2; ++a) {
      if (out.size() > 253) fail(kWeights);
      const Cell& c = t.cells[s[a]];
      out.push_back(c.sym);
      s[a] = c.base + bits.read(c.bits);
      if (bits.left < 0) {
        out.push_back(t.cells[s[1 - a]].sym);
        return out;
      }
    }
}

// a Huffman tree description at d[pos, end) -> the table; `pos` moves past it
void read_huffman(const uint8_t* d, int64_t& pos, int64_t end, Huffman& h) {
  if (pos >= end) fail(kLiterals);
  int head = d[pos];
  std::vector<int> w;
  int64_t size;
  if (head >= 128) {
    int n = head - 127;
    size = (n + 1) / 2;
    if (pos + 1 + size > end) fail(kLiterals);
    for (int64_t i = 0; i < size; ++i) {
      w.push_back(d[pos + 1 + i] >> 4);
      w.push_back(d[pos + 1 + i] & 15);
    }
    w.resize(n);
  } else {
    size = head;
    if (pos + 1 + size > end) fail(kLiterals);
    w = fse_weights(d + pos + 1, size);
  }
  pos += 1 + size;
  int64_t total = 0;
  for (int x : w) {
    if (x > kHufLogMax) fail(kWeights);
    total += (int64_t(1) << x) >> 1;
  }
  if (total == 0) fail(kWeights);
  int log = bit_length(uint64_t(total));
  if (log > kHufLogMax) fail(kWeights);
  int64_t rest = (int64_t(1) << log) - total;
  if (rest & (rest - 1)) fail(kWeights);
  w.push_back(bit_length(uint64_t(rest)));
  int ones = 0;
  for (int x : w) ones += x == 1;
  if (ones < 2 || ones & 1) fail(kWeights);
  h.log = log;
  h.entry.assign(size_t(1) << log, 0);
  int64_t at = 0;
  for (int v = 1; v <= log; ++v)
    for (size_t s = 0; s < w.size(); ++s)
      if (w[s] == v) {
        int64_t span = int64_t(1) << (v - 1);
        for (int64_t k = 0; k < span; ++k) {
          h.entry[at + k] = uint16_t(s | (log + 1 - v) << 8);
        }
        at += span;
      }
}

void huffman_stream(const uint8_t* d, int64_t n, const Huffman& h, int64_t count,
                    uint8_t* out) {
  Back bits;
  bits.init(d, n);
  for (int64_t i = 0; i < count; ++i) {
    uint16_t e = h.entry[bits.peek(h.log)];
    out[i] = uint8_t(e);
    bits.left -= e >> 8;
  }
  if (bits.left != 0) fail(kBitstream);
}

// libzstd's fast 4-stream decoder (io/zstd.py::_huffman_fast)
void huffman_fast(const uint8_t* d, const int64_t ends[4], const Huffman& h, int64_t size,
                  uint8_t* out) {
  int64_t seg = (size + 3) / 4;
  int64_t counts[4] = {seg, seg, seg, size - 3 * seg};
  std::vector<int64_t> used[4];
  for (int i = 0; i < 4; ++i) {
    int last = d[ends[i] - 1];
    Back bits;
    bits.init_left(d, ends[i], 8 * ends[i] - (last ? 9 - bit_length(last) : 0));
    used[i].push_back(8 * ends[i] - bits.left);
    for (int64_t j = 0; j < counts[i]; ++j) {
      uint16_t e = h.entry[bits.peek(h.log)];
      *out++ = uint8_t(e);
      bits.left -= e >> 8;
      if (j % 5 == 4) used[i].push_back(8 * ends[i] - bits.left);
    }
  }
  int64_t k = 0;
  while (true) {
    int64_t ip[4];
    for (int i = 0; i < 4; ++i) ip[i] = ends[i] - 8 - (used[i][k] >> 3);
    int64_t iters = std::min((counts[3] - 5 * k) / 5, ip[0] / 7);
    if (iters == 0 || ip[1] < ip[0] || ip[2] < ip[1] || ip[3] < ip[2]) break;
    k += iters;
  }
  int64_t starts[4] = {6, ends[0], ends[1], ends[2]};
  for (int i = 0; i < 4; ++i)
    if ((used[i][k] >> 3) > ends[i] - starts[i]) fail(kBitstream);
}

// the literals section at the start of the block -> the literals; returns
// the position after the section
int64_t read_literals(const uint8_t* b, int64_t n, State& st, int64_t lit_limit,
                      std::vector<uint8_t>& lits) {
  if (n < 2) fail(kLiterals);
  int kind = b[0] & 3, fmt = b[0] >> 2 & 3;
  if (kind < 2) {
    int64_t head, size;
    if (fmt == 0 || fmt == 2) {
      head = 1;
      size = b[0] >> 3;
    } else if (fmt == 1) {
      if (kind == 1 && n < 3) fail(kLiterals);
      head = 2;
      size = int64_t(le(b, 2) >> 4);
    } else {
      if (n < 3 + kind) fail(kLiterals);
      head = 3;
      size = int64_t(le(b, 3) >> 4);
    }
    if (size > lit_limit) fail(kLiteralSize, size, lit_limit);
    if (kind == 1) {
      lits.assign(size_t(size), b[head]);
      return head + 1;
    }
    if (head + size > n) fail(kLiterals);
    lits.assign(b + head, b + head + size);
    return head + size;
  }
  if (kind == 3 && !st.have_huffman) fail(kTreeless);
  if (n < 5) fail(kLiterals);
  uint64_t h = le(b, 5);
  int64_t head, size, csize;
  if (fmt < 2) {
    head = 3;
    size = h >> 4 & 0x3FF;
    csize = h >> 14 & 0x3FF;
  } else if (fmt == 2) {
    head = 4;
    size = h >> 4 & 0x3FFF;
    csize = h >> 18 & 0x3FFF;
  } else {
    head = 5;
    size = h >> 4 & 0x3FFFF;
    csize = h >> 22 & 0x3FFFF;
  }
  if (size > lit_limit) fail(kLiteralSize, size, lit_limit);
  int streams = fmt == 0 ? 1 : 4;
  if (streams == 4 && size < 6) fail(kLiterals);
  int64_t end = head + csize;
  if (end > n) fail(kLiterals);
  int64_t pos = head;
  if (kind == 2) {
    if (csize == 0) fail(kLiterals);
    read_huffman(b, pos, end, st.huffman);
    st.have_huffman = true;
    if (pos >= end) fail(kLiterals);
  }
  const Huffman& hf = st.huffman;
  lits.resize(size_t(size));
  if (streams == 1) {
    huffman_stream(b + pos, end - pos, hf, size, lits.data());
  } else {
    if (end - pos < 10) fail(kLiterals);
    int64_t l[4];
    for (int i = 0; i < 3; ++i) l[i] = int64_t(le(b + pos + 2 * i, 2));
    if (l[0] + l[1] + l[2] > end - pos - 6) fail(kLiterals);
    l[3] = end - pos - 6 - l[0] - l[1] - l[2];
    int64_t seg = (size + 3) / 4, ends[4], at = 6;
    for (int i = 0; i < 4; ++i) ends[i] = at += l[i];
    if (hf.log <= 11 && std::min({l[0], l[1], l[2], l[3]}) >= 8 && 3 * seg < size) {
      huffman_fast(b + pos, ends, hf, size, lits.data());
    } else {
      for (int i = 0; i < 4; ++i)
        huffman_stream(b + pos + ends[i] - l[i], l[i], hf, i < 3 ? seg : size - 3 * seg,
                       lits.data() + i * seg);
    }
  }
  return end;
}

// ---------------------------------------------------------------- sequences
const Fse& seq_table(const uint8_t* b, int64_t& pos, int64_t end, int mode, int which,
                     State& st) {
  if (mode == 0) {
    st.tables[which] = predefined(which);
  } else if (mode == 1) {
    if (pos >= end) fail(kSequences);
    if (b[pos] > kMaxSymbol[which]) fail(kSequences);
    Fse t;
    t.cells.assign(1, Cell{b[pos], 0, 0});
    st.tables[which] = t;
    pos += 1;
  } else if (mode == 2) {
    st.tables[which] = read_ncount(b, pos, end, which);
  } else if (!st.fse_entropy) {
    fail(kRepeat);
  }
  return st.tables[which];
}

// a compressed block appended to `out`, at most `cap` bytes
void read_block(const uint8_t* b, int64_t n, std::vector<uint8_t>& out, State& st,
                int64_t cap, int64_t bsm) {
  std::vector<uint8_t> lits;
  int64_t pos = read_literals(b, n, st, std::min(bsm, cap), lits);
  if (pos >= n) fail(kSequences);
  int64_t nseq = b[pos++];
  if (nseq > 127) {
    if (nseq == 255) {
      if (pos + 2 > n) fail(kSequences);
      nseq = int64_t(le(b + pos, 2)) + 0x7F00;
      pos += 2;
    } else {
      if (pos >= n) fail(kSequences);
      nseq = ((nseq - 128) << 8) + b[pos++];
    }
  }
  int64_t start = int64_t(out.size());
  if (nseq == 0) {
    if (pos != n) fail(kSequences);
    if (int64_t(lits.size()) > cap) fail(kOutput, cap);
    out.insert(out.end(), lits.begin(), lits.end());
    return;
  }
  if (pos >= n || b[pos] & 3) fail(kSequences);
  int modes = b[pos++];
  const Fse& ll = seq_table(b, pos, n, modes >> 6, 0, st);
  const Fse& of = seq_table(b, pos, n, modes >> 4 & 3, 1, st);
  const Fse& ml = seq_table(b, pos, n, modes >> 2 & 3, 2, st);
  st.fse_entropy = true;
  Back bits;
  bits.init(b + pos, n - pos);
  uint64_t s_ll = bits.read(ll.log), s_of = bits.read(of.log), s_ml = bits.read(ml.log);
  uint64_t* rep = st.rep;
  int64_t lit = 0, nlit = int64_t(lits.size());
  for (int64_t i = 0; i < nseq; ++i) {
    const Cell& cl = ll.cells[s_ll];
    const Cell& co = of.cells[s_of];
    const Cell& cm = ml.cells[s_ml];
    int ll_base = kLLBase[cl.sym], ll_bits = kLLBits[cl.sym];
    int ml_base = kMLBase[cm.sym], ml_bits = kMLBits[cm.sym];
    bool ll0 = ll_base == 0;
    int of_code = co.sym;
    uint64_t offset;
    if (of_code > 1) {
      offset = (uint64_t(1) << of_code) - 3 + bits.read(of_code);
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = offset;
    } else if (of_code == 0) {
      offset = ll0 ? rep[1] : rep[0];
      if (ll0) {
        rep[1] = rep[0];
        rep[0] = offset;
      }
    } else {
      int idx = 1 + ll0 + int(bits.read(1));
      offset = idx == 3 ? rep[0] - 1 : rep[idx];
      if (offset == 0) offset = ~uint64_t(0);
      if (idx != 1) rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = offset;
    }
    int64_t mlen = ml_base + (ml_bits ? int64_t(bits.read(ml_bits)) : 0);
    int64_t llen = ll_base + (ll_bits ? int64_t(bits.read(ll_bits)) : 0);
    if (i != nseq - 1) {
      s_ll = cl.base + bits.read(cl.bits);
      s_ml = cm.base + bits.read(cm.bits);
      s_of = co.base + bits.read(co.bits);
    }
    if (llen > nlit - lit) fail(kLiteralOverrun);
    if (int64_t(out.size()) - start + llen + mlen > cap) fail(kOutput, cap);
    out.insert(out.end(), lits.begin() + lit, lits.begin() + lit + llen);
    lit += llen;
    int64_t have = int64_t(out.size());
    if (offset > uint64_t(have)) fail(kOffset, int64_t(offset), have);
    size_t src = size_t(have - int64_t(offset));
    out.resize(size_t(have + mlen));
    uint8_t* o = out.data();
    if (int64_t(offset) >= mlen) {
      std::memcpy(o + have, o + src, size_t(mlen));
    } else {
      for (int64_t k = 0; k < mlen; ++k) o[have + k] = o[src + k];
    }
  }
  if (bits.left != 0) fail(kBitstream);
  if (int64_t(out.size()) - start + nlit - lit > cap) fail(kOutput, cap);
  out.insert(out.end(), lits.begin() + lit, lits.end());
}

// ---------------------------------------------------------------- XXH64
constexpr uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
                   P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
                   P5 = 0x27D4EB2F165667C5ull;

uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
uint64_t round1(uint64_t acc, uint64_t lane) { return rotl(acc + lane * P2, 31) * P1; }

uint64_t xxh64(const uint8_t* p, int64_t n, uint64_t seed) {
  int64_t pos = 0;
  uint64_t h;
  if (n >= 32) {
    uint64_t v[4] = {seed + P1 + P2, seed + P2, seed, seed - P1};
    for (; pos + 32 <= n; pos += 32)
      for (int i = 0; i < 4; ++i) v[i] = round1(v[i], le(p + pos + 8 * i, 8));
    h = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18);
    for (int i = 0; i < 4; ++i) h = (h ^ round1(0, v[i])) * P1 + P4;
  } else {
    h = seed + P5;
  }
  h += uint64_t(n);
  for (; pos + 8 <= n; pos += 8) {
    h ^= round1(0, le(p + pos, 8));
    h = rotl(h, 27) * P1 + P4;
  }
  if (pos + 4 <= n) {
    h ^= le(p + pos, 4) * P1;
    h = rotl(h, 23) * P2 + P3;
    pos += 4;
  }
  for (; pos < n; ++pos) {
    h ^= p[pos] * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

// ---------------------------------------------------------------- frame
struct Header {
  int64_t size = 0, window = 0, fcs = -1;
  int checksum = 0;
  bool skippable = false;
};

Header read_header(const uint8_t* d, int64_t n) {
  Header h;
  if (n < 5) {
    uint8_t m[4], s[4];
    for (int i = 0; i < 4; ++i) {
      m[i] = i < n ? d[i] : uint8_t(kMagicNumber >> (8 * i));
      s[i] = i < n ? d[i] : uint8_t(kSkippable >> (8 * i));
    }
    if (le(m, 4) != kMagicNumber && (le(s, 4) & kSkippableMask) != kSkippable) {
      uint8_t z[4] = {0, 0, 0, 0};
      for (int i = 0; i < n && i < 4; ++i) z[i] = d[i];
      fail(kMagic, int64_t(uint32_t(z[0]) << 24 | z[1] << 16 | z[2] << 8 | z[3]));
    }
    fail(kCut);
  }
  uint32_t magic = uint32_t(le(d, 4));
  if ((magic & kSkippableMask) == kSkippable) {
    if (n < 8 || 8 + int64_t(le(d + 4, 4)) > n) fail(kCut);
    h.skippable = true;
    return h;
  }
  if (magic == 0xFD2FB526u || magic == 0xFD2FB527u) fail(kLegacy, magic & 15);
  if (magic != kMagicNumber)
    fail(kMagic, int64_t(uint32_t(d[0]) << 24 | d[1] << 16 | d[2] << 8 | d[3]));
  int fhd = d[4], single = fhd >> 5 & 1;
  const int did_sizes[4] = {0, 1, 2, 4};
  int did_size = did_sizes[fhd & 3];
  const int fcs_sizes[4] = {single, 2, 4, 8};
  int fcs_size = fcs_sizes[fhd >> 6];
  h.size = 5 + (1 - single) + did_size + fcs_size;
  if (n < h.size) fail(kCut);
  if (fhd & 8) fail(kReservedBit);
  int64_t pos = 5;
  if (!single) {
    int log = (d[5] >> 3) + 10;
    if (log > 31) fail(kWindowLog, log);
    h.window = (int64_t(1) << log) + ((int64_t(1) << log) >> 3) * (d[5] & 7);
    pos = 6;
  }
  uint64_t did = le(d + pos, did_size);
  pos += did_size;
  uint64_t fcs = le(d + pos, fcs_size) + (fcs_size == 2 ? 256 : 0);
  if (single) h.window = int64_t(fcs);
  if (did) fail(kDictionary, int64_t(did));
  h.fcs = fcs_size ? int64_t(fcs) : -1;
  h.checksum = fhd >> 2 & 1;
  return h;
}

// libzstd's walk over the block headers: is the whole frame in d[0, n)?
bool whole_frame(const uint8_t* d, int64_t n, int64_t pos, int checksum) {
  while (true) {
    if (pos + 3 > n) return false;
    uint32_t h = uint32_t(le(d + pos, 3));
    int kind = h >> 1 & 3;
    if (kind == 3) return false;
    pos += 3 + (kind == 1 ? 1 : int64_t(h >> 3));
    if (pos > n) return false;
    if (h & 1) return pos + 4 * checksum <= n;
  }
}

// the frame's output (its first `size` bytes count) -> the bytes returned
int64_t decode_frame(const uint8_t* d, int64_t n, int64_t size, std::vector<uint8_t>& out) {
  Header hd = read_header(d, n);
  if (hd.skippable) return 0;
  int64_t bsm = std::min(hd.window, kBlockMax);
  bool one_pass = hd.fcs >= 0 && hd.fcs <= size && whole_frame(d, n, hd.size, hd.checksum);
  int64_t window = std::max<int64_t>(hd.window, 1024);
  if (!one_pass && window > kWindowLimit) fail(kWindow, window);
  int64_t ring = window + 2 * bsm + 2 * kWildcopy;
  bool fcs_limited = hd.fcs >= 0 && hd.fcs <= ring;
  State st;
  out.reserve(size_t(std::min<int64_t>(size, int64_t(1) << 30) + kBlockMax));
  int64_t pos = hd.size;
  auto more = [&]() -> int64_t {  // libzstd waits for input that never comes
    if (int64_t(out.size()) < size) fail(kCut);
    return size;
  };
  while (true) {
    if (pos + 3 > n) return more();
    uint32_t h = uint32_t(le(d + pos, 3));
    int last = h & 1, kind = h >> 1 & 3;
    int64_t bsize = h >> 3;
    if (kind == 3) fail(kBlockType);
    int64_t csize = kind == 1 ? 1 : bsize;
    pos += 3;
    int64_t cap, have = int64_t(out.size());
    if (one_pass) {
      cap = size - have;
    } else {
      if (csize > bsm) fail(kBlockSize, csize, bsm);
      cap = fcs_limited ? std::min(bsm, hd.fcs - have) : bsm;
      if (csize == 0) {  // libzstd skips an empty block
        if (last) break;
        continue;
      }
    }
    if (kind == 0) {
      int64_t piece = one_pass ? csize : std::min(csize, n - pos);
      if (!one_pass && piece == 0) return more();
      if (piece > cap) fail(kOutput, cap);
      out.insert(out.end(), d + pos, d + pos + piece);
      pos += piece;
      if (piece < csize) return more();
    } else {
      if (pos + csize > n) return more();
      if (kind == 1) {
        if (bsize > cap) fail(kOutput, cap);
        out.insert(out.end(), size_t(bsize), d[pos]);
      } else {
        if (csize > bsm) fail(kBlockSize, csize, bsm);
        read_block(d + pos, csize, out, st, cap, bsm);
      }
      pos += csize;
    }
    int64_t got = int64_t(out.size());
    if (last && hd.fcs >= 0 && got != hd.fcs) fail(kContentSize, got, hd.fcs);
    if (!one_pass && got > size) return size;
    if (last) break;
  }
  if (hd.checksum) {
    if (pos + 4 > n) return more();
    uint32_t want = uint32_t(le(d + pos, 4));
    uint32_t got = uint32_t(xxh64(out.data(), int64_t(out.size()), 0));
    if (want != got) fail(kChecksum, want, got);
  }
  return int64_t(out.size());
}

// ---------------------------------------------------------------- encoder
// forward bit writer, LSB first (libzstd's BIT_CStream)
struct BitOut {
  std::vector<uint8_t> bytes;
  uint64_t acc = 0;
  int n = 0;
  void add(uint64_t v, int bits) {
    if (bits == 0) return;
    acc |= (v & ((uint64_t(1) << bits) - 1)) << n;
    n += bits;
    while (n >= 8) {
      bytes.push_back(uint8_t(acc));
      acc >>= 8;
      n -= 8;
    }
  }
  // the end mark, then the last byte
  std::vector<uint8_t> close() {
    add(1, 1);
    if (n) bytes.push_back(uint8_t(acc));
    acc = 0;
    n = 0;
    return bytes;
  }
};

// FSE encoding table of normalized counts (libzstd's FSE_buildCTable)
struct FseEnc {
  int log = 0;
  std::vector<uint16_t> state;
  std::vector<int32_t> delta_bits, delta_state;
};

FseEnc fse_encoder(const std::vector<int16_t>& norm, int log) {
  int size = 1 << log, nsym = int(norm.size()), high = size - 1;
  std::vector<int> sym(size, 0), cumul(nsym + 1, 0);
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      cumul[s + 1] = cumul[s] + 1;
      sym[high--] = s;
    } else {
      cumul[s + 1] = cumul[s] + norm[s];
    }
  }
  int pos = 0, step = (size >> 1) + (size >> 3) + 3;
  for (int s = 0; s < nsym; ++s)
    for (int i = 0; i < norm[s]; ++i) {
      sym[pos] = s;
      do pos = (pos + step) & (size - 1);
      while (pos > high);
    }
  FseEnc e;
  e.log = log;
  e.state.resize(size);
  std::vector<int> at(cumul.begin(), cumul.end() - 1);
  for (int u = 0; u < size; ++u) e.state[at[sym[u]]++] = uint16_t(size + u);
  e.delta_bits.resize(nsym);
  e.delta_state.resize(nsym);
  int total = 0;
  for (int s = 0; s < nsym; ++s) {
    int c = norm[s];
    if (c == 0) {
      e.delta_bits[s] = ((log + 1) << 16) - size;
    } else if (c == -1 || c == 1) {
      e.delta_bits[s] = (log << 16) - size;
      e.delta_state[s] = total - 1;
      total += 1;
    } else {
      int max_out = log - (bit_length(uint64_t(c - 1)) - 1);
      e.delta_bits[s] = (max_out << 16) - (c << max_out);
      e.delta_state[s] = total - c;
      total += c;
    }
  }
  return e;
}

struct FseState {
  const FseEnc* t;
  uint32_t value;
  void init(const FseEnc& e, int s) {
    t = &e;
    uint32_t nb = uint32_t((e.delta_bits[s] + (1 << 15)) >> 16);
    uint32_t v = (nb << 16) - uint32_t(e.delta_bits[s]);
    value = e.state[(v >> nb) + e.delta_state[s]];
  }
  void encode(BitOut& out, int s) {
    uint32_t nb = (value + uint32_t(t->delta_bits[s])) >> 16;
    out.add(value, int(nb));
    value = t->state[(value >> nb) + t->delta_state[s]];
  }
  void flush(BitOut& out) { out.add(value, t->log); }
};

// counts -> normalized counts summing to 2^log, each present symbol at least 1
std::vector<int16_t> normalize(const std::vector<int64_t>& count, int log) {
  int64_t total = 0;
  for (int64_t c : count) total += c;
  std::vector<int16_t> norm(count.size(), 0);
  int64_t sum = 0, size = int64_t(1) << log;
  for (size_t s = 0; s < count.size(); ++s)
    if (count[s]) {
      norm[s] = int16_t(std::max<int64_t>(1, (count[s] * size + total / 2) / total));
      sum += norm[s];
    }
  while (sum != size) {
    size_t best = 0;
    for (size_t s = 1; s < norm.size(); ++s)
      if (norm[s] > norm[best]) best = s;
    if (sum > size) {
      int64_t cut = std::min<int64_t>(sum - size, norm[best] - 1);
      if (cut == 0) break;
      norm[best] = int16_t(norm[best] - cut);
      sum -= cut;
    } else {
      norm[best] = int16_t(norm[best] + (size - sum));
      sum = size;
    }
  }
  return norm;
}

// libzstd's FSE_writeNCount
void write_ncount(const std::vector<int16_t>& norm, int log, std::vector<uint8_t>& out) {
  BitOut b;
  b.add(uint64_t(log - 5), 4);
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  int nsym = int(norm.size()), s = 0;
  bool previous0 = false;
  while (s < nsym && remaining > 1) {
    if (previous0) {
      int start = s;
      while (s < nsym && !norm[s]) ++s;
      while (s >= start + 3) {
        start += 3;
        b.add(3, 2);
      }
      b.add(uint64_t(s - start), 2);
    }
    int count = norm[s++], top = 2 * threshold - 1 - remaining;
    remaining -= count < 0 ? -count : count;
    count += 1;
    if (count >= threshold) count += top;
    b.add(uint64_t(count), nbits - (count < top));
    previous0 = count == 1;
    while (remaining < threshold) {
      nbits -= 1;
      threshold >>= 1;
    }
  }
  if (b.n) b.bytes.push_back(uint8_t(b.acc));
  out.insert(out.end(), b.bytes.begin(), b.bytes.end());
}

double fse_cost(const std::vector<int64_t>& count, const std::vector<int16_t>& norm,
                int log) {
  double bits = 0;
  for (size_t s = 0; s < count.size(); ++s)
    if (count[s]) {
      if (s >= norm.size() || norm[s] == 0) return 1e300;
      bits += double(count[s]) * (log - std::log2(double(norm[s] < 0 ? 1 : norm[s])));
    }
  return bits;
}

// canonical Huffman code lengths of at most 11 bits for the present symbols
std::vector<int> huffman_lengths(const std::vector<int64_t>& freq) {
  std::vector<int64_t> f(freq);
  while (true) {
    std::vector<std::pair<int64_t, int>> nodes;  // (weight, node)
    std::vector<int> parent;
    for (int s = 0; s < 256; ++s)
      if (f[s]) {
        nodes.push_back({f[s], int(parent.size())});
        parent.push_back(-1);
      }
    std::vector<int> leaf_of;
    for (int s = 0; s < 256; ++s)
      if (f[s]) leaf_of.push_back(s);
    std::vector<std::pair<int64_t, int>> heap(nodes);
    auto cmp = [](const std::pair<int64_t, int>& a, const std::pair<int64_t, int>& b) {
      return a.first != b.first ? a.first > b.first : a.second > b.second;
    };
    std::make_heap(heap.begin(), heap.end(), cmp);
    while (heap.size() > 1) {
      std::pop_heap(heap.begin(), heap.end(), cmp);
      auto a = heap.back();
      heap.pop_back();
      std::pop_heap(heap.begin(), heap.end(), cmp);
      auto b = heap.back();
      heap.pop_back();
      int id = int(parent.size());
      parent.push_back(-1);
      parent[a.second] = id;
      parent[b.second] = id;
      heap.push_back({a.first + b.first, id});
      std::push_heap(heap.begin(), heap.end(), cmp);
    }
    std::vector<int> len(256, 0);
    int longest = 0;
    for (size_t i = 0; i < leaf_of.size(); ++i) {
      int depth = 0;
      for (int x = int(i); parent[x] >= 0; x = parent[x]) ++depth;
      len[leaf_of[i]] = depth;
      longest = std::max(longest, depth);
    }
    if (longest <= 11) return len;
    for (int s = 0; s < 256; ++s)
      if (f[s]) f[s] = (f[s] + 1) / 2;
  }
}

// the Huffman tree description of `weights` (each symbol's up to the last
// one with a weight, whose weight the decoder infers): the smallest of the
// direct 4-bit weights and the FSE-coded ones at accuracy 6 and 5 that
// decode back (the decoder's own walk checks them); empty where none can be
// written (more than 128 weights that FSE cannot code)
std::vector<uint8_t> huffman_description(const std::vector<int>& weights) {
  int n = int(weights.size()) - 1;
  std::vector<uint8_t> best;
  if (n <= 128) {
    best.push_back(uint8_t(127 + n));
    for (int i = 0; i < n; i += 2)
      best.push_back(uint8_t(weights[i] << 4 | (i + 1 < n ? weights[i + 1] : 0)));
  }
  std::vector<int64_t> count(13, 0);
  for (int i = 0; i < n; ++i) ++count[weights[i]];
  int distinct = 0, top = 0;
  for (int64_t c : count) {
    distinct += c > 0;
    top = std::max<int>(top, int(c));
  }
  while (count.back() == 0) count.pop_back();
  if (n <= 2 || distinct < 2 || top < 2) return best;  // libzstd's "not compressible"
  const std::vector<int> want(weights.begin(), weights.begin() + n);
  for (int log : {6, 5}) {
    std::vector<int16_t> norm = normalize(count, log);
    FseEnc e = fse_encoder(norm, log);
    std::vector<uint8_t> body;
    write_ncount(norm, log, body);
    BitOut b;
    FseState s1, s2;
    int i = n;
    if (n & 1) {
      s1.init(e, weights[--i]);
      s2.init(e, weights[--i]);
      s1.encode(b, weights[--i]);
    } else {
      s2.init(e, weights[--i]);
      s1.init(e, weights[--i]);
    }
    while (i > 0) {
      s2.encode(b, weights[--i]);
      s1.encode(b, weights[--i]);
    }
    s2.flush(b);
    s1.flush(b);
    std::vector<uint8_t> stream = b.close();
    body.insert(body.end(), stream.begin(), stream.end());
    if (body.size() >= 128 || (!best.empty() && body.size() + 1 >= best.size())) continue;
    try {
      if (fse_weights(body.data(), int64_t(body.size())) != want) continue;
    } catch (const Error&) {
      continue;
    }
    best.assign(1, uint8_t(body.size()));
    best.insert(best.end(), body.begin(), body.end());
  }
  return best;
}

// the literals section of `lits`
void write_literals(const uint8_t* lits, int64_t n, std::vector<uint8_t>& out) {
  auto raw_head = [&](int kind) {
    if (n < 32) {
      out.push_back(uint8_t(n << 3 | kind));
    } else if (n < 4096) {
      out.push_back(uint8_t((n & 15) << 4 | 1 << 2 | kind));
      out.push_back(uint8_t(n >> 4));
    } else {
      out.push_back(uint8_t((n & 15) << 4 | 3 << 2 | kind));
      out.push_back(uint8_t(n >> 4));
      out.push_back(uint8_t(n >> 12));
    }
  };
  bool same = n > 1;
  for (int64_t i = 1; i < n && same; ++i) same = lits[i] == lits[0];
  if (same) {
    raw_head(1);
    out.push_back(lits[0]);
    return;
  }
  std::vector<uint8_t> coded;
  if (n >= 32) {
    std::vector<int64_t> freq(256, 0);
    for (int64_t i = 0; i < n; ++i) ++freq[lits[i]];
    std::vector<int> len = huffman_lengths(freq);
    int log = *std::max_element(len.begin(), len.end()), last = 255;
    while (!len[last]) --last;
    std::vector<int> weights(last + 1);
    for (int s = 0; s <= last; ++s) weights[s] = len[s] ? log + 1 - len[s] : 0;
    std::vector<uint8_t> desc = huffman_description(weights);
    if (!desc.empty()) {
      // canonical codes: weight 1 first, symbols in order
      std::vector<uint32_t> code(256, 0);
      uint32_t at = 0;
      for (int w = 1; w <= log; ++w)
        for (int s = 0; s <= last; ++s)
          if (weights[s] == w) {
            code[s] = at >> (w - 1);
            at += 1u << (w - 1);
          }
      int streams = n < 256 ? 1 : 4;
      int64_t seg = (n + 3) / 4;
      std::vector<std::vector<uint8_t>> parts;
      for (int k = 0; k < streams; ++k) {
        int64_t lo = streams == 1 ? 0 : k * seg, hi = streams == 1 || k == 3 ? n : lo + seg;
        BitOut b;
        for (int64_t i = hi - 1; i >= lo; --i) b.add(code[lits[i]], len[lits[i]]);
        parts.push_back(b.close());
      }
      coded = desc;
      if (streams == 4)
        for (int k = 0; k < 3; ++k) {
          coded.push_back(uint8_t(parts[k].size()));
          coded.push_back(uint8_t(parts[k].size() >> 8));
        }
      for (auto& p : parts) coded.insert(coded.end(), p.begin(), p.end());
      int64_t c = int64_t(coded.size());
      bool fits = streams == 1 ? c < 1024 : c < (int64_t(1) << 18);
      for (auto& p : parts) fits = fits && p.size() < 65536;
      int head = streams == 1 || (n < 1024 && c < 1024) ? 3 : (n < 16384 && c < 16384) ? 4 : 5;
      if (fits && c + head < n + (n < 32 ? 1 : n < 4096 ? 2 : 3)) {
        uint64_t fmt = streams == 1 ? 0 : head - 2, h;
        int shift = head == 3 ? 10 : head == 4 ? 14 : 18;
        h = 2 | fmt << 2 | uint64_t(n) << 4 | uint64_t(c) << (4 + shift);
        for (int k = 0; k < head; ++k) out.push_back(uint8_t(h >> (8 * k)));
        out.insert(out.end(), coded.begin(), coded.end());
        return;
      }
    }
  }
  raw_head(0);
  out.insert(out.end(), lits, lits + n);
}

struct Seq {
  int64_t ll, ml, ov;  // literal length, match length, offset value (1-3 repeats)
};

int ll_code(int64_t v) {
  if (v < 16) return int(v);
  int c = 16;
  while (c < 35 && kLLBase[c + 1] <= v) ++c;
  return c;
}

int ml_code(int64_t v) {
  if (v < 35) return int(v - 3);
  int c = 32;
  while (c < 52 && kMLBase[c + 1] <= v) ++c;
  return c;
}

// the sequences section
void write_sequences(const std::vector<Seq>& seqs, std::vector<uint8_t>& out) {
  int64_t nseq = int64_t(seqs.size());
  if (nseq < 128) {
    out.push_back(uint8_t(nseq));
  } else if (nseq < 0x7F00) {
    out.push_back(uint8_t((nseq >> 8) + 0x80));
    out.push_back(uint8_t(nseq));
  } else {
    out.push_back(255);
    out.push_back(uint8_t(nseq - 0x7F00));
    out.push_back(uint8_t((nseq - 0x7F00) >> 8));
  }
  if (nseq == 0) return;
  std::vector<int> codes[3];
  for (const Seq& q : seqs) {
    codes[0].push_back(ll_code(q.ll));
    codes[1].push_back(bit_length(uint64_t(q.ov)) - 1);
    codes[2].push_back(ml_code(q.ml));
  }
  const int16_t* defaults[3] = {kLLDefault, kOFDefault, kMLDefault};
  const int ndefault[3] = {36, 29, 53}, default_log[3] = {6, 5, 6};
  int modes[3];
  std::vector<uint8_t> descs[3];
  FseEnc enc[3];
  for (int t = 0; t < 3; ++t) {
    std::vector<int64_t> count(kMaxSymbol[t] + 1, 0);
    for (int c : codes[t]) ++count[c];
    int distinct = 0, last = 0;
    for (int s = 0; s <= kMaxSymbol[t]; ++s)
      if (count[s]) {
        ++distinct;
        last = s;
      }
    count.resize(last + 1);
    if (distinct == 1 && nseq > 1) {
      modes[t] = 1;
      descs[t] = {uint8_t(last)};
      enc[t] = fse_encoder(std::vector<int16_t>{1}, 0);
      continue;
    }
    std::vector<int16_t> dnorm(defaults[t], defaults[t] + ndefault[t]);
    double best = fse_cost(count, dnorm, default_log[t]);
    modes[t] = 0;
    enc[t] = fse_encoder(dnorm, default_log[t]);
    int min_log = std::max(5, bit_length(uint64_t(last)));
    int log = std::min(kMaxLog[t], std::max(min_log, bit_length(uint64_t(nseq)) - 1));
    if (min_log <= kMaxLog[t] && nseq > 8) {
      std::vector<int16_t> norm = normalize(count, log);
      std::vector<uint8_t> desc;
      write_ncount(norm, log, desc);
      double cost = fse_cost(count, norm, log) + 8.0 * desc.size();
      if (cost < best) {
        modes[t] = 2;
        descs[t] = desc;
        enc[t] = fse_encoder(norm, log);
      }
    }
  }
  out.push_back(uint8_t(modes[0] << 6 | modes[1] << 4 | modes[2] << 2));
  for (int t = 0; t < 3; ++t) out.insert(out.end(), descs[t].begin(), descs[t].end());
  // an RLE table: one state, no bits (its encoder is never asked to move)
  BitOut b;
  FseState st[3];
  int64_t k = nseq - 1;
  for (int t : {2, 1, 0})
    if (modes[t] != 1) st[t].init(enc[t], codes[t][k]);
  auto extras = [&](int64_t i) {
    int lc = codes[0][i], mc = codes[2][i], oc = codes[1][i];
    b.add(uint64_t(seqs[i].ll - kLLBase[lc]), kLLBits[lc]);
    b.add(uint64_t(seqs[i].ml - kMLBase[mc]), kMLBits[mc]);
    b.add(uint64_t(seqs[i].ov), oc);
  };
  extras(k);
  for (int64_t i = nseq - 2; i >= 0; --i) {
    for (int t : {1, 2, 0})
      if (modes[t] != 1) st[t].encode(b, codes[t][i]);
    extras(i);
  }
  for (int t : {2, 1, 0})
    if (modes[t] != 1) st[t].flush(b);
  std::vector<uint8_t> stream = b.close();
  out.insert(out.end(), stream.begin(), stream.end());
}

// the offset value of a match at `offset` after `ll` literals; the repeat
// offsets move as the decoder moves them
int64_t offset_value(int64_t offset, int64_t ll, uint64_t rep[3]) {
  uint64_t o = uint64_t(offset);
  int64_t ov;
  if (ll > 0) {
    ov = o == rep[0] ? 1 : o == rep[1] ? 2 : o == rep[2] ? 3 : offset + 3;
  } else {
    ov = o == rep[1] ? 1 : o == rep[2] ? 2 : o == rep[0] - 1 ? 3 : offset + 3;
  }
  if (ov > 3) {
    rep[2] = rep[1];
    rep[1] = rep[0];
    rep[0] = o;
  } else {
    int idx = int(ov) - 1 + (ll == 0);
    if (idx > 0) {
      if (idx != 1) rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = o;
    }
  }
  return ov;
}

void put_block_header(std::vector<uint8_t>& out, int last, int kind, int64_t size) {
  uint32_t h = uint32_t(last) | uint32_t(kind) << 1 | uint32_t(size) << 3;
  out.push_back(uint8_t(h));
  out.push_back(uint8_t(h >> 8));
  out.push_back(uint8_t(h >> 16));
}

constexpr int kHashLog = 17;

uint32_t read32(const uint8_t* p) { return uint32_t(le(p, 4)); }
uint32_t hash4(uint32_t v) { return (v * 2654435761u) >> (32 - kHashLog); }

void encode_frame(const uint8_t* src, int64_t n, int checksum, std::vector<uint8_t>& out) {
  for (int i = 0; i < 4; ++i) out.push_back(uint8_t(kMagicNumber >> (8 * i)));
  int flag = n < 256 ? 0 : n < 65536 + 256 ? 1 : n < (int64_t(1) << 32) ? 2 : 3;
  out.push_back(uint8_t(flag << 6 | 1 << 5 | checksum << 2));
  const int fcs_sizes[4] = {1, 2, 4, 8};
  int fcs_size = fcs_sizes[flag];
  uint64_t fcs = uint64_t(n) - (flag == 1 ? 256 : 0);
  for (int i = 0; i < fcs_size; ++i) out.push_back(uint8_t(fcs >> (8 * i)));
  std::vector<int64_t> table(size_t(1) << kHashLog, -1);
  uint64_t rep[3] = {1, 4, 8};
  int64_t pos = 0;
  do {
    int64_t end = std::min(n, pos + kBlockMax), bsize = end - pos;
    int last = end == n;
    bool same = bsize > 1;
    for (int64_t i = pos + 1; i < end && same; ++i) same = src[i] == src[pos];
    if (same) {
      put_block_header(out, last, 1, bsize);
      out.push_back(src[pos]);
      pos = end;
      continue;
    }
    // greedy matches within the block, the repeat offsets tried first
    std::vector<Seq> seqs;
    std::vector<uint8_t> lits;
    uint64_t rep_in[3] = {rep[0], rep[1], rep[2]};
    int64_t p = pos, anchor = pos;
    while (p + 4 <= end) {
      int64_t best_len = 0, best_off = 0;
      uint64_t tries[3] = {rep[0], rep[1], rep[2]};
      for (uint64_t o : tries)
        if (o <= uint64_t(p) && read32(src + p - o) == read32(src + p)) {
          int64_t l = 4;
          while (p + l < end && src[p + l] == src[p + l - int64_t(o)]) ++l;
          if (l > best_len) {
            best_len = l;
            best_off = int64_t(o);
          }
        }
      uint32_t h = hash4(read32(src + p));
      int64_t cand = table[h];
      table[h] = p;
      if (best_len < 8 && cand >= 0 && read32(src + cand) == read32(src + p)) {
        int64_t l = 4;
        while (p + l < end && src[p + l] == src[cand + l]) ++l;
        if (l > best_len + 1) {
          best_len = l;
          best_off = p - cand;
        }
      }
      if (best_len < 4) {
        p += 1 + ((p - anchor) >> 7);
        continue;
      }
      int64_t ll = p - anchor;
      lits.insert(lits.end(), src + anchor, src + p);
      seqs.push_back(Seq{ll, best_len, offset_value(best_off, ll, rep)});
      for (int64_t q = p + 1; q < p + best_len && q + 4 <= end; q += 3)
        table[hash4(read32(src + q))] = q;
      p += best_len;
      anchor = p;
    }
    lits.insert(lits.end(), src + anchor, src + end);
    std::vector<uint8_t> body;
    write_literals(lits.data(), int64_t(lits.size()), body);
    write_sequences(seqs, body);
    if (int64_t(body.size()) < bsize) {
      put_block_header(out, last, 2, int64_t(body.size()));
      out.insert(out.end(), body.begin(), body.end());
    } else {
      std::copy(rep_in, rep_in + 3, rep);
      put_block_header(out, last, 0, bsize);
      out.insert(out.end(), src + pos, src + end);
    }
    pos = end;
  } while (pos < n);
  if (checksum) {
    uint32_t c = uint32_t(xxh64(src, n, 0));
    for (int i = 0; i < 4; ++i) out.push_back(uint8_t(c >> (8 * i)));
  }
}

}  // namespace

extern "C" {

// data, n, out, size, info: info[0] the bytes written to out (at most
// size), info[1], info[2] the status's values
int gm_zstd_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t size,
                   int64_t* info) {
  std::vector<uint8_t> frame;
  try {
    int64_t got = decode_frame(data, n, size, frame);
    if (got) std::memcpy(out, frame.data(), size_t(got));
    info[0] = got;
    return 0;
  } catch (const Error& e) {
    info[1] = e.a;
    info[2] = e.b;
    return e.code;
  }
}

// data, n, seed, out (one uint64)
int gm_xxh64(const uint8_t* data, int64_t n, uint64_t seed, uint64_t* out) {
  *out = xxh64(data, n, seed);
  return 0;
}

// data, n, checksum, out, cap, n_out
int gm_zstd_encode(const uint8_t* data, int64_t n, int checksum, uint8_t* out, int64_t cap,
                   int64_t* n_out) {
  std::vector<uint8_t> frame;
  encode_frame(data, n, checksum, frame);
  if (int64_t(frame.size()) > cap) return kNoRoom;
  std::memcpy(out, frame.data(), frame.size());
  *n_out = int64_t(frame.size());
  return 0;
}

}  // extern "C"
