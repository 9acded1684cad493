// nice_ref.cpp — native serial oracle codec for the `.nice` format.
//
// This is the framework's C++ runtime component (SURVEY §7.1.2): the
// correctness oracle, fuzz target, serial performance baseline, and the
// production host-side entropy decoder (entropy decode is inherently serial,
// SURVEY §7.3.5).  Behavior follows the spec in SURVEY.md Appendix A —
// a from-scratch implementation, not a translation of the reference Rust.
//
// Byte-level compatibility contract: identical output to nicetpu/spec/codec.py
// (same deterministic Huffman tie-break, same canonical codes, same packing).
//
// Build: g++ -O3 -march=native -shared -fPIC nice_ref.cpp -o libniceref.so

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Format constants (mirrors nicetpu/format/constants.py; SURVEY A.1-A.5)
// ---------------------------------------------------------------------------
constexpr int NUM_STREAMS = 10;
constexpr int ALPHABET[NUM_STREAMS] = {256, 13, 64, 32, 11, 343, 64, 32, 32, 11};
constexpr int SC_RGB = 0, SC_PREFIXES = 1, SC_LUMA_BASE_DIFF = 2,
              SC_LUMA_OTHER_DIFF = 3, SC_LUMA_BACK_REF = 4, SC_SMALL_DIFF = 5,
              SC_LUMA_BASE_DIFF2 = 6, SC_LUMA_OTHER_DIFF2 = 7,
              SC_LUMA_OTHER_DIFFB2 = 8, SC_BACK_REF = 9;
constexpr int PREFIX_BACK_REF = 0, PREFIX_RGB = 1, PREFIX_COLOR_LUMA = 2,
              PREFIX_SMALL_DIFF = 3, PREFIX_COLOR_LUMA2 = 4, PREFIX_RUN_BASE = 5;
constexpr int MAX_CODE_LEN = 31;
constexpr int NUM_BACK_REF = 5, NUM_LUMA_REF = 11;

int stream_base(int s) {
  int b = 0;
  for (int i = 0; i < s; i++) b += ALPHABET[i];
  return b;
}
const int TOTAL_SYMBOLS = stream_base(NUM_STREAMS);  // 858

// ---------------------------------------------------------------------------
// Huffman code lengths — deterministic, identical to format/huffman.py:
// minimum-variance merge (leaves pop before equal-weight internal nodes,
// then by smallest symbol under node), aob init 1, stop at 2 nodes.
// ---------------------------------------------------------------------------
struct HeapNode {
  uint64_t weight;
  int internal;  // 0 leaf, 1 internal — leaves first on weight ties
  int min_sym;
  std::vector<uint16_t> syms;
};
struct HeapCmp {  // std::priority_queue is a max-heap; invert for min-heap
  bool operator()(const HeapNode& a, const HeapNode& b) const {
    if (a.weight != b.weight) return a.weight > b.weight;
    if (a.internal != b.internal) return a.internal > b.internal;
    return a.min_sym > b.min_sym;
  }
};

void huffman_lengths_once(const uint64_t* counts, int n, uint8_t* out) {
  std::vector<int64_t> lengths(n, 1);
  std::priority_queue<HeapNode, std::vector<HeapNode>, HeapCmp> heap;
  for (int i = 0; i < n; i++)
    heap.push(HeapNode{counts[i], 0, i, {static_cast<uint16_t>(i)}});
  while (heap.size() > 2) {
    HeapNode a = heap.top(); heap.pop();
    HeapNode b = heap.top(); heap.pop();
    HeapNode m;
    m.weight = a.weight + b.weight;
    m.internal = 1;
    m.min_sym = std::min(a.min_sym, b.min_sym);
    m.syms = std::move(a.syms);
    m.syms.insert(m.syms.end(), b.syms.begin(), b.syms.end());
    for (uint16_t s : m.syms) lengths[s]++;
    heap.push(std::move(m));
  }
  for (int i = 0; i < n; i++) out[i] = static_cast<uint8_t>(lengths[i]);
}

// Length-limiting clamp (mirrors format/huffman.py exactly): when the raw
// merge exceeds MAX_CODE_LEN, clamp every count (including zeros) up to
// total/2^20 + 1 and re-merge.  Removing zero weights makes the Fibonacci
// depth bound apply: w_min/total' > 1/F(33), so depth <= 31 with margin.
static uint64_t clamp_floor(uint64_t total) { return (total >> 20) + 1; }

void code_lengths(const uint64_t* counts, int n, uint8_t* out) {
  huffman_lengths_once(counts, n, out);
  int maxlen = 0;
  for (int i = 0; i < n; i++) maxlen = std::max(maxlen, static_cast<int>(out[i]));
  if (maxlen > MAX_CODE_LEN) {
    uint64_t total = 0;
    for (int i = 0; i < n; i++) total += counts[i];
    const uint64_t floor_w = clamp_floor(total);
    std::vector<uint64_t> clamped(n);
    for (int i = 0; i < n; i++) clamped[i] = std::max(counts[i], floor_w);
    huffman_lengths_once(clamped.data(), n, out);
  }
}

// Canonical codes: (length asc, symbol asc), counting up (SURVEY §2.3.2).
void canonical_codes(const uint8_t* lengths, int n, uint32_t* codes) {
  std::vector<int> order(n);
  for (int i = 0; i < n; i++) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    if (lengths[a] != lengths[b]) return lengths[a] < lengths[b];
    return a < b;
  });
  uint32_t code = 0;
  int prev_len = 0;
  for (int sym : order) {
    int ln = lengths[sym];
    if (prev_len) code = (code + 1) << (ln - prev_len);
    codes[sym] = code;
    prev_len = ln;
  }
}

// ---------------------------------------------------------------------------
// Bit I/O (MSB-first, 64-bit cache)
// ---------------------------------------------------------------------------
struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t cache = 0;
  int bits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  inline void write(uint32_t value, int n) {
    cache |= static_cast<uint64_t>(value) << (64 - bits - n);
    bits += n;
    while (bits >= 8) {
      out.push_back(static_cast<uint8_t>(cache >> 56));
      cache <<= 8;
      bits -= 8;
    }
  }
  // 5-byte flush tail [B, B, 0, 0, 0] (SURVEY A.1/A.6)
  void tail() {
    uint8_t B = static_cast<uint8_t>(cache >> 56);
    out.push_back(B);
    out.push_back(B);
    out.push_back(0);
    out.push_back(0);
    out.push_back(0);
  }
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t cache = 0;
  int ncache = 0;  // valid bits at top of cache
  BitReader(const uint8_t* data, size_t len) : p(data), end(data + len) {}
  inline void fill() {
    while (ncache <= 56) {
      uint64_t b = (p < end) ? *p++ : 0;  // zero-extend past end
      cache |= b << (56 - ncache);
      ncache += 8;
    }
  }
  inline uint32_t peek(int n) {
    fill();
    return static_cast<uint32_t>(cache >> (64 - n));
  }
  inline void consume(int n) {
    cache <<= n;
    ncache -= n;
  }
  inline uint32_t take(int n) {
    uint32_t v = peek(n);
    consume(n);
    return v;
  }
  bool exhausted() const { return p >= end && ncache <= 0; }
};

// ---------------------------------------------------------------------------
// Per-stream decoder: one-shot LUT (<=16 bit) or canonical range search.
// ---------------------------------------------------------------------------
struct StreamDec {
  int max_aob = 0;
  int nsyms = 0;
  bool deep = false;
  std::vector<uint16_t> lut_sym;
  std::vector<uint8_t> lut_len;
  std::vector<uint16_t> sorted_syms;
  int32_t index_base[MAX_CODE_LEN + 2];
  uint64_t aligned_first[MAX_CODE_LEN + 2];

  void build(const uint8_t* lengths, int n) {
    nsyms = n;
    max_aob = 0;
    for (int i = 0; i < n; i++) max_aob = std::max(max_aob, static_cast<int>(lengths[i]));
    std::vector<uint32_t> codes(n);
    canonical_codes(lengths, n, codes.data());
    if (max_aob <= 16) {
      deep = false;
      lut_sym.assign(1u << max_aob, 0);
      lut_len.assign(1u << max_aob, 0);
      for (int s = 0; s < n; s++) {
        uint32_t lo = codes[s] << (max_aob - lengths[s]);
        uint32_t hi = (codes[s] + 1) << (max_aob - lengths[s]);
        for (uint32_t x = lo; x < hi; x++) {
          lut_sym[x] = static_cast<uint16_t>(s);
          lut_len[x] = lengths[s];
        }
      }
    } else {
      deep = true;
      std::vector<int> order(n);
      for (int i = 0; i < n; i++) order[i] = i;
      std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
        if (lengths[a] != lengths[b]) return lengths[a] < lengths[b];
        return a < b;
      });
      sorted_syms.resize(n);
      for (int l = 0; l <= MAX_CODE_LEN + 1; l++) {
        index_base[l] = 0;
        aligned_first[l] = UINT64_MAX;
      }
      for (int idx = 0; idx < n; idx++) {
        int sym = order[idx];
        sorted_syms[idx] = static_cast<uint16_t>(sym);
        int ln = lengths[sym];
        if (aligned_first[ln] == UINT64_MAX) {
          index_base[ln] = idx;
          aligned_first[ln] = static_cast<uint64_t>(codes[sym]) << (32 - ln);
        }
      }
    }
  }

  inline int read(BitReader& br) {
    if (!deep) {
      uint32_t x = br.peek(max_aob);
      br.consume(lut_len[x]);
      return lut_sym[x];
    }
    uint64_t aligned = static_cast<uint64_t>(br.peek(max_aob)) << (32 - max_aob);
    int best_l = 0;
    for (int l = 1; l <= max_aob; l++)
      if (aligned_first[l] <= aligned) best_l = l;
    int64_t idx = index_base[best_l] +
                  static_cast<int64_t>((aligned - aligned_first[best_l]) >> (32 - best_l));
    if (idx < 0 || idx >= nsyms) idx = nsyms - 1;  // corrupt-stream guard
    br.consume(best_l > 0 ? best_l : 1);
    return sorted_syms[idx];
  }
};

// ---------------------------------------------------------------------------
// Encoder (serial oracle; SURVEY A.4/A.5 cascade)
// ---------------------------------------------------------------------------
struct Token {
  uint16_t sym;
  uint8_t stream;
};

void luma_offsets(int64_t W, int64_t* out) {
  const int64_t o[NUM_LUMA_REF] = {1,      W,        W - 1,     W - 3,
                                   3,      3 * W - 1, 3 * W,     3 * W + 1,
                                   W + 3,  3 * W + 3, 3 * W - 3};
  std::memcpy(out, o, sizeof(o));
}

void backref_offsets(int64_t W, int64_t* out) {
  const int64_t o[NUM_BACK_REF] = {1, W, W - 1, 2, 2 * W};
  std::memcpy(out, o, sizeof(o));
}

}  // namespace

extern "C" {

// Deterministic code-length builder exposed for the Python/JAX pipeline
// (identical results to format/huffman.py.code_lengths).
void nice_code_lengths(const uint64_t* counts, int32_t n, uint8_t* out) {
  code_lengths(counts, n, out);
}

// Encode (H*W RGB bytes) -> .nice.  Returns byte size, or negative on error.
// Output buffer is malloc'd into *out (caller frees with nice_free).
int64_t nice_encode(const uint8_t* rgb, uint32_t width, uint32_t height,
                    uint8_t** out_buf) {
  if (width < 4) return -1;
  const int64_t W = width, N = static_cast<int64_t>(width) * height;
  int64_t lu_off[NUM_LUMA_REF], br_off[NUM_BACK_REF];
  luma_offsets(W, lu_off);
  backref_offsets(W, br_off);

  std::vector<Token> tokens;
  tokens.reserve(static_cast<size_t>(N) + (static_cast<size_t>(N) >> 1));
  std::vector<uint64_t> counts(TOTAL_SYMBOLS, 0);
  int base_of[NUM_STREAMS];
  for (int s = 0; s < NUM_STREAMS; s++) base_of[s] = stream_base(s);
  auto emit = [&](int stream, int sym) {
    tokens.push_back(Token{static_cast<uint16_t>(sym), static_cast<uint8_t>(stream)});
    counts[base_of[stream] + sym]++;
  };

  const uint8_t* px = rgb;
  int64_t p = 0;
  while (p < N) {
    const uint8_t* cur = px + 3 * p;
    // BACK_REF: first exact match over 5 offsets
    int hit = -1;
    for (int i = 0; i < NUM_BACK_REF; i++) {
      int64_t o = br_off[i];
      if (p >= o) {
        const uint8_t* r = cur - 3 * o;
        if (cur[0] == r[0] && cur[1] == r[1] && cur[2] == r[2]) {
          hit = i;
          break;
        }
      }
    }
    if (hit >= 0) {
      emit(SC_PREFIXES, PREFIX_BACK_REF);
      emit(SC_BACK_REF, hit);
    } else {
      // SMALL_DIFF: i16 diffs vs avg(up,left) (or left on row 0)
      const uint8_t* prev = cur - 3;  // p==0 gated out by (p > 0)
      int d0, d1, d2;
      if (p >= W) {
        const uint8_t* up = cur - 3 * W;
        d0 = cur[0] - (up[0] + prev[0]) / 2;
        d1 = cur[1] - (up[1] + prev[1]) / 2;
        d2 = cur[2] - (up[2] + prev[2]) / 2;
      } else if (p > 0) {
        d0 = cur[0] - prev[0];
        d1 = cur[1] - prev[1];
        d2 = cur[2] - prev[2];
      } else {
        d0 = d1 = d2 = 99;
      }
      if (p > 0 && d0 >= -3 && d0 <= 3 && d1 >= -3 && d1 <= 3 && d2 >= -3 && d2 <= 3) {
        emit(SC_PREFIXES, PREFIX_SMALL_DIFF);
        emit(SC_SMALL_DIFF, (3 + d0) + 7 * (3 + d1) + 49 * (3 + d2));
      } else {
        bool done = false;
        // COLOR_LUMA2: averaged predictor, requires p >= W
        if (p >= W) {
          const uint8_t* up = cur - 3 * W;
          uint8_t g = static_cast<uint8_t>(cur[1] - (up[1] + prev[1]) / 2);
          uint8_t r = static_cast<uint8_t>(
              static_cast<uint8_t>(cur[0] - (up[0] + prev[0]) / 2) - g);
          uint8_t b = static_cast<uint8_t>(
              static_cast<uint8_t>(cur[2] - (up[2] + prev[2]) / 2) - g);
          if ((g >= 224 || g < 32) && (r >= 240 || r < 16) && (b >= 240 || b < 16)) {
            emit(SC_PREFIXES, PREFIX_COLOR_LUMA2);
            emit(SC_LUMA_BASE_DIFF2, static_cast<uint8_t>(g + 32));
            emit(SC_LUMA_OTHER_DIFF2, static_cast<uint8_t>(r + 16));
            emit(SC_LUMA_OTHER_DIFFB2, static_cast<uint8_t>(b + 16));
            done = true;
          }
        }
        // COLOR_LUMA: 11 single-pixel refs, first in-range wins
        if (!done) {
          for (int i = 0; i < NUM_LUMA_REF && !done; i++) {
            int64_t o = lu_off[i];
            if (p < o) continue;
            const uint8_t* r3 = cur - 3 * o;
            uint8_t g = static_cast<uint8_t>(cur[1] - r3[1]);
            uint8_t r = static_cast<uint8_t>(static_cast<uint8_t>(cur[0] - r3[0]) - g);
            uint8_t b = static_cast<uint8_t>(static_cast<uint8_t>(cur[2] - r3[2]) - g);
            if ((g >= 224 || g < 32) && (r >= 240 || r < 16) && (b >= 240 || b < 16)) {
              emit(SC_PREFIXES, PREFIX_COLOR_LUMA);
              emit(SC_LUMA_BACK_REF, i);
              emit(SC_LUMA_BASE_DIFF, static_cast<uint8_t>(g + 32));
              emit(SC_LUMA_OTHER_DIFF, static_cast<uint8_t>(r + 16));
              emit(SC_LUMA_OTHER_DIFF, static_cast<uint8_t>(b + 16));
              done = true;
            }
          }
        }
        // RGB fallback
        if (!done) {
          emit(SC_PREFIXES, PREFIX_RGB);
          for (int c = 0; c < 3; c++) {
            uint8_t res;
            if (p >= W) {
              const uint8_t* up = cur - 3 * W;
              res = static_cast<uint8_t>(cur[c] - (up[c] + prev[c]) / 2);
            } else {
              res = static_cast<uint8_t>(cur[c] - (p > 0 ? prev[c] : 0));
            }
            emit(SC_RGB, res);
          }
        }
      }
    }
    // Run scan: following pixels equal to cur
    int64_t q = p + 1;
    while (q < N) {
      const uint8_t* nx = px + 3 * q;
      if (nx[0] != cur[0] || nx[1] != cur[1] || nx[2] != cur[2]) break;
      q++;
    }
    int64_t k = q - p - 1;
    if (k > 0) {
      uint64_t v = static_cast<uint64_t>(k - 1);
      for (;;) {
        emit(SC_PREFIXES, static_cast<int>(v % 8) + PREFIX_RUN_BASE);
        if (v < 8) break;
        v /= 8;
      }
    }
    p = q;
  }

  // Tables
  std::vector<uint8_t> lengths(TOTAL_SYMBOLS);
  std::vector<uint32_t> codes(TOTAL_SYMBOLS);
  for (int s = 0; s < NUM_STREAMS; s++) {
    code_lengths(counts.data() + base_of[s], ALPHABET[s], lengths.data() + base_of[s]);
    canonical_codes(lengths.data() + base_of[s], ALPHABET[s], codes.data() + base_of[s]);
  }

  // Serialize
  std::vector<uint8_t> out;
  out.reserve(static_cast<size_t>(N) * 4 + 1024);
  out.push_back('n'); out.push_back('i'); out.push_back('c'); out.push_back('e');
  for (int i = 3; i >= 0; i--) out.push_back(static_cast<uint8_t>(width >> (8 * i)));
  for (int i = 3; i >= 0; i--) out.push_back(static_cast<uint8_t>(height >> (8 * i)));
  out.push_back(3);

  BitWriter bw(out);
  for (int s = 0; s < NUM_STREAMS; s++) {
    int maxa = 0;
    for (int i = 0; i < ALPHABET[s]; i++)
      maxa = std::max(maxa, static_cast<int>(lengths[base_of[s] + i]));
    bw.write(static_cast<uint32_t>(maxa), 5);
    for (int i = 0; i < ALPHABET[s]; i++)
      bw.write(lengths[base_of[s] + i], 7);
  }
  for (const Token& t : tokens) {
    int bin = base_of[t.stream] + t.sym;
    bw.write(codes[bin], lengths[bin]);
  }
  bw.tail();

  uint8_t* buf = static_cast<uint8_t*>(std::malloc(out.size()));
  if (!buf) return -2;
  std::memcpy(buf, out.data(), out.size());
  *out_buf = buf;
  return static_cast<int64_t>(out.size());
}

void nice_free(uint8_t* buf) { std::free(buf); }

// Batch encode: n images in parallel (OpenMP across images — the host-side
// throughput path for the streamed-corpus config, BASELINE config 4).
// Per-image failures are reported in out_lens[i] (< 0); returns 0/-1 overall.
int64_t nice_encode_batch(const uint8_t* const* imgs, const uint32_t* ws,
                          const uint32_t* hs, int32_t n, uint8_t** out_bufs,
                          int64_t* out_lens) {
  int err = 0;
#pragma omp parallel for schedule(dynamic)
  for (int32_t i = 0; i < n; i++) {
    out_lens[i] = nice_encode(imgs[i], ws[i], hs[i], &out_bufs[i]);
    if (out_lens[i] < 0) err = 1;
  }
  return err ? -1 : 0;
}

int64_t nice_decode(const uint8_t* data, size_t len, uint8_t* out);

// Batch decode: n .nice payloads in parallel into caller buffers.
int64_t nice_decode_batch(const uint8_t* const* datas, const size_t* lens,
                          int32_t n, uint8_t* const* outs, int64_t* rcs) {
  int err = 0;
#pragma omp parallel for schedule(dynamic)
  for (int32_t i = 0; i < n; i++) {
    rcs[i] = nice_decode(datas[i], lens[i], outs[i]);
    if (rcs[i] != 0) err = 1;
  }
  return err ? -1 : 0;
}

int32_t nice_read_header(const uint8_t* data, size_t len, uint32_t* w,
                         uint32_t* h, uint8_t* channels) {
  if (len < 13) return -1;
  *w = (static_cast<uint32_t>(data[4]) << 24) | (data[5] << 16) | (data[6] << 8) | data[7];
  *h = (static_cast<uint32_t>(data[8]) << 24) | (data[9] << 16) | (data[10] << 8) | data[11];
  *channels = data[12];
  return 0;
}

// Decode .nice -> caller buffer of w*h*3 bytes.  Returns 0 or negative error.
int64_t nice_decode(const uint8_t* data, size_t len, uint8_t* out) {
  uint32_t width, height;
  uint8_t channels;
  if (nice_read_header(data, len, &width, &height, &channels) != 0) return -1;
  if (channels != 3) return -3;  // RGB-only decode (SURVEY A.8.3)
  if (width < 4) return -1;
  const int64_t W = width, N = static_cast<int64_t>(width) * height;
  if (N == 0) return 0;

  // Stream headers: 5-bit max_aob + 7-bit aobs, in stream order (SURVEY A.2)
  BitReader hbr(data + 13, len > 13 ? len - 13 : 0);
  std::vector<uint8_t> lengths(TOTAL_SYMBOLS);
  for (int s = 0; s < NUM_STREAMS; s++) {
    hbr.take(5);  // max_aob is redundant given lengths
    for (int i = 0; i < ALPHABET[s]; i++)
      lengths[stream_base(s) + i] = static_cast<uint8_t>(hbr.take(7));
  }
  // Validate: lengths in [1, 31] and Kraft sum <= 1, else the canonical
  // code ranges would overflow the decoder LUT (corrupt/hostile input; the
  // reference has no such guard and corrupts memory here).
  for (int s = 0; s < NUM_STREAMS; s++) {
    uint64_t kraft = 0;
    for (int i = 0; i < ALPHABET[s]; i++) {
      uint8_t ln = lengths[stream_base(s) + i];
      if (ln < 1 || ln > MAX_CODE_LEN) return -6;
      kraft += 1ull << (MAX_CODE_LEN - ln);
    }
    if (kraft > (1ull << MAX_CODE_LEN)) return -6;
  }
  StreamDec dec[NUM_STREAMS];
  for (int s = 0; s < NUM_STREAMS; s++)
    dec[s].build(lengths.data() + stream_base(s), ALPHABET[s]);

  // Payload starts at byte 13 + 757 (headers are always byte-aligned)
  constexpr size_t HEADERS_BYTES = (NUM_STREAMS * 5 + 858 * 7) / 8;
  size_t pay_off = 13 + HEADERS_BYTES;
  BitReader br(data + (pay_off < len ? pay_off : len),
               len > pay_off ? len - pay_off : 0);

  int64_t lu_off[NUM_LUMA_REF], br_off[NUM_BACK_REF];
  luma_offsets(W, lu_off);
  backref_offsets(W, br_off);

  int64_t pos = 0, prev = 0;
  int prefix = dec[SC_PREFIXES].read(br);
  for (;;) {
    uint8_t* o = out + 3 * pos;
    const uint8_t* pv = out + 3 * prev;
    switch (prefix) {
      case PREFIX_COLOR_LUMA2: {
        if (pos < W) return -5;  // corrupt stream: predictor out of range
        const uint8_t* up = o - 3 * W;
        int g = dec[SC_LUMA_BASE_DIFF2].read(br) - 32;
        o[1] = static_cast<uint8_t>(g + (pv[1] + up[1]) / 2);
        o[0] = static_cast<uint8_t>(dec[SC_LUMA_OTHER_DIFF2].read(br) - 16 + g +
                                    (pv[0] + up[0]) / 2);
        o[2] = static_cast<uint8_t>(dec[SC_LUMA_OTHER_DIFFB2].read(br) - 16 + g +
                                    (pv[2] + up[2]) / 2);
        break;
      }
      case PREFIX_SMALL_DIFF: {
        int code = dec[SC_SMALL_DIFF].read(br);
        int dr = code % 7;
        code = (code - dr) / 7;
        int dg = code % 7;
        int db = (code - dg) / 7;
        int r0, g0, b0;
        if (pos >= W) {
          const uint8_t* up = o - 3 * W;
          r0 = (up[0] + pv[0]) / 2;
          g0 = (up[1] + pv[1]) / 2;
          b0 = (up[2] + pv[2]) / 2;
        } else {
          r0 = pv[0]; g0 = pv[1]; b0 = pv[2];
        }
        o[0] = static_cast<uint8_t>(dr - 3 + r0);
        o[1] = static_cast<uint8_t>(dg - 3 + g0);
        o[2] = static_cast<uint8_t>(db - 3 + b0);
        break;
      }
      case PREFIX_COLOR_LUMA: {
        int64_t off = lu_off[dec[SC_LUMA_BACK_REF].read(br)];
        if (pos < off) return -5;  // corrupt stream
        const uint8_t* r3 = o - 3 * off;
        int g = dec[SC_LUMA_BASE_DIFF].read(br) - 32;
        o[1] = static_cast<uint8_t>(g + r3[1]);
        o[0] = static_cast<uint8_t>(dec[SC_LUMA_OTHER_DIFF].read(br) - 16 + g + r3[0]);
        o[2] = static_cast<uint8_t>(dec[SC_LUMA_OTHER_DIFF].read(br) - 16 + g + r3[2]);
        break;
      }
      case PREFIX_BACK_REF: {
        int64_t off = br_off[dec[SC_BACK_REF].read(br)];
        if (pos < off) return -5;  // corrupt stream
        const uint8_t* r3 = o - 3 * off;
        o[0] = r3[0]; o[1] = r3[1]; o[2] = r3[2];
        break;
      }
      case PREFIX_RGB: {
        int p0, p1, p2;
        if (pos >= W) {
          const uint8_t* up = o - 3 * W;
          p0 = (up[0] + pv[0]) / 2;
          p1 = (up[1] + pv[1]) / 2;
          p2 = (up[2] + pv[2]) / 2;
        } else if (pos > 0) {
          p0 = pv[0]; p1 = pv[1]; p2 = pv[2];
        } else {
          p0 = p1 = p2 = 0;
        }
        o[0] = static_cast<uint8_t>(dec[SC_RGB].read(br) + p0);
        o[1] = static_cast<uint8_t>(dec[SC_RGB].read(br) + p1);
        o[2] = static_cast<uint8_t>(dec[SC_RGB].read(br) + p2);
        break;
      }
      default:
        return -4;  // unknown prefix: corrupt stream
    }
    prev = pos;
    pos++;
    if (pos >= N) break;
    prefix = dec[SC_PREFIXES].read(br);
    if (prefix >= PREFIX_RUN_BASE) {
      // Run accumulation with robust end-of-image handling (SURVEY A.8.8):
      // never read tokens past a run that fills the raster.
      uint64_t v = 0;
      int shift = 0;
      bool stream_done = false;
      for (;;) {
        v += static_cast<uint64_t>(prefix - PREFIX_RUN_BASE) << shift;
        shift += 3;
        uint64_t remaining = static_cast<uint64_t>(N - pos);
        if (v + 1 >= remaining) {
          stream_done = true;
          break;
        }
        if (shift >= 63 || v + (1ull << shift) + 1 > remaining) {
          prefix = dec[SC_PREFIXES].read(br);
          break;
        }
        prefix = dec[SC_PREFIXES].read(br);
        if (prefix < PREFIX_RUN_BASE) break;
      }
      uint64_t copies = std::min<uint64_t>(v + 1, static_cast<uint64_t>(N - pos));
      const uint8_t* src = out + 3 * prev;
      uint8_t* dst = out + 3 * pos;
      for (uint64_t i = 0; i < copies; i++) {
        dst[3 * i] = src[0];
        dst[3 * i + 1] = src[1];
        dst[3 * i + 2] = src[2];
      }
      prev = pos + static_cast<int64_t>(copies) - 1;
      pos += static_cast<int64_t>(copies);
      if (stream_done || pos >= N) break;
    }
  }
  return 0;
}

}  // extern "C"
