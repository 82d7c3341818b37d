// The NVC range coder, frozen: a copy of the port's
// elvis_tpu_torch/codec/nvc/csrc/rangecoder.cpp as the benchmark was
// defined, so that the reference's NVC decoder reads streams with code of
// its own. The reference calls only the two decoders.
//
// Coder: LZMA-style binary range coder (32-bit range, 64-bit low with
// carry propagation), 12-bit adaptive probabilities with shift-5 update.
// Binarization per coefficient: significance flag -> sign (bypass) ->
// magnitude bit-length in adaptive unary -> mantissa bits (bypass).
// Contexts: per zigzag-position bucket and neighbour significance.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kTopValue = 1u << 24;
constexpr int kProbBits = 12;
constexpr uint16_t kProbInit = 1 << (kProbBits - 1);
constexpr int kProbShift = 5;

struct RangeEncoder {
  uint64_t low = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint8_t cache = 0;
  int64_t cache_size = 1;
  std::vector<uint8_t>* out;

  explicit RangeEncoder(std::vector<uint8_t>* buf) : out(buf) {}

  void shift_low() {
    if (static_cast<uint32_t>(low) < 0xFF000000u || (low >> 32) != 0) {
      uint8_t carry = static_cast<uint8_t>(low >> 32);
      out->push_back(static_cast<uint8_t>(cache + carry));
      while (--cache_size) {
        out->push_back(static_cast<uint8_t>(0xFF + carry));
      }
      cache = static_cast<uint8_t>(low >> 24);
    }
    ++cache_size;
    low = (low << 8) & 0xFFFFFFFFu;
  }

  void encode_bit(uint16_t* prob, int bit) {
    uint32_t bound = (range >> kProbBits) * (*prob);
    if (bit == 0) {
      range = bound;
      *prob += (static_cast<uint16_t>((1 << kProbBits)) - *prob) >> kProbShift;
    } else {
      low += bound;
      range -= bound;
      *prob -= *prob >> kProbShift;
    }
    while (range < kTopValue) {
      range <<= 8;
      shift_low();
    }
  }

  void encode_bypass(int bit) {
    range >>= 1;
    if (bit) low += range;
    while (range < kTopValue) {
      range <<= 8;
      shift_low();
    }
  }

  void flush() {
    for (int i = 0; i < 5; ++i) shift_low();
  }
};

struct RangeDecoder {
  const uint8_t* in;
  size_t size;
  size_t pos = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint32_t code = 0;

  RangeDecoder(const uint8_t* data, size_t n) : in(data), size(n) {
    ++pos;  // first byte emitted by the encoder's priming shift is 0
    for (int i = 0; i < 4; ++i) code = (code << 8) | next_byte();
  }

  uint8_t next_byte() { return pos < size ? in[pos++] : 0; }

  int decode_bit(uint16_t* prob) {
    uint32_t bound = (range >> kProbBits) * (*prob);
    int bit;
    if (code < bound) {
      bit = 0;
      range = bound;
      *prob += (static_cast<uint16_t>((1 << kProbBits)) - *prob) >> kProbShift;
    } else {
      bit = 1;
      code -= bound;
      range -= bound;
      *prob -= *prob >> kProbShift;
    }
    while (range < kTopValue) {
      range <<= 8;
      code = (code << 8) | next_byte();
    }
    return bit;
  }

  int decode_bypass() {
    range >>= 1;
    int bit = 0;
    if (code >= range) {
      code -= range;
      bit = 1;
    }
    while (range < kTopValue) {
      range <<= 8;
      code = (code << 8) | next_byte();
    }
    return bit;
  }
};

// --- coefficient model ------------------------------------------------------
//
// Streams are arrays of int16 coefficients grouped in fixed-length blocks
// (block_len = b*b in zigzag order). Contexts:
//   cbf      : 4 ctx by previous block's cbf (2) x whether block 0 (2)
//   sig      : kPosBuckets x 2 (previous coefficient significant?)
//   len unary: kPosBuckets x 16

constexpr int kPosBuckets = 16;
constexpr int kMaxLenBits = 16;

struct CoeffModel {
  uint16_t cbf[4];
  uint16_t sig[kPosBuckets][2];
  uint16_t len[kPosBuckets][kMaxLenBits];

  CoeffModel() {
    for (auto& p : cbf) p = kProbInit;
    for (auto& row : sig)
      for (auto& p : row) p = kProbInit;
    for (auto& row : len)
      for (auto& p : row) p = kProbInit;
  }
};

inline int pos_bucket(int i, int block_len) {
  int b = (i * kPosBuckets) / (block_len > 0 ? block_len : 1);
  return b < kPosBuckets ? b : kPosBuckets - 1;
}

inline int bit_length(uint32_t v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

}  // namespace

extern "C" {

// Encode n coefficients (n % block_len == 0). Returns number of bytes
// written, or -1 if out_cap is insufficient.
long long nvc_rc_encode(const int16_t* coeffs, long long n, int block_len,
                        uint8_t* out, long long out_cap) {
  std::vector<uint8_t> buf;
  buf.reserve(static_cast<size_t>(n / 4 + 64));
  RangeEncoder rc(&buf);
  CoeffModel m;

  int prev_cbf = 0;
  for (long long base = 0; base < n; base += block_len) {
    int any = 0;
    for (int i = 0; i < block_len; ++i)
      if (coeffs[base + i] != 0) {
        any = 1;
        break;
      }
    int cbf_ctx = (prev_cbf << 1) | (base == 0 ? 1 : 0);
    rc.encode_bit(&m.cbf[cbf_ctx], any);
    prev_cbf = any;
    if (!any) continue;

    int prev_sig = 1;
    for (int i = 0; i < block_len; ++i) {
      int16_t c = coeffs[base + i];
      int pb = pos_bucket(i, block_len);
      int sig = c != 0;
      rc.encode_bit(&m.sig[pb][prev_sig], sig);
      prev_sig = sig;
      if (!sig) continue;
      rc.encode_bypass(c < 0);
      uint32_t mag = static_cast<uint32_t>(c < 0 ? -c : c);  // >= 1
      int nb = bit_length(mag) - 1;  // 0..15
      for (int k = 0; k < nb; ++k) rc.encode_bit(&m.len[pb][k], 1);
      if (nb < kMaxLenBits) rc.encode_bit(&m.len[pb][nb], 0);
      for (int k = nb - 1; k >= 0; --k) rc.encode_bypass((mag >> k) & 1);
    }
  }
  rc.flush();

  if (static_cast<long long>(buf.size()) > out_cap) return -1;
  std::memcpy(out, buf.data(), buf.size());
  return static_cast<long long>(buf.size());
}

// Decode exactly n coefficients from the stream.
long long nvc_rc_decode(const uint8_t* in, long long in_size, long long n,
                        int block_len, int16_t* coeffs) {
  RangeDecoder rc(in, static_cast<size_t>(in_size));
  CoeffModel m;

  int prev_cbf = 0;
  for (long long base = 0; base < n; base += block_len) {
    int cbf_ctx = (prev_cbf << 1) | (base == 0 ? 1 : 0);
    int any = rc.decode_bit(&m.cbf[cbf_ctx]);
    prev_cbf = any;
    if (!any) {
      std::memset(coeffs + base, 0, sizeof(int16_t) * block_len);
      continue;
    }
    int prev_sig = 1;
    for (int i = 0; i < block_len; ++i) {
      int pb = pos_bucket(i, block_len);
      int sig = rc.decode_bit(&m.sig[pb][prev_sig]);
      prev_sig = sig;
      if (!sig) {
        coeffs[base + i] = 0;
        continue;
      }
      int neg = rc.decode_bypass();
      int nb = 0;
      while (nb < kMaxLenBits && rc.decode_bit(&m.len[pb][nb])) ++nb;
      uint32_t mag = 1;
      for (int k = 0; k < nb; ++k) mag = (mag << 1) | rc.decode_bypass();
      coeffs[base + i] = static_cast<int16_t>(neg ? -static_cast<int>(mag)
                                                  : static_cast<int>(mag));
    }
  }
  return n;
}

// Generic adaptive bit-plane coder for small side-channel maps (modes,
// delta-QP maps): encodes bytes as 8 binary decisions with per-bit-position
// contexts conditioned on the previous byte's bit.
long long nvc_rc_encode_bytes(const uint8_t* data, long long n, uint8_t* out,
                              long long out_cap) {
  std::vector<uint8_t> buf;
  buf.reserve(static_cast<size_t>(n / 2 + 64));
  RangeEncoder rc(&buf);
  uint16_t probs[8][2][256];
  for (auto& a : probs)
    for (auto& b : a)
      for (auto& p : b) p = kProbInit;
  uint8_t prev = 0;
  for (long long i = 0; i < n; ++i) {
    uint8_t v = data[i];
    for (int k = 7; k >= 0; --k) {
      int bit = (v >> k) & 1;
      int pbit = (prev >> k) & 1;
      // context: bit position, same bit of previous byte, bits decoded so far
      int sofar = k == 7 ? 0 : (v >> (k + 1));
      rc.encode_bit(&probs[k][pbit][sofar & 0xFF], bit);
    }
    prev = v;
  }
  rc.flush();
  if (static_cast<long long>(buf.size()) > out_cap) return -1;
  std::memcpy(out, buf.data(), buf.size());
  return static_cast<long long>(buf.size());
}

long long nvc_rc_decode_bytes(const uint8_t* in, long long in_size,
                              long long n, uint8_t* data) {
  RangeDecoder rc(in, static_cast<size_t>(in_size));
  uint16_t probs[8][2][256];
  for (auto& a : probs)
    for (auto& b : a)
      for (auto& p : b) p = kProbInit;
  uint8_t prev = 0;
  for (long long i = 0; i < n; ++i) {
    uint8_t v = 0;
    for (int k = 7; k >= 0; --k) {
      int pbit = (prev >> k) & 1;
      int sofar = k == 7 ? 0 : (v >> (k + 1));
      int bit = rc.decode_bit(&probs[k][pbit][sofar & 0xFF]);
      v = static_cast<uint8_t>(v | (bit << k));
    }
    data[i] = v;
    prev = v;
  }
  return n;
}

}  // extern "C"
