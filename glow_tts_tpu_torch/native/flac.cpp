// Native FLAC decoder (host-side ETL acceleration).
//
// Twin of the pure-Python codec in glow_tts_tpu/data/flac.py (RFC 9639 /
// xiph.org spec): STREAMINFO, frame headers (all block-size / sample-rate /
// sample-size codes), subframe types CONSTANT / VERBATIM / FIXED(0-4) /
// LPC(1-32), wasted bits, Rice/Rice2 residual with escape partitions,
// stereo decorrelation (left-side / side-right / mid-side), CRC-8 and
// CRC-16 verification.  The Python module stays the oracle (and the
// encoder); this kernel is the production decode path for flac corpora
// (LibriTTS) where the reference leans on librosa/soundfile
// (/root/reference/Audio.py:3-7).  MD5 verification of the decoded stream
// is done by the ctypes wrapper (vectorised hashlib over the decoded
// samples) — every frame here is still CRC-16 checked.
//
// API (ctypes, see glow_tts_tpu/data/flac_native.py):
//   flac_decode(data, size, out, out_capacity, meta[4], err, err_cap)
//     out == nullptr  -> probe: fill meta, return total samples/channel
//     out != nullptr  -> decode interleaved int32 [total, channels]
//   returns total samples per channel, or -1 (error; err filled).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------- CRC ----
struct CrcTables {
  uint8_t crc8[256];
  uint16_t crc16[256];
  CrcTables() {
    for (int i = 0; i < 256; ++i) {
      uint32_t c8 = static_cast<uint32_t>(i);
      for (int b = 0; b < 8; ++b)
        c8 = (c8 & 0x80u) ? ((c8 << 1) ^ 0x07u) : (c8 << 1);
      crc8[i] = static_cast<uint8_t>(c8 & 0xFFu);
      uint32_t c16 = static_cast<uint32_t>(i) << 8;
      for (int b = 0; b < 8; ++b)
        c16 = (c16 & 0x8000u) ? ((c16 << 1) ^ 0x8005u) : (c16 << 1);
      crc16[i] = static_cast<uint16_t>(c16 & 0xFFFFu);
    }
  }
};
const CrcTables kCrc;

uint8_t Crc8(const uint8_t* data, int64_t n) {
  uint8_t crc = 0;
  for (int64_t i = 0; i < n; ++i) crc = kCrc.crc8[crc ^ data[i]];
  return crc;
}

uint16_t Crc16(const uint8_t* data, int64_t n) {
  uint16_t crc = 0;
  for (int64_t i = 0; i < n; ++i)
    crc = static_cast<uint16_t>(kCrc.crc16[((crc >> 8) ^ data[i]) & 0xFF] ^
                                ((crc << 8) & 0xFFFF));
  return crc;
}

// ---------------------------------------------------------- bit reader ----
struct Reader {
  const uint8_t* data;
  int64_t nbits;
  int64_t pos = 0;
  bool fail = false;
  char msg[160];

  Reader(const uint8_t* d, int64_t nbytes)
      : data(d), nbits(nbytes * 8) {
    msg[0] = '\0';
  }

  void Error(const char* text) {
    if (!fail) {
      fail = true;
      snprintf(msg, sizeof(msg), "%s", text);
    }
  }

  uint64_t Read(int n) {  // n <= 57
    if (n == 0 || fail) return 0;
    if (pos + n > nbits) {
      Error("flac: truncated stream");
      return 0;
    }
    uint64_t v = 0;
    int64_t p = pos;
    pos += n;
    while (n > 0) {
      const int64_t byte = p >> 3;
      const int bit = static_cast<int>(p & 7);
      int take = 8 - bit;
      if (take > n) take = n;
      const uint8_t b = data[byte];
      const uint8_t chunk =
          static_cast<uint8_t>(static_cast<uint8_t>(b << bit) >> (8 - take));
      v = (v << take) | chunk;
      p += take;
      n -= take;
    }
    return v;
  }

  int64_t ReadSigned(int n) {
    if (n == 0) return 0;
    const uint64_t v = Read(n);
    const uint64_t sign = 1ull << (n - 1);
    return (v & sign) ? static_cast<int64_t>(v) - (1ll << n)
                      : static_cast<int64_t>(v);
  }

  int Unary() {
    int count = 0;
    while (!fail) {
      if (pos >= nbits) {
        Error("flac: truncated unary code");
        return 0;
      }
      const int64_t byte = pos >> 3;
      const int bit = static_cast<int>(pos & 7);
      const uint8_t rest = static_cast<uint8_t>(data[byte] << bit);
      if (rest) {
        const int lead = __builtin_clz(static_cast<unsigned>(rest)) - 24;
        count += lead;
        pos += lead + 1;
        return count;
      }
      count += 8 - bit;
      pos += 8 - bit;
    }
    return 0;
  }

  void Align() { pos = (pos + 7) / 8 * 8; }
  int64_t BytePos() const { return pos / 8; }
};

// ------------------------------------------------------------- tables ----
int BlockSizeFromCode(int code) {
  static const int sizes[16] = {-1, 192,  576,  1152, 2304, 4608, -2,   -3,
                                256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
  return sizes[code & 15];
}

int SampleSizeFromCode(int code) {
  static const int sizes[8] = {0, 8, 12, -1, 16, 20, 24, 32};
  return sizes[code & 7];
}

int64_t Utf8Decode(Reader& r) {
  const uint64_t first = r.Read(8);
  if (first < 0x80) return static_cast<int64_t>(first);
  int n = 0;
  uint64_t probe = first;
  while (probe & 0x80) {
    ++n;
    probe = (probe << 1) & 0xFF;
  }
  if (n < 2 || n > 7) {
    r.Error("flac: bad UTF-8 coded number");
    return -1;
  }
  uint64_t value = first & (0x7Fu >> n);
  for (int i = 0; i < n - 1; ++i) {
    const uint64_t cont = r.Read(8);
    if ((cont & 0xC0) != 0x80) {
      r.Error("flac: bad UTF-8 continuation byte");
      return -1;
    }
    value = (value << 6) | (cont & 0x3F);
  }
  return static_cast<int64_t>(value);
}

// ----------------------------------------------------------- residual ----
bool ReadResidual(Reader& r, int block_size, int order, int64_t* residual) {
  const uint64_t method = r.Read(2);
  if (method > 1) {
    r.Error("flac: reserved residual coding method");
    return false;
  }
  const int param_bits = method == 0 ? 4 : 5;
  const uint64_t escape = (1ull << param_bits) - 1;
  const int partition_order = static_cast<int>(r.Read(4));
  const int partitions = 1 << partition_order;
  if (block_size % partitions) {
    r.Error("flac: block size not divisible by partitions");
    return false;
  }
  const int samples_per = block_size >> partition_order;
  int64_t out = 0;
  for (int p = 0; p < partitions && !r.fail; ++p) {
    const int count = samples_per - (p == 0 ? order : 0);
    const uint64_t param = r.Read(param_bits);
    if (param == escape) {
      const int raw_bits = static_cast<int>(r.Read(5));
      for (int i = 0; i < count; ++i)
        residual[out + i] = raw_bits ? r.ReadSigned(raw_bits) : 0;
    } else {
      const int k = static_cast<int>(param);
      for (int i = 0; i < count; ++i) {
        const uint64_t q = static_cast<uint64_t>(r.Unary());
        const uint64_t v = (q << k) | r.Read(k);
        residual[out + i] =
            static_cast<int64_t>(v >> 1) ^ -static_cast<int64_t>(v & 1);
      }
    }
    out += count;
  }
  return !r.fail;
}

// ----------------------------------------------------------- subframe ----
// x: caller-provided scratch of block_size int64.
bool ReadSubframe(Reader& r, int block_size, int bps, int64_t* x,
                  std::vector<int64_t>& residual_scratch) {
  static const int kFixed[5][4] = {
      {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};
  if (r.Read(1)) {
    r.Error("flac: subframe padding bit set");
    return false;
  }
  const int sf_type = static_cast<int>(r.Read(6));
  int wasted = 0;
  if (r.Read(1)) wasted = r.Unary() + 1;
  bps -= wasted;

  int order = 0;
  int64_t coeffs[32];
  int shift = 0;
  bool predicted = false;

  if (sf_type == 0) {  // CONSTANT
    const int64_t value = r.ReadSigned(bps);
    for (int i = 0; i < block_size; ++i) x[i] = value;
  } else if (sf_type == 1) {  // VERBATIM
    for (int i = 0; i < block_size; ++i) x[i] = r.ReadSigned(bps);
  } else if (sf_type >= 8 && sf_type <= 12) {  // FIXED 0-4
    order = sf_type - 8;
    for (int i = 0; i < order; ++i) x[i] = r.ReadSigned(bps);
    for (int i = 0; i < order; ++i) coeffs[i] = kFixed[order][i];
    shift = 0;
    predicted = true;
  } else if (sf_type >= 32) {  // LPC 1-32
    order = (sf_type & 31) + 1;
    for (int i = 0; i < order; ++i) x[i] = r.ReadSigned(bps);
    const int precision = static_cast<int>(r.Read(4)) + 1;
    if (precision == 16) {
      r.Error("flac: invalid LPC precision code");
      return false;
    }
    shift = static_cast<int>(r.ReadSigned(5));
    if (shift < 0) {
      r.Error("flac: negative LPC shift");
      return false;
    }
    for (int i = 0; i < order; ++i) coeffs[i] = r.ReadSigned(precision);
    predicted = true;
  } else {
    r.Error("flac: reserved subframe type");
    return false;
  }

  if (predicted) {
    if (static_cast<int>(residual_scratch.size()) < block_size)
      residual_scratch.resize(block_size);
    int64_t* residual = residual_scratch.data();
    if (!ReadResidual(r, block_size, order, residual)) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t acc = 0;
      for (int j = 0; j < order; ++j) acc += coeffs[j] * x[i - 1 - j];
      x[i] = (acc >> shift) + residual[i - order];
    }
  }
  if (r.fail) return false;
  if (wasted)
    for (int i = 0; i < block_size; ++i) x[i] <<= wasted;
  return true;
}

}  // namespace

extern "C" int64_t flac_decode(const uint8_t* data, int64_t size,
                               int32_t* out, int64_t out_capacity,
                               int32_t* meta, char* err, int32_t err_cap) {
  auto error = [&](const char* text) -> int64_t {
    if (err && err_cap > 0) snprintf(err, err_cap, "%s", text);
    return -1;
  };
  if (size < 4 || memcmp(data, "fLaC", 4) != 0)
    return error("flac: missing fLaC marker");

  // ---- metadata blocks ----
  int64_t offset = 4;
  bool have_info = false;
  int channels = 0, bits_per_sample = 0;
  int64_t sample_rate = 0, total_samples = 0;
  while (true) {
    if (offset + 4 > size) return error("flac: truncated metadata");
    const uint8_t header = data[offset];
    const int64_t length = (static_cast<int64_t>(data[offset + 1]) << 16) |
                           (static_cast<int64_t>(data[offset + 2]) << 8) |
                           static_cast<int64_t>(data[offset + 3]);
    if (offset + 4 + length > size) return error("flac: truncated metadata");
    if ((header & 0x7F) == 0) {  // STREAMINFO
      if (length < 34) return error("flac: short STREAMINFO");
      const uint8_t* raw = data + offset + 4;
      uint64_t packed = 0;
      for (int i = 10; i < 18; ++i) packed = (packed << 8) | raw[i];
      sample_rate = static_cast<int64_t>(packed >> 44);
      channels = static_cast<int>((packed >> 41) & 0x7) + 1;
      bits_per_sample = static_cast<int>((packed >> 36) & 0x1F) + 1;
      total_samples = static_cast<int64_t>(packed & ((1ull << 36) - 1));
      have_info = true;
    }
    offset += 4 + length;
    if (header & 0x80) break;
  }
  if (!have_info) return error("flac: no STREAMINFO block");
  if (meta) {
    meta[0] = channels;
    meta[1] = static_cast<int32_t>(sample_rate);
    meta[2] = bits_per_sample;
    meta[3] = 0;
  }
  if (out == nullptr) return total_samples;  // probe
  if (total_samples == 0)
    return error("flac: unknown total sample count (use the python decoder)");
  if (out_capacity < total_samples * channels)
    return error("flac: output buffer too small");

  // ---- frames ----
  Reader r(data + offset, size - offset);
  std::vector<int64_t> sub[8];
  std::vector<int64_t> residual_scratch;
  int64_t written = 0;  // samples per channel
  while (r.nbits - r.pos >= 16 && written < total_samples) {
    const int64_t frame_start = r.BytePos();
    if (r.Read(14) != 0x3FFE) return error("flac: lost frame sync");
    r.Read(1);  // reserved
    r.Read(1);  // blocking strategy
    const int bs_code = static_cast<int>(r.Read(4));
    const int sr_code = static_cast<int>(r.Read(4));
    const int ch_code = static_cast<int>(r.Read(4));
    const int ss_code = static_cast<int>(r.Read(3));
    r.Read(1);  // reserved
    if (Utf8Decode(r) < 0) return error(r.msg);

    int block_size;
    if (bs_code == 6) {
      block_size = static_cast<int>(r.Read(8)) + 1;
    } else if (bs_code == 7) {
      block_size = static_cast<int>(r.Read(16)) + 1;
    } else {
      block_size = BlockSizeFromCode(bs_code);
      if (block_size < 0) return error("flac: reserved block size code");
    }
    if (sr_code == 12) {
      r.Read(8);
    } else if (sr_code == 13 || sr_code == 14) {
      r.Read(16);
    } else if (sr_code == 15) {
      return error("flac: bad sample rate code");
    }
    int bps = bits_per_sample;
    if (ss_code != 0) {
      bps = SampleSizeFromCode(ss_code);
      if (bps <= 0) return error("flac: reserved sample size code");
    }
    const uint8_t crc8_read_ahead =
        static_cast<uint8_t>(Crc8(r.data + frame_start,
                                  r.BytePos() - frame_start));
    if (crc8_read_ahead != static_cast<uint8_t>(r.Read(8)))
      return error("flac: frame header CRC-8 mismatch");

    int n_channels;
    if (ch_code < 8) {
      n_channels = ch_code + 1;
    } else if (ch_code <= 10) {
      n_channels = 2;
    } else {
      return error("flac: reserved channel assignment");
    }
    if (n_channels != channels)
      return error("flac: frame channel count differs from STREAMINFO");

    for (int c = 0; c < n_channels; ++c)
      if (static_cast<int>(sub[c].size()) < block_size)
        sub[c].resize(block_size);

    if (ch_code < 8) {
      for (int c = 0; c < n_channels; ++c)
        if (!ReadSubframe(r, block_size, bps, sub[c].data(),
                          residual_scratch))
          return error(r.msg);
    } else {
      const int a_bps = bps + (ch_code == 9 ? 1 : 0);
      const int b_bps = bps + (ch_code == 8 || ch_code == 10 ? 1 : 0);
      if (!ReadSubframe(r, block_size, a_bps, sub[0].data(),
                        residual_scratch) ||
          !ReadSubframe(r, block_size, b_bps, sub[1].data(),
                        residual_scratch))
        return error(r.msg);
      int64_t* a = sub[0].data();
      int64_t* b = sub[1].data();
      if (ch_code == 8) {  // left / side
        for (int i = 0; i < block_size; ++i) b[i] = a[i] - b[i];
      } else if (ch_code == 9) {  // side / right
        for (int i = 0; i < block_size; ++i) a[i] = a[i] + b[i];
      } else {  // mid / side
        for (int i = 0; i < block_size; ++i) {
          const int64_t mid = (a[i] << 1) | (b[i] & 1);
          a[i] = (mid + b[i]) >> 1;
          b[i] = (mid - b[i]) >> 1;
        }
      }
    }

    r.Align();
    if (r.fail) return error(r.msg);
    const uint16_t crc = Crc16(r.data + frame_start,
                               r.BytePos() - frame_start);
    if (crc != static_cast<uint16_t>(r.Read(16)))
      return error("flac: frame CRC-16 mismatch");
    if (r.fail) return error(r.msg);

    const int64_t take =
        block_size < total_samples - written
            ? block_size
            : total_samples - written;
    for (int64_t i = 0; i < take; ++i)
      for (int c = 0; c < channels; ++c)
        out[(written + i) * channels + c] =
            static_cast<int32_t>(sub[c][i]);
    written += take;
  }
  if (written < total_samples)
    return error("flac: stream ended before the declared sample count");
  return written;
}
