// Native host-side audio I/O of the port's data pipeline (a copy of the
// JAX package's native/audio_io.cpp, kept beside the port's CUDA sources).
//
// A RIFF/WAVE decoder (PCM 8/16/24/32, IEEE-float 32/64,
// WAVE_FORMAT_EXTENSIBLE) with channel-mean mono mixdown, a FLAC decoder,
// and a linear-interpolation resampler for tempo perturbation. Exposed via
// ctypes (mtl_tpu_torch/data/audio.py), which keeps a numpy fallback for
// WAV and the resampler.
//
// Built at first use by mtl_tpu_torch/utils/host_native.py:
// g++ -O3 -march=native -shared -fPIC audio_io.cpp -o libaudio_io-<hash>.so

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct WavData {
  std::vector<uint8_t> fmt;
  std::vector<uint8_t> data;
  bool ok = false;
};

// Stream the RIFF chunk list, keeping only fmt + data (mirrors the Python
// fallback parser in mtl_tpu_torch/data/audio.py:_load_wav_riff, including the
// odd-size chunk padding rule).
WavData read_riff(const char* path) {
  WavData w;
  FILE* f = std::fopen(path, "rb");
  if (!f) return w;
  uint8_t header[12];
  if (std::fread(header, 1, 12, f) != 12 || std::memcmp(header, "RIFF", 4) ||
      std::memcmp(header + 8, "WAVE", 4)) {
    std::fclose(f);
    return w;
  }
  uint8_t chunk[8];
  while (std::fread(chunk, 1, 8, f) == 8) {
    const uint32_t size = chunk[4] | (chunk[5] << 8) | (chunk[6] << 16) |
                          (uint32_t(chunk[7]) << 24);
    const uint32_t padded = size + (size & 1);
    if (!std::memcmp(chunk, "fmt ", 4)) {
      w.fmt.resize(size);
      if (std::fread(w.fmt.data(), 1, size, f) != size) break;
      if (size & 1) std::fseek(f, 1, SEEK_CUR);
    } else if (!std::memcmp(chunk, "data", 4)) {
      w.data.resize(size);
      if (std::fread(w.data.data(), 1, size, f) != size) w.data.resize(0);
      if (size & 1) std::fseek(f, 1, SEEK_CUR);
    } else {
      std::fseek(f, long(padded), SEEK_CUR);
    }
    if (!w.fmt.empty() && !w.data.empty()) break;
  }
  std::fclose(f);
  w.ok = w.fmt.size() >= 16 && !w.data.empty();
  return w;
}

uint16_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}

struct Fmt {
  uint16_t codec, channels, bits;
  uint32_t rate;
};

Fmt parse_fmt(const std::vector<uint8_t>& fmt) {
  Fmt r;
  r.codec = le16(&fmt[0]);
  r.channels = le16(&fmt[2]);
  r.rate = le32(&fmt[4]);
  r.bits = le16(&fmt[14]);
  if (r.codec == 0xFFFE && fmt.size() >= 26) r.codec = le16(&fmt[24]);
  return r;
}

// per-sample decode to float in [-1, 1] — the exact scaling constants of
// mtl_tpu_torch/data/audio.py:_pcm_to_float
double sample_at(const uint8_t* d, size_t i, const Fmt& f) {
  switch (f.codec) {
    case 1:  // PCM
      switch (f.bits) {
        case 16: {
          int16_t v;
          std::memcpy(&v, d + 2 * i, 2);
          return v / 32768.0;
        }
        case 32: {
          int32_t v;
          std::memcpy(&v, d + 4 * i, 4);
          return v / 2147483648.0;
        }
        case 8:
          return (d[i] - 128.0) / 128.0;
        case 24: {
          int32_t v = d[3 * i] | (d[3 * i + 1] << 8) | (d[3 * i + 2] << 16);
          if (v >= (1 << 23)) v -= (1 << 24);
          return v / double(1 << 23);
        }
      }
      return 0.0;
    case 3:  // IEEE float
      if (f.bits == 32) {
        float v;
        std::memcpy(&v, d + 4 * i, 4);
        return v;
      }
      if (f.bits == 64) {
        double v;
        std::memcpy(&v, d + 8 * i, 8);
        return v;
      }
      return 0.0;
    default:
      return 0.0;
  }
}

bool supported(const Fmt& f) {
  if (f.codec == 1) return f.bits == 8 || f.bits == 16 || f.bits == 24 ||
                           f.bits == 32;
  if (f.codec == 3) return f.bits == 32 || f.bits == 64;
  return false;
}

// ---------------------------------------------------------------------------
// FLAC decoder (from scratch; no libFLAC).
//
// The reference decodes arbitrary codecs through torchaudio
// (utils/audio.py:7-9); real CommonVoice ships mp3/flac. This implements the
// FLAC bitstream per the format spec: STREAMINFO metadata, frame headers
// (UTF-8 frame numbers, block-size/rate/size codes), subframe types
// CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32), Rice/Rice2 partitioned
// residuals, wasted bits, and all stereo decorrelation modes
// (left/side, right/side, mid/side). CRCs/MD5 are not verified (decode
// trusts well-formed files; a malformed stream returns an error).
// ---------------------------------------------------------------------------

namespace flac {

struct BitReader {
  const uint8_t* d;
  size_t n;        // total bytes
  size_t bit = 0;  // next bit index (msb-first)
  bool err = false;

  bool eof() const { return bit >= n * 8; }

  uint64_t bits(int k) {  // k <= 57
    uint64_t v = 0;
    for (int i = 0; i < k; ++i) {
      const size_t byte = bit >> 3;
      if (byte >= n) {
        err = true;
        return 0;
      }
      v = (v << 1) | ((d[byte] >> (7 - (bit & 7))) & 1);
      ++bit;
    }
    return v;
  }

  int64_t sbits(int k) {  // two's complement
    uint64_t v = bits(k);
    if (k > 0 && (v >> (k - 1)) & 1) return int64_t(v) - (int64_t(1) << k);
    return int64_t(v);
  }

  uint32_t unary() {  // count 0s until a 1
    uint32_t q = 0;
    while (!err) {
      const size_t byte = bit >> 3;
      if (byte >= n) {
        err = true;
        return 0;
      }
      if ((d[byte] >> (7 - (bit & 7))) & 1) {
        ++bit;
        return q;
      }
      ++bit;
      ++q;
      if (q > 1u << 24) {  // corrupt stream guard
        err = true;
        return 0;
      }
    }
    return 0;
  }

  void align() { bit = (bit + 7) & ~size_t(7); }
};

struct StreamInfo {
  uint32_t sample_rate = 0, channels = 0, bps = 0;
  uint64_t total_samples = 0;
  size_t audio_start = 0;  // byte offset of the first frame
  bool ok = false;
};

StreamInfo parse_header(const std::vector<uint8_t>& f) {
  StreamInfo si;
  if (f.size() < 42 || std::memcmp(f.data(), "fLaC", 4)) return si;
  size_t pos = 4;
  bool last = false;
  while (!last && pos + 4 <= f.size()) {
    last = f[pos] & 0x80;
    const uint32_t type = f[pos] & 0x7F;
    const uint32_t len = (f[pos + 1] << 16) | (f[pos + 2] << 8) | f[pos + 3];
    pos += 4;
    if (pos + len > f.size()) return si;
    if (type == 0 && len >= 34) {  // STREAMINFO
      const uint8_t* p = &f[pos];
      si.sample_rate = (p[10] << 12) | (p[11] << 4) | (p[12] >> 4);
      si.channels = ((p[12] >> 1) & 0x7) + 1;
      si.bps = (((p[12] & 1) << 4) | (p[13] >> 4)) + 1;
      si.total_samples = (uint64_t(p[13] & 0x0F) << 32) | (uint64_t(p[14]) << 24)
                         | (p[15] << 16) | (p[16] << 8) | p[17];
    }
    pos += len;
  }
  si.audio_start = pos;
  // bps bounds matter: decode_mono scales by 1 << (bps-1), so an absent or
  // crafted STREAMINFO with bps 0 (or 33+) would shift out of range
  si.ok = last && si.sample_rate && si.channels && si.bps >= 4 &&
          si.bps <= 32;
  return si;
}

void skip_utf8(BitReader& br) {  // frame/sample number (extended UTF-8)
  uint64_t b0 = br.bits(8);
  int follow = 0;
  for (uint64_t m = 0x80; b0 & m; m >>= 1) ++follow;
  if (follow) --follow;  // first 1-bit counts itself
  for (int i = 0; i < follow; ++i) br.bits(8);
}

// residual into x[order..blocksize)
bool read_residual(BitReader& br, int32_t* x, uint32_t blocksize,
                   uint32_t order) {
  const uint32_t method = uint32_t(br.bits(2));
  if (method > 1 || br.err) return false;
  const int pbits = method == 0 ? 4 : 5;
  const uint32_t escape = method == 0 ? 0xF : 0x1F;
  const uint32_t po = uint32_t(br.bits(4));
  const uint32_t parts = 1u << po;
  if (blocksize % parts || blocksize / parts <= 0) return false;
  // first partition holds (blocksize/parts - order) residuals; a crafted
  // stream with order > blocksize/parts would wrap cnt below (uint32) and
  // write ~4e9 samples past x
  if (order > blocksize / parts) return false;
  uint32_t idx = order;
  for (uint32_t p = 0; p < parts; ++p) {
    uint32_t cnt = blocksize / parts - (p == 0 ? order : 0);
    const uint32_t param = uint32_t(br.bits(pbits));
    if (param == escape) {
      const int raw = int(br.bits(5));
      for (uint32_t i = 0; i < cnt; ++i) x[idx++] = int32_t(br.sbits(raw));
    } else {
      for (uint32_t i = 0; i < cnt; ++i) {
        const uint32_t q = br.unary();
        const uint64_t r = br.bits(param);
        const uint64_t u = (uint64_t(q) << param) | r;
        x[idx++] = int32_t((u >> 1) ^ (~(u & 1) + 1));  // zigzag
      }
    }
    if (br.err) return false;
  }
  return idx == blocksize;
}

bool decode_subframe(BitReader& br, int32_t* x, uint32_t blocksize, int bps) {
  if (br.bits(1)) return false;  // padding bit must be 0
  const uint32_t type = uint32_t(br.bits(6));
  uint32_t wasted = 0;
  if (br.bits(1)) wasted = br.unary() + 1;
  bps -= wasted;
  if (br.err || bps <= 0 || bps > 33) return false;

  if (type == 0) {  // CONSTANT
    const int64_t v = br.sbits(bps);
    for (uint32_t i = 0; i < blocksize; ++i) x[i] = int32_t(v);
  } else if (type == 1) {  // VERBATIM
    for (uint32_t i = 0; i < blocksize; ++i) x[i] = int32_t(br.sbits(bps));
  } else if (type >= 8 && type <= 12) {  // FIXED order 0-4
    const uint32_t order = type - 8;
    if (order > blocksize) return false;
    for (uint32_t i = 0; i < order; ++i) x[i] = int32_t(br.sbits(bps));
    if (!read_residual(br, x, blocksize, order)) return false;
    for (uint32_t i = order; i < blocksize; ++i) {
      int64_t p = 0;
      switch (order) {
        case 0: p = 0; break;
        case 1: p = x[i - 1]; break;
        case 2: p = 2LL * x[i - 1] - x[i - 2]; break;
        case 3: p = 3LL * x[i - 1] - 3LL * x[i - 2] + x[i - 3]; break;
        case 4: p = 4LL * x[i - 1] - 6LL * x[i - 2] + 4LL * x[i - 3]
                    - x[i - 4]; break;
      }
      x[i] = int32_t(p + x[i]);
    }
  } else if (type >= 32) {  // LPC order 1-32
    const uint32_t order = (type & 31) + 1;
    if (order > blocksize) return false;
    for (uint32_t i = 0; i < order; ++i) x[i] = int32_t(br.sbits(bps));
    const uint32_t prec = uint32_t(br.bits(4)) + 1;
    if (prec == 16) return false;  // 0b1111 invalid
    const int shift = int(br.sbits(5));
    if (shift < 0) return false;
    int32_t coef[32];
    for (uint32_t i = 0; i < order; ++i) coef[i] = int32_t(br.sbits(prec));
    if (!read_residual(br, x, blocksize, order)) return false;
    for (uint32_t i = order; i < blocksize; ++i) {
      int64_t p = 0;
      for (uint32_t j = 0; j < order; ++j)
        p += int64_t(coef[j]) * x[i - 1 - j];
      x[i] = int32_t((p >> shift) + x[i]);
    }
  } else {
    return false;  // reserved type
  }
  if (wasted)
    // shift in uint64_t: wasted can be 32 (sub_bps 33, bps 1) and a 32-bit
    // shift by 32 is undefined behavior
    for (uint32_t i = 0; i < blocksize; ++i)
      x[i] = int32_t(uint32_t(uint64_t(uint32_t(x[i])) << wasted));
  return !br.err;
}

// Decode the whole stream to mono float32 (channel mean). Returns samples
// written, or -1 on error. With out == nullptr, runs a counting pass over
// every frame instead (for STREAMINFO total_samples == 0, the spec's legal
// "unknown length" of live-encoded streams); max_out is then ignored.
int64_t decode_mono(const std::vector<uint8_t>& file, const StreamInfo& si,
                    float* out, int64_t max_out) {
  BitReader br{file.data(), file.size()};
  br.bit = si.audio_start * 8;
  const double scale = 1.0 / double(1u << (si.bps - 1));
  int64_t written = 0;
  std::vector<std::vector<int32_t>> ch(si.channels);

  while (out == nullptr || written < max_out) {
    br.align();
    // find frame sync 0b11111111 111110xx
    while (!br.eof()) {
      const size_t byte = br.bit >> 3;
      if (byte + 1 < br.n && br.d[byte] == 0xFF &&
          (br.d[byte + 1] & 0xFC) == 0xF8)
        break;
      br.bit += 8;
    }
    if (br.eof()) break;
    br.bits(14);                      // sync
    br.bits(1);                       // reserved
    br.bits(1);                       // blocking strategy
    const uint32_t bs_code = uint32_t(br.bits(4));
    const uint32_t sr_code = uint32_t(br.bits(4));
    const uint32_t ch_code = uint32_t(br.bits(4));
    const uint32_t ss_code = uint32_t(br.bits(3));
    br.bits(1);  // reserved
    skip_utf8(br);

    uint32_t blocksize = 0;
    switch (bs_code) {
      case 0: return -1;  // reserved
      case 1: blocksize = 192; break;
      case 6: blocksize = uint32_t(br.bits(8)) + 1; break;
      case 7: blocksize = uint32_t(br.bits(16)) + 1; break;
      default:
        blocksize = bs_code <= 5 ? (576u << (bs_code - 2))
                                 : (256u << (bs_code - 8));
    }
    if (sr_code == 12) br.bits(8);       // rate in kHz (streaminfo rules)
    else if (sr_code == 13 || sr_code == 14) br.bits(16);
    br.bits(8);  // CRC-8

    int bps = int(si.bps);
    switch (ss_code) {
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: break;  // 0: from streaminfo
    }

    uint32_t nch = si.channels;
    int side_ch = -1;  // which subframe carries the side channel (bps+1)
    if (ch_code <= 7) {
      nch = ch_code + 1;
    } else if (ch_code == 8) {  // left/side
      nch = 2; side_ch = 1;
    } else if (ch_code == 9) {  // right/side
      nch = 2; side_ch = 0;
    } else if (ch_code == 10) {  // mid/side
      nch = 2; side_ch = 1;
    } else {
      return -1;
    }
    if (nch != si.channels || br.err) return -1;

    for (uint32_t c = 0; c < nch; ++c) {
      ch[c].resize(blocksize);
      const int sub_bps = bps + (int(c) == side_ch ? 1 : 0);
      if (!decode_subframe(br, ch[c].data(), blocksize, sub_bps)) return -1;
    }
    br.align();
    br.bits(16);  // CRC-16

    // stereo decorrelation
    if (ch_code == 8) {  // left/side: R = L - side
      for (uint32_t i = 0; i < blocksize; ++i)
        ch[1][i] = ch[0][i] - ch[1][i];
    } else if (ch_code == 9) {  // right/side: L = side + R
      for (uint32_t i = 0; i < blocksize; ++i)
        ch[0][i] = ch[0][i] + ch[1][i];
    } else if (ch_code == 10) {  // mid/side
      for (uint32_t i = 0; i < blocksize; ++i) {
        const int32_t side = ch[1][i];
        const int64_t mid = (int64_t(ch[0][i]) << 1) | (side & 1);
        ch[0][i] = int32_t((mid + side) >> 1);
        ch[1][i] = int32_t((mid - side) >> 1);
      }
    }

    const int64_t todo =
        out ? std::min<int64_t>(blocksize, max_out - written)
            : int64_t(blocksize);
    if (out)
      for (int64_t i = 0; i < todo; ++i) {
        double acc = 0.0;
        for (uint32_t c = 0; c < nch; ++c) acc += ch[c][i] * scale;
        out[written + i] = float(acc / nch);
      }
    written += todo;
  }
  return written;
}

std::vector<uint8_t> read_file(const char* path) {
  std::vector<uint8_t> buf;
  FILE* f = std::fopen(path, "rb");
  if (!f) return buf;
  std::fseek(f, 0, SEEK_END);
  const long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (sz > 0) {
    buf.resize(size_t(sz));
    if (std::fread(buf.data(), 1, size_t(sz), f) != size_t(sz)) buf.clear();
  }
  std::fclose(f);
  return buf;
}

}  // namespace flac

}  // namespace

extern "C" {

// FLAC probe: 0 on success (fills mono sample count + rate), -1 otherwise.
// STREAMINFO total_samples == 0 is the spec's legal "unknown length"
// (streamed/live-encoded FLAC): the frames are then counted by a decoding
// pass instead of rejecting the file as malformed.
int32_t flac_probe(const char* path, int64_t* n_mono, int32_t* sample_rate) {
  const std::vector<uint8_t> f = flac::read_file(path);
  const flac::StreamInfo si = flac::parse_header(f);
  if (!si.ok) return -1;
  int64_t n = int64_t(si.total_samples);
  if (n == 0) {
    n = flac::decode_mono(f, si, nullptr, 0);
    if (n <= 0) return -1;
  }
  *n_mono = n;
  *sample_rate = int32_t(si.sample_rate);
  return 0;
}

// FLAC decode to mono float32 (channel mean). Returns samples written >= 0,
// -1 on malformed stream. Zero-fills any tail the caller expected.
int64_t flac_decode(const char* path, float* out, int64_t n_mono) {
  const std::vector<uint8_t> f = flac::read_file(path);
  const flac::StreamInfo si = flac::parse_header(f);
  if (!si.ok) return -1;
  const int64_t got = flac::decode_mono(f, si, out, n_mono);
  if (got < 0) return -1;
  if (got < n_mono)
    std::memset(out + got, 0, size_t(n_mono - got) * sizeof(float));
  return got;
}

// Probe: fills *n_mono (mono sample count) and *sample_rate.
// Returns 0 on success, -1 on unreadable/non-RIFF, -2 on unsupported codec.
int32_t wav_probe(const char* path, int64_t* n_mono, int32_t* sample_rate) {
  WavData w = read_riff(path);
  if (!w.ok) return -1;
  Fmt f = parse_fmt(w.fmt);
  if (!supported(f) || f.channels == 0) return -2;
  const size_t bytes_per = f.bits / 8;
  const size_t n_samples = w.data.size() / bytes_per;
  *n_mono = int64_t(n_samples / f.channels);  // trims a partial tail frame
  *sample_rate = int32_t(f.rate);
  return 0;
}

// Decode to mono float32 (channel mean, float64 accumulate like numpy's
// .mean). `out` must hold n_mono floats (from wav_probe). Returns 0 on
// success. The common codecs get tight vectorizable loops — a per-sample
// format switch measured SLOWER than numpy's SIMD path.
int32_t wav_decode(const char* path, float* out, int64_t n_mono) {
  WavData w = read_riff(path);
  if (!w.ok) return -1;
  Fmt f = parse_fmt(w.fmt);
  if (!supported(f) || f.channels == 0) return -2;
  const uint8_t* d = w.data.data();
  const int ch = f.channels;
  // Re-derive the mono count from THIS read's data chunk: the file may have
  // shrunk between wav_probe and wav_decode (or the caller may pass an
  // oversized n_mono) — never trust the caller's count for loop bounds
  // (a heap over-read otherwise). Zero-fill any tail the caller expected.
  const int64_t n_here =
      int64_t(w.data.size() / (size_t(f.bits / 8) * f.channels));
  if (n_here < n_mono) {
    std::memset(out + n_here, 0, size_t(n_mono - n_here) * sizeof(float));
    n_mono = n_here;
  }
  if (ch == 1 && f.codec == 1 && f.bits == 16) {
    const int16_t* s = reinterpret_cast<const int16_t*>(d);
    constexpr float k = 1.0f / 32768.0f;
    for (int64_t i = 0; i < n_mono; ++i) out[i] = s[i] * k;
    return 0;
  }
  if (ch == 1 && f.codec == 3 && f.bits == 32) {
    std::memcpy(out, d, size_t(n_mono) * 4);
    return 0;
  }
  if (ch == 1 && f.codec == 1 && f.bits == 32) {
    const int32_t* s = reinterpret_cast<const int32_t*>(d);
    constexpr double k = 1.0 / 2147483648.0;
    for (int64_t i = 0; i < n_mono; ++i) out[i] = float(s[i] * k);
    return 0;
  }
  if (ch == 2 && f.codec == 1 && f.bits == 16) {
    const int16_t* s = reinterpret_cast<const int16_t*>(d);
    constexpr double k = 0.5 / 32768.0;
    for (int64_t i = 0; i < n_mono; ++i)
      out[i] = float((double(s[2 * i]) + double(s[2 * i + 1])) * k);
    return 0;
  }
  for (int64_t i = 0; i < n_mono; ++i) {
    double acc = 0.0;
    for (int c = 0; c < ch; ++c) acc += sample_at(d, size_t(i) * ch + c, f);
    out[i] = float(acc / ch);
  }
  return 0;
}

// Linear-interpolation resample matching numpy:
//   x_new = linspace(0, n_in-1, n_out); out = interp(x_new, arange(n_in), in)
// (mtl_tpu_torch/data/audio.py:resample_linear — tempo perturbation).
void resample_linear_f32(const float* in, int64_t n_in, int64_t n_out,
                         float* out) {
  if (n_in <= 1) {
    for (int64_t i = 0; i < n_out; ++i) out[i] = n_in ? in[0] : 0.0f;
    return;
  }
  const double step = double(n_in - 1) / double(n_out - 1 ? n_out - 1 : 1);
  for (int64_t i = 0; i < n_out; ++i) {
    const double x = (n_out == 1) ? 0.0 : i * step;
    int64_t lo = int64_t(x);
    if (lo >= n_in - 1) lo = n_in - 2;
    const double t = x - lo;
    out[i] = float(double(in[lo]) * (1.0 - t) + double(in[lo + 1]) * t);
  }
}

}  // extern "C"
