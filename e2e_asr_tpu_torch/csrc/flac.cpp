// Native FLAC decoder of the PyTorch port (host C++, not a CUDA kernel).
//
// The port's copy of the JAX package's csrc/flac.cpp: CONSTANT / VERBATIM /
// FIXED(0-4) / LPC subframes, Rice and Rice2 partitioned residuals (escape
// codes included), wasted bits, UTF-8 frame numbers and the stereo
// decorrelations (left/side, right/side, mid/side); channel 0 is returned.
// What differs from that file: a frame that ends early (a subframe that
// cannot be decoded, a frame CRC past the end of the file) fails the whole
// decode with -1 instead of returning the samples before it, so that a
// truncated file raises in the caller.
//
// Built with native.cpp by e2e_asr_tpu_torch/native.py.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte = 0;
  int bit = 0;  // bits consumed of current byte (0..7)
  bool error = false;

  bool aligned() const { return bit == 0; }
  void align() {
    if (bit) {
      bit = 0;
      ++byte;
    }
  }
  uint64_t bits(int n) {
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) {
      if (byte >= size) {
        error = true;
        return 0;
      }
      v = (v << 1) | ((data[byte] >> (7 - bit)) & 1);
      if (++bit == 8) {
        bit = 0;
        ++byte;
      }
    }
    return v;
  }
  int64_t sbits(int n) {
    uint64_t v = bits(n);
    if (n == 0) return 0;
    if (v & (1ull << (n - 1))) return (int64_t)(v | (~0ull << n));
    return (int64_t)v;
  }
  uint32_t unary() {
    uint32_t q = 0;
    while (!error && bits(1) == 0) {
      ++q;
      if (q > 1u << 24) {  // corrupt stream guard
        error = true;
        return 0;
      }
    }
    return q;
  }
};

const int64_t kFixedCoef[5][4] = {
    {},
    {1},
    {2, -1},
    {3, -3, 1},
    {4, -6, 4, -1},
};

bool decode_residual(BitReader& br, int blocksize, int order,
                     std::vector<int64_t>& out) {
  int method = (int)br.bits(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  int escape = method == 0 ? 0xF : 0x1F;
  int porder = (int)br.bits(4);
  int nparts = 1 << porder;
  if (blocksize % nparts) return false;
  int idx = order;
  for (int p = 0; p < nparts; ++p) {
    int n = blocksize >> porder;
    if (p == 0) n -= order;
    if (n < 0) return false;
    int param = (int)br.bits(plen);
    if (param == escape) {
      int nbits = (int)br.bits(5);
      for (int i = 0; i < n; ++i) out[idx++] = nbits ? br.sbits(nbits) : 0;
    } else {
      for (int i = 0; i < n; ++i) {
        uint32_t q = br.unary();
        uint64_t r = param ? br.bits(param) : 0;
        uint64_t u = ((uint64_t)q << param) | r;
        out[idx++] = (u & 1) ? -(int64_t)(u >> 1) - 1 : (int64_t)(u >> 1);
      }
    }
    if (br.error) return false;
  }
  return true;
}

bool decode_subframe(BitReader& br, int blocksize, int bps,
                     std::vector<int64_t>& out) {
  if (br.bits(1) != 0) return false;  // zero pad bit
  int type = (int)br.bits(6);
  int wasted = 0;
  if (br.bits(1)) wasted = 1 + (int)br.unary();
  bps -= wasted;
  out.assign(blocksize, 0);

  if (type == 0) {  // CONSTANT
    int64_t v = br.sbits(bps);
    for (int i = 0; i < blocksize; ++i) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; ++i) out[i] = br.sbits(bps);
  } else if ((type & 0x38) == 0x08 && (type & 7) <= 4) {  // FIXED
    int order = type & 7;
    for (int i = 0; i < order; ++i) out[i] = br.sbits(bps);
    if (!decode_residual(br, blocksize, order, out)) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += kFixedCoef[order][j] * out[i - 1 - j];
      out[i] += pred;
    }
  } else if (type & 0x20) {  // LPC
    int order = (type & 0x1F) + 1;
    for (int i = 0; i < order; ++i) out[i] = br.sbits(bps);
    int precision = (int)br.bits(4) + 1;
    if (precision == 16) return false;  // 0b1111 invalid
    int shift = (int)br.sbits(5);
    if (shift < 0) return false;
    std::vector<int64_t> coef(order);
    for (int i = 0; i < order; ++i) coef[i] = br.sbits(precision);
    if (!decode_residual(br, blocksize, order, out)) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coef[j] * out[i - 1 - j];
      out[i] += pred >> shift;
    }
  } else {
    return false;
  }
  if (wasted)
    for (auto& v : out) v <<= wasted;
  return !br.error;
}

// UTF-8-style coded number (frame/sample index)
bool read_utf8(BitReader& br, uint64_t* out) {
  uint64_t b0 = br.bits(8);
  if (br.error) return false;
  int extra = 0;
  uint64_t v = 0;
  if (b0 < 0x80) {
    *out = b0;
    return true;
  } else if ((b0 & 0xE0) == 0xC0) {
    extra = 1;
    v = b0 & 0x1F;
  } else if ((b0 & 0xF0) == 0xE0) {
    extra = 2;
    v = b0 & 0x0F;
  } else if ((b0 & 0xF8) == 0xF0) {
    extra = 3;
    v = b0 & 0x07;
  } else if ((b0 & 0xFC) == 0xF8) {
    extra = 4;
    v = b0 & 0x03;
  } else if ((b0 & 0xFE) == 0xFC) {
    extra = 5;
    v = b0 & 0x01;
  } else if (b0 == 0xFE) {
    extra = 6;
    v = 0;
  } else {
    return false;
  }
  for (int i = 0; i < extra; ++i) {
    uint64_t b = br.bits(8);
    if ((b & 0xC0) != 0x80) return false;
    v = (v << 6) | (b & 0x3F);
  }
  *out = v;
  return true;
}

struct StreamInfo {
  uint32_t sample_rate = 0;
  int channels = 0;
  int bps = 0;
  uint64_t total_samples = 0;
};

const int kBlockSizes[16] = {0,   192,  576,  1152, 2304, 4608, -1,  -2,
                             256, 512,  1024, 2048, 4096, 8192, 16384, 32768};

bool parse_stream(const uint8_t* data, size_t size, StreamInfo* info,
                  float* out, int64_t max_samples, int64_t* written) {
  if (size < 4 || std::memcmp(data, "fLaC", 4)) return false;
  BitReader br{data, size};
  br.byte = 4;
  // metadata blocks
  bool last = false;
  while (!last) {
    last = br.bits(1);
    int type = (int)br.bits(7);
    uint32_t len = (uint32_t)br.bits(24);
    if (type == 0) {  // STREAMINFO
      size_t start = br.byte;
      br.bits(16);  // min blocksize
      br.bits(16);  // max blocksize
      br.bits(24);  // min frame
      br.bits(24);  // max frame
      info->sample_rate = (uint32_t)br.bits(20);
      info->channels = (int)br.bits(3) + 1;
      info->bps = (int)br.bits(5) + 1;
      info->total_samples = br.bits(36);
      br.byte = start + len;
      br.bit = 0;
    } else {
      br.byte += len;
      if (br.byte > size) return false;
    }
  }
  if (info->channels <= 0 || info->bps <= 0) return false;
  if (!out) {
    *written = 0;
    return true;
  }

  float scale = 1.0f / (float)(1ll << (info->bps - 1));
  int64_t n_out = 0;
  std::vector<std::vector<int64_t>> ch(info->channels);
  while (br.byte < size && n_out < max_samples) {
    br.align();
    if (br.byte >= size) break;
    // frame header
    uint64_t sync = br.bits(14);
    if (br.error) break;
    if (sync != 0x3FFE) return n_out > 0;  // trailing junk tolerated
    br.bits(1);                            // reserved
    br.bits(1);                            // blocking strategy
    int bs_code = (int)br.bits(4);
    int sr_code = (int)br.bits(4);
    int ch_code = (int)br.bits(4);
    int sz_code = (int)br.bits(3);
    br.bits(1);  // reserved
    uint64_t dummy;
    if (!read_utf8(br, &dummy)) return false;
    int blocksize;
    if (bs_code == 6)
      blocksize = (int)br.bits(8) + 1;
    else if (bs_code == 7)
      blocksize = (int)br.bits(16) + 1;
    else if (kBlockSizes[bs_code] > 0)
      blocksize = kBlockSizes[bs_code];
    else
      return false;
    if (sr_code == 12)
      br.bits(8);
    else if (sr_code == 13 || sr_code == 14)
      br.bits(16);
    int bps = info->bps;
    switch (sz_code) {  // per-frame sample size override
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: break;
    }
    br.bits(8);  // CRC-8 (not verified; structure errors caught elsewhere)

    int nch = info->channels;
    for (int c = 0; c < nch; ++c) {
      int sub_bps = bps;
      // side channels carry one extra bit
      if ((ch_code == 8 && c == 1) || (ch_code == 9 && c == 0) ||
          (ch_code == 10 && c == 1))
        sub_bps += 1;
      if (!decode_subframe(br, blocksize, sub_bps, ch[c])) return false;
    }
    br.align();
    br.bits(16);  // frame CRC-16
    if (br.error) return false;  // the frame ran past the end of the file

    // stereo decorrelation
    if (ch_code == 8 && nch == 2) {  // left/side
      for (int i = 0; i < blocksize; ++i) ch[1][i] = ch[0][i] - ch[1][i];
    } else if (ch_code == 9 && nch == 2) {  // right/side: ch0=side ch1=right
      for (int i = 0; i < blocksize; ++i) ch[0][i] = ch[0][i] + ch[1][i];
    } else if (ch_code == 10 && nch == 2) {  // mid/side
      for (int i = 0; i < blocksize; ++i) {
        int64_t mid = ch[0][i], side = ch[1][i];
        mid = (mid << 1) | (side & 1);
        ch[0][i] = (mid + side) >> 1;
        ch[1][i] = (mid - side) >> 1;
      }
    }

    for (int i = 0; i < blocksize && n_out < max_samples; ++i)
      out[n_out++] = (float)ch[0][i] * scale;  // channel 0 (speech corpora: mono)
  }
  *written = n_out;
  return true;
}

bool read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf->resize(sz);
  bool ok = std::fread(buf->data(), 1, sz, f) == (size_t)sz;
  std::fclose(f);
  return ok;
}

}  // namespace

extern "C" {

// Returns total samples (from STREAMINFO), or -1 on error.
int64_t flac_num_samples(const char* path) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return -1;
  StreamInfo info;
  int64_t w = 0;
  if (!parse_stream(buf.data(), buf.size(), &info, nullptr, 0, &w)) return -1;
  return (int64_t)info.total_samples;
}

int64_t flac_sample_rate(const char* path) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return -1;
  StreamInfo info;
  int64_t w = 0;
  if (!parse_stream(buf.data(), buf.size(), &info, nullptr, 0, &w)) return -1;
  return (int64_t)info.sample_rate;
}

// Decode channel 0 into float32 [-1, 1); returns samples written or -1.
int64_t flac_decode(const char* path, float* out, int64_t max_samples) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return -1;
  StreamInfo info;
  int64_t written = -1;
  if (!parse_stream(buf.data(), buf.size(), &info, out, max_samples, &written))
    return -1;
  return written;
}

}  // extern "C"
