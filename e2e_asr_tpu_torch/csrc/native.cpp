// Native host library of the PyTorch port (host C++, not a CUDA kernel).
//
// The port's copy of the JAX package's csrc/native.cpp: exact Levenshtein
// on int32 token sequences (one pair, or a batch on threads), a PCM WAV
// reader, and a threaded batch packer that decodes and zero-pads a whole
// bucketed batch outside the GIL. What differs from that file: a wav the
// reader cannot decode (not PCM, not 16 or 32 bits, short of its header's
// data) gives -1, also in pack_wav_batch's lengths, so that the caller
// raises instead of taking a zero-length row.
//
// Built with flac.cpp by e2e_asr_tpu_torch/native.py at first use:
// g++ -O3 -std=c++17 -shared -fPIC native.cpp flac.cpp -o native-<hash>.so -lpthread

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- lev
// Levenshtein distance between two int32 token sequences.
// Rolling single-row DP, O(la*lb) time, O(min) memory.
int64_t levenshtein(const int32_t* a, int64_t la, const int32_t* b, int64_t lb) {
  if (la == 0) return lb;
  if (lb == 0) return la;
  if (lb > la) {  // keep the rolling row small
    std::swap(a, b);
    std::swap(la, lb);
  }
  std::vector<int64_t> row(lb + 1);
  for (int64_t j = 0; j <= lb; ++j) row[j] = j;
  for (int64_t i = 1; i <= la; ++i) {
    int64_t prev = row[0];  // dp[i-1][0]
    row[0] = i;
    for (int64_t j = 1; j <= lb; ++j) {
      int64_t cur = row[j];
      int64_t sub = prev + (a[i - 1] != b[j - 1]);
      row[j] = std::min({row[j] + 1, row[j - 1] + 1, sub});
      prev = cur;
    }
  }
  return row[lb];
}

// Batch version: distances for n pairs (flattened, with offsets).
void levenshtein_batch(const int32_t* a_flat, const int64_t* a_off,
                       const int32_t* b_flat, const int64_t* b_off,
                       int64_t n, int64_t* out, int n_threads) {
  std::atomic<int64_t> next(0);
  auto work = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      out[i] = levenshtein(a_flat + a_off[i], a_off[i + 1] - a_off[i],
                           b_flat + b_off[i], b_off[i + 1] - b_off[i]);
    }
  };
  int nt = std::max(1, n_threads);
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t) ts.emplace_back(work);
  for (auto& t : ts) t.join();
}

// ---------------------------------------------------------------- wav
// Minimal RIFF/WAVE PCM reader (16/32-bit int, mono or first channel).
// Returns sample count written (<= max_samples), or -1 on error.
static int64_t read_wav_file(const char* path, float* out, int64_t max_samples,
                             int64_t* total_samples) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  uint8_t hdr[12];
  if (std::fread(hdr, 1, 12, f) != 12 || std::memcmp(hdr, "RIFF", 4) ||
      std::memcmp(hdr + 8, "WAVE", 4)) {
    std::fclose(f);
    return -1;
  }
  uint16_t fmt = 0, channels = 1, bits = 16;
  int64_t written = -1;
  for (;;) {
    uint8_t ck[8];
    if (std::fread(ck, 1, 8, f) != 8) break;
    uint32_t sz;
    std::memcpy(&sz, ck + 4, 4);
    if (!std::memcmp(ck, "fmt ", 4)) {
      std::vector<uint8_t> buf(sz);
      if (std::fread(buf.data(), 1, sz, f) != sz) break;
      std::memcpy(&fmt, buf.data(), 2);
      std::memcpy(&channels, buf.data() + 2, 2);
      std::memcpy(&bits, buf.data() + 14, 2);
    } else if (!std::memcmp(ck, "data", 4)) {
      if ((fmt != 1 && fmt != 0xFFFE) || (bits != 16 && bits != 32)) break;  // PCM 16/32 only
      int bytes = bits / 8;
      int64_t frames = sz / (bytes * std::max<int>(channels, 1));
      if (total_samples) *total_samples = frames;
      int64_t n = out ? std::min<int64_t>(frames, max_samples) : 0;
      if (out && n > 0) {
        std::vector<uint8_t> buf(n * bytes * channels);
        if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) break;
        for (int64_t i = 0; i < n; ++i) {
          const uint8_t* p = buf.data() + i * bytes * channels;  // ch 0
          if (bits == 16) {
            int16_t v;
            std::memcpy(&v, p, 2);
            out[i] = v / 32768.0f;
          } else {
            int32_t v;
            std::memcpy(&v, p, 4);
            out[i] = v / 2147483648.0f;
          }
        }
      }
      written = n;
      break;
    } else {
      std::fseek(f, sz + (sz & 1), SEEK_CUR);
    }
  }
  std::fclose(f);
  return written;
}

int64_t read_wav(const char* path, float* out, int64_t max_samples) {
  return read_wav_file(path, out, max_samples, nullptr);
}

int64_t wav_num_samples(const char* path) {
  int64_t total = -1;
  if (read_wav_file(path, nullptr, 0, &total) < 0) return -1;
  return total;
}

// Decode n wavs in parallel into a zero-padded [n, stride] float32 buffer;
// writes per-row valid lengths, -1 for a file that could not be decoded.
// The bucketed-batch assembly on native threads, no process forks.
void pack_wav_batch(const char** paths, int64_t n, float* out, int64_t stride,
                    int64_t* lens, int n_threads) {
  std::atomic<int64_t> next(0);
  auto work = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      float* row = out + i * stride;
      std::memset(row, 0, stride * sizeof(float));
      lens[i] = read_wav(paths[i], row, stride);
    }
  };
  int nt = std::max(1, n_threads);
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t) ts.emplace_back(work);
  for (auto& t : ts) t.join();
}

}  // extern "C"
