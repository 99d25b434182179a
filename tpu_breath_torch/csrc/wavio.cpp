// Threaded batch WAV decoder, host C++ (tpu_breath_torch/data/wav.py
// builds it at first use and binds it with ctypes).
//
// The byte-level work of the ingest path -- RIFF parsing (fmt/data/extra
// chunks, WAVE_FORMAT_EXTENSIBLE), sample-format conversion (PCM 8/16/24/32
// and IEEE float32/64), the channel-mean downmix in float64, polyphase
// resampling of any input rate to 16 kHz, and pad/truncate to a fixed
// length -- runs in a pool of threads outside the interpreter lock, filling
// one contiguous [N, expected_len] float32 buffer. The resampler (Kaiser
// beta 8.6, 16 zero-crossings at the narrower Nyquist) is the numpy
// resample_poly's design, so the two agree to float32 rounding; without
// resampling they agree bit for bit. Built without -ffast-math and without
// -march=native: a contracted multiply-add would change the samples.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kTargetRate = 16000;
constexpr double kKaiserBeta = 8.6;
constexpr int kZeroCrossings = 16;

struct RiffHeader {
  uint16_t format_code = 0;  // 1 = PCM, 3 = IEEE float (EXTENSIBLE resolved)
  uint16_t channels = 0;
  uint16_t bits_per_sample = 0;
  uint32_t sample_rate = 0;
  long data_offset = -1;
  uint32_t data_bytes = 0;
};

// Minimal RIFF/WAVE walker: finds fmt + data chunks.
bool parse_header(FILE* f, RiffHeader* out) {
  unsigned char hdr[12];
  if (fread(hdr, 1, 12, f) != 12) return false;
  if (memcmp(hdr, "RIFF", 4) != 0 || memcmp(hdr + 8, "WAVE", 4) != 0)
    return false;
  unsigned char chunk[8];
  bool have_fmt = false;
  while (fread(chunk, 1, 8, f) == 8) {
    uint32_t size = chunk[4] | (chunk[5] << 8) | (chunk[6] << 16) |
                    (uint32_t(chunk[7]) << 24);
    if (memcmp(chunk, "fmt ", 4) == 0) {
      unsigned char fmt[40];
      uint32_t want = size < 40 ? size : 40;
      if (size < 16 || fread(fmt, 1, want, f) != want) return false;
      out->format_code = fmt[0] | (fmt[1] << 8);
      out->channels = fmt[2] | (fmt[3] << 8);
      out->sample_rate = fmt[4] | (fmt[5] << 8) | (fmt[6] << 16) |
                         (uint32_t(fmt[7]) << 24);
      out->bits_per_sample = fmt[14] | (fmt[15] << 8);
      if (out->format_code == 0xFFFE && size >= 26)  // WAVE_FORMAT_EXTENSIBLE
        out->format_code = fmt[24] | (fmt[25] << 8);
      if (size > want) fseek(f, size - want, SEEK_CUR);
      if (size & 1) fseek(f, 1, SEEK_CUR);
      have_fmt = true;
    } else if (memcmp(chunk, "data", 4) == 0) {
      out->data_offset = ftell(f);
      out->data_bytes = size;
      return have_fmt && out->channels != 0;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  return false;
}

// Raw data bytes -> float64 mono (channel-mean downmix), librosa/soundfile
// PCM scaling. Returns false on an unsupported format.
bool to_mono_f64(const RiffHeader& h, const std::vector<unsigned char>& raw,
                 std::vector<double>* mono) {
  const int ch = h.channels;
  size_t bytes_per = h.bits_per_sample / 8;
  if (bytes_per == 0) return false;
  size_t n_total = raw.size() / bytes_per;
  size_t n_frames = n_total / ch;
  mono->assign(n_frames, 0.0);
  const unsigned char* p = raw.data();
  auto accumulate = [&](auto decode) {
    for (size_t t = 0; t < n_frames; ++t) {
      double acc = 0.0;
      for (int c = 0; c < ch; ++c)
        acc += decode(p + (t * ch + c) * bytes_per);
      (*mono)[t] = acc / ch;
    }
  };
  if (h.format_code == 3 && h.bits_per_sample == 32) {
    accumulate([](const unsigned char* q) {
      float v;
      memcpy(&v, q, 4);
      return double(v);
    });
  } else if (h.format_code == 3 && h.bits_per_sample == 64) {
    accumulate([](const unsigned char* q) {
      double v;
      memcpy(&v, q, 8);
      return v;
    });
  } else if (h.format_code == 1 && h.bits_per_sample == 16) {
    accumulate([](const unsigned char* q) {
      int16_t v = int16_t(q[0] | (q[1] << 8));
      return double(v) / 32768.0;
    });
  } else if (h.format_code == 1 && h.bits_per_sample == 24) {
    accumulate([](const unsigned char* q) {
      int32_t v = q[0] | (q[1] << 8) | (q[2] << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      return double(v) / double(1 << 23);
    });
  } else if (h.format_code == 1 && h.bits_per_sample == 32) {
    accumulate([](const unsigned char* q) {
      int32_t v = q[0] | (q[1] << 8) | (q[2] << 16) |
                  (int32_t(uint32_t(q[3]) << 24));
      return double(v) / 2147483648.0;
    });
  } else if (h.format_code == 1 && h.bits_per_sample == 8) {
    accumulate([](const unsigned char* q) {
      return (double(q[0]) - 128.0) / 128.0;
    });
  } else {
    return false;
  }
  return true;
}

double bessel_i0(double x) {
  // Series sum_k ((x/2)^k / k!)^2; converges fast for the beta range here.
  double sum = 1.0, term = 1.0;
  const double q = x * x / 4.0;
  for (int k = 1; k < 64; ++k) {
    term *= q / (double(k) * double(k));
    sum += term;
    if (term < 1e-18 * sum) break;
  }
  return sum;
}

struct ResampleFilter {
  int up = 1, down = 1, half = 0;
  std::vector<double> h;  // 2*half+1 taps, gain `up`
};

// Cache of designed filters keyed by (up, down); a handful of rates at most.
const ResampleFilter& get_filter(int up, int down) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, ResampleFilter> cache;
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find({up, down});
  if (it != cache.end()) return it->second;
  ResampleFilter f;
  f.up = up;
  f.down = down;
  int m = up > down ? up : down;
  f.half = kZeroCrossings * m;
  int n_taps = 2 * f.half + 1;
  f.h.resize(n_taps);
  const double fc = 1.0 / m;
  const double i0b = bessel_i0(kKaiserBeta);
  for (int i = 0; i < n_taps; ++i) {
    const double n = double(i - f.half);
    const double x = fc * n;
    const double sinc = x == 0.0 ? 1.0 : std::sin(M_PI * x) / (M_PI * x);
    // np.kaiser(N, beta)[i] with N = n_taps
    const double r = 2.0 * double(i) / double(n_taps - 1) - 1.0;
    const double w = bessel_i0(kKaiserBeta * std::sqrt(1.0 - r * r)) / i0b;
    f.h[i] = double(up) * fc * sinc * w;
  }
  return cache.emplace(std::make_pair(up, down), std::move(f)).first->second;
}

// Rational polyphase resample (data/wav.py's resample_poly, summed in order):
// output t sits at input time t*down/up, n_out = ceil(n_in * up / down).
void resample(const std::vector<double>& x, int sr_in, int sr_out,
              std::vector<double>* out) {
  int g = 1;
  {
    int a = sr_in, b = sr_out;
    while (b) {
      int t = a % b;
      a = b;
      b = t;
    }
    g = a;
  }
  const ResampleFilter& f = get_filter(sr_out / g, sr_in / g);
  const long n_in = long(x.size());
  const long n_out = (n_in * f.up + f.down - 1) / f.down;
  out->assign(n_out, 0.0);
  for (long t = 0; t < n_out; ++t) {
    const long k = t * f.down + f.half;  // tap m pairs with input i: m = k - i*up
    const long num = k - 2 * f.half;     // m <= 2*half  =>  i >= ceil(num/up)
    long i_lo = num >= 0 ? (num + f.up - 1) / f.up : -((-num) / f.up);
    if (i_lo < 0) i_lo = 0;
    long i_hi = k / f.up;  // m >= 0
    if (i_hi >= n_in) i_hi = n_in - 1;
    double acc = 0.0;
    for (long i = i_lo; i <= i_hi; ++i) acc += x[size_t(i)] * f.h[size_t(k - i * f.up)];
    (*out)[size_t(t)] = acc;
  }
}

// Decode one file into out[expected_len] float32 mono 16 kHz, zero-padded /
// truncated. Returns 0 on success.
int decode_one(const char* path, float* out, int expected_len) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  RiffHeader h;
  if (!parse_header(f, &h)) {
    fclose(f);
    return 2;
  }
  std::vector<unsigned char> raw(h.data_bytes);
  fseek(f, h.data_offset, SEEK_SET);
  const size_t got = fread(raw.data(), 1, h.data_bytes, f);
  fclose(f);
  raw.resize(got);
  std::vector<double> mono;
  if (!to_mono_f64(h, raw, &mono)) return 3;
  std::vector<double> resampled;
  const std::vector<double>* y = &mono;
  if (h.sample_rate != kTargetRate) {
    if (h.sample_rate == 0) return 4;
    resample(mono, int(h.sample_rate), int(kTargetRate), &resampled);
    y = &resampled;
  }
  const size_t n = y->size() < size_t(expected_len) ? y->size()
                                                    : size_t(expected_len);
  for (size_t i = 0; i < n; ++i) out[i] = float((*y)[i]);
  for (size_t i = n; i < size_t(expected_len); ++i) out[i] = 0.0f;
  return 0;
}

}  // namespace

extern "C" {

// Decodes n_files paths into out[n_files * expected_len]. n_threads <= 0
// uses the hardware concurrency. Returns the number of failed files.
int decode_wav_batch(const char** paths, int n_files, float* out,
                     int expected_len, int n_threads) {
  if (n_threads <= 0) {
    n_threads = int(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > n_files) n_threads = n_files > 0 ? n_files : 1;
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n_files; i = next.fetch_add(1)) {
      if (decode_one(paths[i], out + size_t(i) * expected_len, expected_len))
        failures.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

}  // extern "C"
