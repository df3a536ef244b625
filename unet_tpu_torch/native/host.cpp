// Host runtime of unet_tpu_torch: torch's MT19937 stream on the host and a
// prefetching reader of the .bin image dataset.
//
// * TorchRng: the generator torch.manual_seed(seed) gives, draw for draw:
//   PyTorch's MT19937 seeding, tempering, 24-bit float and 53-bit double
//   conversions, and the 16-element blocked Box-Muller fill with its
//   recompute-the-tail rule.  Its 625-word state (624 words + cursor) is
//   the blob a `--host_rng` checkpoint carries.
// * BinLoader: batches of a .bin dataset read, CHW->HWC transposed and
//   optionally width-mirrored on a worker thread while the caller consumes
//   the batch before, emitted as float32 or as the uint8 pixels
//   round((v + 1) * 127.5) of the trainer's host-to-device encoding.
//
// Built with the host C++ compiler at first use and bound with ctypes
// (unet_tpu_torch/utils/native.py).  No Python.h dependency.
// -ffp-contract=off is required: a fused multiply-add would change the
// Box-Muller bits.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr unsigned kN = 624;
constexpr unsigned kM = 397;
constexpr uint32_t kMatrixA = 0x9908b0dfu;
constexpr uint32_t kUpperMask = 0x80000000u;
constexpr uint32_t kLowerMask = 0x7fffffffu;

class TorchRng {
 public:
  explicit TorchRng(uint32_t seed) { reseed(seed); }

  void reseed(uint32_t seed) {
    state_[0] = seed;
    for (unsigned i = 1; i < kN; ++i) {
      state_[i] = 1812433253u * (state_[i - 1] ^ (state_[i - 1] >> 30)) + i;
    }
    pos_ = kN;  // force regeneration on first draw
  }

  // Full generator state (624 words + cursor) for checkpoint/resume.
  // fill_normal keeps no cross-call cache (the n>=16 Box-Muller path is
  // blocked; the n<16 cache is call-local), so this IS the whole state.
  void get_state(uint32_t* out625) const {
    std::memcpy(out625, state_, kN * sizeof(uint32_t));
    out625[kN] = pos_;
  }

  void set_state(const uint32_t* in625) {
    std::memcpy(state_, in625, kN * sizeof(uint32_t));
    pos_ = in625[kN];
  }

  uint32_t u32() {
    if (pos_ >= kN) twist();
    uint32_t y = state_[pos_++];
    y ^= y >> 11;
    y ^= (y << 7) & 0x9d2c5680u;
    y ^= (y << 15) & 0xefc60000u;
    y ^= y >> 18;
    return y;
  }

  uint64_t u64() {
    uint64_t hi = u32();
    return (hi << 32) | u32();
  }

  // torch keeps 24 random bits for a float in [0, 1)
  float f32() { return (u32() & ((1u << 24) - 1)) * (1.0f / (1 << 24)); }

  // and 53 bits for a double
  double f64() {
    return (u64() & ((1ull << 53) - 1)) * (1.0 / 9007199254740992.0);
  }

  void fill_uniform(float* out, int64_t n, float lo, float hi) {
    for (int64_t i = 0; i < n; ++i) out[i] = f32() * (hi - lo) + lo;
  }

  // torch normal_(): for n >= 16, fill with uniforms then apply Box-Muller
  // in strided blocks of 16 (8 cos + 8 sin lanes); a ragged tail is
  // REDRAWN over the final 16 slots.  For n < 16, scalar double-precision
  // Box-Muller with one cached sample.
  void fill_normal(float* out, int64_t n, float mean, float std) {
    constexpr double kEps = 1e-12;
    if (n >= 16) {
      for (int64_t i = 0; i < n; ++i) out[i] = f32();
      for (int64_t base = 0; base + 16 <= n; base += 16) {
        bm16(out + base, mean, std);
      }
      if (n % 16 != 0) {
        float* tail = out + n - 16;
        for (int i = 0; i < 16; ++i) tail[i] = f32();
        bm16(tail, mean, std);
      }
      return;
    }
    bool cached = false;
    double cache = 0.0;
    for (int64_t i = 0; i < n; ++i) {
      if (cached) {
        out[i] = static_cast<float>(cache * std + mean);
        cached = false;
        continue;
      }
      float u1 = static_cast<float>(f64());
      float u2 = static_cast<float>(f64());
      float r = sqrtf(-2.0f * logf(1.0f - u2 + static_cast<float>(kEps)));
      float theta = 2.0f * static_cast<float>(M_PI) * u1;
      cache = r * sinf(theta);
      cached = true;
      out[i] = r * cosf(theta) * std + mean;
    }
  }

  // timestep draw: floor(u * range) of a torch float uniform u
  void fill_timesteps(float* out, int64_t n, int range) {
    for (int64_t i = 0; i < n; ++i) {
      out[i] = static_cast<float>(static_cast<int>(f32() * range));
    }
  }

  void shuffle(int32_t* idx, int64_t n) {
    for (int64_t i = n - 1; i > 0; --i) {
      int64_t j = u32() % (i + 1);
      int32_t tmp = idx[i];
      idx[i] = idx[j];
      idx[j] = tmp;
    }
  }

 private:
  void bm16(float* d, float mean, float std) {
    constexpr float kEps = 1e-12f;
    for (int t = 0; t < 8; ++t) {
      float u1 = 1.0f - d[t];
      float u2 = d[t + 8];
      float r = sqrtf(-2.0f * logf(u1 + kEps));
      float theta = 2.0f * static_cast<float>(M_PI) * u2;
      d[t] = r * cosf(theta) * std + mean;
      d[t + 8] = r * sinf(theta) * std + mean;
    }
  }

  void twist() {
    for (unsigned i = 0; i < kN; ++i) {
      uint32_t y = (state_[i] & kUpperMask) | (state_[(i + 1) % kN] & kLowerMask);
      state_[i] = state_[(i + kM) % kN] ^ (y >> 1) ^ ((y & 1u) ? kMatrixA : 0u);
    }
    pos_ = 0;
  }

  uint32_t state_[kN];
  unsigned pos_;
};

// ---------------------------------------------------------------------------
// Prefetching .bin dataset loader (magic 20240620; 256-int32 header
// [magic, n, c, h, w] + n fp32 CHW images).

struct BinLoader {
  FILE* file = nullptr;
  int64_t n = 0;
  int c = 0, h = 0, w = 0;
  int batch = 0;
  int64_t cursor = 0;          // next image index (sequential order)
  size_t img_floats = 0;

  // indexed mode (shuffle/flip/shard): Python supplies the epoch's
  // absolute image indices + per-image flip bytes (the rng stays in
  // Python so the trajectory-faithful resume replay contract is shared
  // with the pure-Python loader); the worker gathers, CHW->HWC
  // transposes and width-flips in one pass on its own thread.
  std::vector<int64_t> order;
  std::vector<uint8_t> flips;
  int64_t ocur = 0;            // next position in `order`
  bool indexed = false;

  // double buffer: the worker fills `back` while the caller consumes front
  std::vector<float> back;
  std::vector<float> chw;      // staging read buffer
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  bool ready = false;          // back buffer holds a batch
  bool want = false;           // caller requested a fill
  bool filling = false;        // worker is mid-fill (set_epoch waits)
  std::atomic<bool> stop{false};

  ~BinLoader() {
    stop = true;
    {
      std::lock_guard<std::mutex> g(mu);
      want = true;
    }
    cv.notify_all();
    if (worker.joinable()) worker.join();
    if (file) fclose(file);
  }

  bool open(const char* path, int batch_size, int64_t start_batch) {
    file = fopen(path, "rb");
    if (!file) return false;
    int32_t header[256];
    if (fread(header, sizeof(int32_t), 256, file) != 256) return false;
    if (header[0] != 20240620) return false;
    n = header[1];
    c = header[2];
    h = header[3];
    w = header[4];
    batch = batch_size;
    // resume: the cursor arithmetic of data_loader's skip_batches
    // (unet_tpu_torch/data/dataset.py), so a resumed run sees the
    // identical batch sequence from step N on
    int64_t per_epoch = n / batch;
    if (per_epoch < 1) per_epoch = 1;
    if (start_batch > 0) cursor = (start_batch % per_epoch) * batch;
    img_floats = static_cast<size_t>(c) * h * w;
    back.resize(img_floats * batch);
    chw.resize(img_floats);
    worker = std::thread([this] { run(); });
    request();
    return true;
  }

  void request() {
    std::lock_guard<std::mutex> g(mu);
    want = true;
    cv.notify_all();
  }

  // blocking: copy the prefetched batch out, then kick off the next read
  void next(float* out) {
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [this] { return ready; });
    std::memcpy(out, back.data(), back.size() * sizeof(float));
    ready = false;
    want = true;
    cv.notify_all();
  }

  // uint8 variant: emit round((v + 1) * 127.5) in one pass — the H2D
  // byte encoding (trainer.make_multi_step input_u8).  lrintf under the
  // default FE_TONEAREST mode matches np.round's round-half-even.
  void next_u8(uint8_t* out) {
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [this] { return ready; });
    const float* src = back.data();
    const size_t m = back.size();
    for (size_t i = 0; i < m; ++i) {
      long v = lrintf((src[i] + 1.0f) * 127.5f);
      out[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
    ready = false;
    want = true;
    cv.notify_all();
  }

  // Install a new serving order (absolute image indices + flip bytes)
  // and discard anything prefetched from the previous one.  start_batch
  // offsets into idx in batch units.  Returns false on bad arguments.
  bool set_epoch(const int64_t* idx, const uint8_t* flip, int64_t n_idx,
                 int64_t start_batch) {
    if (n_idx < batch || start_batch * batch >= n_idx) return false;
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [this] { return !filling; });
    order.assign(idx, idx + n_idx);
    if (flip) {
      flips.assign(flip, flip + n_idx);
    } else {
      flips.assign(static_cast<size_t>(n_idx), 0);
    }
    ocur = start_batch * batch;
    indexed = true;
    ready = false;  // stale prefetch from the old order
    want = true;
    cv.notify_all();
    return true;
  }

 private:
  void read_image(int64_t img, float* dst, bool fl) {
    fseek(file, 256 * sizeof(int32_t)
               + img * static_cast<int64_t>(img_floats) * sizeof(float),
          SEEK_SET);
    size_t got = fread(chw.data(), sizeof(float), img_floats, file);
    if (got != img_floats) { std::memset(chw.data(), 0, img_floats * 4); }
    // CHW -> HWC, optionally mirroring width in the same pass
    const int hw = h * w;
    for (int ch = 0; ch < c; ++ch) {
      const float* src = chw.data() + static_cast<size_t>(ch) * hw;
      if (fl) {
        for (int y = 0; y < h; ++y)
          for (int x = 0; x < w; ++x)
            dst[(static_cast<size_t>(y) * w + (w - 1 - x)) * c + ch] =
                src[y * w + x];
      } else {
        for (int p = 0; p < hw; ++p)
          dst[static_cast<size_t>(p) * c + ch] = src[p];
      }
    }
  }

  void run() {
    for (;;) {
      std::unique_lock<std::mutex> lk(mu);
      cv.wait(lk, [this] { return want || stop; });
      if (stop) return;
      want = false;
      if (indexed &&
          ocur + batch > static_cast<int64_t>(order.size())) {
        // epoch exhausted: wait for the next set_epoch instead of
        // wrapping (Python owns the epoch boundary and its rng draws)
        continue;
      }
      filling = true;
      lk.unlock();

      if (indexed) {
        for (int b = 0; b < batch; ++b)
          read_image(order[ocur + b],
                     back.data() + static_cast<size_t>(b) * img_floats,
                     flips[ocur + b] != 0);
        ocur += batch;
      } else {
        // sequential fixed-stride batches, wrapping at the end
        if (cursor + batch > n) cursor = 0;
        for (int b = 0; b < batch; ++b)
          read_image(cursor + b,
                     back.data() + static_cast<size_t>(b) * img_floats,
                     false);
        cursor += batch;
      }

      lk.lock();
      filling = false;
      ready = true;
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// ---- RNG ----
void* rng_create(uint32_t seed) { return new TorchRng(seed); }
void rng_destroy(void* r) { delete static_cast<TorchRng*>(r); }
void rng_seed(void* r, uint32_t seed) { static_cast<TorchRng*>(r)->reseed(seed); }
uint32_t rng_u32(void* r) { return static_cast<TorchRng*>(r)->u32(); }
float rng_f32(void* r) { return static_cast<TorchRng*>(r)->f32(); }
double rng_f64(void* r) { return static_cast<TorchRng*>(r)->f64(); }
void rng_uniform(void* r, float* out, int64_t n, float lo, float hi) {
  static_cast<TorchRng*>(r)->fill_uniform(out, n, lo, hi);
}
void rng_normal(void* r, float* out, int64_t n, float mean, float std) {
  static_cast<TorchRng*>(r)->fill_normal(out, n, mean, std);
}
void rng_timesteps(void* r, float* out, int64_t n, int range) {
  static_cast<TorchRng*>(r)->fill_timesteps(out, n, range);
}
void rng_shuffle(void* r, int32_t* idx, int64_t n) {
  static_cast<TorchRng*>(r)->shuffle(idx, n);
}
void rng_get_state(void* r, uint32_t* out625) {
  static_cast<TorchRng*>(r)->get_state(out625);
}
void rng_set_state(void* r, const uint32_t* in625) {
  static_cast<TorchRng*>(r)->set_state(in625);
}

// ---- dataloader ----
void* loader_open(const char* path, int batch_size, int64_t start_batch) {
  auto* l = new BinLoader();
  if (!l->open(path, batch_size, start_batch)) {
    delete l;
    return nullptr;
  }
  return l;
}
void loader_close(void* l) { delete static_cast<BinLoader*>(l); }
void loader_meta(void* l, int64_t* out4) {
  auto* bl = static_cast<BinLoader*>(l);
  out4[0] = bl->n;
  out4[1] = bl->c;
  out4[2] = bl->h;
  out4[3] = bl->w;
}
// writes batch * h * w * c floats (NHWC)
void loader_next(void* l, float* out) { static_cast<BinLoader*>(l)->next(out); }
// writes batch * h * w * c uint8 pixels round((v+1)*127.5) (NHWC)
void loader_next_u8(void* l, uint8_t* out) {
  static_cast<BinLoader*>(l)->next_u8(out);
}
// install an epoch order: idx[n_idx] absolute image indices, flip[n_idx]
// 0/1 width-mirror bytes (flip may be NULL), serving from batch
// `start_batch` of the order.  Returns 1 on success.
int loader_set_epoch(void* l, const int64_t* idx, const uint8_t* flip,
                     int64_t n_idx, int64_t start_batch) {
  return static_cast<BinLoader*>(l)->set_epoch(idx, flip, n_idx,
                                               start_batch) ? 1 : 0;
}

}  // extern "C"
