// Native data-loading runtime of the PyTorch port, the port's own copy of
// de_i2i_gan_tpu/runtime/dataloader.cc (same C ABI, same batches).
//
// The reference feeds its GPU with 4 torch DataLoader worker *processes*
// doing PIL decode + torchvision transforms per epoch
// (defectGAN/train_defectgan.py:75-77). Here the host side is a C++
// pipeline over a decode-once raw-tensor cache:
//
//   * images are decoded once (Python/PIL) into a flat uint8 HWC cache file
//     plus an index (offset, h, w, label vector per item)
//   * worker threads mmap the cache and produce augmented float32 NHWC
//     batches into a bounded ring: random-resized-crop (bilinear), random
//     h/v flips, color jitter (brightness/saturation/contrast),
//     normalize to [-1, 1]
//   * consumers block on dl_next(), which copies one batch into the
//     caller-provided buffer (a numpy array feeding a single H2D transfer)
//
// Exposed as a C ABI for ctypes. runtime/native_loader.py builds it at first
// use (g++ -O3 -march=native -std=c++17 -shared -fPIC ... -lpthread) into
// build/de_i2i_gan_torch/ beside the package.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <memory>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cmath>
#include <fcntl.h>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Item {
  uint64_t offset;
  int32_t h, w;
};

struct Batch {
  std::vector<float> images;
  std::vector<float> labels;
};

struct IndexHeader {
  uint32_t magic;       // 0xD16D16D1
  uint32_t n_items;
  uint32_t label_nc;
  uint32_t channels;
};

class Loader {
 public:
  Loader(const char* cache_path, const char* index_path, int image_size,
         int batch, int threads, uint64_t seed, int augment,
         float crop_frac)
      : image_size_(image_size), batch_(batch), augment_(augment),
        crop_frac_(crop_frac), seed_(seed) {
    // map the cache
    int fd = open(cache_path, O_RDONLY);
    if (fd < 0) { ok_ = false; return; }
    struct stat st;
    fstat(fd, &st);
    cache_size_ = st.st_size;
    cache_ = static_cast<const uint8_t*>(
        mmap(nullptr, cache_size_, PROT_READ, MAP_PRIVATE, fd, 0));
    close(fd);
    if (cache_ == MAP_FAILED) { ok_ = false; return; }
    madvise(const_cast<uint8_t*>(cache_), cache_size_, MADV_WILLNEED);

    // read the index
    FILE* f = fopen(index_path, "rb");
    if (!f) { ok_ = false; return; }
    IndexHeader hdr;
    if (fread(&hdr, sizeof(hdr), 1, f) != 1 || hdr.magic != 0xD16D16D1u) {
      fclose(f); ok_ = false; return;
    }
    label_nc_ = hdr.label_nc;
    channels_ = hdr.channels;
    items_.resize(hdr.n_items);
    labels_.resize(size_t(hdr.n_items) * label_nc_);
    for (uint32_t i = 0; i < hdr.n_items; ++i) {
      fread(&items_[i], sizeof(Item), 1, f);
      fread(&labels_[size_t(i) * label_nc_], sizeof(float), label_nc_, f);
    }
    fclose(f);

    stop_.store(false);
    epoch_gen_.seed(seed_);
    reshuffle();
    for (int t = 0; t < threads; ++t) {
      workers_.emplace_back([this, t] { worker_loop(t); });
    }
  }

  ~Loader() {
    stop_.store(true);
    cv_full_.notify_all();
    cv_empty_.notify_all();
    for (auto& w : workers_) w.join();
    if (cache_ && cache_ != MAP_FAILED)
      munmap(const_cast<uint8_t*>(cache_), cache_size_);
  }

  bool ok() const { return ok_; }
  int label_nc() const { return label_nc_; }
  uint32_t n_items() const { return (uint32_t)items_.size(); }

  // blocking: copy one batch out. returns 0 on success.
  int next(float* out_images, float* out_labels) {
    std::unique_ptr<Batch> b = pop();
    if (!b) return 1;
    std::memcpy(out_images, b->images.data(),
                b->images.size() * sizeof(float));
    std::memcpy(out_labels, b->labels.data(),
                b->labels.size() * sizeof(float));
    return 0;
  }

  // u8 variant: images re-quantized from [-1,1] to [0,255] so the caller
  // ships 1/4 of the bytes to the device and normalizes there (the u8
  // quantization step, 1/127.5, is finer than bf16 resolution near +-1,
  // so nothing the bf16 compute path could see is lost).
  int next_u8(uint8_t* out_images, float* out_labels) {
    std::unique_ptr<Batch> b = pop();
    if (!b) return 1;
    const float* src = b->images.data();
    const size_t n = b->images.size();
    for (size_t i = 0; i < n; ++i) {
      float v = (src[i] + 1.f) * 127.5f + 0.5f;
      out_images[i] =
          (uint8_t)(v < 0.f ? 0.f : (v > 255.f ? 255.f : v));
    }
    std::memcpy(out_labels, b->labels.data(),
                b->labels.size() * sizeof(float));
    return 0;
  }

 private:
  std::unique_ptr<Batch> pop() {
    std::unique_ptr<Batch> b;
    {
      std::unique_lock<std::mutex> lk(mu_);
      cv_full_.wait(lk, [this] { return !queue_.empty() || stop_.load(); });
      if (stop_.load() && queue_.empty()) return nullptr;
      b = std::move(queue_.front());
      queue_.pop();
    }
    cv_empty_.notify_one();
    return b;
  }

  void reshuffle() {
    order_.resize(items_.size());
    for (size_t i = 0; i < order_.size(); ++i) order_[i] = (uint32_t)i;
    std::shuffle(order_.begin(), order_.end(), epoch_gen_);
    cursor_.store(0);
  }

  uint32_t next_index() {
    uint64_t c = cursor_.fetch_add(1);
    if (c >= order_.size()) {
      std::lock_guard<std::mutex> lk(shuffle_mu_);
      if (cursor_.load() > order_.size()) {  // first to notice wraps
        reshuffle();
      }
      c = cursor_.fetch_add(1) % order_.size();
    }
    return order_[c % order_.size()];
  }

  // bilinear sample from the uint8 source (HWC)
  static inline float sample(const uint8_t* src, int h, int w, int c,
                             float y, float x, int ch) {
    int x0 = (int)x, y0 = (int)y;
    int x1 = x0 + 1 < w ? x0 + 1 : x0;
    int y1 = y0 + 1 < h ? y0 + 1 : y0;
    float fx = x - x0, fy = y - y0;
    const uint8_t* p00 = src + (size_t(y0) * w + x0) * c + ch;
    const uint8_t* p01 = src + (size_t(y0) * w + x1) * c + ch;
    const uint8_t* p10 = src + (size_t(y1) * w + x0) * c + ch;
    const uint8_t* p11 = src + (size_t(y1) * w + x1) * c + ch;
    float top = *p00 + fx * (*p01 - *p00);
    float bot = *p10 + fx * (*p11 - *p10);
    return top + fy * (bot - top);
  }

  // integer-exact random crop + hflip, no resampling: the canonical pix2pix
  // resize(load_size) -> random-crop(crop_size) schedule when the cache is
  // stored at load_size. ~10x cheaper than the bilinear path (pure copy +
  // normalize), which keeps a 1-core host ahead of the TPU step rate.
  void crop_copy(const Item& it, const uint8_t* src, int iy, int ix,
                 bool hflip, float* img_out) {
    const int S = image_size_, C = channels_;
    for (int y = 0; y < S; ++y) {
      const uint8_t* row = src + (size_t(iy + y) * it.w + ix) * C;
      float* dst = img_out + size_t(y) * S * C;
      if (!hflip) {
        for (int i = 0; i < S * C; ++i)
          dst[i] = row[i] * (2.f / 255.f) - 1.f;
      } else {
        for (int x = 0; x < S; ++x) {
          const uint8_t* p = row + size_t(S - 1 - x) * C;
          float* d = dst + size_t(x) * C;
          for (int ch = 0; ch < C; ++ch)
            d[ch] = p[ch] * (2.f / 255.f) - 1.f;
        }
      }
    }
  }

  void decode_one(std::mt19937& gen, uint32_t idx, float* img_out,
                  float* lbl_out) {
    const Item& it = items_[idx];
    const uint8_t* src = cache_ + it.offset;
    const int S = image_size_;
    std::uniform_real_distribution<float> uni(0.f, 1.f);

    // Integer fast path: valid ONLY when the cache is stored at load_size,
    // i.e. the crop_frac_ window already IS S x S (within 1 px). A larger
    // cached image must fall through to the fractional bilinear path below,
    // or crop_frac_ would be silently ignored and the crop schedule would
    // shrink to a tiny fraction of the documented resize->crop recipe.
    if (augment_ == 2 && it.h >= S && it.w >= S &&
        std::fabs(it.h * crop_frac_ - S) <= 1.f &&
        std::fabs(it.w * crop_frac_ - S) <= 1.f) {
      int iy = std::min((int)(uni(gen) * (it.h - S + 1)), it.h - S);
      int ix = std::min((int)(uni(gen) * (it.w - S + 1)), it.w - S);
      crop_copy(it, src, iy, ix, uni(gen) < 0.5f, img_out);
      std::memcpy(lbl_out, &labels_[size_t(idx) * label_nc_],
                  label_nc_ * sizeof(float));
      return;
    }

    float crop_h = it.h, crop_w = it.w;
    float y_off = 0.f, x_off = 0.f;
    bool hflip = false, vflip = false;
    float br = 1.f, sat = 1.f, con = 1.f;
    const bool jitter = (augment_ == 1);
    if (augment_ == 2) {
      // paired-i2i augmentation (pix2pix resize->random-crop->hflip):
      // crop a crop_frac_ window (= crop_size/load_size of the cached
      // image) at a random offset, horizontal flip only, NO color jitter
      // (the target photo is supervision; photometric noise would corrupt
      // the regression). Channels carry A|B stacked, so the identical
      // window/flip applies to both halves by construction.
      crop_h = it.h * crop_frac_;
      crop_w = it.w * crop_frac_;
      y_off = uni(gen) * (it.h - crop_h);
      x_off = uni(gen) * (it.w - crop_w);
      hflip = uni(gen) < 0.5f;
    } else if (augment_) {
      // random resized crop: scale (0.6, 1.0) of area, ratio (3/4, 4/3)
      float area = float(it.h) * float(it.w);
      for (int attempt = 0; attempt < 10; ++attempt) {
        float target = area * (0.6f + 0.4f * uni(gen));
        float lr = std::log(3.f / 4.f), ur = std::log(4.f / 3.f);
        float ratio = std::exp(lr + (ur - lr) * uni(gen));
        float cw = std::sqrt(target * ratio);
        float chh = std::sqrt(target / ratio);
        if (cw <= it.w && chh <= it.h) {
          crop_w = cw; crop_h = chh;
          x_off = uni(gen) * (it.w - cw);
          y_off = uni(gen) * (it.h - chh);
          break;
        }
      }
      hflip = uni(gen) < 0.5f;
      vflip = uni(gen) < 0.5f;
      br = 0.8f + 0.4f * uni(gen);
      sat = 0.8f + 0.4f * uni(gen);
      con = 0.8f + 0.4f * uni(gen);
    } else {
      // center square crop
      float side = std::min(it.h, it.w);
      crop_h = crop_w = side;
      y_off = (it.h - side) * 0.5f;
      x_off = (it.w - side) * 0.5f;
    }

    const int C = channels_;
    float mean_all = 0.f;
    // crop+resize+flip into [0,1]
    for (int y = 0; y < S; ++y) {
      float sy = y_off + (y + 0.5f) * crop_h / S - 0.5f;
      if (sy < 0) sy = 0;
      if (sy > it.h - 1) sy = it.h - 1;
      int oy = vflip ? (S - 1 - y) : y;
      for (int x = 0; x < S; ++x) {
        float sx = x_off + (x + 0.5f) * crop_w / S - 0.5f;
        if (sx < 0) sx = 0;
        if (sx > it.w - 1) sx = it.w - 1;
        int ox = hflip ? (S - 1 - x) : x;
        float* dst = img_out + (size_t(oy) * S + ox) * C;
        float grey = 0.f;
        for (int ch = 0; ch < C; ++ch) {
          float v = sample(src, it.h, it.w, C, sy, sx, ch) * (1.f / 255.f);
          dst[ch] = v;
          grey += v;
        }
        grey /= C;
        if (jitter) {
          for (int ch = 0; ch < C; ++ch) {
            float v = dst[ch] * br;                    // brightness
            v = grey * br + (v - grey * br) * sat;     // saturation
            dst[ch] = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
            mean_all += dst[ch];
          }
        }
      }
    }
    if (jitter) {
      mean_all /= float(S) * S * C;
      for (size_t i = 0; i < size_t(S) * S * C; ++i) {
        float v = mean_all + (img_out[i] - mean_all) * con;  // contrast
        v = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
        img_out[i] = v * 2.f - 1.f;                          // normalize
      }
    } else {
      for (size_t i = 0; i < size_t(S) * S * C; ++i)
        img_out[i] = img_out[i] * 2.f - 1.f;
    }
    std::memcpy(lbl_out, &labels_[size_t(idx) * label_nc_],
                label_nc_ * sizeof(float));
  }

  void worker_loop(int tid) {
    std::mt19937 gen(seed_ + 1000003u * (tid + 1));
    const size_t img_elems = size_t(image_size_) * image_size_ * channels_;
    while (!stop_.load()) {
      auto b = std::make_unique<Batch>();
      b->images.resize(img_elems * batch_);
      b->labels.resize(size_t(label_nc_) * batch_);
      for (int i = 0; i < batch_; ++i) {
        decode_one(gen, next_index(), b->images.data() + img_elems * i,
                   b->labels.data() + size_t(label_nc_) * i);
      }
      std::unique_lock<std::mutex> lk(mu_);
      cv_empty_.wait(lk, [this] {
        return queue_.size() < kQueueCap || stop_.load();
      });
      if (stop_.load()) return;
      queue_.push(std::move(b));
      lk.unlock();
      cv_full_.notify_one();
    }
  }

  static constexpr size_t kQueueCap = 8;
  bool ok_ = true;
  int image_size_, batch_, augment_;
  float crop_frac_;  // paired crop window: crop_size / load_size
  uint64_t seed_;
  int label_nc_ = 0, channels_ = 3;
  const uint8_t* cache_ = nullptr;
  size_t cache_size_ = 0;
  std::vector<Item> items_;
  std::vector<float> labels_;
  std::vector<uint32_t> order_;
  std::atomic<uint64_t> cursor_{0};
  std::mt19937 epoch_gen_;
  std::mutex shuffle_mu_;

  std::mutex mu_;
  std::condition_variable cv_full_, cv_empty_;
  std::queue<std::unique_ptr<Batch>> queue_;
  std::vector<std::thread> workers_;
  std::atomic<bool> stop_{false};
};

}  // namespace

extern "C" {

// crop_frac: the paired mode's (augment=2) crop window fraction,
// crop_size / load_size; it is fixed before the worker threads start, so
// every batch uses it
void* dl_create(const char* cache_path, const char* index_path,
                int image_size, int batch, int threads, uint64_t seed,
                int augment, float crop_frac) {
  auto* l = new Loader(cache_path, index_path, image_size, batch, threads,
                       seed, augment, crop_frac);
  if (!l->ok()) { delete l; return nullptr; }
  return l;
}

int dl_next(void* handle, float* out_images, float* out_labels) {
  return static_cast<Loader*>(handle)->next(out_images, out_labels);
}

int dl_next_u8(void* handle, uint8_t* out_images, float* out_labels) {
  return static_cast<Loader*>(handle)->next_u8(out_images, out_labels);
}

int dl_label_nc(void* handle) {
  return static_cast<Loader*>(handle)->label_nc();
}

unsigned int dl_n_items(void* handle) {
  return static_cast<Loader*>(handle)->n_items();
}

void dl_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
