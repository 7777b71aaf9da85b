// Native IO runtime: image decode + prefetching data loader + feature
// serialization.
//
// The reference implements its host-side runtime in C (staging buffers,
// async transfer queues overlapping DMA with compute —
// src/vulkansift/sift_memory.c, vkenv/*). Here the device side of that
// role belongs to XLA/PJRT, but the HOST side — feeding images from disk
// ahead of the accelerator — is still native work. This library provides:
//
//  * PGM/PPM (P2/P3/P5/P6) decode to 8-bit grayscale (the Oxford/Hannover
//    dataset formats used by the reference's perf harness).
//  * A multi-threaded prefetching loader: worker threads decode upcoming
//    images into a bounded ring of slots while the accelerator crunches
//    the current one — the analogue of the reference's double-buffered
//    staging path (sift_memory.c:596-607, async transfer queues
//    vulkansift.c:195-202).
//  * Binary feature-set (de)serialization in the exact vksift_Feature
//    layout (include/vulkansift/vulkansift_types.h:17-31) so externally
//    persisted feature databases round-trip (vulkansift.h:74-78).
//
// C ABI only (consumed from Python via ctypes — no pybind11 dependency).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#define VKSIFT_IO_API extern "C" __attribute__((visibility("default")))

namespace {

struct Image {
  int width = 0;
  int height = 0;
  std::vector<uint8_t> pixels;  // grayscale
  bool ok = false;
};

bool read_token(FILE* f, char* buf, size_t cap) {
  int c;
  // skip whitespace + comments
  do {
    c = fgetc(f);
    if (c == '#') {
      while (c != '\n' && c != EOF) c = fgetc(f);
    }
  } while (c == ' ' || c == '\t' || c == '\n' || c == '\r');
  if (c == EOF) return false;
  size_t i = 0;
  while (c != EOF && c != ' ' && c != '\t' && c != '\n' && c != '\r') {
    if (i + 1 < cap) buf[i++] = static_cast<char>(c);
    c = fgetc(f);
  }
  buf[i] = 0;
  return i > 0;
}

Image decode_pnm(const char* path) {
  Image img;
  FILE* f = fopen(path, "rb");
  if (!f) return img;
  char tok[64];
  if (!read_token(f, tok, sizeof tok)) { fclose(f); return img; }
  std::string magic = tok;
  bool ascii = (magic == "P2" || magic == "P3");
  bool color = (magic == "P3" || magic == "P6");
  if (magic != "P2" && magic != "P3" && magic != "P5" && magic != "P6") {
    fclose(f);
    return img;
  }
  if (!read_token(f, tok, sizeof tok)) { fclose(f); return img; }
  img.width = atoi(tok);
  if (!read_token(f, tok, sizeof tok)) { fclose(f); return img; }
  img.height = atoi(tok);
  if (!read_token(f, tok, sizeof tok)) { fclose(f); return img; }
  int maxval = atoi(tok);
  if (img.width <= 0 || img.height <= 0 || maxval <= 0 || maxval > 65535) {
    fclose(f);
    return img;
  }
  size_t n = static_cast<size_t>(img.width) * img.height;
  size_t ch = color ? 3 : 1;
  size_t bytes_per = maxval > 255 ? 2 : 1;
  std::vector<uint32_t> raw(n * ch);
  if (ascii) {
    for (size_t i = 0; i < n * ch; i++) {
      if (!read_token(f, tok, sizeof tok)) { fclose(f); return img; }
      raw[i] = static_cast<uint32_t>(atoi(tok));
    }
  } else {
    std::vector<uint8_t> buf(n * ch * bytes_per);
    if (fread(buf.data(), 1, buf.size(), f) != buf.size()) {
      fclose(f);
      return img;
    }
    for (size_t i = 0; i < n * ch; i++) {
      raw[i] = bytes_per == 2
                   ? (static_cast<uint32_t>(buf[2 * i]) << 8) | buf[2 * i + 1]
                   : buf[i];
    }
  }
  fclose(f);
  img.pixels.resize(n);
  for (size_t i = 0; i < n; i++) {
    uint32_t v;
    if (color) {
      // Rec.601 luma, matching cv::imread(path, 0).
      v = (299 * raw[3 * i] + 587 * raw[3 * i + 1] + 114 * raw[3 * i + 2])
          / 1000;
    } else {
      v = raw[i];
    }
    img.pixels[i] = static_cast<uint8_t>(v * 255 / maxval);
  }
  img.ok = true;
  return img;
}

// ---------------------------------------------------------------------------
// Prefetching loader
// ---------------------------------------------------------------------------

struct Loader {
  std::vector<std::string> paths;
  size_t next_submit = 0;   // next index a worker will take
  size_t next_consume = 0;  // next index the consumer expects
  size_t prefetch = 4;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_worker;
  std::condition_variable cv_consumer;
  std::vector<Image> done;       // index -> decoded image
  std::vector<uint8_t> done_set;  // index -> decoded flag
  std::atomic<bool> stop{false};

  void work() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_worker.wait(lk, [&] {
          return stop.load() ||
                 (next_submit < paths.size() &&
                  next_submit < next_consume + prefetch);
        });
        if (stop.load()) return;
        idx = next_submit++;
      }
      Image img = decode_pnm(paths[idx].c_str());
      {
        std::lock_guard<std::mutex> lk(mu);
        done[idx] = std::move(img);
        done_set[idx] = 1;
      }
      cv_consumer.notify_all();
    }
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

VKSIFT_IO_API uint8_t* vksift_read_image_gray(const char* path, int* width,
                                              int* height) {
  Image img = decode_pnm(path);
  if (!img.ok) return nullptr;
  auto* out = static_cast<uint8_t*>(malloc(img.pixels.size()));
  memcpy(out, img.pixels.data(), img.pixels.size());
  *width = img.width;
  *height = img.height;
  return out;
}

VKSIFT_IO_API void vksift_free(void* p) { free(p); }

VKSIFT_IO_API void* vksift_loader_create(const char** paths, int nb_paths,
                                         int nb_threads, int prefetch) {
  auto* l = new Loader();
  l->paths.assign(paths, paths + nb_paths);
  l->prefetch = prefetch > 0 ? static_cast<size_t>(prefetch) : 4;
  l->done.resize(nb_paths);
  l->done_set.assign(nb_paths, 0);
  int nt = nb_threads > 0 ? nb_threads : 2;
  for (int i = 0; i < nt; i++) l->workers.emplace_back([l] { l->work(); });
  return l;
}

// Blocks until image ``index`` (sequential consumption) is decoded; returns
// a malloc'd grayscale buffer (caller frees via vksift_free) or nullptr on
// decode failure / end of stream.
VKSIFT_IO_API uint8_t* vksift_loader_next(void* handle, int* width,
                                          int* height) {
  auto* l = static_cast<Loader*>(handle);
  size_t idx;
  {
    std::lock_guard<std::mutex> lk(l->mu);
    if (l->next_consume >= l->paths.size()) return nullptr;
    idx = l->next_consume;
  }
  l->cv_worker.notify_all();
  std::unique_lock<std::mutex> lk(l->mu);
  l->cv_consumer.wait(lk, [&] { return l->done_set[idx] != 0; });
  Image img = std::move(l->done[idx]);
  l->done_set[idx] = 0;
  l->next_consume++;
  lk.unlock();
  l->cv_worker.notify_all();
  if (!img.ok) {
    *width = *height = 0;
    return nullptr;
  }
  auto* out = static_cast<uint8_t*>(malloc(img.pixels.size()));
  memcpy(out, img.pixels.data(), img.pixels.size());
  *width = img.width;
  *height = img.height;
  return out;
}

VKSIFT_IO_API void vksift_loader_destroy(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  l->stop.store(true);
  l->cv_worker.notify_all();
  for (auto& t : l->workers) t.join();
  delete l;
}

// ---------------------------------------------------------------------------
// Feature serialization (vksift_Feature layout, 164 bytes/feature)
// ---------------------------------------------------------------------------

static const uint32_t kFeatMagic = 0x54464956;  // "VIFT"
static const uint32_t kFeatSize = 164;

VKSIFT_IO_API int vksift_save_features(const char* path, const void* data,
                                       uint32_t nb_features) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  uint32_t header[2] = {kFeatMagic, nb_features};
  if (fwrite(header, sizeof header, 1, f) != 1 ||
      (nb_features &&
       fwrite(data, kFeatSize, nb_features, f) != nb_features)) {
    fclose(f);
    return -1;
  }
  fclose(f);
  return 0;
}

// Returns a malloc'd buffer of nb*164 bytes (caller frees) or nullptr.
VKSIFT_IO_API void* vksift_load_features(const char* path,
                                         uint32_t* nb_features) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  uint32_t header[2];
  if (fread(header, sizeof header, 1, f) != 1 || header[0] != kFeatMagic) {
    fclose(f);
    return nullptr;
  }
  // Validate the on-disk count against the remaining file size before
  // allocating: a corrupt/truncated header must produce a clean error,
  // not a huge unchecked malloc + fread into it.
  long data_start = ftell(f);
  if (data_start < 0 || fseek(f, 0, SEEK_END) != 0) {
    fclose(f);
    return nullptr;
  }
  long file_end = ftell(f);
  if (file_end < data_start ||
      static_cast<uint64_t>(file_end - data_start) !=
          static_cast<uint64_t>(header[1]) * kFeatSize ||
      fseek(f, data_start, SEEK_SET) != 0) {
    fclose(f);
    return nullptr;
  }
  *nb_features = header[1];
  // malloc(0) may legally return nullptr; keep empty files loadable.
  void* out = malloc(header[1] ? static_cast<size_t>(header[1]) * kFeatSize
                               : 1);
  if (!out) {
    fclose(f);
    return nullptr;
  }
  if (header[1] && fread(out, kFeatSize, header[1], f) != header[1]) {
    free(out);
    fclose(f);
    return nullptr;
  }
  fclose(f);
  return out;
}
