// frameio: native frame decoding + multi-threaded prefetch queue.
//
// The reference's host-side IO/runtime is C++ (OpenCV imread/cvtColor at
// src/Tracking.cpp:56-70 and cv::FileStorage loading); this is the
// engine's equivalent: a dependency-free decoder for PGM/PPM (binary and
// ascii netpbm — the format TUM/KITTI tooling readily converts to) with
// RGB->grayscale conversion, plus a producer/consumer prefetch queue that
// decodes ahead of the SLAM loop on a thread pool so the accelerator never
// waits on disk.
//
// Exposed as a plain C ABI consumed via ctypes
// (orbslam_in_practice/io/native_loader.py).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int h = 0;
  int w = 0;
  std::vector<float> data;  // grayscale [0, 255]
  bool ok = false;
};

// ---------- netpbm decoding (P2/P3/P5/P6) ----------

bool skip_ws_comments(FILE* f) {
  int c;
  while ((c = fgetc(f)) != EOF) {
    if (c == '#') {
      while ((c = fgetc(f)) != EOF && c != '\n') {
      }
    } else if (!isspace(c)) {
      ungetc(c, f);
      return true;
    }
  }
  return false;
}

bool read_int(FILE* f, int* out) {
  if (!skip_ws_comments(f)) return false;
  return fscanf(f, "%d", out) == 1;
}

Image decode_netpbm(const char* path) {
  Image img;
  FILE* f = fopen(path, "rb");
  if (!f) return img;
  char magic[3] = {0, 0, 0};
  if (fread(magic, 1, 2, f) != 2 || magic[0] != 'P') {
    fclose(f);
    return img;
  }
  int kind = magic[1] - '0';
  if (kind != 2 && kind != 3 && kind != 5 && kind != 6) {
    fclose(f);
    return img;
  }
  int w, h, maxval;
  if (!read_int(f, &w) || !read_int(f, &h) || !read_int(f, &maxval) || w <= 0 ||
      h <= 0 || maxval <= 0 || maxval > 65535) {
    fclose(f);
    return img;
  }
  const int channels = (kind == 3 || kind == 6) ? 3 : 1;
  const size_t n = static_cast<size_t>(w) * h * channels;
  std::vector<float> raw(n);
  if (kind >= 5) {  // binary: one whitespace byte after maxval
    fgetc(f);
    const int bytes = maxval > 255 ? 2 : 1;
    std::vector<uint8_t> buf(n * bytes);
    if (fread(buf.data(), 1, buf.size(), f) != buf.size()) {
      fclose(f);
      return img;
    }
    if (bytes == 1) {
      for (size_t i = 0; i < n; ++i) raw[i] = buf[i];
    } else {  // big-endian 16-bit
      for (size_t i = 0; i < n; ++i)
        raw[i] = (buf[2 * i] << 8 | buf[2 * i + 1]) * 255.0f / maxval;
    }
  } else {  // ascii
    for (size_t i = 0; i < n; ++i) {
      int v;
      if (!read_int(f, &v)) {
        fclose(f);
        return img;
      }
      raw[i] = static_cast<float>(v);
    }
  }
  fclose(f);
  const float scale = maxval > 255 && kind < 5 ? 255.0f / maxval : 1.0f;

  img.h = h;
  img.w = w;
  img.data.resize(static_cast<size_t>(w) * h);
  if (channels == 1) {
    for (size_t i = 0; i < img.data.size(); ++i) img.data[i] = raw[i] * scale;
  } else {
    for (size_t i = 0; i < img.data.size(); ++i) {
      const float r = raw[3 * i], g = raw[3 * i + 1], b = raw[3 * i + 2];
      img.data[i] = (0.299f * r + 0.587f * g + 0.114f * b) * scale;
    }
  }
  img.ok = true;
  return img;
}

// ---------- prefetch queue ----------

struct Queue {
  std::vector<std::string> paths;
  int prefetch = 8;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits
  std::condition_variable cv_space;   // producers wait
  std::map<int, Image> ready;         // decoded, awaiting consumption
  std::atomic<int> next_to_decode{0};
  int next_to_serve = 0;
  bool closed = false;

  void worker() {
    for (;;) {
      const int idx = next_to_decode.fetch_add(1);
      if (idx >= static_cast<int>(paths.size())) return;
      Image img = decode_netpbm(paths[idx].c_str());
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return closed || idx < next_to_serve + prefetch;
      });
      if (closed) return;
      ready.emplace(idx, std::move(img));
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// Decode one image. Returns 0 on success; fills h/w; writes row-major float
// grayscale into out (capacity max_h * max_w).
int fio_read_image(const char* path, float* out, int* h, int* w, int max_h,
                   int max_w) {
  Image img = decode_netpbm(path);
  if (!img.ok || img.h > max_h || img.w > max_w) return -1;
  *h = img.h;
  *w = img.w;
  std::memcpy(out, img.data.data(), img.data.size() * sizeof(float));
  return 0;
}

void* fio_open_queue(const char** paths, int n, int prefetch, int n_threads) {
  auto* q = new Queue();
  q->paths.assign(paths, paths + n);
  q->prefetch = prefetch > 0 ? prefetch : 8;
  if (n_threads <= 0) n_threads = 2;
  for (int i = 0; i < n_threads; ++i)
    q->workers.emplace_back(&Queue::worker, q);
  return q;
}

// Blocks for the next frame in order. Returns the frame index, or -1 at end
// of sequence, or -2 on decode failure / capacity overflow.
int fio_next(void* qp, float* out, int* h, int* w, int max_h, int max_w) {
  auto* q = static_cast<Queue*>(qp);
  std::unique_lock<std::mutex> lk(q->mu);
  if (q->next_to_serve >= static_cast<int>(q->paths.size())) return -1;
  const int idx = q->next_to_serve;
  q->cv_ready.wait(lk, [&] { return q->ready.count(idx) > 0; });
  Image img = std::move(q->ready[idx]);
  q->ready.erase(idx);
  q->next_to_serve++;
  q->cv_space.notify_all();
  lk.unlock();
  if (!img.ok || img.h > max_h || img.w > max_w) return -2;
  *h = img.h;
  *w = img.w;
  std::memcpy(out, img.data.data(), img.data.size() * sizeof(float));
  return idx;
}

void fio_close(void* qp) {
  auto* q = static_cast<Queue*>(qp);
  {
    std::lock_guard<std::mutex> lk(q->mu);
    q->closed = true;
    q->next_to_decode = static_cast<int>(q->paths.size());
    q->cv_space.notify_all();
    q->cv_ready.notify_all();
  }
  for (auto& t : q->workers) t.join();
  delete q;
}

}  // extern "C"
