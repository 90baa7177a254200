// Native batched JPEG decoder: libjpeg across a persistent thread pool.
//
// The reference hides per-frame JPEG decode latency behind torch DataLoader
// worker *processes* (train_lres.py:281-287). Stage-1 training reads 128
// JPEG frames per sample, so decode throughput is the host-side bottleneck;
// this decoder amortizes it with one in-process pool (no pickling, no IPC)
// and one contiguous output buffer per batch.
//
// C ABI (consumed via ctypes from data/jpeg_native.py):
//   lvg_decoder_create(num_threads) -> handle
//   lvg_decoder_destroy(handle)
//   lvg_decode_batch(handle, blobs, sizes, n, out, H, W, C) -> 0 on success
//     Decodes n same-sized RGB JPEGs into out[n, H, W, C] uint8.
//   lvg_probe(blob, size, &H, &W, &C) -> 0 on success (header-only parse)

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one RGB JPEG into out (H*W*3, row-major). Returns 0 on success.
int decode_one(const uint8_t* blob, size_t size, uint8_t* out, int expect_h,
               int expect_w, int expect_c) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, blob, size);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != expect_h ||
      static_cast<int>(cinfo.output_width) != expect_w ||
      cinfo.output_components != expect_c) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  const int stride = expect_w * expect_c;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

class ThreadPool {
 public:
  explicit ThreadPool(int num_threads) : stop_(false) {
    for (int i = 0; i < num_threads; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> task;
          {
            std::unique_lock<std::mutex> lock(mutex_);
            cv_.wait(lock, [this] { return stop_ || !tasks_.empty(); });
            if (stop_ && tasks_.empty()) return;
            task = std::move(tasks_.front());
            tasks_.pop();
          }
          task();
        }
      });
    }
  }

  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lock(mutex_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }

  void submit(std::function<void()> fn) {
    {
      std::lock_guard<std::mutex> lock(mutex_);
      tasks_.push(std::move(fn));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> tasks_;
  std::mutex mutex_;
  std::condition_variable cv_;
  bool stop_;
};

}  // namespace

extern "C" {

void* lvg_decoder_create(int num_threads) {
  if (num_threads <= 0) num_threads = std::thread::hardware_concurrency();
  return new ThreadPool(num_threads);
}

void lvg_decoder_destroy(void* handle) {
  delete static_cast<ThreadPool*>(handle);
}

int lvg_probe(const uint8_t* blob, size_t size, int* h, int* w, int* c) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, blob, size);
  jpeg_read_header(&cinfo, TRUE);
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  *c = cinfo.num_components == 1 ? 3 : cinfo.num_components;  // decode L as RGB
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int lvg_decode_batch(void* handle, const uint8_t** blobs, const size_t* sizes,
                     int n, uint8_t* out, int h, int w, int c) {
  auto* pool = static_cast<ThreadPool*>(handle);
  const size_t frame_bytes = static_cast<size_t>(h) * w * c;

  std::atomic<int> remaining(n);
  std::atomic<int> status(0);
  std::mutex done_mutex;
  std::condition_variable done_cv;

  for (int i = 0; i < n; ++i) {
    pool->submit([&, i] {
      int rc = decode_one(blobs[i], sizes[i], out + frame_bytes * i, h, w, c);
      if (rc != 0) status.store(rc);
      if (remaining.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lock(done_mutex);
        done_cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lock(done_mutex);
  done_cv.wait(lock, [&] { return remaining.load() == 0; });
  return status.load();
}

}  // extern "C"
