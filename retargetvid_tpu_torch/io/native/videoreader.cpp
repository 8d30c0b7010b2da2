// Native threaded video decode loader (C ABI, driven via ctypes).
//
// The PyTorch port's copy of the JAX package's decoder: a C++ worker
// decodes and BGR->RGB converts frames into a bounded queue while Python
// only copies finished frames into a caller-owned numpy buffer, so the
// decode path holds no GIL and allocates no per-frame numpy array (the
// counterpart of the reference's imutils.FileVideoStream decode thread,
// smartVidCrop.py:299).
//
// Build:  make -C retargetvid_tpu_torch/io/native OUT=<library path>
//         (g++ + OpenCV core/imgproc/videoio; ``io/native_reader.py``
//         runs it at first use into build/native/)
//
// C ABI (all functions thread-compatible for distinct handles):
//   vr_open(path, queue_frames)      -> handle (NULL on failure)
//   vr_probe(handle, out[4])         -> fps, frame_count, width, height
//   vr_next_batch(handle, dst, max)  -> frames written into dst
//                                       (max * H * W * 3 uint8, RGB), 0=EOF
//   vr_close(handle)
//   vr_last_error()                  -> static message for the last vr_open
//                                       failure in this process

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <opencv2/core.hpp>
#include <opencv2/imgproc.hpp>
#include <opencv2/videoio.hpp>

namespace {

std::mutex g_err_mutex;
std::string g_last_error;

void set_error(const std::string& msg) {
  std::lock_guard<std::mutex> lock(g_err_mutex);
  g_last_error = msg;
}

struct Reader {
  cv::VideoCapture cap;
  double fps = 0.0;
  int frame_count = 0;
  int width = 0;
  int height = 0;

  size_t capacity;
  std::deque<cv::Mat> queue;       // decoded RGB frames
  std::mutex mutex;
  std::condition_variable cv_pop;  // signaled when frames arrive / EOF
  std::condition_variable cv_push; // signaled when space frees up
  bool done = false;
  bool stop = false;
  std::thread worker;

  explicit Reader(size_t cap_frames) : capacity(cap_frames) {}

  void run() {
    cv::Mat bgr;
    for (;;) {
      {
        std::unique_lock<std::mutex> lock(mutex);
        cv_push.wait(lock, [&] { return queue.size() < capacity || stop; });
        if (stop) break;
      }
      if (!cap.read(bgr)) break;
      cv::Mat rgb;
      cv::cvtColor(bgr, rgb, cv::COLOR_BGR2RGB);
      {
        std::lock_guard<std::mutex> lock(mutex);
        queue.push_back(std::move(rgb));
      }
      cv_pop.notify_one();
    }
    {
      std::lock_guard<std::mutex> lock(mutex);
      done = true;
    }
    cv_pop.notify_all();
  }
};

}  // namespace

extern "C" {

void* vr_open(const char* path, int queue_frames) {
  auto* r = new Reader(queue_frames > 0 ? (size_t)queue_frames : 256);
  if (!r->cap.open(path)) {
    set_error(std::string("cannot open video: ") + path);
    delete r;
    return nullptr;
  }
  r->fps = r->cap.get(cv::CAP_PROP_FPS);
  r->frame_count = (int)r->cap.get(cv::CAP_PROP_FRAME_COUNT);
  r->width = (int)r->cap.get(cv::CAP_PROP_FRAME_WIDTH);
  r->height = (int)r->cap.get(cv::CAP_PROP_FRAME_HEIGHT);
  r->worker = std::thread([r] { r->run(); });
  return r;
}

void vr_probe(void* handle, double* out4) {
  auto* r = static_cast<Reader*>(handle);
  out4[0] = r->fps;
  out4[1] = (double)r->frame_count;
  out4[2] = (double)r->width;
  out4[3] = (double)r->height;
}

int vr_next_batch(void* handle, uint8_t* dst, int max_frames) {
  auto* r = static_cast<Reader*>(handle);
  const size_t frame_bytes = (size_t)r->width * r->height * 3;
  int written = 0;
  while (written < max_frames) {
    cv::Mat frame;
    {
      std::unique_lock<std::mutex> lock(r->mutex);
      r->cv_pop.wait(lock, [&] { return !r->queue.empty() || r->done; });
      if (r->queue.empty()) break;  // done and drained
      frame = std::move(r->queue.front());
      r->queue.pop_front();
    }
    r->cv_push.notify_one();
    if (frame.isContinuous()) {
      std::memcpy(dst + (size_t)written * frame_bytes, frame.data,
                  frame_bytes);
    } else {
      const size_t row = (size_t)r->width * 3;
      for (int y = 0; y < r->height; ++y) {
        std::memcpy(dst + (size_t)written * frame_bytes + y * row,
                    frame.ptr(y), row);
      }
    }
    ++written;
  }
  return written;
}

void vr_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  {
    std::lock_guard<std::mutex> lock(r->mutex);
    r->stop = true;
  }
  r->cv_push.notify_all();
  if (r->worker.joinable()) r->worker.join();
  delete r;
}

const char* vr_last_error() {
  std::lock_guard<std::mutex> lock(g_err_mutex);
  return g_last_error.c_str();
}

}  // extern "C"
