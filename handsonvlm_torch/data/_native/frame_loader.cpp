// Native frame loader: JPEG decode + bicubic resize + center crop + CLIP
// normalize, multi-threaded over a batch.
//
// The port's copy of handsonvlm_tpu/data/_native/frame_loader.cpp: a
// native path for the reference's host-side frame loading
// (hoi_forecast/dataset/video_utils.py load_video_frames: 10 JPEG decodes
// and preprocessing per sample through PIL). Exposed through a plain C ABI
// and loaded with ctypes by handsonvlm_torch/data/native_loader.py.
//
// Math matches data/video_io.py clip_preprocess: shortest side -> `size`
// with bicubic (a=-0.5, center-aligned sampling like PIL), center crop,
// x/255, (x-mean)/std, CHW output.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr float kMean[3] = {0.48145466f, 0.4578275f, 0.40821073f};
constexpr float kStd[3] = {0.26862954f, 0.26130258f, 0.27577711f};

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Decode a JPEG file to RGB8. Returns false on failure.
bool decode_jpeg(const char* path, std::vector<unsigned char>& rgb, int& w, int& h) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  w = cinfo.output_width;
  h = cinfo.output_height;
  rgb.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = rgb.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

inline float cubic_weight(float x) {  // Catmull-Rom style, a = -0.5 (PIL)
  const float a = -0.5f;
  x = std::fabs(x);
  if (x < 1.0f) return ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
  if (x < 2.0f) return (((x - 5.0f) * x + 8.0f) * x - 4.0f) * a;
  return 0.0f;
}

// PIL-style convolution resampling coefficients for one axis: support
// scales with the downscale ratio (antialiasing), weights normalised.
struct AxisFilter {
  std::vector<int> bounds;   // (out,) first source index
  std::vector<int> counts;   // (out,) number of taps
  std::vector<float> coefs;  // (out * max_taps)
  int max_taps = 0;
};

AxisFilter build_filter(int in_size, int out_size) {
  const double kSupport = 2.0;  // bicubic
  AxisFilter f;
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = kSupport * filterscale;
  f.max_taps = static_cast<int>(std::ceil(support)) * 2 + 1;
  f.bounds.resize(out_size);
  f.counts.resize(out_size);
  f.coefs.assign(static_cast<size_t>(out_size) * f.max_taps, 0.0f);
  for (int i = 0; i < out_size; ++i) {
    double center = (i + 0.5) * scale;
    int xmin = std::max(0, static_cast<int>(center - support + 0.5));
    int xmax = std::min(in_size, static_cast<int>(center + support + 0.5));
    double wsum = 0.0;
    std::vector<double> w(xmax - xmin);
    for (int x = xmin; x < xmax; ++x) {
      double ww = cubic_weight(static_cast<float>((x + 0.5 - center) / filterscale));
      w[x - xmin] = ww;
      wsum += ww;
    }
    f.bounds[i] = xmin;
    f.counts[i] = xmax - xmin;
    for (int k = 0; k < xmax - xmin; ++k) {
      f.coefs[static_cast<size_t>(i) * f.max_taps + k] =
          static_cast<float>(wsum != 0.0 ? w[k] / wsum : 0.0);
    }
  }
  return f;
}

// Separable PIL-style bicubic resize RGB8 -> float RGB (HWC).
void resize_bicubic(const unsigned char* src, int sw, int sh, float* dst, int dw, int dh) {
  AxisFilter fx = build_filter(sw, dw);
  AxisFilter fy = build_filter(sh, dh);
  // horizontal pass: (sh, dw)
  std::vector<float> tmp(static_cast<size_t>(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const unsigned char* row = src + static_cast<size_t>(y) * sw * 3;
    for (int x = 0; x < dw; ++x) {
      const float* cf = fx.coefs.data() + static_cast<size_t>(x) * fx.max_taps;
      int x0 = fx.bounds[x], cnt = fx.counts[x];
      float acc[3] = {0, 0, 0};
      for (int k = 0; k < cnt; ++k) {
        const unsigned char* p = row + static_cast<size_t>(x0 + k) * 3;
        float w = cf[k];
        acc[0] += w * p[0];
        acc[1] += w * p[1];
        acc[2] += w * p[2];
      }
      float* q = tmp.data() + (static_cast<size_t>(y) * dw + x) * 3;
      q[0] = acc[0]; q[1] = acc[1]; q[2] = acc[2];
    }
  }
  // vertical pass: (dh, dw)
  for (int y = 0; y < dh; ++y) {
    const float* cf = fy.coefs.data() + static_cast<size_t>(y) * fy.max_taps;
    int y0 = fy.bounds[y], cnt = fy.counts[y];
    for (int x = 0; x < dw; ++x) {
      float acc[3] = {0, 0, 0};
      for (int k = 0; k < cnt; ++k) {
        const float* p = tmp.data() + (static_cast<size_t>(y0 + k) * dw + x) * 3;
        float w = cf[k];
        acc[0] += w * p[0];
        acc[1] += w * p[1];
        acc[2] += w * p[2];
      }
      float* q = dst + (static_cast<size_t>(y) * dw + x) * 3;
      q[0] = acc[0]; q[1] = acc[1]; q[2] = acc[2];
    }
  }
}

// Full pipeline for one image -> out (3, size, size) CHW float32.
bool process_one(const char* path, float* out, int size) {
  std::vector<unsigned char> rgb;
  int w, h;
  if (!decode_jpeg(path, rgb, w, h)) return false;
  int nw, nh;
  if (w <= h) {
    nw = size;
    nh = std::max(static_cast<int>(std::lround(static_cast<double>(h) * size / w)), size);
  } else {
    nh = size;
    nw = std::max(static_cast<int>(std::lround(static_cast<double>(w) * size / h)), size);
  }
  std::vector<float> resized(static_cast<size_t>(nw) * nh * 3);
  resize_bicubic(rgb.data(), w, h, resized.data(), nw, nh);
  int left = (nw - size) / 2;
  int top = (nh - size) / 2;
  for (int y = 0; y < size; ++y) {
    for (int x = 0; x < size; ++x) {
      const float* p = resized.data() + (static_cast<size_t>(y + top) * nw + (x + left)) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = std::clamp(p[c], 0.0f, 255.0f) / 255.0f;
        out[(static_cast<size_t>(c) * size + y) * size + x] = (v - kMean[c]) / kStd[c];
      }
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Decode+preprocess `n` JPEGs into out (n, 3, size, size) float32.
// Returns the number of successfully processed images; failed slots are
// zero-filled and flagged in `ok` (len n) when non-null.
int decode_preprocess_batch(const char** paths, int n, float* out, int size,
                            int num_threads, unsigned char* ok) {
  if (num_threads <= 0) num_threads = std::thread::hardware_concurrency();
  num_threads = std::max(1, std::min(num_threads, n));
  std::atomic<int> next(0), good(0);
  const size_t stride = static_cast<size_t>(3) * size * size;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      bool success = process_one(paths[i], out + stride * i, size);
      if (!success) std::memset(out + stride * i, 0, stride * sizeof(float));
      if (ok) ok[i] = success ? 1 : 0;
      if (success) good.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return good.load();
}

int native_loader_version() { return 1; }
}
