// Native data loader: multi-threaded PNG decode + alpha compositing.
//
// The port's own copy of tinynerf_tpu/native/loader.cpp (the same code): a
// C++ thread pool decodes straight into one preallocated float buffer that
// the host then ships to the device once.
//
// C ABI (consumed via ctypes from tinynerf_tpu_torch/native/__init__.py):
//   tn_png_dims(path, &w, &h)            -> probe dimensions
//   tn_load_pngs(paths, n, w, h, bg_rgb, out, n_threads)
//       decode n same-sized PNGs into out [n, h, w, 3] float32 in [0, 1],
//       compositing RGBA over the given background color.
//
// Build (at first use, into <checkout>/build/tinynerf_tpu_torch/):
//   g++ -O3 -fPIC -shared -std=c++17 loader.cpp -lpng -lz -o libtn_loader_<hash>.so

#include <png.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Image {
  std::vector<uint8_t> rgba;  // [h, w, 4]
  int w = 0;
  int h = 0;
};

// Decode one PNG to RGBA8. Returns 0 on success.
int decode_png(const char* path, Image* img) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return 1;

  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return 2;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    std::fclose(fp);
    return 2;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 3;
  }

  png_init_io(png, fp);
  png_read_info(png, info);

  // normalize every input format to 8-bit RGBA
  png_byte color_type = png_get_color_type(png, info);
  png_byte bit_depth = png_get_bit_depth(png, info);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_RGB || color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_PALETTE)
    png_set_filler(png, 0xFF, PNG_FILLER_AFTER);
  png_read_update_info(png, info);

  img->w = static_cast<int>(png_get_image_width(png, info));
  img->h = static_cast<int>(png_get_image_height(png, info));
  img->rgba.resize(static_cast<size_t>(img->w) * img->h * 4);

  std::vector<png_bytep> rows(img->h);
  for (int y = 0; y < img->h; ++y)
    rows[y] = img->rgba.data() + static_cast<size_t>(y) * img->w * 4;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 0;
}

}  // namespace

extern "C" {

int tn_png_dims(const char* path, int* w, int* h) {
  Image img;
  // full decode is wasteful for a probe but runs once per dataset
  int rc = decode_png(path, &img);
  if (rc) return rc;
  *w = img.w;
  *h = img.h;
  return 0;
}

int tn_load_pngs(const char** paths, int n, int w, int h, float bg_r,
                 float bg_g, float bg_b, float* out, int n_threads) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;

  const float bg[3] = {bg_r, bg_g, bg_b};
  std::atomic<int> next(0);
  std::atomic<int> err(0);

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || err.load()) return;
      Image img;
      int rc = decode_png(paths[i], &img);
      if (rc || img.w != w || img.h != h) {
        err.store(rc ? rc : 4);
        return;
      }
      float* dst = out + static_cast<size_t>(i) * h * w * 3;
      const uint8_t* src = img.rgba.data();
      // Pillow AlphaComposite.c integer math (PRECISION_BITS = 7) with an
      // opaque destination — bit-identical to the PIL fallback
      // (Image.alpha_composite + convert("RGB") + /255), so training inputs
      // do not depend on whether the native toolchain is available.
      constexpr int kPB = 7;
      uint32_t bg_u8[3];
      for (int c = 0; c < 3; ++c) {
        float b = bg[c] * 255.0f;
        bg_u8[c] = static_cast<uint32_t>(b < 0 ? 0 : (b > 255 ? 255 : b + 0.5f));
      }
      for (size_t p = 0, np = static_cast<size_t>(w) * h; p < np; ++p) {
        const uint32_t a = src[4 * p + 3];
        const uint32_t coef1 = (a * 255u * 255u * (1u << kPB)) / (255u * 255u);
        const uint32_t coef2 = 255u * (1u << kPB) - coef1;
        for (int c = 0; c < 3; ++c) {
          const uint32_t v = src[4 * p + c];
          uint32_t tmp = v * coef1 + bg_u8[c] * coef2 + (0x80u << kPB);
          const uint32_t q = (tmp + (tmp >> 8)) >> (8 + kPB);
          dst[3 * p + c] = static_cast<float>(q) / 255.0f;
        }
      }
    }
  };

  std::vector<std::thread> threads;
  const int nt = n_threads < n ? n_threads : n;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return err.load();
}

}  // extern "C"
