// PNG row unfiltering (the five filter types of PNG method 0).
//
// Built with nms.cpp into the port's host library by
// pointgnn_tpu_torch/postprocess/native.py and called by
// pointgnn_tpu_torch/data/png.py after zlib has inflated the IDAT data.
// The Average and Paeth filters predict each byte from the decoded byte
// to its left, so a row is a sequential loop over its bytes, too slow in
// Python for a full-size image.

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

}  // namespace

extern "C" {

// rows: [height, 1 + stride] (each row's filter byte, then its filtered
// bytes); out: [height, stride] the image bytes; bpp: bytes per pixel.
// Returns -1, or the index of the first row with an unknown filter type.
int64_t pgnn_png_unfilter(const uint8_t* rows, int64_t height,
                          int64_t stride, int64_t bpp, uint8_t* out) {
  for (int64_t r = 0; r < height; ++r) {
    const uint8_t kind = rows[r * (stride + 1)];
    const uint8_t* in = rows + r * (stride + 1) + 1;
    uint8_t* cur = out + r * stride;
    const uint8_t* up = r ? out + (r - 1) * stride : nullptr;
    for (int64_t i = 0; i < stride; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = up ? up[i] : 0;
      const int c = up && i >= bpp ? up[i - bpp] : 0;
      int pred;
      switch (kind) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: pred = paeth(a, b, c); break;
        default: return r;
      }
      cur[i] = static_cast<uint8_t>(in[i] + pred);
    }
  }
  return -1;
}

}  // extern "C"
