// PNG scanline unfilter (PNG specification, section 9: filter method 0).
//
// The decompressed image data of a non-interlaced PNG is `height` rows of
// one filter-type byte followed by `row_bytes` filtered bytes. Each row is
// reconstructed in place of `out` (height * row_bytes bytes) from the row
// above it; `bpp` is the bytes per complete pixel (1 gray, 3 RGB, 4 RGBA at
// 8 bits). Average and Paeth read the byte `bpp` to the left in the same
// reconstructed row, so a row is serial along its length; rows are serial
// too. The numpy twin is kitti_io._unfilter_plain.
//
// Returns -1 on success, else the index of the first row whose filter type
// is not 0-4.
#include <cstdint>
#include <cstdlib>

extern "C" int64_t png_unfilter(const uint8_t* data, int64_t height, int64_t row_bytes,
                                int64_t bpp, uint8_t* out) {
  for (int64_t r = 0; r < height; ++r) {
    const uint8_t* src = data + r * (row_bytes + 1);
    const uint8_t kind = src[0];
    ++src;
    uint8_t* cur = out + r * row_bytes;
    const uint8_t* up = r > 0 ? out + (r - 1) * row_bytes : nullptr;
    switch (kind) {
      case 0:
        for (int64_t i = 0; i < row_bytes; ++i) cur[i] = src[i];
        break;
      case 1:
        for (int64_t i = 0; i < row_bytes; ++i)
          cur[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < row_bytes; ++i)
          cur[i] = static_cast<uint8_t>(src[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          cur[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = static_cast<uint8_t>(src[i] + pred);
        }
        break;
      default:
        return r;
    }
  }
  return -1;
}
