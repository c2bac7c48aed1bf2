// PNG scanline unfiltering: None, Sub, Up, Average and Paeth (PNG spec 9.2).
//
// Native counterpart of hive_tpu_torch/io.py's `_png_unfilter`, which walks
// anti-diagonal wavefronts in numpy: a few hundred small numpy calls a frame
// that hold the interpreter lock, so frames decoded on a thread pool queue
// behind each other. Here one call per image runs without the lock.

#include <cstdint>
#include <cstdlib>

// data: `height` rows of a filter-type byte then `stride` filtered bytes.
// out: height * stride unfiltered bytes. bpp: bytes per complete pixel (>= 1).
// Returns 0, or -1 for an unknown filter type.
extern "C" int hive_png_unfilter(const uint8_t* data, int64_t height, int64_t stride,
                                 int64_t bpp, uint8_t* out) {
    for (int64_t r = 0; r < height; ++r) {
        const uint8_t type = data[r * (stride + 1)];
        const uint8_t* f = data + r * (stride + 1) + 1;
        uint8_t* o = out + r * stride;
        const uint8_t* up = r ? out + (r - 1) * stride : nullptr;
        for (int64_t i = 0; i < stride; ++i) {
            const int a = i >= bpp ? o[i - bpp] : 0;
            const int b = up ? up[i] : 0;
            const int c = (up && i >= bpp) ? up[i - bpp] : 0;
            int predictor;
            switch (type) {
                case 0: predictor = 0; break;
                case 1: predictor = a; break;
                case 2: predictor = b; break;
                case 3: predictor = (a + b) >> 1; break;
                case 4: {
                    const int p = a + b - c;
                    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
                    predictor = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    break;
                }
                default: return -1;
            }
            o[i] = static_cast<uint8_t>(f[i] + predictor);
        }
    }
    return 0;
}
