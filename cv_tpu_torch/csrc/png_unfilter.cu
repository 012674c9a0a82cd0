// PNG scanline unfiltering (PNG spec §9), host code.
//
// The counterpart of the reference loader's native decoder
// (native/image_loader.cpp, through libpng): the Average and Paeth filters
// take the byte to the left, so a row is a sequential walk that the port's
// plain version (cv_tpu_torch/utils/png.py::unfilter_plain) takes one byte
// at a time in Python.  This file holds no device code: nvcc hands it to
// its host compiler, and the library is built and loaded as the kernels
// are (cv_tpu_torch/kernels.py).  A ctypes call releases the interpreter
// lock, so the prefetch loader's threads decode alongside the engine.
//
// Bound: one pass over the bytes; at ~2 MB a 1080x1920 gray frame it is a
// few milliseconds of one core.

#include <cstdint>
#include <cstdlib>

static inline int paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    return pb <= pc ? b : c;
}

// rows: height x (stride + 1) bytes, each row its filter type then its
// filtered bytes; out: height x stride unfiltered bytes.  Returns 0, or
// 1 + the first row whose filter type is not 0-4 (out is then partial).
extern "C" int cv_png_unfilter(const uint8_t* rows, uint8_t* out, int height, int stride, int bpp) {
    for (int y = 0; y < height; ++y) {
        const uint8_t* in = rows + (size_t)y * (stride + 1);
        const int ftype = in[0];
        ++in;
        uint8_t* o = out + (size_t)y * stride;
        const uint8_t* up = y > 0 ? o - stride : nullptr;
        switch (ftype) {
            case 0:
                for (int i = 0; i < stride; ++i) o[i] = in[i];
                break;
            case 1:
                for (int i = 0; i < stride; ++i) o[i] = (uint8_t)(in[i] + (i >= bpp ? o[i - bpp] : 0));
                break;
            case 2:
                for (int i = 0; i < stride; ++i) o[i] = (uint8_t)(in[i] + (up ? up[i] : 0));
                break;
            case 3:
                for (int i = 0; i < stride; ++i) {
                    const int left = i >= bpp ? o[i - bpp] : 0;
                    o[i] = (uint8_t)(in[i] + ((left + (up ? up[i] : 0)) >> 1));
                }
                break;
            case 4:
                for (int i = 0; i < stride; ++i) {
                    const int left = i >= bpp ? o[i - bpp] : 0;
                    const int b = up ? up[i] : 0;
                    const int c = (up && i >= bpp) ? up[i - bpp] : 0;
                    o[i] = (uint8_t)(in[i] + paeth(left, b, c));
                }
                break;
            default:
                return y + 1;
        }
    }
    return 0;
}
