// Native host-side data loader: parallel JPEG/PNG decode + letterbox.
// The PyTorch port's own copy of `yoloclip_tpu/native/dataload.cpp`:
// canvases, scales and decodes are byte-identical to it on the same
// inputs (the letterbox arithmetic, its float rounding and `v + 0.5f` are
// unchanged).
//
// Role: the serving runtime letterboxes every request on the client's
// thread into the fixed model canvas, and the streaming CLI decodes image
// directories per step. This module does decode + letterbox for a whole
// batch in one C call with a thread pool, writing straight into a
// preallocated NHWC uint8 slab that uploads to the device as-is
// (normalization happens on the device).
//
// Letterbox contract (must match data/coco.py and ops/preprocess.py):
//   scale = min(th/h, tw/w); resized dims = (int(h*scale), int(w*scale))
//   (C truncation == Python int()); bilinear sample with the standard
//   half-pixel convention (sx = (dx+0.5)/scale - 0.5, clamped); paste at
//   the TOP-LEFT of a zeroed (th, tw, 3) canvas.
//
// Built at first use by yoloclip_tpu_torch/_build.py (g++ -O3 -shared
// -ljpeg -lpng). Where the libjpeg/libpng headers are missing it is built
// with -DYCL_NO_CODECS: the letterbox stays, decoding reports
// YCL_ERR_NO_CODECS and `ycl_has_codecs()` returns 0.
// Bindings: yoloclip_tpu_torch/native/__init__.py (ctypes).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <cmath>
#include <algorithm>
#include <atomic>
#include <thread>
#include <vector>

#ifndef YCL_NO_CODECS
#include <jpeglib.h>
#include <png.h>
#endif

namespace {

// decode_rgb_impl's return code when the library was built without codecs
constexpr int YCL_ERR_NO_CODECS = -3;

// ---------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------

#ifndef YCL_NO_CODECS
struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
    JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
    longjmp(err->jmp, 1);
}

bool is_jpeg(const uint8_t* d, long n) {
    return n >= 3 && d[0] == 0xFF && d[1] == 0xD8 && d[2] == 0xFF;
}

bool is_png(const uint8_t* d, long n) {
    static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', 0x0D, 0x0A,
                                   0x1A, 0x0A};
    return n >= 8 && memcmp(d, sig, 8) == 0;
}

// out == nullptr: probe dimensions only.
int decode_jpeg_rgb(const uint8_t* data, long size, int* h, int* w,
                    uint8_t* out) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jmp)) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
                 static_cast<unsigned long>(size));
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    *h = static_cast<int>(cinfo.image_height);
    *w = static_cast<int>(cinfo.image_width);
    if (!out) {
        jpeg_destroy_decompress(&cinfo);
        return 0;
    }
    jpeg_start_decompress(&cinfo);
    const int stride = (*w) * 3;
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = out + static_cast<size_t>(cinfo.output_scanline)
                       * stride;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

struct PngReadState {
    const uint8_t* data;
    long size;
    long pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
    PngReadState* s = static_cast<PngReadState*>(png_get_io_ptr(png));
    if (s->pos + static_cast<long>(n) > s->size) {
        png_error(png, "read past end");
    }
    memcpy(out, s->data + s->pos, n);
    s->pos += static_cast<long>(n);
}

int decode_png_rgb(const uint8_t* data, long size, int* h, int* w,
                   uint8_t* out) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING,
                                             nullptr, nullptr, nullptr);
    if (!png) return -1;
    png_infop info = png_create_info_struct(png);
    if (!info) {
        png_destroy_read_struct(&png, nullptr, nullptr);
        return -1;
    }
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        return -1;
    }
    PngReadState state = {data, size, 0};
    png_set_read_fn(png, &state, png_read_fn);
    png_read_info(png, info);
    *h = static_cast<int>(png_get_image_height(png, info));
    *w = static_cast<int>(png_get_image_width(png, info));
    if (!out) {
        png_destroy_read_struct(&png, &info, nullptr);
        return 0;
    }
    // normalize anything to 8-bit RGB
    png_set_strip_16(png);
    png_set_palette_to_rgb(png);
    png_set_expand_gray_1_2_4_to_8(png);
    png_set_gray_to_rgb(png);
    png_set_strip_alpha(png);
    png_read_update_info(png, info);
    std::vector<png_bytep> rows(*h);
    for (int y = 0; y < *h; ++y) {
        rows[y] = out + static_cast<size_t>(y) * (*w) * 3;
    }
    png_read_image(png, rows.data());
    png_destroy_read_struct(&png, &info, nullptr);
    return 0;
}

int decode_rgb_impl(const uint8_t* data, long size, int* h, int* w,
                    uint8_t* out) {
    if (is_jpeg(data, size)) return decode_jpeg_rgb(data, size, h, w, out);
    if (is_png(data, size)) return decode_png_rgb(data, size, h, w, out);
    return -2;  // unknown format
}
#else
int decode_rgb_impl(const uint8_t*, long, int*, int*, uint8_t*) {
    return YCL_ERR_NO_CODECS;
}
#endif

// ---------------------------------------------------------------------
// bilinear resize + letterbox
// ---------------------------------------------------------------------

void resize_bilinear_u8(const uint8_t* src, int h, int w,
                        uint8_t* dst, int rh, int rw) {
    const float sy = static_cast<float>(h) / rh;
    const float sx = static_cast<float>(w) / rw;
    std::vector<int> x0(rw), x1(rw);
    std::vector<float> fx(rw);
    for (int dx = 0; dx < rw; ++dx) {
        float x = (dx + 0.5f) * sx - 0.5f;
        x = std::max(0.0f, std::min(x, static_cast<float>(w - 1)));
        x0[dx] = static_cast<int>(x);
        x1[dx] = std::min(x0[dx] + 1, w - 1);
        fx[dx] = x - x0[dx];
    }
    for (int dy = 0; dy < rh; ++dy) {
        float y = (dy + 0.5f) * sy - 0.5f;
        y = std::max(0.0f, std::min(y, static_cast<float>(h - 1)));
        const int y0 = static_cast<int>(y);
        const int y1 = std::min(y0 + 1, h - 1);
        const float fy = y - y0;
        const uint8_t* r0 = src + static_cast<size_t>(y0) * w * 3;
        const uint8_t* r1 = src + static_cast<size_t>(y1) * w * 3;
        uint8_t* drow = dst + static_cast<size_t>(dy) * rw * 3;
        for (int dx = 0; dx < rw; ++dx) {
            const uint8_t* p00 = r0 + x0[dx] * 3;
            const uint8_t* p01 = r0 + x1[dx] * 3;
            const uint8_t* p10 = r1 + x0[dx] * 3;
            const uint8_t* p11 = r1 + x1[dx] * 3;
            const float wx = fx[dx];
            for (int c = 0; c < 3; ++c) {
                const float top = p00[c] + (p01[c] - p00[c]) * wx;
                const float bot = p10[c] + (p11[c] - p10[c]) * wx;
                const float v = top + (bot - top) * fy;
                drow[dx * 3 + c] =
                    static_cast<uint8_t>(v + 0.5f);
            }
        }
    }
}

float letterbox_impl(const uint8_t* src, int h, int w,
                     uint8_t* canvas, int th, int tw) {
    // double precision: Python's int(h * scale) truncates a float64
    // product, and float32 rounding can land on the other side of the
    // integer boundary for sizes where h*scale is (near-)integral
    const double scale = std::min(static_cast<double>(th) / h,
                                  static_cast<double>(tw) / w);
    const int rh = static_cast<int>(h * scale);   // int() floor, ref math
    const int rw = static_cast<int>(w * scale);
    std::vector<uint8_t> resized(static_cast<size_t>(rh) * rw * 3);
    resize_bilinear_u8(src, h, w, resized.data(), rh, rw);
    for (int y = 0; y < rh; ++y) {
        memcpy(canvas + static_cast<size_t>(y) * tw * 3,
               resized.data() + static_cast<size_t>(y) * rw * 3,
               static_cast<size_t>(rw) * 3);
    }
    return static_cast<float>(scale);
}

std::vector<uint8_t> read_file(const char* path) {
    std::vector<uint8_t> buf;
    FILE* f = fopen(path, "rb");
    if (!f) return buf;
    fseek(f, 0, SEEK_END);
    const long n = ftell(f);
    fseek(f, 0, SEEK_SET);
    buf.resize(n);
    if (fread(buf.data(), 1, n, f) != static_cast<size_t>(n)) buf.clear();
    fclose(f);
    return buf;
}

}  // namespace

extern "C" {

// 1 when JPEG/PNG decoding was compiled in, 0 for a -DYCL_NO_CODECS build.
int ycl_has_codecs() {
#ifdef YCL_NO_CODECS
    return 0;
#else
    return 1;
#endif
}

// Probe encoded image dimensions. Returns 0 ok, <0 error.
int ycl_image_info(const uint8_t* data, long size, int* h, int* w) {
    return decode_rgb_impl(data, size, h, w, nullptr);
}

// Decode to RGB uint8 HWC (caller allocates h*w*3). Returns 0 ok.
int ycl_decode_rgb(const uint8_t* data, long size, uint8_t* out) {
    int h, w;
    return decode_rgb_impl(data, size, &h, &w, out);
}

// Letterbox a decoded RGB image into a ZEROED (th, tw, 3) canvas
// (top-left paste). Returns the resize scale.
float ycl_letterbox(const uint8_t* src, int h, int w,
                    uint8_t* canvas, int th, int tw) {
    return letterbox_impl(src, h, w, canvas, th, tw);
}

// Decode + letterbox a batch of image FILES in parallel.
// canvases: zeroed n*th*tw*3 uint8; scales: n floats (0.0 on failure).
// Returns the number of failed items.
int ycl_load_batch(const char** paths, int n, int th, int tw,
                   uint8_t* canvases, float* scales, int nthreads) {
    if (nthreads < 1) nthreads = 1;
    nthreads = std::min(nthreads, n);
    std::atomic<int> next(0), failures(0);
    auto worker = [&]() {
        for (;;) {
            const int i = next.fetch_add(1);
            if (i >= n) return;
            scales[i] = 0.0f;
            std::vector<uint8_t> bytes = read_file(paths[i]);
            int h = 0, w = 0;
            if (bytes.empty() ||
                decode_rgb_impl(bytes.data(), bytes.size(), &h, &w,
                                nullptr) != 0) {
                failures.fetch_add(1);
                continue;
            }
            std::vector<uint8_t> img(static_cast<size_t>(h) * w * 3);
            if (decode_rgb_impl(bytes.data(), bytes.size(), &h, &w,
                                img.data()) != 0) {
                failures.fetch_add(1);
                continue;
            }
            uint8_t* canvas = canvases
                + static_cast<size_t>(i) * th * tw * 3;
            scales[i] = letterbox_impl(img.data(), h, w, canvas, th, tw);
        }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < nthreads; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
    return failures.load();
}

}  // extern "C"
