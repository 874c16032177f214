// Native image decode for the jittor_mlp_tpu_torch data pipeline.
//
// Host C++ around the model: threaded JPEG/PNG batch decode (system libjpeg
// / libpng16) with shorter-side resize + center-crop to a square, mirroring
// ImageFolderDataset.get's PIL semantics (data/dataset.py) so the Python
// feeding loop never touches per-pixel work. JPEGs use libjpeg's DCT-domain
// 1/2-1/8 scaled decode to skip most of the IDCT work when the target is
// much smaller than the file. Unsupported containers (bmp/webp/CMYK jpeg)
// report a per-image failure flag and fall back to PIL in Python.
//
// A copy of jittor_mlp_tpu/data/native/decode.cpp: the two packages decode
// the same bytes to the same pixels. Compiled on demand by loader.py
// (g++ -O3 -shared -ljpeg -lpng -lpthread) into build/native/ at the
// repository root, bound via ctypes.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct JErr {
    jpeg_error_mgr pub;
    jmp_buf jb;
};

void jerr_exit(j_common_ptr cinfo) {
    longjmp(reinterpret_cast<JErr*>(cinfo->err)->jb, 1);
}

void jerr_silent(j_common_ptr, int) {}

// Bilinear resize, RGB u8, half-pixel centers (matches loader.resize_batch).
void resize_rgb(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                int dw) {
    const float ry = static_cast<float>(sh) / dh;
    const float rx = static_cast<float>(sw) / dw;
    for (int y = 0; y < dh; ++y) {
        float fy = (y + 0.5f) * ry - 0.5f;
        int y0 = static_cast<int>(std::floor(fy));
        float wy = fy - y0;
        int y1 = std::min(y0 + 1, sh - 1);
        y0 = std::max(y0, 0);
        for (int x = 0; x < dw; ++x) {
            float fx = (x + 0.5f) * rx - 0.5f;
            int x0 = static_cast<int>(std::floor(fx));
            float wx = fx - x0;
            int x1 = std::min(x0 + 1, sw - 1);
            x0 = std::max(x0, 0);
            const uint8_t* p00 = src + (static_cast<int64_t>(y0) * sw + x0) * 3;
            const uint8_t* p01 = src + (static_cast<int64_t>(y0) * sw + x1) * 3;
            const uint8_t* p10 = src + (static_cast<int64_t>(y1) * sw + x0) * 3;
            const uint8_t* p11 = src + (static_cast<int64_t>(y1) * sw + x1) * 3;
            uint8_t* d = dst + (static_cast<int64_t>(y) * dw + x) * 3;
            for (int c = 0; c < 3; ++c) {
                float top = p00[c] + (p01[c] - p00[c]) * wx;
                float bot = p10[c] + (p11[c] - p10[c]) * wx;
                d[c] = static_cast<uint8_t>(top + (bot - top) * wy + 0.5f);
            }
        }
    }
}

// Decoded images larger than this are sent to the PIL fallback instead of
// risking a multi-GB allocation from a (possibly malicious) header.
constexpr int64_t kMaxPixels = 64LL * 1024 * 1024;

// Python's round() is half-to-even; match it so native and PIL-fallback
// geometry agree on exact-.5 scaled dimensions.
inline int64_t round_half_even(double v) {
    return static_cast<int64_t>(std::nearbyint(v));  // FE_TONEAREST default
}

// Shorter-side scale to s (never below), then center-crop s×s — the exact
// geometry of ImageFolderDataset.get: scale = s/min(w,h), dims rounded,
// floored at s.
void finish_to_square(const uint8_t* rgb, int h, int w, uint8_t* out,
                      int64_t s) {
    double scale = static_cast<double>(s) / std::min(h, w);
    int nh = std::max<int64_t>(s, round_half_even(h * scale));
    int nw = std::max<int64_t>(s, round_half_even(w * scale));
    std::vector<uint8_t> tmp;
    const uint8_t* r = rgb;
    if (nh != h || nw != w) {
        tmp.resize(static_cast<size_t>(nh) * nw * 3);
        resize_rgb(rgb, h, w, tmp.data(), nh, nw);
        r = tmp.data();
    }
    int top = (nh - s) / 2;
    int left = (nw - s) / 2;
    for (int64_t y = 0; y < s; ++y) {
        std::memcpy(out + y * s * 3,
                    r + ((top + y) * static_cast<int64_t>(nw) + left) * 3,
                    s * 3);
    }
}

int decode_jpeg(const uint8_t* data, int64_t len, uint8_t* out, int64_t s) {
    jpeg_decompress_struct ci;
    JErr err;
    ci.err = jpeg_std_error(&err.pub);
    err.pub.error_exit = jerr_exit;
    err.pub.emit_message = jerr_silent;
    // declared before setjmp so the longjmp error path (e.g. a JPEG
    // truncated mid-scan) lands with buf still in scope and its destructor
    // running on the return-1 path — no jump over initialization
    std::vector<uint8_t> buf;
    if (setjmp(err.jb)) {
        jpeg_destroy_decompress(&ci);
        return 1;
    }
    jpeg_create_decompress(&ci);
    jpeg_mem_src(&ci, const_cast<unsigned char*>(data),
                 static_cast<unsigned long>(len));
    jpeg_read_header(&ci, TRUE);
    ci.out_color_space = JCS_RGB;
    // largest 1/2^k scale whose shorter side still covers the target
    unsigned denom = 1;
    unsigned shorter = std::min(ci.image_width, ci.image_height);
    while (denom < 8 && shorter / (denom * 2) >= static_cast<unsigned>(s))
        denom *= 2;
    ci.scale_num = 1;
    ci.scale_denom = denom;
    jpeg_start_decompress(&ci);
    if (ci.output_components != 3
        || static_cast<int64_t>(ci.output_width) * ci.output_height
           > kMaxPixels) {
        jpeg_destroy_decompress(&ci);
        return 1;  // CMYK / absurd header dims → PIL fallback
    }
    int w = ci.output_width, h = ci.output_height;
    buf.resize(static_cast<size_t>(h) * w * 3);
    while (ci.output_scanline < ci.output_height) {
        JSAMPROW row = buf.data() + static_cast<size_t>(ci.output_scanline) * w * 3;
        jpeg_read_scanlines(&ci, &row, 1);
    }
    jpeg_finish_decompress(&ci);
    jpeg_destroy_decompress(&ci);
    finish_to_square(buf.data(), h, w, out, s);
    return 0;
}

int decode_png_img(const uint8_t* data, int64_t len, uint8_t* out, int64_t s) {
    png_image im;
    std::memset(&im, 0, sizeof(im));
    im.version = PNG_IMAGE_VERSION;
    if (!png_image_begin_read_from_memory(&im, data,
                                          static_cast<size_t>(len)))
        return 1;
    // Alpha PNGs: libpng's simplified API would COMPOSITE alpha while the
    // PIL path's convert('RGB') drops it — different pixels for the same
    // file. Punt those (and absurd dims) to the PIL fallback.
    if ((im.format & PNG_FORMAT_FLAG_ALPHA)
        || static_cast<int64_t>(im.width) * im.height > kMaxPixels) {
        png_image_free(&im);
        return 1;
    }
    im.format = PNG_FORMAT_RGB;
    std::vector<uint8_t> buf(PNG_IMAGE_SIZE(im));
    if (!png_image_finish_read(&im, nullptr, buf.data(), 0, nullptr)) {
        png_image_free(&im);
        return 1;
    }
    finish_to_square(buf.data(), im.height, im.width, out, s);
    return 0;
}

int decode_one(const uint8_t* data, int64_t len, uint8_t* out,
               int64_t s) noexcept {
    // no exception may escape into the std::thread workers (std::terminate
    // would kill the whole process); allocation failure = PIL fallback
    try {
        if (len >= 3 && data[0] == 0xFF && data[1] == 0xD8)
            return decode_jpeg(data, len, out, s);
        if (len >= 8 && data[0] == 0x89 && data[1] == 'P' && data[2] == 'N'
            && data[3] == 'G')
            return decode_png_img(data, len, out, s);
        return 2;  // unsupported container → PIL fallback
    } catch (...) {
        return 3;
    }
}

}  // namespace

extern "C" {

// One image: returns 0 ok, nonzero = caller should fall back to PIL.
int decode_image_to_square_rgb(const uint8_t* data, int64_t len, uint8_t* out,
                               int64_t s) {
    return decode_one(data, len, out, s);
}

// Batch over a concatenated byte blob with n+1 offsets; out is (n, s, s, 3)
// u8; fail[i] set nonzero where the image needs the PIL fallback. Work is
// spread over nthreads std::threads (images are independent; libjpeg/libpng
// contexts are per-call).
void decode_batch_to_square_rgb(const uint8_t* blob, const int64_t* offsets,
                                int64_t n, uint8_t* out, int64_t s,
                                int64_t nthreads, uint8_t* fail) {
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n) return;
            fail[i] = static_cast<uint8_t>(decode_one(
                blob + offsets[i], offsets[i + 1] - offsets[i],
                out + i * s * s * 3, s));
        }
    };
    int64_t t = std::max<int64_t>(1, std::min(nthreads, n));
    if (t == 1) {
        worker();
        return;
    }
    std::vector<std::thread> pool;
    for (int64_t k = 0; k < t; ++k) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
}

}  // extern "C"
