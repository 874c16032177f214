// Native host-side batch preprocessing for jittor_mlp_tpu_torch.
//
// Host C++ around the model: batch assembly (uint8 HWC → resized / normalized
// planar float) so the Python feeding loop never touches per-pixel work.
// A copy of jittor_mlp_tpu/data/native/fastloader.cpp. Compiled on demand by
// loader.py (g++ -O3 -shared [-fopenmp]) into build/native/ at the
// repository root, called via ctypes.

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// HWC uint8 -> CHW float32, (x/255 - mean)/std. One image per call site loop;
// n images, parallel-friendly plain loops (auto-vectorized by -O3).
void normalize_u8_nhwc_to_nchw_f32(
    const uint8_t* src, float* dst,
    int64_t n, int64_t h, int64_t w, int64_t c,
    const float* mean, const float* stdv)
{
    const int64_t hw = h * w;
    const int64_t img_in = hw * c;
    const int64_t img_out = c * hw;
    float scale[8], shift[8];
    for (int64_t k = 0; k < c && k < 8; ++k) {
        scale[k] = 1.0f / (255.0f * stdv[k]);
        shift[k] = -mean[k] / stdv[k];
    }
    #pragma omp parallel for if (n > 1)
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* s = src + i * img_in;
        float* d = dst + i * img_out;
        for (int64_t k = 0; k < c; ++k) {
            const float sc = scale[k], sh = shift[k];
            float* dk = d + k * hw;
            const uint8_t* sk = s + k;
            for (int64_t p = 0; p < hw; ++p) {
                dk[p] = (float)sk[p * c] * sc + sh;
            }
        }
    }
}

// Bilinear resize uint8 HWC -> uint8 HWC (half-pixel centers, edge clamp).
void resize_bilinear_u8(
    const uint8_t* src, uint8_t* dst,
    int64_t n, int64_t h, int64_t w, int64_t c,
    int64_t oh, int64_t ow)
{
    const float sy = (float)h / (float)oh;
    const float sx = (float)w / (float)ow;
    #pragma omp parallel for if (n > 1)
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* s = src + i * h * w * c;
        uint8_t* d = dst + i * oh * ow * c;
        for (int64_t y = 0; y < oh; ++y) {
            float fy = ((float)y + 0.5f) * sy - 0.5f;
            fy = std::max(0.0f, std::min(fy, (float)(h - 1)));
            int64_t y0 = (int64_t)fy;
            int64_t y1 = std::min(y0 + 1, h - 1);
            float wy = fy - (float)y0;
            for (int64_t x = 0; x < ow; ++x) {
                float fx = ((float)x + 0.5f) * sx - 0.5f;
                fx = std::max(0.0f, std::min(fx, (float)(w - 1)));
                int64_t x0 = (int64_t)fx;
                int64_t x1 = std::min(x0 + 1, w - 1);
                float wx = fx - (float)x0;
                for (int64_t k = 0; k < c; ++k) {
                    float v00 = s[(y0 * w + x0) * c + k];
                    float v01 = s[(y0 * w + x1) * c + k];
                    float v10 = s[(y1 * w + x0) * c + k];
                    float v11 = s[(y1 * w + x1) * c + k];
                    float v = (1 - wy) * ((1 - wx) * v00 + wx * v01)
                            + wy * ((1 - wx) * v10 + wx * v11);
                    d[(y * ow + x) * c + k] = (uint8_t)(v + 0.5f);
                }
            }
        }
    }
}

}  // extern "C"
