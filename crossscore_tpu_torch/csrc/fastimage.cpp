// fastimage: the host image-decode core of the port's input pipeline; the
// port's own copy of the JAX package's native decoder (native/fastimage.cpp),
// with the same arithmetic, so that both give the same bits when built with
// the same flags on the same machine.
//
// A training or predict item costs 1+K PNG decodes + resize + crop +
// normalise (the reference does this in PIL/torchvision inside DataLoader
// workers, nvs_dataset.py:428-474). This library fuses the whole per-image
// chain into one C call, so the loader's threads spend their time here,
// without the GIL.
//
// Exposed C ABI (ctypes, crossscore_tpu_torch/data/fastimage.py):
//   fi_image_info(path, &h, &w, &channels, &bit_depth)     -> 0 on success
//   fi_load_rgb(path, out, resize_h, resize_w,
//               crop_i, crop_j, crop_h, crop_w, normalize)  -> 0 on success
//       decode 8-bit PNG (gray/rgb/rgba) -> float32 [0,1] HWC(3)
//       optional antialiased bilinear resize to (resize_h, resize_w) [<=0: off]
//       optional crop (crop_h<=0: off), optional ImageNet normalisation
//   fi_load_metric(path, out, vrange_mode, clamp01, square,
//                  resize_h, resize_w, crop_i, crop_j, crop_h, crop_w)
//       decode 16-bit gray PNG -> float32; vrange_mode 0: /65535, 1: /32767-1
//   fi_*_mem: the same from an in-memory PNG payload (record shards);
//   fi_raw_info, fi_load_*_raw: the same from a pre-decoded "CSRT" payload.
//
// Resize matches torch/torchvision antialiased bilinear semantics
// (triangle filter scaled by the downsampling factor, out-of-range taps
// dropped and weights renormalised), the algorithm of
// crossscore_tpu_torch/ops/interpolate.py::resize_bilinear_antialias.
//
// Build: crossscore_tpu_torch/ops/_build.py::build_host (g++ -O3 -shared
// -fPIC, links libpng + zlib) into build/crossscore_tpu_torch/.

#include <png.h>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr float kImagenetMean[3] = {0.485f, 0.456f, 0.406f};
constexpr float kImagenetStd[3] = {0.229f, 0.224f, 0.225f};

struct PngImage {
    std::vector<uint8_t> data;  // raw rows, tightly packed
    int h = 0, w = 0, channels = 0, bit_depth = 0;
};

// in-memory read source for png_set_read_fn (record-shard payloads decode
// straight from the mmap'd/pread buffer — no temp file, no extra copy)
struct MemSource {
    const uint8_t* data;
    size_t len;
    size_t off;
};

void mem_read_cb(png_structp png, png_bytep out, png_size_t n) {
    MemSource* src = (MemSource*)png_get_io_ptr(png);
    if (src->off + n > src->len) {
        png_error(png, "fastimage: truncated PNG buffer");
        return;
    }
    std::memcpy(out, src->data + src->off, n);
    src->off += n;
}

// shared decode body; exactly one of fp / mem is non-null
int read_png_impl(FILE* fp, MemSource* mem, PngImage* img, bool want_16bit_gray) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
    if (!png) { if (fp) fclose(fp); return 2; }
    png_infop info = png_create_info_struct(png);
    if (!info) { png_destroy_read_struct(&png, nullptr, nullptr); if (fp) fclose(fp); return 2; }
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        if (fp) fclose(fp);
        return 3;
    }
    if (fp) png_init_io(png, fp);
    else png_set_read_fn(png, mem, mem_read_cb);
    png_read_info(png, info);

    int bit_depth = png_get_bit_depth(png, info);
    int color_type = png_get_color_type(png, info);

    if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8) png_set_expand_gray_1_2_4_to_8(png);
    if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);

    if (want_16bit_gray) {
        // metric maps: keep 16-bit, native byte order
        if (bit_depth == 16) png_set_swap(png);  // PNG is big-endian; we want LE
    } else {
        if (bit_depth == 16) png_set_strip_16(png);
        if (color_type & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
        if (color_type == PNG_COLOR_TYPE_GRAY || color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
            png_set_gray_to_rgb(png);
    }
    png_read_update_info(png, info);

    img->h = (int)png_get_image_height(png, info);
    img->w = (int)png_get_image_width(png, info);
    img->channels = (int)png_get_channels(png, info);
    img->bit_depth = (int)png_get_bit_depth(png, info);

    size_t rowbytes = png_get_rowbytes(png, info);
    img->data.resize(rowbytes * img->h);
    std::vector<png_bytep> rows(img->h);
    for (int y = 0; y < img->h; ++y) rows[y] = img->data.data() + y * rowbytes;
    png_read_image(png, rows.data());
    png_read_end(png, nullptr);
    png_destroy_read_struct(&png, &info, nullptr);
    if (fp) fclose(fp);
    return 0;
}

int read_png(const char* path, PngImage* img, bool want_16bit_gray) {
    FILE* fp = fopen(path, "rb");
    if (!fp) return 1;
    return read_png_impl(fp, nullptr, img, want_16bit_gray);
}

int read_png_mem(const uint8_t* data, size_t len, PngImage* img, bool want_16bit_gray) {
    MemSource src{data, len, 0};
    return read_png_impl(nullptr, &src, img, want_16bit_gray);
}

// torch-style antialiased bilinear axis weights (drop out-of-range taps).
struct AxisFilter {
    std::vector<int> starts;       // first source index per output index
    std::vector<int> counts;       // tap count per output index
    std::vector<float> weights;    // flattened taps (max_taps stride)
    int max_taps = 0;
};

AxisFilter make_axis_filter(int in_size, int out_size) {
    AxisFilter f;
    double scale = (double)in_size / out_size;
    double support = scale > 1.0 ? scale : 1.0;
    int taps = (int)std::ceil(2 * support) + 2;
    f.max_taps = taps;
    f.starts.resize(out_size);
    f.counts.resize(out_size);
    f.weights.assign((size_t)out_size * taps, 0.0f);
    std::vector<double> tmp(taps);  // taps grows with the downscale factor
    for (int o = 0; o < out_size; ++o) {
        double center = (o + 0.5) * scale - 0.5;
        int lo = (int)std::floor(center - support);
        double wsum = 0.0;
        int count = 0;
        int first = -1;
        for (int t = 0; t < taps; ++t) {
            int idx = lo + t;
            if (idx < 0 || idx >= in_size) continue;
            double w = 1.0 - std::fabs((center - idx) / support);
            if (w <= 0.0) continue;
            if (first < 0) first = idx;
            // taps are contiguous once positive
            tmp[count++] = w;
            wsum += w;
        }
        f.starts[o] = first < 0 ? 0 : first;
        f.counts[o] = count;
        for (int t = 0; t < count; ++t)
            f.weights[(size_t)o * taps + t] = (float)(tmp[t] / wsum);
    }
    return f;
}

// separable resize: (in_h, in_w, C) f32 -> (out_h, out_w, C) f32
void resize_f32(const float* src, int in_h, int in_w, int c, float* dst, int out_h, int out_w) {
    AxisFilter fh = make_axis_filter(in_h, out_h);
    AxisFilter fw = make_axis_filter(in_w, out_w);
    std::vector<float> tmp((size_t)out_h * in_w * c);
    for (int o = 0; o < out_h; ++o) {
        float* trow = tmp.data() + (size_t)o * in_w * c;
        std::memset(trow, 0, sizeof(float) * in_w * c);
        int s0 = fh.starts[o];
        for (int t = 0; t < fh.counts[o]; ++t) {
            float wgt = fh.weights[(size_t)o * fh.max_taps + t];
            const float* srow = src + (size_t)(s0 + t) * in_w * c;
            for (int i = 0; i < in_w * c; ++i) trow[i] += wgt * srow[i];
        }
    }
    for (int o = 0; o < out_h; ++o) {
        const float* trow = tmp.data() + (size_t)o * in_w * c;
        float* drow = dst + (size_t)o * out_w * c;
        for (int p = 0; p < out_w; ++p) {
            int s0 = fw.starts[p];
            for (int ch = 0; ch < c; ++ch) {
                float acc = 0.0f;
                for (int t = 0; t < fw.counts[p]; ++t)
                    acc += fw.weights[(size_t)p * fw.max_taps + t] * trow[(size_t)(s0 + t) * c + ch];
                drow[(size_t)p * c + ch] = acc;
            }
        }
    }
}

}  // namespace

extern "C" {

int fi_image_info(const char* path, int* h, int* w, int* channels, int* bit_depth) {
    FILE* fp = fopen(path, "rb");
    if (!fp) return 1;
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
    png_infop info = png_create_info_struct(png);
    if (!png || !info) { if (fp) fclose(fp); return 2; }
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        fclose(fp);
        return 3;
    }
    png_init_io(png, fp);
    png_read_info(png, info);
    *h = (int)png_get_image_height(png, info);
    *w = (int)png_get_image_width(png, info);
    *channels = (int)png_get_channels(png, info);
    *bit_depth = (int)png_get_bit_depth(png, info);
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return 0;
}

// shared post-decode chain from a raw u8 HWC(3) buffer (PNG-decoded rows or a
// pre-decoded record-shard tensor). Without a resize, the u8->f32 convert,
// crop and normalise fuse into ONE pass over the crop window only (identical
// arithmetic per element, so bit-identical to the staged form).
//
// normalize modes: 0 = float32 [0,1]; 1 = float32 ImageNet-normalised;
// 2 = raw uint8 passthrough (``out`` is reinterpreted as a uint8 buffer) —
// the wire-compact loader path (data.dataset.wire_uint8): pixels stay uint8
// until the DEVICE normalises them, quartering host->device transfer and
// host collate bytes. Without a resize the crop is a pure row memcpy; with a
// resize the bilinear output is re-quantised (round-to-nearest) to 8 bits.
static int rgb_from_u8(const uint8_t* p8, int in_h, int in_w, float* out,
                       int resize_h, int resize_w,
                       int crop_i, int crop_j, int crop_h, int crop_w,
                       int normalize) {
    int h = in_h, w = in_w;
    bool need_resize =
        resize_h > 0 && resize_w > 0 && (resize_h != h || resize_w != w);

    if (!need_resize) {
        int ci = 0, cj = 0, ch = h, cw = w;
        if (crop_h > 0 && crop_w > 0) {
            ci = crop_i; cj = crop_j; ch = crop_h; cw = crop_w;
            if (ci < 0 || cj < 0 || ci + ch > h || cj + cw > w) return 5;
        }
        for (int y = 0; y < ch; ++y) {
            const uint8_t* srow = p8 + ((size_t)(ci + y) * w + cj) * 3;
            if (normalize == 2) {
                std::memcpy(reinterpret_cast<uint8_t*>(out) + (size_t)y * cw * 3,
                            srow, (size_t)cw * 3);
                continue;
            }
            float* drow = out + (size_t)y * cw * 3;
            if (normalize) {
                for (int x = 0; x < cw; ++x)
                    for (int c = 0; c < 3; ++c)
                        drow[x * 3 + c] =
                            (srow[x * 3 + c] * (1.0f / 255.0f) - kImagenetMean[c]) /
                            kImagenetStd[c];
            } else {
                for (int i = 0; i < cw * 3; ++i) drow[i] = srow[i] * (1.0f / 255.0f);
            }
        }
        return 0;
    }

    std::vector<float> f32((size_t)h * w * 3);
    for (size_t i = 0; i < f32.size(); ++i) f32[i] = p8[i] * (1.0f / 255.0f);

    std::vector<float> resized((size_t)resize_h * resize_w * 3);
    resize_f32(f32.data(), h, w, 3, resized.data(), resize_h, resize_w);
    const float* cur = resized.data();
    h = resize_h;
    w = resize_w;

    int ci = 0, cj = 0, ch = h, cw = w;
    if (crop_h > 0 && crop_w > 0) {
        ci = crop_i; cj = crop_j; ch = crop_h; cw = crop_w;
        if (ci < 0 || cj < 0 || ci + ch > h || cj + cw > w) return 5;
    }
    for (int y = 0; y < ch; ++y) {
        const float* srow = cur + ((size_t)(ci + y) * w + cj) * 3;
        if (normalize == 2) {
            uint8_t* drow = reinterpret_cast<uint8_t*>(out) + (size_t)y * cw * 3;
            for (int i = 0; i < cw * 3; ++i) {
                float v = srow[i];
                v = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
                drow[i] = (uint8_t)lrintf(v * 255.0f);
            }
            continue;
        }
        float* drow = out + (size_t)y * cw * 3;
        if (normalize == 1) {
            for (int x = 0; x < cw; ++x)
                for (int c = 0; c < 3; ++c)
                    drow[x * 3 + c] = (srow[x * 3 + c] - kImagenetMean[c]) / kImagenetStd[c];
        } else {
            std::memcpy(drow, srow, sizeof(float) * cw * 3);
        }
    }
    return 0;
}

static int load_rgb_from(PngImage& img, float* out, int resize_h, int resize_w,
                         int crop_i, int crop_j, int crop_h, int crop_w,
                         int normalize) {
    if (img.channels != 3 || img.bit_depth != 8) return 4;
    return rgb_from_u8(img.data.data(), img.h, img.w, out, resize_h, resize_w,
                       crop_i, crop_j, crop_h, crop_w, normalize);
}

// out must hold crop_h*crop_w*3 (or post-resize/full dims when crop_h<=0) floats.
int fi_load_rgb(const char* path, float* out, int resize_h, int resize_w,
                int crop_i, int crop_j, int crop_h, int crop_w, int normalize) {
    PngImage img;
    int rc = read_png(path, &img, /*want_16bit_gray=*/false);
    if (rc) return rc;
    return load_rgb_from(img, out, resize_h, resize_w, crop_i, crop_j, crop_h, crop_w, normalize);
}

// same as fi_load_rgb, decoding from an in-memory PNG payload (record shards)
int fi_load_rgb_mem(const uint8_t* data, size_t len, float* out,
                    int resize_h, int resize_w,
                    int crop_i, int crop_j, int crop_h, int crop_w, int normalize) {
    PngImage img;
    int rc = read_png_mem(data, len, &img, /*want_16bit_gray=*/false);
    if (rc) return rc;
    return load_rgb_from(img, out, resize_h, resize_w, crop_i, crop_j, crop_h, crop_w, normalize);
}

// shared post-decode chain from a raw u16 HW buffer; see rgb_from_u8. Without
// a resize the crop window alone is converted (the elementwise vrange/clamp/
// square transforms commute with cropping — bit-identical results).
static int metric_from_u16(const uint16_t* p16, int in_h, int in_w, float* out,
                           int vrange_mode, int clamp01, int square,
                           int resize_h, int resize_w,
                           int crop_i, int crop_j, int crop_h, int crop_w) {
    int h = in_h, w = in_w;
    bool need_resize =
        resize_h > 0 && resize_w > 0 && (resize_h != h || resize_w != w);

    if (!need_resize) {
        int ci = 0, cj = 0, ch = h, cw = w;
        if (crop_h > 0 && crop_w > 0) {
            ci = crop_i; cj = crop_j; ch = crop_h; cw = crop_w;
            if (ci < 0 || cj < 0 || ci + ch > h || cj + cw > w) return 5;
        }
        for (int y = 0; y < ch; ++y) {
            const uint16_t* srow = p16 + (size_t)(ci + y) * w + cj;
            float* drow = out + (size_t)y * cw;
            for (int x = 0; x < cw; ++x) {
                float v = vrange_mode == 0 ? srow[x] * (1.0f / 65535.0f)
                                           : srow[x] * (1.0f / 32767.0f) - 1.0f;
                if (clamp01) v = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
                if (square) v = v * v;
                drow[x] = v;
            }
        }
        return 0;
    }

    std::vector<float> f32((size_t)h * w);
    if (vrange_mode == 0) {
        for (size_t i = 0; i < f32.size(); ++i) f32[i] = p16[i] * (1.0f / 65535.0f);
    } else {
        for (size_t i = 0; i < f32.size(); ++i) f32[i] = p16[i] * (1.0f / 32767.0f) - 1.0f;
    }
    if (clamp01)
        for (auto& v : f32) v = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
    if (square)
        for (auto& v : f32) v = v * v;

    std::vector<float> resized((size_t)resize_h * resize_w);
    resize_f32(f32.data(), h, w, 1, resized.data(), resize_h, resize_w);
    const float* cur = resized.data();
    h = resize_h;
    w = resize_w;

    int ci = 0, cj = 0, ch = h, cw = w;
    if (crop_h > 0 && crop_w > 0) {
        ci = crop_i; cj = crop_j; ch = crop_h; cw = crop_w;
        if (ci < 0 || cj < 0 || ci + ch > h || cj + cw > w) return 5;
    }
    for (int y = 0; y < ch; ++y)
        std::memcpy(out + (size_t)y * cw, cur + (size_t)(ci + y) * w + cj, sizeof(float) * cw);
    return 0;
}

static int load_metric_from(PngImage& img, float* out, int vrange_mode, int clamp01,
                            int square, int resize_h, int resize_w,
                            int crop_i, int crop_j, int crop_h, int crop_w) {
    if (img.channels != 1 || img.bit_depth != 16) return 4;
    return metric_from_u16(reinterpret_cast<const uint16_t*>(img.data.data()),
                           img.h, img.w, out, vrange_mode, clamp01, square,
                           resize_h, resize_w, crop_i, crop_j, crop_h, crop_w);
}

// 16-bit gray metric map. vrange_mode: 0 -> /65535 ([0,1]); 1 -> /32767-1 ([-1,1]).
// clamp01: clamp to [0,1] after decode; square: m = m*m (mse from mae).
int fi_load_metric(const char* path, float* out, int vrange_mode, int clamp01, int square,
                   int resize_h, int resize_w, int crop_i, int crop_j, int crop_h, int crop_w) {
    PngImage img;
    int rc = read_png(path, &img, /*want_16bit_gray=*/true);
    if (rc) return rc;
    return load_metric_from(img, out, vrange_mode, clamp01, square,
                            resize_h, resize_w, crop_i, crop_j, crop_h, crop_w);
}

int fi_load_metric_mem(const uint8_t* data, size_t len, float* out,
                       int vrange_mode, int clamp01, int square,
                       int resize_h, int resize_w,
                       int crop_i, int crop_j, int crop_h, int crop_w) {
    PngImage img;
    int rc = read_png_mem(data, len, &img, /*want_16bit_gray=*/true);
    if (rc) return rc;
    return load_metric_from(img, out, vrange_mode, clamp01, square,
                            resize_h, resize_w, crop_i, crop_j, crop_h, crop_w);
}

// ---- pre-decoded raw-tensor payloads (record shards, data/records.py) ----
//
// Payload layout (little-endian): "CSRT" magic, u8 version (1), u8 dtype
// (0 = uint8, 1 = uint16), u8 channels, u8 reserved, u32 h, u32 w, then the
// C-order tensor bytes. A training sample from a decoded shard costs a pread
// + this fused crop/normalise pass — no PNG inflate at all.

static int parse_raw_header(const uint8_t* data, size_t len,
                            int* h, int* w, int* channels, int* dtype) {
    if (len < 16 || std::memcmp(data, "CSRT", 4) != 0 || data[4] != 1) return 6;
    *dtype = data[5];
    *channels = data[6];
    uint32_t hh, ww;
    std::memcpy(&hh, data + 8, 4);
    std::memcpy(&ww, data + 12, 4);
    *h = (int)hh;
    *w = (int)ww;
    size_t elem = *dtype == 1 ? 2 : 1;
    if (16 + (size_t)hh * ww * *channels * elem > len) return 6;
    return 0;
}

int fi_raw_info(const uint8_t* data, size_t len,
                int* h, int* w, int* channels, int* bit_depth) {
    int dtype;
    int rc = parse_raw_header(data, len, h, w, channels, &dtype);
    if (rc) return rc;
    *bit_depth = dtype == 1 ? 16 : 8;
    return 0;
}

int fi_load_rgb_raw(const uint8_t* data, size_t len, float* out,
                    int resize_h, int resize_w,
                    int crop_i, int crop_j, int crop_h, int crop_w, int normalize) {
    int h, w, channels, dtype;
    int rc = parse_raw_header(data, len, &h, &w, &channels, &dtype);
    if (rc) return rc;
    if (channels != 3 || dtype != 0) return 4;
    return rgb_from_u8(data + 16, h, w, out, resize_h, resize_w,
                       crop_i, crop_j, crop_h, crop_w, normalize);
}

int fi_load_metric_raw(const uint8_t* data, size_t len, float* out,
                       int vrange_mode, int clamp01, int square,
                       int resize_h, int resize_w,
                       int crop_i, int crop_j, int crop_h, int crop_w) {
    int h, w, channels, dtype;
    int rc = parse_raw_header(data, len, &h, &w, &channels, &dtype);
    if (rc) return rc;
    if (channels != 1 || dtype != 1) return 4;
    return metric_from_u16(reinterpret_cast<const uint16_t*>(data + 16), h, w, out,
                           vrange_mode, clamp01, square,
                           resize_h, resize_w, crop_i, crop_j, crop_h, crop_w);
}

int fi_image_info_mem(const uint8_t* data, size_t len,
                      int* h, int* w, int* channels, int* bit_depth) {
    // header-only probe: decode just the IHDR via the mem reader
    MemSource src{data, len, 0};
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
    png_infop info = png_create_info_struct(png);
    if (!png || !info) return 2;
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        return 3;
    }
    png_set_read_fn(png, &src, mem_read_cb);
    png_read_info(png, info);
    *h = (int)png_get_image_height(png, info);
    *w = (int)png_get_image_width(png, info);
    *channels = (int)png_get_channels(png, info);
    *bit_depth = (int)png_get_bit_depth(png, info);
    png_destroy_read_struct(&png, &info, nullptr);
    return 0;
}

}  // extern "C"
