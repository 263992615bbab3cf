/* Native data-plane kernels for the host loader hot path.
 *
 * The reference's DataLoader re-pads every character cell in Python inside
 * 10 worker processes (reference scripts/dataset.py:71-92
 * character_padding_forinput + utils/tools.py:617-635 pad_2D_gray_image).
 * Here the equivalent work — slicing a glyph strip into per-character
 * cells, centering each on a white background (extra pixel on the LEFT),
 * and emitting normalized float32 straight into the batch tensor — is one
 * C pass per clip, called through ctypes from data/dataset.py; the DTW
 * recursion of the DTW-MCD metric runs here too (metrics.py).
 *
 * Copy of visual_onoma_to_wave_tpu/native/datakernels.c. Build:
 * cc -O2 -shared -fPIC datakernels.c -o libdatakernels.so (done on demand by
 * data/native.py; pure C99, no dependencies).
 */
#include <stdint.h>
#include <string.h>

/* Slice img (H x W, row-major uint8) into n cells of cell_width, each
 * character (widths[i] px) centered with ceil-left padding, written as
 * normalized float32 into out (n x H x cell_width, prefilled by caller or
 * overwritten fully here with background 1.0f). Returns 0 on success. */
int fill_cells_f32(const uint8_t *img, int64_t height, int64_t width,
                   const int64_t *widths, int64_t n, int64_t cell_width,
                   float *out) {
    int64_t x = 0;
    const float inv = 1.0f / 255.0f;
    for (int64_t i = 0; i < n; i++) {
        int64_t w = widths[i];
        int64_t w_req = w > cell_width ? cell_width : w;       /* defensive */
        int64_t copy_w = w_req;
        if (x + copy_w > width) copy_w = width > x ? width - x : 0;
        /* left offset from the requested (pre-image-clip) width, matching
         * the Python fallback pad_character_cells in data/dataset.py */
        int64_t pad = cell_width - w_req;
        int64_t left = pad / 2 + (pad & 1);                    /* ceil-left */
        float *cell = out + i * height * cell_width;
        for (int64_t r = 0; r < height; r++) {
            float *row = cell + r * cell_width;
            const uint8_t *src = img + r * width + x;
            int64_t c = 0;
            for (; c < left; c++) row[c] = 1.0f;
            for (int64_t k = 0; k < copy_w; k++) row[c++] = src[k] * inv;
            for (; c < cell_width; c++) row[c] = 1.0f;
        }
        x += w;
    }
    return 0;
}

/* uint8 variant preserving the reference's artifact dtype (255 background),
 * for code paths that keep cells as uint8. */
int pad_cells_u8(const uint8_t *img, int64_t height, int64_t width,
                 const int64_t *widths, int64_t n, int64_t cell_width,
                 uint8_t *out) {
    int64_t x = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t w = widths[i];
        int64_t w_req = w > cell_width ? cell_width : w;
        int64_t copy_w = w_req;
        if (x + copy_w > width) copy_w = width > x ? width - x : 0;
        int64_t pad = cell_width - w_req;          /* pre-image-clip width */
        int64_t left = pad / 2 + (pad & 1);
        uint8_t *cell = out + i * height * cell_width;
        for (int64_t r = 0; r < height; r++) {
            uint8_t *row = cell + r * cell_width;
            memset(row, 255, (size_t)cell_width);
            memcpy(row + left, img + r * width + x, (size_t)copy_w);
        }
        x += w;
    }
    return 0;
}

/* DTW accumulation for the quality metrics (metrics.py mcd_dtw): fill the
 * (t1+1) x (t2+1) accumulated-cost table over moves (1,0),(0,1),(1,1) and
 * emit the backtracked path. cost is t1 x t2 row-major float64; acc is
 * caller-allocated (t1+1)*(t2+1) float64 scratch; path_i/path_j are
 * caller-allocated int64 buffers of capacity t1+t2 (the maximal path
 * length); the path is written FRONT-ALIGNED in forward order and its
 * length returned. Returns -1 on degenerate sizes.
 *
 * Python fallback: metrics.dtw_path (same DP, same tie-breaking: on equal
 * accumulated costs prefer diagonal, then up, then left). */
int64_t dtw_path_f64(const double *cost, int64_t t1, int64_t t2,
                     double *acc, int64_t *path_i, int64_t *path_j) {
    if (t1 <= 0 || t2 <= 0) return -1;
    const int64_t stride = t2 + 1;
    const double inf = 1.0 / 0.0;
    for (int64_t j = 0; j <= t2; j++) acc[j] = inf;
    acc[0] = 0.0;
    for (int64_t i = 1; i <= t1; i++) {
        const double *prev = acc + (i - 1) * stride;
        double *cur = acc + i * stride;
        const double *row = cost + (i - 1) * t2;
        cur[0] = inf;
        for (int64_t j = 1; j <= t2; j++) {
            double m = prev[j - 1];              /* diagonal preferred */
            if (prev[j] < m) m = prev[j];
            if (cur[j - 1] < m) m = cur[j - 1];
            cur[j] = row[j - 1] + m;
        }
    }
    /* backtrack (reverse order), then reverse in place */
    int64_t i = t1, j = t2, k = 0;
    while (i > 0 && j > 0) {
        path_i[k] = i - 1;
        path_j[k] = j - 1;
        k++;
        const double d = acc[(i - 1) * stride + (j - 1)];
        const double u = acc[(i - 1) * stride + j];
        const double l = acc[i * stride + (j - 1)];
        if (d <= u && d <= l) { i--; j--; }
        else if (u <= l) { i--; }
        else { j--; }
    }
    for (int64_t a = 0, b = k - 1; a < b; a++, b--) {
        int64_t ti = path_i[a]; path_i[a] = path_i[b]; path_i[b] = ti;
        int64_t tj = path_j[a]; path_j[a] = path_j[b]; path_j[b] = tj;
    }
    return k;
}
