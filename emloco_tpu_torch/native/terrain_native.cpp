// Native host-side terrain pipeline.
//
// TPU-native counterpart of the reference's C++ runtime components: where
// Isaac Gym does terrain/asset preparation inside its closed .so (heightfield
// -> trimesh -> PhysX cooking), here the compiled-for-TPU sim consumes the
// heightfield directly and the expensive *host-side* setup work (walkable-mask
// erosion over large maps, spawn-table extraction, tile stamping) runs in C++.
// Exposed over a plain C ABI for ctypes (no pybind11 dependency).
//
// Build: emloco_tpu/native/build.py (g++ -O3 -shared -fPIC).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

extern "C" {

// Walkable mask: slope threshold + box erosion by `margin` cells.
// heights: H*W row-major; out: H*W uint8 (1 = walkable).
// (semantics of the reference's walkable_field_raw + binary dilation,
//  humanoid_pedestrain_terrain.py:1196-1210)
void walkable_mask(const float* heights, int H, int W, float cell,
                   float max_slope, int margin, uint8_t* out) {
    std::vector<uint8_t> bad(static_cast<size_t>(H) * W, 0);
    for (int i = 0; i < H; ++i) {
        for (int j = 0; j < W; ++j) {
            int i0 = i > 0 ? i - 1 : i, i1 = i < H - 1 ? i + 1 : i;
            int j0 = j > 0 ? j - 1 : j, j1 = j < W - 1 ? j + 1 : j;
            float gx = (heights[i1 * W + j] - heights[i0 * W + j]) /
                       (cell * (i1 - i0 > 0 ? (i1 - i0) : 1));
            float gy = (heights[i * W + j1] - heights[i * W + j0]) /
                       (cell * (j1 - j0 > 0 ? (j1 - j0) : 1));
            bad[i * W + j] =
                (std::fabs(gx) >= max_slope || std::fabs(gy) >= max_slope);
        }
    }
    // separable box dilation of `bad` by margin (rows then cols)
    std::vector<uint8_t> tmp(static_cast<size_t>(H) * W, 0);
    for (int i = 0; i < H; ++i) {
        int run = 0;
        for (int j = 0; j < W; ++j) {  // forward pass with sliding window
            if (bad[i * W + j]) run = margin + 1;
            tmp[i * W + j] = run > 0;
            if (run > 0) --run;
        }
        run = 0;
        for (int j = W - 1; j >= 0; --j) {
            if (bad[i * W + j]) run = margin + 1;
            if (run > 0) { tmp[i * W + j] = 1; --run; }
        }
    }
    for (int j = 0; j < W; ++j) {
        int run = 0;
        for (int i = 0; i < H; ++i) {
            if (tmp[i * W + j]) run = margin + 1;
            out[i * W + j] = run > 0 ? 0 : 1;
            if (run > 0) --run;
        }
        run = 0;
        for (int i = H - 1; i >= 0; --i) {
            if (tmp[i * W + j]) run = margin + 1;
            if (run > 0) { out[i * W + j] = 0; --run; }
        }
    }
    // a margin-wide border strip is never walkable (matches padding the bad
    // mask with `true` outside the map)
    for (int i = 0; i < H; ++i)
        for (int j = 0; j < W; ++j)
            if (i < margin || j < margin || i >= H - margin || j >= W - margin)
                out[i * W + j] = 0;
}

// Extract up to max_pts (x, y) world coordinates of walkable cells,
// uniformly subsampled with a deterministic LCG.
int spawn_table(const uint8_t* mask, int H, int W, float cell,
                float origin_x, float origin_y, uint64_t seed,
                int max_pts, float* out_xy) {
    std::vector<int64_t> idx;
    idx.reserve(1 << 16);
    for (int64_t k = 0; k < static_cast<int64_t>(H) * W; ++k)
        if (mask[k]) idx.push_back(k);
    if (idx.empty()) return 0;
    std::mt19937_64 rng(seed);
    int n = static_cast<int>(idx.size());
    int take = n < max_pts ? n : max_pts;
    // partial Fisher-Yates for the first `take`
    for (int i = 0; i < take; ++i) {
        int j = i + static_cast<int>(rng() % (n - i));
        std::swap(idx[i], idx[j]);
        int64_t k = idx[i];
        out_xy[2 * i] = static_cast<float>(k / W) * cell + origin_x;
        out_xy[2 * i + 1] = static_cast<float>(k % W) * cell + origin_y;
    }
    return take;
}

// Stamp a tile of procedural terrain into a larger map (stairs / slope /
// random-uniform / obstacles), C++ for big-map generation speed.
// kind: 0=random_uniform 1=slope 2=pyramid 3=stairs 4=obstacles
void stamp_tile(float* map, int H, int W, int x0, int y0, int h, int w,
                int kind, float p0, float p1, uint64_t seed) {
    std::mt19937_64 rng(seed);
    std::uniform_real_distribution<float> uni(0.f, 1.f);
    switch (kind) {
        case 0: {  // random uniform steps in [p0, p1]
            float step = 0.025f;
            int levels = static_cast<int>((p1 - p0) / step) + 1;
            for (int i = 0; i < h; ++i)
                for (int j = 0; j < w; ++j)
                    map[(x0 + i) * W + (y0 + j)] =
                        p0 + step * static_cast<float>(rng() % levels);
            break;
        }
        case 1: {  // slope p0 per cell along x
            for (int i = 0; i < h; ++i)
                for (int j = 0; j < w; ++j)
                    map[(x0 + i) * W + (y0 + j)] = p0 * i;
            break;
        }
        case 2: {  // pyramid slope
            for (int i = 0; i < h; ++i)
                for (int j = 0; j < w; ++j) {
                    int d = std::min(std::min(i, h - 1 - i),
                                     std::min(j, w - 1 - j));
                    map[(x0 + i) * W + (y0 + j)] = p0 * d;
                }
            break;
        }
        case 3: {  // stairs: step width p0 cells, height p1
            int sw = p0 > 1 ? static_cast<int>(p0) : 1;
            for (int i = 0; i < h; ++i)
                for (int j = 0; j < w; ++j)
                    map[(x0 + i) * W + (y0 + j)] = p1 * (i / sw);
            break;
        }
        case 4: {  // discrete obstacles, 24 rects of height ±p1
            for (int r = 0; r < 24; ++r) {
                int rw = 4 + static_cast<int>(rng() % 12);
                int rh = 4 + static_cast<int>(rng() % 12);
                int ri = static_cast<int>(rng() % (h > rh ? h - rh : 1));
                int rj = static_cast<int>(rng() % (w > rw ? w - rw : 1));
                float v = (uni(rng) < 0.5f ? -1.f : 1.f) *
                          p1 * (0.5f + 0.5f * uni(rng));
                for (int i = 0; i < rh; ++i)
                    for (int j = 0; j < rw; ++j)
                        map[(x0 + ri + i) * W + (y0 + rj + j)] = v;
            }
            break;
        }
    }
}

// Rasterize a triangle mesh onto a heightfield grid: for every cell center
// covered by a triangle, keep the maximum surface z (top surface of the
// scan). cover[i*W+j]=1 marks cells hit by at least one triangle.
// (TPU-native counterpart of the reference MeshTerrain real-scan ground,
//  humanoid_pedestrain_terrain.py:996-1133 — heights are pre-sampled on the
//  host instead of ray-cast against the mesh inside PhysX.)
void rasterize_trimesh(const float* verts, int n_verts,
                       const int32_t* faces, int n_faces,
                       int H, int W, float cell, float origin_x,
                       float origin_y, float* out_h, uint8_t* cover) {
    (void)n_verts;
    for (int64_t k = 0; k < static_cast<int64_t>(H) * W; ++k) {
        out_h[k] = -1e30f;
        cover[k] = 0;
    }
    for (int f = 0; f < n_faces; ++f) {
        const float* a = verts + 3 * faces[3 * f];
        const float* b = verts + 3 * faces[3 * f + 1];
        const float* c = verts + 3 * faces[3 * f + 2];
        float minx = std::fmin(a[0], std::fmin(b[0], c[0]));
        float maxx = std::fmax(a[0], std::fmax(b[0], c[0]));
        float miny = std::fmin(a[1], std::fmin(b[1], c[1]));
        float maxy = std::fmax(a[1], std::fmax(b[1], c[1]));
        int i0 = static_cast<int>(std::floor((minx - origin_x) / cell));
        int i1 = static_cast<int>(std::ceil((maxx - origin_x) / cell));
        int j0 = static_cast<int>(std::floor((miny - origin_y) / cell));
        int j1 = static_cast<int>(std::ceil((maxy - origin_y) / cell));
        i0 = i0 < 0 ? 0 : i0; j0 = j0 < 0 ? 0 : j0;
        i1 = i1 >= H ? H - 1 : i1; j1 = j1 >= W ? W - 1 : j1;
        float d = (b[1] - c[1]) * (a[0] - c[0]) + (c[0] - b[0]) * (a[1] - c[1]);
        if (std::fabs(d) < 1e-12f) continue;  // degenerate in plan view
        float inv_d = 1.0f / d;
        for (int i = i0; i <= i1; ++i) {
            float px = origin_x + i * cell;
            for (int j = j0; j <= j1; ++j) {
                float py = origin_y + j * cell;
                float w0 = ((b[1] - c[1]) * (px - c[0]) +
                            (c[0] - b[0]) * (py - c[1])) * inv_d;
                float w1 = ((c[1] - a[1]) * (px - c[0]) +
                            (a[0] - c[0]) * (py - c[1])) * inv_d;
                float w2 = 1.0f - w0 - w1;
                const float eps = -1e-5f;
                if (w0 < eps || w1 < eps || w2 < eps) continue;
                float z = w0 * a[2] + w1 * b[2] + w2 * c[2];
                int64_t k = static_cast<int64_t>(i) * W + j;
                if (z > out_h[k]) out_h[k] = z;
                cover[k] = 1;
            }
        }
    }
}

}  // extern "C"
