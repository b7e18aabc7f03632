// Host rasterizer for top-down (BEV) map textures.
//
// Replaces the reference's pygame map rasterization
// (metadrive/obs/top_down_obs_impl.py + top_down_obs.py:22): per-scenario
// map layers (drivable area, lane lines, route) are baked once on the host
// when the env is built; the per-step ego-centric crop, rotation and
// vehicle stamping run on the device in torch (obs/top_down.py).
//
// Build (core/cuda_build.py::host_library): g++ -O3 -shared -fPIC
// Interface: plain C, loaded with ctypes.
#include <cmath>
#include <cstdint>
#include <algorithm>

extern "C" {

// Stamp thick polylines (capsule strokes) into a H x W float grid.
//   grid      : H*W floats, row-major; grid[y*W + x]
//   origin_x/y: world coordinates of pixel (0, 0) center
//   res       : meters per pixel
//   pts       : n_pts * 2 floats (world x, y), concatenated polylines
//   starts    : n_polys+1 ints; polyline i spans pts[starts[i]:starts[i+1]]
//   widths    : n_polys floats, full stroke width in meters
//   value     : value written on covered pixels (max-combined)
void rasterize_polylines(
    float* grid, int H, int W, float origin_x, float origin_y, float res,
    const float* pts, const int* starts, int n_polys,
    const float* widths, float value)
{
    for (int p = 0; p < n_polys; ++p) {
        const float half = widths[p] * 0.5f;
        const float half_px = half / res;
        for (int i = starts[p]; i + 1 < starts[p + 1]; ++i) {
            const float ax = (pts[2 * i] - origin_x) / res;
            const float ay = (pts[2 * i + 1] - origin_y) / res;
            const float bx = (pts[2 * i + 2] - origin_x) / res;
            const float by = (pts[2 * i + 3] - origin_y) / res;
            const int x0 = std::max(0, (int)std::floor(std::min(ax, bx) - half_px - 1));
            const int x1 = std::min(W - 1, (int)std::ceil(std::max(ax, bx) + half_px + 1));
            const int y0 = std::max(0, (int)std::floor(std::min(ay, by) - half_px - 1));
            const int y1 = std::min(H - 1, (int)std::ceil(std::max(ay, by) + half_px + 1));
            const float dx = bx - ax, dy = by - ay;
            const float len2 = dx * dx + dy * dy;
            for (int y = y0; y <= y1; ++y) {
                for (int x = x0; x <= x1; ++x) {
                    const float rx = (float)x - ax, ry = (float)y - ay;
                    float t = len2 > 1e-9f ? (rx * dx + ry * dy) / len2 : 0.0f;
                    t = std::max(0.0f, std::min(1.0f, t));
                    const float px = rx - t * dx, py = ry - t * dy;
                    if (px * px + py * py <= half_px * half_px) {
                        float& g = grid[y * W + x];
                        g = std::max(g, value);
                    }
                }
            }
        }
    }
}

// Fill convex/simple polygons (even-odd scanline) into the grid.
//   polys: n_pts * 2 floats; starts as above.
void rasterize_polygons(
    float* grid, int H, int W, float origin_x, float origin_y, float res,
    const float* pts, const int* starts, int n_polys, float value)
{
    for (int p = 0; p < n_polys; ++p) {
        const int s = starts[p], e = starts[p + 1];
        const int n = e - s;
        if (n < 3) continue;
        float ymin = 1e30f, ymax = -1e30f;
        for (int i = s; i < e; ++i) {
            const float py = (pts[2 * i + 1] - origin_y) / res;
            ymin = std::min(ymin, py);
            ymax = std::max(ymax, py);
        }
        const int y0 = std::max(0, (int)std::floor(ymin));
        const int y1 = std::min(H - 1, (int)std::ceil(ymax));
        for (int y = y0; y <= y1; ++y) {
            const float yc = (float)y;
            // gather intersections of scanline with polygon edges
            float xs[256];
            int nx = 0;
            for (int i = 0; i < n && nx < 256; ++i) {
                const int j = (i + 1) % n;
                const float ax = (pts[2 * (s + i)] - origin_x) / res;
                const float ay = (pts[2 * (s + i) + 1] - origin_y) / res;
                const float bx = (pts[2 * (s + j)] - origin_x) / res;
                const float by = (pts[2 * (s + j) + 1] - origin_y) / res;
                if ((ay <= yc && by > yc) || (by <= yc && ay > yc)) {
                    const float t = (yc - ay) / (by - ay);
                    xs[nx++] = ax + t * (bx - ax);
                }
            }
            std::sort(xs, xs + nx);
            for (int k = 0; k + 1 < nx; k += 2) {
                const int xa = std::max(0, (int)std::ceil(xs[k]));
                const int xb = std::min(W - 1, (int)std::floor(xs[k + 1]));
                for (int x = xa; x <= xb; ++x) {
                    float& g = grid[y * W + x];
                    g = std::max(g, value);
                }
            }
        }
    }
}

}  // extern "C"
