// Native twin of the texture-atlas bin packer (models/potpack.py::
// potpack_python, the mapbox/potpack algorithm the reference consumes as an
// npm dep, atlas.ts:60). Must stay BIT-IDENTICAL to the Python packer
// (tests/test_torch_native.py): same height-descending stable order,
// same last-to-first free-space scan, same split rules. All arithmetic is
// f64 — Python's float IS f64, and the integer-dim call sites (the fat
// atlas's LCM grids, models/types.py) stay exact because every value is
// far below 2^53. The area sum adds each w*h product rounded on its own,
// as Python does for float dims (the library is built with
// -ffp-contract=off, so no multiply-add is fused). Caveat on `area`: Python
// sums exact ints and rounds once at area/0.95, while this loop rounds per
// multiply/add in f64 — identical only while the SUM of w*h products (not
// just each value) stays exactly representable, i.e. total area < 2^53
// texels. FAT_ATLAS_MAX_TEXELS caps
// call sites orders of magnitude below that; if the LCM path ever grows
// unbounded before that check, switch this to Kahan/long-double summation.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// wh: (n, 2) f64 box (w, h) pairs in list order. xy out: (n, 2) f64 box
// (x, y) positions (zeros for boxes no free space fits, matching the
// Python boxes' untouched initial x/y). out_dims: (2,) f64 (width, height).
int64_t wpt_potpack(const double* wh, int64_t n, double* xy,
                    double* out_dims) {
    double area = 0.0;
    for (int64_t i = 0; i < n; ++i) area += wh[2 * i] * wh[2 * i + 1];
    double max_width = 0.0;  // Python: max(..., default=0)
    for (int64_t i = 0; i < n; ++i) max_width = std::max(max_width, wh[2 * i]);

    // sorted(range(n), key=-h): height-descending, ties in list order.
    std::vector<int64_t> order(n);
    for (int64_t i = 0; i < n; ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        return wh[2 * a + 1] > wh[2 * b + 1];
    });

    double start_width = std::ceil(std::sqrt(area / 0.95));
    if (max_width > start_width) start_width = max_width;

    struct Space {
        double x, y, w, h;
    };
    std::vector<Space> spaces;
    spaces.push_back(
        {0.0, 0.0, start_width, std::numeric_limits<double>::infinity()});

    double width = 0.0, height = 0.0;
    for (int64_t oi = 0; oi < n; ++oi) {
        const int64_t bi = order[oi];
        const double bw = wh[2 * bi], bh = wh[2 * bi + 1];
        double bx = 0.0, by = 0.0;
        for (int64_t i = (int64_t)spaces.size() - 1; i >= 0; --i) {
            Space& sp = spaces[i];
            if (bw > sp.w || bh > sp.h) continue;
            bx = sp.x;
            by = sp.y;
            if (by + bh > height) height = by + bh;
            if (bx + bw > width) width = bx + bw;
            if (bw == sp.w && bh == sp.h) {
                // spaces[i] = spaces[-1]; spaces.pop() — fine when i is last.
                spaces[i] = spaces.back();
                spaces.pop_back();
            } else if (bh == sp.h) {
                sp.x += bw;
                sp.w -= bw;
            } else if (bw == sp.w) {
                sp.y += bh;
                sp.h -= bh;
            } else {
                // Python appends the right-remainder THEN shrinks the
                // original; push_back may reallocate, so stage the new
                // space before touching the vector.
                Space ns{sp.x + bw, sp.y, sp.w - bw, bh};
                sp.y += bh;
                sp.h -= bh;
                spaces.push_back(ns);
            }
            break;
        }
        xy[2 * bi] = bx;
        xy[2 * bi + 1] = by;
    }
    out_dims[0] = width;
    out_dims[1] = height;
    return 0;
}

}  // extern "C"
