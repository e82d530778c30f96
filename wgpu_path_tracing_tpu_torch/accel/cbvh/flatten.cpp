// Native scene flattener: world transform + normal renormalization +
// corner gather in ONE pass over the index buffer.
//
// Twin of the NumPy flatten in models/gltf.py::flatten_corners (the
// reference's gpu.ts:247-274 transform loop, loaders.gl side). Must stay
// BIT-IDENTICAL to the NumPy path (tests/test_torch_native.py):
//   * positions: f64 row-vector times world^T plus translation, in the
//     k-ascending order BLAS dgemm uses for K=3, cast to f32 — or the raw
//     f32 vertex when the node matrix is the identity (models/gltf.py
//     takes the same shortcut);
//   * normals: f64 transform by the inverse-transpose, L2-normalized in
//     f64 (x*x + y*y + z*z summed ascending, sqrt, divide), cast to f32;
//     zero-length normals pass through (ln == 0 -> 1.0 divisor);
//   * gathers AFTER the f32 cast (cast commutes with gather).
// FMA contraction is disabled for these functions (and for the whole
// library by accel/native.py's -ffp-contract=off): the NumPy reference
// rounds every multiply and add separately.

#include <cmath>
#include <cstdint>

#if defined(__GNUC__) && !defined(__clang__)
#define WPT_NO_FMA __attribute__((optimize("fp-contract=off")))
#else
#define WPT_NO_FMA
#endif

extern "C" {

// pos / nrm: (n_verts, 3) f32. world: (4, 4) f64 row-major node-to-world.
// nmat: (3, 3) f64 row-major inverse-transpose (normal matrix).
// idx: (3 * n_tris,) i64 corner indices in (v0, v1, v2) triple order.
// identity: nonzero when world is the identity (skip the f64 round trip
// for positions, exactly like the Python fast path).
// Outputs v0, v1, v2, n0, n1, n2: (n_tris, 3) f32.
WPT_NO_FMA
int64_t wpt_flatten(const float* pos, const float* nrm, int64_t n_verts,
                    const double* world, const double* nmat,
                    const int64_t* idx, int64_t n_tris, int32_t identity,
                    float* v0, float* v1, float* v2,
                    float* n0, float* n1, float* n2) {
    float* vout[3] = {v0, v1, v2};
    float* nout[3] = {n0, n1, n2};
    for (int64_t t = 0; t < n_tris; ++t) {
        for (int c = 0; c < 3; ++c) {
            const int64_t vi = idx[3 * t + c];
            if (vi < 0 || vi >= n_verts) return -1;
            const float* p = pos + 3 * vi;
            float* ov = vout[c] + 3 * t;
            if (identity) {
                ov[0] = p[0];
                ov[1] = p[1];
                ov[2] = p[2];
            } else {
                const double px = (double)p[0], py = (double)p[1],
                             pz = (double)p[2];
                for (int r = 0; r < 3; ++r) {
                    // Row-vector times world^T: k-ascending accumulation,
                    // matching dgemm's K=3 microkernel order, then the
                    // separate broadcast add of the translation column.
                    double acc = px * world[4 * r + 0];
                    acc = acc + py * world[4 * r + 1];
                    acc = acc + pz * world[4 * r + 2];
                    acc = acc + world[4 * r + 3];
                    ov[r] = (float)acc;
                }
            }
            const float* q = nrm + 3 * vi;
            const double nx0 = (double)q[0], ny0 = (double)q[1],
                         nz0 = (double)q[2];
            double nx, ny, nz;
            if (identity) {
                nx = nx0; ny = ny0; nz = nz0;
            } else {
                nx = nx0 * nmat[0];
                nx = nx + ny0 * nmat[1];
                nx = nx + nz0 * nmat[2];
                ny = nx0 * nmat[3];
                ny = ny + ny0 * nmat[4];
                ny = ny + nz0 * nmat[5];
                nz = nx0 * nmat[6];
                nz = nz + ny0 * nmat[7];
                nz = nz + nz0 * nmat[8];
            }
            double sq = nx * nx;
            sq = sq + ny * ny;
            sq = sq + nz * nz;
            double ln = std::sqrt(sq);
            if (ln == 0.0) ln = 1.0;
            float* on = nout[c] + 3 * t;
            on[0] = (float)(nx / ln);
            on[1] = (float)(ny / ln);
            on[2] = (float)(nz / ln);
        }
    }
    return 0;
}

// Fused triangle-table reorder: one pass writing all six f32 (n, 3)
// columns plus the two f32 (n, 2) uv pairs and the i32 material column in
// BVH order. Twin of the reorder() gathers in models/assemble.py::
// finalize_scene (pure
// permutation — bit-identical trivially; fusing the nine NumPy
// fancy-index passes into one avoids re-walking the index array).
int64_t wpt_reorder_tris(const int64_t* order, int64_t n,
                         const float* v0i, const float* v1i, const float* v2i,
                         const float* n0i, const float* n1i, const float* n2i,
                         const float* u0i, const float* u1i, const float* u2i,
                         const int32_t* mi,
                         float* v0o, float* v1o, float* v2o,
                         float* n0o, float* n1o, float* n2o,
                         float* u0o, float* u1o, float* u2o, int32_t* mo) {
    for (int64_t t = 0; t < n; ++t) {
        const int64_t s = order[t];
        if (s < 0 || s >= n) return -1;
        for (int k = 0; k < 3; ++k) {
            v0o[3 * t + k] = v0i[3 * s + k];
            v1o[3 * t + k] = v1i[3 * s + k];
            v2o[3 * t + k] = v2i[3 * s + k];
            n0o[3 * t + k] = n0i[3 * s + k];
            n1o[3 * t + k] = n1i[3 * s + k];
            n2o[3 * t + k] = n2i[3 * s + k];
        }
        for (int k = 0; k < 2; ++k) {
            u0o[2 * t + k] = u0i[2 * s + k];
            u1o[2 * t + k] = u1i[2 * s + k];
            u2o[2 * t + k] = u2i[2 * s + k];
        }
        mo[t] = mi[s];
    }
    return 0;
}

}  // extern "C"
