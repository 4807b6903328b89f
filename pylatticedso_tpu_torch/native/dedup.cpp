// Native graph-builder kernels for the host geometry frontend.
//
// The lattice builder's hot path is row deduplication of millions of
// quantized node coordinates and edge pairs (design/lattice.py).  numpy's
// unique(axis=0) sorts void-views (O(N log N) with heavy constants); these
// open-addressing hash kernels are O(N) and ~20x faster at 50^3-lattice
// scale.  Exposed through ctypes (no pybind11 dependency).
//
// Build: g++ -O3 -march=native -shared -fPIC dedup.cpp -o libdedup.so

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

inline uint64_t mix(uint64_t x) {
    // splitmix64 finalizer
    x += 0x9e3779b97f4a7c15ULL;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
    return x ^ (x >> 31);
}

inline uint64_t hash3(const int64_t* row) {
    uint64_t h = mix((uint64_t)row[0]);
    h = mix(h ^ (uint64_t)row[1]);
    h = mix(h ^ (uint64_t)row[2]);
    return h;
}

inline uint64_t hash2(int64_t a, int64_t b) {
    return mix(mix((uint64_t)a) ^ (uint64_t)b);
}

}  // namespace

extern "C" {

// First-occurrence dedup of n int64 rows of width 3.
// out_inverse[i] = dense id (ordered by first occurrence) of row i.
// out_first[j]   = index of the first occurrence of dense id j.
// Returns the number of unique rows.
int64_t dedup_rows3(const int64_t* rows, int64_t n,
                    int64_t* out_inverse, int64_t* out_first) {
    uint64_t cap = 1;
    while (cap < (uint64_t)(n * 2 + 8)) cap <<= 1;
    const uint64_t mask = cap - 1;
    std::vector<int64_t> slot_id(cap, -1);

    int64_t n_unique = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t* r = rows + 3 * i;
        uint64_t h = hash3(r) & mask;
        for (;;) {
            int64_t s = slot_id[h];
            if (s < 0) {
                slot_id[h] = n_unique;
                out_first[n_unique] = i;
                out_inverse[i] = n_unique;
                ++n_unique;
                break;
            }
            const int64_t* q = rows + 3 * out_first[s];
            if (q[0] == r[0] && q[1] == r[1] && q[2] == r[2]) {
                out_inverse[i] = s;
                break;
            }
            h = (h + 1) & mask;
        }
    }
    return n_unique;
}

// First-occurrence dedup of unordered int64 pairs (a, b).
int64_t dedup_pairs(const int64_t* a, const int64_t* b, int64_t n,
                    int64_t* out_inverse, int64_t* out_first) {
    uint64_t cap = 1;
    while (cap < (uint64_t)(n * 2 + 8)) cap <<= 1;
    const uint64_t mask = cap - 1;
    std::vector<int64_t> slot_id(cap, -1);

    int64_t n_unique = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t lo = a[i] < b[i] ? a[i] : b[i];
        int64_t hi = a[i] < b[i] ? b[i] : a[i];
        uint64_t h = hash2(lo, hi) & mask;
        for (;;) {
            int64_t s = slot_id[h];
            if (s < 0) {
                slot_id[h] = n_unique;
                out_first[n_unique] = i;
                out_inverse[i] = n_unique;
                ++n_unique;
                break;
            }
            int64_t j = out_first[s];
            int64_t jlo = a[j] < b[j] ? a[j] : b[j];
            int64_t jhi = a[j] < b[j] ? b[j] : a[j];
            if (jlo == lo && jhi == hi) {
                out_inverse[i] = s;
                break;
            }
            h = (h + 1) & mask;
        }
    }
    return n_unique;
}

// Dedup of int64 pairs treated as ORDERED (for (cell, edge) membership).
int64_t dedup_pairs_ordered(const int64_t* a, const int64_t* b, int64_t n,
                            int64_t* out_inverse, int64_t* out_first) {
    uint64_t cap = 1;
    while (cap < (uint64_t)(n * 2 + 8)) cap <<= 1;
    const uint64_t mask = cap - 1;
    std::vector<int64_t> slot_id(cap, -1);

    int64_t n_unique = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t h = hash2(a[i], b[i]) & mask;
        for (;;) {
            int64_t s = slot_id[h];
            if (s < 0) {
                slot_id[h] = n_unique;
                out_first[n_unique] = i;
                out_inverse[i] = n_unique;
                ++n_unique;
                break;
            }
            int64_t j = out_first[s];
            if (a[j] == a[i] && b[j] == b[i]) {
                out_inverse[i] = s;
                break;
            }
            h = (h + 1) & mask;
        }
    }
    return n_unique;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused geometry replication: world endpoints + quantized int keys in one
// pass (replaces the numpy broadcast + round + astype chain, which is
// memory-bandwidth-bound on constrained hosts).
//
// templates: [m, 6] fractional beams; origin/size: [C, 3];
// out_pts: [(C*m*2), 3] float64 (interleaved p1, p2);
// out_keys: [(C*m*2), 3] int64 = llround(coord * 1e9).
extern "C" void replicate_cells(const double* tpl, int64_t m,
                                const double* origin, const double* size,
                                int64_t C, double* out_pts, int64_t* out_keys) {
    for (int64_t c = 0; c < C; ++c) {
        const double ox = origin[3 * c], oy = origin[3 * c + 1], oz = origin[3 * c + 2];
        const double sx = size[3 * c], sy = size[3 * c + 1], sz = size[3 * c + 2];
        double* P = out_pts + c * m * 6;
        int64_t* K = out_keys + c * m * 6;
        for (int64_t b = 0; b < m; ++b) {
            const double* t = tpl + 6 * b;
            const double v[6] = {
                ox + t[0] * sx, oy + t[1] * sy, oz + t[2] * sz,
                ox + t[3] * sx, oy + t[4] * sy, oz + t[5] * sz,
            };
            for (int k = 0; k < 6; ++k) {
                P[6 * b + k] = v[k];
                K[6 * b + k] = llround(v[k] * 1e9);
            }
        }
    }
}

// Lexicographic argsort of int64 rows of width w (used for the
// deterministic node/edge orderings; plain std::sort beats numpy's
// multi-pass lexsort on bandwidth-starved hosts).
#include <algorithm>
#include <numeric>

extern "C" void argsort_rows(const int64_t* rows, int64_t n, int64_t w,
                             int64_t* out_order) {
    std::iota(out_order, out_order + n, (int64_t)0);
    std::sort(out_order, out_order + n, [rows, w](int64_t a, int64_t b) {
        const int64_t* ra = rows + w * a;
        const int64_t* rb = rows + w * b;
        for (int64_t k = 0; k < w; ++k) {
            if (ra[k] != rb[k]) return ra[k] < rb[k];
        }
        return a < b;
    });
}

// Multi-template replication in (cell, geometry, beam) creation order:
// tpl: concatenated [M_total, 6] rows of all geometry templates;
// offsets: [G+1] template row offsets; per cell, all templates are emitted
// consecutively — matching the reference's generation order so
// first-occurrence dedup semantics follow (cell.py:261-290).
extern "C" void replicate_cells_multi(const double* tpl, const int64_t* offsets,
                                      int64_t G, const double* origin,
                                      const double* size, int64_t C,
                                      double* out_pts, int64_t* out_keys) {
    const int64_t M = offsets[G];
    for (int64_t c = 0; c < C; ++c) {
        const double o[3] = {origin[3 * c], origin[3 * c + 1], origin[3 * c + 2]};
        const double s[3] = {size[3 * c], size[3 * c + 1], size[3 * c + 2]};
        double* P = out_pts + c * M * 6;
        int64_t* K = out_keys + c * M * 6;
        for (int64_t b = 0; b < M; ++b) {
            const double* t = tpl + 6 * b;
            for (int k = 0; k < 6; ++k) {
                const double v = o[k % 3] + t[k] * s[k % 3];
                P[6 * b + k] = v;
                K[6 * b + k] = llround(v * 1e9);
            }
        }
    }
}

// Float64 variant of the lexicographic argsort (node/edge deterministic
// orderings compare stored coordinates exactly like the reference's tuple
// sorts, lattice.py:665-698).
extern "C" void argsort_rows_f64(const double* rows, int64_t n, int64_t w,
                                 int64_t* out_order) {
    std::iota(out_order, out_order + n, (int64_t)0);
    std::sort(out_order, out_order + n, [rows, w](int64_t a, int64_t b) {
        const double* ra = rows + w * a;
        const double* rb = rows + w * b;
        for (int64_t k = 0; k < w; ++k) {
            if (ra[k] != rb[k]) return ra[k] < rb[k];
        }
        return a < b;
    });
}
