// Host kernel of LIF data generation: grid-hash kNN sign-voting SDF.
//
// The k nearest oriented surfels of a query vote sign(dot(n_i, q - p_i));
// a unanimous vote gives +/- the distance to the nearest surfel, a split
// vote discards the query (the semantics of the reference sampler's
// ComputeSDFKernel).  The same source as the JAX package's native sampler,
// built with the same flags, so both give the same bits.
//
// Structure: a density-corrected FINE uniform grid (~4 surfels/occupied
// cell; surfels are reordered so each cell's points are contiguous), plus
// a 6^3-nested COARSE view of the same grid.  The query mix is bimodal:
// ~75% are surface-perturbed (answered by a fine ring search capped at a
// few rings), ~25% are bbox-uniform and sit many cells from the thin
// surface — those ring-expand on the coarse level (64x fewer empty-cell
// probes) and, inside each occupied coarse cell, prune nested fine cells
// by their box distance against the running kth bound, so tangentially
// grazing a large surface scans a band one FINE cell thick instead of one
// coarse cell thick.
//
// Exposed via a plain C ABI for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int kCoarse = 6;      // fine cells per coarse cell, per axis

struct Grid {
    double origin[3];
    double cell;                 // fine cell size
    int dims[3];                 // fine dims
    int cdims[3];                // coarse dims (ceil(dims / kCoarse))
    std::vector<int> cell_start; // fine CSR offsets
    std::vector<int> ccount;     // surfels per coarse cell
    std::vector<double> pts;     // (m,3) surfels reordered by fine cell
    std::vector<double> nrm;     // (m,3) normals, same order
};

inline int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

void fill_grid(Grid& g, const double* pts, const double* nrm, int m,
               const double* mn, const double* mx) {
    for (int d = 0; d < 3; ++d) {
        g.origin[d] = mn[d];
        g.dims[d] = std::max(1, (int)std::floor((mx[d] - mn[d]) / g.cell) + 1);
        g.dims[d] = std::min(g.dims[d], 768);
    }
    // recompute cell so the clamped dims still cover the extent
    for (int d = 0; d < 3; ++d)
        g.cell = std::max(g.cell, (mx[d] - mn[d]) / g.dims[d] + 1e-12);
    for (int d = 0; d < 3; ++d)
        g.cdims[d] = (g.dims[d] + kCoarse - 1) / kCoarse;

    int n_cells = g.dims[0] * g.dims[1] * g.dims[2];
    std::vector<int> count(n_cells, 0);
    std::vector<int> cell_of(m);
    std::vector<int> ccell_of(m);
    for (int i = 0; i < m; ++i) {
        int c[3];
        for (int d = 0; d < 3; ++d)
            c[d] = clampi((int)((pts[3 * i + d] - g.origin[d]) / g.cell), 0,
                          g.dims[d] - 1);
        cell_of[i] = (c[0] * g.dims[1] + c[1]) * g.dims[2] + c[2];
        ccell_of[i] = ((c[0] / kCoarse) * g.cdims[1] + c[1] / kCoarse)
                      * g.cdims[2] + c[2] / kCoarse;
        count[cell_of[i]]++;
    }
    g.cell_start.assign(n_cells + 1, 0);
    for (int c = 0; c < n_cells; ++c)
        g.cell_start[c + 1] = g.cell_start[c] + count[c];
    g.ccount.assign(g.cdims[0] * g.cdims[1] * g.cdims[2], 0);
    // reorder surfels into cell order: contiguous per-cell scans, no
    // indirection (hardware prefetch works)
    g.pts.resize(3 * m);
    g.nrm.resize(3 * m);
    std::vector<int> cursor(g.cell_start.begin(), g.cell_start.end() - 1);
    for (int i = 0; i < m; ++i) {
        int dst = cursor[cell_of[i]]++;
        for (int d = 0; d < 3; ++d) {
            g.pts[3 * dst + d] = pts[3 * i + d];
            g.nrm[3 * dst + d] = nrm[3 * i + d];
        }
        g.ccount[ccell_of[i]]++;
    }
}

Grid build_grid(const double* pts, const double* nrm, int m) {
    double mn[3], mx[3];
    for (int d = 0; d < 3; ++d) { mn[d] = pts[d]; mx[d] = pts[d]; }
    for (int i = 1; i < m; ++i)
        for (int d = 0; d < 3; ++d) {
            mn[d] = std::min(mn[d], pts[3 * i + d]);
            mx[d] = std::max(mx[d], pts[3 * i + d]);
        }
    Grid g;
    double vol = 1.0;
    for (int d = 0; d < 3; ++d) vol *= std::max(mx[d] - mn[d], 1e-9);
    // First guess: ~4 surfels per cell IF the distribution filled the
    // volume.  Surfels lie on a 2-D surface, so this systematically
    // oversizes cells (measured ~56 surfels per OCCUPIED cell on the
    // simple-shape meshes).  A second pass rescales by the measured
    // occupancy: for a 2-D set, occupied-cell count ~ 1/cell^2, so
    // cell *= sqrt(target / measured) lands near the target density.
    g.cell = std::cbrt(vol * 4.0 / std::max(m, 1));
    if (!(g.cell > 0)) g.cell = 1e-3;
    fill_grid(g, pts, nrm, m, mn, mx);
    int n_cells = g.dims[0] * g.dims[1] * g.dims[2];
    int occupied = 0;
    for (int c = 0; c < n_cells; ++c)
        occupied += (g.cell_start[c + 1] > g.cell_start[c]);
    double density = (double)m / std::max(occupied, 1);
    if (density > 8.0) {
        g.cell *= std::sqrt(4.0 / density);
        fill_grid(g, pts, nrm, m, mn, mx);
    }
    return g;
}

struct KnnState {
    std::vector<std::pair<double, int>> found;  // (dist2, id), unordered
    double kth = 1e300;                         // worst kept dist2
    int k = 11;

    void reset() { found.clear(); kth = 1e300; }

    inline void offer(double d2, int pi) {
        if ((int)found.size() < k) {
            found.emplace_back(d2, pi);
            if ((int)found.size() == k) {
                kth = 0.0;
                for (auto& e : found) kth = std::max(kth, e.first);
            }
        } else if (d2 < kth) {
            // k is small (11): a linear scan for the worst beats heap
            // maintenance (no pop/push churn per candidate)
            int worst = 0;
            for (int j = 1; j < k; ++j)
                if (found[j].first > found[worst].first) worst = j;
            found[worst] = {d2, pi};
            kth = 0.0;
            for (auto& e : found) kth = std::max(kth, e.first);
        }
    }
};

inline void scan_fine_cell(const Grid& g, const double* q, KnnState& st,
                           int x, int y, int z) {
    int c = (x * g.dims[1] + y) * g.dims[2] + z;
    for (int s = g.cell_start[c]; s < g.cell_start[c + 1]; ++s) {
        const double* p = g.pts.data() + 3 * s;
        double dx = q[0] - p[0], dy = q[1] - p[1], dz = q[2] - p[2];
        st.offer(dx * dx + dy * dy + dz * dz, s);
    }
}

// squared distance from q to the box of fine cell (x,y,z); 0 if inside
inline double fine_cell_dist2(const Grid& g, const double* q,
                              int x, int y, int z) {
    int c[3] = {x, y, z};
    double d2 = 0.0;
    for (int d = 0; d < 3; ++d) {
        double lo = g.origin[d] + c[d] * g.cell;
        double hi = lo + g.cell;
        double dd = std::max(std::max(lo - q[d], q[d] - hi), 0.0);
        d2 += dd * dd;
    }
    return d2;
}

// Completeness bound shared by both levels: after finishing ring r around
// `base` (in units of `cell` over `dims`), every unexplored cell lies, in
// at least one dimension, beyond the scanned slab but inside the grid.
// Returns the minimum such distance (1e300 = whole grid swept).
inline double unexplored_lower_bound(const double* q, const double* origin,
                                     double cell, const int* dims,
                                     const int* base, int r) {
    double lo = 1e300;
    for (int d = 0; d < 3; ++d) {
        double dd = 1e300;
        if (base[d] - r > 0) {
            double x_lo = origin[d] + (base[d] - r) * cell;
            dd = std::min(dd, std::max(q[d] - x_lo, 0.0));
        }
        if (base[d] + r < dims[d] - 1) {
            double x_hi = origin[d] + (base[d] + r + 1) * cell;
            dd = std::min(dd, std::max(x_hi - q[d], 0.0));
        }
        lo = std::min(lo, dd);
    }
    return lo;
}

// Fine-level ring search capped at ring_cap.  Iterates ONLY the shell's
// six faces (O(ring^2) cells; a full-cube sweep with an interior
// `continue` is O(ring^3)).  Returns true if completeness was PROVED.
bool fine_search(const Grid& g, const double* q, KnnState& st,
                 int ring_cap) {
    int base[3];
    for (int d = 0; d < 3; ++d)
        base[d] = clampi((int)((q[d] - g.origin[d]) / g.cell), 0,
                         g.dims[d] - 1);
    int max_ring = std::max(std::max(g.dims[0], g.dims[1]), g.dims[2]);
    for (int ring = 0; ring <= max_ring; ++ring) {
        if ((int)st.found.size() == st.k && ring > 0) {
            double lo = unexplored_lower_bound(q, g.origin, g.cell, g.dims,
                                               base, ring - 1);
            if (lo >= 1e300 || lo * lo > st.kth) return true;
        }
        if (ring > ring_cap) return false;
        int x0 = base[0] - ring, x1 = base[0] + ring;
        int y0 = base[1] - ring, y1 = base[1] + ring;
        int z0 = base[2] - ring, z1 = base[2] + ring;
        if (x0 < 0 && y0 < 0 && z0 < 0 && x1 >= g.dims[0] &&
            y1 >= g.dims[1] && z1 >= g.dims[2])
            return true;                       // whole grid swept: exact
        int cy0 = clampi(y0, 0, g.dims[1] - 1),
            cy1 = clampi(y1, 0, g.dims[1] - 1);
        int cz0 = clampi(z0, 0, g.dims[2] - 1),
            cz1 = clampi(z1, 0, g.dims[2] - 1);
        if (ring == 0) {
            scan_fine_cell(g, q, st, base[0], base[1], base[2]);
            continue;
        }
        for (int f = 0; f < 2; ++f) {        // x faces: full y,z
            int x = f ? x1 : x0;
            if (x < 0 || x >= g.dims[0] || (f && x1 == x0)) continue;
            for (int y = cy0; y <= cy1; ++y)
                for (int z = cz0; z <= cz1; ++z)
                    scan_fine_cell(g, q, st, x, y, z);
        }
        int ix0 = std::max(x0 + 1, 0), ix1 = std::min(x1 - 1, g.dims[0] - 1);
        for (int f = 0; f < 2; ++f) {        // y faces: x interior
            int y = f ? y1 : y0;
            if (y < 0 || y >= g.dims[1] || (f && y1 == y0)) continue;
            for (int x = ix0; x <= ix1; ++x)
                for (int z = cz0; z <= cz1; ++z)
                    scan_fine_cell(g, q, st, x, y, z);
        }
        int iy0 = std::max(y0 + 1, 0), iy1 = std::min(y1 - 1, g.dims[1] - 1);
        for (int f = 0; f < 2; ++f) {        // z faces: x,y interior
            int z = f ? z1 : z0;
            if (z < 0 || z >= g.dims[2] || (f && z1 == z0)) continue;
            for (int x = ix0; x <= ix1; ++x)
                for (int y = iy0; y <= iy1; ++y)
                    scan_fine_cell(g, q, st, x, y, z);
        }
    }
    return true;
}

// Coarse-level exact search: ring-expand over coarse cells; each occupied
// coarse cell recurses into its nested fine cells with a per-fine-cell
// box-distance prune against the running kth bound.
void coarse_search(const Grid& g, const double* q, KnnState& st) {
    double ccell = g.cell * kCoarse;
    int base[3];
    for (int d = 0; d < 3; ++d)
        base[d] = clampi((int)((q[d] - g.origin[d]) / ccell), 0,
                         g.cdims[d] - 1);

    auto scan_coarse = [&](int X, int Y, int Z) {
        int cc = (X * g.cdims[1] + Y) * g.cdims[2] + Z;
        if (g.ccount[cc] == 0) return;
        // whole-coarse-cell box prune: at the tangent-contact ring most
        // occupied coarse cells are already beyond the kth bound — skip
        // them in O(1) instead of bound-checking their 216 fine cells
        // (this alone is ~4x on bbox-uniform queries)
        double d2c = 0.0;
        int C[3] = {X, Y, Z};
        for (int d = 0; d < 3; ++d) {
            double lo = g.origin[d] + C[d] * ccell;
            double hi = lo + ccell;
            double dd = std::max(std::max(lo - q[d], q[d] - hi), 0.0);
            d2c += dd * dd;
        }
        if (d2c > st.kth) return;
        int fx1 = std::min((X + 1) * kCoarse, g.dims[0]);
        int fy1 = std::min((Y + 1) * kCoarse, g.dims[1]);
        int fz1 = std::min((Z + 1) * kCoarse, g.dims[2]);
        for (int x = X * kCoarse; x < fx1; ++x)
            for (int y = Y * kCoarse; y < fy1; ++y)
                for (int z = Z * kCoarse; z < fz1; ++z) {
                    int c = (x * g.dims[1] + y) * g.dims[2] + z;
                    if (g.cell_start[c + 1] == g.cell_start[c]) continue;
                    if (fine_cell_dist2(g, q, x, y, z) > st.kth) continue;
                    scan_fine_cell(g, q, st, x, y, z);
                }
    };

    int max_ring = std::max(std::max(g.cdims[0], g.cdims[1]), g.cdims[2]);
    for (int ring = 0; ring <= max_ring; ++ring) {
        if ((int)st.found.size() == st.k && ring > 0) {
            double lo = unexplored_lower_bound(q, g.origin, ccell, g.cdims,
                                               base, ring - 1);
            if (lo >= 1e300 || lo * lo > st.kth) return;
        }
        int x0 = base[0] - ring, x1 = base[0] + ring;
        int y0 = base[1] - ring, y1 = base[1] + ring;
        int z0 = base[2] - ring, z1 = base[2] + ring;
        if (x0 < 0 && y0 < 0 && z0 < 0 && x1 >= g.cdims[0] &&
            y1 >= g.cdims[1] && z1 >= g.cdims[2])
            return;                            // whole grid swept: exact
        int cy0 = clampi(y0, 0, g.cdims[1] - 1),
            cy1 = clampi(y1, 0, g.cdims[1] - 1);
        int cz0 = clampi(z0, 0, g.cdims[2] - 1),
            cz1 = clampi(z1, 0, g.cdims[2] - 1);
        if (ring == 0) {
            scan_coarse(base[0], base[1], base[2]);
            continue;
        }
        for (int f = 0; f < 2; ++f) {
            int x = f ? x1 : x0;
            if (x < 0 || x >= g.cdims[0] || (f && x1 == x0)) continue;
            for (int y = cy0; y <= cy1; ++y)
                for (int z = cz0; z <= cz1; ++z)
                    scan_coarse(x, y, z);
        }
        int ix0 = std::max(x0 + 1, 0), ix1 = std::min(x1 - 1, g.cdims[0] - 1);
        for (int f = 0; f < 2; ++f) {
            int y = f ? y1 : y0;
            if (y < 0 || y >= g.cdims[1] || (f && y1 == y0)) continue;
            for (int x = ix0; x <= ix1; ++x)
                for (int z = cz0; z <= cz1; ++z)
                    scan_coarse(x, y, z);
        }
        int iy0 = std::max(y0 + 1, 0), iy1 = std::min(y1 - 1, g.cdims[1] - 1);
        for (int f = 0; f < 2; ++f) {
            int z = f ? z1 : z0;
            if (z < 0 || z >= g.cdims[2] || (f && z1 == z0)) continue;
            for (int x = ix0; x <= ix1; ++x)
                for (int y = iy0; y <= iy1; ++y)
                    scan_coarse(x, y, z);
        }
    }
}

}  // namespace

extern "C" {

// queries (n,3), surf_pts (m,3), surf_nrm (m,3) row-major f64.
// out_sdf (n,), out_keep (n,) uint8.
void knn_sign_vote(const double* queries, int64_t n,
                   const double* surf_pts, const double* surf_nrm, int64_t m,
                   int k, double* out_sdf, uint8_t* out_keep) {
    if (m == 0 || n == 0) return;
    if (k > m) k = (int)m;
    Grid g = build_grid(surf_pts, surf_nrm, (int)m);

    // Process queries in fine-cell order.  The surfel grid (~19 MB f64 at
    // the 800k-samples/mesh volume) far exceeds L2, and the caller's query
    // order is random (perturbed + uniform draws), so every query paid
    // DRAM latency for its cell scans.  Sorting queries by their grid cell
    // makes consecutive queries walk the SAME cells — the working set
    // drops to one neighbourhood.  Bit-exact: each query's own scan order
    // is a function of the query alone, only the outer loop order changes.
    // (std::sort on 800k keys is ~2% of the win it buys.)
    std::vector<int64_t> order(n);
    {
        std::vector<int> qcell(n);
        for (int64_t i = 0; i < n; ++i) {
            const double* q = queries + 3 * i;
            int c[3];
            for (int d = 0; d < 3; ++d)
                c[d] = clampi((int)((q[d] - g.origin[d]) / g.cell), 0,
                              g.dims[d] - 1);
            qcell[i] = (c[0] * g.dims[1] + c[1]) * g.dims[2] + c[2];
        }
        for (int64_t i = 0; i < n; ++i) order[i] = i;
        std::sort(order.begin(), order.end(),
                  [&](int64_t a, int64_t b) { return qcell[a] < qcell[b]; });
    }
    std::vector<double> qsorted(3 * n);
    for (int64_t i = 0; i < n; ++i)
        for (int d = 0; d < 3; ++d)
            qsorted[3 * i + d] = queries[3 * order[i] + d];

#pragma omp parallel
    {
        KnnState st;
        st.k = k;
        st.found.reserve(k + 1);
#pragma omp for schedule(dynamic, 256)
        for (int64_t si = 0; si < n; ++si) {
            const int64_t qi = order[si];
            const double* q = qsorted.data() + 3 * si;
            st.reset();
            // near-surface fast path on the fine grid; exact nested
            // coarse fallback for queries whose neighbors sit further out
            if (!fine_search(g, q, st, /*ring_cap=*/8)) {
                st.reset();
                coarse_search(g, q, st);
            }
            // vote
            int pos = 0;
            double best_d2 = 1e300;
            for (auto& e : st.found) {
                const double* p = g.pts.data() + 3 * e.second;
                const double* nn = g.nrm.data() + 3 * e.second;
                double dot = (q[0] - p[0]) * nn[0] + (q[1] - p[1]) * nn[1] +
                             (q[2] - p[2]) * nn[2];
                if (dot > 0) pos++;
                best_d2 = std::min(best_d2, e.first);
            }
            int kk = (int)st.found.size();
            bool keep = (pos == 0) || (pos == kk);
            out_keep[qi] = keep ? 1 : 0;
            double s = (pos == kk) ? 1.0 : -1.0;
            out_sdf[qi] = s * std::sqrt(best_d2);
        }
    }
}

}  // extern "C"
