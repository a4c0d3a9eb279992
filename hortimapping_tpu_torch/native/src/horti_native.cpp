// Native runtime kernels for hortimapping_tpu.
//
// Host-side geometry ops the reference obtained from skimage/Open3D C++
// (marching cubes at `wild_completion/utils.py:576`, DBSCAN clustering at
// `utils.py:410`) — re-implemented from first principles:
//
//  * iso-surface extraction by marching tetrahedra on the 6-tet cube
//    decomposition (shared main diagonal -> consistent, watertight across
//    cube faces), with vertex welding on grid-edge keys, and classic
//    marching cubes on the same welded vertices; both run a batch of grids
//    on a pool of threads;
//  * DBSCAN with a uniform grid hash (cell = eps) and BFS expansion.
//
// Exposed as a plain C ABI for ctypes. Build: see native/__init__.py.

#include <algorithm>
#include <array>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <memory>
#include <mutex>
#include <system_error>
#include <thread>
#include <unordered_map>
#include <vector>
#include <queue>

extern "C" {

// ---------------------------------------------------------------------------
// Marching tetrahedra
// ---------------------------------------------------------------------------

// Cube corner offsets (x, y, z) indexed 0..7: bit0 = x, bit1 = y, bit2 = z.
static const int CORNER[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {1, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1},
};

// 6 tetrahedra per cube, all containing the main diagonal 0-7.
static const int TETS[6][4] = {
    {0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
    {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7},
};

// Shared vertex welder: one vertex per crossing grid edge, positioned by
// linear interpolation to the iso value. Both iso-surfacers (marching
// tetrahedra below, classic marching cubes further down) weld through this,
// so their vertex SETS agree wherever they cross the same grid edges.
// Welding is a direct-index array over (edge class, lower grid point): the
// 6-tet decomposition only ever crosses 7 edge directions (axis x/y/z, face
// diagonals xy/xz/yz, body diagonal), all anchored at their lower corner —
// a zero-initialized idx+1 slot per edge replaces the hash map that
// dominated the crossing-cell work (~100 ns/lookup -> one cached load).
// One state serves every fruit a thread meshes: `begin` clears only the
// slots the last fruit filled, not the whole table (28 bytes a grid point).
struct McState {
    std::vector<float> verts;
    std::vector<int32_t> faces;
    std::vector<int32_t> weld;  // [7 * npts], vertex index + 1, 0 = empty
    std::vector<size_t> filled;  // the weld slots set since `begin`
    int ny = 0, nz = 0;
    int64_t npts = 0;
    float iso = 0.f, spacing = 1.f;

    void begin(int nx, int ny_, int nz_, float iso_, float spacing_) {
        ny = ny_; nz = nz_; iso = iso_; spacing = spacing_;
        verts.clear();
        faces.clear();
        const int64_t n = (int64_t)nx * ny * nz;
        if (n != npts) {
            npts = n;
            weld.assign((size_t)npts * 7, 0);
        } else {
            for (size_t s : filled) weld[s] = 0;
        }
        filled.clear();
    }

    int edge_class(int64_t d) const {
        const int64_t sx = (int64_t)ny * nz, sy = nz;
        if (d == sx) return 0;
        if (d == sy) return 1;
        if (d == 1) return 2;
        if (d == sx + sy) return 3;
        if (d == sx + 1) return 4;
        if (d == sy + 1) return 5;
        return 6;  // sx + sy + 1 (body diagonal)
    }

    int32_t edge_vertex(int64_t ga, int64_t gb, float va, float vb) {
        const int64_t lo = ga < gb ? ga : gb, hi = ga < gb ? gb : ga;
        const size_t s = (size_t)edge_class(hi - lo) * npts + lo;
        int32_t* slot = &weld[s];
        if (*slot) return *slot - 1;
        filled.push_back(s);
        float t = (iso - va) / (vb - va);
        if (!(t >= 0.f)) t = 0.f;
        if (!(t <= 1.f)) t = 1.f;
        int ai = (int)(ga / ((int64_t)ny * nz));
        int aj = (int)((ga / nz) % ny);
        int ak = (int)(ga % nz);
        int bi = (int)(gb / ((int64_t)ny * nz));
        int bj = (int)((gb / nz) % ny);
        int bk = (int)(gb % nz);
        float x = (ai + t * (bi - ai)) * spacing;
        float y = (aj + t * (bj - aj)) * spacing;
        float z = (ak + t * (bk - ak)) * spacing;
        int32_t idx = (int32_t)(verts.size() / 3);
        verts.push_back(x);
        verts.push_back(y);
        verts.push_back(z);
        *slot = idx + 1;
        return idx;
    }
};

// Column sign masks: bit t of word w of column (i, j) = (grid value at
// z = w*64 + t) < iso. The iso-surface touches O(D^2) of the D^3 cells, so
// an iso-surfacer's scan is dominated by proving cells empty; with these
// masks a whole z-column of cells is classified with ~4 word ops per word
// instead of 8 loads per cell (measured 3.9 -> 0.35 ms per 40^3 fruit grid
// on one core).
struct SignColumns {
    std::vector<uint64_t> m;
    int ny = 0, nz = 0, W = 0;

    void build(const float* grid, int nx, int ny_, int nz_, float iso) {
        ny = ny_; nz = nz_; W = (nz + 63) >> 6;
        m.assign((size_t)nx * ny * W, 0);
        const float* g = grid;
        for (int64_t col = 0; col < (int64_t)nx * ny; ++col, g += nz) {
            uint64_t* mw = &m[(size_t)col * W];
            for (int k = 0; k < nz; ++k)
                if (g[k] < iso) mw[k >> 6] |= 1ull << (k & 63);
        }
    }
    const uint64_t* col(int i, int j) const {
        return &m[((size_t)i * ny + j) * W];
    }
    int bit(const uint64_t* c, int k) const {
        return (int)((c[k >> 6] >> (k & 63)) & 1ull);
    }
    // bit k of out = cell (i, j, k) has corners of both signs (k < nz-1)
    void crossing(int i, int j, uint64_t* out, uint64_t* u, uint64_t* v) const {
        const uint64_t *a = col(i, j), *b = col(i + 1, j),
                       *c = col(i, j + 1), *d = col(i + 1, j + 1);
        for (int w = 0; w < W; ++w) {
            u[w] = a[w] | b[w] | c[w] | d[w];
            v[w] = a[w] & b[w] & c[w] & d[w];
        }
        for (int w = 0; w < W; ++w) {
            uint64_t u2 = (u[w] >> 1) | (w + 1 < W ? u[w + 1] << 63 : 0ull);
            uint64_t v2 = (v[w] >> 1) | (w + 1 < W ? v[w + 1] << 63 : 0ull);
            out[w] = (u[w] | u2) & ~(v[w] & v2);
        }
        // cells exist for k in [0, nz-2]: clear bit nz-1 and above
        int wl = (nz - 1) >> 6, bl = (nz - 1) & 63;
        out[wl] &= (1ull << bl) - 1ull;
        for (int w = wl + 1; w < W; ++w) out[w] = 0;
    }
    // corner sign mask of cell (i, j, k), CORNER bit order (bit0=x,1=y,2=z)
    int cell_mask(int i, int j, int k) const {
        const uint64_t *a = col(i, j), *b = col(i + 1, j),
                       *c = col(i, j + 1), *d = col(i + 1, j + 1);
        return bit(a, k) | bit(b, k) << 1 | bit(c, k) << 2 | bit(d, k) << 3 |
               bit(a, k + 1) << 4 | bit(b, k + 1) << 5 | bit(c, k + 1) << 6 |
               bit(d, k + 1) << 7;
    }
};

// grid: row-major (nx, ny, nz), value at (i,j,k) = grid[(i*ny + j)*nz + k].
// The surface goes to st (begun on this grid): vertices in index * spacing
// coordinates, faces indexing them.
static void marching_tetrahedra(const float* grid, int nx, int ny, int nz,
                                McState& st, SignColumns& sc) {
    const float iso = st.iso;
    auto gid = [&](int i, int j, int k) -> int64_t {
        return ((int64_t)i * ny + j) * nz + k;
    };

    auto edge_vertex = [&](int64_t ga, int64_t gb, float va, float vb) -> int32_t {
        return st.edge_vertex(ga, gb, va, vb);
    };

    sc.build(grid, nx, ny, nz, iso);
    int64_t off[8];
    for (int c = 0; c < 8; ++c)
        off[c] = ((int64_t)CORNER[c][0] * ny + CORNER[c][1]) * nz + CORNER[c][2];
    std::vector<uint64_t> cross(sc.W), ubuf(sc.W), vbuf(sc.W);

    for (int i = 0; i + 1 < nx; ++i) {
        for (int j = 0; j + 1 < ny; ++j) {
            sc.crossing(i, j, cross.data(), ubuf.data(), vbuf.data());
            for (int w = 0; w < sc.W; ++w) {
            uint64_t bits = cross[w];
            while (bits) {
                const int k = (w << 6) + __builtin_ctzll(bits);
                bits &= bits - 1;
                const int64_t base = gid(i, j, k);
                const int mask = sc.cell_mask(i, j, k);
                float cv[8];
                int64_t cg[8];
                for (int c = 0; c < 8; ++c) {
                    cg[c] = base + off[c];
                    cv[c] = grid[cg[c]];
                }
                for (int t = 0; t < 6; ++t) {
                    const int* T = TETS[t];
                    int inside = 0;
                    for (int c = 0; c < 4; ++c)
                        if ((mask >> T[c]) & 1) inside |= 1 << c;
                    if (inside == 0 || inside == 15) continue;

                    // collect crossing edges of the tet (pairs with opposite sign)
                    // tet edges: (0,1)(0,2)(0,3)(1,2)(1,3)(2,3)
                    static const int TE[6][2] = {{0,1},{0,2},{0,3},{1,2},{1,3},{2,3}};
                    int32_t ev[6];
                    int ne = 0;
                    int epairs[6][2];
                    for (int e = 0; e < 6; ++e) {
                        int a = TE[e][0], b = TE[e][1];
                        bool ia = (inside >> a) & 1, ib = (inside >> b) & 1;
                        if (ia != ib) {
                            ev[ne] = edge_vertex(cg[T[a]], cg[T[b]], cv[T[a]], cv[T[b]]);
                            epairs[ne][0] = a; epairs[ne][1] = b;
                            ne++;
                        }
                    }
                    if (ne == 3) {
                        st.faces.push_back(ev[0]);
                        st.faces.push_back(ev[1]);
                        st.faces.push_back(ev[2]);
                    } else if (ne == 4) {
                        // quad: the 4 crossing edges form a polygon in which
                        // two edges are adjacent iff they share a tet vertex.
                        // Place the edge opposite e0 (sharing no vertex) at
                        // polygon position 2.
                        auto share = [&](int x, int y) {
                            return epairs[x][0] == epairs[y][0] || epairs[x][0] == epairs[y][1] ||
                                   epairs[x][1] == epairs[y][0] || epairs[x][1] == epairs[y][1];
                        };
                        int op = 1;
                        if (!share(0, 2)) op = 2;
                        else if (!share(0, 3)) op = 3;
                        int adj1 = -1, adj2 = -1;
                        for (int e = 1; e < 4; ++e) {
                            if (e == op) continue;
                            (adj1 < 0 ? adj1 : adj2) = e;
                        }
                        int q0 = ev[0], q1 = ev[adj1], q2 = ev[op], q3 = ev[adj2];
                        st.faces.push_back(q0); st.faces.push_back(q1); st.faces.push_back(q2);
                        st.faces.push_back(q0); st.faces.push_back(q2); st.faces.push_back(q3);
                    }
                }
            }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Classic marching cubes (cube cells, asymptotic-decider ambiguity handling)
// ---------------------------------------------------------------------------
// The reference extracts its meshes with skimage's cube-based marching cubes
// (`wild_completion/utils.py:576-578`). This is the cube-cell equivalent,
// built table-free: per cube, every crossing cube edge gets a welded vertex
// (same interpolation as MT above, so the vertex positions are the classic
// MC ones); crossing points are linked pairwise on each cube face by
// marching-squares pairing, with the bilinear asymptotic decider resolving
// the ambiguous (diagonal) face case — the topologically correct choice that
// fixed-table MC gets wrong on saddle faces. The resulting per-cube closed
// polygons are fan-triangulated with outward-consistent winding (normals
// point toward increasing SDF).

// 12 cube edges as corner pairs (corner bit0 = x, bit1 = y, bit2 = z).
static const int CEDGE[12][2] = {
    {0, 1}, {2, 3}, {4, 5}, {6, 7},   // x-aligned
    {0, 2}, {1, 3}, {4, 6}, {5, 7},   // y-aligned
    {0, 4}, {1, 5}, {2, 6}, {3, 7},   // z-aligned
};

// 6 faces, 4 corners each in cyclic order.
static const int FACES[6][4] = {
    {0, 2, 6, 4}, {1, 3, 7, 5},   // x = 0, 1
    {0, 1, 5, 4}, {2, 3, 7, 6},   // y = 0, 1
    {0, 1, 3, 2}, {4, 5, 7, 6},   // z = 0, 1
};

// FACE_EDGE[f][s] = cube-edge index between FACES[f][s] and FACES[f][(s+1)%4].
static int FACE_EDGE[6][4];
static bool face_edge_init_done = [] {
    int lut[8][8];
    for (int a = 0; a < 8; ++a)
        for (int b = 0; b < 8; ++b) lut[a][b] = -1;
    for (int e = 0; e < 12; ++e) {
        lut[CEDGE[e][0]][CEDGE[e][1]] = e;
        lut[CEDGE[e][1]][CEDGE[e][0]] = e;
    }
    for (int f = 0; f < 6; ++f)
        for (int s = 0; s < 4; ++s)
            FACE_EDGE[f][s] = lut[FACES[f][s]][FACES[f][(s + 1) % 4]];
    return true;
}();

// The same contract as marching_tetrahedra above.
static void marching_cubes(const float* grid, int nx, int ny, int nz,
                           McState& st, SignColumns& sc) {
    const float iso = st.iso;
    auto gid = [&](int i, int j, int k) -> int64_t {
        return ((int64_t)i * ny + j) * nz + k;
    };

    // same column-mask crossing-cell scan as marching tetrahedra above
    sc.build(grid, nx, ny, nz, iso);
    int64_t off[8];
    for (int c = 0; c < 8; ++c)
        off[c] = ((int64_t)CORNER[c][0] * ny + CORNER[c][1]) * nz + CORNER[c][2];
    std::vector<uint64_t> cross(sc.W), ubuf(sc.W), vbuf(sc.W);

    for (int i = 0; i + 1 < nx; ++i) {
        for (int j = 0; j + 1 < ny; ++j) {
            sc.crossing(i, j, cross.data(), ubuf.data(), vbuf.data());
            for (int w = 0; w < sc.W; ++w) {
            uint64_t bits = cross[w];
            while (bits) {
                const int k = (w << 6) + __builtin_ctzll(bits);
                bits &= bits - 1;
                const int64_t base = gid(i, j, k);
                const int mask = sc.cell_mask(i, j, k);
                float cv[8];
                int64_t cg[8];
                bool inside[8];
                for (int c = 0; c < 8; ++c) {
                    cg[c] = base + off[c];
                    cv[c] = grid[cg[c]];
                    inside[c] = (mask >> c) & 1;
                }

                // welded vertex per crossing cube edge
                int32_t evert[12];
                for (int e = 0; e < 12; ++e) {
                    int a = CEDGE[e][0], b = CEDGE[e][1];
                    evert[e] = inside[a] != inside[b]
                                   ? st.edge_vertex(cg[a], cg[b], cv[a], cv[b])
                                   : -1;
                }

                // link crossing points pairwise on each face
                int adj[12][2];
                int deg[12] = {0};
                bool on_amb_face[12] = {false};
                auto link = [&](int ea, int eb) {
                    if (deg[ea] < 2) adj[ea][deg[ea]++] = eb;
                    if (deg[eb] < 2) adj[eb][deg[eb]++] = ea;
                };
                for (int f = 0; f < 6; ++f) {
                    int xs[4], nxs = 0;
                    for (int s = 0; s < 4; ++s) {
                        int qa = FACES[f][s], qb = FACES[f][(s + 1) % 4];
                        if (inside[qa] != inside[qb]) xs[nxs++] = s;
                    }
                    if (nxs == 2) {
                        link(FACE_EDGE[f][xs[0]], FACE_EDGE[f][xs[1]]);
                    } else if (nxs == 4) {
                        for (int s = 0; s < 4; ++s)
                            on_amb_face[FACE_EDGE[f][s]] = true;
                        // ambiguous face: inside corners on one diagonal.
                        // Asymptotic decider — the bilinear saddle value
                        // decides which corner pair the two arcs wrap.
                        float v0 = cv[FACES[f][0]], v1 = cv[FACES[f][1]];
                        float v2 = cv[FACES[f][2]], v3 = cv[FACES[f][3]];
                        float denom = v0 + v2 - v1 - v3;
                        bool saddle_inside =
                            denom != 0.f && (v0 * v2 - v1 * v3) / denom < iso;
                        if (saddle_inside == inside[FACES[f][0]]) {
                            link(FACE_EDGE[f][0], FACE_EDGE[f][1]);
                            link(FACE_EDGE[f][2], FACE_EDGE[f][3]);
                        } else {
                            link(FACE_EDGE[f][3], FACE_EDGE[f][0]);
                            link(FACE_EDGE[f][1], FACE_EDGE[f][2]);
                        }
                    }
                }

                // trace the closed polygon loops (every crossing edge has
                // exactly two face links), orient, fan-triangulate
                bool used[12] = {false};
                for (int e0 = 0; e0 < 12; ++e0) {
                    if (evert[e0] < 0 || used[e0] || deg[e0] != 2) continue;
                    int loop[12], n = 0;
                    int prev = -1, cur = e0;
                    while (true) {
                        loop[n++] = cur;
                        used[cur] = true;
                        int nxt = adj[cur][0] == prev ? adj[cur][1] : adj[cur][0];
                        prev = cur;
                        cur = nxt;
                        if (cur == e0 || used[cur] || n >= 12) break;
                    }
                    if (n < 3) continue;

                    // Newell normal of the loop
                    float nxl = 0.f, nyl = 0.f, nzl = 0.f;
                    for (int m = 0; m < n; ++m) {
                        const float* pa = &st.verts[3 * evert[loop[m]]];
                        const float* pb = &st.verts[3 * evert[loop[(m + 1) % n]]];
                        nxl += (pa[1] - pb[1]) * (pa[2] + pb[2]);
                        nyl += (pa[2] - pb[2]) * (pa[0] + pb[0]);
                        nzl += (pa[0] - pb[0]) * (pa[1] + pb[1]);
                    }
                    // outward direction: every loop vertex sits on a cube
                    // edge with one inside and one outside corner; the
                    // inside->outside direction of that edge is a local
                    // gradient proxy. Sum them over the loop.
                    float dx = 0.f, dy = 0.f, dz = 0.f;
                    for (int m = 0; m < n; ++m) {
                        int a = CEDGE[loop[m]][0], b = CEDGE[loop[m]][1];
                        if (inside[b]) { int t = a; a = b; b = t; }
                        dx += CORNER[b][0] - CORNER[a][0];
                        dy += CORNER[b][1] - CORNER[a][1];
                        dz += CORNER[b][2] - CORNER[a][2];
                    }
                    bool flip = nxl * dx + nyl * dy + nzl * dz < 0.f;
                    // Fan apex must not lie on an ambiguous (4-crossing)
                    // face: an apex whose edge borders such a face can form
                    // a fan chord lying IN that face plane, and the
                    // neighboring cube then emits the coincident opposite
                    // triangle — a non-manifold zero-volume fin. A 2-crossing
                    // face can never contain a third loop vertex, so any
                    // apex off all ambiguous faces is safe; if none exists,
                    // triangulate from the loop centroid (strictly interior
                    // to this cube, so it cannot coincide across cubes).
                    int apex = -1;
                    if (n == 3) {
                        apex = 0;  // single triangle, always safe
                    } else {
                        for (int m = 0; m < n; ++m)
                            if (!on_amb_face[loop[m]]) { apex = m; break; }
                    }
                    if (apex >= 0) {
                        for (int m = 1; m + 1 < n; ++m) {
                            int ia = (apex + (flip ? m + 1 : m)) % n;
                            int ib = (apex + (flip ? m : m + 1)) % n;
                            st.faces.push_back(evert[loop[apex]]);
                            st.faces.push_back(evert[loop[ia]]);
                            st.faces.push_back(evert[loop[ib]]);
                        }
                    } else {
                        float cx = 0.f, cy = 0.f, cz = 0.f;
                        for (int m = 0; m < n; ++m) {
                            const float* p = &st.verts[3 * evert[loop[m]]];
                            cx += p[0]; cy += p[1]; cz += p[2];
                        }
                        int32_t cidx = (int32_t)(st.verts.size() / 3);
                        st.verts.push_back(cx / n);
                        st.verts.push_back(cy / n);
                        st.verts.push_back(cz / n);
                        for (int m = 0; m < n; ++m) {
                            int ia = flip ? (m + 1) % n : m;
                            int ib = flip ? m : (m + 1) % n;
                            st.faces.push_back(cidx);
                            st.faces.push_back(evert[loop[ia]]);
                            st.faces.push_back(evert[loop[ib]]);
                        }
                    }
                }
            }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// A batch of grids on a pool of threads
// ---------------------------------------------------------------------------
// horti_iso_surface_batch meshes the fruits of a batch on a pool of threads,
// each taking the next fruit not yet taken; f16 grids are widened to f32
// first, exactly, and the vertices become (v - offset) * scale in f32, as
// numpy computes it on an f32 array. A fruit's output depends on its grid
// alone, so the batch's output is the same at any thread count.

// IEEE half -> float, exact for every bit pattern.
static inline float half_to_float(uint16_t h) {
    const uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
    const uint32_t em = h & 0x7fffu;
    uint32_t bits;
    if (em >= 0x7c00u) {                 // inf, nan
        bits = sign | 0x7f800000u | ((em & 0x3ffu) << 13);
    } else if (em >= 0x0400u) {          // normal: exponent bias 15 -> 127
        bits = sign | ((em << 13) + 0x38000000u);
    } else {                             // zero, subnormal: em * 2^-24
        const float f = (float)em * 0x1p-24f;
        memcpy(&bits, &f, sizeof bits);
        bits |= sign;
    }
    float out;
    memcpy(&out, &bits, sizeof out);
    return out;
}

// What a thread needs to mesh one grid after another. A batch's threads
// take theirs from a free list and give it back when the batch is done, so
// the next batch neither allocates nor faults in a weld table anew (on an
// 8-CPU H100 host, 32 grids of 80^3 on 8 threads: 1.15-1.21 ms a fruit
// against 1.30-1.44 with a new state each batch). The list keeps as many as
// the most threads that ever meshed at once, each with 28 bytes a grid
// point (14 MB at 80^3): about 115 MB on 8 threads and 460 MB on 32, for
// the life of the process.
struct IsoScratch {
    McState st;
    SignColumns sc;
    std::vector<float> wide;  // an f16 grid, widened
};

// A batch's surfaces, each fruit's in buffers of its own, which the caller
// reads in place and frees all at once with horti_iso_batch_free. Copying
// them out into one array a batch instead made host meshing slower on an
// 8-CPU H100 host: 40 % at 40^3 and 14 % at 80^3 (32 grids, medians).
struct IsoBatch {
    std::vector<std::vector<float>> verts;    // 3 a vertex
    std::vector<std::vector<int32_t>> faces;  // 3 a face, indexing the fruit's vertices
};

static std::mutex scratch_mu;
static std::vector<std::unique_ptr<IsoScratch>> scratch_free;

static std::unique_ptr<IsoScratch> scratch_take() {
    {
        std::lock_guard<std::mutex> lock(scratch_mu);
        if (!scratch_free.empty()) {
            std::unique_ptr<IsoScratch> s = std::move(scratch_free.back());
            scratch_free.pop_back();
            return s;
        }
    }
    return std::unique_ptr<IsoScratch>(new IsoScratch);
}

static void scratch_give(std::unique_ptr<IsoScratch> s) {
    std::lock_guard<std::mutex> lock(scratch_mu);
    scratch_free.push_back(std::move(s));
}

// grids: n row-major (nx, ny, nz) grids back to back, f32 (f16 = 0) or IEEE
// half (f16 = 1). method: 0 marching tetrahedra, 1 marching cubes. Meshes
// them on up to n_threads threads and writes, for each grid i, its vertex
// and face counts to n_verts[i] and n_faces[i] and where they lie to
// verts[i] and faces[i], and the threads that meshed to *threads_used.
// Returns the batch that holds them, or null where memory ran out.
void* horti_iso_surface_batch(const void* grids, int f16, int64_t n,
                              int nx, int ny, int nz, float iso, float spacing,
                              float offset, float scale, int method, int n_threads,
                              int64_t* n_verts, int64_t* n_faces, void** verts, void** faces,
                              int* threads_used) {
    std::unique_ptr<IsoBatch> b;
    try {
        b.reset(new IsoBatch);
        b->verts.resize(n);
        b->faces.resize(n);
    } catch (const std::bad_alloc&) {
        return nullptr;
    }
    const int64_t npts = (int64_t)nx * ny * nz;
    std::atomic<int64_t> next{0};
    std::atomic<bool> failed{false};

    auto work = [&]() {
        try {
            std::unique_ptr<IsoScratch> scratch = scratch_take();
            McState& st = scratch->st;
            for (int64_t i; !failed.load() && (i = next.fetch_add(1)) < n;) {
                const float* g;
                if (f16) {
                    const uint16_t* h = (const uint16_t*)grids + i * npts;
                    scratch->wide.resize(npts);
                    for (int64_t p = 0; p < npts; ++p) scratch->wide[p] = half_to_float(h[p]);
                    g = scratch->wide.data();
                } else {
                    g = (const float*)grids + i * npts;
                }
                st.begin(nx, ny, nz, iso, spacing);
                if (method == 1)
                    marching_cubes(g, nx, ny, nz, st, scratch->sc);
                else
                    marching_tetrahedra(g, nx, ny, nz, st, scratch->sc);
                std::vector<float>& v = b->verts[i];
                v.resize(st.verts.size());
                for (size_t k = 0; k < v.size(); ++k) v[k] = (st.verts[k] - offset) * scale;
                b->faces[i].assign(st.faces.begin(), st.faces.end());
            }
            scratch_give(std::move(scratch));
        } catch (const std::exception&) {
            failed = true;
        }
    };

    const int want = (int)std::max<int64_t>(1, std::min<int64_t>(n_threads, n));
    std::vector<std::thread> pool;
    for (int t = 1; t < want; ++t) {
        try {
            pool.emplace_back(work);
        } catch (const std::system_error&) {
            break;  // no more threads to be had: mesh on those started
        }
    }
    work();
    for (std::thread& t : pool) t.join();
    if (failed) return nullptr;
    for (int64_t i = 0; i < n; ++i) {
        n_verts[i] = (int64_t)(b->verts[i].size() / 3);
        n_faces[i] = (int64_t)(b->faces[i].size() / 3);
        verts[i] = b->verts[i].data();
        faces[i] = b->faces[i].data();
    }
    *threads_used = 1 + (int)pool.size();
    return b.release();
}

void horti_iso_batch_free(void* batch) { delete (IsoBatch*)batch; }

// ---------------------------------------------------------------------------
// DBSCAN (grid-hash neighborhoods, BFS expansion)
// ---------------------------------------------------------------------------
// labels: -1 noise, 0..k cluster ids. Matches Open3D cluster_dbscan
// semantics (`utils.py:410`): a core point has >= min_points neighbors
// within eps (including itself).

int horti_dbscan(const float* pts, int64_t n, float eps, int min_points,
                 int32_t* labels) {
    if (n == 0) return 0;
    const float eps2 = eps * eps;
    struct CellHash {
        size_t operator()(const std::array<int64_t, 3>& c) const {
            return std::hash<int64_t>()(c[0] * 73856093 ^ c[1] * 19349663 ^ c[2] * 83492791);
        }
    };
    std::unordered_map<std::array<int64_t, 3>, std::vector<int64_t>, CellHash> cells;
    auto cell_of = [&](int64_t i) {
        return std::array<int64_t, 3>{
            (int64_t)std::floor(pts[3 * i] / eps),
            (int64_t)std::floor(pts[3 * i + 1] / eps),
            (int64_t)std::floor(pts[3 * i + 2] / eps)};
    };
    for (int64_t i = 0; i < n; ++i) cells[cell_of(i)].push_back(i);

    auto neighbors = [&](int64_t i, std::vector<int64_t>& out) {
        out.clear();
        auto c = cell_of(i);
        for (int dx = -1; dx <= 1; ++dx)
            for (int dy = -1; dy <= 1; ++dy)
                for (int dz = -1; dz <= 1; ++dz) {
                    auto it = cells.find({c[0] + dx, c[1] + dy, c[2] + dz});
                    if (it == cells.end()) continue;
                    for (int64_t j : it->second) {
                        float ddx = pts[3 * i] - pts[3 * j];
                        float ddy = pts[3 * i + 1] - pts[3 * j + 1];
                        float ddz = pts[3 * i + 2] - pts[3 * j + 2];
                        if (ddx * ddx + ddy * ddy + ddz * ddz <= eps2) out.push_back(j);
                    }
                }
    };

    std::vector<int8_t> visited(n, 0);
    for (int64_t i = 0; i < n; ++i) labels[i] = -1;
    int32_t cluster = -1;
    std::vector<int64_t> nbr, nbr2;
    for (int64_t i = 0; i < n; ++i) {
        if (visited[i]) continue;
        visited[i] = 1;
        neighbors(i, nbr);
        if ((int)nbr.size() < min_points) continue;  // noise (may be claimed later)
        ++cluster;
        labels[i] = cluster;
        std::queue<int64_t> q;
        for (int64_t j : nbr) q.push(j);
        while (!q.empty()) {
            int64_t j = q.front();
            q.pop();
            if (labels[j] == -1) labels[j] = cluster;  // border point
            if (visited[j]) continue;
            visited[j] = 1;
            labels[j] = cluster;
            neighbors(j, nbr2);
            if ((int)nbr2.size() >= min_points)
                for (int64_t m : nbr2) q.push(m);
        }
    }
    return cluster + 1;  // number of clusters
}

// ---------------------------------------------------------------------------
// Brute-force nearest-neighbor distances (small host-side fallback; the hot
// path runs on TPU, see ops/chamfer.py)
// ---------------------------------------------------------------------------

void horti_nn_distances(const float* a, int64_t na, const float* b, int64_t nb,
                        float* out) {
    for (int64_t i = 0; i < na; ++i) {
        float best = INFINITY;
        float ax = a[3 * i], ay = a[3 * i + 1], az = a[3 * i + 2];
        for (int64_t j = 0; j < nb; ++j) {
            float dx = ax - b[3 * j], dy = ay - b[3 * j + 1], dz = az - b[3 * j + 2];
            float d = dx * dx + dy * dy + dz * dz;
            if (d < best) best = d;
        }
        out[i] = std::sqrt(best);
    }
}

}  // extern "C"
