// tpu_ldpc_torch native host helper: the port's copy of the JAX
// package's tpu_ldpc/_native/native.cpp, without its CPU min-sum decoder
// (ldpc_minsum_decode; the port decodes with decode(device='cpu') and the
// CUDA kernels instead).
//
// Cycle counting for girth-driven construction and annealing, and
// bit-packed GF(2) elimination for rank checks and minimum-distance
// search.  Semantics mirror tpu_ldpc_torch/codes/base_graphs.py and
// tpu_ldpc_torch/codes/gf2.py exactly; tests hold them equal.
//
// Build (tpu_ldpc_torch/_build.py, at first use):
//   g++ -O3 -shared -fPIC -std=c++17 native.cpp -o libnative_<hash>.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// Cycle counting on a QC base matrix (B row-major int64, -1 = zero block)
// ---------------------------------------------------------------------

long long qc_count_4cycles(const long long* B, int mb, int nb, int Z) {
    long long count = 0;
    for (int i1 = 0; i1 < mb; ++i1) {
        const long long* r1 = B + (size_t)i1 * nb;
        for (int i2 = i1 + 1; i2 < mb; ++i2) {
            const long long* r2 = B + (size_t)i2 * nb;
            for (int j1 = 0; j1 < nb; ++j1) {
                if (r1[j1] < 0 || r2[j1] < 0) continue;
                for (int j2 = j1 + 1; j2 < nb; ++j2) {
                    if (r1[j2] < 0 || r2[j2] < 0) continue;
                    long long d = (r1[j1] - r1[j2] + r2[j2] - r2[j1]) % Z;
                    if (d < 0) d += Z;
                    if (d == 0) ++count;
                }
            }
        }
    }
    return count;
}

// ACE-weighted 6-cycle cost: each zero-shift-sum 6-cycle through columns
// (j1, j2, j3) contributes 2^-(d_j1 + d_j2 + d_j3 - 6), so cycles confined
// to low-degree variable nodes (low ACE — the harmful ones for error
// floors, Tian et al.) dominate the cost while cycles passing through
// high-degree nodes are nearly free.  colw = column weights (length nb).
double qc_ace6_cost(const long long* B, int mb, int nb, int Z,
                    const long long* colw) {
    double raw = 0.0;
    for (int i1 = 0; i1 < mb; ++i1) {
        const long long* r1 = B + (size_t)i1 * nb;
        for (int j1 = 0; j1 < nb; ++j1) {
            if (r1[j1] < 0) continue;
            for (int j2 = 0; j2 < nb; ++j2) {
                if (j2 == j1 || r1[j2] < 0) continue;
                for (int i2 = i1 + 1; i2 < mb; ++i2) {
                    const long long* r2 = B + (size_t)i2 * nb;
                    if (r2[j2] < 0) continue;
                    for (int j3 = 0; j3 < nb; ++j3) {
                        if (j3 == j1 || j3 == j2 || r2[j3] < 0) continue;
                        for (int i3 = i1 + 1; i3 < mb; ++i3) {
                            if (i3 == i2) continue;
                            const long long* r3 = B + (size_t)i3 * nb;
                            if (r3[j3] < 0 || r3[j1] < 0) continue;
                            long long s = (r1[j1] - r1[j2] + r2[j2] - r2[j3]
                                           + r3[j3] - r3[j1]) % Z;
                            if (s < 0) s += Z;
                            if (s == 0) {
                                long long ace = colw[j1] + colw[j2]
                                                + colw[j3] - 6;
                                if (ace > 40) ace = 40;
                                raw += std::ldexp(1.0, (int)-ace);
                            }
                        }
                    }
                }
            }
        }
    }
    return raw * 0.5;
}

long long qc_count_6cycles(const long long* B, int mb, int nb, int Z) {
    // Mirrors base_graphs.count_6cycles: enumerate
    // (i1,j1)-(i1,j2)-(i2,j2)-(i2,j3)-(i3,j3)-(i3,j1) with i1 the
    // smallest of {i1, i2, i3}; each cycle is then hit exactly twice
    // (once per direction), halve at the end.  (With i1 only smaller
    // than i2 a cycle was hit three times -> 1.5x overcount.)
    long long raw = 0;
    for (int i1 = 0; i1 < mb; ++i1) {
        const long long* r1 = B + (size_t)i1 * nb;
        for (int j1 = 0; j1 < nb; ++j1) {
            if (r1[j1] < 0) continue;
            for (int j2 = 0; j2 < nb; ++j2) {
                if (j2 == j1 || r1[j2] < 0) continue;
                for (int i2 = i1 + 1; i2 < mb; ++i2) {
                    const long long* r2 = B + (size_t)i2 * nb;
                    if (r2[j2] < 0) continue;
                    for (int j3 = 0; j3 < nb; ++j3) {
                        if (j3 == j1 || j3 == j2 || r2[j3] < 0) continue;
                        for (int i3 = i1 + 1; i3 < mb; ++i3) {
                            if (i3 == i2) continue;
                            const long long* r3 = B + (size_t)i3 * nb;
                            if (r3[j3] < 0 || r3[j1] < 0) continue;
                            long long s = (r1[j1] - r1[j2] + r2[j2] - r2[j3]
                                           + r3[j3] - r3[j1]) % Z;
                            if (s < 0) s += Z;
                            if (s == 0) ++raw;
                        }
                    }
                }
            }
        }
    }
    return raw / 2;
}

}  // extern "C" — the walk enumerator below is a template (C++ linkage)

// 8-cycle enumeration shared by qc_count_8cycles / qc_ace8_cost.
//
// A length-8 cycle in the LIFTED Tanner graph projects to a closed
// non-backtracking base-graph walk r1-c1-r2-c2-r3-c3-r4-c4-r1 with
//   * consecutive node distinctness (r_t != r_{t+1}, c_t != c_{t+1},
//     cyclically) — non-backtracking,
//   * total alternating shift sum == 0 mod Z (the walk closes), and
//   * for the *non-consecutive* repeats the base graph allows at
//     length 8 (r1==r3, r2==r4, c1==c3, c2==c4): the partial sums at
//     the two visits must DIFFER mod Z, otherwise the two visits land
//     on the same lifted node and the walk decomposes into shorter
//     cycles instead of being one simple 8-cycle.
// Each accepted base tuple lifts to exactly Z ordered lifted walks
// (one per starting offset), and each simple lifted 8-cycle has
// exactly 8 ordered walks, so
//     #lifted 8-cycles == Z * (#tuples) / 8        (exact, verified
// against brute-force lifted-graph counting in tests) — including the
// doubly-wrapped 4-cycle patterns (r1==r3, r2==r4, c1==c3, c2==c4: a
// base 4-cycle whose shift sum has order exactly 2 mod Z, traversed
// twice), which produce 4 tuples and Z/2 lifted cycles.  visit() is
// called once per accepted tuple; divide accumulated totals by 8 for
// the per-base-pattern count (the same normalization as the 4-/6-cycle
// counters: lifted count / Z).
template <typename Visit>
static void enumerate_8walks(const long long* B, int mb, int nb, int Z,
                             Visit visit) {
    std::vector<std::vector<int>> row_adj(mb), col_adj(nb);
    for (int i = 0; i < mb; ++i)
        for (int j = 0; j < nb; ++j)
            if (B[(size_t)i * nb + j] >= 0) {
                row_adj[i].push_back(j);
                col_adj[j].push_back(i);
            }
    auto S = [&](int i, int j) { return B[(size_t)i * nb + j]; };
    for (int r1 = 0; r1 < mb; ++r1)
      for (int c1 : row_adj[r1])
        for (int r2 : col_adj[c1]) {
          if (r2 == r1) continue;
          // p: partial alternating sums at each visited node (mod Z)
          long long p2 = ((S(r1, c1) - S(r2, c1)) % Z + Z) % Z;
          for (int c2 : row_adj[r2]) {
            if (c2 == c1) continue;
            long long p3 = (p2 + S(r2, c2)) % Z;
            for (int r3 : col_adj[c2]) {
              if (r3 == r2) continue;
              long long p4 = ((p3 - S(r3, c2)) % Z + Z) % Z;
              if (r3 == r1 && p4 == 0) continue;  // same lifted row node
              for (int c3 : row_adj[r3]) {
                if (c3 == c2) continue;
                long long p5 = (p4 + S(r3, c3)) % Z;
                if (c3 == c1 && p5 == (S(r1, c1) % Z)) continue;
                for (int r4 : col_adj[c3]) {
                  if (r4 == r3 || r4 == r1) continue;
                  long long p6 = ((p5 - S(r4, c3)) % Z + Z) % Z;
                  if (r4 == r2 && p6 == p2) continue;
                  for (int c4 : row_adj[r4]) {
                    if (c4 == c3 || c4 == c1) continue;
                    if (S(r1, c4) < 0) continue;
                    long long p7 = (p6 + S(r4, c4)) % Z;
                    if (c4 == c2 && p7 == p3) continue;
                    long long tot = ((p7 - S(r1, c4)) % Z + Z) % Z;
                    if (tot != 0) continue;
                    visit(c1, c2, c3, c4);
                  }
                }
              }
            }
          }
        }
}

extern "C" {

// Raw accepted-tuple count: #lifted 8-cycles == Z * raw / 8 exactly.
// Callers divide by 8 for the per-base-pattern count (may floor a
// half-pattern from doubly-wrapped 4-cycles); use raw for existence.
long long qc_count_8cycles_raw(const long long* B, int mb, int nb, int Z) {
    long long raw = 0;
    enumerate_8walks(B, mb, nb, Z,
                     [&](int, int, int, int) { ++raw; });
    return raw;
}

// ACE-weighted 8-cycle cost (same weighting family as qc_ace6_cost):
// each 8-cycle contributes 2^-(sum of the 4 visited column degrees - 8),
// so cycles confined to low-degree variable nodes dominate.  A repeated
// base column is visited twice by distinct lifted nodes of equal degree
// and contributes twice, as the ACE definition requires.
double qc_ace8_cost(const long long* B, int mb, int nb, int Z,
                    const long long* colw) {
    double raw = 0.0;
    enumerate_8walks(B, mb, nb, Z, [&](int c1, int c2, int c3, int c4) {
        long long ace = colw[c1] + colw[c2] + colw[c3] + colw[c4] - 8;
        if (ace > 40) ace = 40;
        raw += std::ldexp(1.0, (int)-ace);
    });
    return raw / 8.0;
}

// ---------------------------------------------------------------------
// Bit-packed GF(2) linear algebra (uint8 in/out, uint64 words inside)
// ---------------------------------------------------------------------

namespace {
struct PackedMat {
    int rows, cols, words;
    std::vector<uint64_t> data;  // row-major, cols packed into words

    PackedMat(int r, int c) : rows(r), cols(c), words((c + 63) / 64),
                              data((size_t)r * words, 0) {}

    uint64_t* row(int r) { return data.data() + (size_t)r * words; }
    int get(int r, int c) const {
        return (data[(size_t)r * words + c / 64] >> (c % 64)) & 1;
    }
    void set(int r, int c, int v) {
        uint64_t& w = data[(size_t)r * words + c / 64];
        uint64_t m = 1ULL << (c % 64);
        if (v) w |= m; else w &= ~m;
    }
    void xor_row(int dst, int src) {
        uint64_t* d = row(dst);
        uint64_t* s = row(src);
        for (int w = 0; w < words; ++w) d[w] ^= s[w];
    }
    void swap_rows(int a, int b) {
        if (a == b) return;
        uint64_t* pa = row(a);
        uint64_t* pb = row(b);
        for (int w = 0; w < words; ++w) std::swap(pa[w], pb[w]);
    }
};

PackedMat pack(const uint8_t* M, int rows, int cols) {
    PackedMat p(rows, cols);
    for (int r = 0; r < rows; ++r)
        for (int c = 0; c < cols; ++c)
            if (M[(size_t)r * cols + c] & 1) p.set(r, c, 1);
    return p;
}

void unpack(PackedMat& p, uint8_t* out) {
    for (int r = 0; r < p.rows; ++r)
        for (int c = 0; c < p.cols; ++c)
            out[(size_t)r * p.cols + c] = (uint8_t)p.get(r, c);
}

// returns rank; pivots written to pivot_cols (size >= rows) if non-null
int row_reduce(PackedMat& p, int* pivot_cols) {
    int r = 0;
    for (int c = 0; c < p.cols && r < p.rows; ++c) {
        int pr = -1;
        for (int i = r; i < p.rows; ++i)
            if (p.get(i, c)) { pr = i; break; }
        if (pr < 0) continue;
        p.swap_rows(r, pr);
        for (int i = 0; i < p.rows; ++i)
            if (i != r && p.get(i, c)) p.xor_row(i, r);
        if (pivot_cols) pivot_cols[r] = c;
        ++r;
    }
    return r;
}
}  // namespace

int gf2_rank(const uint8_t* M, int rows, int cols) {
    PackedMat p = pack(M, rows, cols);
    return row_reduce(p, nullptr);
}

// rref of M written to out (same shape); returns rank
int gf2_row_reduce(const uint8_t* M, int rows, int cols, uint8_t* out) {
    PackedMat p = pack(M, rows, cols);
    int rank = row_reduce(p, nullptr);
    unpack(p, out);
    return rank;
}

// out = inverse of square M; returns 0 on success, -1 if singular
int gf2_inv(const uint8_t* M, int n, uint8_t* out) {
    PackedMat aug(n, 2 * n);
    for (int r = 0; r < n; ++r) {
        for (int c = 0; c < n; ++c)
            if (M[(size_t)r * n + c] & 1) aug.set(r, c, 1);
        aug.set(r, n + r, 1);
    }
    std::vector<int> pivots(n, -1);
    int rank = row_reduce(aug, pivots.data());
    if (rank != n) return -1;
    for (int r = 0; r < n; ++r)
        if (pivots[r] != r) return -1;
    for (int r = 0; r < n; ++r)
        for (int c = 0; c < n; ++c)
            out[(size_t)r * n + c] = (uint8_t)aug.get(r, n + c);
    return 0;
}

// parity map M (m x k) with p = M u for H = [A | B]; 0 on success
int gf2_parity_map(const uint8_t* H, int m, int n, uint8_t* out) {
    int k = n - m;
    if (k <= 0) return -2;
    // augment [B | A]; reduce; if B -> I then right part is B^-1 A
    PackedMat aug(m, n);
    for (int r = 0; r < m; ++r) {
        for (int c = 0; c < m; ++c)
            if (H[(size_t)r * n + k + c] & 1) aug.set(r, c, 1);
        for (int c = 0; c < k; ++c)
            if (H[(size_t)r * n + c] & 1) aug.set(r, m + c, 1);
    }
    std::vector<int> pivots(m, -1);
    int rank = row_reduce(aug, pivots.data());
    if (rank != m) return -1;
    for (int r = 0; r < m; ++r)
        if (pivots[r] != r) return -1;
    for (int r = 0; r < m; ++r)
        for (int c = 0; c < k; ++c)
            out[(size_t)r * k + c] = (uint8_t)aug.get(r, m + c);
    return 0;
}

}  // extern "C"
