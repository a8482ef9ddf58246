// Native host-side plan engine for superbblas_tpu.
//
// The reference library's distribution layer spends host time computing
// box-intersection communication plans over all rank pairs
// (get_indices_to_send / get_indices_to_receive, dist.h:1789-1852, and
// the hole subtraction dist.h:3745-3828 — all C++ there).  The JAX
// rebuild keeps the same split: device work is XLA/Pallas, but plan
// construction is native.  This translation-unit implements toroidal
// interval/box intersection and subtraction and the full (src, dst)
// fragment sweep; Python binds it with ctypes and falls back to the
// pure-Python implementation when the shared library is unavailable.
//
// All coordinates are int64; boxes are (from[nd], size[nd]) pairs over a
// periodic lattice dim[nd].  Fragments are emitted as
// (src_rank, dst_rank, from[nd], size[nd]) rows.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using i64 = long long;

struct Interval {
    i64 from, size;
};

// Toroidal overlap pieces of two 1-D intervals (up to 2).
static int intersect_interval(i64 f0, i64 s0, i64 f1, i64 s1, i64 dim,
                              Interval out[2]) {
    if (s0 <= 0 || s1 <= 0 || dim <= 0) return 0;
    if (s0 >= dim && s1 >= dim) {
        out[0] = {((f1 % dim) + dim) % dim, s0 < s1 ? s0 : s1};
        return 1;
    }
    f0 = ((f0 % dim) + dim) % dim;
    f1 = ((f1 % dim) + dim) % dim;
    // unwrap each interval into up to 2 pieces on [0, 2*dim)
    Interval p0[2], p1[2];
    int n0 = 1, n1 = 1;
    if (f0 + s0 <= dim) {
        p0[0] = {f0, s0};
    } else {
        p0[0] = {f0, dim - f0};
        p0[1] = {0, s0 - (dim - f0)};
        n0 = 2;
    }
    if (f1 + s1 <= dim) {
        p1[0] = {f1, s1};
    } else {
        p1[0] = {f1, dim - f1};
        p1[1] = {0, s1 - (dim - f1)};
        n1 = 2;
    }
    // wrapped x wrapped pairs can yield up to 4 LINEAR pieces; they
    // coalesce (linearly and across the wrap seam) into <= 2 toroidal
    // arcs.  Collect all, then merge — truncating at 2 before merging
    // silently dropped fragments (full-extent wrapped destinations).
    Interval tmp[4];
    int n = 0;
    for (int a = 0; a < n0; ++a) {
        for (int b = 0; b < n1; ++b) {
            i64 lo = p0[a].from > p1[b].from ? p0[a].from : p1[b].from;
            i64 hi0 = p0[a].from + p0[a].size;
            i64 hi1 = p1[b].from + p1[b].size;
            i64 hi = hi0 < hi1 ? hi0 : hi1;
            if (hi > lo) {
                bool dup = false;
                for (int k = 0; k < n; ++k)
                    if (tmp[k].from == lo % dim && tmp[k].size == hi - lo)
                        dup = true;
                if (!dup && n < 4) tmp[n++] = {lo % dim, hi - lo};
            }
        }
    }
    // sort by start
    for (int i = 0; i < n; ++i)
        for (int j = i + 1; j < n; ++j)
            if (tmp[j].from < tmp[i].from) std::swap(tmp[i], tmp[j]);
    // Only when more than 2 pieces arise (wrapped x wrapped), coalesce:
    // the result is then guaranteed to reduce to <= 2 toroidal arcs.
    // For <= 2 pieces keep the decomposition bit-identical to the
    // Python box algebra.
    while (n > 2) {
        bool merged_any = false;
        // linearly adjacent pieces
        for (int i = 0; i + 1 < n && n > 2; ++i) {
            if (tmp[i].from + tmp[i].size == tmp[i + 1].from) {
                tmp[i].size += tmp[i + 1].size;
                for (int j = i + 1; j + 1 < n; ++j) tmp[j] = tmp[j + 1];
                n -= 1;
                merged_any = true;
            }
        }
        // across the wrap seam (last ends at dim, first starts at 0)
        if (n > 2 && tmp[0].from == 0 &&
            tmp[n - 1].from + tmp[n - 1].size == dim) {
            tmp[n - 1].size += tmp[0].size;
            for (int i = 0; i + 1 < n; ++i) tmp[i] = tmp[i + 1];
            n -= 1;
            merged_any = true;
        }
        if (!merged_any) break;
    }
    int cnt = 0;
    for (int i = 0; i < n && cnt < 2; ++i) out[cnt++] = tmp[i];
    return cnt;
}

// Split toroidal interval (f0, s0) into pieces outside (kept) / inside
// (removed) interval (f1, s1); kept + removed exactly tile (f0, s0).
// When both intervals wrap, the overlap is TWO disjoint toroidal arcs —
// both must be returned (matches parallel/partition.py interval_split).
static void interval_split(i64 f0, i64 s0, i64 f1, i64 s1, i64 dim,
                           std::vector<Interval> &kept,
                           std::vector<Interval> &removed) {
    if (s0 <= 0) return;
    if (s1 <= 0) {
        kept.push_back({dim > 0 ? ((f0 % dim) + dim) % dim : 0, s0});
        return;
    }
    f0 = ((f0 % dim) + dim) % dim;
    i64 h = (((f1 - f0) % dim) + dim) % dim;  // hole start in offset space
    // holes in offset space [0, s0): [h, h+s1) and wrapped part
    struct Piece {
        i64 a, b;
    };
    std::vector<Piece> keep{{0, s0}};
    std::vector<Piece> rem;
    Piece holes[2];
    int nh = 0;
    i64 first = s1 < dim - h ? s1 : dim - h;
    holes[nh++] = {h, h + first};
    if (s1 > dim - h) holes[nh++] = {0, s1 - (dim - h)};
    for (int hi = 0; hi < nh; ++hi) {
        std::vector<Piece> next;
        for (auto &k : keep) {
            i64 lo = k.a > holes[hi].a ? k.a : holes[hi].a;
            i64 up = k.b < holes[hi].b ? k.b : holes[hi].b;
            if (up <= lo) {
                next.push_back(k);
            } else {
                if (lo > k.a) next.push_back({k.a, lo});
                rem.push_back({lo, up});
                if (k.b > up) next.push_back({up, k.b});
            }
        }
        keep.swap(next);
    }
    for (auto &k : keep) kept.push_back({(f0 + k.a) % dim, k.b - k.a});
    for (auto &r : rem) removed.push_back({(f0 + r.a) % dim, r.b - r.a});
}

struct Box {
    std::vector<i64> from, size;
};

static bool empty_box(const Box &b) {
    for (auto s : b.size)
        if (s <= 0) return true;
    return b.size.empty();
}

// N-D toroidal intersection: cartesian product of per-axis overlaps.
static void intersect_box(const Box &a, const Box &b, const i64 *dim, int nd,
                          std::vector<Box> &out) {
    std::vector<std::vector<Interval>> per(nd);
    for (int i = 0; i < nd; ++i) {
        Interval tmp[2];
        int n = intersect_interval(a.from[i], a.size[i], b.from[i], b.size[i],
                                   dim[i], tmp);
        if (n == 0) return;
        per[i].assign(tmp, tmp + n);
    }
    std::vector<int> idx(nd, 0);
    while (true) {
        Box r;
        r.from.resize(nd);
        r.size.resize(nd);
        for (int i = 0; i < nd; ++i) {
            r.from[i] = per[i][idx[i]].from;
            r.size[i] = per[i][idx[i]].size;
        }
        out.push_back(std::move(r));
        int ax = nd - 1;
        while (ax >= 0 && ++idx[ax] == (int)per[ax].size()) idx[ax--] = 0;
        if (ax < 0) break;
    }
}

// box \ hole -> disjoint boxes (slab decomposition, same scheme as the
// Python box_minus).  Per axis: kept pieces are emitted with the other
// axes unchanged; EVERY inside piece recurses to the next axis (the
// wrapped x wrapped overlap is two disjoint arcs — following only the
// biggest silently dropped the remainder under the other arc).
static void box_minus_rec(const Box &cur, const Box &hole, const i64 *dim,
                          int nd, int ax, std::vector<Box> &out) {
    if (ax == nd) return;  // inside the hole on every axis: subtracted.
    std::vector<Interval> kept, removed;
    interval_split(cur.from[ax], cur.size[ax], hole.from[ax], hole.size[ax],
                   dim[ax], kept, removed);
    for (auto &p : kept) {
        Box b = cur;
        b.from[ax] = p.from;
        b.size[ax] = p.size;
        out.push_back(std::move(b));
    }
    for (auto &p : removed) {
        Box b = cur;
        b.from[ax] = p.from;
        b.size[ax] = p.size;
        box_minus_rec(b, hole, dim, nd, ax + 1, out);
    }
}

static void box_minus(const Box &box, const Box &hole, const i64 *dim, int nd,
                      std::vector<Box> &out) {
    if (empty_box(box)) return;
    box_minus_rec(box, hole, dim, nd, 0, out);
}

}  // namespace

extern "C" {

// Compute the full (src, dst) fragment plan.
//   src_boxes, dst_boxes: [n, 2, nd] int64 (from, size per rank)
//   dim: [nd], copy_mode: 0 = copy (first cover wins), 1 = add (all)
// Two-phase: call with frags == nullptr to get the row count; then with a
// buffer of shape [count, 2 + 2*nd].
long long sbt_fragment_plan(const long long *src_boxes,
                            const long long *dst_boxes, long long n,
                            const long long *dim, long long nd,
                            long long copy_mode, long long *frags,
                            long long cap) {
    i64 count = 0;
    auto get_box = [nd](const i64 *base, i64 r) {
        Box b;
        b.from.assign(base + r * 2 * nd, base + r * 2 * nd + nd);
        b.size.assign(base + r * 2 * nd + nd, base + r * 2 * nd + 2 * nd);
        return b;
    };
    for (i64 j = 0; j < n; ++j) {
        Box dst = get_box(dst_boxes, j);
        if (empty_box(dst)) continue;
        std::vector<Box> remaining{dst};
        for (i64 i = 0; i < n; ++i) {
            Box src = get_box(src_boxes, i);
            if (empty_box(src)) continue;
            std::vector<Box> found;
            if (copy_mode == 0) {
                std::vector<Box> next;
                for (auto &r : remaining) {
                    intersect_box(r, src, dim, (int)nd, found);
                    box_minus(r, src, dim, (int)nd, next);
                }
                remaining.swap(next);
            } else {
                intersect_box(dst, src, dim, (int)nd, found);
            }
            for (auto &f : found) {
                if (empty_box(f)) continue;
                if (frags) {
                    if (count >= cap) return -1;
                    i64 *row = frags + count * (2 + 2 * nd);
                    row[0] = i;
                    row[1] = j;
                    for (int k = 0; k < nd; ++k) {
                        row[2 + k] = f.from[k];
                        row[2 + nd + k] = f.size[k];
                    }
                }
                ++count;
            }
        }
    }
    return count;
}

// Batch toroidal box intersection (vectorized primitive for tests /
// storage index lookups): boxes_a [na, 2, nd] x boxes_b [nb, 2, nd].
long long sbt_intersect_all(const long long *boxes_a, long long na,
                            const long long *boxes_b, long long nb,
                            const long long *dim, long long nd,
                            long long *out, long long cap) {
    i64 count = 0;
    for (i64 a = 0; a < na; ++a) {
        Box ba;
        ba.from.assign(boxes_a + a * 2 * nd, boxes_a + a * 2 * nd + nd);
        ba.size.assign(boxes_a + a * 2 * nd + nd, boxes_a + a * 2 * nd + 2 * nd);
        for (i64 b = 0; b < nb; ++b) {
            Box bb;
            bb.from.assign(boxes_b + b * 2 * nd, boxes_b + b * 2 * nd + nd);
            bb.size.assign(boxes_b + b * 2 * nd + nd,
                           boxes_b + b * 2 * nd + 2 * nd);
            std::vector<Box> found;
            intersect_box(ba, bb, dim, (int)nd, found);
            for (auto &f : found) {
                if (empty_box(f)) continue;
                if (out) {
                    if (count >= cap) return -1;
                    i64 *row = out + count * (2 + 2 * nd);
                    row[0] = a;
                    row[1] = b;
                    for (int k = 0; k < nd; ++k) {
                        row[2 + k] = f.from[k];
                        row[2 + nd + k] = f.size[k];
                    }
                }
                ++count;
            }
        }
    }
    return count;
}

}  // extern "C"
