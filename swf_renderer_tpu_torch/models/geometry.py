"""Geometry lowering: styled paths -> flat, dense edge tables.

This layer goes further than the reference (which replays path commands into
Cairo, reference ts/src/lib/renderers/canvas-renderer.ts:269-290): it flattens
quadratic curves and expands strokes host-side, producing padded ``(E, 4)``
float32 edge tables in *device* (pixel) space.  Those dense tables are what
the Pallas coverage kernel consumes — the TPU-native replacement for Cairo's
scanline fill (canvas-renderer.ts:335) and for the reference Rust lyon
tessellation (rs/src/renderer.rs:24-64).

Conventions:
* All transforms are Canvas2D-style affines ``(a, b, c, d, e, f)``:
  ``x' = a x + c y + e``, ``y' = b x + d y + f``.
* Fills implicitly close every subpath (Canvas2D ``fill()`` semantics).
* Strokes do NOT implicitly close; open ends get caps.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import ir

TWIPS_PER_PX = 20.0


@dataclasses.dataclass(frozen=True)
class Affine:
    """Canvas2D affine transform (a, b, c, d, e, f)."""

    a: float = 1.0
    b: float = 0.0
    c: float = 0.0
    d: float = 1.0
    e: float = 0.0
    f: float = 0.0

    @staticmethod
    def identity() -> "Affine":
        return Affine()

    @staticmethod
    def scaling(sx: float, sy: float) -> "Affine":
        return Affine(a=sx, d=sy)

    @staticmethod
    def translation(tx: float, ty: float) -> "Affine":
        return Affine(e=tx, f=ty)

    @staticmethod
    def from_swf_matrix(m) -> "Affine":
        return Affine(*m.to_affine())

    def then(self, other: "Affine") -> "Affine":
        """Return ``self ∘ other`` — apply ``other`` first, then ``self``.

        Matches ``ctx.transform(other)`` applied on a CTM of ``self``."""
        return Affine(
            a=self.a * other.a + self.c * other.b,
            b=self.b * other.a + self.d * other.b,
            c=self.a * other.c + self.c * other.d,
            d=self.b * other.c + self.d * other.d,
            e=self.a * other.e + self.c * other.f + self.e,
            f=self.b * other.e + self.d * other.f + self.f,
        )

    def apply(self, pts: np.ndarray) -> np.ndarray:
        """Transform an (N, 2) point array."""
        pts = np.asarray(pts, dtype=np.float64)
        x = self.a * pts[..., 0] + self.c * pts[..., 1] + self.e
        y = self.b * pts[..., 0] + self.d * pts[..., 1] + self.f
        return np.stack([x, y], axis=-1)

    def inverse(self) -> "Affine":
        det = self.a * self.d - self.b * self.c
        if abs(det) < 1e-12:
            raise ValueError("singular transform")
        ia = self.d / det
        ib = -self.b / det
        ic = -self.c / det
        id_ = self.a / det
        ie = -(ia * self.e + ic * self.f)
        if_ = -(ib * self.e + id_ * self.f)
        return Affine(ia, ib, ic, id_, ie, if_)

    def max_scale(self) -> float:
        """Upper bound on length scaling (for flatness tolerances)."""
        return math.sqrt(
            max(self.a * self.a + self.b * self.b, self.c * self.c + self.d * self.d)
        ) * math.sqrt(2.0)

    def norm2(self) -> float:
        """EXACT largest singular value of the linear part (the true
        length-scaling factor — max_scale is a looser sqrt(2) bound kept
        for the tolerances the golden ratchets were tuned under)."""
        f = (self.a * self.a + self.b * self.b
             + self.c * self.c + self.d * self.d)
        g = math.hypot(
            self.a * self.a + self.b * self.b
            - self.c * self.c - self.d * self.d,
            2.0 * (self.a * self.c + self.b * self.d))
        return math.sqrt(max(0.0, (f + g) / 2.0))

    def as_tuple(self) -> Tuple[float, float, float, float, float, float]:
        return (self.a, self.b, self.c, self.d, self.e, self.f)


# Production curve-flattening tolerance (device px).  Round 5 calibrated
# 0.1 -> 0.075 against the hb29 morph goldens: the finer setting bumps
# exactly the curves whose ceil(sqrt(dev/4tol)) sits just under a pow2
# boundary (hb29's left-border curve: n 8 -> 16), dropping pm-max 22 ->
# 17 at ALL three ratios with zero change on the other four corpus
# samples (tools/exp_role_tol.py round-5 study; pm >2 frac trades
# 0.0093 -> 0.0115 at ratio 1.0 only).  x0.9 is a no-op and x0.6
# regresses — the optimum is the measured plateau [0.7, 0.8].
CURVE_TOLERANCE = 0.075


def quad_subdivisions(
    p0: np.ndarray, ctrl: np.ndarray, p1: np.ndarray, tolerance: float,
    pow2: bool = False,
) -> int:
    """Number of uniform-`t` line segments so a quadratic stays within
    ``tolerance`` of its polyline.

    The curve's second derivative is ``2 (p0 - 2c + p1)``; the max deviation
    of an n-piece uniform subdivision from its chords is
    ``|p0 - 2c + p1| / (4 n^2)``.  ``pow2`` rounds the count up to a power
    of two — RECURSIVE-MIDPOINT semantics, matching the Flash player's
    flattening (measured on the morph golden: pow2 at tolerance 0.1 px
    halves the >2/255 pixel fraction vs any uniform-count tolerance)."""
    dev = np.hypot(*(p0 - 2.0 * ctrl + p1))
    if dev <= 4.0 * tolerance:
        return 1
    n = int(math.ceil(math.sqrt(dev / (4.0 * tolerance))))
    if pow2 and n > 1:
        n = 1 << (n - 1).bit_length()
    return n


def flatten_quad(
    p0: np.ndarray, ctrl: np.ndarray, p1: np.ndarray, n: int
) -> np.ndarray:
    """Evaluate the quadratic at uniform t (excluding t=0), shape (n, 2)."""
    t = (np.arange(1, n + 1, dtype=np.float64) / n)[:, None]
    omt = 1.0 - t
    return omt * omt * p0 + 2.0 * omt * t * ctrl + t * t * p1


def path_to_subpaths(
    commands: Sequence[ir.Command],
    transform: Affine,
    tolerance: float = 0.1,
    pow2: bool = False,
) -> List[np.ndarray]:
    """Replay MoveTo/LineTo/CurveTo into device-space polylines.

    Curves are flattened adaptively with ``tolerance`` in device pixels
    (transform applied to control points first; affine maps commute with
    Bezier evaluation).  Returns a list of (K, 2) float arrays.
    """
    subpaths: List[np.ndarray] = []
    current: List[np.ndarray] = []
    pos = np.zeros(2)

    def flush():
        nonlocal current
        if len(current) >= 2:
            subpaths.append(np.asarray(current))
        current = []

    for cmd in commands:
        if isinstance(cmd, ir.MoveTo):
            flush()
            pos = transform.apply(np.array([cmd.x, cmd.y], dtype=np.float64))
            current = [pos]
        elif isinstance(cmd, ir.LineTo):
            end = transform.apply(np.array([cmd.end_x, cmd.end_y], dtype=np.float64))
            if not current:
                current = [pos]
            current.append(end)
            pos = end
        elif isinstance(cmd, ir.CurveTo):
            ctrl = transform.apply(
                np.array([cmd.control_x, cmd.control_y], dtype=np.float64)
            )
            end = transform.apply(np.array([cmd.end_x, cmd.end_y], dtype=np.float64))
            if not current:
                current = [pos]
            n = quad_subdivisions(pos, ctrl, end, tolerance, pow2)
            current.extend(flatten_quad(pos, ctrl, end, n))
            pos = end
        else:
            raise ValueError(f"UnexpectedCommand: {cmd!r}")
    flush()
    return subpaths


def subpaths_to_fill_edges(subpaths: Sequence[np.ndarray]) -> np.ndarray:
    """Edge table for filling: every polyline edge plus the implicit closing
    edge of each subpath (Canvas2D ``fill()`` closes subpaths)."""
    rows: List[np.ndarray] = []
    for pts in subpaths:
        if len(pts) < 2:
            continue
        seg = np.concatenate([pts[:-1], pts[1:]], axis=1)  # (K-1, 4)
        rows.append(seg)
        if not np.array_equal(pts[0], pts[-1]):
            rows.append(np.concatenate([pts[-1], pts[0]])[None, :])
    if not rows:
        return np.zeros((0, 4), dtype=np.float32)
    return np.concatenate(rows, axis=0).astype(np.float32)


# ---------------------------------------------------------------------------
# Stroke expansion
# ---------------------------------------------------------------------------


def _orient_ccw(poly: np.ndarray) -> np.ndarray:
    """Normalize a closed polygon to positive signed area so that stroke
    pieces reinforce (winding +1) instead of canceling where they overlap."""
    x, y = poly[:, 0], poly[:, 1]
    area2 = np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y)
    return poly if area2 >= 0 else poly[::-1]


def _arc_points(
    center: np.ndarray, radius: float, a0: float, a1: float, tolerance: float
) -> np.ndarray:
    """Polygonize an arc from angle a0 to a1 (shorter way respecting sign)."""
    sweep = a1 - a0
    max_step = 2.0 * math.acos(max(0.0, 1.0 - tolerance / max(radius, 1e-6)))
    n = max(1, int(math.ceil(abs(sweep) / max(max_step, 1e-3))))
    angles = a0 + sweep * np.arange(0, n + 1) / n
    return center + radius * np.stack([np.cos(angles), np.sin(angles)], axis=-1)


def _outer_join_points(p, a, b, h: float, join: str, miter_limit: float,
                       tolerance: float) -> List[np.ndarray]:
    """Points connecting offset point ``a`` to ``b`` around vertex ``p`` on
    the OUTER side of a turn (both at distance h from p), inclusive of a
    and b."""
    if join == "round":
        a0 = math.atan2(a[1] - p[1], a[0] - p[0])
        a1 = math.atan2(b[1] - p[1], b[0] - p[0])
        sweep = (a1 - a0 + math.pi) % (2.0 * math.pi) - math.pi
        return list(_arc_points(p, h, a0, a0 + sweep, tolerance))
    if join == "miter":
        va, vb = a - p, b - p
        # The miter tip is the intersection of the two offset LINES
        # (parallel to the segments at distance h): along the normal
        # bisector at distance h / cos(phi/2), phi = angle between the
        # offset normals va, vb (equivalently h / sin(theta/2), theta =
        # interior segment angle).  The Canvas2D miter-limit gate is
        # miterLength / lineWidth = 1 / sin(theta/2) <= limit.
        dot = float(np.dot(va, vb)) / max(h * h, 1e-12)
        cos_half = math.sqrt(max(0.0, (1.0 + dot) / 2.0))
        if cos_half > 1e-9 and 1.0 / cos_half <= miter_limit:
            bis = va + vb
            norm = np.hypot(*bis)
            if norm > 1e-12:
                tip = p + bis / norm * (h / cos_half)
                return [a, tip, b]
        return [a, b]  # miter-limit fallback: bevel
    return [a, b]  # bevel


def stroke_subpath(
    pts: np.ndarray,
    width: float,
    cap: str = "butt",
    join: str = "miter",
    miter_limit: float = 10.0,
    tolerance: float = 0.1,
) -> List[np.ndarray]:
    """Expand one polyline into its stroke OUTLINE loops.

    One closed loop per open subpath (left offsets forward, end cap, right
    offsets backward, start cap); two loops for a closed subpath (offset
    ring on each side, the inner one reversed so the hole's winding
    cancels).  Unlike a union of per-segment quads + join wedges, the
    outline has no internal seams, so the analytic-coverage rasterizer
    never conflates overlapping pieces inside an antialiased pixel (a
    union's seam pixels over-count: winding INTEGRATES across the pixel
    before the fill rule clamps).  Inner joins insert the path vertex
    itself (a -> p -> b) so the fold stays covered — the same device Cairo
    and Skia strokers use.
    Canvas2D defaults: butt cap + miter join (limit 10); the reference's
    morph strokes use round/round (canvas-renderer.ts:263-264).
    """
    # Drop zero-length segments.
    keep = [0]
    for i in range(1, len(pts)):
        if np.hypot(*(pts[i] - pts[keep[-1]])) > 1e-9:
            keep.append(i)
    pts = pts[keep]
    h = width / 2.0
    polys: List[np.ndarray] = []
    if len(pts) < 2:
        # Degenerate subpath: Canvas draws a dot only for round caps.
        if len(pts) == 1 and cap == "round" and h > 0:
            circle = _arc_points(pts[0], h, 0.0, 2.0 * math.pi, tolerance)
            polys.append(_orient_ccw(circle[:-1]))
        return polys

    closed = len(pts) >= 4 and np.hypot(*(pts[0] - pts[-1])) < 1e-9
    if closed:
        pts = pts[:-1]

    d = (np.concatenate([pts[1:], pts[:1]]) - pts) if closed \
        else pts[1:] - pts[:-1]
    lengths = np.hypot(d[:, 0], d[:, 1])
    units = d / lengths[:, None]
    normals = np.stack([-units[:, 1], units[:, 0]], axis=-1) * h

    def vertex_conn(out: List[np.ndarray], p, i_prev: int, i_next: int,
                    sign: float) -> None:
        u0, u1 = units[i_prev], units[i_next]
        a = p + sign * normals[i_prev]
        b = p + sign * normals[i_next]
        cross = u0[0] * u1[1] - u0[1] * u1[0]
        if abs(cross) < 1e-12 and float(np.dot(u0, u1)) > 0:
            out.append(b)  # collinear: offsets coincide
        elif abs(cross) < 1e-12:
            # EXACT 180-degree reversal: neither side is the outer turn
            # (cross == 0), but a round join must still emit the
            # half-disk beyond the vertex (Canvas joins are the
            # Minkowski disk at the vertex; miter/bevel degenerate to
            # nothing here).  Emit the half-arc through the forward
            # "nose" p + h*u0 on the sign=+1 pass; the other side
            # routes through the vertex as an inner join.
            if join == "round" and sign > 0:
                a0 = math.atan2(a[1] - p[1], a[0] - p[0])
                out.extend(_arc_points(p, h, a0, a0 - sign * math.pi,
                                       tolerance))
            else:
                out.extend([a, p, b])
        elif sign * cross < 0:  # this side is the turn's OUTER side
            out.extend(_outer_join_points(p, a, b, h, join, miter_limit,
                                          tolerance))
        else:  # inner side: route through the vertex to keep it covered
            out.extend([a, p, b])

    if closed:
        # Two concentric rings; the inner traversed backward so the hole's
        # winding cancels ((+1) + (-1) = 0) while the band keeps |w| = 1.
        loops = []
        for sign in (1.0, -1.0):
            ring: List[np.ndarray] = []
            for i in range(len(pts)):
                vertex_conn(ring, pts[i], i - 1, i, sign)
            loops.append(np.asarray(ring))
        return [loops[0], loops[1][::-1]]

    def side_chain(sign: float) -> List[np.ndarray]:
        out = [pts[0] + sign * normals[0]]
        for i in range(1, len(pts) - 1):
            vertex_conn(out, pts[i], i - 1, i, sign)
        out.append(pts[-1] + sign * normals[-1])
        return out

    left = side_chain(1.0)
    right = side_chain(-1.0)
    u_end, u_start = units[-1], units[0]
    n_end, n_start = normals[-1], normals[0]
    end_cap: List[np.ndarray] = []
    start_cap: List[np.ndarray] = []
    if h > 0:
        if cap == "round":
            a0 = math.atan2(n_end[1], n_end[0])
            end_cap = list(_arc_points(pts[-1], h, a0, a0 - math.pi,
                                       tolerance))[1:-1]
            a0 = math.atan2(-n_start[1], -n_start[0])
            start_cap = list(_arc_points(pts[0], h, a0, a0 - math.pi,
                                         tolerance))[1:-1]
        elif cap == "square":
            end_cap = [pts[-1] + n_end + u_end * h,
                       pts[-1] - n_end + u_end * h]
            start_cap = [pts[0] - n_start - u_start * h,
                         pts[0] + n_start - u_start * h]
    loop = left + end_cap + right[::-1] + start_cap
    return [np.asarray(loop)]


def deoverlap_edges(edges: np.ndarray, max_edges: int = 20000) -> np.ndarray:
    """Replace an overlapping edge soup by the BOUNDARY of its nonzero-
    winding region (a Boolean union), so the analytic-coverage rasterizer
    stops conflating overlaps inside antialiased pixels.

    The device pipeline integrates winding across each pixel BEFORE the
    fill rule clamps, so two overlapping loops crossing an AA pixel count
    twice (a union's seam pixel can reach winding-integral ~1.0 where the
    true covered fraction is ~0.65 — measured on homestuck-beta-1's 3 px
    strokes, whose self-overlapping outline is exactly this case; Cairo
    clamps per sub-span and renders the union).  De-overlapping host-side
    keeps the kernel unchanged: split every edge at its pairwise
    intersections, keep the fragments with interior (winding != 0) on
    exactly one side, oriented interior-left, and the soup's nonzero
    coverage becomes exact union coverage.

    O(E^2) pairwise work, computed in row blocks of 512 edges so the
    float64 intermediates stay O(block * E) (~80 MB at the 20000-edge
    cap); inputs beyond ``max_edges`` are returned unchanged (conflation
    is the lesser evil at that scale)."""
    e = np.asarray(edges, np.float64)
    n = e.shape[0]
    if n == 0 or n > max_edges:
        return np.asarray(edges, np.float32)
    p0, p1 = e[:, :2], e[:, 2:]
    d = p1 - p0
    eps = 1e-9
    frags = []
    block = 512
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        db = d[lo:hi]
        # Pairwise intersections of block rows i against ALL edges j:
        # solve p0_i + t*d_i = p0_j + s*d_j.
        denom = db[:, 0][:, None] * d[None, :, 1] \
            - db[:, 1][:, None] * d[None, :, 0]
        rel = p0[None, :, :] - p0[lo:hi, None, :]
        t_num = rel[:, :, 0] * d[None, :, 1] - rel[:, :, 1] * d[None, :, 0]
        s_num = rel[:, :, 0] * db[:, None, 1] - rel[:, :, 1] * db[:, None, 0]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = t_num / denom
            s = s_num / denom
        hit = (np.abs(denom) > eps) & (t > eps) & (t < 1 - eps) \
            & (s > eps) & (s < 1 - eps)
        # COLLINEAR overlapping edges (a path retracing itself emits
        # stroke offsets on exactly the same line) never satisfy the
        # |denom| > eps transversal test, so overlapping same-line edges
        # would keep whole and the union boundary would be emitted twice
        # (double winding = non-watertight output).  Split them at each
        # other's endpoint projections so coincident geometry becomes
        # exactly-coincident fragments, collapsed to net multiplicity
        # below.
        db_len = np.hypot(db[:, 0], db[:, 1])
        d_len = np.hypot(d[:, 0], d[:, 1])
        with np.errstate(divide="ignore", invalid="ignore"):
            colin = (np.abs(denom) <= 1e-7 * db_len[:, None] * d_len[None])\
                & (np.abs(s_num) <= 1e-7 * db_len[:, None] * d_len[None]) \
                & (db_len[:, None] > 1e-12) & (d_len[None] > 1e-12)
            dot0 = (rel[:, :, 0] * db[:, None, 0]
                    + rel[:, :, 1] * db[:, None, 1]) \
                / (db_len ** 2)[:, None]
            ddot = (db[:, None, 0] * d[None, :, 0]
                    + db[:, None, 1] * d[None, :, 1]) \
                / (db_len ** 2)[:, None]
        for bi in range(hi - lo):
            i = lo + bi
            ts = t[bi][hit[bi]]
            cut_t = [ts]
            cut_p = [p0[i] + ts[:, None] * d[i]]
            cm = colin[bi]
            if cm.any():
                # Use the partner's endpoint COORDINATES as the cut
                # point (not p0 + t*d): both coincident parents then
                # fragment at bitwise-identical points, so the net-
                # multiplicity collapse below can match them exactly.
                ends = np.concatenate([p0[cm], p1[cm]])
                tp = np.concatenate([dot0[bi][cm],
                                     dot0[bi][cm] + ddot[bi][cm]])
                keep = (tp > eps) & (tp < 1 - eps)
                cut_t.append(tp[keep])
                cut_p.append(ends[keep])
            tt = np.concatenate(cut_t)
            pp = np.concatenate(cut_p)
            order = np.argsort(tt)
            pts = np.concatenate([p0[i][None], pp[order], p1[i][None]])
            seg = np.concatenate([pts[:-1], pts[1:]], axis=1)
            frags.append(seg)
    f = np.concatenate(frags, axis=0)
    lens = np.hypot(f[:, 2] - f[:, 0], f[:, 3] - f[:, 1])
    f = f[lens > 1e-12]

    # Winding just left/right of each fragment midpoint (against the
    # ORIGINAL soup — winding is well defined away from boundaries).
    mid = (f[:, :2] + f[:, 2:]) / 2.0
    fd = f[:, 2:] - f[:, :2]
    fl = np.hypot(fd[:, 0], fd[:, 1])
    nrm = np.stack([-fd[:, 1], fd[:, 0]], axis=-1) / fl[:, None]
    off = np.maximum(fl * 1e-4, 1e-7)[:, None] * nrm

    def winding_at(pts: np.ndarray) -> np.ndarray:
        # Upward-crossing signed count along the +x ray (half-open in y),
        # in point blocks so the (points x edges) temporaries stay small.
        out = np.empty(len(pts), np.int64)
        y0, y1 = e[None, :, 1], e[None, :, 3]
        x0, x1 = e[None, :, 0], e[None, :, 2]
        dy = y1 - y0
        for lo in range(0, len(pts), 1024):
            hi = min(len(pts), lo + 1024)
            x = pts[lo:hi, 0][:, None]
            y = pts[lo:hi, 1][:, None]
            with np.errstate(divide="ignore", invalid="ignore"):
                xc = x0 + (y - y0) * (x1 - x0) / dy
            up = (y0 <= y) & (y1 > y) & (xc > x)
            down = (y1 <= y) & (y0 > y) & (xc > x)
            out[lo:hi] = up.sum(axis=1) - down.sum(axis=1)
        return out

    wl = winding_at(mid + off)
    wr = winding_at(mid - off)
    on_boundary = (wl != 0) != (wr != 0)
    f = f[on_boundary]
    flip = (wl[on_boundary] == 0)  # interior must sit on the LEFT
    out = f.copy()
    out[flip] = f[flip][:, [2, 3, 0, 1]]
    # Collapse coincident fragments to their NET orientation: an exact
    # retrace's coincident parent edges each emit a copy of the same
    # boundary piece, but the union's winding crosses that line exactly
    # once — doubled copies leak half-plane winding into the output.
    # No-op (and order-preserving) when there are no coincident pieces.
    if len(out) > 1:
        a, b = out[:, :2], out[:, 2:]
        swap = (a[:, 1] > b[:, 1]) | ((a[:, 1] == b[:, 1])
                                      & (a[:, 0] > b[:, 0]))
        und = np.concatenate([np.where(swap[:, None], b, a),
                              np.where(swap[:, None], a, b)], axis=1)
        sgn = np.where(swap, -1, 1)
        # Coincident pieces from different parents can differ by an f32
        # ulp (the retraced offsets were CONSTRUCTED from different
        # points), so group with a tolerance: near-duplicates sit
        # adjacent in lexsorted undirected order.
        order = np.lexsort(und.T[::-1])
        u = und[order]
        close = np.all(np.abs(u[1:] - u[:-1]) <= 1e-5, axis=1)
        if close.any():
            gid = np.concatenate([[0], np.cumsum(~close)])
            keep_rows = []
            for g in range(int(gid[-1]) + 1):
                rows = order[gid == g]
                net = int(sgn[rows].sum())
                if net != 0:
                    want = 1 if net > 0 else -1
                    keep_rows.append(rows[sgn[rows] == want][0])
            out = out[np.sort(np.asarray(keep_rows, np.int64))]
    # SAFETY NET: the left/right winding probes misclassify when two
    # DISTINCT boundary lines sit closer than the probe offset (a
    # nearly-but-not-exactly retraced stroke) — one mis-kept or
    # mis-oriented fragment leaks half-plane winding into the output.
    # The union boundary of any region is a set of closed loops, so
    # every vertex must have balanced in/out degree (tolerance-grouped);
    # if not, fall back to the ORIGINAL soup: the engine's documented
    # integrate-then-clamp conflation is localized seam over-count,
    # never a leak.
    if len(out):
        pts_all = np.concatenate([out[:, :2], out[:, 2:]])
        deg = np.concatenate([np.ones(len(out)), -np.ones(len(out))])
        order = np.lexsort(pts_all.T[::-1])
        sp = pts_all[order]
        close = np.all(np.abs(sp[1:] - sp[:-1]) <= 1e-4, axis=1)
        gid = np.concatenate([[0], np.cumsum(~close)])
        net = np.zeros(int(gid[-1]) + 1)
        np.add.at(net, gid, deg[order])
        if np.any(net != 0):
            return np.asarray(edges, np.float32)
    return out.astype(np.float32)


def polygons_to_edges(polys: Sequence[np.ndarray]) -> np.ndarray:
    """Closed polygons -> edge table (each polygon closed explicitly)."""
    rows: List[np.ndarray] = []
    for poly in polys:
        closed = np.concatenate([poly, poly[:1]], axis=0)
        rows.append(np.concatenate([closed[:-1], closed[1:]], axis=1))
    if not rows:
        return np.zeros((0, 4), dtype=np.float32)
    return np.concatenate(rows, axis=0).astype(np.float32)


def stroke_to_edges(
    subpaths: Sequence[np.ndarray],
    width: float,
    cap: str = "butt",
    join: str = "miter",
    miter_limit: float = 10.0,
    tolerance: float = 0.1,
) -> np.ndarray:
    polys: List[np.ndarray] = []
    for pts in subpaths:
        polys.extend(
            stroke_subpath(
                pts, width, cap=cap, join=join, miter_limit=miter_limit,
                tolerance=tolerance,
            )
        )
    return polygons_to_edges(polys)


def _clip_halfplane(edges: np.ndarray, coord: int, bound: float,
                    keep_below: bool) -> np.ndarray:
    """Clip an edge soup against ``coord <= bound`` (or ``>=`` when
    ``keep_below`` is False), preserving the winding integral of the kept
    region: outside portions are PROJECTED onto the boundary line rather
    than dropped, so the clipped shape stays closed (projected segments are
    parallel to the clip line and the scanline integral never sees
    boundary-collinear geometry as interior coverage)."""
    if edges.shape[0] == 0:
        return edges
    c0 = edges[:, coord]
    c1 = edges[:, coord + 2]
    if keep_below:
        in0, in1 = c0 <= bound, c1 <= bound
    else:
        in0, in1 = c0 >= bound, c1 >= bound
    if (in0 & in1).all():
        return edges
    parts = [edges[in0 & in1]]
    both_out = ~in0 & ~in1
    if both_out.any():
        seg = edges[both_out].copy()
        seg[:, coord] = bound
        seg[:, coord + 2] = bound
        parts.append(seg)
    cross = in0 ^ in1
    if cross.any():
        ce = edges[cross]
        cc0, cc1 = ce[:, coord], ce[:, coord + 2]
        t = (bound - cc0) / (cc1 - cc0)
        oc = ce[:, 1 - coord] + t * (ce[:, 3 - coord] - ce[:, 1 - coord])
        start_in = in0[cross]
        # first: start -> crossing point, second: crossing point -> end;
        # whichever half is outside collapses onto the boundary line.
        first = ce.copy()
        first[:, coord + 2] = bound
        first[:, 3 - coord] = oc
        first[:, coord] = np.where(start_in, first[:, coord], bound)
        second = ce.copy()
        second[:, coord] = bound
        second[:, 1 - coord] = oc
        second[:, coord + 2] = np.where(start_in, bound,
                                        second[:, coord + 2])
        parts.extend([first, second])
    return np.concatenate(parts, axis=0)


def clip_edges_rect(edges: np.ndarray, width: float, height: float,
                    xmin: float = 0.0, ymin: float = 0.0) -> np.ndarray:
    """Clip an edge table to the stage rect [xmin, width] x [ymin, height].

    The Flash player clips content at the EXACT stage bounds — which are
    fractional in pixels (stage size = bounds twips / 20, e.g. 709.3 px for
    flat-shapes/homestuck-beta-1) — while the raster is the ceil'd integer
    size; border pixels are therefore only partially coverable.  The golden
    captures reflect that (alpha 72 = 255 * 0.3 at the right edge of hb1).
    """
    edges = np.asarray(edges, dtype=np.float32)
    for coord, bound, keep_below in ((0, xmin, False), (0, width, True),
                                     (1, ymin, False), (1, height, True)):
        edges = _clip_halfplane(edges, coord, float(bound), keep_below)
    return edges.astype(np.float32)


def split_edges_y(edges: np.ndarray, max_extent: float = 64.0) -> np.ndarray:
    """Split segments so every edge's |y1 - y0| <= max_extent.

    Splitting a segment at interior points leaves the coverage integral
    unchanged; it bounds each edge's vertical footprint so the banded
    coverage kernel's per-tile-row windows stay tight."""
    edges = np.asarray(edges, dtype=np.float32)
    if edges.shape[0] == 0:
        return edges
    yext = np.abs(edges[:, 3] - edges[:, 1])
    n = np.maximum(1, np.ceil(yext / max_extent).astype(int))
    if (n == 1).all():
        return edges
    rows = []
    for (x0, y0, x1, y1), k in zip(edges, n):
        if k == 1:
            rows.append([[x0, y0, x1, y1]])
        else:
            t = np.linspace(0.0, 1.0, k + 1)
            xs = x0 + t * (x1 - x0)
            ys = y0 + t * (y1 - y0)
            rows.append(np.stack([xs[:-1], ys[:-1], xs[1:], ys[1:]], axis=1))
    return np.concatenate(rows, axis=0).astype(np.float32)


def pad_edges(edges: np.ndarray, multiple: int = 128) -> np.ndarray:
    """Pad an (E, 4) edge table to a multiple of ``multiple`` rows.

    Padding rows are all-zero degenerate edges, which contribute exactly
    nothing to coverage — the kernel needs no edge count."""
    count = edges.shape[0]
    padded = max(multiple, ((count + multiple - 1) // multiple) * multiple)
    out = np.zeros((padded, 4), dtype=np.float32)
    out[:count] = edges
    return out
