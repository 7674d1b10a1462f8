"""Batched ORB feature extraction.

Re-design of the reference's ORBextractor (/root/reference/src/ORBextractor.cc:
operator() at include/ORBextractor.h:57 — image pyramid, two-tier FAST,
quadtree keypoint distribution, intensity-centroid orientation, steered
256-bit BRIEF), built for XLA instead of per-feature C++ loops:

- FAST responses for *every* pixel of a level at once (16 circle shifts ->
  contiguous-arc score, fully elementwise).
- The quadtree distribution (ORBextractor::DistributeOctTree) is replaced by
  an equivalent coverage guarantee: 3x3 NMS + per-cell top-k + per-level
  quota top-k, all static-shape.
- The two-tier threshold (iniThFAST=20 then minThFAST=7, ref
  src/ORBextractor.cc FAST calls) becomes a score bonus: keypoints above the
  high threshold always outrank low-threshold ones inside a cell.
- Orientation + descriptors are batched gathers over the (blurred) level.
- Descriptors are 256 bits stored packed as (N,8) uint32; matching unpacks
  to +-1 vectors so Hamming distance is a matmul (see hamming.py).

The BRIEF sampling pattern is generated here (seeded Gaussian pairs, the
original BRIEF construction) rather than copying OpenCV's learned table; the
whole system is self-consistent so no binary compatibility is needed.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


class OrbConfig(NamedTuple):
    """Static extraction parameters (hashable -> usable as jit static arg).

    Defaults mirror the reference YAMLs (Examples/Stereo/KITTI00-02.yaml:
    ORBextractor.nFeatures=2000, scaleFactor=1.2, nLevels=8, iniThFAST=20,
    minThFAST=7).
    """

    n_features: int = 2048
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_th: float = 20.0
    min_th: float = 7.0
    cell_size: int = 32          # NMS/coverage cell in level pixels
    cell_top_k: int = 8          # candidates kept per cell before level top-k
    edge: int = 19               # EDGE_THRESHOLD (ref ORBextractor.cc:73)
    patch_radius: int = 15       # HALF_PATCH_SIZE for orientation

    def level_scales(self):
        return [self.scale_factor ** l for l in range(self.n_levels)]

    def level_quotas(self):
        """Features per level, geometric series like mnFeaturesPerLevel
        (ref src/ORBextractor.cc ctor)."""
        inv = 1.0 / self.scale_factor
        base = self.n_features * (1 - inv) / (1 - inv ** self.n_levels)
        q = [int(round(base * inv ** l)) for l in range(self.n_levels)]
        q[0] += self.n_features - sum(q)  # make the quotas sum exactly
        return q


class Features(NamedTuple):
    """One image's extracted features, fixed capacity N = cfg.n_features.

    Replaces the per-Frame keypoint/descriptor arrays of the reference
    (include/Frame.h mvKeysUn / mDescriptors / mvuRight / mvDepth).
    """

    xy: jnp.ndarray        # (N,2) float32, level-0 (undistorted) pixel coords
    response: jnp.ndarray  # (N,) float32 FAST score
    angle: jnp.ndarray     # (N,) float32 radians
    octave: jnp.ndarray    # (N,) int32 pyramid level
    desc: jnp.ndarray      # (N,8) uint32 packed 256-bit descriptor
    valid: jnp.ndarray     # (N,) bool


# FAST circle: 16 Bresenham offsets of radius 3, in circular order (dy, dx).
_FAST_CIRCLE = np.array(
    [(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
     (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1)],
    dtype=np.int32,
)

_ARC_LEN = 9  # contiguous arc length for the FAST-9 test

# Keypoint patch geometry for the matmul descriptor path: BRIEF offsets are
# clipped to +-13 (see _brief_pattern), so rotated offsets stay within
# radius ceil(13*sqrt(2)) = 19; the extracted patch adds 3px for the 7x7
# blur's valid region.
PATCH_R = 19                  # blurred patch radius available to BRIEF
EXTRACT_R = PATCH_R + 3       # raw patch radius extracted per keypoint
N_ANGLE_BINS = 30             # steered-BRIEF angle quantization (the
                              # original ORB paper discretizes to 2pi/30)


@functools.lru_cache()
def _brief_pattern(n_bits: int = 256, patch: int = 31, seed: int = 0x0B12EF):
    """Seeded Gaussian BRIEF pair pattern: (n_bits, 4) int32 [dy1,dx1,dy2,dx2].

    Pairs ~ N(0, (patch/5)^2) clipped to the patch (original BRIEF G-II
    construction; stands in for OpenCV's learned bit_pattern_31_)."""
    rs = np.random.RandomState(seed)
    sigma = patch / 5.0
    lim = patch // 2 - 2  # keep inside patch so rotation stays in 31x31 + margin
    pts = np.clip(np.round(rs.normal(0.0, sigma, size=(n_bits, 4))), -lim, lim)
    return pts.astype(np.int32)


# ---------------------------------------------------------------------------
# Pyramid
# ---------------------------------------------------------------------------

def pyramid_shapes(h: int, w: int, cfg: OrbConfig):
    shapes = []
    for s in cfg.level_scales():
        shapes.append((int(round(h / s)), int(round(w / s))))
    return shapes



# ---------------------------------------------------------------------------
# FAST response
# ---------------------------------------------------------------------------

def fast_score(img: jnp.ndarray, min_th: float) -> jnp.ndarray:
    """Per-pixel FAST-9 corner score.

    score = max over the 16 circular 9-windows of min |I(c_i)-I(p)| on a
    consistently-brighter (or darker) arc; 0 if not a corner at min_th.
    This is the max-threshold-still-corner score OpenCV computes, evaluated
    densely for the whole image.
    """
    c = img
    d = [jnp.roll(img, shift=(-int(dy), -int(dx)), axis=(0, 1)) - c
         for dy, dx in _FAST_CIRCLE]

    def arc_scores(d16):
        # circular sliding-window minimum of length 9 by doubling:
        # min2 -> min4 -> min8 -> min9; all static indexing (no gathers)
        m = d16
        for span in (1, 2, 4):
            m = [jnp.minimum(m[i], m[(i + span) % 16]) for i in range(16)]
        m9 = [jnp.minimum(m[i], d16[(i + 8) % 16]) for i in range(16)]
        best = m9[0]
        for i in range(1, 16):
            best = jnp.maximum(best, m9[i])
        return best

    bright = arc_scores(d)        # want all > th  -> score = min of window
    dark = arc_scores([-x for x in d])
    score = jnp.maximum(bright, dark)
    return jnp.where(score >= min_th, score, 0.0)


def _nms3(score: jnp.ndarray) -> jnp.ndarray:
    """3x3 local-maximum suppression."""
    m = jax.lax.reduce_window(score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME")
    return jnp.where(score >= m, score, 0.0)



# ---------------------------------------------------------------------------
# Orientation (intensity centroid) and descriptors (steered BRIEF)
# ---------------------------------------------------------------------------

@functools.lru_cache()
def _circular_offsets(radius: int):
    """(K,2) int offsets within the circular patch + matching x,y weights."""
    ys, xs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    mask = (ys ** 2 + xs ** 2) <= radius ** 2
    return ys[mask].astype(np.int32), xs[mask].astype(np.int32)



def pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """(N,256) bool -> (N,8) uint32, little-endian bit order within words."""
    n = bits.shape[0]
    b = bits.reshape(n, 8, 32).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << shifts[None, None, :], axis=-1, dtype=jnp.uint32)


def unpack_bits(packed: jnp.ndarray) -> jnp.ndarray:
    """(N,8) uint32 -> (N,256) bool."""
    n = packed.shape[0]
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (packed[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    return bits.reshape(n, 256).astype(jnp.bool_)


# ---------------------------------------------------------------------------
# Batched (padded level stack) extraction. All levels are
# padded into one (L,H,W) tensor so every stage is ONE kernel set instead of
# an 8x sequence of small per-level programs, and orientation/descriptor
# lookups become a single gather over the stack.
# ---------------------------------------------------------------------------

def build_pyramid_stack(img: jnp.ndarray, cfg: OrbConfig):
    """(H,W) -> (L,H,W) padded stack (level l occupies [:h_l,:w_l])."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, cfg)
    levels = [img]
    for (lh, lw) in shapes[1:]:
        levels.append(jax.image.resize(img, (lh, lw), method="bilinear"))
    stack = jnp.stack([
        jnp.pad(l, ((0, h - l.shape[0]), (0, w - l.shape[1])))
        for l in levels])
    return stack, shapes


@functools.lru_cache()
def _level_masks(h: int, w: int, cfg: OrbConfig):
    """Static (L,H,W) in-bounds masks (borders excluded per level).

    The border is max(edge, EXTRACT_R+1) so every keypoint's extraction
    patch lies fully inside its level (the reference's EDGE_THRESHOLD=19
    serves the same purpose for its 31px patches)."""
    shapes = pyramid_shapes(h, w, cfg)
    e = max(cfg.edge, EXTRACT_R + 1)
    m = np.zeros((cfg.n_levels, h, w), bool)
    for l, (lh, lw) in enumerate(shapes):
        m[l, e:lh - e, e:lw - e] = True
    return m


def detect_stack(stack: jnp.ndarray, cfg: OrbConfig, n_images: int = 1):
    """All-level detection on the padded stack (optionally several images'
    stacks concatenated on the leading axis). Returns per-level-quota
    concatenated (n_images*N,) arrays indexed into the big stack:
    stack-slice index, y, x, score, valid."""
    L, h, w = stack.shape
    score = fast_score_batched(stack, cfg.min_th)
    inb = jnp.asarray(_level_masks(h, w, cfg))
    if n_images > 1:
        inb = jnp.tile(inb, (n_images, 1, 1))
    score = jnp.where(inb, score, 0.0)
    m = jax.lax.reduce_window(score, -jnp.inf, jax.lax.max, (1, 3, 3),
                              (1, 1, 1), "SAME")
    score = jnp.where(score >= m, score, 0.0)
    BONUS = 1e4
    rank = jnp.where(score >= cfg.ini_th, score + BONUS, score)

    cs = cfg.cell_size
    gh, gw = -(-h // cs), -(-w // cs)
    pad_h, pad_w = gh * cs - h, gw * cs - w
    rpad = jnp.pad(rank, ((0, 0), (0, pad_h), (0, pad_w)))
    cells = rpad.reshape(L, gh, cs, gw, cs).transpose(0, 1, 3, 2, 4)
    cells = cells.reshape(L * gh * gw, cs * cs)
    k = min(cfg.cell_top_k, cs * cs)
    # candidate ranking only (the per-level exact top-quota follows);
    # approx_max_k lowers to an exact top-k on the GPU and CPU
    top_v, top_i = jax.lax.approx_max_k(cells, k)   # (L*gh*gw, k)
    cell_ids = jax.lax.broadcasted_iota(jnp.int32, (L * gh * gw, k), 0)
    lvl = cell_ids // (gh * gw)
    rem = cell_ids % (gh * gw)
    cy = (rem // gw) * cs + top_i // cs
    cx = (rem % gw) * cs + top_i % cs
    # per-level top-quota (quotas differ per level; each level's candidate
    # rows are contiguous)
    per_lvl = gh * gw * k
    cand_v = top_v.reshape(L, per_lvl)
    cand_y = cy.reshape(L, per_lvl)
    cand_x = cx.reshape(L, per_lvl)
    del lvl
    ys, xs, lv, sc, va = [], [], [], [], []
    quotas = cfg.level_quotas() * n_images
    for l, quota in enumerate(quotas):
        v, i = jax.lax.top_k(cand_v[l], min(quota, per_lvl))
        if quota > per_lvl:
            pad = quota - per_lvl
            v = jnp.pad(v, (0, pad))
            i = jnp.pad(i, (0, pad))
        ys.append(cand_y[l][i])
        xs.append(cand_x[l][i])
        lv.append(jnp.full((quota,), l, jnp.int32))
        sc.append(jnp.where(v >= 1e4, v - 1e4, v))
        va.append(v > 0.0)
    return (jnp.concatenate(lv), jnp.concatenate(ys), jnp.concatenate(xs),
            jnp.concatenate(sc), jnp.concatenate(va))


def fast_score_batched(stack: jnp.ndarray, min_th: float) -> jnp.ndarray:
    """fast_score on a (L,H,W) stack (rolls act on the last two axes)."""
    d = [jnp.roll(stack, shift=(-int(dy), -int(dx)), axis=(1, 2)) - stack
         for dy, dx in _FAST_CIRCLE]

    def arc_scores(d16):
        m = d16
        for span in (1, 2, 4):
            m = [jnp.minimum(m[i], m[(i + span) % 16]) for i in range(16)]
        m9 = [jnp.minimum(m[i], d16[(i + 8) % 16]) for i in range(16)]
        best = m9[0]
        for i in range(1, 16):
            best = jnp.maximum(best, m9[i])
        return best

    bright = arc_scores(d)
    dark = arc_scores([-x for x in d])
    score = jnp.maximum(bright, dark)
    return jnp.where(score >= min_th, score, 0.0)



def extract_stack(img: jnp.ndarray, cfg: OrbConfig):
    """Batched full extraction. Returns (Features, stack, None) —
    the stack is reused by the stereo matcher."""
    feats, stacks, _ = extract_stack_multi(img[None], cfg)
    return (jax.tree.map(lambda a: a[0], feats), stacks[0], None)


def extract_stack_multi(imgs: jnp.ndarray, cfg: OrbConfig):
    """Extraction for B images at once on one (B*L,H,W) stack: every
    stage (FAST, NMS, top-k, orientation, blur, BRIEF) runs as a single
    kernel set for the whole batch (e.g. both stereo images).

    The per-keypoint stages are patch-based: ONE block slice per keypoint
    (45x45), then the 7x7 blur runs on the patches and steered BRIEF is a
    batched +-1 one-hot MATMUL over 30 precomputed angle-binned pattern
    matrices (the original ORB paper quantizes steering to 2pi/30) —
    replacing ~1200 random device-memory gathers per keypoint.

    Returns (Features batched (B,...), stacks (B,L,H,W), None)."""
    B = imgs.shape[0]
    L = cfg.n_levels
    stack, shapes = build_pyramid_stack_multi(imgs, cfg)
    lv, ys, xs, sc, va = detect_stack(stack, cfg, n_images=B)

    patches = extract_patches(stack, lv, ys, xs)          # (n,45,45)
    ang = orientation_from_patches(patches)
    desc = descriptors_from_patches(patches, ang)

    octave = lv % L
    scales = jnp.asarray(cfg.level_scales(), jnp.float32)
    xy0 = jnp.stack([xs.astype(jnp.float32), ys.astype(jnp.float32)],
                    axis=-1) * scales[octave][:, None]
    n = cfg.n_features
    feats = Features(
        xy=xy0.reshape(B, n, 2), response=sc.reshape(B, n),
        angle=ang.reshape(B, n), octave=octave.reshape(B, n),
        desc=desc.reshape(B, n, 8), valid=va.reshape(B, n))
    return feats, stack.reshape(B, L, *stack.shape[1:]), None


# ---------------------------------------------------------------------------
# Patch-based orientation + descriptors (the matmul path)
# ---------------------------------------------------------------------------

def extract_patches(stack: jnp.ndarray, lv, ys, xs) -> jnp.ndarray:
    """One (2R+1)^2 raw patch per keypoint via batched block slices
    (XLA lowers vmapped dynamic_slice to a block gather — measured ~4x
    cheaper than per-element gathers for the same pixels)."""
    E = 2 * EXTRACT_R + 1

    def one(l, y, x):
        return jax.lax.dynamic_slice(
            stack, (l, y - EXTRACT_R, x - EXTRACT_R), (1, E, E))[0]

    return jax.vmap(one)(lv, ys, xs)


@functools.lru_cache()
def _moment_matrix():
    """(E*E, 2) flattened circular-mask [y, x] moment weights (radius =
    HALF_PATCH_SIZE 15, ref IC_Angle's circular patch)."""
    E = 2 * EXTRACT_R + 1
    yy, xx = np.mgrid[-EXTRACT_R:EXTRACT_R + 1, -EXTRACT_R:EXTRACT_R + 1]
    mask = (yy ** 2 + xx ** 2) <= 15 ** 2
    return np.stack([(yy * mask), (xx * mask)], -1).reshape(E * E, 2) \
        .astype(np.float32)


def orientation_from_patches(patches: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid angle: two patch-matrix dot products
    (ref IC_Angle, src/ORBextractor.cc)."""
    n = patches.shape[0]
    mom = patches.reshape(n, -1) @ jnp.asarray(_moment_matrix())
    return jnp.arctan2(mom[:, 0], mom[:, 1])


def blur_patches(patches: jnp.ndarray) -> jnp.ndarray:
    """Separable 7x7 Gaussian (sigma=2), valid region only:
    (n,45,45) -> (n,39,39). Interior keypoints make this exactly equal to
    slicing a blurred full image (ref GaussianBlur before descriptors)."""
    x = np.arange(-3, 4)
    k = np.exp(-x * x / (2 * 2.0 ** 2))
    k = (k / k.sum()).astype(np.float32)
    kj = jnp.asarray(k)
    P = 2 * PATCH_R + 1
    ph = sum(kj[i] * patches[:, :, i:i + P] for i in range(7))
    return sum(kj[i] * ph[:, i:i + P, :] for i in range(7))


@functools.lru_cache()
def _binned_pattern_matrices():
    """(Q, P*P, 256) +-1 difference matrices: descriptor bit b at angle bin
    q is (blurred patch . M[q,:,b]) > 0 == I(p1_rot) < I(p2_rot). Steering
    is quantized to Q=30 bins so all bins evaluate as one batched matmul."""
    pat = _brief_pattern()
    P = 2 * PATCH_R + 1
    Q = N_ANGLE_BINS
    out = np.zeros((Q, P * P, 256), np.float32)
    for q in range(Q):
        th = 2 * np.pi * q / Q
        ca, sa = np.cos(th), np.sin(th)
        for b in range(256):
            dy1, dx1, dy2, dx2 = pat[b]
            r1y = int(round(dx1 * sa + dy1 * ca))
            r1x = int(round(dx1 * ca - dy1 * sa))
            r2y = int(round(dx2 * sa + dy2 * ca))
            r2x = int(round(dx2 * ca - dy2 * sa))
            out[q, (r2y + PATCH_R) * P + (r2x + PATCH_R), b] += 1.0
            out[q, (r1y + PATCH_R) * P + (r1x + PATCH_R), b] -= 1.0
    return out


def descriptors_from_patches(patches: jnp.ndarray,
                             angle: jnp.ndarray) -> jnp.ndarray:
    """Steered BRIEF-256 as a batched matmul: blur the patches,
    evaluate every angle bin's pattern matrix at once, select each
    keypoint's bin."""
    n = patches.shape[0]
    Q = N_ANGLE_BINS
    blurred = blur_patches(patches).reshape(n, -1)
    PB = jnp.asarray(_binned_pattern_matrices(), jnp.bfloat16)
    q = jnp.round(angle * (Q / (2 * np.pi))).astype(jnp.int32) % Q
    alls = jnp.einsum("np,qpb->qnb", blurred.astype(jnp.bfloat16), PB,
                      preferred_element_type=jnp.float32)
    bits = jnp.take_along_axis(alls, q[None, :, None], axis=0)[0] > 0
    return pack_bits(bits)


# ---------------------------------------------------------------------------
# Canvas-packed extraction: all pyramid levels side-by-side in ONE (H, Wc)
# plane per image instead of L full-size padded planes. The stack layout
# wastes ~60% of its pixels as padding (level l occupies 1/1.44^l of its
# plane); the canvas packs levels at cell-aligned column offsets, cutting
# FAST + NMS work ~1.7x. Detection/extraction semantics are identical.
# ---------------------------------------------------------------------------

@functools.lru_cache()
def canvas_layout(h: int, w: int, cfg: OrbConfig):
    """Per-level column offsets in the packed canvas + canvas width.

    Offsets are cell_size-aligned so every detection cell belongs to exactly
    one level; Wc is padded to a multiple of lcm(cell_size, 128). The 128
    fixes the deployment's canvas shapes; whether another width is faster
    on the H100 is unmeasured (ROADMAP S3)."""
    shapes = pyramid_shapes(h, w, cfg)
    cs = cfg.cell_size
    offs, x = [], 0
    for (lh, lw) in shapes:
        offs.append(x)
        x += ((lw + cs - 1) // cs) * cs
    lcm = cs * 128 // np.gcd(cs, 128)
    Wc = ((x + lcm - 1) // lcm) * lcm
    return tuple(offs), Wc, tuple(shapes)


def build_canvas_multi(imgs: jnp.ndarray, cfg: OrbConfig) -> jnp.ndarray:
    """(B,H,W) -> (B,H,Wc) packed canvases (level l at columns
    [off_l, off_l+w_l), rows [0, h_l))."""
    B, h, w = imgs.shape
    offs, Wc, shapes = canvas_layout(h, w, cfg)
    parts = []
    for l, (lh, lw) in enumerate(shapes):
        img_l = imgs if l == 0 else jax.image.resize(
            imgs, (B, lh, lw), method="bilinear")
        seg_w = (offs[l + 1] if l + 1 < len(offs) else Wc) - offs[l]
        parts.append(jnp.pad(img_l, ((0, 0), (0, h - lh), (0, seg_w - lw))))
    return jnp.concatenate(parts, axis=2)


@functools.lru_cache()
def _canvas_masks(h: int, w: int, cfg: OrbConfig):
    """Static in-bounds mask (H,Wc) + cell->level map for the canvas."""
    offs, Wc, shapes = canvas_layout(h, w, cfg)
    e = max(cfg.edge, EXTRACT_R + 1)
    m = np.zeros((h, Wc), bool)
    for l, (lh, lw) in enumerate(shapes):
        m[e:lh - e, offs[l] + e:offs[l] + lw - e] = True
    cs = cfg.cell_size
    ghc, gwc = -(-h // cs), Wc // cs
    cell_lvl = np.full((ghc * gwc,), -1, np.int32)
    for l in range(cfg.n_levels):
        x0 = offs[l] // cs
        x1 = (offs[l + 1] // cs) if l + 1 < len(offs) else gwc
        for gy in range(ghc):
            cell_lvl[gy * gwc + x0:gy * gwc + x1] = l
    return m, cell_lvl, ghc, gwc


def detect_canvas(canvas: jnp.ndarray, w: int, cfg: OrbConfig):
    """All-level detection on packed canvases (B,H,Wc). Returns per-image
    (B,N) arrays: level, y, x_canvas, score, valid."""
    B, h, Wc = canvas.shape
    cs = cfg.cell_size
    score = fast_score_batched(canvas, cfg.min_th)
    m, cell_lvl, ghc, gwc = _canvas_masks(h, w, cfg)
    score = jnp.where(jnp.asarray(m)[None], score, 0.0)
    mx = jax.lax.reduce_window(score, -jnp.inf, jax.lax.max, (1, 3, 3),
                               (1, 1, 1), "SAME")
    score = jnp.where(score >= mx, score, 0.0)
    BONUS = 1e4
    rank = jnp.where(score >= cfg.ini_th, score + BONUS, score)

    nc = ghc * gwc
    rank = jnp.pad(rank, ((0, 0), (0, ghc * cs - h), (0, 0)))
    k = min(cfg.cell_top_k, cs * cs)
    import os as _os
    FY, FX_ = 4, 8                 # fine sub-block (rows x cols)
    use_fine = (not _os.environ.get("MSSLAM_NO_SUBBLOCK")
                and cs % FY == 0 and cs % FX_ == 0
                and (cs // FY) * (cs // FX_) >= k)
    if use_fine:
        # Two-stage per-cell top-k: ONE strided reduce_window keeps the
        # best (score, position)-packed corner of every fine 4x8 sub-block,
        # then an exact top-k over each cell's (cs/4)*(cs/8) fine maxima —
        # a tiny per-row sort instead of a top-k over full 1024-pixel
        # cells.
        # Equal to the exact per-cell top-k unless two of a cell's top-k
        # corners share one 4x8 block (the 3x3 NMS makes that rare).
        # Candidate order is level-major (gx outermost) so each pyramid
        # level's candidates form one contiguous slice below.
        npos = cs * cs
        nf_y, nf_x = cs // FY, cs // FX_
        nf = nf_y * nf_x
        H2, Wc2 = rank.shape[1], rank.shape[2]
        # pack: round(score * 64) * npos + position within the CELL
        # (scores < ~1.1e4 after BONUS -> 656k * 1024 < 2^31)
        yy = jax.lax.broadcasted_iota(jnp.int32, (H2, Wc2), 0)
        xx = jax.lax.broadcasted_iota(jnp.int32, (H2, Wc2), 1)
        lpos = (yy % cs) * cs + (xx % cs)
        packed = (jnp.round(rank * 64.0).astype(jnp.int32) * npos
                  + lpos[None])
        imin = np.int32(jnp.iinfo(jnp.int32).min)
        fine = jax.lax.reduce_window(packed, imin, jax.lax.max,
                                     (1, FY, FX_), (1, FY, FX_),
                                     "VALID")        # (B, ghc*nf_y, gwc*nf_x)
        fine = fine.reshape(B, ghc, nf_y, gwc, nf_x).transpose(0, 3, 1, 2, 4)
        fine = fine.reshape(B, nc, nf)               # level-major cells
        bm, _ = jax.lax.top_k(fine, k)               # exact top-k of nf
        bm = jnp.maximum(bm.reshape(B, nc * k), 0)
        ti = bm % npos                               # position within cell
        top_v = (bm // npos).astype(jnp.float32) * (1.0 / 64.0)
        jj = jax.lax.broadcasted_iota(jnp.int32, (B, nc * k), 1)
        cell = jj // k
        gy = cell % ghc
        gx = cell // ghc
        cy = gy * cs + ti // cs
        cx = gx * cs + ti % cs
        top_v = top_v.reshape(B, nc, k)
        cy = cy.reshape(B, nc, k)
        cx = cx.reshape(B, nc, k)
    else:
        # LEVEL-MAJOR cell order (cell = gx * ghc + gy): levels occupy
        # disjoint column ranges of the canvas, so each level's cells are
        # one contiguous slice for the quota selection below
        cells = rank.reshape(B, ghc, cs, gwc, cs).transpose(0, 3, 1, 2, 4)
        cells = cells.reshape(B, nc, cs * cs)
        top_v, top_i = jax.lax.approx_max_k(cells, k)       # (B, nc, k)
        cell_ids = jax.lax.broadcasted_iota(jnp.int32, (B, nc, k), 1)
        cy = (cell_ids % ghc) * cs + top_i // cs
        cx = (cell_ids // ghc) * cs + top_i % cs

    ys, xs, lv, sc, va = [], [], [], [], []
    offs, Wc_, _ = canvas_layout(h, w, cfg)
    for l, quota in enumerate(cfg.level_quotas()):
        gx0 = offs[l] // cs
        gx1 = (offs[l + 1] // cs) if l + 1 < cfg.n_levels else gwc
        sl = slice(gx0 * ghc, gx1 * ghc)
        n_l = (gx1 - gx0) * ghc * k
        vals = top_v[:, sl].reshape(B, n_l)
        # exact top-quota. FAST scores tie often (differences of integer
        # pixels), so ties go to the lowest candidate index through an
        # explicit two-key sort: every backend then selects the same
        # keypoints, where a top-k leaves the tie order to its lowering
        iota = jax.lax.broadcasted_iota(jnp.int32, (B, n_l), 1)
        neg, order = jax.lax.sort((-vals, iota), dimension=1, num_keys=2)
        v, i = -neg[:, :quota], order[:, :quota]          # (B, <=quota)
        if quota > n_l:
            v = jnp.pad(v, ((0, 0), (0, quota - n_l)))
            i = jnp.pad(i, ((0, 0), (0, quota - n_l)))
        ys.append(jnp.take_along_axis(
            cy[:, sl].reshape(B, n_l), i, axis=1))
        xs.append(jnp.take_along_axis(
            cx[:, sl].reshape(B, n_l), i, axis=1))
        lv.append(jnp.full((B, quota), l, jnp.int32))
        sc.append(jnp.where(v >= 1e4, v - 1e4, v))
        va.append(v > 0.0)
    return (jnp.concatenate(lv, 1), jnp.concatenate(ys, 1),
            jnp.concatenate(xs, 1), jnp.concatenate(sc, 1),
            jnp.concatenate(va, 1))


def extract_patches_canvas(canvas: jnp.ndarray, bi, ys, xs) -> jnp.ndarray:
    """One (2R+1)^2 raw patch per keypoint from its image's canvas."""
    E = 2 * EXTRACT_R + 1
    bi = bi.astype(jnp.int32)
    ys = ys.astype(jnp.int32)
    xs = xs.astype(jnp.int32)

    def one(b, y, x):
        return jax.lax.dynamic_slice(
            canvas, (b, y - EXTRACT_R, x - EXTRACT_R), (1, E, E))[0]

    return jax.vmap(one)(bi, ys, xs)


def extract_canvas_multi(imgs: jnp.ndarray, cfg: OrbConfig):
    """Canvas-packed full extraction for B images: FAST + NMS + top-k on one
    packed f32 plane per image, then the patch-based matmul orientation/
    descriptor pipeline. Returns (Features (B,...), canvases (B,H,Wc))."""
    B, h, w = imgs.shape
    offs, Wc, shapes = canvas_layout(h, w, cfg)
    canvas = build_canvas_multi(imgs, cfg)
    lv, ys, xs, sc, va = detect_canvas(canvas, w, cfg)   # (B,N) each
    n = cfg.n_features
    bi = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None],
                          (B, n)).reshape(-1)
    patches = extract_patches_canvas(canvas, bi, ys.reshape(-1),
                                     xs.reshape(-1))
    ang = orientation_from_patches(patches)
    desc = descriptors_from_patches(patches, ang)

    scales = jnp.asarray(cfg.level_scales(), jnp.float32)
    offs_j = jnp.asarray(offs, jnp.int32)
    x_lvl = (xs - offs_j[lv]).astype(jnp.float32)
    xy0 = jnp.stack([x_lvl, ys.astype(jnp.float32)],
                    axis=-1) * scales[lv][..., None]
    feats = Features(
        xy=xy0, response=sc, angle=ang.reshape(B, n), octave=lv,
        desc=desc.reshape(B, n, 8), valid=va)
    return feats, canvas


def build_pyramid_stack_multi(imgs: jnp.ndarray, cfg: OrbConfig):
    """(B,H,W) -> (B*L,H,W) padded stacks (image-major)."""
    B, h, w = imgs.shape
    shapes = pyramid_shapes(h, w, cfg)
    levels = [imgs]
    for (lh, lw) in shapes[1:]:
        levels.append(jax.image.resize(imgs, (B, lh, lw), method="bilinear"))
    stack = jnp.stack([
        jnp.pad(l, ((0, 0), (0, h - l.shape[1]), (0, w - l.shape[2])))
        for l in levels], axis=1)                  # (B,L,H,W)
    return stack.reshape(B * cfg.n_levels, h, w), shapes



# ---------------------------------------------------------------------------
# Full extraction
# ---------------------------------------------------------------------------

def extract(img: jnp.ndarray, cfg: OrbConfig) -> Features:
    """Full ORB extraction for one image (H,W) float32 in [0,255].

    Returns Features with capacity cfg.n_features; invalid slots masked.
    Equivalent surface to ORBextractor::operator()
    (ref include/ORBextractor.h:57)."""
    feats, _ = extract_canvas_multi(img[None], cfg)
    return jax.tree.map(lambda a: a[0], feats)
