"""Keypoint orientation and M-LDB binary descriptors.

Port of ``cv_tpu/akaze/descriptors.py`` (reference
scale_space_extrema.rs:157-288 and descriptors.rs).  The static tables are
copies of the reference's NumPy host code.  The batched describe path is the
``pgather``, ``pallas`` and ``pepatch`` branches of ``orient_mldb_onehot``
and the group describe ``orient_mldb_groups``: both sample passes
(orientation, then M-LDB) go through the hand-written select kernels of
:mod:`.select`.  ``orient_mldb_onehot``'s ``'highest'`` branch (a one-hot
product in ``cv_tpu``, an exact index gather here) and the gather forms
(``compute_orientations``/``compute_mldb_descriptors`` of the exact
extractor, ``orientation_flat``/``orientation_padded``/``mldb_flat`` of the
fast path's ``'gather'`` sampler) are plain tensor ops, as they are XLA ops
in ``cv_tpu``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops.trig import TWO_PI, angle_cv, cos_sin
from .select import GROUP, cut_patches, select_groups, select_samples, select_samples_patch

# 7x7 Gaussian weight table (scale_space_extrema.rs:162-226).
GAUSS25 = np.array(
    [
        [0.02546481, 0.02350698, 0.01849125, 0.01239505, 0.00708017, 0.00344629, 0.00142946],
        [0.02350698, 0.02169968, 0.01706957, 0.01144208, 0.00653582, 0.00318132, 0.00131956],
        [0.01849125, 0.01706957, 0.01342740, 0.00900066, 0.00514126, 0.00250252, 0.00103800],
        [0.01239505, 0.01144208, 0.00900066, 0.00603332, 0.00344629, 0.00167749, 0.00069579],
        [0.00708017, 0.00653582, 0.00514126, 0.00344629, 0.00196855, 0.00095820, 0.00039744],
        [0.00344629, 0.00318132, 0.00250252, 0.00167749, 0.00095820, 0.00046640, 0.00019346],
        [0.00142946, 0.00131956, 0.00103800, 0.00069579, 0.00039744, 0.00019346, 0.00008024],
    ],
    dtype=np.float32,
)

PATCH = 128  # side of the window around a keypoint that holds all its samples

# Retired describe modes ('ptiles' and 'pepatch', cv_tpu's measured losers
# on its TPU) register here when cv_tpu_torch/experiments/mldb_losers.py is
# imported: 'ptiles' maps to an orient_mldb-like describe, 'pepatch' to a
# select hook of select_samples' signature.
EXTERNAL_MODES: dict = {}
RETIRED_MODULE = "cv_tpu_torch/experiments/mldb_losers.py"


def external_mode(mode: str):
    """The registered hook of a retired describe mode, or ``KeyError``."""
    if mode not in EXTERNAL_MODES:
        raise KeyError(f"{mode!r} was retired to {RETIRED_MODULE}; import that module first")
    return EXTERNAL_MODES[mode]


@lru_cache(maxsize=None)
def orientation_table():
    """(di, dj, weight) for the 109-sample disc (scale_space_extrema.rs:242-253)."""
    dis, djs, ws = [], [], []
    for j in range(-6, 7):
        for i in range(-6, 7):
            if i * i + j * j < 36:
                dis.append(i)
                djs.append(j)
                ws.append(GAUSS25[abs(j)][abs(i)])
    return (
        np.array(dis, np.float32),
        np.array(djs, np.float32),
        np.array(ws, np.float32),
    )


@lru_cache(maxsize=None)
def orientation_windows():
    """The 42 sliding-window start angles, accumulated in f32 exactly like
    the reference's ``ang1 += 0.15`` loop (scale_space_extrema.rs:256-287)."""
    angs = []
    ang1 = np.float32(0.0)
    two_pi = np.float32(2.0) * np.float32(np.pi)
    while ang1 < two_pi:
        angs.append(ang1)
        ang1 = np.float32(ang1 + np.float32(0.15))
    ang1s = np.array(angs, np.float32)
    pi3 = np.float32(np.pi) / np.float32(3.0)
    ang2s = np.where(
        ang1s + pi3 > two_pi, ang1s - np.float32(5.0) * pi3, ang1s + pi3
    ).astype(np.float32)
    return ang1s, ang2s


@lru_cache(maxsize=None)
def mldb_tables(pattern_size: int = 10):
    """Static M-LDB sampling + comparison tables (descriptors.rs:102-202).

    Returns:
      samples: (n_samples, 3) int32 rows (cell_index, k, l) across all 3 grid
        levels (cells are numbered consecutively: 4 + 9 + 16 = 29).
      cell_counts: (29,) number of samples per cell.
      comparisons: (486, 3) int32 rows (cell_i, cell_j, channel) in exact
        ``dpos`` order (level-major, then channel, then pair).
    """
    size_mult = [1.0, 2.0 / 3.0, 1.0 / 2.0]
    samples = []
    cell_counts = []
    comparisons = []
    cell_base = 0
    for lvl, mult in enumerate(size_mult):
        count = (lvl + 2) * (lvl + 2)
        step = int(np.ceil(pattern_size * mult))
        cell = cell_base
        n_axis = 0
        for i in range(-pattern_size, pattern_size, step):
            n_axis += 1
        assert n_axis * n_axis == count, (lvl, n_axis, count)
        for i in range(-pattern_size, pattern_size, step):
            for j in range(-pattern_size, pattern_size, step):
                for k in range(i, i + step):
                    for l in range(j, j + step):
                        samples.append((cell, k, l))
                cell_counts.append(step * step)
                cell += 1
        for ch in range(3):
            for a in range(count):
                for b in range(a + 1, count):
                    comparisons.append((cell_base + a, cell_base + b, ch))
        cell_base += count
    return (
        np.array(samples, np.int32),
        np.array(cell_counts, np.int32),
        np.array(comparisons, np.int32),
    )


@lru_cache(maxsize=None)
def mldb_unique_tables(pattern_size: int = 10):
    """Deduplicated M-LDB sampling tables.

    The sampled position depends only on (k, l), and the three grid levels'
    (k, l) ranges overlap almost entirely (union = 21x21 = 441 unique
    offsets vs 1241 raw samples): each unique offset is sampled once and
    cells aggregate through a static 0/1 membership matrix.  The unique
    table is (k, l)-lexicographic.

    Returns:
      uk, ul: (U,) int32 unique sample offsets.
      member: (n_cells, U) float32 0/1 cell membership.
      cell_counts: (n_cells,) int32.
    """
    samples, cell_counts, _ = mldb_tables(pattern_size)
    pairs = sorted({(int(k), int(l)) for _, k, l in samples})
    index = {p: i for i, p in enumerate(pairs)}
    n_cells = int(cell_counts.shape[0])
    member = np.zeros((n_cells, len(pairs)), np.float32)
    for cell, k, l in samples:
        member[cell, index[(int(k), int(l))]] += 1.0
    assert member.max() == 1.0  # each cell samples each offset once
    uk = np.array([p[0] for p in pairs], np.int32)
    ul = np.array([p[1] for p in pairs], np.int32)
    return uk, ul, member, cell_counts


def cell_member_table(member: np.ndarray) -> np.ndarray:
    """(n_cells, max_members) int64: each cell's unique-sample indices in
    ascending order, padded with ``U`` (the index of an appended zero)."""
    n_cells, u = member.shape
    rows = [np.nonzero(member[c])[0] for c in range(n_cells)]
    table = np.full((n_cells, max(len(r) for r in rows)), u, np.int64)
    for c, r in enumerate(rows):
        table[c, : len(r)] = r
    return table


def cell_means(values: torch.Tensor, cell_members: torch.Tensor, inv_counts: torch.Tensor) -> torch.Tensor:
    """M-LDB cell means of ``values`` (..., U): each cell's members added in
    a fixed order (ascending sample index, padded slots adding 0.0), then
    scaled by ``inv_counts``.  A chain of plain adds, so the CPU and the card
    round identically (a matmul would sum in a library's order)."""
    padded = torch.cat([values, torch.zeros_like(values[..., :1])], dim=-1)
    g = padded[..., cell_members]  # (..., n_cells, max_members)
    acc = g[..., 0]
    for j in range(1, g.shape[-1]):
        acc = acc + g[..., j]
    return acc * inv_counts


@lru_cache(maxsize=None)
def _orientation_device_tables(device: torch.device) -> dict:
    """The orientation disc and window tables as tensors on ``device``."""
    di, dj, wt = orientation_table()
    ang1s, ang2s = orientation_windows()
    host = dict(di=di, dj=dj, wt=wt, ang1s=ang1s, ang2s=ang2s)
    return {k: torch.as_tensor(v, device=device) for k, v in host.items()}


@lru_cache(maxsize=None)
def _mldb_device_tables(pattern_size: int, device: torch.device) -> dict:
    """The M-LDB sampling, membership and comparison tables on ``device``."""
    uk, ul, member, cell_counts = mldb_unique_tables(pattern_size)
    _, _, comparisons = mldb_tables(pattern_size)
    host = dict(
        ks=uk.astype(np.float32),
        ls=ul.astype(np.float32),
        cell_members=cell_member_table(member),
        inv_counts=(1.0 / cell_counts.astype(np.float32))[None, :],
        ci=comparisons[:, 0].astype(np.int64),
        cj=comparisons[:, 1].astype(np.int64),
        ch=comparisons[:, 2].astype(np.int64),
        shifts=np.arange(32, dtype=np.int64),
    )
    return {k: torch.as_tensor(v, device=device) for k, v in host.items()}


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Rust ``f32::round`` semantics (round half away from zero);
    ``torch.round`` is half-to-even, which would disagree on exact .5."""
    return torch.sign(x) * torch.floor(x.abs() + 0.5)


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed halving tree: zero-pad it to a
    power of two ``n``, then ``x[..., i] + x[..., i + n/2]`` for ``i <
    n/2``, and again, down to one.  Elementwise adds only, so every device
    and every batch size rounds alike (``Tensor.sum``'s order depends on
    both), and a kernel that reduces in the same tree gives the same bits."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _orientation_from_samples(res_x: torch.Tensor, res_y: torch.Tensor) -> torch.Tensor:
    """Sliding-window dominant orientation from weighted samples (K, 109);
    each window's sum is a :func:`tree_sum`.  The angles are OpenCV's atan2
    in [0, 2pi) (scale_space_extrema.rs:236-239), :func:`ops.trig.angle_cv`
    (cv_tpu's bits; one kernel launch each on a card)."""
    t = _orientation_device_tables(res_x.device)
    angs = angle_cv(res_y, res_x)
    a1 = t["ang1s"][None, :, None]
    a2 = t["ang2s"][None, :, None]
    ang = angs[:, None, :]
    in_window = ((a1 < a2) & (a1 < ang) & (ang < a2)) | (
        (a2 < a1) & (((ang > 0) & (ang < a2)) | ((ang > a1) & (ang < TWO_PI)))
    )  # (K, 42, 109)
    zero = torch.zeros((), dtype=res_x.dtype, device=res_x.device)
    sum_x = tree_sum(torch.where(in_window, res_x[:, None, :], zero))
    sum_y = tree_sum(torch.where(in_window, res_y[:, None, :], zero))
    val = sum_x * sum_x + sum_y * sum_y  # (K, 42)
    best = torch.argmax(val, dim=-1, keepdim=True)  # first max wins (`val > max`)
    angle = angle_cv(sum_y.gather(1, best)[:, 0], sum_x.gather(1, best)[:, 0])
    # The reference keeps angle 0 when no window beats max=0.
    return torch.where(val.max(dim=-1).values > 0.0, angle, zero)


def _mldb_pack(ri, rx, ry, co, si, pattern_size):
    """Cell means -> rotated channels -> 486 comparisons -> packed words.

    ``ri``/``rx``/``ry``: (K, U) UNIQUE-position sampled Lt/Lx/Ly values.
    ``co``/``si``: (K, 1).  Returns (K, 16) int32 bit patterns of the
    reference's uint32 words.
    """
    t = _mldb_device_tables(pattern_size, ri.device)
    means = cell_means(torch.stack([ri, rx, ry], dim=1), t["cell_members"], t["inv_counts"])
    di, sx, sy = means[:, 0], means[:, 1], means[:, 2]  # (K, 29) each
    # Rotate the mean gradient (linear, so mean-then-rotate == rotate-then-
    # mean): dx stores -rx*si + ry*co, dy stores rx*co + ry*si
    # (descriptors.rs:160-166).
    dx = -sx * si + sy * co
    dy = sx * co + sy * si
    values = torch.stack([di, dx, dy], dim=-1)  # (K, 29, 3)
    bits = values[:, t["ci"], t["ch"]] > values[:, t["cj"], t["ch"]]  # (K, 486)
    pad = (-bits.shape[-1]) % 32
    bits = torch.nn.functional.pad(bits.to(torch.int64), (0, pad))
    words = (bits.reshape(bits.shape[0], -1, 32) << t["shifts"]).sum(dim=-1)
    # uint32 value -> the int32 with the same bits.
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)




def patch_anchor(xf, yf, hmax: int, wmax: int):
    """``(y0, x0)`` int32: the 128x128 window that holds every sample of a
    keypoint (the reference's patch), clamped into the padded stack."""
    p = PATCH
    y0 = torch.clamp(yf.to(torch.int32) - p // 2, 0, hmax - p)
    x0 = torch.clamp(xf.to(torch.int32) - p // 2, 0, wmax - p)
    return y0, x0


def _upper(limit):
    """A per-keypoint bound ``(K,)`` as a column, or a plane's as it is."""
    return limit[:, None] if isinstance(limit, torch.Tensor) else limit


def orientation_positions(xf, yf, scale, width, height):
    """The 109-disc orientation sample positions ``(ix, iy)`` int32 (K,
    109), rounded half away from zero and clamped to the plane (``width`` /
    ``height``: ints or per-keypoint tensors): Rust's ``as usize`` saturates
    negatives, and the border guard keeps the top in range."""
    t = _orientation_device_tables(xf.device)
    ox = round_half_away(xf[:, None] + t["di"][None, :] * scale[:, None]).to(torch.int32)
    oy = round_half_away(yf[:, None] + t["dj"][None, :] * scale[:, None]).to(torch.int32)
    ox = torch.minimum(ox.clamp(min=0), torch.as_tensor(_upper(width), device=xf.device) - 1)
    oy = torch.minimum(oy.clamp(min=0), torch.as_tensor(_upper(height), device=xf.device) - 1)
    return ox.to(torch.int32), oy.to(torch.int32)


def orientation_offsets(xf, yf, scale, width, height, x0, y0, span: int):
    """The 109-disc orientation sample positions, clamped to the plane and
    then made relative to the window origin ``(y0, x0)`` of side ``span``:
    ``(rel_x, rel_y)`` int32 (K, 109)."""
    ox, oy = orientation_positions(xf, yf, scale, width, height)
    rel_x = torch.clamp(ox - x0[:, None], 0, span - 1).to(torch.int32)
    rel_y = torch.clamp(oy - y0[:, None], 0, span - 1).to(torch.int32)
    return rel_x, rel_y


def orientation_from_values(vo: torch.Tensor) -> torch.Tensor:
    """Dominant angle from the sampled (Lx, Ly) values ``vo`` (K, 2, 109)."""
    wt = _orientation_device_tables(vo.device)["wt"][None, :]
    return _orientation_from_samples(wt * vo[:, 0], wt * vo[:, 1])


def _mldb_sample_positions(xf, yf, scale, angle, pattern_size):
    """Rotated grid sample coords for the unique offsets: ``(x1, y1)`` int32
    (K, U) rounded half away from zero, and ``co``/``si`` (K, 1): the
    angle's :func:`ops.trig.cos_sin` (cv_tpu's bits; one kernel launch on a
    card)."""
    t = _mldb_device_tables(pattern_size, xf.device)
    co, si = cos_sin(angle)
    co, si = co[:, None], si[:, None]
    sc = scale[:, None]
    ks, ls = t["ks"][None, :], t["ls"][None, :]
    sy = yf[:, None] + (ls * co + ks * si) * sc
    sx = xf[:, None] + (-ls * si + ks * co) * sc
    return round_half_away(sx).to(torch.int32), round_half_away(sy).to(torch.int32), co, si


def mldb_positions(xf, yf, scale, angle, width, height, pattern_size: int = 10):
    """``(x1, y1, ok, co, si)``: the M-LDB sample positions clamped to the
    plane (``width`` / ``height``: ints or per-keypoint tensors), and ``ok``
    = every sample inside it before the clamp (the reference drops a
    keypoint with an out-of-bounds sample, descriptors.rs:131-140)."""
    x1, y1, co, si = _mldb_sample_positions(xf, yf, scale, angle, pattern_size)
    w_hi = torch.as_tensor(_upper(width), device=xf.device) - 1
    h_hi = torch.as_tensor(_upper(height), device=xf.device) - 1
    oob = (x1 < 0) | (x1 > w_hi) | (y1 < 0) | (y1 > h_hi)
    ok = ~oob.any(dim=-1)
    x1 = torch.minimum(x1.clamp(min=0), w_hi).to(torch.int32)
    y1 = torch.minimum(y1.clamp(min=0), h_hi).to(torch.int32)
    return x1, y1, ok, co, si


def mldb_offsets(xf, yf, scale, angle, width, height, x0, y0, span: int, pattern_size: int = 10):
    """The rotated M-LDB sample positions for the unique offsets: ``(rel_x,
    rel_y, ok, co, si)`` with positions rounded half away from zero,
    ``ok`` = every sample inside the plane, then clamped to the plane and
    made relative to the window origin ``(y0, x0)`` of side ``span``."""
    x1, y1, ok, co, si = mldb_positions(xf, yf, scale, angle, width, height, pattern_size)
    rel_x = torch.clamp(x1 - x0[:, None], 0, span - 1).to(torch.int32)
    rel_y = torch.clamp(y1 - y0[:, None], 0, span - 1).to(torch.int32)
    return rel_x, rel_y, ok, co, si


def orient_mldb(
    planes: torch.Tensor,  # (L, 3, Hp, Wp) channel-major padded (Lt, Lx, Ly) stack
    lvl: torch.Tensor,  # (K,) plane index per keypoint
    width: torch.Tensor,  # (K,) true plane width (for the OOB mask)
    height: torch.Tensor,  # (K,)
    xf: torch.Tensor,  # (K,) octave coords
    yf: torch.Tensor,
    scale: torch.Tensor,  # (K,) rounded sampling scale
    pattern_size: int = 10,
    mode: str = "pgather",
):
    """Dominant orientation, then M-LDB words, for ``K`` keypoints.

    Port of ``orient_mldb_onehot``'s ``pgather``, ``pallas`` and
    ``pepatch`` modes.  Every sample of a keypoint lies in the 128x128
    window anchored at ``(y0, x0)`` (the reference's patch), addressed as a
    window-relative offset.  ``'pgather'``: the select kernel reads
    ``planes[lvl, c, y0 + rel_y, x0 + rel_x]`` straight from the stack.
    ``'pallas'``: the patches are cut first, as ``cv_tpu`` does for its
    one-hot kernels, and selected through :func:`select_samples_patch`.
    ``'pepatch'``: the retired select hook ``EXTERNAL_MODES['pepatch']``
    (``KeyError`` until its module is imported) on the same anchors and
    offsets.  All give the same bits.  Returns ``(words (K, 16) int32, ok
    (K,), angle (K,))``.
    """
    if mode not in ("pgather", "pallas", "pepatch"):
        raise ValueError(f"orient_mldb: mode {mode!r} is not 'pgather', 'pallas' or 'pepatch'")
    p = PATCH
    lvl = lvl.to(torch.int32)
    y0, x0 = patch_anchor(xf, yf, planes.shape[2], planes.shape[3])
    if mode == "pallas":
        patches = cut_patches(planes, lvl, y0, x0, p)

        def select(rel_x, rel_y, c0):
            return select_samples_patch(patches, rel_x, rel_y, c0)
    else:
        hook = external_mode(mode) if mode == "pepatch" else select_samples

        def select(rel_x, rel_y, c0):
            return hook(planes, lvl, y0, x0, rel_x, rel_y, c0)

    orel_x, orel_y = orientation_offsets(xf, yf, scale, width, height, x0, y0, p)
    angle = orientation_from_values(select(orel_x, orel_y, 1))  # (K, 2, 109) samples
    rel_x, rel_y, ok, co, si = mldb_offsets(xf, yf, scale, angle, width, height, x0, y0, p, pattern_size)
    vals = select(rel_x, rel_y, 0)  # (K, 3, 441)
    words = _mldb_pack(vals[:, 0], vals[:, 1], vals[:, 2], co, si, pattern_size)
    return words, ok, angle


# ---------------------------------------------------------------------------
# The group describe: keypoints sorted by their 256x256 window
# ---------------------------------------------------------------------------


def window_catalog_size(specs, b: int, hp: int, wp: int) -> int:
    """Static count of distinct 256x256 tile-aligned sampling windows the
    extract can occupy: the bound that makes the group tables static.  Per
    level, ``ty = clip(clip(yf - 64, 0, hp - 128) // 128, 0, ht - 2)`` with
    ``yf`` below the true height spans ``min((h - 65) // 128, ht - 2) + 1``
    values (the same for ``tx``)."""
    ht, wt = hp // 128, wp // 128
    total = 0
    for s in specs:
        nty = min(max(s.height - 65, 0) // 128, max(ht - 2, 0)) + 1
        ntx = min(max(s.width - 65, 0) // 128, max(wt - 2, 0)) + 1
        total += nty * ntx
    return b * total


def group_tables(lvl, ty, tx, valid, n_levels: int, ht: int, wt: int, g: int, ng_cap: int, w: int = 1):
    """Window-sorted padded group tables for :func:`select_groups`.

    Port of ``cv_tpu/akaze/descriptors.py::_group_tables``.  Slots are
    sorted (stably) by window key, invalid slots into a last segment keyed
    ``n_levels * ht * wt`` (one above the largest valid key).  A new group
    starts at every segment boundary and at every ``g``-th slot inside a
    segment, so every group has one window and at most ``ceil(K / g) +
    segments <= ng_cap`` groups exist.  The tables come in the column-major
    layout for ``w`` groups per TPU grid step: canonical group ``t`` sits at
    position ``(t % ngw) * w + t // ngw`` with ``ngw = ceil(ng_cap / w)``.

    Returns ``(perm, win_lvl, win_ty, win_tx, n_active, src_of, p_of)``:
    ``perm`` (K,) the sort order; ``win_*``/``n_active`` (NG,) int32 per
    table position; ``src_of`` (NG * g,) the sorted slot feeding each
    padded slot; ``p_of`` (K,) the padded slot of each sorted slot.
    """
    k = lvl.shape[0]
    dev = lvl.device
    i64 = torch.int64
    sentinel = n_levels * ht * wt
    key = torch.where(valid, (lvl.to(i64) * ht + ty.to(i64)) * wt + tx.to(i64), sentinel)
    lvl0, ty0, tx0 = (torch.where(valid, v.to(i64), 0) for v in (lvl, ty, tx))
    perm = torch.argsort(key, stable=True)
    ks = key[perm]
    iota = torch.arange(k, device=dev)
    newseg = torch.ones((k,), dtype=torch.bool, device=dev)
    newseg[1:] = ks[1:] != ks[:-1]
    seg_start = torch.cummax(torch.where(newseg, iota, 0), dim=0).values
    rank = iota - seg_start
    new_group = newseg | (rank % g == 0)
    group_id = torch.cumsum(new_group.to(i64), dim=0) - 1
    slot_in = rank % g

    ngw = -(-ng_cap // w)
    ng = ngw * w
    valid_s = valid[perm]
    # Each group has one boundary slot; the other slots write a dummy tail
    # entry that is cut (as are groups past the static bound, which JAX's
    # scatter drops).
    head = new_group & (group_id < ng)
    dump = torch.where(head, group_id, ng)

    def table(v, fill):
        buf = torch.full((ng + 1,), fill, dtype=i64, device=dev)
        buf[dump] = torch.where(head, v, fill)
        return buf

    win_lvl_c = table(lvl0[perm], 0)[:ng]
    win_ty_c = table(ty0[perm], 0)[:ng]
    win_tx_c = table(tx0[perm], 0)[:ng]
    j0_c = table(iota, k)
    # Groups tile the sorted axis in order: a group's size is the gap to
    # the next group's first slot (empty tail groups: k - k = 0).
    size_c = torch.clamp(j0_c[1:] - j0_c[:ng], 0, g)
    j0_c = j0_c[:ng]
    bvalid = valid_s[torch.clamp(j0_c, 0, k - 1)] & (j0_c < k)
    n_active_c = torch.where(bvalid, size_c, 0)

    q = torch.arange(ng, device=dev)
    stride_idx = (q % w) * ngw + q // w  # position q holds canonical group stride_idx
    i32 = torch.int32
    win_lvl, win_ty, win_tx, n_active = (
        t[stride_idx].to(i32) for t in (win_lvl_c, win_ty_c, win_tx_c, n_active_c)
    )
    j0 = j0_c[stride_idx]
    src_of = torch.clamp(j0[:, None] + torch.arange(g, device=dev)[None, :], 0, k - 1).reshape(-1)
    p_of = ((group_id % ngw) * w + group_id // ngw) * g + slot_in
    return perm, win_lvl, win_ty, win_tx, n_active, src_of, p_of


def orient_mldb_groups(planes, lvl, width, height, xf, yf, scale, valid, pattern_size: int, ng_cap: int, w: int = 1):
    """The group describe: orientation and M-LDB words with both sample
    passes through :func:`select_groups`.

    Port of ``cv_tpu/akaze/descriptors.py::orient_mldb_groups``.  ``K`` is
    padded to a multiple of 8; keypoints are sorted by the 256x256
    tile-aligned window that holds their 128x128 patch, grouped eight to a
    window, and every per-slot table is computed in the padded group layout;
    words, flags and angles are then put back in keypoint order.  Valid
    slots get the bits of :func:`orient_mldb`; invalid ones are computed
    from zero samples.  A stack below 256x256 raises ``ValueError``: it has
    no 256x256 window (``cv_tpu``'s ``descriptors.py:623`` asserts there).
    Returns ``(words (K, 16) int32, ok (K,), angle (K,))``.
    """
    g = GROUP
    k_in = xf.shape[0]
    hmax, wmax = planes.shape[2], planes.shape[3]
    ht, wt = hmax // 128, wmax // 128
    if ht < 2 or wt < 2:
        raise ValueError(
            f"orient_mldb_groups needs a padded stack of at least 256x256, got {hmax}x{wmax} "
            "(cv_tpu/akaze/descriptors.py:623 asserts ht >= 2 and wt >= 2); use 'pgather'"
        )
    pad_k = (-k_in) % g
    if pad_k:

        def pad(t, value):
            return torch.cat([t, torch.full((pad_k,), value, dtype=t.dtype, device=t.device)])

        lvl, width, height = pad(lvl, 0), pad(width, 128), pad(height, 128)
        xf, yf, scale = pad(xf, 64.0), pad(yf, 64.0), pad(scale, 1.0)
        valid = pad(valid, False)
    p = PATCH
    y0, x0 = patch_anchor(xf, yf, hmax, wmax)
    ty = torch.clamp(y0 // p, 0, ht - 2)
    tx = torch.clamp(x0 // p, 0, wt - 2)
    perm, win_lvl, win_ty, win_tx, n_active, src_of, p_of = group_tables(
        lvl.to(torch.int32), ty, tx, valid, planes.shape[0], ht, wt, g, ng_cap, w
    )
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)

    # Per padded slot: the original keypoint feeding it and its group's
    # window origin.
    osrc = perm[src_of]
    xf_p, yf_p, sc_p, w_p, h_p = (t[osrc] for t in (xf, yf, scale, width, height))
    x0_p = win_tx.repeat_interleave(g) * p
    y0_p = win_ty.repeat_interleave(g) * p
    span = 2 * p

    orel_x, orel_y = orientation_offsets(xf_p, yf_p, sc_p, w_p, h_p, x0_p, y0_p, span)
    vo = select_groups(planes, win_lvl, win_ty, win_tx, n_active, orel_x, orel_y, c0=1)
    angle_p = orientation_from_values(vo)
    rel_x, rel_y, ok_p, co, si = mldb_offsets(xf_p, yf_p, sc_p, angle_p, w_p, h_p, x0_p, y0_p, span, pattern_size)
    vals = select_groups(planes, win_lvl, win_ty, win_tx, n_active, rel_x, rel_y)
    words_p = _mldb_pack(vals[:, 0], vals[:, 1], vals[:, 2], co, si, pattern_size)
    back = p_of[inv]  # padded slot of each original keypoint
    return words_p[back][:k_in], ok_p[back][:k_in], angle_p[back][:k_in]


# ---------------------------------------------------------------------------
# The one-hot describe ('highest'): a float32 one-hot product per patch
# ---------------------------------------------------------------------------


def cut_patches_interleaved(stack, lvl, y0, x0, side: int = PATCH) -> torch.Tensor:
    """``(K, 3, side, side)`` windows of a pixel-interleaved ``(L, Hp,
    3 * Wp)`` stack (lane ``3 * x + channel``): one ``(side, 3 * side)`` slice
    a keypoint, de-interleaved (a relayout; the values are the channel-major
    cut's)."""
    yy = (y0.long()[:, None] + torch.arange(side, device=stack.device))[:, :, None]
    xx = (3 * x0.long()[:, None] + torch.arange(3 * side, device=stack.device))[:, None, :]
    raw = stack[lvl.long()[:, None, None], yy, xx]  # (K, side, 3 * side)
    return raw.reshape(raw.shape[0], side, side, 3).permute(0, 3, 1, 2)


def patch_select(patch: torch.Tensor, rel_x: torch.Tensor, rel_y: torch.Tensor) -> torch.Tensor:
    """``vals[k, c, n] = patch[k, c, rel_y[k, n], rel_x[k, n]]`` (0 where an
    index falls outside the patch) as an exact index gather: the bits of
    ``cv_tpu``'s one-hot product at ``Precision.HIGHEST`` (each of its sums
    has one nonzero term; a zero sample comes out +0 as the product's does),
    with no library product, so the caller's TF32 setting does not enter."""
    side_y, side_x = patch.shape[-2:]
    rx, ry = rel_x.long(), rel_y.long()
    inside = ((rx >= 0) & (rx < side_x) & (ry >= 0) & (ry < side_y))[:, None, :]
    k = torch.arange(patch.shape[0], device=patch.device)[:, None, None]
    c = torch.arange(patch.shape[1], device=patch.device)[None, :, None]
    vals = patch[k, c, ry.clamp(0, side_y - 1)[:, None, :], rx.clamp(0, side_x - 1)[:, None, :]]
    zero = torch.zeros((), dtype=patch.dtype, device=patch.device)
    return torch.where(inside, vals, zero) + zero


def orient_mldb_onehot(planes, lvl, width, height, xf, yf, scale, pattern_size: int = 10, chunk: int = 128,
                       interleaved: bool = False):
    """Orientation then M-LDB words through one patch cut per keypoint and
    the exact select of :func:`patch_select` (``cv_tpu``'s
    ``orient_mldb_onehot`` in mode ``'highest'``, a float32 one-hot product;
    ``interleaved``: ``'highest+inter'``, which cuts each patch from the
    pixel-interleaved stack).  ``chunk`` keypoints at a time bound the
    patches; the bits do not depend on it.
    Returns ``(words (K, 16) int32, ok (K,), angle (K,))``."""
    p = PATCH
    if interleaved:
        hmax, wmax = planes.shape[1], planes.shape[2] // 3
    else:
        hmax, wmax = planes.shape[2], planes.shape[3]
    y0, x0 = patch_anchor(xf, yf, hmax, wmax)
    words, oks, angles = [], [], []
    for a in range(0, xf.shape[0], chunk):
        c = slice(a, a + chunk)
        if interleaved:
            patch = cut_patches_interleaved(planes, lvl[c], y0[c], x0[c], p)
        else:
            patch = cut_patches(planes, lvl[c], y0[c], x0[c], p)
        orel_x, orel_y = orientation_offsets(xf[c], yf[c], scale[c], width[c], height[c], x0[c], y0[c], p)
        angle = orientation_from_values(patch_select(patch[:, 1:], orel_x, orel_y))
        rel_x, rel_y, ok, co, si = mldb_offsets(xf[c], yf[c], scale[c], angle, width[c], height[c], x0[c], y0[c],
                                                p, pattern_size)
        vals = patch_select(patch, rel_x, rel_y)
        words.append(_mldb_pack(vals[:, 0], vals[:, 1], vals[:, 2], co, si, pattern_size))
        oks.append(ok)
        angles.append(angle)
    if not words:
        k = xf.new_zeros((0, 16), dtype=torch.int32)
        return k, xf.new_zeros((0,), dtype=torch.bool), xf.new_zeros((0,))
    return torch.cat(words), torch.cat(oks), torch.cat(angles)


# ---------------------------------------------------------------------------
# Gather forms: the exact extractor's per-group planes and the fast path's
# flat buffers
# ---------------------------------------------------------------------------


def orientation_samples(lx, ly, sub, xf, yf, s):
    """The weighted orientation samples ``(res_x, res_y)`` (K, 109) of
    :func:`compute_orientations`."""
    ix, iy = orientation_positions(xf, yf, s, lx.shape[-1], lx.shape[-2])
    sub_b, ix, iy = sub.long()[:, None], ix.long(), iy.long()
    wt = _orientation_device_tables(lx.device)["wt"][None, :]
    return wt * lx[sub_b, iy, ix], wt * ly[sub_b, iy, ix]


def compute_orientations(lx, ly, sub, xf, yf, s) -> torch.Tensor:
    """Dominant orientation per keypoint (scale_space_extrema.rs:229-288)
    from one octave group's stacked ``(S, H, W)`` derivative planes:
    ``sub`` (K,) sublevel, ``xf``/``yf`` octave coords, ``s`` the rounded
    sampling scale."""
    return _orientation_from_samples(*orientation_samples(lx, ly, sub, xf, yf, s))


def mldb_samples(lt, lx, ly, sub, xf, yf, scale, angle, pattern_size: int = 10):
    """The sampled ``(ri, rx, ry)`` (K, U), ``ok``, ``co`` and ``si`` of
    :func:`compute_mldb_descriptors`."""
    x1, y1, ok, co, si = mldb_positions(xf, yf, scale, angle, lt.shape[-1], lt.shape[-2], pattern_size)
    sub_b, x1, y1 = sub.long()[:, None], x1.long(), y1.long()
    return lt[sub_b, y1, x1], lx[sub_b, y1, x1], ly[sub_b, y1, x1], ok, co, si


def compute_mldb_descriptors(lt, lx, ly, sub, xf, yf, scale, angle, pattern_size: int = 10):
    """486-bit M-LDB descriptors (descriptors.rs:55-202) from one octave
    group's stacked planes: ``(words (K, 16) int32, ok (K,))``, ``ok`` False
    when a sample falls out of the plane."""
    ri, rx, ry, ok, co, si = mldb_samples(lt, lx, ly, sub, xf, yf, scale, angle, pattern_size)
    return _mldb_pack(ri, rx, ry, co, si, pattern_size), ok


def orientation_flat(flat_pack, base, width, height, xf, yf, s) -> torch.Tensor:
    """:func:`compute_orientations` from one flat ``(P, 3)`` (Lt, Lx, Ly)
    buffer of every evolution: keypoint ``k`` reads pixel ``(x, y)`` of its
    plane at ``base[k] + y * width[k] + x``."""
    ix, iy = orientation_positions(xf, yf, s, width, height)
    idx = base.long()[:, None] + iy.long() * width.long()[:, None] + ix.long()
    vals = flat_pack[idx, 1:]  # (K, 109, 2)
    wt = _orientation_device_tables(xf.device)["wt"][None, :]
    return _orientation_from_samples(wt * vals[..., 0], wt * vals[..., 1])


def orientation_padded(planes, lvl, width, height, xf, yf, s) -> torch.Tensor:
    """:func:`compute_orientations` from the channel-major padded ``(L, 3,
    Hp, Wp)`` stack, keypoint ``k`` on plane ``lvl[k]``."""
    ix, iy = orientation_positions(xf, yf, s, width, height)
    lv, ix, iy = lvl.long()[:, None], ix.long(), iy.long()
    wt = _orientation_device_tables(xf.device)["wt"][None, :]
    return _orientation_from_samples(wt * planes[lv, 1, iy, ix], wt * planes[lv, 2, iy, ix])


def mldb_flat(flat_pack, base, width, height, xf, yf, scale, angle, pattern_size: int = 10):
    """:func:`compute_mldb_descriptors` from the flat ``(P, 3)`` buffer:
    ``(words (K, 16) int32, ok (K,))``."""
    x1, y1, ok, co, si = mldb_positions(xf, yf, scale, angle, width, height, pattern_size)
    idx = base.long()[:, None] + y1.long() * width.long()[:, None] + x1.long()
    vals = flat_pack[idx]  # (K, U, 3)
    return _mldb_pack(vals[..., 0], vals[..., 1], vals[..., 2], co, si, pattern_size), ok


def mldb_flat_onehot(planes, lvl, width, height, xf, yf, scale, angle, pattern_size: int = 10, chunk: int = 128):
    """:func:`mldb_flat` from the channel-major padded ``(L, 3, Hp, Wp)``
    stack: one 128 x 128 patch cut a keypoint (anchored at ``(int(yf) - 64,
    int(xf) - 64)`` clamped to the stack) and the exact select of
    :func:`patch_select` (``cv_tpu``'s one-hot product), ``chunk`` keypoints
    at a time.  Returns ``(words (K, 16) int32, ok (K,))``, the bits of
    :func:`mldb_flat`."""
    x1, y1, ok, co, si = mldb_positions(xf, yf, scale, angle, width, height, pattern_size)
    p = PATCH
    hmax, wmax = planes.shape[2], planes.shape[3]
    y0 = torch.clamp(yf.to(torch.int32) - p // 2, 0, hmax - p)
    x0 = torch.clamp(xf.to(torch.int32) - p // 2, 0, wmax - p)
    rel_y = torch.clamp(y1 - y0[:, None], 0, p - 1)
    rel_x = torch.clamp(x1 - x0[:, None], 0, p - 1)
    vals = [patch_select(cut_patches(planes, lvl[c], y0[c], x0[c], p), rel_x[c], rel_y[c])
            for c in (slice(a, a + chunk) for a in range(0, xf.shape[0], chunk))]
    vals = torch.cat(vals) if vals else planes.new_zeros((0, 3, x1.shape[1]))
    return _mldb_pack(vals[:, 0], vals[:, 1], vals[:, 2], co, si, pattern_size), ok
