"""Keypoint orientation and M-LDB binary descriptors.

Port of ``cv_tpu/akaze/descriptors.py`` (reference
scale_space_extrema.rs:157-288 and descriptors.rs).  The static tables are
copies of the reference's NumPy host code.  The describe path is the
``pgather`` branch of ``orient_mldb_onehot``: both sample passes
(orientation, then M-LDB) read the padded plane stack through the
hand-written select kernel (:mod:`.select`), which reads the stack
directly and so never builds the per-keypoint patch buffer.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .select import select_samples

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


def _atan2_cv(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """OpenCV-equivalent atan2 in [0, 2pi) (scale_space_extrema.rs:236-239)."""
    two_pi = float(np.float32(2.0 * np.pi))
    return torch.remainder(torch.atan2(y, x) + two_pi, two_pi)


def _orientation_from_samples(res_x: torch.Tensor, res_y: torch.Tensor) -> torch.Tensor:
    """Sliding-window dominant orientation from weighted samples (K, 109)."""
    t = _orientation_device_tables(res_x.device)
    angs = _atan2_cv(res_y, res_x)
    two_pi = float(np.float32(2.0 * np.pi))
    a1 = t["ang1s"][None, :, None]
    a2 = t["ang2s"][None, :, None]
    ang = angs[:, None, :]
    in_window = ((a1 < a2) & (a1 < ang) & (ang < a2)) | (
        (a2 < a1) & (((ang > 0) & (ang < a2)) | ((ang > a1) & (ang < two_pi)))
    )  # (K, 42, 109)
    zero = torch.zeros((), dtype=res_x.dtype, device=res_x.device)
    sum_x = torch.where(in_window, res_x[:, None, :], zero).sum(dim=-1)
    sum_y = torch.where(in_window, res_y[:, None, :], zero).sum(dim=-1)
    val = sum_x * sum_x + sum_y * sum_y  # (K, 42)
    best = torch.argmax(val, dim=-1, keepdim=True)  # first max wins (`val > max`)
    angle = _atan2_cv(sum_y.gather(1, best)[:, 0], sum_x.gather(1, best)[:, 0])
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


def orient_mldb(
    planes: torch.Tensor,  # (L, 3, Hp, Wp) channel-major padded (Lt, Lx, Ly) stack
    lvl: torch.Tensor,  # (K,) plane index per keypoint
    width: torch.Tensor,  # (K,) true plane width (for the OOB mask)
    height: torch.Tensor,  # (K,)
    xf: torch.Tensor,  # (K,) octave coords
    yf: torch.Tensor,
    scale: torch.Tensor,  # (K,) rounded sampling scale
    pattern_size: int = 10,
):
    """Dominant orientation, then M-LDB words, for ``K`` keypoints.

    Port of ``orient_mldb_onehot``'s ``pgather`` mode.  Every sample of a
    keypoint lies in the 128x128 window anchored at ``(y0, x0)`` (the
    reference's patch), addressed as a window-relative offset; the select
    kernel reads ``planes[lvl, c, y0 + rel_y, x0 + rel_x]`` straight from the
    stack.  Returns ``(words (K, 16) int32, ok (K,), angle (K,))``.
    """
    t = {**_orientation_device_tables(xf.device), **_mldb_device_tables(pattern_size, xf.device)}
    p = PATCH
    hmax, wmax = planes.shape[2], planes.shape[3]
    lvl = lvl.to(torch.int32)
    y0 = torch.clamp(yf.to(torch.int32) - p // 2, 0, hmax - p)
    x0 = torch.clamp(xf.to(torch.int32) - p // 2, 0, wmax - p)
    w_hi = (width - 1)[:, None]
    h_hi = (height - 1)[:, None]

    # Orientation sample positions (109-disc), window-relative.
    ox = round_half_away(xf[:, None] + t["di"][None, :] * scale[:, None]).to(torch.int32)
    oy = round_half_away(yf[:, None] + t["dj"][None, :] * scale[:, None]).to(torch.int32)
    ox = torch.minimum(ox.clamp(min=0), w_hi)
    oy = torch.minimum(oy.clamp(min=0), h_hi)
    orel_x = torch.clamp(ox - x0[:, None], 0, p - 1).to(torch.int32)
    orel_y = torch.clamp(oy - y0[:, None], 0, p - 1).to(torch.int32)
    vo = select_samples(planes, lvl, y0, x0, orel_x, orel_y, c0=1)  # (K, 2, 109)
    res_x = t["wt"][None, :] * vo[:, 0]
    res_y = t["wt"][None, :] * vo[:, 1]
    angle = _orientation_from_samples(res_x, res_y)

    # M-LDB sample positions (need the angle).
    co = torch.cos(angle)[:, None]
    si = torch.sin(angle)[:, None]
    sc = scale[:, None]
    ks, ls = t["ks"][None, :], t["ls"][None, :]
    sy = yf[:, None] + (ls * co + ks * si) * sc
    sx = xf[:, None] + (-ls * si + ks * co) * sc
    x1 = round_half_away(sx).to(torch.int32)
    y1 = round_half_away(sy).to(torch.int32)
    oob = (x1 < 0) | (x1 > w_hi) | (y1 < 0) | (y1 > h_hi)
    ok = ~oob.any(dim=-1)
    x1 = torch.minimum(x1.clamp(min=0), w_hi)
    y1 = torch.minimum(y1.clamp(min=0), h_hi)
    rel_x = torch.clamp(x1 - x0[:, None], 0, p - 1).to(torch.int32)
    rel_y = torch.clamp(y1 - y0[:, None], 0, p - 1).to(torch.int32)
    vals = select_samples(planes, lvl, y0, x0, rel_x, rel_y, c0=0)  # (K, 3, 441)
    words = _mldb_pack(vals[:, 0], vals[:, 1], vals[:, 2], co, si, pattern_size)
    return words, ok, angle
