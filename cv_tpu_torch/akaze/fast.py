"""Batched AKAZE extraction on one device (the throughput path).

Port of ``cv_tpu/akaze/fast.py``.  The pipeline keeps static per-frame
budgets: per-evolution candidates (by exact pixel-order compaction, or the
strongest by a sort: ``topk_method``), the reference's sequential dedup (a
conflict prefilter plus an exact scan over the conflicted candidates),
sub-pixel refinement of a preselection, the global top-M, then orientation
and M-LDB words through the select kernels (the describe mode picks which;
see :func:`check_describe_mode`), a float32 one-hot product (``'highest'``)
or plain gathers from one flat buffer (``sampler='gather'``).

Output is a fixed-budget :class:`FeatureSet` with validity masks.  Static
per-shape tables (border masks, slot tables, dedup radii) are built once
per image shape and device and reused.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from . import descriptors as desc
from . import extrema, fused
from .config import Akaze, allocate_evolutions
from .scale_space import build_scale_space


@dataclasses.dataclass(frozen=True)
class FeatureSet:
    """Batched keypoints + descriptors with a validity mask.

    All tensors have leading shape ``(B, M)`` (frames x feature budget).
    """

    point: torch.Tensor  # (B, M, 2) f32, octave-0 pixel coords
    response: torch.Tensor  # (B, M) f32
    size: torch.Tensor  # (B, M) f32
    angle: torch.Tensor  # (B, M) f32
    octave: torch.Tensor  # (B, M) int
    class_id: torch.Tensor  # (B, M) int
    words: torch.Tensor  # (B, M, 16) int32 bit patterns of the uint32 words
    valid: torch.Tensor  # (B, M) bool

    @property
    def count(self):
        return self.valid.sum(dim=-1)

    def to_numpy(self) -> dict:
        """Host arrays, with ``words`` as uint32 like the reference's."""
        out = {f.name: getattr(self, f.name).cpu().numpy() for f in dataclasses.fields(self)}
        out["words"] = out["words"].view(np.uint32)
        return out

    @classmethod
    def from_numpy(cls, arrays: dict, device=None) -> "FeatureSet":
        """From host arrays (``words`` as uint32 or int32 bit patterns)."""
        fields = {}
        for f in dataclasses.fields(cls):
            a = np.asarray(arrays[f.name])
            if f.name == "words":
                a = a.view(np.int32)
            fields[f.name] = torch.tensor(a, device=device)
        return cls(**fields)


def _octave_groups(planes):
    """Consecutive evolutions that share a plane shape (one octave)."""
    groups = []
    for i, p in enumerate(planes):
        shape = tuple(p.ldet.shape[-2:])
        if groups and groups[-1][0] == shape:
            groups[-1][1].append(i)
        else:
            groups.append([shape, [i]])
    return groups


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: equal values keep the lower
    index first (a stable sort; ``torch.topk`` promises no tie order)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _border_ok_1d(n, s):
    """Reference border predicate along one axis, f32-exact
    (scale_space_extrema.rs:96-104): round half-away-from-zero."""
    v = np.arange(n, dtype=np.float32)

    def rnd(x):
        return np.sign(x) * np.floor(np.abs(x) + np.float32(0.5))

    lo = rnd(v - np.float32(s)) - np.float32(1.0) >= 0.0
    hi = rnd(v + np.float32(s)) + np.float32(1.0) < np.float32(n)
    return lo & hi


@lru_cache(maxsize=None)
def _border_mask(specs: tuple, derivative_factor: float, h: int, w: int, device) -> torch.Tensor:
    """(S, H, W) bool: pixels of each evolution far enough from the border."""
    border = np.empty((len(specs), h, w), bool)
    for j, s in enumerate(specs):
        smax_ss = float(extrema.SMAX) * float(
            np.round(
                np.float32(np.float32(s.esigma) * derivative_factor)
                / np.float32(2.0**s.octave)
            )
        )
        border[j] = _border_ok_1d(h, smax_ss)[:, None] & _border_ok_1d(w, smax_ss)[None, :]
    return torch.as_tensor(border, device=device)


# ---------------------------------------------------------------------------
# Stage 1: per-evolution candidate selection
# ---------------------------------------------------------------------------


TOPK_METHODS = ("compact", "block", "raw", "approx")


def stage_candidates(cfg, specs, planes, k, topk_method: str = "compact"):
    """Masked per-evolution candidates, pixel-order sorted.

    ``topk_method`` fills the per-evolution budget of ``k``:

    * ``"compact"``: the first ``k`` in pixel order (the reference iterates
      candidates in pixel order with no budget, so this is the faithful
      overflow policy);
    * ``"block"``: the strongest ``k``, ranked over 2x2 block maxima (a
      strict 3x3 maximum excludes its 8 neighbours, so a block holds at most
      one candidate);
    * ``"raw"``: the strongest ``k`` of the whole plane;
    * ``"approx"``: ``cv_tpu``'s ``jax.lax.approx_max_k`` (recall target
      0.99), which is an approximation on a TPU only; elsewhere it returns
      the exact top-k, ties included, so the port's ``"approx"`` is
      ``"raw"``.

    The strongest-``k`` methods then re-sort each evolution's slots by pixel
    index.  Border rejection is folded into the mask (the reference rejects
    border keypoints before they enter the dedup cache, so they can neither
    survive nor suppress others).
    """
    if topk_method not in TOPK_METHODS:
        raise ValueError(f"topk_method {topk_method!r}: use one of {TOPK_METHODS}")
    b = planes[0].ldet.shape[0]
    dev = planes[0].ldet.device
    resp_list = [None] * len(planes)
    idx_list = [None] * len(planes)
    for (h_g, w_g), idxs_g in _octave_groups(planes):
        stacked = torch.stack([planes[i].ldet for i in idxs_g], dim=1)
        s_count = len(idxs_g)
        mask = extrema.candidate_mask(stacked, cfg.detector_threshold)
        border = _border_mask(
            tuple(planes[i].spec for i in idxs_g), cfg.derivative_factor, h_g, w_g, dev
        )
        mask &= border[None]
        masked = torch.where(mask, stacked, -torch.inf)
        if topk_method == "compact":
            resp_g, idx_g = _compact_candidates(masked.reshape(b * s_count, -1), k)
        elif topk_method == "block":
            resp_g, idx_g = _block_top_k(masked.reshape((b * s_count,) + masked.shape[-2:]), k)
        else:
            resp_g, idx_g = _top_k(masked.reshape(b * s_count, -1), k)
        resp_g = resp_g.reshape(b, s_count, k)
        idx_g = idx_g.reshape(b, s_count, k)
        for j, i in enumerate(idxs_g):
            resp_list[i] = resp_g[:, j]
            idx_list[i] = idx_g[:, j]

    cand = []
    for p, resp, idx in zip(planes, resp_list, idx_list):
        valid = torch.isfinite(resp)
        s = p.spec
        x = (idx % s.width).to(torch.float32)
        y = (idx // s.width).to(torch.float32)
        ratio = np.float32(2.0**s.octave)
        size = np.float32(np.float32(s.esigma) * np.float32(cfg.derivative_factor))
        sigma_size = np.float32(np.round(size / ratio))
        # Border rejection (scale_space_extrema.rs:96-104), vectorized.
        reach = float(extrema.SMAX * sigma_size)
        left = torch.round(x - reach) - 1.0
        right = torch.round(x + reach) + 1.0
        up = torch.round(y - reach) - 1.0
        down = torch.round(y + reach) + 1.0
        valid &= (left >= 0) & (right < s.width) & (up >= 0) & (down < s.height)
        off = float(np.float32(0.5) * (ratio - np.float32(1.0)))
        cand.append(
            dict(
                spec=s,
                x=x,
                y=y,
                # octave-0 coords with the +off shift applied once
                px=x * float(ratio) + off,
                py=y * float(ratio) + off,
                resp=torch.where(valid, resp, -torch.inf),
                idx=idx,
                valid=valid,
                size=size,
            )
        )
    if topk_method == "compact":
        # Compaction emits pixel order with the empty slots last.
        return cand
    # The strongest k come in response order: re-sort each evolution's
    # slots by pixel index, invalid slots last (the dedup's order).
    fields = ("x", "y", "px", "py", "resp", "idx", "valid")
    stacked_f = {f: torch.stack([c[f] for c in cand], dim=1) for f in fields}
    sort_key = torch.where(stacked_f["valid"], stacked_f["idx"], torch.iinfo(torch.int32).max)
    order = torch.argsort(sort_key, dim=-1, stable=True)
    for f in fields:
        taken = stacked_f[f].gather(-1, order)
        for e, c in enumerate(cand):
            c[f] = taken[:, e]
    return cand


def _block_top_k(masked: torch.Tensor, k: int):
    """The strongest ``k`` of a (N, H, W) masked extrema plane through 2x2
    block maxima: each block's maximum and its flat pixel index (the first
    of equal values in block order), then :func:`_top_k` over the blocks.
    Returns responses and flat pixel indices, as a top-k of the raw plane."""
    n, h, w = masked.shape
    masked = torch.nn.functional.pad(masked, (0, w % 2, 0, h % 2), value=-torch.inf)
    hb, wb = masked.shape[1] // 2, masked.shape[2] // 2
    blocks = masked.reshape(n, hb, 2, wb, 2)
    rows = torch.arange(hb, device=masked.device)[None, :, None] * 2
    cols = torch.arange(wb, device=masked.device)[None, None, :] * 2
    best_v, best_i = None, None
    for dy in (0, 1):
        for dx in (0, 1):
            v = blocks[:, :, dy, :, dx]
            i = ((rows + dy) * w + (cols + dx)).expand(v.shape)
            if best_v is None:
                best_v, best_i = v, i
            else:
                take = v > best_v
                best_v, best_i = torch.where(take, v, best_v), torch.where(take, i, best_i)
    r, pos = _top_k(best_v.reshape(n, -1), k)
    return r, best_i.reshape(n, -1).gather(1, pos)


def _compact_candidates(masked: torch.Tensor, k: int):
    """The first ``k`` finite entries of each row in pixel order.

    ``masked``: (N, T) plane rows with non-candidates at -inf.  Returns
    ``(resp, idx)`` (N, k); empty slots hold -inf and index ``T - 1``, as in
    the reference.  A running count ranks the candidates and one scatter
    places them; candidates past ``k`` land in a spill column that is cut.
    """
    n, total = masked.shape
    fin = torch.isfinite(masked)
    rank = torch.cumsum(fin, dim=1) - 1
    slot = torch.where(fin & (rank < k), rank, k)
    resp = torch.full((n, k + 1), -torch.inf, dtype=masked.dtype, device=masked.device)
    idx = torch.full((n, k + 1), total - 1, dtype=torch.int64, device=masked.device)
    resp.scatter_(1, slot, masked)
    pix = torch.arange(total, device=masked.device).expand(n, total)
    idx.scatter_(1, slot, pix)
    return resp[:, :k], idx[:, :k]


# ---------------------------------------------------------------------------
# Stage 2: cross-scale dedup (conflict prefilter + exact sequential scan)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _dedup_radii(sizes: tuple, ratios: tuple, device):
    """Squared conservative conflict radii: within one evolution and between
    adjacent evolutions.  The slack covers the shifted-vs-unshifted
    coordinates the scan compares (see the reference's stage_dedup)."""

    def pair_slack(ra, rb):
        return 0.5 * (max(ra, rb) - 1.0) * np.sqrt(2.0) + 1e-3

    n_evo = len(sizes)
    r_self = np.array(
        [(sizes[e] + pair_slack(ratios[e], ratios[e])) ** 2 for e in range(n_evo)],
        np.float32,
    )
    r_pair = np.array(
        [
            (max(sizes[e], sizes[e + 1]) + pair_slack(ratios[e], ratios[e + 1])) ** 2
            for e in range(n_evo - 1)
        ],
        np.float32,
    )
    return torch.as_tensor(r_self, device=device), torch.as_tensor(r_pair, device=device)


def stage_dedup(cand, k, scan_cap):
    """Exact sequential dedup over a frame batch.

    Candidates with no conflict inside a conservative superset radius bypass
    the scan as definite survivors; only conflicted ones are compacted into
    the (capped) sequential scan.  Updates each ``cand[e]['valid']``.
    """
    b = cand[0]["x"].shape[0]
    dev = cand[0]["x"].device
    n_evo = len(cand)
    ratios = [np.float32(2.0 ** c["spec"].octave) for c in cand]
    px_cmp = torch.cat([c["x"] * float(r) for c, r in zip(cand, ratios)], dim=1)
    py_cmp = torch.cat([c["y"] * float(r) for c, r in zip(cand, ratios)], dim=1)
    px_store = torch.cat([c["px"] for c in cand], dim=1)
    py_store = torch.cat([c["py"] for c in cand], dim=1)
    resp_all = torch.cat([c["resp"] for c in cand], dim=1)
    cls_all = torch.arange(n_evo, device=dev).repeat_interleave(k).expand(b, -1)
    size2_all = torch.cat(
        [torch.full((b, k), float(c["size"] * c["size"]), device=dev) for c in cand], dim=1
    )
    valid_all = torch.cat([c["valid"] for c in cand], dim=1)

    # Conflict prefilter over stacked (B, E, K, K) tensors: a candidate with
    # no other candidate of the same or an adjacent evolution within the
    # radius can neither suppress nor be suppressed/replaced.
    r_self, r_pair = _dedup_radii(
        tuple(float(c["size"]) for c in cand), tuple(float(r) for r in ratios), dev
    )
    px_s = px_store.reshape(b, n_evo, k)
    py_s = py_store.reshape(b, n_evo, k)
    val_s = valid_all.reshape(b, n_evo, k)

    dx = px_s[:, :, :, None] - px_s[:, :, None, :]
    dy = py_s[:, :, :, None] - py_s[:, :, None, :]
    close = (dx * dx + dy * dy) <= r_self[None, :, None, None]
    close &= ~torch.eye(k, dtype=torch.bool, device=dev)[None, None]  # never self
    close &= val_s[:, :, None, :] & val_s[:, :, :, None]
    conflicted = close.any(dim=-1)  # (B, E, K)

    dxa = px_s[:, :-1, :, None] - px_s[:, 1:, None, :]
    dya = py_s[:, :-1, :, None] - py_s[:, 1:, None, :]
    close_a = (dxa * dxa + dya * dya) <= r_pair[None, :, None, None]
    close_a &= val_s[:, :-1, :, None] & val_s[:, 1:, None, :]
    zpad = torch.zeros((b, 1, k), dtype=torch.bool, device=dev)
    conflicted = (
        conflicted
        | torch.cat([close_a.any(dim=-1), zpad], dim=1)  # lower evo vs upper
        | torch.cat([zpad, close_a.any(dim=-2)], dim=1)  # upper evo vs lower
    )

    conf_all = conflicted.reshape(b, n_evo * k) & valid_all
    c_total = conf_all.shape[1]
    scan_cap = min(scan_cap, c_total)
    # Stable compaction: conflicted candidates first, original order kept.
    comp_key = torch.where(conf_all, 0, 1) * c_total + torch.arange(c_total, device=dev)
    comp_order = torch.argsort(comp_key, dim=1)[:, :scan_cap]

    def takec(a):
        return a.gather(1, comp_order)

    n_steps = torch.clamp(conf_all.sum(dim=1), max=scan_cap)
    survive_scan = extrema.dedup_scan_device(
        takec(px_cmp),
        takec(py_cmp),
        takec(px_store),
        takec(py_store),
        takec(resp_all),
        takec(cls_all),
        takec(size2_all),
        takec(valid_all & conf_all),
        n_steps,
    )
    # Scatter scan survivors back. Non-conflicted valid candidates pass
    # straight through, as do conflicted candidates beyond the scan cap
    # (keep-don't-drop overflow policy).
    conf_rank = torch.cumsum(conf_all, dim=1) - 1
    overflow = conf_all & (conf_rank >= scan_cap)
    survive = valid_all & (~conf_all | overflow)
    survive = survive.scatter(1, comp_order, takec(survive) | survive_scan)
    for e in range(n_evo):
        cand[e]["valid"] = survive[:, e * k : (e + 1) * k]
    return cand


# ---------------------------------------------------------------------------
# Stage 3: the padded plane stack + static per-slot tables
# ---------------------------------------------------------------------------


def padded_shape(h: int, w: int):
    """The padded stack's plane size: multiples of 128, at least 128."""
    return -(-max(128, h) // 128) * 128, -(-max(128, w) // 128) * 128


def flat_ldet_buffer(planes):
    """One ``(B, P)`` Ldet buffer spanning every evolution (``cv_tpu``'s
    subpixel gather layout): evolution ``e``'s pixel ``(x, y)`` sits at
    ``base[e] + y * width[e] + x``."""
    b = planes[0].ldet.shape[0]
    return torch.cat([p.ldet.reshape(b, -1) for p in planes], dim=1)


def flat_pack_buffer(planes):
    """(B, P, 3) packed (Lt, Lx, Ly) buffer of every evolution's pixels, for
    the ``'gather'`` sampler: keypoint ``k`` of evolution ``e`` reads pixel
    ``(x, y)`` at ``base[e] + y * width[e] + x``."""
    b = planes[0].ldet.shape[0]
    return torch.cat([torch.stack([p.lt.reshape(b, -1), p.lx.reshape(b, -1), p.ly.reshape(b, -1)], dim=-1)
                      for p in planes], dim=1)


def padded_plane_stack(planes):
    """(B*n_evo, 3, Hp, Wp) zero-padded (Lt, Lx, Ly) stack: the sampling
    source for orientation and M-LDB, padded to multiples of 128 (and at
    least one 128x128 window)."""
    b = planes[0].ldet.shape[0]
    n_evo = len(planes)
    hp, wp = padded_shape(planes[0].lt.shape[-2], planes[0].lt.shape[-1])
    out = torch.zeros((b, n_evo, 3, hp, wp), dtype=planes[0].lt.dtype, device=planes[0].lt.device)
    for e, p in enumerate(planes):
        ho, wo = p.lt.shape[-2], p.lt.shape[-1]
        for ch, arr in enumerate((p.lt, p.lx, p.ly)):
            out[:, e, ch, :ho, :wo] = arr
    return out.reshape(b * n_evo, 3, hp, wp)


def padded_plane_stack_interleaved(planes):
    """(B*n_evo, Hp, 3*Wp) pixel-interleaved (Lt, Lx, Ly) stack, lane ``3 *
    x + channel``: the layout of ``'highest+inter'``, whose patch cut is one
    (128, 384) slice a keypoint.  Zero-padded as :func:`padded_plane_stack`."""
    b = planes[0].ldet.shape[0]
    n_evo = len(planes)
    hp, wp = padded_shape(planes[0].lt.shape[-2], planes[0].lt.shape[-1])
    out = torch.zeros((b, n_evo, hp, wp, 3), dtype=planes[0].lt.dtype, device=planes[0].lt.device)
    for e, p in enumerate(planes):
        ho, wo = p.lt.shape[-2], p.lt.shape[-1]
        for ch, arr in enumerate((p.lt, p.lx, p.ly)):
            out[:, e, :ho, :wo, ch] = arr
    return out.reshape(b * n_evo, hp, 3 * wp)


def slot_tables(cfg, specs, k):
    """Static per-slot numpy tables over the concatenated candidate axis."""
    n_evo = len(specs)
    sizes_px = [s.height * s.width for s in specs]
    bases = np.concatenate([[0], np.cumsum(sizes_px)[:-1]]).astype(np.int32)
    return dict(
        slot_cls=np.repeat(np.arange(n_evo), k).astype(np.int32),
        width=np.array([s.width for s in specs], np.int32),
        height=np.array([s.height for s in specs], np.int32),
        base=bases,
        power=np.array([2.0**s.octave for s in specs], np.float32),
        octave=np.array([s.octave for s in specs], np.int32),
        size2x=np.array(
            [
                np.float32(np.float32(s.esigma) * np.float32(cfg.derivative_factor))
                * np.float32(2.0)
                for s in specs
            ],
            np.float32,
        ),
        ssamp=np.array(
            [
                np.float32(
                    np.round(
                        np.float32(np.float32(s.esigma) * cfg.derivative_factor)
                        / np.float32(2.0**s.octave)
                    )
                )
                for s in specs
            ],
            np.float32,
        ),
    )


@lru_cache(maxsize=None)
def _slot_tables_device(cfg, specs: tuple, k: int, device) -> dict:
    tables = slot_tables(cfg, list(specs), k)
    out = {n: torch.as_tensor(v, device=device) for n, v in tables.items()}
    out["slot_cls"] = out["slot_cls"].long()
    return out


# ---------------------------------------------------------------------------
# Stage 4: subpixel refinement + global top-M selection
# ---------------------------------------------------------------------------


def stage_refine_select(cfg, specs, cand, planes, k, max_features, slack=128):
    """Preselect the top (M + slack) candidates by response, subpixel-refine
    only those, then keep the final top-M as (B, M) selection tensors.

    Refinement never changes a response — it only *drops* keypoints with
    |delta| > 1 — so refining the top (M + slack) is exact unless more than
    ``slack`` of them fail refinement.
    """
    b = planes[0].ldet.shape[0]
    t = _slot_tables_device(cfg, tuple(specs), k, planes[0].ldet.device)
    c_total = len(specs) * k

    x_all = torch.cat([c["x"] for c in cand], dim=1).to(torch.int64)
    y_all = torch.cat([c["y"] for c in cand], dim=1).to(torch.int64)
    resp_ok = torch.where(
        torch.cat([c["valid"] for c in cand], dim=1),
        torch.cat([c["resp"] for c in cand], dim=1),
        -torch.inf,
    )

    # Preselect by response (refinement is response-preserving).
    m = min(max_features, c_total)
    pre_m = min(m + slack, c_total)
    resp1, idx1 = _top_k(resp_ok, pre_m)  # (B, P)
    cls1 = t["slot_cls"][idx1]
    x1 = x_all.gather(1, idx1)
    y1 = y_all.gather(1, idx1)
    xs = torch.minimum(x1.clamp(min=1), t["width"][cls1] - 2)
    ys = torch.minimum(y1.clamp(min=1), t["height"][cls1] - 2)

    # Octave-group gathers of the 3x3 Ldet neighbourhood, merged by group
    # membership.
    offsets = [(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    samples = {o: torch.zeros_like(resp1) for o in offsets}
    for (h_g, w_g), idxs_g in _octave_groups(planes):
        flat_g = torch.stack([planes[i].ldet for i in idxs_g], dim=1).reshape(b, -1)
        first = idxs_g[0]
        in_g = (cls1 >= first) & (cls1 < first + len(idxs_g))
        lvl_loc = torch.clamp(cls1 - first, 0, len(idxs_g) - 1)
        xs_g = torch.clamp(x1, 1, w_g - 2)
        ys_g = torch.clamp(y1, 1, h_g - 2)
        center_g = (lvl_loc * h_g + ys_g) * w_g + xs_g
        for dx, dy in offsets:
            val = flat_g.gather(1, center_g + dy * w_g + dx)
            samples[(dx, dy)] = torch.where(in_g, val, samples[(dx, dy)])

    dst0, dst1, refine_ok = extrema.refine_from_samples(lambda dx, dy: samples[(dx, dy)])
    resp1 = torch.where(refine_ok, resp1, -torch.inf)
    pw = t["power"][cls1]
    px = (xs.to(torch.float32) + dst0) * pw + 0.5 * (pw - 1.0)
    py = (ys.to(torch.float32) + dst1) * pw + 0.5 * (pw - 1.0)

    # Final top-M among the refined preselection.
    top_resp, top_idx = _top_k(resp1, m)  # (B, M)
    sel_cls = cls1.gather(1, top_idx)
    return dict(
        resp=top_resp,
        cls=sel_cls,
        base=t["base"][sel_cls],
        w=t["width"][sel_cls],
        h=t["height"][sel_cls],
        pw=t["power"][sel_cls],
        size=t["size2x"][sel_cls],
        ssamp=t["ssamp"][sel_cls],
        oct=t["octave"][sel_cls],
        px=px.gather(1, top_idx),
        py=py.gather(1, top_idx),
        valid=torch.isfinite(top_resp),
    )


# ---------------------------------------------------------------------------
# Stage 5: orientation + M-LDB descriptors
# ---------------------------------------------------------------------------


# Describe modes with a kernel (cv_tpu's names), those of them cv_tpu also
# runs on the pixel-interleaved stack, the one-hot product, and cv_tpu's
# TPU matrix-unit workarounds, which the port does not have.
KERNEL_MODES = ("pgather", "pgroups", "pfused", "pallas", "pepatch", "ptiles")
INTER_MODES = ("pgather+inter", "pallas+inter")
ONEHOT_MODES = ("highest", "highest+inter")
TPU_MODES = ("bf16x3", "bf16x3k", "+fused")


def check_describe_mode(mode: str | None) -> None:
    """Raise ``ValueError`` unless ``mode`` is None (the default rule) or a
    describe mode of ``cv_tpu`` that the port has: ``'pgather'`` (the select
    kernel), ``'pgroups'``/``'pgroupsN'`` (the group select, N groups per TPU
    grid step; a table layout only here), ``'pfused'`` (the fused describe),
    ``'pallas'`` (the patch-form select), the retired ``'pepatch'`` /
    ``'ptiles'``, which run once ``cv_tpu_torch.experiments.mldb_losers`` is
    imported (an extract raises ``KeyError`` before), ``'highest'`` /
    ``'highest+inter'`` (cv_tpu's default off the TPU: a float32 one-hot
    product there, the exact index gather of ``descriptors.patch_select``
    here, from the channel-major or the pixel-interleaved stack), or
    ``'pgather+inter'`` / ``'pallas+inter'`` (the select kernel and the
    patch-form select on the pixel-interleaved stack).  ``cv_tpu`` fails on
    ``'+inter'`` with any other kernel mode, and so it is refused here."""
    if mode is None or mode in KERNEL_MODES or mode in ONEHOT_MODES or mode in INTER_MODES:
        return
    if mode.startswith("pgroups") and mode[7:].isdigit() and int(mode[7:]) > 0:
        return
    known = ", ".join(map(repr, KERNEL_MODES + INTER_MODES + ONEHOT_MODES))
    base, plus, suffix = mode.partition("+")
    if base in TPU_MODES or suffix.startswith("fused"):
        raise ValueError(
            f"describe mode {mode!r}: {', '.join(map(repr, TPU_MODES))} are cv_tpu's workarounds for its TPU "
            "matrix unit (exact bf16 splits of the one-hot product, XLA's fused row reduce); they give "
            f"'highest''s bits and are not ported.  Use one of {known}"
        )
    if plus:
        raise ValueError(
            f"describe mode {mode!r}: '+inter' (the pixel-interleaved stack) is ported for 'highest', 'pgather' "
            f"and 'pallas'; cv_tpu itself fails on {mode!r} ('pfused' and 'pgroups' index the interleaved stack "
            "as channel-major and raise IndexError, 'pepatch' and 'ptiles' assert a channel-major stack at its "
            f"akaze/descriptors.py:744, :778), so it is not ported.  Use one of {known}"
        )
    raise ValueError(f"unknown describe mode {mode!r}; use one of {known}")


def default_describe_mode(max_features: int, height: int, width: int) -> str:
    """``cv_tpu``'s rule on its accelerator: the group describe at 2048 or
    more features, else the select kernel; and the select kernel too when
    the padded stack has no 256x256 window (where ``cv_tpu``'s group
    describe asserts, descriptors.py:623)."""
    hp, wp = padded_shape(height, width)
    return "pgroups" if max_features >= 2048 and hp >= 256 and wp >= 256 else "pgather"


def stage_describe(cfg, planes, sel, mode: str = "pgather", sampler: str = "onehot") -> FeatureSet:
    """Dominant orientation then M-LDB words for the selected keypoints,
    through describe ``mode`` (see :func:`check_describe_mode`), or with
    ``sampler='gather'`` through plain gathers from :func:`flat_pack_buffer`
    (``cv_tpu``'s ``orientation_flat`` / ``mldb_flat``; the mode is unused)."""
    if sampler not in ("onehot", "gather"):
        raise ValueError(f"sampler {sampler!r}: use 'onehot' or 'gather'")
    check_describe_mode(mode)
    b, m = sel["resp"].shape
    n_evo = len(planes)
    xf = (sel["px"] / sel["pw"]).reshape(-1)
    yf = (sel["py"] / sel["pw"]).reshape(-1)
    if sampler == "gather":
        flat = flat_pack_buffer(planes)
        total = flat.shape[1]
        base = (torch.arange(b, device=flat.device)[:, None] * total + sel["base"]).reshape(-1)
        flat = flat.reshape(-1, 3)
        kp = (base, sel["w"].reshape(-1), sel["h"].reshape(-1), xf, yf, sel["ssamp"].reshape(-1))
        angle = desc.orientation_flat(flat, *kp)
        words, w_ok = desc.mldb_flat(flat, *kp, angle, pattern_size=cfg.descriptor_pattern_size)
        return _feature_set(sel, words, w_ok, angle)
    # '+inter' swaps the stack for the pixel-interleaved one (only it is built).
    interleaved = mode.endswith("+inter")
    mode = mode.removesuffix("+inter")
    stack = padded_plane_stack_interleaved(planes) if interleaved else padded_plane_stack(planes)
    lvl = (torch.arange(b, device=sel["cls"].device)[:, None] * n_evo + sel["cls"]).reshape(-1)
    kp = (lvl, sel["w"].reshape(-1), sel["h"].reshape(-1), xf, yf, sel["ssamp"].reshape(-1))
    if mode == "highest":
        words, w_ok, angle = desc.orient_mldb_onehot(stack, *kp, pattern_size=cfg.descriptor_pattern_size,
                                                     interleaved=interleaved)
    elif mode.startswith("pgroups"):
        # The static group bound: one group per 8 slots plus one per window
        # the extract can occupy (cv_tpu/akaze/fast.py:711-713).
        hp, wp = stack.shape[-2], stack.shape[-1]
        ng_cap = -(-(b * m) // 8) + desc.window_catalog_size([p.spec for p in planes], b, hp, wp) + 1
        words, w_ok, angle = desc.orient_mldb_groups(
            stack, *kp, sel["valid"].reshape(-1), pattern_size=cfg.descriptor_pattern_size,
            ng_cap=ng_cap, w=int(mode[len("pgroups"):] or "1"),
        )
    elif mode == "pfused":
        words, w_ok, angle = fused.orient_mldb_fused(stack, *kp, pattern_size=cfg.descriptor_pattern_size)
    elif mode == "ptiles":
        words, w_ok, angle = desc.external_mode("ptiles")(stack, *kp, cfg.descriptor_pattern_size)
    else:
        words, w_ok, angle = desc.orient_mldb(stack, *kp, pattern_size=cfg.descriptor_pattern_size, mode=mode,
                                              interleaved=interleaved)
    return _feature_set(sel, words, w_ok, angle)


def _feature_set(sel, words, w_ok, angle) -> FeatureSet:
    """The selection's FeatureSet with its (B*M,) describe outputs."""
    b, m = sel["resp"].shape
    return FeatureSet(
        point=torch.stack([sel["px"], sel["py"]], dim=-1),
        response=sel["resp"],
        size=sel["size"],
        angle=angle.reshape(b, m),
        octave=sel["oct"],
        class_id=sel["cls"],
        words=words.reshape(b, m, -1),
        valid=sel["valid"] & w_ok.reshape(b, m),
    )


class DeviceExtractor:
    """Batched extractor on ``device`` (the CUDA card unless the caller
    asks for the CPU).

    ``candidate_budget``: max extrema kept per evolution (the first in
    pixel order).  ``max_features``: final per-frame feature budget M.
    ``dedup_scan_cap``: max conflicted candidates the sequential scan
    resolves (the rest are kept).  ``onehot_mode``: the describe mode (see
    :func:`check_describe_mode`); None takes :func:`default_describe_mode`.
    The modes give the same keypoints and words (on the CPU, where each
    runs its kernels' plain versions, up to one-ulp angle differences).
    ``sampler``: ``'onehot'`` (the describe mode) or ``'gather'`` (plain
    gathers from one flat buffer, the same bits).  ``topk_method``: how the
    per-evolution budget is filled (:func:`stage_candidates`).
    """

    def __init__(
        self,
        config: Akaze | None = None,
        candidate_budget: int = 256,
        max_features: int = 1024,
        dedup_scan_cap: int = 1024,
        device="cuda",
        onehot_mode: str | None = None,
        sampler: str = "onehot",
        topk_method: str = "compact",
    ):
        check_describe_mode(onehot_mode)
        if sampler not in ("onehot", "gather") or topk_method not in TOPK_METHODS:
            raise ValueError(f"sampler {sampler!r} / topk_method {topk_method!r}")
        self.config = config or Akaze()
        self.candidate_budget = candidate_budget
        self.max_features = max_features
        self.dedup_scan_cap = dedup_scan_cap
        self.device = torch.device(device)
        self.onehot_mode = onehot_mode
        self.sampler = sampler
        self.topk_method = topk_method
        self._specs: dict = {}

    def describe_mode(self, height: int, width: int) -> str:
        """The describe mode an extract of ``height`` x ``width`` frames takes."""
        if self.onehot_mode is not None:
            return self.onehot_mode
        return default_describe_mode(self.max_features, height, width)

    def specs(self, height: int, width: int):
        key = (height, width)
        if key not in self._specs:
            self._specs[key] = allocate_evolutions(self.config, width, height)
        return self._specs[key]

    @torch.no_grad()
    def extract(self, images) -> FeatureSet:
        """``images``: (B, H, W) float32 in [0, 1] -> FeatureSet on ``device``."""
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        cfg = self.config
        b, h, w = images.shape
        specs = self.specs(h, w)
        k = self.candidate_budget
        planes = build_scale_space(cfg, specs, images)
        cand = stage_candidates(cfg, specs, planes, k, self.topk_method)
        cand = stage_dedup(cand, k, self.dedup_scan_cap)
        sel = stage_refine_select(cfg, specs, cand, planes, k, self.max_features)
        return stage_describe(cfg, planes, sel, self.describe_mode(h, w), self.sampler)


class FastAkazeExtractor:
    """Engine-facing adapter over :class:`DeviceExtractor` (port of
    ``cv_tpu/akaze/fast.py:769-880``).

    ``extract(image) -> (keypoints dict, words)`` is the contract
    ``VSlam.kps_descriptors`` consumes (lib.rs:2195-2236): the fixed-budget
    :class:`FeatureSet` is mask-compacted to host arrays, already sorted by
    response descending, with words as uint32.  ``dispatch_extract`` /
    ``fetch_extract`` split extraction plus the frame's LSH sketch into an
    enqueue and one device-to-host copy, so a caller can queue frame n+1's
    extraction before frame n's engine work.
    """

    def __init__(self, config: Akaze | None = None, candidate_budget: int | None = None,
                 max_features: int | None = None, device="cuda"):
        self.config = config or Akaze()
        # The config's feature budget as-is (the engine passes
        # tracking_features straight through).
        m = max_features or self.config.maximum_features
        if candidate_budget is None:
            # Per-evolution candidate slots scale with the global budget.
            candidate_budget = max(512, m // 4)
        # The dedup scan covers the conflicted-candidate count, with the
        # reference's floor of 1024.
        self._dev = DeviceExtractor(
            self.config, candidate_budget=candidate_budget, max_features=m,
            dedup_scan_cap=max(1024, m), device=device,
        )

    @property
    def device(self):
        return self._dev.device

    def _images(self, image):
        from .extract import to_gray_f32

        return torch.as_tensor(to_gray_f32(image), device=self._dev.device)[None]

    def extract(self, image: np.ndarray):
        """Extraction without the sketch: ``(kp dict, words (n, 16) uint32)``."""
        kp, words, _ = self.fetch_extract((self._dev.extract(self._images(image)), None))
        return kp, words

    def extract_with_sketch(self, image: np.ndarray):
        """Extraction plus the frame's LSH sketch, fetched in one copy:
        ``(kp dict, words, sketch (16,) uint32)``."""
        return self.fetch_extract(self.dispatch_extract(image))

    @torch.no_grad()
    def dispatch_extract(self, image: np.ndarray):
        """Enqueue the extraction and the sketch; returns unfetched tensors."""
        from ..matching import lsh

        fs = self._dev.extract(self._images(image))
        cw = lsh._codewords_device(fs.words.device)
        sketch = lsh.sketch_from_distances(lsh.distance_matrix(fs.words[0], cw), fs.valid[0])
        return fs, sketch

    def fetch_extract(self, handle):
        """One device-to-host copy of a :meth:`dispatch_extract` handle ->
        ``(kp dict, words, sketch or None)``."""
        fs, sketch = handle
        host = fs.to_numpy()
        valid = host["valid"][0]
        kp = {key: host[key][0][valid] for key in ("point", "response", "size", "angle", "octave", "class_id")}
        sk = None if sketch is None else sketch.cpu().numpy().view(np.uint32)
        return kp, host["words"][0][valid], sk
