"""Scale-space extrema detection, sequential dedup, and sub-pixel refinement.

Port of ``cv_tpu/akaze/extrema.py`` (reference scale_space_extrema.rs):

* ``candidate_mask``: thresholded strict 3x3 maxima as shifted-tensor
  comparisons over the whole Ldet plane.
* ``extract_candidates`` / ``dedup_keypoints_exact``: the host form of the
  reference's dedup, a NumPy loop in float32 over each evolution's
  candidates in row-major order (cv_tpu's own, kept as the function the
  rest is held to).
* ``dedup_scan_device``: the same dedup with in-place replacement and the
  upper-scale suppression pass over a batch of candidate lists.  The JAX
  package runs it as a vmapped ``lax.while_loop``; on a CUDA tensor the
  wrapper launches the hand-written kernel ``csrc/dedup_scan.cu`` (one
  block per frame), on a CPU tensor it runs ``dedup_scan_plain``, a Python
  loop over candidates whose every step is vectorized over the frame batch.
  With ``with_slots`` both also give each survivor's cache slot, the
  keypoint order of ``dedup_keypoints_exact``.
* ``subpixel_refine_batch``: the 2x2 Newton step on the Ldet Hessian.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import kernels

SMAX = np.float32(10.0) * np.sqrt(np.float32(2.0))


def candidate_mask(ldet: torch.Tensor, threshold: float) -> torch.Tensor:
    """Strict 3x3 maxima above threshold, border-excluded.

    ``ldet`` is ``(..., H, W)``; returns a bool mask of the same shape.
    """
    h, w = ldet.shape[-2], ldet.shape[-1]
    c = ldet[..., 1:-1, 1:-1]
    # Strict max over the 8-neighborhood as c > max(neighbors), from a
    # horizontal 3-max (same form as the reference).
    row3 = torch.maximum(
        ldet[..., :, : w - 2], torch.maximum(ldet[..., :, 1 : w - 1], ldet[..., :, 2:])
    )  # (..., H, W-2) horizontal 3-max centered at x+1
    nmax = torch.maximum(
        torch.maximum(row3[..., : h - 2, :], row3[..., 2:, :]),  # rows y-1, y+1
        torch.maximum(ldet[..., 1:-1, : w - 2], ldet[..., 1:-1, 2:]),  # row y
    )
    m = torch.zeros(ldet.shape, dtype=torch.bool, device=ldet.device)
    m[..., 1:-1, 1:-1] = (c > threshold) & (c > nmax)
    return m


@dataclasses.dataclass
class Candidates:
    """Host-side raw candidates of one evolution, row-major order."""

    e_id: int
    octave: int
    esigma: float
    width: int
    height: int
    xs: np.ndarray  # int32
    ys: np.ndarray  # int32
    responses: np.ndarray  # float32


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def extract_candidates(specs, masks, responses) -> list[Candidates]:
    """Candidate masks and Ldet planes (tensors or arrays, one per
    evolution) -> host candidate lists in row-major order."""
    out = []
    for spec, m, r in zip(specs, masks, responses):
        ys, xs = np.nonzero(_host(m))
        out.append(
            Candidates(
                e_id=spec.index,
                octave=spec.octave,
                esigma=spec.esigma,
                width=spec.width,
                height=spec.height,
                xs=xs.astype(np.int32),
                ys=ys.astype(np.int32),
                responses=_host(r)[ys, xs].astype(np.float32),
            )
        )
    return out


def dedup_keypoints_exact(candidates: list[Candidates], derivative_factor: float) -> dict[str, np.ndarray]:
    """The reference's sequential dedup (scale_space_extrema.rs:60-143), on
    the host.

    All arithmetic in f32 to mirror the reference. Returns keypoint arrays
    in cache order: ``point`` (octave-0 coords, pre-subpixel),
    ``response``, ``size`` (esigma * derivative_factor, pre-doubling),
    ``octave``, ``class_id``, and the integer octave coords ``ixy`` for the
    refinement gather.
    """
    cache_pt = np.zeros((0, 2), np.float32)
    cache_resp = np.zeros((0,), np.float32)
    cache_class = np.zeros((0,), np.int64)
    cache_size = np.zeros((0,), np.float32)
    cache_ixy = np.zeros((0, 2), np.int32)
    cache_octave = np.zeros((0,), np.int64)

    for cand in candidates:
        if len(cand.xs) == 0:
            continue
        ratio = np.float32(2.0) ** np.float32(cand.octave)
        size = np.float32(cand.esigma * derivative_factor)
        size2 = size * size
        sigma_size = np.float32(np.round(size / ratio))
        w, h = np.float32(cand.width), np.float32(cand.height)
        off = np.float32(0.5) * (ratio - np.float32(1.0))
        for x, y, resp in zip(cand.xs, cand.ys, cand.responses):
            px = np.float32(x) * ratio  # no +off during dedup (":81-83")
            py = np.float32(y) * ratio
            # Compare with cached keypoints of same or lower-adjacent class.
            cls_ok = (cache_class == cand.e_id) | (cache_class == cand.e_id - 1)
            is_repeated = False
            is_extremum = True
            id_repeated = -1
            if cls_ok.any():
                idxs = np.nonzero(cls_ok)[0]
                dx = px - cache_pt[idxs, 0]
                dy = py - cache_pt[idxs, 1]
                dist = dx * dx + dy * dy
                close = dist <= size2
                if close.any():
                    k = idxs[np.argmax(close)]  # first close one (break)
                    if resp > cache_resp[k]:
                        is_repeated = True
                        id_repeated = k
                    else:
                        is_extremum = False
            if not is_extremum:
                continue
            # Border check in this evolution's coords (":96-104").
            left = np.float32(np.round(np.float32(x) - SMAX * sigma_size)) - 1.0
            right = np.float32(np.round(np.float32(x) + SMAX * sigma_size)) + 1.0
            up = np.float32(np.round(np.float32(y) - SMAX * sigma_size)) - 1.0
            down = np.float32(np.round(np.float32(y) + SMAX * sigma_size)) + 1.0
            if left < 0 or right >= w or up < 0 or down >= h:
                continue
            pt = np.array([np.float32(x) * ratio + off, np.float32(y) * ratio + off], np.float32)
            if is_repeated:
                cache_pt[id_repeated] = pt
                cache_resp[id_repeated] = resp
                cache_class[id_repeated] = cand.e_id
                cache_size[id_repeated] = size
                cache_ixy[id_repeated] = (x, y)
                cache_octave[id_repeated] = cand.octave
            else:
                cache_pt = np.concatenate([cache_pt, pt[None]], axis=0)
                cache_resp = np.append(cache_resp, resp)
                cache_class = np.append(cache_class, cand.e_id)
                cache_size = np.append(cache_size, size)
                cache_ixy = np.concatenate([cache_ixy, np.array([[x, y]], np.int32)], axis=0)
                cache_octave = np.append(cache_octave, cand.octave)

    # Upper-scale suppression (":120-140").
    n = len(cache_resp)
    keep = np.ones(n, bool)
    for i in range(n):
        js = np.arange(i + 1, n)
        if len(js) == 0:
            break
        upper = cache_class[js] == cache_class[i] + 1
        if not upper.any():
            continue
        js = js[upper]
        d = cache_pt[js] - cache_pt[i]
        dist = d[:, 0] ** 2 + d[:, 1] ** 2
        hit = (dist <= cache_size[i] * cache_size[i]) & (cache_resp[i] <= cache_resp[js])
        if hit.any():
            keep[i] = False

    return {
        "point": cache_pt[keep],
        "response": cache_resp[keep],
        "size": cache_size[keep],
        "class_id": cache_class[keep],
        "octave": cache_octave[keep],
        "ixy": cache_ixy[keep],
    }


def dedup_scan_plain(
    px_cmp: torch.Tensor,  # (B, C) unshifted octave-0 x = x * ratio
    py_cmp: torch.Tensor,
    px_store: torch.Tensor,  # (B, C) shifted octave-0 coords (stored on insert)
    py_store: torch.Tensor,
    resp: torch.Tensor,  # (B, C) f32
    class_id: torch.Tensor,  # (B, C) int evolution index
    size2: torch.Tensor,  # (B, C) f32 squared dedup radius of the candidate
    valid: torch.Tensor,  # (B, C) bool (threshold/extremum/border applied)
    n_steps: torch.Tensor | None = None,  # (B,): only the first n need scanning
    with_slots: bool = False,
):
    """Exact replica of the sequential dedup + upper-scale filter for a
    batch of frames.

    Candidates MUST be ordered (evolution-major, row-major pixel order),
    exactly as the reference's iteration (scale_space_extrema.rs:17-117).
    The keypoint cache lives in fixed-size tensors; the loop runs to the
    batch maximum of ``n_steps`` (one host read), and frames that finished
    earlier see invalid candidates, which change nothing (a step whose
    candidate is invalid in every frame is skipped).

    Returns a (B, C) bool mask over the *input candidate order*: True for
    candidates that survive as output keypoints.  With ``with_slots``,
    ``(mask, slots)``: ``slots`` (B, C) int32 holds each survivor's cache
    slot at its candidate's place and -1 elsewhere, so ordering the
    survivors by slot gives the cache order of ``dedup_keypoints_exact``.
    """
    b, c = px_cmp.shape
    dev = px_cmp.device
    if n_steps is None:
        n_steps = torch.full((b,), c, dtype=torch.int64, device=dev)
    steps = int(n_steps.max()) if b else 0
    # The cache never holds more entries than candidates scanned, so every
    # tensor is cut to the scanned prefix.
    cs = max(steps, 1)
    px_cmp, py_cmp, px_store, py_store, resp, class_id, size2 = (
        t[:, :cs] for t in (px_cmp, py_cmp, px_store, py_store, resp, class_id, size2)
    )
    rows = torch.arange(cs, device=dev)
    ok_all = valid[:, :cs] & (rows[None, :] < n_steps[:, None])

    cpx = torch.full((b, cs), torch.inf, dtype=px_cmp.dtype, device=dev)
    cpy = torch.full((b, cs), torch.inf, dtype=px_cmp.dtype, device=dev)
    cresp = torch.zeros((b, cs), dtype=resp.dtype, device=dev)
    ccls = torch.full((b, cs), -2, dtype=torch.int64, device=dev)  # -2 never matches
    csrc = torch.zeros((b, cs), dtype=torch.int64, device=dev)
    count = torch.zeros((b,), dtype=torch.int64, device=dev)
    cls_all = class_id.to(torch.int64)

    # A candidate invalid in every frame changes nothing: skip its step.
    for j in torch.nonzero(ok_all.any(dim=0))[:, 0].tolist():
        cls = cls_all[:, j : j + 1]
        cls_ok = (ccls == cls) | (ccls == cls - 1)
        dx = px_cmp[:, j : j + 1] - cpx
        dy = py_cmp[:, j : j + 1] - cpy
        close = cls_ok & ((dx * dx + dy * dy) <= size2[:, j : j + 1])
        exists = close.any(dim=1)
        first = close.to(torch.uint8).argmax(dim=1)  # first close one (break)
        prev_resp = cresp.gather(1, first[:, None])[:, 0]
        r = resp[:, j]
        is_rep = exists & (r > prev_resp)
        write = ~((exists & ~is_rep) | ~ok_all[:, j])
        slot = torch.where(is_rep, first, count)
        m = write[:, None] & (rows[None, :] == slot[:, None])
        cpx = torch.where(m, px_store[:, j : j + 1], cpx)
        cpy = torch.where(m, py_store[:, j : j + 1], cpy)
        cresp = torch.where(m, r[:, None], cresp)
        ccls = torch.where(m, cls, ccls)
        csrc = torch.where(m, j, csrc)
        count = count + (write & ~is_rep).to(torch.int64)

    # Upper-scale suppression over the final cache (":120-140"): entry i is
    # dropped when a *later slot* j of class_id+1 within radius size_i has
    # response >= resp_i.  Slots past the largest count are unused.
    used = max(int(count.max()) if b else 0, 1)
    cpx, cpy, cresp, ccls, csrc, rows = (t[..., :used] for t in (cpx, cpy, cresp, ccls, csrc, rows))
    slot_used = rows[None, :] < count[:, None]
    size2_cache = size2.gather(1, csrc)
    dx = cpx[:, :, None] - cpx[:, None, :]
    dy = cpy[:, :, None] - cpy[:, None, :]
    later = rows[None, :] > rows[:, None]
    upper = ccls[:, None, :] == (ccls[:, :, None] + 1)
    hit = (
        later[None]
        & upper
        & ((dx * dx + dy * dy) <= size2_cache[:, :, None])
        & (cresp[:, :, None] <= cresp[:, None, :])
        & slot_used[:, None, :]
    )
    keep = slot_used & ~hit.any(dim=-1)
    # Scatter back to candidate order. Unused slots all carry csrc == 0, so
    # a max-scatter keeps them from clobbering candidate 0.
    out = torch.zeros((b, c), dtype=torch.int64, device=dev)
    out.scatter_reduce_(1, csrc, keep.to(torch.int64), reduce="amax")
    if not with_slots:
        return out > 0
    slots = torch.full((b, c), -1, dtype=torch.int64, device=dev)
    slots.scatter_reduce_(1, csrc, torch.where(keep, rows[None, :], -1), reduce="amax")
    return out > 0, slots.to(torch.int32)


_DEDUP_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_DEDUP_SLOTS_ARGS = _DEDUP_ARGS + [ctypes.c_void_p]


def dedup_scan_device(px_cmp, py_cmp, px_store, py_store, resp, class_id, size2, valid,
                      n_steps=None, max_shared_slots: int | None = None, with_slots: bool = False):
    """The sequential dedup of :func:`dedup_scan_plain` (same arguments and
    result).  On a CPU tensor it runs the plain version; on a CUDA tensor it
    launches ``csrc/dedup_scan.cu`` or raises.  The kernel reads ``n_steps``
    on the device, so it needs no host sync.

    The kernel keeps its cache in shared memory when the cap ``C`` fits
    there (up to ~10,800 slots on an H100), else in global memory.
    ``max_shared_slots`` lowers that bound; ``0`` forces the global-memory
    cache, which is how the tests reach it at small caps.  ``with_slots``
    adds the survivors' cache slots (``cv_dedup_scan_slots``)."""
    args = (px_cmp, py_cmp, px_store, py_store, resp, class_id, size2, valid)
    devices = {t.device for t in args} | ({n_steps.device} if n_steps is not None else set())
    if len(devices) != 1:
        raise ValueError(f"dedup_scan_device: tensors on several devices {devices}")
    dev = px_cmp.device
    if dev.type == "cpu":
        return dedup_scan_plain(*args, n_steps, with_slots=with_slots)
    if dev.type != "cuda":
        raise ValueError(f"dedup_scan_device: unsupported device {dev}")
    b, c = px_cmp.shape
    for name, t in zip(("px_cmp", "py_cmp", "px_store", "py_store", "resp", "size2"),
                       (px_cmp, py_cmp, px_store, py_store, resp, size2)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, c):
            raise ValueError(f"{name} must be float32 {(b, c)}, got {t.dtype} {tuple(t.shape)}")
    if tuple(class_id.shape) != (b, c) or valid.dtype != torch.bool or tuple(valid.shape) != (b, c):
        raise ValueError("class_id and valid must be (B, C), valid bool")
    if n_steps is None:
        n_steps = torch.full((b,), c, dtype=torch.int32, device=dev)
    if tuple(n_steps.shape) != (b,):
        raise ValueError(f"n_steps must be ({b},), got {tuple(n_steps.shape)}")
    floats = [t.contiguous() for t in (px_cmp, py_cmp, px_store, py_store, resp)]
    cls = class_id.to(torch.int32).contiguous()
    s2 = size2.contiguous()
    ok = valid.contiguous()
    steps = n_steps.to(torch.int32).contiguous()
    out = torch.empty((b, c), dtype=torch.bool, device=dev)
    slots = torch.empty((b, c), dtype=torch.int32, device=dev) if with_slots else None
    if b == 0 or c == 0:
        return (out, slots) if with_slots else out
    launch_args = (
        *(t.data_ptr() for t in floats), cls.data_ptr(), s2.data_ptr(), ok.data_ptr(),
        steps.data_ptr(), out.data_ptr(), b, c, -1 if max_shared_slots is None else max_shared_slots,
        kernels.current_stream(dev),
    )
    if with_slots:
        err = kernels.function("dedup_scan", "cv_dedup_scan_slots", _DEDUP_SLOTS_ARGS)(*launch_args, slots.data_ptr())
    else:
        err = kernels.function("dedup_scan", "cv_dedup_scan", _DEDUP_ARGS)(*launch_args)
    if err != 0:
        raise RuntimeError(f"dedup_scan kernel launch failed: cudaError {err}")
    dedup_scan_device.launches += 1
    return (out, slots) if with_slots else out


dedup_scan_device.launches = 0  # kernel launches so far (CPU calls do not count)


def refine_from_samples(at):
    """The 2x2 Newton step from the 3x3 Ldet neighbourhood ``at(dx, dy)``
    (scale_space_extrema.rs:297-345): returns ``(dst0, dst1, ok)`` where
    ``ok`` requires ``|delta| <= 1`` componentwise."""
    v = at(0, 0)
    d_x = 0.5 * (at(1, 0) - at(-1, 0))
    d_y = 0.5 * (at(0, 1) - at(0, -1))
    d_xx = at(1, 0) + at(-1, 0) - 2.0 * v
    d_yy = at(0, 1) + at(0, -1) - 2.0 * v
    d_xy = 0.25 * (at(1, 1) + at(-1, -1)) - 0.25 * (at(1, -1) + at(-1, 1))
    inv_det = 1.0 / (d_xx * d_yy - d_xy * d_xy)
    dst0 = -d_x * (inv_det * d_yy) + -d_y * (inv_det * -d_xy)
    dst1 = -d_x * (inv_det * -d_xy) + -d_y * (inv_det * d_xx)
    ok = (dst0.abs() <= 1.0) & (dst1.abs() <= 1.0)
    return dst0, dst1, ok


def subpixel_refine_batch(ldet: torch.Tensor, ixy: torch.Tensor, valid: torch.Tensor):
    """Batched 2x2 Newton refinement (scale_space_extrema.rs:297-345).

    ``ldet``: ``(S, H, W)`` stacked planes of one octave group;
    ``ixy``: ``(K, 3)`` int rows ``(sublevel, x, y)``; ``valid``: ``(K,)``.
    Returns ``(delta (K, 2), ok (K,))``.
    """
    s, x, y = ixy[:, 0].long(), ixy[:, 1].long(), ixy[:, 2].long()
    dst0, dst1, ok = refine_from_samples(lambda dx, dy: ldet[s, y + dy, x + dx])
    return torch.stack([dst0, dst1], dim=-1), ok & valid
