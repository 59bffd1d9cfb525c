"""LFO post-processing (port of `mod_extraction_tpu/ops/corners.py`):
smoothing, corner detection, corner stretching and the validity rules the
stage-2 task applies to extracted LFOs.

Everything is batched over the leading (B,) axis with fixed shapes: a
segment between two anchors gets an id from an exclusive cumulative sum of
the anchor mask, per-segment statistics are masked reductions over a static
budget of K = max_n_corners + 2 segments, and validity is a (B,) mask
(invalid examples are weighted out of the loss, not dropped).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F


_CUMSUM_BLOCK = 16


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last dim in a fixed summation order: blocks
    of 16 summed left to right, each block offset by the scanned totals of
    the blocks before it (the same recursion).  This is the order of XLA's
    cumulative sum on the CPU, so the JAX package's smoothed LFOs, and the
    corners found on them, are matched bit for bit; only additions are
    involved, so the card gives the same bits as the CPU."""
    n = x.shape[-1]
    if n <= _CUMSUM_BLOCK:
        cols = [x[..., 0]]
        for i in range(1, n):
            cols.append(cols[-1] + x[..., i])
        return torch.stack(cols, dim=-1)
    nb = -(-n // _CUMSUM_BLOCK)
    blocks = F.pad(x, (0, nb * _CUMSUM_BLOCK - n)).reshape(*x.shape[:-1], nb, _CUMSUM_BLOCK)
    inner = blocked_cumsum(blocks)
    offsets = F.pad(blocked_cumsum(inner[..., -1])[..., :-1], (1, 0))
    return (inner + offsets[..., None]).reshape(*x.shape[:-1], nb * _CUMSUM_BLOCK)[..., :n]


class _Smoothen(torch.autograd.Function):
    """The moving average through `blocked_cumsum`, whose order decides
    corners; its backward is the adjoint moving sum through one reverse
    `torch.cumsum` (no corner depends on a gradient's summation order), so
    the gradient costs a handful of launches, not one per scanned column."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.w = w
        cs = F.pad(blocked_cumsum(x), (1, 0))
        return (cs[..., w:] - cs[..., :-w]) / w

    @staticmethod
    def backward(ctx, g):
        w = ctx.w
        g_cs = F.pad(g, (w, 0)) - F.pad(g, (0, w))  # cotangent of cs
        return g_cs.flip(-1).cumsum(-1).flip(-1)[..., 1:] / w, None


def smoothen(x: torch.Tensor, smooth_n_frames: int) -> torch.Tensor:
    """Stride-1 moving average over the last dim (unfold-mean semantics):
    the length shrinks to T - smooth_n_frames + 1.  Computed from a
    cumulative sum, as the JAX package does (`blocked_cumsum`)."""
    if smooth_n_frames <= 1:
        return x
    return _Smoothen.apply(x, smooth_n_frames)


def find_corners(mod_sig: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top and bottom corner masks, (B, T) int32 in {0, 1}.

    A frame is a top corner when the slope goes from positive to negative
    (a bottom the reverse), detected with the sign of the product of the
    neighbouring differences through `-floor(d_l * (d_r + 1e-16))`.  The
    first and last frames are never corners."""
    assert mod_sig.ndim == 2
    diff = mod_sig[:, 1:] - mod_sig[:, :-1]
    diff_r = diff[:, 1:]
    diff_l = diff[:, :-1]
    zero = torch.zeros_like(diff_l)
    diff_pos_l = torch.where(diff_l > 0, diff_l, zero)
    diff_neg_l = torch.where(diff_l < 0, diff_l, zero)
    top = (-torch.floor(diff_pos_l * (diff_r + 1e-16))).to(torch.int32)
    bottom = (-torch.floor(diff_neg_l * (diff_r + 1e-16))).to(torch.int32)
    return F.pad(top, (1, 1)), F.pad(bottom, (1, 1))


def _segment_stats(
    m: torch.Tensor, anchor_mask: torch.Tensor, anchor_targets: torch.Tensor, max_segments: int
) -> Dict[str, torch.Tensor]:
    """Per-frame segment ids and per-segment anchors of (B, T) signals.

    Segment s ends at the (s+1)-th anchor (`anchor_mask` must hold the last
    frame).  Returns `seg_id` (B, T) and, per segment, (B, K) arrays
    `prev_pos`, `cur_pos`, `prev_target`, `cur_target`, `seg_min` (min of
    m over frames (prev, cur], frame 0 excluded) and `seg_valid`.  Entries
    of segments past the live count are garbage: mask with `seg_valid`."""
    b, t = m.shape
    dev = m.device
    iota = torch.arange(t, device=dev)
    a = anchor_mask.to(torch.int64)
    ex_cumsum = torch.cumsum(a, dim=-1) - a  # anchors strictly before i
    seg_id = torch.clamp(ex_cumsum, 0, max_segments - 1)

    s_range = torch.arange(max_segments, device=dev)[None, :, None]
    is_cur = (ex_cumsum[:, None, :] == s_range) & anchor_mask[:, None, :]
    cur_pos = torch.where(is_cur, iota, t).amin(dim=-1)  # (B, K)
    seg_valid = cur_pos < t
    cur_pos = torch.clamp(cur_pos, max=t - 1)
    prev_pos = F.pad(cur_pos[:, :-1], (1, 0))

    cur_target = torch.gather(anchor_targets, 1, cur_pos)
    prev_target = torch.cat([m[:, :1], cur_target[:, :-1]], dim=1)

    in_seg = (seg_id[:, None, :] == s_range) & (iota >= 1)
    seg_min = torch.where(in_seg, m[:, None, :], math.inf).amin(dim=-1)
    return dict(
        seg_id=seg_id, cur_pos=cur_pos, prev_pos=prev_pos, cur_target=cur_target,
        prev_target=prev_target, seg_min=seg_min, seg_valid=seg_valid,
    )


def _stretch_one(
    m: torch.Tensor, top: torch.Tensor, bottom: torch.Tensor, max_n_corners: int,
    top_val: float = 1.0, bot_val: float = 0.0,
) -> torch.Tensor:
    """Rescale each segment between anchors of (B, T) signals so that its
    anchor frame hits its target (tops 1.0, bottoms 0.0; the forced final
    anchor keeps its own value).  Segments whose previous and current
    targets coincide, or whose original range is zero, are left as they
    are; frame 0 is never changed; a signal with more than `max_n_corners`
    corners is returned unchanged."""
    t = m.shape[1]
    n_corners = top.sum(dim=-1) + bottom.sum(dim=-1)
    is_top, is_bot = top == 1, bottom == 1
    anchor_mask = is_top | is_bot
    anchor_mask[:, t - 1] = True
    targets = torch.where(is_top, top_val, torch.where(is_bot, bot_val, m))

    st = _segment_stats(m, anchor_mask, targets, max_n_corners + 2)
    m_prev = torch.gather(m, 1, st["prev_pos"])
    m_cur = torch.gather(m, 1, st["cur_pos"])
    curr_range = torch.abs(m_prev - m_cur)
    target_range = torch.abs(st["prev_target"] - st["cur_target"])
    safe = curr_range > 0
    scale = torch.where(
        safe, target_range / torch.where(safe, curr_range, torch.ones_like(curr_range)), 0.0
    )
    offset = st["cur_target"] - (m_cur - st["seg_min"]) * scale
    apply = (st["prev_target"] != st["cur_target"]) & safe & st["seg_valid"]

    s = st["seg_id"]

    def per_frame(v):
        return torch.gather(v, 1, s)

    stretched = torch.where(
        per_frame(apply), (m - per_frame(st["seg_min"])) * per_frame(scale) + per_frame(offset), m
    )
    stretched[:, 0] = m[:, 0]
    return torch.where((n_corners > max_n_corners)[:, None], m, stretched)


def stretch_corners(
    mod_sig: torch.Tensor, max_n_corners: int = 10, smooth_n_frames: int = 32
) -> torch.Tensor:
    """Smooth (B, T) LFOs, find their corners and rescale every
    inter-corner segment so peaks hit 1.0 and troughs 0.0."""
    assert mod_sig.ndim == 2
    mod_sig = smoothen(mod_sig, smooth_n_frames)
    top, bottom = find_corners(mod_sig)
    return _stretch_one(mod_sig, top, bottom, max_n_corners)


def corners_to_mod_sig(top_corners: torch.Tensor, bottom_corners: torch.Tensor) -> torch.Tensor:
    """A piecewise-linear LFO rebuilt from (T,) corner masks: linear ramps
    between consecutive corners (tops 1, bottoms 0), zeros before the first
    and after the last corner, all zeros if either mask is empty."""
    assert top_corners.ndim == 1
    t = top_corners.shape[0]
    iota = torch.arange(t, device=top_corners.device)
    is_top = top_corners == 1
    is_corner = is_top | (bottom_corners == 1)
    targets = is_top.to(torch.float32)
    prev_idx = torch.cummax(torch.where(is_corner, iota, -1), dim=0).values
    next_idx = torch.cummin(torch.where(is_corner, iota, t).flip(0), dim=0).values.flip(0)
    p = prev_idx.clamp(0, t - 1)
    n = next_idx.clamp(0, t - 1)
    frac = (iota - p).to(torch.float32) / (n - p).clamp(min=1).to(torch.float32)
    ramp = targets[p] + (targets[n] - targets[p]) * frac
    out = torch.where((prev_idx >= 0) & (next_idx < t), ramp, 0.0)
    if top_corners.max() == 0 or bottom_corners.max() == 0:
        return torch.zeros_like(out)
    return out


def _min_corner_spacing(mask: torch.Tensor) -> torch.Tensor:
    """(B,) minimum index distance between consecutive 1s of (B, T) masks,
    inf where a row has fewer than two."""
    b, t = mask.shape
    iota = torch.arange(t, device=mask.device).expand(b, t)
    marked = torch.where(mask == 1, iota, -1)
    last_le = torch.cummax(marked, dim=-1).values
    prev_lt = F.pad(last_le[:, :-1], (1, 0), value=-1)
    dist = torch.where((mask == 1) & (prev_lt >= 0), iota - prev_lt, t + 1)
    d = dist.amin(dim=-1)
    return torch.where(d > t, math.inf, d.to(torch.float32))


def check_mod_sig_mask(
    mod_sig: torch.Tensor,
    top_corners: torch.Tensor,
    bottom_corners: torch.Tensor,
    min_top_corners: int = 1,
    max_top_corners: int = 6,
    min_bottom_corners: int = 1,
    max_bottom_corners: int = 6,
    min_fraction_between_corners: float = 0.10,
) -> torch.Tensor:
    """(B,) bool: the LFO has 1..6 tops and 1..6 bottoms, and neither kind
    of corner comes closer than 10 % of the frames to its neighbour."""
    assert mod_sig.ndim == 2
    min_n_frames = int(min_fraction_between_corners * mod_sig.shape[-1])
    n_top = top_corners.sum(dim=-1)
    n_bot = bottom_corners.sum(dim=-1)
    ok = (
        (n_top >= min_top_corners)
        & (n_top <= max_top_corners)
        & (n_bot >= min_bottom_corners)
        & (n_bot <= max_bottom_corners)
    )
    ok &= _min_corner_spacing(top_corners) >= min_n_frames
    ok &= _min_corner_spacing(bottom_corners) >= min_n_frames
    return ok


def find_valid_mod_sig_mask(mod_sig: torch.Tensor) -> torch.Tensor:
    """(B,) bool validity of (B, T) LFOs (`check_mod_sig_mask` on their
    corners)."""
    top, bottom = find_corners(mod_sig)
    return check_mod_sig_mask(mod_sig, top, bottom)
