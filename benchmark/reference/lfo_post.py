"""Plain NumPy post-processing of extracted LFOs, row by row, as the
reference pipeline defines it: the moving average, corner detection, the
corner stretch and the validity rules the effect-model training applies.

* smooth: mean over each window of n frames (the length shrinks by n - 1),
  as differences of a float32 running sum taken in blocks of 16 (each
  block summed left to right, offset by the running sum of the blocks
  before it): the order of XLA's cumulative sum on the CPU, which the JAX
  package's corners, and so its validity decisions, rest on;
* corners: frame i (not the first or last) is a top where the slope turns
  from rising to falling, a bottom where it turns from falling to rising,
  by the sign of d_l * (d_r + 1e-16);
* stretch: every segment between anchors (the corners, and the last frame)
  is rescaled so that a top lands on 1.0 and a bottom on 0.0: segment
  (prev, cur] maps m -> (m - min) * scale + cur_target - (m[cur] - min) *
  scale with scale = |prev_target - cur_target| / |m[prev] - m[cur]|, min
  taken over the segment's frames (frame 0 excluded); a segment whose two
  targets are equal or whose range is zero is left alone, frame 0 always,
  and a row with more than `max_n_corners` corners entirely;
* valid: 1 to 6 tops and 1 to 6 bottoms, no two tops and no two bottoms
  closer than 10 % of the frames.
"""

from __future__ import annotations

import numpy as np


def running_sum(x: np.ndarray) -> np.ndarray:
    """float32 inclusive running sum of the last axis in blocks of 16."""
    x = x.astype(np.float32)
    n = x.shape[-1]
    if n <= 16:
        out = x.copy()
        for i in range(1, n):
            out[..., i] = out[..., i - 1] + x[..., i]
        return out
    nb = -(-n // 16)
    pad = np.zeros(x.shape[:-1] + (nb * 16 - n,), np.float32)
    inner = running_sum(np.concatenate([x, pad], axis=-1).reshape(x.shape[:-1] + (nb, 16)))
    totals = running_sum(inner[..., -1])
    offsets = np.concatenate([np.zeros(x.shape[:-1] + (1,), np.float32), totals[..., :-1]], axis=-1)
    return (inner + offsets[..., None]).reshape(x.shape[:-1] + (nb * 16,))[..., :n]


def smooth(x: np.ndarray, n: int) -> np.ndarray:
    """(B, F) -> (B, F - n + 1) float32."""
    if n <= 1:
        return x.astype(np.float32)
    cs = np.concatenate([np.zeros((x.shape[0], 1), np.float32), running_sum(x)], axis=1)
    return ((cs[:, n:] - cs[:, :-n]) / np.float32(n)).astype(np.float32)


def corners(m: np.ndarray) -> tuple:
    """(tops, bottoms) index lists of a 1-D LFO."""
    d = np.diff(m.astype(np.float32))
    dl, dr = d[:-1], d[1:] + np.float32(1e-16)
    tops = [i + 1 for i in range(len(dl)) if dl[i] > 0 and dl[i] * dr[i] < 0]
    bots = [i + 1 for i in range(len(dl)) if dl[i] < 0 and dl[i] * dr[i] < 0]
    return tops, bots


def stretch_row(m: np.ndarray, max_n_corners: int) -> np.ndarray:
    tops, bots = corners(m)
    if len(tops) + len(bots) > max_n_corners:
        return m.copy()
    t = len(m)
    target = {i: 1.0 for i in tops}
    target.update({i: 0.0 for i in bots})
    anchors = sorted(set(target) | {t - 1})
    out = m.astype(np.float64).copy()
    prev, prev_target = 0, float(m[0])
    for cur in anchors:
        cur_target = target.get(cur, float(m[cur]))
        seg = np.arange(prev + 1, cur + 1)
        rng = abs(float(m[prev]) - float(m[cur]))
        if prev_target != cur_target and rng > 0 and seg.size:
            lo = float(m[seg].min())
            scale = abs(prev_target - cur_target) / rng
            out[seg] = (m[seg] - lo) * scale + (cur_target - (float(m[cur]) - lo) * scale)
        prev, prev_target = cur, cur_target
    out[0] = m[0]
    return out.astype(np.float32)


def stretch(x: np.ndarray, max_n_corners: int) -> np.ndarray:
    return np.stack([stretch_row(r, max_n_corners) for r in x])


def valid(x: np.ndarray, min_fraction: float = 0.10) -> np.ndarray:
    """(B,) bool."""
    min_gap = int(min_fraction * x.shape[1])
    out = []
    for r in x:
        tops, bots = corners(r)
        ok = 1 <= len(tops) <= 6 and 1 <= len(bots) <= 6
        for c in (tops, bots):
            if len(c) > 1 and min(np.diff(c)) < min_gap:
                ok = False
        out.append(ok)
    return np.asarray(out)
