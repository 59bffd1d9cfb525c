"""The yardstick's arithmetic: model operations and bytes of the port's
layers at a cell's shapes, and the H100's published peaks.

Frozen copies, so that a change to the program cannot move them:
`train_step_model_flops` is `bench_torch.py::train_step_model_flops` and
`lstm_ops_bytes` is `chip_smoke.py::lstm_ops_bytes`, both unchanged.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def train_step_model_flops(
    batch_size: int,
    n_samples: int = 88200,
    hop_len: int = 256,
    n_fft: int = 1024,
    n_mels: int = 256,
    channels: tuple = (2, 64, 64, 64, 64, 64, 64),
    kernel: tuple = (5, 13),
    pool_h: int = 2,
) -> float:
    """Analytic model FLOPs of one stage-1 train step (paper config), as
    `bench.py` counts them: conv trunk forward + dgrad + wgrad (2 FLOPs a
    MAC), the DFT frontend and mel projection (forward only) and the 1x1
    head (forward + backward); elementwise work, LayerNorm, losses and AdamW
    excluded."""
    frames = n_samples // hop_len + 1
    kh, kw = kernel
    mels = n_mels
    conv_macs = 0
    for cin, cout in zip(channels[:-1], channels[1:]):
        conv_macs += cin * cout * kh * kw * mels * frames
        mels //= pool_h
    conv_flops = 3 * 2 * conv_macs
    bins = n_fft // 2 + 1
    dft_flops = 2 * (2 * 2 * frames * n_fft * bins)
    mel_flops = 2 * (2 * frames * bins * n_mels)
    head_flops = 3 * 2 * (channels[-1] * frames)
    return float(batch_size) * (conv_flops + dft_flops + mel_flops + head_flops)


def lstm_ops_bytes(b, t, hid, in_dim, out_ch, backward=False, save_states=False):
    """(float32 operations, bytes) one K3/K4/K5 launch needs: each input
    read once, each output written once (K4's saved states and gate
    activations are its outputs and K5's inputs; K5's gate cotangents are
    scratch and not counted); transcendental functions count as one
    operation."""
    g4 = 4 * hid
    w_floats = in_dim * g4 + hid * g4 + g4
    if not backward:
        ops = b * t * (2 * g4 * (hid + in_dim) + g4 + g4 + 5 * hid + 2 * hid * out_ch + 3 * out_ch)
        floats = b * t * (in_dim + 2 * out_ch) + 4 * b * hid + w_floats + hid * out_ch + out_ch
        if save_states:
            floats += 2 * b * t * hid + b * t * g4
        return ops, 4 * floats
    ops = b * t * (
        20 * hid  # cell backward and gate cotangents
        + 2 * g4 * hid  # recurrent cotangent
        + 2 * g4 * (hid + in_dim + 1)  # dW_hh, dW_ih, db
        + 2 * g4 * in_dim  # dseq
    )
    floats = 2 * b * in_dim * t + 3 * b * t * hid + b * t * g4 + 6 * b * hid + 2 * w_floats
    return ops, 4 * floats


def extractor_flops(batch_size: int, ex: dict, n_samples: int, backward: bool) -> tuple:
    """(bf16 FLOPs, float32 FLOPs) of the extractor at `batch_size`, split
    from `train_step_model_flops`'s terms: the trunk convs run in bf16; the
    DFT, the mel projection and the head in float32.  Forward only
    (`backward=False`) keeps a third of the conv and head terms."""
    chans = (ex["in_ch"],) + tuple(ex["out_channels"])
    kw = dict(n_samples=n_samples, hop_len=ex["hop_len"], n_fft=ex["n_fft"], n_mels=ex["n_mels"],
              channels=chans, kernel=tuple(ex["kernel_size"]), pool_h=ex["pool_size"][0])
    frames = n_samples // ex["hop_len"] + 1
    bins = ex["n_fft"] // 2 + 1
    front = 2 * (2 * 2 * frames * ex["n_fft"] * bins) + 2 * (2 * frames * bins * ex["n_mels"])
    head = 3 * 2 * (chans[-1] * frames)
    conv = train_step_model_flops(1, **kw) - front - head
    share = 1.0 if backward else 1.0 / 3.0
    return batch_size * conv * share, batch_size * (front + head * share)


def least_seconds(bf16_flops: float, f32_flops: float) -> float:
    """Least time of work at the peak of the precision each part runs in."""
    return bf16_flops / PEAK_BF16_FLOPS + f32_flops / PEAK_F32_FLOPS


def lstm_launch_least_s(b, t, hid, in_dim, out_ch, backward=False, save_states=False) -> float:
    """The larger of a launch's operation and byte bounds, in seconds."""
    ops, nbytes = lstm_ops_bytes(b, t, hid, in_dim, out_ch, backward, save_states)
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)


def lstm_chunk_least_s(b, t, hid, in_dim=2, out_ch=1) -> float:
    """Least time of one TBPTT chunk: K4's forward (states saved) and K5's
    backward, each at the larger of its two bounds."""
    return (lstm_launch_least_s(b, t, hid, in_dim, out_ch, save_states=True)
            + lstm_launch_least_s(b, t, hid, in_dim, out_ch, backward=True))


def tbptt_step_flops(batch_size, n_samples, ex, hid, warmup, step, n_chunks, in_dim=2, out_ch=1):
    """(bf16, float32) FLOPs of one TBPTT step's model work: the frozen
    extractor's forward, the warm-up's LSTM forward and each chunk's forward
    and backward.  Nothing recomputed is counted."""
    bf16, f32 = extractor_flops(batch_size, ex, n_samples, backward=False)
    f32 += lstm_ops_bytes(batch_size, warmup, hid, in_dim, out_ch)[0]
    chunk = (lstm_ops_bytes(batch_size, step, hid, in_dim, out_ch, save_states=True)[0]
             + lstm_ops_bytes(batch_size, step, hid, in_dim, out_ch, backward=True)[0])
    return bf16, f32 + n_chunks * chunk


def render_bytes(batch_size: int, n_samples: int, n_frames: int) -> int:
    """Bytes the stage-1 render needs: the int16 dry chunks and the
    frame-rate LFOs read once; the float32 dry, wet and frame-rate LFO
    written once (per-row parameters are a few hundred bytes and left out)."""
    return batch_size * (n_samples * (2 + 4 + 4) + 2 * n_frames * 4)
