"""Streaming (real-time) inference of the LSTM effect model: the plugin
export (port of `mod_extraction_tpu/export/streaming.py`).

A processor takes one buffer at a time, any length, and carries all its
state explicitly from buffer to buffer: the LSTM's (h, c), one row per
channel, and the phase of its cos LFO.  Channels are the batch of K3
(`ops/lstm_kernels.py`), the kernel that runs every buffer on the card.

* the LFO continues from the previous buffer's phase, with channel c offset
  by c times the stereo phase offset; knob mappings lfo_rate [0.1, 5] Hz,
  lfo_depth [0, 1.5], offset [0, 2 pi] (`knob_to_params`); native 44.1 kHz.
* the export is a directory: `weights.npz` (the shipped flat layout, which
  the JAX package loads too), `metadata.json`, and `processor.pt2`, a
  `torch.export` program of the whole processor with the weights inside it
  and the buffer length symbolic.  It loads with `torch.export.load` and
  needs no model code, only K3's operator (`ops/lstm_kernels.py`, imported
  here).  The same artifact serves the CPU, where the operator runs the
  plain version, and the card, where it launches the kernel
  (`compiled_artifact_platforms: ["cpu", "cuda"]`).

Everything runs on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import copy
import io
import json
import math
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from mod_extraction_tpu_torch.models.convert import load_lstm_effect_model, lstm_state_dict_to_flax
from mod_extraction_tpu_torch.models.lstm import LSTMEffectModel
from mod_extraction_tpu_torch.ops import lstm_kernels  # noqa: F401  (registers K3's operator)
from mod_extraction_tpu_torch.paths import ensure_dir
from mod_extraction_tpu_torch.train.checkpoints import save_weights
from mod_extraction_tpu_torch.utils.device import resolve_device
from mod_extraction_tpu_torch.utils.spans import span

State = Dict[str, torch.Tensor]


def init_stream_state(n_channels: int, n_hidden: int, device: str | torch.device = "cuda") -> State:
    device = resolve_device(device)
    z = torch.zeros(n_channels, n_hidden, dtype=torch.float32, device=device)
    return {"h": z, "c": z.clone(), "phase": torch.zeros((), dtype=torch.float32, device=device)}


def knob_tensors(device, *values) -> Tuple[torch.Tensor, ...]:
    """The knobs as the 0-d float32 tensors `process` takes."""
    return tuple(torch.tensor(float(v), dtype=torch.float32, device=device) for v in values)


def _process_np(proc, state, x: np.ndarray, lfo_rate=0.2, lfo_depth=0.6667, stereo_offset=0.0):
    """A processor's `process_np`: numpy in, numpy out, as a plugin host
    drives it; the state stays on the processor's device.  Its spans
    (`utils/spans.py`): `processor.call` over `processor.input` (the
    buffer and the knobs to the device), `processor.run` (the program) and
    `processor.output` (the wait for the device and the copy back), timed
    on the host alone: no reader wants their device time, and their CUDA
    events would land in the call's own time."""
    with span("processor.call", device=False), torch.no_grad():
        with span("processor.input", device=False):
            xt = torch.as_tensor(np.asarray(x, np.float32), device=proc.device)
            knobs = knob_tensors(proc.device, lfo_rate, lfo_depth, stereo_offset)
        with span("processor.run", device=False):
            y, state = proc.process(state, xt, *knobs)
        with span("processor.output", device=False):
            return y.cpu().numpy(), state


class StreamingEffectModel(nn.Module):
    """Buffer-by-buffer LFO-driven effect processor.

    `weights`: an `LSTMEffectModel` (copied), or a `.npz` path or flax
    param tree (`models/convert.py`); a mono-input model with one latent
    channel.  Its parameters are frozen, so its forward takes K3 and never
    the training kernels."""

    def __init__(
        self,
        weights: LSTMEffectModel | str | Mapping[str, Any],
        sr: float = 44100.0,
        n_channels: int = 2,
        device: str | torch.device = "cuda",
    ) -> None:
        super().__init__()
        self.device = resolve_device(device)
        if isinstance(weights, LSTMEffectModel):
            model = copy.deepcopy(weights)  # the caller's model stays as it is
        else:
            model = load_lstm_effect_model(weights, device=self.device)
        if model.in_ch != 1 or model.latent_dim != 1:
            raise ValueError("the processor drives a mono-input model with one LFO channel")
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.sr = float(sr)
        self.n_hidden = model.n_hidden
        self.n_channels = n_channels

    def init_state(self) -> State:
        return init_stream_state(self.n_channels, self.n_hidden, self.device)

    def process(
        self,
        state: State,
        x: torch.Tensor,
        lfo_rate: torch.Tensor,
        lfo_depth: torch.Tensor,
        lfo_stereo_phase_offset: torch.Tensor,
    ) -> Tuple[torch.Tensor, State]:
        """x: (n_channels, buffer_len) -> (y, new_state); the knobs are 0-d
        float32 tensors on the processor's device."""
        c, t = x.shape
        # the JAX processor's float32 arithmetic, in its order
        i = torch.arange(1, t + 1, dtype=torch.float32, device=x.device)
        arg_l = (2.0 * math.pi / self.sr) * lfo_rate * i + state["phase"]
        next_phase = torch.remainder(arg_l[-1], 2.0 * math.pi)
        offsets = torch.arange(c, dtype=torch.float32, device=x.device) * lfo_stereo_phase_offset
        arg = arg_l[None, :] + offsets[:, None]
        lfo = (torch.cos(arg) + 1.0) / 2.0 * lfo_depth  # (C, T)
        y, (h, c_state) = self.model(x[:, None, :], lfo[:, None, :], (state["h"], state["c"]))
        return y[:, 0, :], {"h": h, "c": c_state, "phase": next_phase}

    forward = process
    process_np = _process_np


DEFAULT_METADATA = {
    "model_authors": ["mod_extraction_tpu"],
    "model_short_description": "LFO extraction evaluation model.",
    "technical_links": {
        "Paper": "https://arxiv.org/abs/2305.13262",
        "Code": "https://github.com/christhetree/mod_extraction/",
    },
    "tags": ["lfo", "phaser", "flanger", "chorus"],
    "model_version": "1.0.0",
    "is_experimental": True,
    "neutone_parameters": [
        {"name": "lfo_rate", "description": "LFO rate [0.1 to 5 Hz]", "default_value": 0.2},
        {"name": "lfo_depth", "description": "LFO depth [0.0, 1.5]", "default_value": 0.66666666},
        {"name": "lfo_stereo_phase_offset", "description": "LFO stereo phase offset [0.0, 2pi]",
         "default_value": 0.0},
    ],
    "native_sample_rates": [44100],
    "native_buffer_sizes": [],  # all sizes supported
    "input_gain_default": 0.4,
    "is_input_mono": False,
    "is_output_mono": False,
}


def knob_to_params(knobs: Dict[str, float]) -> Dict[str, float]:
    """Normalized [0, 1] knobs -> physical params."""
    return {
        "lfo_rate": knobs.get("lfo_rate", 0.2) * 4.9 + 0.1,
        "lfo_depth": knobs.get("lfo_depth", 0.6667) * 1.5,
        "lfo_stereo_phase_offset": knobs.get("lfo_stereo_phase_offset", 0.0) * 2.0 * np.pi,
    }


ARTIFACT_NAME = "processor.pt2"


def serialize_streaming_processor(sm: StreamingEffectModel) -> bytes:
    """The whole processor as a `torch.export` program (`.pt2` bytes): the
    weights travel inside it as its frozen parameters, and the buffer length
    is one symbolic dimension, so one artifact serves any buffer size with
    no model code.  Traced from a CPU copy; `CompiledStreamingProcessor`
    moves it to the device it serves."""
    cpu = StreamingEffectModel(sm.model, sr=sm.sr, n_channels=sm.n_channels, device="cpu")
    example = (cpu.init_state(), torch.zeros(cpu.n_channels, 16), *knob_tensors("cpu", 0.2, 0.6667, 0.0))
    t = torch.export.Dim("t", min=1)
    dynamic = (dict.fromkeys(example[0]), {1: t}, None, None, None)
    with torch.no_grad():
        exported = torch.export.export(cpu, example, dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


class CompiledStreamingProcessor:
    """Drives a reloaded processor artifact buffer by buffer: what a host
    needs, with no dependency on the model code."""

    def __init__(self, artifact: bytes, n_channels: int, n_hidden: int,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        exported = torch.export.load(io.BytesIO(artifact))
        if self.device.type != "cpu":
            exported = move_to_device_pass(exported, self.device)
        self.exported = exported
        self._call = exported.module()
        self.n_channels = n_channels
        self.n_hidden = n_hidden

    def init_state(self) -> State:
        return init_stream_state(self.n_channels, self.n_hidden, self.device)

    def process(self, state, x, lfo_rate, lfo_depth, lfo_stereo_phase_offset):
        return self._call(state, x, lfo_rate, lfo_depth, lfo_stereo_phase_offset)

    process_np = _process_np


def export_streaming_model(
    weights: LSTMEffectModel | str | Mapping[str, Any],
    out_dir: str,
    model_name: str,
    sr: float = 44100.0,
    metadata_overrides: Optional[Dict] = None,
    with_artifact: bool = True,
) -> str:
    """Write the plugin directory `out_dir/model_name`: weights, metadata
    and (by default) the processor artifact.  Runs on the CPU: it writes
    files and traces the processor, and computes nothing on a device."""
    meta = dict(DEFAULT_METADATA)
    meta.update(metadata_overrides or {})
    sm = StreamingEffectModel(weights, sr=sr, n_channels=1 if meta["is_input_mono"] else 2, device="cpu")
    meta.update({"model_name": model_name, "n_hidden": sm.n_hidden, "sr": sr})
    target = ensure_dir(os.path.join(out_dir, model_name))
    save_weights(os.path.join(target, "weights.npz"), lstm_state_dict_to_flax(sm.model.state_dict()))
    if with_artifact:
        with open(os.path.join(target, ARTIFACT_NAME), "wb") as f:
            f.write(serialize_streaming_processor(sm))
        meta["compiled_artifact"] = ARTIFACT_NAME
        meta["compiled_artifact_platforms"] = ["cpu", "cuda"]
    with open(os.path.join(target, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return target


def _metadata(export_dir: str) -> dict:
    with open(os.path.join(export_dir, "metadata.json")) as f:
        return json.load(f)


def load_compiled_processor(export_dir: str, device: str | torch.device = "cuda") -> CompiledStreamingProcessor:
    """Load only the artifact: no model code, no weights file."""
    meta = _metadata(export_dir)
    with open(os.path.join(export_dir, meta["compiled_artifact"]), "rb") as f:
        artifact = f.read()
    return CompiledStreamingProcessor(
        artifact, n_channels=1 if meta.get("is_input_mono") else 2,
        n_hidden=meta.get("n_hidden", 64), device=device,
    )


def load_streaming_model(export_dir: str, device: str | torch.device = "cuda") -> StreamingEffectModel:
    """The live processor from an export directory's weights (this
    package's or the JAX package's)."""
    meta = _metadata(export_dir)
    return StreamingEffectModel(
        os.path.join(export_dir, "weights.npz"), sr=meta.get("sr", 44100.0),
        n_channels=1 if meta.get("is_input_mono") else 2, device=device,
    )
