"""The serving cell: the plugin's processor artifact driven as a DAW's audio
thread drives it, one buffer due every buffer period (open loop).

Set-up exports the effect model (`export_streaming_model`, under TMPDIR),
loads the artifact a plugin loads (`load_compiled_processor`), makes the
input audio from the seed and warms up the buffer's shape.  The window
then calls `process_np` once per buffer at its due time (or at once, when
the calls run late), from a fresh state; each call's latency runs from its
due time to its output on the host.  After the window the reference runs
the whole input through the plain model and every output sample, and the
state carried to the end, are compared."""

from __future__ import annotations

import gc
import math
import tempfile
import time
import traceback
from typing import Callable, Dict

import numpy as np
import torch

from benchmark.harness import generator
from benchmark.harness.common import ROOT, Run, log
from benchmark.harness.trace import profile_span
from benchmark.reference import lstm as ref_lstm


class OpenLoop:
    """Calls due every `period` seconds from the first; a call starts at its
    due time or, when the calls before it ran late, as soon as they end.
    The loop waits by spinning on the clock: a sleep's wake-up on the H100
    machines came 1-7 ms late on 1-10 % of calls, which is the generator's
    lateness and not the processor's (PERF.md, PR 18).  `clock`, `sleep`
    and `spin_s` (sleep until that long before a due time) let a test run
    it on a fake clock."""

    def __init__(self, period: float, clock: Callable[[], float] = time.perf_counter,
                 sleep: Callable[[float], None] = time.sleep, spin_s: float = math.inf):
        self.period, self.clock, self.sleep, self.spin_s = period, clock, sleep, spin_s

    def run(self, call: Callable[[int], None], n: int) -> Dict[str, np.ndarray]:
        """latency (due to done) and lateness (due to start) of each call, s."""
        lat, late = np.empty(n), np.empty(n)
        t0 = self.clock()
        for k in range(n):
            due = t0 + k * self.period
            wait = due - self.clock()
            if wait > self.spin_s:
                self.sleep(wait - self.spin_s)
            while self.clock() < due:
                pass
            start = self.clock()
            call(k)
            done = self.clock()
            lat[k], late[k] = done - due, start - due
        return {"latency": lat, "lateness": late}


def build(run: Run):
    """The artifact a plugin loads, the input audio and the warm-up: (the
    processor, the input (channels, samples), the number of calls)."""
    from mod_extraction_tpu_torch.export.streaming import export_streaming_model, load_compiled_processor

    device = torch.device(run.device)
    cfg, tr = run.config, run.traffic
    n, ch, sr = tr["buffer"], tr["channels"], cfg["sr"]
    n_calls = int(round(run.seconds * sr / n))
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        export_dir = export_streaming_model(str(ROOT / cfg["effect_model_weights"]), tmp, "processor",
                                            sr=float(sr))
        proc = load_compiled_processor(export_dir, device=device)
    t_loaded = time.perf_counter()
    x = generator.stream_input(run.host_seed, n * n_calls, ch, sr, tr["peak"], device)
    warm = generator.stream_input(run.host_seed + 1, n * tr["warmup_calls"], ch, sr, tr["peak"], device)
    state = proc.init_state()
    for k in range(tr["warmup_calls"]):
        _, state = proc.process_np(state, warm[:, k * n:(k + 1) * n], **tr["knobs"])
    gc.collect()  # the loaded program's objects settle into the oldest generation
    if device.type == "cuda":
        torch.cuda.synchronize()
    log(f"set-up: {t_start - run.t0:.2f} s to the driver (imports, card), {t_loaded - t_start:.2f} s "
        f"export and load, {time.perf_counter() - t_loaded:.2f} s input and warm-up")
    return proc, x, n_calls


def run(run: Run) -> Dict:
    device = torch.device(run.device)
    cfg, tr = run.config, run.traffic
    n, ch, sr, knobs = tr["buffer"], tr["channels"], cfg["sr"], tr["knobs"]
    weights = str(ROOT / cfg["effect_model_weights"])
    proc, x, n_calls = build(run)
    setup_s = time.perf_counter() - run.t0

    y = np.full((ch, n * n_calls), np.nan, np.float32)
    box = {"state": proc.init_state(), "failed": 0, "logged": False}

    def call(k: int) -> None:
        try:
            out, box["state"] = proc.process_np(box["state"], x[:, k * n:(k + 1) * n], **knobs)
            y[:, k * n:(k + 1) * n] = out
            ok = bool(np.isfinite(out).all())
        except Exception:  # a failed call counts; the stream goes on
            ok = False
            if not box["logged"]:
                log(traceback.format_exc())
                box["logged"] = True
        box["failed"] += not ok

    timing = OpenLoop(n / sr).run(call, n_calls)
    lat = timing["latency"]
    log(f"window: {n_calls} calls, failed {box['failed']}, latency ms p50 "
        f"{1e3 * np.percentile(lat, 50):.4f} p99 {1e3 * np.percentile(lat, 99):.4f} max "
        f"{1e3 * lat.max():.4f}; generator lateness ms p99 {1e3 * np.percentile(timing['lateness'], 99):.4f}")
    out = {"attempted": n_calls, "failed": box["failed"],
           "end_to_end": {"buffer_p99_ms": 1e3 * float(np.percentile(lat, 99)), "setup_s": setup_s},
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0}
    h_end, c_end = (box["state"][k].detach().cpu().numpy() for k in ("h", "c"))
    if run.trace:
        n_traced = tr["traced_calls"]
        probe_x = generator.stream_input(run.host_seed + 2, n * n_traced, ch, sr, tr["peak"], device)
        st = {"state": proc.init_state()}

        def traced_call(k):
            _, st["state"] = proc.process_np(st["state"], probe_x[:, k * n:(k + 1) * n], **knobs)

        trace = profile_span(lambda: OpenLoop(n / sr).run(traced_call, n_traced) and n_traced)
        run.obs.update(unit="buffer", trace=trace, latency_s=lat)
        out["per_layer"] = run.read_layers()
        out["trace"] = trace
    run.obs.clear()
    del proc, box
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    out["values"] = compare(weights, x, y, h_end, c_end, n, sr, knobs, device)
    log(f"reference: {time.perf_counter() - t_ref:.1f} s")
    return out


def reference_stream(weights: str, x: np.ndarray, n: int, sr: float, knobs: dict, device,
                     precision: str = "config"):
    """The plain model over the whole input: (y, h, c), in float32 with TF32
    off (cuDNN's default has it on).  The control ("control") takes the
    LSTM's weights and inputs rounded to TF32, the precision below that."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = ref_lstm.npz_params(weights)
    phases = ref_lstm.stream_phases(x.shape[1] // n, n, sr, knobs["lfo_rate"])
    lfo = ref_lstm.stream_lfo(phases, n, sr, knobs["lfo_rate"], knobs["lfo_depth"], x.shape[0],
                              knobs["stereo_offset"])
    x_in = x
    if precision == "control":  # the operands of the LSTM's products
        params = {k: (ref_lstm.tf32_round(v) if k != "fc_b" else v) for k, v in params.items()}
        x_in, lfo = ref_lstm.tf32_round(x), ref_lstm.tf32_round(lfo)
    return ref_lstm.stream(ref_lstm.EffectModel(params, device).eval(), x, lfo, device, x_in=x_in)


def compare(weights, x, y, h_end, c_end, n, sr, knobs, device, precision="config") -> Dict[str, float]:
    """The widest gap of any output sample, and of the state carried to the
    end, from the reference's."""
    y_ref, h_ref, c_ref = reference_stream(weights, x, n, sr, knobs, device, precision)
    out_gap = float(np.abs(y - y_ref).max()) if np.isfinite(y).all() else math.inf
    state_gap = max(float(np.abs(h_end - h_ref).max()), float(np.abs(c_end - c_ref).max()))
    return {"output": out_gap, "state": state_gap if math.isfinite(state_gap) else math.inf}
