"""Train cells: the port's stage-1 extractor step (`train_lfo`) and its
stage-2 TBPTT step (`train_tbptt`), driven as a training job drives them.

Set-up makes the corpus and the batches from the seed, builds the task
(the training step with its model and optimizer state), and drives it
through its first three steps with the window's own call and feed: they
are the warm-up and the steps that the reference follows.  The window then
runs whole steps, each read back (its loss, as a trainer logs it), until
the first step that ends past `--seconds`; `audio_s_per_s` is the audio of
every step in the window over the window's length.  A `--trace 1` run
then profiles two more steps and times the cell's layers alone.  Once the
program's state is freed, the reference repeats the three steps and the
comparison decides `correct`."""

from __future__ import annotations

import gc
import math
import time
import traceback
from typing import Callable, Dict, List

import numpy as np
import torch

from benchmark.harness import counts, generator
from benchmark.harness.common import ROOT, Run, cuda_seconds, leaf_norm_gap, log, relative_gap
from benchmark.harness.trace import profile_span
from benchmark.reference import steps as ref_steps

N_CHECKED = 3  # steps the reference follows
N_TRACED = 2  # whole steps in the profiled span


def extractor_shapes(ex: dict) -> Dict[str, tuple]:
    """The extractor's parameters and their shapes, in the order drawn."""
    shapes, prev = {}, ex["in_ch"]
    kf, kt = ex["kernel_size"]
    for i, c in enumerate(ex["out_channels"]):
        shapes[f"convs.{i}.weight"] = (c, prev, kf, kt)
        shapes[f"convs.{i}.bias"] = (c,)
        prev = c
    for i, c in enumerate(ex["out_channels"]):
        shapes[f"prelus.{i}.alpha"] = (c,)
    shapes["out.weight"] = (ex["latent_dim"], prev)
    shapes["out.bias"] = (ex["latent_dim"],)
    return shapes


def seeded_init(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights from the seed, made on the device in one draw: weights
    normal (std sqrt(1 / fan_in) / 0.8796, cut at 2 std, as flax's
    lecun_normal), biases 0, PReLU slopes 0.25."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ws = [k for k in shapes if k.endswith("weight")]
    flat = torch.fmod(torch.randn(sum(math.prod(shapes[k]) for k in ws), generator=gen, device=device), 2.0)
    out, at = {}, 0
    for k, shape in shapes.items():
        if k in ws:
            n = math.prod(shape)
            std = (shape[0] / n) ** 0.5 / 0.87962566103423978
            out[k] = (flat[at:at + n] * std).reshape(shape)
            at += n
        elif k.endswith("alpha"):
            out[k] = torch.full(shape, 0.25, device=device)
        else:
            out[k] = torch.zeros(shape, device=device)
    return out


def optimizer_factory(opt: dict) -> Callable:
    return lambda params: torch.optim.AdamW(params, lr=opt["lr"], betas=tuple(opt["betas"]),
                                            eps=opt["eps"], weight_decay=opt["weight_decay"])


class Stage1:
    """The extractor's step: render (K1, K2) -> Mel frontend -> SpecAugment
    -> bf16 trunk -> l1 + 5 fdl1 + 10 sdl1 -> AdamW."""

    def __init__(self, run: Run, device, corpus, pool):
        from mod_extraction_tpu_torch.models.spectral_2dcnn import Spectral2DCNN
        from mod_extraction_tpu_torch.train.lfo_task import LFOExtractionTask
        from mod_extraction_tpu_torch.train.render import RenderConfig

        cfg, s1 = run.config, run.config["stage1"]
        self.ex, self.sr, self.t = cfg["extractor"], cfg["sr"], cfg["n_samples"]
        self.model = Spectral2DCNN(**self.ex, n_samples=self.t, sr=self.sr,
                                   compute_dtype=cfg["precision"]["trunk_convs"])
        self.init = seeded_init(extractor_shapes(self.ex), run.host_seed, device)
        self.model.load_state_dict(self.init)
        self.render_cfg = RenderConfig(
            sr=self.sr, n_samples=self.t, effects=generator.effects(run.traffic),
            max_delay_samples=generator.max_delay_samples(run.traffic, self.sr),
            phaser_n_stages=s1["phaser_n_stages"])
        self.task = LFOExtractionTask(
            self.model, self.render_cfg, optimizer=optimizer_factory(s1), use_dry=s1["use_dry"],
            model_smooth_n_frames=s1["model_smooth_n_frames"], should_stretch=s1["should_stretch"],
            loss_dict=s1["loss"], device=device, seed=run.host_seed)
        self.device, self.corpus, self.pool = device, corpus, pool
        self.draws = generator.mask_draws(run.host_seed, run.traffic["pool_batches"])
        self.batch = run.traffic["batch_size"]

    def step(self, i: int) -> float:
        p = i % len(self.draws)
        m = self.task.train_step(generator.pool_batch(self.pool, p), self.corpus, mask_draws=self.draws[p])
        return float(m["loss"])

    def leaves(self) -> Dict[str, torch.Tensor]:
        return dict(self.task.trained_model.named_parameters())

    def step_least_s(self) -> float:
        bf16, f32 = counts.extractor_flops(self.batch, self.ex, self.t, backward=True)
        return counts.least_seconds(bf16, f32)

    def probes(self) -> Dict[str, tuple]:
        from mod_extraction_tpu_torch.train.render import render_batch

        b = generator.pool_batch(self.pool, 0)
        with torch.no_grad():
            dry, wet, _, _ = render_batch(b, self.render_cfg, self.corpus)
        x = torch.cat([dry, wet], dim=1)
        draws = self.draws[0]

        def render():
            with torch.no_grad():
                render_batch(b, self.render_cfg, self.corpus)

        def trunk():
            self.model.zero_grad(set_to_none=True)
            y, _ = self.model(x, mask_draws=draws)
            y.sum().backward()

        nbytes = counts.render_bytes(self.batch, self.t, self.t // generator.MOD_SIG_DIVISOR)
        return {"render": (render, nbytes / counts.PEAK_HBM_BYTES),
                "trunk": (trunk, self.step_least_s())}


class Stage2:
    """The TBPTT step: render (K1) -> frozen extractor (bf16) -> smoothing,
    corner stretch, validity, crop, upsampling -> warm-up (K3) -> per chunk
    forward (K4), l1, backward (K5), AdamW."""

    def __init__(self, run: Run, device, corpus, pool):
        from mod_extraction_tpu_torch.models.convert import load_lstm_effect_model, load_spectral_2dcnn
        from mod_extraction_tpu_torch.train.render import RenderConfig
        from mod_extraction_tpu_torch.train.tbptt_task import TBPTTEffectModelingTask

        cfg, s2 = run.config, run.config["stage2"]
        self.ex, self.sr, self.t = cfg["extractor"], cfg["sr"], cfg["n_samples"]
        self.ex_path = str(ROOT / cfg["extractor_weights"])
        self.em_path = str(ROOT / cfg["effect_model_weights"])
        extractor = load_spectral_2dcnn(self.ex_path, device=device, **self.ex, n_samples=self.t,
                                        sr=self.sr, compute_dtype=cfg["precision"]["trunk_convs"])
        self.em = load_lstm_effect_model(self.em_path, device=device)
        self.render_cfg = RenderConfig(
            sr=self.sr, n_samples=self.t, effects=generator.effects(run.traffic),
            max_delay_samples=generator.max_delay_samples(run.traffic, self.sr))
        self.task = TBPTTEffectModelingTask(
            self.em, self.render_cfg, warmup_n_samples=s2["warmup_n_samples"],
            step_n_samples=s2["step_n_samples"], lfo_model=extractor, freeze_lfo_model=True,
            optimizer=optimizer_factory(s2), use_dry=s2["use_dry"],
            model_smooth_n_frames=s2["model_smooth_n_frames"], should_stretch=s2["should_stretch"],
            max_n_corners=s2["max_n_corners"], discard_invalid_lfos=s2["discard_invalid_lfos"],
            loss_dict=s2["loss"], device=device, seed=run.host_seed)
        self.init = {k: v.detach().clone() for k, v in self.leaves().items()}
        self.device, self.corpus, self.pool = device, corpus, pool
        self.batch = run.traffic["batch_size"]
        self.s2 = s2
        self.n_pool = run.traffic["pool_batches"]
        self.seed = run.host_seed

    def step(self, i: int) -> float:
        m = self.task.train_step(generator.pool_batch(self.pool, i % self.n_pool), self.corpus)
        return float(m["loss"])

    def leaves(self) -> Dict[str, torch.Tensor]:
        return dict(self.task.trained_model.named_parameters())

    def step_least_s(self) -> float:
        w, s = self.s2["warmup_n_samples"], self.s2["step_n_samples"]
        frames = self.t // self.ex["hop_len"] + 1  # the LFO's frames, then cropped by the smoothing
        cropped = int(((frames - (self.s2["model_smooth_n_frames"] - 1)) / frames) * self.t)
        bf16, f32 = counts.tbptt_step_flops(self.batch, self.t, self.ex, self.em.n_hidden, w, s,
                                            (cropped - w) // s)
        return counts.least_seconds(bf16, f32)

    def probes(self) -> Dict[str, tuple]:
        from mod_extraction_tpu_torch.models.lstm import lstm_init_state

        s, b = self.s2["step_n_samples"], self.batch
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        audio = self.corpus[: 2 * b * s].to(torch.float32).reshape(b, 1, 2 * s) / 32768.0
        lfo = torch.rand(b, 1, 2 * s, generator=gen, device=self.device)
        with torch.no_grad():
            _, hidden = self.em(audio[:, :, :s], lfo[:, :, :s],
                                lstm_init_state(b, self.em.n_hidden, self.device))
        x, lat = audio[:, :, s:].contiguous(), lfo[:, :, s:].contiguous()

        def chunk():
            self.em.zero_grad(set_to_none=True)
            y, _ = self.em(x, lat, hidden)
            y.sum().backward()

        return {"lstm_chunk": (chunk, counts.lstm_chunk_least_s(b, s, self.em.n_hidden))}


def timed_window(step: Callable[[int], float], first: int, seconds: float) -> Dict:
    """Whole steps from index `first` until one ends `seconds` or more
    after the window opened; each step's loss read back.  A step that
    raises or whose loss is not finite is failed."""
    durations: List[float] = []
    failed, i, logged = 0, first, False
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        try:
            ok = math.isfinite(step(i))
        except Exception:  # a failed step counts; the window goes on
            ok = False
            if not logged:
                log(traceback.format_exc())
                logged = True
        te = time.perf_counter()
        durations.append(te - ts)
        failed += not ok
        i += 1
        if te - t0 >= seconds:
            break
    return {"durations": durations, "failed": failed, "attempted": len(durations),
            "window_s": te - t0, "next": i}


def first_grad_hook(optimizer, leaves: Dict[str, torch.Tensor], out: Dict) -> None:
    """Copy each leaf's gradient as the optimizer gets it at its first update."""
    names = {id(p): k for k, p in leaves.items()}

    def hook(opt, args, kwargs):
        if not out:
            for group in opt.param_groups:
                for p in group["params"]:
                    if id(p) in names and p.grad is not None:
                        out[names[id(p)]] = p.grad.detach().clone()
        handle.remove()

    handle = optimizer.register_step_pre_hook(hook)


def prepare(run: Run):
    """The corpus, the pool of batches (host and device) and the task."""
    device = torch.device(run.device)
    cfg, tr = run.config, run.traffic
    corpus = generator.make_corpus(run.host_seed, tr["corpus_seconds"], cfg["sr"], tr["peak"],
                                   cfg["n_samples"], device)
    pool_np = generator.make_pool(run.host_seed, tr, cfg["n_samples"], cfg["sr"], corpus.numel())
    pool = generator.to_device(pool_np, device)
    cell = (Stage1 if tr["kind"] == "train_lfo" else Stage2)(run, device, corpus, pool)
    return corpus, pool_np, cell


def checked_steps(cell) -> Dict:
    """The first steps through the window's call and feed: their losses,
    the first gradient as the optimizer gets it, the weights after them."""
    grad1: Dict[str, torch.Tensor] = {}
    first_grad_hook(cell.task.optimizer, cell.leaves(), grad1)
    losses = [cell.step(i) for i in range(N_CHECKED)]
    return {"losses": losses, "grad1": grad1,
            "after": {k: v.detach().clone() for k, v in cell.leaves().items()}}


def reference_inputs(run: Run, cell, prog: Dict, pool_np, corpus) -> tuple:
    """What the comparison needs, on the host, and the reference's call;
    neither holds the program's state, which the caller then frees."""
    device = torch.device(run.device)
    cfg, tr = run.config, run.traffic
    batches = [generator.pool_batch(pool_np, i) for i in range(N_CHECKED)]
    corpus_np = corpus.cpu().numpy()
    host = {"losses": prog["losses"], "grad1": {k: v.cpu() for k, v in prog["grad1"].items()},
            "after": {k: v.cpu() for k, v in prog["after"].items()},
            "init": {k: v.detach().cpu() for k, v in cell.init.items()}}
    if isinstance(cell, Stage1):
        draws = cell.draws[:N_CHECKED].numpy()
        return host, lambda: ref_steps.stage1(host["init"], batches, corpus_np, draws, cfg, tr, device)
    paths = (cell.ex_path, cell.em_path)
    return host, lambda: ref_steps.stage2(*paths, batches, corpus_np, cfg, tr, device)


def reference_values(host: Dict, call) -> Dict[str, float]:
    t_ref = time.perf_counter()
    ref = call()
    log(f"reference: {time.perf_counter() - t_ref:.1f} s; valid shares {ref.get('valid')}")
    return compare(host, ref)


def release(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(run: Run) -> Dict:
    device = torch.device(run.device)
    cfg, tr = run.config, run.traffic
    t_built = time.perf_counter()
    corpus, pool_np, cell = prepare(run)
    t_task = time.perf_counter()
    prog = checked_steps(cell)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - run.t0
    log(f"set-up: {t_built - run.t0:.2f} s to the driver (imports, card), {t_task - t_built:.2f} s "
        f"corpus, batches and task, {time.perf_counter() - t_task:.2f} s the checked steps")

    win = timed_window(cell.step, N_CHECKED, run.seconds)
    audio_s = (win["attempted"] - win["failed"]) * tr["batch_size"] * cfg["n_samples"] / cfg["sr"]
    out = {"attempted": win["attempted"], "failed": win["failed"],
           "end_to_end": {tr["throughput_metric"]: audio_s / win["window_s"], "setup_s": setup_s},
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0}
    log(f"window: {win['attempted']} steps in {win['window_s']:.3f} s, failed {win['failed']}, "
        f"step ms median {1e3 * float(np.median(win['durations'])):.3f}")
    if run.trace:
        nxt = win["next"]
        trace = profile_span(lambda: [cell.step(i) for i in range(nxt, nxt + N_TRACED)] and N_TRACED)
        run.obs.update(unit="step", trace=trace, step_s=win["durations"],
                       step_least_s=cell.step_least_s(), probes=cell.probes(), time_probe=cuda_seconds)
        out["per_layer"] = run.read_layers()
        out["trace"] = trace
        run.obs.clear()
    host, call = reference_inputs(run, cell, prog, pool_np, corpus)
    del cell, corpus, prog
    release(device)
    out["values"] = reference_values(host, call)
    return out


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The compared numbers: each checked step's loss, the first gradient's
    norm and the change of the weights over the checked steps, the last two
    by the worst leaf."""
    values = {f"loss{k + 1}": relative_gap(p, r) for k, (p, r) in enumerate(zip(prog["losses"], ref["losses"]))}
    g_ref = ref_steps.norms(ref["grad1"])
    g_prog = ref_steps.norms(prog["grad1"]) if prog["grad1"] else {k: math.inf for k in g_ref}
    values["grad1"], worst_g = leaf_norm_gap(g_prog, g_ref, sorted(g_ref))
    moved = ref_steps.moved_leaves(g_ref)
    c_ref = ref_steps.change_norms(ref["params"], prog["init"])
    c_prog = ref_steps.change_norms(prog["after"], prog["init"])
    values["change3"], worst_c = leaf_norm_gap(c_prog, c_ref, moved)
    log(f"worst leaves: grad1 {worst_g}, change3 {worst_c}; leaves left out of change3: "
        f"{sorted(set(g_ref) - set(moved))}")
    return values
