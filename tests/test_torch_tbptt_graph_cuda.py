"""The TBPTT chunk updates replayed as CUDA graphs, on the card: replayed
steps equal the eager loop's bit for bit (metrics, every weight, the
optimizer's state) with the same capturable optimizer, at H 64 and H 160 at
batch 32 over full 2 s clips; a cosine schedule gives the eager lr at every
update; a short batch captures a second shape; a step pre-hook on the
optimizer sees the first update's real gradients; a saved state resumes in
either optimizer form; the graph cache makes its side stream on its own
card and captures there, whichever card is current.  The ground-truth LFO conditions the steps (no
extractor, so no cuDNN choice enters the comparison).  This file imports
torch, numpy and the port only, so it runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_tbptt_graph_cuda.py
"""

import copy

import pytest
import torch

from mod_extraction_tpu_torch.cli import build_lr, build_optimizer, load_yaml_with_includes
from mod_extraction_tpu_torch.data.synthetic import (
    CHORUS_DELAYS_MS,
    batch_to_torch,
    flanger_max_delay_samples,
    make_synthetic_batch,
)
from mod_extraction_tpu_torch.models.convert import load_lstm_effect_model
from mod_extraction_tpu_torch.ops import lstm_kernels
from mod_extraction_tpu_torch.train.lfo_task import optimizer_form
from mod_extraction_tpu_torch.train.render import RenderConfig
from mod_extraction_tpu_torch.train.tbptt_task import TBPTTEffectModelingTask
from mod_extraction_tpu_torch.utils.graphs import GraphCache

SR, N, B = 44100.0, 88200, 32
MODELS = {  # hidden size -> (weights, config, effect, delay line)
    64: ("models/lstm_64__lfo_2dcnn_r7__sim_flanger.npz", "configs/train_em_sim_flanger_r7.yml", "flanger", 485),
    160: ("models/lstm_160__lfo_2dcnn_r6__sim_chorus.npz", "configs/train_em_sim_chorus_h160.yml", "chorus",
          flanger_max_delay_samples(*CHORUS_DELAYS_MS, SR)),
}
TASK_KEYS = ("warmup_n_samples", "step_n_samples", "use_dry", "model_smooth_n_frames", "should_stretch",
             "max_n_corners", "discard_invalid_lfos", "loss_dict")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graphs replay CUDA kernels; the CPU runs the eager loop)")


def task(hid: int, static: bool, n_samples: int = N, schedule=None):
    """The shipped model's task as its config sets it up, on the ground-truth
    LFO; `static`: the chunk updates replayed (True) or the eager loop."""
    weights, config, _, delay = MODELS[hid]
    cfg = load_yaml_with_includes(config)
    margs = cfg["model"]["init_args"]
    t = TBPTTEffectModelingTask(
        load_lstm_effect_model(weights, device="cuda"),
        RenderConfig(sr=SR, n_samples=n_samples, effects=(2,), max_delay_samples=delay),
        optimizer=build_optimizer(cfg["optimizer"]), lr_schedule=schedule, device="cuda",
        **{k: margs[k] for k in TASK_KEYS})
    assert t.capturable and t.static_chunks
    t.static_chunks = static
    return t


def batches(hid: int, n: int, rows=B, n_samples: int = N, seed: int = 0):
    effect = MODELS[hid][2]
    return [batch_to_torch(make_synthetic_batch(seed + i, rows, n_samples, SR, effect), "cuda") for i in range(n)]


def run(t, bs):
    return [{k: v.clone() for k, v in t.train_step(b).items()} for b in bs]


def assert_same(a, b, ma, mb):
    """Metrics, every weight and the optimizer's state, bit for bit."""
    for x, y in zip(ma, mb):
        for k in x:
            assert torch.equal(x[k], y[k]), k
    for (k, p), q in zip(a.trained_model.named_parameters(), b.trained_model.parameters()):
        assert torch.equal(p, q), k
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        for name in sa:
            assert torch.equal(sa[name], sb[name]), (k, name)


@pytest.mark.cuda
@pytest.mark.parametrize("hid", [64, 160])
def test_replay_matches_eager_on_card(hid):
    """Three steps of 83 updates, replayed against the eager loop with the
    same capturable optimizer: bit for bit; the graph holds one shape."""
    _need_cuda()
    bs = batches(hid, 3)
    eager, replayed = task(hid, False), task(hid, True)
    m_eager, m_replayed = run(eager, bs), run(replayed, bs)
    assert_same(eager, replayed, m_eager, m_replayed)
    assert len(replayed.graphs.keys()) == 1 and replayed.graphs.captured() == replayed.graphs.keys()
    assert eager.graphs.keys() == []


@pytest.mark.cuda
def test_cosine_schedule_under_replay():
    """A cosine schedule with warm-up (`cli.build_lr`) over the updates of
    two short steps: the lr tensor holds float32(schedule(u)) before each
    update u, replayed and eager, and the weights agree bit for bit."""
    _need_cuda()
    n = 22050
    schedule = build_lr({"init_args": {"lr": 1e-3}, "lr_schedule": {
        "name": "cosine", "warmup_steps": 5, "decay_steps": 40, "end_lr": 1e-5}})
    bs = batches(64, 2, n_samples=n, seed=10)
    seen, tasks, lrs = {}, {}, {}
    for static in (False, True):
        t = tasks[static] = task(64, static, n, schedule)
        lr = lrs[static] = t.optimizer.param_groups[0]["lr"]
        seen[static] = [lr.clone()]
        step = t.scheduler.step

        def advance(step=step, lr=lr, out=seen[static]):
            step()
            out.append(lr.clone())

        t.scheduler.step = advance
        assert torch.is_tensor(lr) and lr.device.type == "cuda"
    ms = {static: run(t, bs) for static, t in tasks.items()}
    n_up = 2 * tasks[True].updates_per_batch
    base = tasks[True].scheduler.base_lrs[0]  # LambdaLR's lr: base x schedule(u) / base
    want = [torch.tensor(base * (schedule(u) / base), dtype=torch.float32) for u in range(n_up + 1)]
    for static in (False, True):
        got = [x.cpu() for x in seen[static]]
        assert len(got) == n_up + 1 and all(torch.equal(g, w) for g, w in zip(got, want)), static
        assert tasks[static].optimizer.param_groups[0]["lr"] is lrs[static]  # written in place
    assert_same(tasks[False], tasks[True], ms[False], ms[True])


@pytest.mark.cuda
def test_short_batch_captures_a_second_shape():
    """Batches of 32, 20, 32 and 20 rows: two shapes, each run eagerly once
    and captured once (K4's and K5's Python counters tick at those alone),
    every step bit for bit the eager loop's."""
    _need_cuda()
    n = 22050
    bs = [b for pair in zip(batches(64, 2, 32, n, 20), batches(64, 2, 20, n, 30)) for b in pair]
    eager, replayed = task(64, False, n), task(64, True, n)
    m_eager = run(eager, bs)
    lstm_kernels.reset_launch_counts()
    m_replayed = run(replayed, bs)
    counts = dict(lstm_kernels.LAUNCHES)
    assert_same(eager, replayed, m_eager, m_replayed)
    assert sorted(k[0] for k in replayed.graphs.captured()) == [20, 32]
    assert counts["lstm_train_forward"] == counts["lstm_backward"] == 4  # an eager update and a capture a shape
    assert counts["lstm_forward"] == len(bs)  # the warm-ups stay eager


@pytest.mark.cuda
def test_step_pre_hook_sees_the_first_real_gradients():
    """The first update is eager: a step pre-hook (as the benchmark reads
    the first gradient) copies the gradients the eager loop's first update
    gets, bit for bit."""
    _need_cuda()
    n = 22050
    (b,) = batches(64, 1, n_samples=n, seed=40)
    grads = {}
    for static in (False, True):
        t = task(64, static, n)
        out = grads[static] = {}

        def hook(opt, args, kwargs, out=out, t=t):
            if not out:
                out.update({k: p.grad.detach().clone() for k, p in t.trained_model.named_parameters()})

        t.optimizer.register_step_pre_hook(hook)
        t.train_step(b)
    assert grads[True].keys() == grads[False].keys() and grads[True]
    for k in grads[True]:
        assert torch.equal(grads[True][k], grads[False][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("saved", ["card", "host"])
def test_resume_from_either_optimizer_form(saved):
    """A step, its state saved with the step counters on the card or (as a
    host-form optimizer saves it) on the host, loaded into a fresh task
    that then takes a second step: bit for bit two steps in one task."""
    _need_cuda()
    n = 22050
    bs = batches(64, 2, n_samples=n, seed=50)
    whole = task(64, True, n)
    m_whole = run(whole, bs)
    first = task(64, True, n)
    run(first, bs[:1])
    state = copy.deepcopy(first.state_dict())
    if saved == "host":
        opt = torch.optim.AdamW([torch.nn.Parameter(p.detach().clone()) for p in first.trained_model.parameters()])
        opt.load_state_dict(state["optimizer"])
        optimizer_form(opt, False)
        state["optimizer"] = opt.state_dict()
        assert all(s["step"].device.type == "cpu" for s in state["optimizer"]["state"].values())
    resumed = task(64, True, n)
    resumed.load_state_dict(state)
    assert resumed.optimizer.param_groups[0]["capturable"]
    assert all(s["step"].device.type == "cuda" for s in resumed.optimizer.state.values())
    m_resumed = run(resumed, bs[1:])
    assert_same(whole, resumed, m_whole[1:], m_resumed)


@pytest.mark.cuda
def test_cache_captures_on_its_own_cards_stream():
    """A cache on the last card, used while card 0 is current (another card
    where there are several; the task sets no device itself), runs its first
    use on a side stream of its card and captures its second there: the
    body, doubling a tensor on that card in place, has run four times after
    an eager use, a capture and replay, and two replays."""
    _need_cuda()
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    cache, seen = GraphCache(2, dev, "t.capture"), []
    x = torch.ones(4, device=dev)

    def body():
        seen.append((torch.cuda.current_stream(dev), torch.cuda.is_current_stream_capturing()))
        return x.mul_(2)

    e = cache.entry("k", lambda: None)
    with torch.cuda.device(0):
        for _ in range(4):
            cache.run(e, body)
    torch.cuda.synchronize(dev)
    assert torch.equal(x.cpu(), torch.full((4,), 16.0))
    (eager_stream, eager_capturing), (capture_stream, capturing) = seen
    assert eager_stream == capture_stream != torch.cuda.default_stream(dev)
    assert eager_stream.device == dev and not eager_capturing and capturing
