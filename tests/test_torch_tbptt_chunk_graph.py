"""The TBPTT task's static chunk updates (`TBPTTEffectModelingTask.
_static_chunks`, the form the card captures and replays as a CUDA graph),
run eagerly on the CPU against the eager loop: bit for bit over two steps
at H 64 and a short clip (metrics, every weight, the optimizer's state),
through the static step buffers, the device-side chunk index, the output
slots and the state write-back, with a float lr and with an lr tensor a
schedule writes in place.  Also: the paths that keep the eager loop (the
unfrozen extractor, the param model, the CPU), the optimizer's two forms
(`lfo_task.optimizer_form`) and a saved state loading into either.  Torch
only; every case runs in a few seconds."""

import copy
import math

import pytest
import torch

from mod_extraction_tpu_torch.data.synthetic import batch_to_torch, make_synthetic_batch
from mod_extraction_tpu_torch.models.lstm import LSTMEffectModel
from mod_extraction_tpu_torch.models.spectral_2dcnn import Spectral2DCNN
from mod_extraction_tpu_torch.models.tcn import SpectralDSTCN
from mod_extraction_tpu_torch.train.lfo_task import adamw, make_optimizer, optimizer_form
from mod_extraction_tpu_torch.train.render import RenderConfig
from mod_extraction_tpu_torch.train.tbptt_task import TBPTTEffectModelingTask

SR, N, CHUNK, HID, B = 8000.0, 4000, 256, 64, 4
RENDER = dict(sr=SR, n_samples=N, effects=(2,), max_delay_samples=89)
TINY = dict(in_ch=2, n_samples=N, sr=SR, n_fft=256, hop_len=64, n_mels=16, out_channels=(4, 4),
            bin_dilations=(1, 1), temp_dilations=(1, 2), pool_size=(2, 1), compute_dtype="float32")
DSTCN = dict(n_samples=N, n_fft=256, hop_len=64, kernel_size=5, out_channels=(4, 4), dilations=(1, 2),
             strides=(2, 2), n_fc_units=8, latent_dim=2)
LR = 2.0**-13  # a float32 value: the lr's two forms hold it exactly


def cosine(u: int) -> float:
    return LR * 0.5 * (1 + math.cos(math.pi * min(u, 20) / 20))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_task(conditioning: str = "frozen", static: bool = False, schedule=None, **kw):
    """An LSTM-64 task on the CPU: conditioned on a tiny frozen extractor,
    the ground truth, an unfrozen extractor or a param model's latent."""
    lfo = Spectral2DCNN(**TINY, seed=2) if conditioning in ("frozen", "unfrozen") else None
    param = SpectralDSTCN(**DSTCN, seed=3) if conditioning == "param_model" else None
    task = TBPTTEffectModelingTask(
        LSTMEffectModel(n_hidden=HID, latent_dim=1 + (DSTCN["latent_dim"] if param else 0),
                        generator=torch.Generator().manual_seed(1)),
        RenderConfig(**RENDER), lfo_model=lfo, freeze_lfo_model=conditioning != "unfrozen", param_model=param,
        optimizer=lambda params: adamw(params, lr=LR), lr_schedule=schedule, device="cpu",
        warmup_n_samples=CHUNK, step_n_samples=CHUNK, discard_invalid_lfos=conditioning == "gt_lfo", **kw)
    task.static_chunks = static
    return task


def batches(n=2, seed=3):
    return [batch_to_torch(make_synthetic_batch(seed + i, B, N, SR, "flanger"), "cpu") for i in range(n)]


def n_chunks(task, batch) -> int:
    """The updates of a step (the tiny extractor's hop is not the 256 that
    `updates_per_batch` assumes)."""
    return (task._prepare(batch)[0].shape[-1] - CHUNK) // CHUNK


def run(task, bs):
    return [task.train_step(b) for b in bs]


def assert_same(a, b, ma, mb):
    """Metrics, every weight and the optimizer's state, bit for bit."""
    for x, y in zip(ma, mb):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k
    for (k, p), q in zip(a.trained_model.named_parameters(), b.trained_model.parameters()):
        assert torch.equal(p, q), k
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        assert sa.keys() == sb.keys()
        for name in sa:
            assert torch.equal(sa[name], sb[name]), (k, name)


@pytest.mark.parametrize("conditioning", ["frozen", "gt_lfo"])
def test_static_chunks_equal_the_eager_loop(conditioning):
    """Two steps of 7 to 12 updates each: the static updates (one shape,
    no graph off the card) give the eager loop's bits."""
    bs = batches()
    eager, static = make_task(conditioning), make_task(conditioning, static=True)
    m_eager, m_static = run(eager, bs), run(static, bs)
    assert_same(eager, static, m_eager, m_static)
    assert eager.graphs.keys() == []
    (key,) = static.graphs.keys()
    n = n_chunks(static, bs[0])
    assert key == (B, (1, 1, 1), n, CHUNK) and static.graphs.captured() == []
    assert int(static.graphs.entry(key, None).buffers.index) == n  # advanced once an update, reset once a step


def test_static_chunks_with_a_scheduled_lr_tensor():
    """A schedule writing each group's lr tensor in place before each
    update (the capturable form's lr, here on the host): it holds
    float32(schedule(u)) at update u, stays one tensor, and the static
    updates equal the eager loop's bit for bit."""
    bs = batches(seed=7)
    tasks, seen = {}, {}
    for static in (False, True):
        t = tasks[static] = make_task("frozen", static, schedule=cosine)
        group = t.optimizer.param_groups[0]
        lr = group["lr"] = torch.tensor(float(group["lr"]), dtype=torch.float32)
        out = seen[static] = []
        t.optimizer.register_step_pre_hook(
            lambda opt, args, kwargs, out=out, lr=lr: out.append((opt.param_groups[0]["lr"] is lr, lr.clone())))
    ms = {static: run(t, bs) for static, t in tasks.items()}
    n_up = sum(n_chunks(tasks[True], b) for b in bs)
    want = [torch.tensor(LR * (cosine(u) / LR), dtype=torch.float32) for u in range(n_up)]
    for static in (False, True):
        assert len(seen[static]) == n_up
        assert all(same and torch.equal(v, w) for (same, v), w in zip(seen[static], want)), static
    assert_same(tasks[False], tasks[True], ms[False], ms[True])
    assert tasks[True].scheduler.last_epoch == n_up


@pytest.mark.parametrize("conditioning", ["unfrozen", "param_model"])
def test_paths_that_stay_eager(conditioning):
    """A conditioning made chunk by chunk keeps the eager loop and the
    host-form optimizer (as does every path on the CPU); static updates
    of it are refused."""
    task = make_task(conditioning)
    assert not task.static_chunks and not task.capturable
    assert not task.optimizer.param_groups[0]["capturable"]
    assert isinstance(task.optimizer.param_groups[0]["lr"], float)
    task.static_chunks = True
    with pytest.raises(ValueError, match="fixed for the step"):
        task.train_step(batches(1)[0])


def test_cpu_tasks_keep_the_host_form():
    task = make_task("frozen")
    assert not task.static_chunks and not task.capturable
    group = task.optimizer.param_groups[0]
    assert group["capturable"] is False and isinstance(group["lr"], float)


def test_make_optimizer_capturable_form():
    """Capturable: each group's lr a float32 tensor on the parameters'
    device, which the schedule fills in place; an optimizer with no
    capturable form (SGD) is left as built."""
    params = [torch.nn.Parameter(torch.zeros(3))]
    opt, sched = make_optimizer(params, lambda p: adamw(p, lr=1e-3), lambda u: 1e-3 / (1 + u), capturable=True)
    group = opt.param_groups[0]
    lr = group["lr"]
    assert group["capturable"] and torch.is_tensor(lr) and lr.dtype == torch.float32
    assert lr.device == params[0].device and torch.equal(lr, torch.tensor(1e-3, dtype=torch.float32))
    for u in (1, 2, 3):
        opt.step()  # no gradients: a no-op, in the order torch wants
        sched.step()
        assert group["lr"] is lr and torch.equal(lr, torch.tensor(1e-3 * ((1e-3 / (1 + u)) / 1e-3),
                                                                    dtype=torch.float32))
    sgd, _ = make_optimizer(params, lambda p: torch.optim.SGD(p, lr=0.1), None, capturable=True)
    assert sgd.param_groups[0]["lr"] == 0.1 and "capturable" not in sgd.param_groups[0]


def _card_form(state: dict) -> dict:
    """A task's saved state as a capturable optimizer saves it: lr
    tensors, the step counters tensors beside them, capturable on."""
    state = copy.deepcopy(state)
    for group in state["optimizer"]["param_groups"]:
        group.update(capturable=True, lr=torch.tensor(group["lr"], dtype=torch.float32))
    return state


@pytest.mark.parametrize("saved", ["host", "card"])
def test_saved_state_loads_in_either_form(saved):
    """A step, its state saved in either optimizer form and loaded into a
    fresh task, which keeps its own (host) form; its second step equals
    two steps in one task, bit for bit."""
    bs = batches(seed=11)
    whole = make_task("gt_lfo", static=True)
    m_whole = run(whole, bs)
    first = make_task("gt_lfo", static=True)
    run(first, bs[:1])
    state = first.state_dict()
    if saved == "card":
        state = _card_form(state)
    resumed = make_task("gt_lfo", static=True)
    resumed.load_state_dict(state)
    group = resumed.optimizer.param_groups[0]
    assert group["capturable"] is False and isinstance(group["lr"], float)
    assert all(s["step"].device.type == "cpu" for s in resumed.optimizer.state.values())
    assert_same(whole, resumed, m_whole[1:], run(resumed, bs[1:]))


def test_optimizer_form_round_trip():
    """To the capturable form and back: the lr (a float32 value) and the
    step counters keep their values; the form's flag follows."""
    params = [torch.nn.Parameter(torch.ones(3))]
    opt = adamw(params, lr=LR)
    params[0].grad = torch.ones(3)
    opt.step()
    optimizer_form(opt, True)
    group = opt.param_groups[0]
    assert group["capturable"] and torch.equal(group["lr"], torch.tensor(LR, dtype=torch.float32))
    assert opt._warned_capturable_if_run_uncaptured
    optimizer_form(opt, False)
    assert group["capturable"] is False and group["lr"] == LR
    assert float(opt.state[params[0]]["step"]) == 1.0
