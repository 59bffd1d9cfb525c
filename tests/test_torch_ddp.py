"""Data parallelism in the port (`mod_extraction_tpu_torch/parallel/`) on
the CPU: two gloo ranks in spawned processes (`run_ranks`, a `file://`
rendezvous, every run bounded by its own timeout that kills the ranks)
against the port's one-process step on the same global batch of 16, and
against the JAX package's 8-way sharded `train_step` on the virtual mesh
`tests/conftest.py` forces (`tests/test_multidevice.py`'s shapes), fed the
same batch, the same initial weights and the SpecAugment draws JAX made.

Tolerances are the JAX oracle's (`tests/test_multidevice.py`): the LFO
step's loss within 1e-5 and its parameters atol 2e-5 / rtol 1e-4; the
TBPTT step's loss within 5e-5 and its parameters atol 5e-5 / rtol 5e-4.
The losses' global values and gradients: rtol 1e-5, atol 1e-7 (float32
sums over two shards against one).  Also: `shard_batch`,
`put_replicated`, uneven validity weights (every invalid LFO on rank 0),
the RandomLFO baseline's draws, `dryrun_multichip(2)`, `cli.fit` on two
ranks (only rank 0 writes, resume loads the same weights on both), the
training script under `torchrun`, and the kernel wrappers' device guard
(by mock: fake CUDA tensors on `cuda:1`).

The sub-batched LFO step (`sub_batch_size`) on 2 and 4 ranks against JAX's
8-way sharded `_train_step_subbatched` and the port's one-process step,
with the LFO step's tolerances: sub-batches of 4 at batch 16 on 2 ranks
(even shares), of 3 at batch 24 on 2 ranks (shares of 1 and 2) and of 2 at
batch 16 on 4 ranks (two ranks hold no row of each sub-batch); and
`cli.fit` of a sub-batched config on two ranks."""

import copy
import glob
import json
import os
import socket
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import torch_ddp_workers as W
from mod_extraction_tpu_torch.data.synthetic import batch_to_torch, make_synthetic_batch
from mod_extraction_tpu_torch.models.convert import flax_lstm_to_state_dict, flax_to_state_dict
from mod_extraction_tpu_torch.ops import conv_kernels, fx_kernels, lstm_kernels
from mod_extraction_tpu_torch.parallel import dist as pdist
from mod_extraction_tpu_torch.parallel.dryrun import dryrun_multichip
from mod_extraction_tpu_torch.train import loop as tloop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LFO_TOL = (1e-5, 2e-5, 1e-4)  # loss atol, parameter atol, parameter rtol
TBPTT_TOL = (5e-5, 5e-5, 5e-4)
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-7
B = 16
TIMEOUT = 120.0  # seconds a spawned run may take
# the sub-batched cases: (world size, global batch, sub_batch_size)
SUB_CASES = {"W2 sub4": (2, 16, 4), "W2 sub3": (2, 24, 3), "W4 sub2": (4, 16, 2)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _take(batch, idx):
    if isinstance(batch, dict):
        return {k: _take(v, idx) for k, v in batch.items()}
    return np.asarray(batch)[idx]


def _assert_params(got, want, atol, rtol):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=atol, rtol=rtol, err_msg=k)


# ---------------------------------------------------------------------------
# the JAX references: 8-way sharded steps on the virtual mesh
# ---------------------------------------------------------------------------


def _jax_tasks(sub_batch_size=None):
    from mod_extraction_tpu.models import LSTMEffectModel as JLSTM
    from mod_extraction_tpu.models import Spectral2DCNN as JCNN
    from mod_extraction_tpu.train.lfo_task import LFOExtractionTask as JLFO
    from mod_extraction_tpu.train.render import RenderConfig as JRender
    from mod_extraction_tpu.train.tbptt_task import TBPTTEffectModelingTask as JTBPTT

    cfg = JRender(sr=W.SR, n_samples=W.N, effects=(1, 2, 3), max_delay_samples=89)
    adamw = optax.adamw(1e-4, b1=0.8, b2=0.99)
    lfo = JLFO(model=JCNN(**W.CNN), render_cfg=cfg, optimizer=adamw, loss_dict=W.LOSSES,
               sub_batch_size=sub_batch_size)
    tbptt = JTBPTT(effect_model=JLSTM(in_ch=1, out_ch=1, n_hidden=W.HID, latent_dim=1), render_cfg=cfg,
                   lfo_model=None, optimizer=adamw, lstm_impl="scan", **W.TBPTT)
    return lfo, tbptt


def _jax_step(task, batch, n_dev, key):
    from mod_extraction_tpu.parallel.mesh import make_mesh, shard_batch

    mesh = make_mesh(n_dev)
    with jax.sharding.set_mesh(mesh):
        state = task.init_state(jax.random.PRNGKey(0))
        params0 = jax.tree.map(np.asarray, state.params)
        new, m = task.train_step(state, shard_batch(jax.tree.map(jnp.asarray, batch), mesh), key)
    return params0, {k: float(v) for k, v in m.items()}, jax.tree.map(np.asarray, new.params)


def _jax_mask_draws(key):
    """The four SpecAugment uniforms the JAX step draws from its key."""
    k_mask = jax.random.split(key, 3)[1]
    return [float(jax.random.uniform(k)) for k in jax.random.split(k_mask, 4)]


def _jax_sub_batched(case, lfo_params, key):
    """A sub-batched case ({name: (world, batch size, sub)}): JAX's 8-way
    sharded step on its batch (its metrics and parameters) and the port's
    arguments for `W.sub_batched_step` (the same weights, batch and
    SpecAugment draws, one row a sub-batch as `jax.random.split(key, n)`
    gives the sub-batches their keys)."""
    _, b, sub = SUB_CASES[case]
    batch = make_synthetic_batch(4, b, W.N, W.SR, "flanger")
    lfo0, metrics, params = _jax_step(_jax_tasks(sub)[0], batch, 8, key)
    assert all(np.array_equal(v, lfo_params[k]) for k, v in flax_to_state_dict(lfo0).items())
    draws = [_jax_mask_draws(k) for k in jax.random.split(key, b // sub)]
    return (metrics, flax_to_state_dict(params)), (lfo_params, batch, sub, draws)


def _uneven(params):
    """A batch of 16 whose invalid LFOs (validity weight 0) all lie in
    rank 0's half."""
    pool = make_synthetic_batch(7, 40, W.N, W.SR, "flanger")
    weights = W.tbptt_task(params)._prepare(batch_to_torch(pool, "cpu"))[4].numpy()
    invalid, valid = np.flatnonzero(weights == 0), np.flatnonzero(weights == 1)
    k = min(len(invalid), B // 2 - 2)
    assert k >= 1 and len(valid) >= B - k
    return _take(pool, np.concatenate([invalid[:k], valid[: B - k]]))


@pytest.fixture(scope="module")
def runs():
    """Every step case on two ranks (one spawn), in one process, and the
    JAX references."""
    key = jax.random.PRNGKey(3)
    j_lfo, j_tbptt = _jax_tasks()
    batch = make_synthetic_batch(0, B, W.N, W.SR, "flanger")
    lfo0, j_lfo_m, j_lfo_p = _jax_step(j_lfo, batch, 8, key)
    lfo_params = {k: v.numpy() for k, v in flax_to_state_dict(lfo0).items()}
    tb0, j_tb_m, j_tb_p = _jax_step(j_tbptt, batch, 8, key)
    tb_params = {k: v.numpy() for k, v in flax_lstm_to_state_dict(tb0).items()}
    uneven = _uneven(tb_params)
    _, j_un_m, j_un_p = _jax_step(j_tbptt, uneven, 8, key)

    dry = np.asarray(batch["dry"])
    corpus = np.clip(dry.reshape(-1) * 32768.0, -32768, 32767).astype(np.int16)
    corpus_batch = {"dry_idx": np.arange(B, dtype=np.int32) * W.N, "dry_gain": np.ones(B, np.float32),
                    "mod_sig": batch["mod_sig"], "fx": batch["fx"]}
    draws = _jax_mask_draws(key)
    sub_refs = {c: _jax_sub_batched(c, lfo_params, key) for c in SUB_CASES if SUB_CASES[c][0] == 2}
    sub_cases = {c: args for c, (_, args) in sub_refs.items()}
    cases = {
        "lfo": ("lfo", lfo_params, batch, None, None),
        "lfo_device_corpus": ("lfo", lfo_params, corpus_batch, None, corpus),
        "tbptt": ("tbptt", tb_params, batch, None, None),
        "tbptt_uneven": ("tbptt", tb_params, uneven, None, None),
        "lfo_jax_draws": ("lfo", lfo_params, batch, draws, None),
    }
    rng = np.random.default_rng(0)
    loss_in = (rng.standard_normal((B, 1, 2600)).astype(np.float32),
               rng.standard_normal((B, 1, 2600)).astype(np.float32),
               np.concatenate([np.zeros(5), np.ones(B - 5)]).astype(np.float32))
    job = (cases, batch, loss_in, sub_cases)
    ranks = pdist.run_ranks(_two_rank_job, 2, args=job, device="cpu", timeout=TIMEOUT)
    one = {"steps": W.steps(cases), "random_lfo": W.random_lfo_val(batch),
           "losses": W.losses_and_grads(*loss_in), "sub_batched": W.sub_batched_steps(sub_cases)}
    jax_ref = {"lfo_jax_draws": (j_lfo_m, flax_to_state_dict(j_lfo_p)),
               "tbptt": (j_tb_m, flax_lstm_to_state_dict(j_tb_p)),
               "tbptt_uneven": (j_un_m, flax_lstm_to_state_dict(j_un_p))}
    jax_ref.update({c: ref for c, (ref, _) in sub_refs.items()})
    return dict(ranks=ranks, one=one, jax=jax_ref, loss_in=loss_in, sub_cases=sub_cases, lfo_params=lfo_params,
                key=key)


@pytest.fixture(scope="module")
def sub_runs(runs):
    """The sub-batched cases on their worlds: those of two ranks from the
    spawn of `runs`, the others in a spawn each, with the one-process step
    of each and JAX's references."""
    out = {c: dict(ranks=[r["sub_batched"][c] for r in runs["ranks"]], one=runs["one"]["sub_batched"][c],
                   jax=runs["jax"][c], case=runs["sub_cases"][c]) for c in runs["sub_cases"]}
    for c, (world_size, _, _) in SUB_CASES.items():
        if c in out:
            continue
        ref, args = _jax_sub_batched(c, runs["lfo_params"], runs["key"])
        ranks = pdist.run_ranks(W.sub_batched_steps, world_size, args=({c: args},), device="cpu",
                                timeout=TIMEOUT)
        out[c] = dict(ranks=[r[c] for r in ranks], one=W.sub_batched_step(*args), jax=ref, case=args)
    return out


def _two_rank_job(cases, batch, loss_in, sub_cases):
    return {
        "steps": W.steps(cases),
        "random_lfo": W.random_lfo_val(batch),
        "losses": W.losses_and_grads(*loss_in),
        "local_losses": W.losses_without_collectives(*loss_in),
        "detects": W.check_replicated_detects(1),
        "grads": W.gradients_after_all_reduce([1.0, -2.0, 3.0]),
        "env": W.environment(),
        "sub_batched": W.sub_batched_steps(sub_cases),
    }


# ---------------------------------------------------------------------------
# shard_batch, put_replicated and the helpers without a group
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world_size", [1, 2, 4])
def test_shard_batch_keeps_contiguous_blocks(world_size):
    batch = make_synthetic_batch(1, 8, 400, 8000.0, "flanger")
    shards = [pdist.shard_batch(batch, r, world_size) for r in range(world_size)]
    for r, s in enumerate(shards):
        assert s["dry"].shape[0] == 8 // world_size
        np.testing.assert_array_equal(s["dry"], batch["dry"][r * 8 // world_size : (r + 1) * 8 // world_size])
    np.testing.assert_array_equal(np.concatenate([s["fx"]["rate_hz"] for s in shards]), batch["fx"]["rate_hz"])
    if world_size == 1:
        assert shards[0] is batch


def test_shard_batch_takes_tensors_too():
    t = {"a": torch.arange(12).reshape(6, 2), "b": {"c": torch.arange(6)}}
    s = pdist.shard_batch(t, 2, 3)
    assert torch.equal(s["a"], torch.tensor([[8, 9], [10, 11]])) and torch.equal(s["b"]["c"], torch.tensor([4, 5]))


def test_shard_batch_rejects_a_batch_the_world_does_not_divide():
    with pytest.raises(ValueError, match="global batch dim 99 not divisible by process_count 4"):
        pdist.shard_batch({"x": np.zeros((99, 3))}, 0, 4)
    with pytest.raises(ValueError, match="global batch dim 99 not divisible by process_count 4"):
        pdist.shard_batch({"x": np.zeros((99, 3))}, 0, 4, sub_batch_size=3)
    with pytest.raises(ValueError, match="global batch dim 12 not divisible by sub_batch_size 8"):
        pdist.shard_batch({"x": np.zeros((12, 3))}, 0, 4, sub_batch_size=8)


@pytest.mark.parametrize("b, sub, world_size", [(16, 4, 2), (24, 3, 2), (16, 2, 4), (24, 4, 3), (12, 6, 4),
                                                (8, 8, 8), (6, 1, 3), (32, 8, 2), (24, 12, 8)])
def test_sub_batch_shares_cover_each_sub_batch_once(b, sub, world_size):
    """Over the ranks, the shares of sub-batch i partition its rows; each
    rank holds B / W rows in all; `shard_batch` with `sub_batch_size` takes
    them in order, from arrays and tensors alike."""
    batch = {"x": np.arange(b * 2).reshape(b, 2), "y": {"z": torch.arange(b)}}
    per_rank = [pdist.sub_batch_shares(b, sub, r, world_size) for r in range(world_size)]
    for i in range(b // sub):
        rows = sorted(x for shares in per_rank for x in range(*shares[i]))
        assert rows == list(range(i * sub, (i + 1) * sub))
        sizes = sorted(hi - lo for shares in per_rank for lo, hi in [shares[i]])
        assert sizes[-1] - sizes[0] <= 1
    for r, shares in enumerate(per_rank):
        idx = np.concatenate([np.arange(lo, hi) for lo, hi in shares])
        assert len(idx) == b // world_size
        local = pdist.shard_batch(batch, r, world_size, sub_batch_size=sub)
        np.testing.assert_array_equal(local["x"], batch["x"][idx])
        assert torch.equal(local["y"]["z"], torch.as_tensor(idx))
    assert pdist.sub_batch_shares(b, sub, 0, 1) == [(i * sub, (i + 1) * sub) for i in range(b // sub)]


def test_put_replicated_copies_the_whole_payload():
    payload = {"corpus": np.arange(10, dtype=np.int16), "g": {"x": np.ones((2, 3), np.float32)}}
    out = pdist.put_replicated(payload, "cpu")
    assert out["corpus"].dtype == torch.int16 and torch.equal(out["corpus"], torch.arange(10, dtype=torch.int16))
    assert out["g"]["x"].shape == (2, 3)
    single = pdist.put_replicated(np.arange(4), torch.device("cpu"))
    assert torch.equal(single, torch.arange(4))


def test_helpers_are_the_identity_without_a_group(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert pdist.init_distributed("cpu") == (0, 1, 0) and not pdist.is_distributed()
    assert pdist.world() == (0, 1, 0)
    t = torch.tensor([1.0, 2.0])
    assert pdist.all_reduce_sum(t) is t and pdist.all_reduce_mean(t) is t
    assert pdist.all_reduce_sum_autograd(t) is t
    m = {"loss": torch.tensor(0.5)}
    assert pdist.reduce_metrics(m) is m
    p = torch.nn.Parameter(torch.zeros(2))
    p.grad = torch.tensor([3.0, 4.0])
    pdist.all_reduce_grads([p])
    assert torch.equal(p.grad, torch.tensor([3.0, 4.0]))
    pdist.check_replicated([p])
    pdist.barrier()
    with pdist.process_group("cpu") as w:
        assert w == (0, 1, 0) and not pdist.is_distributed()


def test_resolve_device_gives_the_local_rank_under_a_group(monkeypatch):
    from mod_extraction_tpu_torch.utils import device as udev

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert udev.resolve_device("cuda") == torch.device("cuda", 1)
    assert udev.resolve_device("cuda:0") == torch.device("cuda", 0)  # an explicit index stays
    assert udev.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        udev.resolve_device("cuda")


# ---------------------------------------------------------------------------
# two ranks against one process and against JAX's 8-way sharded step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["lfo", "lfo_device_corpus", "tbptt", "tbptt_uneven", "lfo_jax_draws"])
def test_two_ranks_match_the_one_process_step(runs, case):
    loss_tol, atol, rtol = TBPTT_TOL if case.startswith("tbptt") else LFO_TOL
    want = runs["one"]["steps"][case]
    for r in runs["ranks"]:
        got = r["steps"][case]
        assert set(got["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            assert abs(got["metrics"][k] - v) <= loss_tol, (k, got["metrics"][k], v)
        _assert_params(got["params"], want["params"], atol, rtol)
    a, b = (r["steps"][case]["params"] for r in runs["ranks"])
    assert all(np.array_equal(a[k], b[k]) for k in a), "the ranks' weights differ"


@pytest.mark.parametrize("case", ["lfo_jax_draws", "tbptt", "tbptt_uneven"])
def test_two_ranks_match_jax_sharded_step(runs, case):
    loss_tol, atol, rtol = TBPTT_TOL if case.startswith("tbptt") else LFO_TOL
    j_metrics, j_params = runs["jax"][case]
    want = {k: v.numpy() for k, v in j_params.items()}
    for r in runs["ranks"]:
        got = r["steps"][case]
        assert abs(got["metrics"]["loss"] - j_metrics["loss"]) <= loss_tol
        if case.startswith("tbptt"):
            assert got["metrics"]["valid_fraction"] == pytest.approx(j_metrics["valid_fraction"], abs=1e-7)
        _assert_params(got["params"], want, atol, rtol)


def test_uneven_validity_puts_every_invalid_lfo_on_rank_zero(runs):
    sums = [r["steps"]["tbptt_uneven"]["weight_sum"] for r in runs["ranks"]]
    assert sums[0] < B // 2 and sums[1] == B // 2
    whole = runs["one"]["steps"]["tbptt_uneven"]
    assert whole["weight_sum"] == sum(sums)
    assert runs["ranks"][0]["steps"]["tbptt_uneven"]["metrics"]["valid_fraction"] == pytest.approx(
        whole["weight_sum"] / B)


@pytest.mark.parametrize("weighted", ["unweighted", "weighted"])
@pytest.mark.parametrize("name", sorted(W._LOSS_REGISTRY))
def test_losses_are_global_under_two_ranks(runs, name, weighted):
    """Each loss's value (the tasks' metric) and each row's gradient on two
    ranks equal the one-process loss of the whole batch: weighted means
    divide by the global weight sum, and `mrstft`'s spectral convergence
    takes the global norms."""
    key = f"{name}/{weighted}"
    want = runs["one"]["losses"][key]
    assert runs["ranks"][0]["losses"][key]["value"] == runs["ranks"][1]["losses"][key]["value"]
    np.testing.assert_allclose(runs["ranks"][0]["losses"][key]["value"], want["value"], rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    grad = np.concatenate([r["losses"][key]["grad"] for r in runs["ranks"]])
    np.testing.assert_allclose(grad, want["grad"], rtol=LOSS_RTOL, atol=LOSS_ATOL * np.abs(want["grad"]).max())


def test_losses_start_no_collective_of_their_own(runs):
    """Under the group, rank 0 alone computes every loss with a plain
    weight tensor (every collective made to raise): the value of its own
    rows, as the same call gives without a group."""
    assert runs["ranks"][1]["local_losses"] is None
    want = W.losses_without_collectives(*(a[: B // 2] for a in runs["loss_in"]))
    got = runs["ranks"][0]["local_losses"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=k)


def test_random_lfo_draws_do_not_depend_on_the_rank(runs):
    want = runs["one"]["random_lfo"]
    for r in runs["ranks"]:
        got = r["random_lfo"]
        assert got["next_draw"] == want["next_draw"]  # every generator in step
        for k, v in want["metrics"].items():
            assert got["metrics"][k] == pytest.approx(v, rel=LOSS_RTOL, abs=LOSS_ATOL), k


def test_gradients_are_averaged_over_the_ranks(runs):
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["grads"], np.array([1.0, -2.0, 3.0]) * 1.5, rtol=0, atol=0)


def test_check_replicated_raises_where_weights_differ(runs):
    assert [r["detects"] for r in runs["ranks"]] == [False, True]


def test_sub_batch_size_trains_under_a_world_above_one(sub_runs):
    """Each rank of a sub-batched step holds its shares of the sub-batches
    (`sub_batch_shares`, B / W rows), and every rank ends with the same
    finite metrics and the same moved weights."""
    for case, res in sub_runs.items():
        world_size, b, sub = SUB_CASES[case]
        params0, batch = res["case"][0], res["case"][1]
        for r, got in enumerate(res["ranks"]):
            idx = np.concatenate([np.arange(lo, hi) for lo, hi in pdist.sub_batch_shares(b, sub, r, world_size)])
            assert len(idx) == b // world_size
            np.testing.assert_array_equal(got["rows"], batch["mod_sig"][idx])
            assert got["metrics"] == res["ranks"][0]["metrics"] and all(np.isfinite(list(got["metrics"].values())))
            assert all(np.array_equal(got["params"][k], res["ranks"][0]["params"][k]) for k in params0), case
        assert any(not np.array_equal(res["ranks"][0]["params"][k], v) for k, v in params0.items())


@pytest.mark.parametrize("case", sorted(SUB_CASES))
def test_sub_batched_ranks_match_jax_sharded_step(sub_runs, case):
    """The ranks' sub-batched step against JAX's `_train_step_subbatched`
    on the 8-way mesh: the same global sub-batches, draws and update."""
    loss_tol, atol, rtol = LFO_TOL
    j_metrics, j_params = sub_runs[case]["jax"]
    want = {k: v.numpy() for k, v in j_params.items()}
    for got in sub_runs[case]["ranks"]:
        assert set(got["metrics"]) == set(j_metrics)
        for k, v in j_metrics.items():
            assert abs(got["metrics"][k] - v) <= loss_tol, (k, got["metrics"][k], v)
        _assert_params(got["params"], want, atol, rtol)


@pytest.mark.parametrize("case", sorted(SUB_CASES))
def test_sub_batched_ranks_match_the_one_process_step(sub_runs, case):
    loss_tol, atol, rtol = LFO_TOL
    want = sub_runs[case]["one"]
    np.testing.assert_array_equal(want["rows"], sub_runs[case]["case"][1]["mod_sig"])
    for got in sub_runs[case]["ranks"]:
        for k, v in want["metrics"].items():
            assert abs(got["metrics"][k] - v) <= loss_tol, (k, got["metrics"][k], v)
        _assert_params(got["params"], want["params"], atol, rtol)


def test_ranks_see_torchruns_variables(runs):
    envs = [r["env"] for r in runs["ranks"]]
    assert [e["RANK"] for e in envs] == ["0", "1"] and {e["WORLD_SIZE"] for e in envs} == {"2"}
    assert [e["world"] for e in envs] == [(0, 2, 0), (1, 2, 1)]


# ---------------------------------------------------------------------------
# run_ranks, dryrun, the entry point
# ---------------------------------------------------------------------------


def _fail_on_rank_one():
    if pdist.world().rank == 1:
        raise ValueError("rank one fails")
    pdist.barrier()  # rank 0 would wait here for ever


def _hang_on_rank_one():
    if pdist.world().rank == 1:
        time.sleep(600)
    pdist.barrier()


def test_run_ranks_kills_the_others_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="rank one fails"):
        pdist.run_ranks(_fail_on_rank_one, 2, device="cpu", timeout=60.0)


def test_run_ranks_kills_every_rank_at_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish within 15.0 s"):
        pdist.run_ranks(_hang_on_rank_one, 2, device="cpu", timeout=15.0)
    assert time.monotonic() - t0 < 15.0 + 30.0


def test_run_ranks_runs_on_the_card_by_default():
    """Without a card the default device raises before any rank starts;
    it does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default runs there (tests/test_torch_ddp_cuda.py)")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        pdist.run_ranks(_fail_on_rank_one, 2, timeout=60.0)


def test_dryrun_multichip_runs_on_the_card_by_default():
    """Without a card the default device raises, as every entry point of
    the port does; it does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default runs there (tests/test_torch_ddp_cuda.py)")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        dryrun_multichip(2)


def test_dryrun_multichip_on_two_ranks(capsys):
    results = dryrun_multichip(2, device="cpu", timeout=TIMEOUT)
    out = capsys.readouterr().out
    assert out.count("[dryrun]") == 3 and "2 CPU ranks (gloo)" in out
    for name in ("lfo", "lfo_device_corpus", "tbptt"):
        assert results[0][name] == results[1][name]  # global metrics
        assert all(np.isfinite(v) for v in results[0][name].values())


def test_wet_corpus_is_the_fixed_flanger_of_the_dry_files(tmp_path):
    """`write_wet_corpus` on the CPU (K1's plain version): each wet file
    is the dry file through the fixed flanger, written and read back as
    PCM16, within one PCM16 step."""
    from mod_extraction_tpu_torch.data.mods import np_make_mod_signal
    from mod_extraction_tpu_torch.data.synthetic import (
        WET_FLANGER,
        write_synthetic_corpus,
        write_wet_corpus,
    )
    from mod_extraction_tpu_torch.data.wav import wav_read, wav_write

    write_synthetic_corpus(str(tmp_path / "dry"), n_train=2, n_val=1, dur_s=0.25)
    assert write_wet_corpus(tmp_path / "dry", tmp_path / "wet", device="cpu") == 2  # one call a split
    for split, n in (("train", 2), ("val", 1)):
        paths = sorted((tmp_path / "dry" / split).glob("*.wav"))
        assert [p.name for p in sorted((tmp_path / "wet" / split).glob("*.wav"))] == [p.name for p in paths]
        assert len(paths) == n
        for p in paths:
            dry, sr = wav_read(str(p))
            wet, wet_sr = wav_read(str(tmp_path / "wet" / split / p.name))
            t = dry.shape[-1]
            delay = 441 * WET_FLANGER["width"] * np_make_mod_signal(t, float(sr), WET_FLANGER["rate_hz"], 0.0, "tri")
            delay = delay + WET_FLANGER["min_delay_width"] * 44
            par = {k: torch.full((1, 1, 1), WET_FLANGER[k]) for k in ("feedback", "depth", "mix")}
            want = fx_kernels.flanger_plain(torch.from_numpy(dry)[None], torch.from_numpy(
                delay.astype(np.float32)).reshape(1, 1, t), par["feedback"], par["depth"], par["mix"], 485)
            wav_write(str(tmp_path / "want.wav"), want[0].numpy(), sr)
            assert wet_sr == sr and wet.shape == dry.shape
            np.testing.assert_allclose(wet, wav_read(str(tmp_path / "want.wav"))[0], atol=1.0 / 32768, rtol=0)
            assert np.abs(wet - dry).max() > 1e-3


@pytest.mark.parametrize("config", ["configs/train_lfo_interwoven_all_live_r7.yml",
                                    "configs/train_em_sim_flanger_r7.yml"])
def test_fit_config_points_a_shipped_config_at_the_corpus(tmp_path, config):
    from mod_extraction_tpu_torch.cli import load_yaml_with_includes
    from mod_extraction_tpu_torch.data.synthetic import fit_config

    shipped = load_yaml_with_includes(os.path.join(ROOT, config))
    cfg = fit_config(os.path.join(ROOT, config), tmp_path / "c", tmp_path / "w", 5, 2)
    args, bs = cfg["data"]["init_args"], shipped["data"]["init_args"]["batch_size"]
    assert args["batch_size"] == bs and cfg["custom"]["log_every_n_steps"] == 1
    assert cfg["model"] == shipped["model"] and cfg["optimizer"] == shipped["optimizer"]
    if "shared_train_args" in args:
        assert args["shared_train_args"]["input_dir"] == str(tmp_path / "c" / "train")
        assert args["shared_val_args"]["num_examples_per_epoch"] == 2 * bs
        assert args["shared_train_args"]["num_examples_per_epoch"] == 5 * bs
    else:
        assert (args["dry_val_dir"], args["wet_train_dir"]) == (str(tmp_path / "c" / "val"),
                                                                str(tmp_path / "w" / "train"))
        assert (args["train_num_examples_per_epoch"], args["val_num_examples_per_epoch"]) == (5 * bs, 2 * bs)


@pytest.fixture(scope="module")
def fit_setup(tmp_path_factory):
    """The LFO fit configuration of `tests/test_torch_fit.py` (batch 4 on
    the CPU: two rows a rank), warm-started from JAX-initialised weights."""
    from test_torch_fit import N as FIT_N
    from test_torch_fit import jax_weights, lfo_config, write_corpus

    root = tmp_path_factory.mktemp("ddp_fit")
    write_corpus(str(root / "corpus"))
    weights = jax_weights(str(root / "cnn.npz"), "cnn", FIT_N)
    cfg = lfo_config(str(root / "corpus"), weights)
    cfg["trainer"]["max_epochs"] = 2
    return root, cfg


def _records(out_dir):
    (path,) = glob.glob(os.path.join(out_dir, "*_metrics.jsonl"))
    with open(path) as f:
        return [json.loads(line) for line in f]


def _compare_runs(port_one, port_two, one_params, two_params):
    a, b = _records(port_one), _records(port_two)
    assert [(r["phase"], r["step"]) for r in a] == [(r["phase"], r["step"]) for r in b]  # each line once
    for x, y in zip(a, b):
        for k in ("loss", "val/loss", "train/loss"):
            if k in x:
                assert abs(x[k] - y[k]) <= LFO_TOL[0], (k, x, y)
    for p in two_params:
        _assert_params(p, one_params, LFO_TOL[1], LFO_TOL[2])
    assert all(np.array_equal(two_params[0][k], two_params[1][k]) for k in one_params)


@pytest.fixture(scope="module")
def fit_runs(fit_setup):
    """The fit configuration, and the same with `sub_batch_size` 2 (two
    sub-batches of the batch of 4; each rank takes a row of each through the
    Trainer's feed): an epoch in one process and on two ranks, then a
    second epoch resumed from `last` on each, the two ranks' fits in one
    spawn an epoch.  {name: (one-process dir, two-rank dir, [(one-process
    weights, the ranks' weights) an epoch])}."""
    root, cfg = fit_setup
    sub = copy.deepcopy(cfg)
    sub["model"]["init_args"]["sub_batch_size"] = 2
    cfgs = {"plain": cfg, "sub_batch_size": sub}
    dirs = {name: (str(root / f"{name}_one"), str(root / f"{name}_two")) for name in cfgs}
    out = {name: [] for name in cfgs}
    for args in ((False, 1), (True, 2)):  # an epoch, then resume for a second
        jobs = {name: dict(c, trainer={"max_epochs": 1}) if not args[0] else c for name, c in cfgs.items()}
        ones = {name: W.fit(c, dirs[name][0], *args) for name, c in jobs.items()}
        ranks = pdist.run_ranks(W.fits, 2, args=([(c, dirs[name][1], *args) for name, c in jobs.items()],),
                                device="cpu", timeout=TIMEOUT)
        for i, name in enumerate(jobs):
            out[name].append((ones[name], [r[i] for r in ranks]))
    return {name: (*dirs[name], out[name]) for name in cfgs}


def _check_fit_runs(one, two, epochs):
    """Each epoch's weights on both ranks against one process's, and the
    metric records of both epochs (the resumed run appends to the first's)."""
    for one_params, two_params in epochs[:-1]:
        _compare_runs(one, two, one_params, two_params)
    _compare_runs(one, two, *epochs[-1])
    assert sorted(os.listdir(two)) == sorted(os.listdir(one))
    assert [r["step"] for r in _records(two) if r["phase"] == "train_step"] == [1, 2, 3, 4, 5, 6]


def test_fit_on_two_ranks_matches_one_process_and_resumes(fit_runs):
    _check_fit_runs(*fit_runs["plain"])


def test_fit_with_sub_batch_size_on_two_ranks_matches_one_process_and_resumes(fit_runs):
    _check_fit_runs(*fit_runs["sub_batch_size"])


class _StubTask:
    device = torch.device("cpu")
    has_params = True

    def __init__(self):
        self.trained_model = torch.nn.Linear(2, 1)

    def train_step(self, batch, corpus):
        return {"loss": torch.tensor(0.25)}

    def val_step(self, batch, corpus):
        return {"loss": torch.tensor(0.5)}

    def state_dict(self):
        return {"model": self.trained_model.state_dict()}


class _StubLoader:
    def epoch(self, epoch):
        yield {"x": np.zeros((4, 3), np.float32)}


class _StubDM:
    batch_size = 4
    render_cfg = types.SimpleNamespace(sr=8000.0, n_samples=400)

    def setup(self, stage):
        pass

    def corpus_payload(self):
        return None

    def train_loader(self):
        return _StubLoader()

    def val_loader(self):
        return _StubLoader()


@pytest.mark.parametrize("rank", [0, 1])
def test_only_rank_zero_writes(tmp_path, monkeypatch, rank):
    """A Trainer on rank 1 writes no metric, checkpoint, profile or media
    file (its `world` stubbed; no group, so no collective runs)."""
    monkeypatch.setattr(tloop, "world", lambda: pdist.World(rank, 2, rank))
    calls = []
    out = tmp_path / "out"
    trainer = tloop.Trainer(_StubTask(), _StubDM(), max_epochs=2, out_dir=str(out), run_name="r",
                            log_every_n_steps=1, profile_dir=str(tmp_path / "prof"),
                            media_callback=lambda tr, b, e: calls.append(e), media_every_n_epochs=1)
    trainer.fit()
    if rank == 0:
        assert {"r_ckpts", "r_metrics.jsonl"} <= set(os.listdir(out)) and calls == [0, 1]
    else:
        assert not out.exists() and not (tmp_path / "prof").exists() and calls == []


def test_train_script_under_torchrun(fit_setup, tmp_path):
    """`torchrun --nproc_per_node 2 scripts/train_torch.py <config> --device
    cpu` (gloo): the global batch is the config's, rank 0 writes, and the
    run matches the one-process fit."""
    root, cfg = fit_setup
    first = dict(cfg, trainer={"max_epochs": 1})
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(first))
    out = tmp_path / "run"
    out.mkdir()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    with socket.socket() as sock:  # a free port for the rendezvous, not a fixed one
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node", "2",
         "--master_addr", "localhost", "--master_port", str(port),
         os.path.join(ROOT, "scripts", "train_torch.py"), str(path), "--device", "cpu"],
        cwd=str(out), env=env, capture_output=True, text=True, timeout=TIMEOUT,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    one = str(tmp_path / "one")
    W.fit(first, one)
    a, b = _records(one), _records(str(out / "out"))
    assert [(r["phase"], r["step"]) for r in a] == [(r["phase"], r["step"]) for r in b]
    for x, y in zip(a, b):
        if "loss" in x:
            assert abs(x["loss"] - y["loss"]) <= LFO_TOL[0]


# ---------------------------------------------------------------------------
# the kernel wrappers launch on the card of their tensors
# ---------------------------------------------------------------------------


class _Guard:
    """Stands for `torch.cuda.device`: records the device it holds."""

    held: list = []

    def __init__(self, device):
        self.device = torch.device(device)

    def __enter__(self):
        _Guard.held.append(self.device)

    def __exit__(self, *exc):
        _Guard.held.pop()


class _FakeLib:
    """The ctypes library: records, for each launch, the devices the guard
    held; the query functions return what the wrappers need."""

    LAUNCHES = ("flanger_forward", "phaser_forward", "lstm_forward", "lstm_backward", "conv_wgrad",
                "conv_wgrad_channels_last")
    VALUES = dict(phaser_max_stages=16, phaser_scan_max_stages=8, phaser_chunk_ok=1, phaser_scratch_floats=64,
                  conv_wgrad_max_kf=8, conv_wgrad_chan_tile=64, conv_wgrad_time_tile=64,
                  conv_wgrad_taps_per_block=4, lstm_max_hidden=256, lstm_max_in_dim=8)

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            if name in self.LAUNCHES:
                self.calls.append((name, list(_Guard.held)))
            return self.VALUES.get(name, 0)

        return fn


def _launch(what):
    dev = dict(device="cuda:1")
    if what in ("flanger", "phaser"):
        x, p = torch.empty(2, 1, 64, **dev), torch.empty(2, 1, 1, **dev)
        if what == "flanger":
            return fx_kernels.flanger(x, x, p, p, p, 16)
        return fx_kernels.phaser(x, x, p, p, 6)
    if what in ("conv_wgrad", "channels_last"):
        x = torch.empty(2, 8, 4, 20, **dev)
        if what == "channels_last":
            return conv_kernels.channels_last_bf16(x)
        return conv_kernels.conv2d_wgrad_tapcat(x, x, 5, 13, 1)
    b, t, hid = 2, 16, 8
    seq, xres, h = torch.empty(b, 2, t, **dev), torch.empty(b, 1, t, **dev), torch.empty(b, hid, **dev)
    w = (torch.empty(2, 4 * hid, **dev), torch.empty(hid, 4 * hid, **dev), torch.empty(4 * hid, **dev),
         torch.empty(hid, 1, **dev), torch.empty(1, **dev))
    if what == "lstm_forward":  # K3's operator's CUDA implementation
        return lstm_kernels._lstm_forward_cuda(seq, xres, h, h, *w)
    if what == "lstm_train_forward":
        return lstm_kernels.lstm_train_forward(seq, xres, h, h, *w)
    hs, gates = torch.empty(b, t, hid, **dev), torch.empty(b, t, 4 * hid, **dev)
    return lstm_kernels.lstm_backward(seq, hs, hs, gates, h, h, *w[:2], hs, h, h)


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("what, launch", [
    ("flanger", "flanger_forward"), ("phaser", "phaser_forward"), ("channels_last", "conv_wgrad_channels_last"),
    ("conv_wgrad", "conv_wgrad"), ("lstm_forward", "lstm_forward"), ("lstm_train_forward", "lstm_forward"),
    ("lstm_backward", "lstm_backward"),
])
def test_wrappers_launch_under_the_device_of_their_tensors(monkeypatch, what, launch):
    """Every ctypes launch runs inside `torch.cuda.device(<the tensors'
    card>)`, so a rank whose current device is another card launches on
    the right one (fake CUDA tensors on `cuda:1`; library and guard
    stubbed)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    lib = _FakeLib()
    for mod in (fx_kernels, conv_kernels, lstm_kernels):
        monkeypatch.setattr(mod, "_load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", _Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: types.SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(lstm_kernels, "_sm_count", lambda index: 132)
    with FakeTensorMode(allow_non_fake_inputs=True):
        try:
            _launch(what)
        except RuntimeError as e:  # K5's outputs, views taken after the launch, need a CUDA build
            if what != "lstm_backward" or "not linked with support for cuda" not in str(e):
                raise
    launches = [c for c in lib.calls if c[0] == launch]
    assert launches and all(held == [torch.device("cuda", 1)] for _, held in launches), lib.calls
