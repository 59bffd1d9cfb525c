"""The port's public surface against the JAX package's: every name of a
JAX sub-package's `__all__` imports from the port's sub-package of the same
name (except the listed ones, each with its reason), the names load lazily,
and the three public functions added last (`ops/fx.py::flanger_delay_line`,
`data/datasets.py::default_fx`, `models/common.py::same_pads`) agree with
JAX's.  Tolerance: the delay line within 1e-4 max-abs on CPU tensors (K1's
plain version against the JAX `lax.scan`); the others exactly.  Also: the
new data-preparation scripts refuse a CUDA request without a card before
they write anything.
"""

import importlib
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ("models", "losses", "ops", "parallel", "utils", "data")
# JAX public names with no counterpart in the port, and why (each also
# stated in the port sub-package's docstring)
NO_COUNTERPART = {
    "parallel": {"make_mesh": "no mesh under torch.distributed",
                 "batch_sharding": "no mesh under torch.distributed",
                 "replicated_sharding": "no mesh under torch.distributed"},
    "utils": {name: "utils/prng.py is unported on purpose (threefry keys; ROADMAP.md)"
              for name in ("sample_uniform", "sample_log_uniform", "sample_randint", "sample_choice")},
}
DELAY_TOL = 1e-4


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_public_name_has_its_counterpart(sub):
    jax_pkg = importlib.import_module(f"mod_extraction_tpu.{sub}")
    port_pkg = importlib.import_module(f"mod_extraction_tpu_torch.{sub}")
    missing = NO_COUNTERPART.get(sub, {})
    assert set(port_pkg.__all__) == set(jax_pkg.__all__) - set(missing)
    for name in jax_pkg.__all__:
        if name in missing:
            assert name in port_pkg.__doc__, name
            with pytest.raises(ImportError):
                exec(f"from mod_extraction_tpu_torch.{sub} import {name}", {})
            continue
        scope = {}
        exec(f"from mod_extraction_tpu_torch.{sub} import {name}", scope)
        got, want = scope[name], getattr(jax_pkg, name)
        assert callable(got) == callable(want), name
        if not callable(want):
            assert got == want, name  # constants: LFO_SHAPES
        assert getattr(got, "__name__", name) == getattr(want, "__name__", name)
    with pytest.raises(AttributeError):
        getattr(port_pkg, "not_a_public_name")


def test_reexports_load_nothing_until_used():
    """Importing a sub-package or one of its modules loads none of the
    modules its re-exports name; a re-export loads its own module."""
    code = (
        "import sys\n"
        "import mod_extraction_tpu_torch.models, mod_extraction_tpu_torch.ops.cuda_build\n"
        "import mod_extraction_tpu_torch.losses, mod_extraction_tpu_torch.parallel\n"
        "import mod_extraction_tpu_torch.utils.device, mod_extraction_tpu_torch.data.constants\n"
        "lazy = ['models.spectral_2dcnn', 'models.tcn', 'models.lstm', 'models.random_lfo', 'ops.lfo',\n"
        "        'ops.corners', 'losses.losses', 'parallel.dist', 'utils.interp', 'data.wav']\n"
        "loaded = [m for m in lazy if 'mod_extraction_tpu_torch.' + m in sys.modules]\n"
        "assert not loaded, loaded\n"
        "from mod_extraction_tpu_torch.models import RandomLFO\n"
        "assert 'mod_extraction_tpu_torch.models.random_lfo' in sys.modules\n"
        "assert 'mod_extraction_tpu_torch.models.tcn' not in sys.modules\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_flanger_delay_line_matches_jax():
    from mod_extraction_tpu.ops.fx import flanger_delay_line as jax_delay_line

    from mod_extraction_tpu_torch.ops import fx_kernels
    from mod_extraction_tpu_torch.ops.fx import flanger_delay_line

    rng = np.random.default_rng(3)
    b, c, t, d = 3, 2, 700, 485
    x = (0.8 * rng.uniform(-1, 1, (b, c, t))).astype(np.float32)
    # delays across the line, a few of them outside it
    delays = rng.uniform(-20, d + 20, (b, c, t)).astype(np.float32)
    fb, depth, mix = (rng.uniform(lo, hi, (b, 1, 1)).astype(np.float32)
                      for lo, hi in ((0.0, 0.9), (0.25, 1.0), (0.25, 1.0)))
    want = np.asarray(jax_delay_line(x, delays, fb, depth, mix, d, implementation="scan"))
    fx_kernels.reset_launch_counts()
    for impl in ("auto", "scan", "pallas"):
        got = flanger_delay_line(*(torch.from_numpy(a) for a in (x, delays, fb, depth, mix)), d,
                                 implementation=impl)
        assert got.dtype == torch.float32 and got.shape == (b, c, t)
        assert np.abs(got.numpy() - want).max() <= DELAY_TOL
    assert fx_kernels.LAUNCHES["flanger"] == 0  # the plain version on CPU tensors
    with pytest.raises(ValueError, match="implementation"):
        flanger_delay_line(*(torch.from_numpy(a) for a in (x, delays, fb, depth, mix)), d, implementation="cuda")


def test_flanger_delay_line_does_not_fall_back_off_the_cpu():
    from mod_extraction_tpu_torch.ops import fx_kernels
    from mod_extraction_tpu_torch.ops.fx import flanger_delay_line

    x = torch.empty(2, 1, 64, device="meta")
    p = torch.empty(2, 1, 1, device="meta")
    fx_kernels.reset_launch_counts()
    for impl in ("auto", "scan"):
        with pytest.raises(RuntimeError, match="meta"):
            flanger_delay_line(x, x, p, p, p, 16, implementation=impl)
    assert fx_kernels.LAUNCHES["flanger"] == 0


def test_default_fx_and_same_pads_match_jax():
    from mod_extraction_tpu.data.datasets import default_fx as jax_default_fx
    from mod_extraction_tpu.models.common import same_pads as jax_same_pads

    from mod_extraction_tpu_torch.data.datasets import default_fx
    from mod_extraction_tpu_torch.models.common import same_pads

    got, want = default_fx(), jax_default_fx()
    assert got == want and [type(v) for v in got.values()] == [type(v) for v in want.values()]
    assert got is not default_fx()  # a fresh dict each call
    for k in range(1, 16):
        for dil in (1, 2, 3, 16):
            assert same_pads(k, dil) == jax_same_pads(k, dil)


def load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_new_scripts_refuse_cuda_without_a_card(tmp_path, monkeypatch):
    """Asked for nothing, each script that computes on a device wants the
    card, and raises before it writes anything when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    split = load_script("split_datasets_torch")
    gen = load_script("generate_preproc_datasets_torch")
    warm = load_script("measure_phaser_warmup_delta_torch")
    (tmp_path / "egfx" / "Clean").mkdir(parents=True)
    for run in (lambda: split.main(["egfx", str(tmp_path / "egfx")]),
                lambda: gen.main(["configs/data/gen_idmt_fl.yml", str(tmp_path / "preproc"), "4"]),
                lambda: warm.main(src=str(tmp_path))):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()
    assert sorted(os.listdir(tmp_path)) == ["egfx"] and os.listdir(tmp_path / "egfx") == ["Clean"]
