"""The stage-2 losses of the port (esr, dc) and the weighted loss dict
holding them, against the JAX package on the CPU, with and without
per-example weights (zero weights included).  Tolerance: rtol 1e-5
(float32 reductions in another order; dc squares a mean error that is
small against the signal, so its last digits carry most of the rounding)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mod_extraction_tpu import losses as jl
from mod_extraction_tpu_torch.losses import losses as tl


def _data(rng):
    y = (0.5 * rng.standard_normal((5, 1, 900))).astype(np.float32)
    y_hat = (y + 0.1 * rng.standard_normal(y.shape)).astype(np.float32)
    return y_hat, y


@pytest.mark.parametrize("name", ["esr", "dc"])
@pytest.mark.parametrize("weighted", [False, True])
def test_esr_dc_match_jax(name, weighted, rng):
    y_hat, y = _data(rng)
    w = np.array([1, 0, 1, 1, 0], np.float32) if weighted else None
    ref = getattr(jl, f"{name}_loss")(jnp.asarray(y_hat), jnp.asarray(y),
                                      None if w is None else jnp.asarray(w))
    out = tl._LOSS_REGISTRY[name](torch.from_numpy(y_hat), torch.from_numpy(y),
                                  None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-5)


def test_stage2_loss_dict_matches_jax(rng):
    y_hat, y = _data(rng)
    w = np.array([1, 1, 0, 1, 0], np.float32)
    cfg = {"l1": 1.0, "esr": 0.0, "dc": 0.0}
    _, mj = jl.WeightedLossDict(cfg)(jnp.asarray(y_hat), jnp.asarray(y), jnp.asarray(w))
    _, mt = tl.WeightedLossDict(cfg)(torch.from_numpy(y_hat), torch.from_numpy(y), torch.from_numpy(w))
    assert set(mt) == set(mj) == {"l1", "esr", "dc", "loss"}
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5, err_msg=k)
