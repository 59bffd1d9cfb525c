"""The H 160 cluster forward (K3/K4, `csrc/lstm.cu::lstm_fwd_cluster_kernel`)
modelled on the CPU in float32, against the JAX package and the port's
plain version.

On the card the batch runs as thread-block clusters of n CTAs (4 or 8) for
one or two batch rows each (`lstm_kernels.cluster_shape`: 8 CTAs for one
row, 4 for two).  CTA r owns the
hidden units r H/n .. (r+1) H/n - 1 with their four gate columns; the L =
2n lanes of a unit hold, for those columns, the rows k of W_hh in the
vectors l + L i of h (kVec floats each), and use them for each of the
cluster's rows, whose arithmetic is the same.  A step of a row is:

1. each lane's four partial sums over its k, multiply-adds in its order;
2. a shuffle exchange: lanes l ^ 1 trade the gates of the other parity,
   lanes l ^ 2 the other half, then xor-adds over the lanes 4 (and 8)
   apart, so that every lane of a unit holds gate l & 3's whole sum;
3. + the input projection (bias first, then W_ih's rows in order), the
   activation as s / (1 + 2^(-s log2(e) a)) + o, c and h;
4. lane l < n stores h into CTA l's ring: every CTA holds the whole h.

The fc head of a chunk adds over the lanes k = l, l + L, ... and then
butterflies over the L lanes.  `cluster_forward_model` does all of this
with numpy in float32 (a multiply-add rounds once: the product is exact in
float64), and is held against `lstm_effect_model_pallas` in interpret mode
and `lstm_kernels.lstm_forward_plain` within 1e-5 max-abs: y, hn and cn,
and K4's saved h, c and gate activations; state carried across a cut.  The
dispatch rule (`forward_plan`) is held at the shapes the paths use.

The backward walk at H 160 (K5, `csrc/lstm.cu::lstm_bwd_cluster_kernel`)
splits the batch the same way.  CTA r forms the gate cotangents of its own
columns (the cell's backward is local to a unit), and W_hh's columns of
CTA r stay in the registers of the 8 lanes of each output quad (units
4 g .. 4 g + 3; lane l holds the columns in the vectors l + 8 i).  A step of
a row is:

1. the owner of unit u adds the n CTAs' partial sums of dh_{t+1}'s
   recurrent part in rank order (dhn at the first step), then
   dh = that + dh_in, dc = fma(dh, a_o, dc_run), dg = (dh or dc) coef,
   dc_run = dc gf (a_o, coef and gf formed for the chunk beforehand);
2. each lane's four partial sums over its columns, multiply-adds in order;
3. the forward's two-stage exchange over the lanes 1 and 2 apart, then an
   xor-add over the lanes 4 apart: lane l holds unit 4 g + (l & 3)'s partial
   over CTA r's columns, and lane l < 4 sends it to the unit's owner.

The last step's partials, added so, are dh0.  `cluster_backward_model`
does this in float32 and is held against `lstm_backward_plain` (dgates,
dh0, dc0 within 1e-5 max-abs: only the order of float32 sums and the
ex2/rcp tanh differ) and, with the weight gradients and dseq formed from
its dgates, against `jax.vjp` of `lstm_effect_model_pallas_train` in
interpret mode (`_lstm_bwd_kernel`), every leaf within 5e-4 of its largest
magnitude, the kernels' gate on the card.  `backward_plan` is held at the
paths' batches.  The CUDA kernels themselves are compared with the plain
version on the card (`tests/test_torch_cuda_kernels.py`,
`chip_smoke.py`)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mod_extraction_tpu.models.lstm import LSTMEffectModel as JLSTM
from mod_extraction_tpu.ops.pallas_lstm import lstm_effect_model_pallas, lstm_effect_model_pallas_train
from mod_extraction_tpu_torch.ops import lstm_kernels as lk

H = lk.CLUSTER_HIDDEN
ATOL = 1e-5
GRAD_REL = 5e-4  # the backward's leaves against JAX, relative to the leaf's largest magnitude
LOG2E = np.float32(1.4426950408889634)
SIZES = (4, 8)  # the CTAs a cluster that `cluster_shape` can pick
H100_SMS = 132


def _fma(a, b, c):
    """float32 a * b + c rounded once (the product of two float32 is exact
    in float64)."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def _rcp_1p_exp2(z):
    return (np.float32(1) / (np.float32(1) + np.exp2(z.astype(np.float32)))).astype(np.float32)


def _tanh_fast(x):
    return _fma(np.float32(2), _rcp_1p_exp2(np.float32(-2) * LOG2E * x), np.float32(-1))


def partition(n: int, hid: int = H):
    """The kernel's constants for n CTAs a row: (U, L, kVec, the rows k of
    W_hh of lane l in the order the lane adds them)."""
    u, lanes = hid // n, 2 * n
    vec = 4 if (hid // 4) % lanes == 0 else 2
    nv = hid // (lanes * vec)
    ks = np.array([[vec * (l + lanes * i) + e for i in range(nv) for e in range(vec)] for l in range(lanes)])
    return u, lanes, vec, ks


def _xor(a, m):
    """a[..., l ^ m, :]: what lane l receives from lane l ^ m (lanes on
    axis -2)."""
    return a[..., np.arange(a.shape[-2]) ^ m, :]


def cluster_forward_model(n, seq, xres, h0, c0, w_ih, w_hh, b, fc_k, fc_b):
    """The cluster forward in float32 (numpy arrays in the kernel's layouts):
    returns y (B, out_ch, T), hn, cn (B, H), hs, cs (B, T, H), gate
    activations (B, T, 4H)."""
    bsz, in_dim, t_len = seq.shape
    hid = w_hh.shape[0]
    u_n, lanes, _, ks = partition(n, hid)
    q = np.arange(lanes) & 3
    odd, high = ((q & 1) != 0)[:, None], ((q & 2) != 0)[:, None]
    # [gate, lane, i, unit] = W_hh[ks[lane, i], gate H + unit]
    w = np.stack([w_hh[ks][:, :, g * hid:(g + 1) * hid] for g in range(4)])
    s = np.where(q == 2, np.float32(2), np.float32(1))[:, None]
    sl = (-LOG2E * s).astype(np.float32)
    o = np.where(q == 2, np.float32(-1), np.float32(0))[:, None]
    cols = (q[:, None] * hid + np.arange(hid)[None]).astype(np.int64)  # (lanes, H): lane's gate column
    rings = np.repeat(h0[:, None], n, axis=1)  # (B, CTA, H): every CTA's copy of h_{t-1}
    c = c0.copy()
    hs, cs, acts = [], [], []
    for t in range(t_len):
        h_new = np.empty_like(c)
        act_t = np.empty((bsz, 4 * hid), np.float32)
        for r in range(n):  # CTA r, its units
            un = slice(r * u_n, (r + 1) * u_n)
            hv = rings[:, r][:, ks]  # (B, lanes, kK)
            p = [np.zeros((bsz, lanes, u_n), np.float32) for _ in range(4)]
            for i in range(ks.shape[1]):
                for g in range(4):
                    p[g] = _fma(w[g, :, i, un], hv[:, :, i, None], p[g])
            k0, k1 = np.where(odd, p[1], p[0]), np.where(odd, p[3], p[2])
            k0 = k0 + _xor(np.where(odd, p[0], p[1]), 1)
            k1 = k1 + _xor(np.where(odd, p[2], p[3]), 1)
            a = np.where(high, k1, k0) + _xor(np.where(high, k0, k1), 2)
            m = 4
            while m < lanes:
                a = a + _xor(a, m)
                m *= 2
            ax = np.broadcast_to(b[cols[:, un]], a.shape).astype(np.float32)
            for i in range(in_dim):
                ax = _fma(w_ih[i][cols[:, un]][None], seq[:, i, t, None, None], ax)
            a = (a + ax).astype(np.float32)
            act = _fma(s, _rcp_1p_exp2((sl * a).astype(np.float32)), o)  # gate l & 3 in lane l
            gi, gf, gg, go = (act[:, g] for g in range(4))  # every unit's lanes 0 .. 3
            c[:, un] = _fma(gf, c[:, un], (gi * gg).astype(np.float32))
            h_new[:, un] = (go * _tanh_fast(c[:, un])).astype(np.float32)
            for g in range(4):
                act_t[:, g * hid + r * u_n:g * hid + (r + 1) * u_n] = act[:, g]
        # lane l < n of each unit stores its h into CTA l's ring
        for r_dst in range(n):
            rings[:, r_dst] = h_new
        hs.append(h_new)
        cs.append(c.copy())
        acts.append(act_t)
    hs_t = np.stack(hs, 1)
    # fc head: lane l adds k = l, l + L, ..., then a butterfly over the lanes
    out_ch = fc_k.shape[1]
    z = np.zeros((bsz, t_len, lanes, out_ch), np.float32)
    for kk in range(hid // lanes):
        k = np.arange(lanes) + lanes * kk
        z = _fma(hs_t[:, :, k, None], fc_k[k][None, None], z)
    m = 1
    while m < lanes:
        z = z + _xor(z, m)
        m *= 2
    pre = ((z[:, :, 0] + fc_b).astype(np.float32).transpose(0, 2, 1) + xres).astype(np.float32)
    y = np.tanh(pre.astype(np.float64)).astype(np.float32)
    return y, hs_t[:, -1], c, hs_t, np.stack(cs, 1), np.stack(acts, 1)


def _weights(b, t, seed):
    """Flax-initialised H 160 weights, an audio / latent pair and a non-zero
    state, from numpy draws."""
    rng = np.random.default_rng(seed)
    jm = JLSTM(in_ch=1, out_ch=1, n_hidden=H, latent_dim=1)
    x = (0.3 * rng.standard_normal((b, 1, t))).astype(np.float32)
    latent = rng.uniform(0, 1, (b, 1, t)).astype(np.float32)
    h0 = (0.2 * rng.standard_normal((b, H))).astype(np.float32)
    c0 = (0.5 * rng.standard_normal((b, H))).astype(np.float32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), x, latent, (h0, c0)))
    return params, x, latent, h0, c0


def _kernel_args(params, x, latent, h0, c0):
    p = params["params"]
    seq = np.concatenate([latent, x], axis=1)
    return (seq, x, h0, c0, p["w_ih"], p["w_hh"], p["b_gates"], p["fc"]["kernel"], p["fc"]["bias"])


@functools.lru_cache(maxsize=None)
def _case(b, t):
    """The inputs of a case and its references: JAX's kernel in interpret
    mode (y, hn, cn) and the port's plain version (K4's six outputs)."""
    params, x, latent, h0, c0 = _weights(b, t, seed=100 * b + t)
    y, (hn, cn) = lstm_effect_model_pallas(params, x, latent, (h0, c0), interpret=True)
    args = _kernel_args(params, x, latent, h0, c0)
    plain = lk.lstm_forward_plain(*(torch.from_numpy(np.array(a)) for a in args), save_states=True)
    return args, [np.asarray(v) for v in (y, hn, cn)], [v.numpy() for v in plain]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("t", [1, 63, 65, 300])
@pytest.mark.parametrize("b", [1, 2, 3])
def test_model_matches_jax_and_plain(b, t, n):
    args, jax_ref, plain = _case(b, t)
    got = cluster_forward_model(n, *(np.asarray(a, np.float32) for a in args))
    assert [g.shape for g in got] == [p.shape for p in plain]
    for name, g, want in zip(("y", "hn", "cn"), got, jax_ref):
        assert np.abs(g - want).max() <= ATOL, f"{name} against JAX"
    for name, g, want in zip(("y", "hn", "cn", "hs", "cs", "gates"), got, plain):
        assert np.abs(g - want).max() <= ATOL, f"{name} against the plain version"


@pytest.mark.parametrize("n", SIZES)
def test_state_carried_across_a_cut(n):
    """Two calls with the carried state equal one call, and JAX's kernel over
    the whole clip (the serving and TBPTT contract)."""
    args, jax_ref, _ = _case(2, 300)
    args = [np.asarray(a, np.float32) for a in args]
    cut = 130
    full = cluster_forward_model(n, *args)
    seq, xres, h0, c0, *w = args
    y1, h1, c1 = cluster_forward_model(n, seq[..., :cut], xres[..., :cut], h0, c0, *w)[:3]
    y2, h2, c2 = cluster_forward_model(n, seq[..., cut:], xres[..., cut:], h1, c1, *w)[:3]
    y = np.concatenate([y1, y2], axis=-1)
    for got, one, ref in ((y, full[0], jax_ref[0]), (h2, full[1], jax_ref[1]), (c2, full[2], jax_ref[2])):
        assert np.abs(got - one).max() <= ATOL
        assert np.abs(got - ref).max() <= ATOL


@pytest.mark.parametrize("n", SIZES)
def test_partition_holds_every_weight_once(n):
    """Each (row k, gate column) of W_hh lies in exactly one lane of one CTA;
    a lane holds 4 H / (2 n) weights, a CTA 2 H lanes (320 threads)."""
    u_n, lanes, vec, ks = partition(n)
    assert sorted(ks.ravel().tolist()) == list(range(H))  # the lanes of a unit split k
    assert ks.shape == (lanes, H // lanes) and 4 * ks.shape[1] == 4 * H // (2 * n)
    assert u_n * lanes == 2 * H and 32 % lanes == 0 and u_n % 4 == 0
    # a load of h: the lanes of a warp read neighbouring vectors (128 bytes)
    assert sorted(ks[:, :vec].ravel().tolist()) == list(range(lanes * vec))


@pytest.mark.parametrize(
    "batch,hid,plan",
    [
        (1, 160, ("cluster", 8, 1)),   # serving, mono
        (2, 160, ("cluster", 8, 1)),   # serving, stereo
        (3, 160, ("cluster", 8, 1)),   # the TBPTT card-vs-CPU batch
        (15, 160, ("cluster", 8, 1)),  # the largest batch with clusters of 8 in one wave
        (16, 160, ("cluster", 4, 2)),  # the smallest with two rows a cluster of 4
        (30, 160, ("cluster", 4, 2)),
        (31, 160, ("cluster", 4, 2)),
        (32, 160, ("cluster", 4, 2)),  # TBPTT warm-up, chunks and val_step
        (32, 64, ("registers", 1, 1)),
        (2, 64, ("registers", 1, 1)),
        (5, 16, ("registers", 1, 1)),
        (5, 32, ("registers", 1, 1)),
        (5, 48, ("generic", 1, 1)),
        (5, 50, ("generic", 1, 1)),
        (32, 256, ("generic", 1, 1)),
    ],
)
def test_forward_plan(batch, hid, plan):
    assert lk.forward_plan(batch, hid, H100_SMS) == plan


@pytest.mark.parametrize("sms", [H100_SMS, 114, 78])
def test_cluster_shape_rule(sms):
    """Always a shape the kernels have, and one wave in 15/16 of the SMs
    wherever one is possible with these shapes."""
    fit = sms * 15 // 16
    for batch in range(1, 129):
        n, rows = lk.cluster_shape(batch, sms)
        assert (n, rows) in lk.CLUSTER_SHAPES
        if 4 * -(-batch // 2) <= fit:
            assert -(-batch // rows) * n <= fit


# ---------------------------------------------------------------------------
# the backward walk (K5)
# ---------------------------------------------------------------------------

QUAD_LANES = 8  # lanes of an output quad in the backward walk


def backward_partition(n: int, hid: int = H):
    """The backward walk's constants for n CTAs a row: (U, the columns of
    each lane in the order it adds them, as indices into the CTA's [gate]
    [unit] columns, shape (8, 4 U / 8))."""
    if hid % n or (hid // n) % 4:
        raise ValueError(f"no cluster walk of {n} CTAs at H {hid}")
    u_n = hid // n
    n_cols = 4 * u_n // QUAD_LANES
    vec = 4 if n_cols % 4 == 0 else 2
    cols = np.array([[vec * (l + QUAD_LANES * i) + e for i in range(n_cols // vec) for e in range(vec)]
                     for l in range(QUAD_LANES)])
    return u_n, cols


def cluster_backward_model(n, rows, hs, cs, gates, c0, w_hh, dh_in, dhn, dcn):
    """The cluster walk of K5 in float32 (numpy arrays in the kernel's
    layouts, clusters of n CTAs for `rows` batch rows): returns dgates (B, T,
    4H), dh0, dc0 (B, H).  A row past the batch walks the last row again
    and is dropped."""
    if (n, rows) not in lk.CLUSTER_SHAPES:
        raise ValueError(f"no cluster walk of {n} CTAs for {rows} rows")
    bsz, t_len, hid = hs.shape
    pad = -bsz % rows
    if pad:
        hs, cs, gates, c0, dh_in, dhn, dcn = (np.concatenate([a, np.repeat(a[-1:], pad, 0)])
                                              for a in (hs, cs, gates, c0, dh_in, dhn, dcn))
    u_n, cols = backward_partition(n, hid)
    lanes = np.arange(QUAD_LANES)
    odd, high = (lanes & 1) != 0, (lanes & 2) != 0
    # the CTA's columns (gate q, unit ul) as global gate columns, and each
    # lane's weights [CTA][quad g][output o][lane][i] = W_hh[4 g + o, column]
    gcol = np.array([[(c // u_n) * hid + r * u_n + c % u_n for c in range(4 * u_n)] for r in range(n)])
    w = np.stack([w_hh[:, gcol[r][cols]].reshape(hid // 4, 4, QUAD_LANES, -1) for r in range(n)])
    # what a step needs beside the running cotangents, formed per chunk
    cprev = np.concatenate([c0[:, None], cs[:, :-1]], axis=1)
    gi, gf, gg, go = (gates[..., k * hid:(k + 1) * hid] for k in range(4))
    tc = _tanh_fast(cs)
    one = np.float32(1)
    a_o = (go * (one - tc * tc)).astype(np.float32)
    coef = [gg * (one - gi) * gi, cprev * (one - gf) * gf, gi * (one - gg) * (one + gg), tc * (one - go) * go]
    coef = [c_.astype(np.float32) for c_ in coef]

    def xor(a, m):
        return a[..., lanes ^ m]

    dgates = np.empty_like(gates)
    dh_run, dc_run = dhn.astype(np.float32), dcn.astype(np.float32)
    for t in range(t_len - 1, -1, -1):
        dh = (dh_run + dh_in[:, t]).astype(np.float32)
        dc = _fma(dh, a_o[:, t], dc_run)
        dg = np.concatenate([(dh if q == 3 else dc) * coef[q][:, t] for q in range(4)], axis=1)
        dgates[:, t] = dg
        dc_run = (dc * gf[:, t]).astype(np.float32)
        parts = []
        for r in range(n):  # CTA r's partials of every unit
            dv = dg[:, gcol[r][cols]]  # (B, lane, i)
            p = np.zeros((4, dg.shape[0], hid // 4, QUAD_LANES), np.float32)  # [o][B][g][lane]
            for i in range(cols.shape[1]):
                for o in range(4):
                    p[o] = _fma(w[r][:, o, :, i][None], dv[:, None, :, i], p[o])
            k0 = np.where(odd, p[1], p[0]) + xor(np.where(odd, p[0], p[1]), 1)
            k1 = np.where(odd, p[3], p[2]) + xor(np.where(odd, p[2], p[3]), 1)
            a = np.where(high, k1, k0) + xor(np.where(high, k0, k1), 2)
            a = a + xor(a, 4)
            parts.append(a[..., :4].reshape(dg.shape[0], hid))  # lane l < 4 sends unit 4 g + l
        dh_run = parts[0]
        for r in range(1, n):  # the owner adds them in rank order
            dh_run = (dh_run + parts[r]).astype(np.float32)
    return dgates[:bsz], dh_run[:bsz], dc_run[:bsz]


@functools.lru_cache(maxsize=None)
def _weights_once():
    return _weights(1, 1, seed=7)[0]


@functools.lru_cache(maxsize=None)
def _backward_case(b, t):
    """K4's saved tensors (plain version) for Flax-initialised H 160
    weights, cotangents of y, hn and cn, the head's dh_in and the plain K5
    (with its dgates)."""
    params = _weights_once()  # Flax's init traces the model at each shape: once
    rng = np.random.default_rng(b + 1000 * t)
    x = (0.3 * rng.standard_normal((b, 1, t))).astype(np.float32)
    latent = rng.uniform(0, 1, (b, 1, t)).astype(np.float32)
    h0 = (0.2 * rng.standard_normal((b, H))).astype(np.float32)
    c0 = (0.5 * rng.standard_normal((b, H))).astype(np.float32)
    dy = rng.standard_normal((b, 1, t)).astype(np.float32)
    dhn = rng.standard_normal((b, H)).astype(np.float32)
    dcn = rng.standard_normal((b, H)).astype(np.float32)
    args = [torch.from_numpy(np.array(a)) for a in _kernel_args(params, x, latent, h0, c0)]
    seq, _, h0_t, c0_t, w_ih, w_hh, _, fc_k, _ = args
    y, _, _, hs, cs, gates = lk.lstm_forward_plain(*args, save_states=True)
    dz = torch.from_numpy(dy) * (1.0 - y * y)
    dh_in = torch.einsum("ho,bot->bth", fc_k, dz)
    bargs = (seq, hs, cs, gates, h0_t, c0_t, w_ih, w_hh, dh_in, torch.from_numpy(dhn), torch.from_numpy(dcn))
    plain = lk.lstm_backward_plain(*bargs, with_dgates=True)
    return (params, x, latent, h0, c0, dy, dhn, dcn), bargs, dz, [v.numpy() for v in plain]


@functools.lru_cache(maxsize=None)
def _backward_jax(b, t):
    """JAX's gradients through `_lstm_bwd_kernel` (interpret mode) for
    `_backward_case(b, t)`: dW_ih, dW_hh, db, dh0, dc0, dlatent, dx."""
    (params, x, latent, h0, c0, dy, dhn, dcn), *_ = _backward_case(b, t)

    def f(p, x_, lat_, h_, c_):
        y, (hn, cn) = lstm_effect_model_pallas_train(p, x_, lat_, (h_, c_), interpret=True)
        return y, hn, cn

    _, vjp = jax.vjp(f, params, x, latent, h0, c0)
    gp, gx, glat, gh0, gc0 = vjp((jnp.asarray(dy), jnp.asarray(dhn), jnp.asarray(dcn)))
    gp = gp["params"]
    return [np.asarray(v) for v in (gp["w_ih"], gp["w_hh"], gp["b_gates"], gh0, gc0, glat, gx)]


def _model_walk(shape, bargs):
    seq, hs, cs, gates, h0, c0, w_ih, w_hh, dh_in, dhn, dcn = bargs
    return cluster_backward_model(*shape, *(a.numpy() for a in (hs, cs, gates, c0, w_hh, dh_in, dhn, dcn)))


SHAPE_IDS = dict(ids=lambda s: f"{s[0]}x{s[1]}")


@pytest.mark.parametrize("shape", lk.CLUSTER_SHAPES, **SHAPE_IDS)
@pytest.mark.parametrize("t", [1, 31, 33, 70])
@pytest.mark.parametrize("b", [1, 2, 3])
def test_backward_model_matches_plain(b, t, shape):
    """dgates, dh0 and dc0 of the cluster walk against the plain K5 within
    1e-5.  T 31 / 33 / 70 cross the 16- and 32-step chunks of the two
    shapes; B 1 and 3 leave a row past the batch at 4 CTAs x 2 rows."""
    _, bargs, _, plain = _backward_case(b, t)
    dgates, dh0, dc0 = _model_walk(shape, bargs)
    for name, got, want in (("dgates", dgates, plain[6]), ("dh0", dh0, plain[1]), ("dc0", dc0, plain[2])):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= ATOL, f"{name} against the plain version"


# JAX's interpret mode compiles each shape anew (2-3 s): a T of each kind
# across the batches
JAX_BACKWARD_CASES = [(1, 1), (3, 31), (2, 33), (3, 70)]


@pytest.mark.parametrize("shape", lk.CLUSTER_SHAPES, **SHAPE_IDS)
@pytest.mark.parametrize("b,t", JAX_BACKWARD_CASES)
def test_backward_model_matches_jax(b, t, shape):
    """dW_ih, dW_hh, db, dh0, dc0 and the latent's and audio's gradients,
    formed from the cluster walk's dgates as the card's reduction and dseq
    form them, against JAX's VJP within 5e-4 of each leaf's largest
    magnitude."""
    _, bargs, dz, _ = _backward_case(b, t)
    seq, hs, _, _, h0, _, w_ih, *_ = bargs
    dgates, dh0, dc0 = _model_walk(shape, bargs)
    dg = torch.from_numpy(dgates)
    hprev = torch.cat([h0[:, None], hs[:, :-1]], dim=1)
    dseq = torch.einsum("btj,ij->bit", dg, w_ih)
    ours = (torch.einsum("bit,btj->ij", seq, dg), torch.einsum("bth,btj->hj", hprev, dg), dg.sum(dim=(0, 1)),
            torch.from_numpy(dh0), torch.from_numpy(dc0), dseq[:, :1], dseq[:, 1:] + dz)
    names = ("dW_ih", "dW_hh", "db", "dh0", "dc0", "dlatent", "dx")
    for name, got, ref in zip(names, ours, _backward_jax(b, t)):
        assert tuple(got.shape) == ref.shape, name
        assert np.abs(got.numpy() - ref).max() <= GRAD_REL * np.abs(ref).max(), f"{name} against JAX"


@pytest.mark.parametrize("n", SIZES)
def test_backward_partition_holds_every_weight_once(n):
    """Each (unit k, gate column) of W_hh lies in one lane of one CTA: the
    8 lanes of an output quad split the CTA's 4 H / n columns, 4 x 4 H /
    (8 n) weights a lane (80 at n 4, 40 at n 8), and a load of dgates
    reads neighbouring vectors across the lanes."""
    u_n, cols = backward_partition(n)
    assert sorted(cols.ravel().tolist()) == list(range(4 * u_n))
    assert 4 * cols.shape[1] == 4 * 4 * H // (QUAD_LANES * n)
    assert (H // 4) * QUAD_LANES == 2 * H  # the CTA's 320 threads
    vec = 4 if cols.shape[1] % 4 == 0 else 2
    assert sorted(cols[:, :vec].ravel().tolist()) == list(range(QUAD_LANES * vec))


def test_backward_model_refuses_a_shape_the_kernels_lack():
    """A cluster the library has no kernel for (6 CTAs; 4 CTAs for one row)
    is refused, as the C entry refuses it on the card."""
    bargs = _backward_case(1, 1)[1]
    for shape in ((6, 1), (4, 1), (8, 2)):
        with pytest.raises(ValueError):
            _model_walk(shape, bargs)


@pytest.mark.parametrize(
    "batch,hid,plan",
    [
        (2, 160, ("cluster", 8, 1)),   # serving's batch (K5 takes none there, the plan is defined)
        (3, 160, ("cluster", 8, 1)),   # the TBPTT card-vs-CPU batch
        (32, 160, ("cluster", 4, 2)),  # the TBPTT batch: 16 clusters of 4 in one wave
        (31, 160, ("cluster", 4, 2)),  # one row past the batch
        (32, 64, ("registers", 1, 1)),
        (3, 16, ("registers", 1, 1)),
        (5, 48, ("generic", 1, 1)),
        (32, 256, ("generic", 1, 1)),
    ],
)
def test_backward_plan(batch, hid, plan):
    assert lk.backward_plan(batch, hid, H100_SMS) == plan
