"""Training recurrentgemma in the port against the JAX package on the same
numpy inputs: the RG-LRU scan's backward (its plain version, and a float64
emulation of the CUDA backward's reverse pass) against ``jax.vjp`` of the
reference's associative scan; the dispatch's autograd Function; the
reduced recurrentgemma-9b (one (rec, rec, attn_local) group, d 64, lru 64,
window 16, float32): its loss, every gradient leaf and one train step
against the reference's, and a falling loss.

On the CPU the scan's forward and backward run their plain versions inside
the same autograd Function that runs the CUDA kernels on the card."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.models.rglru import rglru_scan as jax_rglru_scan
from repro.train.step import make_train_step as jax_make_train_step
from repro.utils.tree import split_params
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.kernels import rglru as lru
from repro_torch.models import build_model
from repro_torch.models.model_api import _stacks_for
from repro_torch.train import optim
from repro_torch.train.step import make_train_step
from repro_torch.utils.tree import flatten, unflatten

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

# the scan's gradients against jax.vjp: 1e-4 of the reference's largest
# magnitude plus 1e-6 (float32 sums of the reverse recurrence in another
# order: the associative scan's tree against a scan or a loop)
RGLRU_GRAD_RTOL, RGLRU_GRAD_ATOL = 1e-4, 1e-6
B, S = 2, 32  # S: twice the reduced window, so the local attention's window binds
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
GRAD_NAMES = ("dlog_a", "dm", "dh0")
#: tokens in a tile of the CUDA backward's ring (csrc/rglru.cu's BWD_TT)
BWD_TT = 32

# (B, S, W): the reference test's shapes, S = 300 (ragged against the
# tiles, W not a multiple of the 32-channel slab) and S = 1
SCAN_SHAPES = [(1, 64, 32), (2, 128, 64), (2, 192, 128), (2, 300, 96), (2, 1, 64)]
SCAN_IDS = ["1x64x32", "2x128x64", "2x192x128", "ragged_S300", "S1"]


def _scan_inputs(Bq, Sq, W, seed, extreme=False):
    """log_a, m, h0, dh_seq and dh_final from numpy, log_a as in
    tests/test_kernels.py; ``extreme`` sets every third channel's log_a to
    -30 (decay to 0 in one step) and the next one's to 0 (no decay)."""
    rng = np.random.default_rng(seed)
    log_a = -np.exp(0.5 * rng.standard_normal((Bq, Sq, W))).astype(np.float32)
    if extreme:
        log_a[..., 0::3] = -30.0
        log_a[..., 1::3] = 0.0
    m, dh = (rng.standard_normal((Bq, Sq, W)).astype(np.float32) for _ in range(2))
    h0, dh_final = (rng.standard_normal((Bq, W)).astype(np.float32) for _ in range(2))
    return log_a, m, h0, dh, dh_final


@jax.jit
def _jax_vjp(log_a, m, h0, dh, dh_final):
    """jax.vjp of the reference's scan, returning (h, h[:, -1])."""
    def scan(la, mm, hh):
        h = jax_rglru_scan(la, mm, hh)
        return h, h[:, -1]

    _, vjp = jax.vjp(scan, log_a, m, h0)
    return vjp((dh, dh_final))


def _jax_grads(*inputs):
    return [np.asarray(g) for g in _jax_vjp(*(jnp.asarray(a) for a in inputs))]


def _bwd_args(log_a, m, h0, dh, dh_final):
    """rglru_bwd's arguments: log_a, the forward's h_seq, h0, dh_seq, dh_final."""
    t = [torch.from_numpy(a) for a in (log_a, m, h0, dh, dh_final)]
    h_seq, _ = lru.rglru_ref(t[0], t[1], t[2])
    return t[0], h_seq, t[2], t[3], t[4]


def _assert_grads(got, want, what):
    for name, g, w in zip(GRAD_NAMES, got, want):
        g = np.asarray(g, dtype=np.float64)
        assert g.shape == w.shape, (what, name)
        limit = RGLRU_GRAD_RTOL * float(np.max(np.abs(w))) + RGLRU_GRAD_ATOL
        err = float(np.max(np.abs(g - w)))
        assert err <= limit, (what, name, err, limit)


@pytest.mark.parametrize("zero_dh_final", [False, True], ids=["dh_final", "no_dh_final"])
@pytest.mark.parametrize("Bq,Sq,W", SCAN_SHAPES, ids=SCAN_IDS)
def test_rglru_bwd_ref_matches_jax_vjp(Bq, Sq, W, zero_dh_final):
    inputs = list(_scan_inputs(Bq, Sq, W, seed=Sq + W))
    if zero_dh_final:
        inputs[4] = np.zeros_like(inputs[4])
    got = lru.rglru_bwd_ref(*_bwd_args(*inputs))
    assert [t.dtype for t in got] == [torch.float32] * 3
    _assert_grads([t.numpy() for t in got], _jax_grads(*inputs), "rglru_bwd_ref")


def _kernel_reverse_pass_f64(log_a, h_seq, h0, dh, dh_final):
    """The CUDA backward's algorithm (csrc/rglru.cu, rglru_bwd_kernel) in
    float64: tiles of BWD_TT tokens from the last to the first, each with
    the rows of h_{t-1} (h_seq one token earlier; h0 in the first tile's
    row 0), and per token, in reverse order, g_t = dh_t + c, c = a_t g_t,
    dm_t = g_t, dlog_a_t = c h_{t-1}; dh0 = c at the end."""
    log_a, h_seq, h0, dh, c = (np.asarray(a, dtype=np.float64)
                               for a in (log_a, h_seq, h0, dh, dh_final))
    Sq = log_a.shape[1]
    dlog_a, dm = np.empty_like(log_a), np.empty_like(log_a)
    n_tiles = -(-Sq // BWD_TT)
    for i in range(n_tiles):
        t0 = (n_tiles - 1 - i) * BWD_TT
        n = min(BWD_TT, Sq - t0)
        h_tile = [h0 if t == 0 else h_seq[:, t - 1] for t in range(t0, t0 + n)]
        for r in reversed(range(n)):
            t = t0 + r
            g = dh[:, t] + c
            c = np.exp(log_a[:, t]) * g
            dm[:, t] = g
            dlog_a[:, t] = c * h_tile[r]
    return dlog_a, dm, c


@pytest.mark.parametrize("Bq,Sq,W,extreme", [(*s, False) for s in SCAN_SHAPES]
                         + [(2, 256, 160, True)], ids=SCAN_IDS + ["log_a_-30_and_0"])
def test_kernel_reverse_pass_emulated_matches_jax_vjp(Bq, Sq, W, extreme):
    inputs = _scan_inputs(Bq, Sq, W, seed=7 * Sq + W, extreme=extreme)
    got = _kernel_reverse_pass_f64(*(t.numpy() for t in _bwd_args(*inputs)))
    _assert_grads(got, _jax_grads(*inputs), "reverse pass, float64")


def test_ops_rglru_under_grad_runs_the_autograd_function():
    """On the CPU ``ops.rglru`` under autograd runs ``_RGLRU``: the plain
    forward, and a backward that is ``rglru_bwd_ref`` bit for bit, with a
    zero dh_final when the final h is dropped; it is close to autograd
    through the plain forward; no kernel launches."""
    log_a, m, h0, dh, _ = _scan_inputs(2, 300, 96, seed=3)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (log_a, m, h0)]
    dh = torch.from_numpy(dh)
    ops.reset_launch_counts()
    h_seq, h_final = ops.rglru(*leaves)
    assert h_seq.grad_fn is not None and h_final.grad_fn is not None
    want_seq, _ = lru.rglru_ref(*(t.detach() for t in leaves))
    assert torch.equal(h_seq.detach(), want_seq)
    got = torch.autograd.grad(h_seq, leaves, dh)
    ref = lru.rglru_bwd_ref(leaves[0].detach(), want_seq, leaves[2].detach(), dh,
                            torch.zeros_like(leaves[2]))
    for name, g, w in zip(GRAD_NAMES, got, ref):
        assert torch.equal(g, w), name
    auto = torch.autograd.grad(lru.rglru_ref(*leaves)[0], leaves, dh)
    for name, g, w in zip(GRAD_NAMES, got, auto):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=name)
    assert all(n == 0 for n in ops.launch_counts().values())


def test_ops_rglru_under_grad_on_the_kernel_path_reaches_the_cuda_wrapper(monkeypatch):
    """On the kernel path (forced here on CPU tensors) ``ops.rglru`` no
    longer refuses a gradient: it reaches the CUDA forward, which takes
    CUDA tensors only; the CUDA backward refuses CPU tensors as well."""
    monkeypatch.setattr(ops, "_use_kernel", lambda t: True)
    x = torch.zeros((1, 4, 32), requires_grad=True)
    h0 = torch.zeros((1, 32))
    with pytest.raises(ValueError, match="CUDA"):
        ops.rglru(x, x, h0)
    with pytest.raises(ValueError, match="CUDA"):
        lru.rglru_bwd(x.detach(), x.detach(), h0, x.detach(), h0)


# ---------------------------------------------------------------------------
# the reduced recurrentgemma-9b
# ---------------------------------------------------------------------------

#: constant-initialised leaves get noise so that every term of the
#: recurrence's gradient matters (as tests/test_torch_recurrent.py does)
_NOISY = {"conv_w", "conv_b", "ba", "bi", "lam"}


def _perturb(tree, rng):
    return {k: _perturb(v, rng) if isinstance(v, dict)
            else (v + 0.3 * rng.standard_normal(v.shape).astype(np.float32) if k in _NOISY else v)
            for k, v in tree.items()}


def _cfgs(**change):
    jcfg = dataclasses.replace(jax_get_arch("recurrentgemma-9b").reduced(), **change)
    tcfg = dataclasses.replace(get_arch("recurrentgemma-9b").reduced(), **change)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jmodel = jax_build_model(jcfg)
    values, _ = split_params(jmodel.init(jax.random.key(0)))
    values_np = _perturb(jax.tree.map(np.asarray, values), np.random.default_rng(1))
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab, (B, S), dtype=np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda v: jmodel.loss(v, {"tokens": jnp.asarray(tokens)})))(
            jax.tree.map(jnp.asarray, values_np))
    return dict(tcfg=tcfg, values_np=values_np, tokens=tokens, jloss=float(jloss),
                jgrads=jax.tree.map(np.asarray, jgrads))


def _ref_layout(tree, cfg):
    """The port's per-layer tree -> {reference path: stacked numpy}."""
    return {path: np.stack([t.detach().numpy() for t in ts]) if stacked
            else ts[0].detach().numpy()
            for path, ts, stacked in optim.leaf_groups(tree, _stacks_for(cfg))}


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_recurrentgemma_loss_and_grads_match_jax(setup, remat):
    tcfg = dataclasses.replace(setup["tcfg"], remat=remat)
    model = build_model(tcfg)
    assert model.kinds == ["rec", "rec", "attn_local"]
    params = convert.from_jax_values(setup["values_np"], tcfg, param_dtype=torch.float32)
    leaves, treedef = flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    ops.reset_launch_counts()
    loss = model.loss(unflatten(treedef, live), {"tokens": setup["tokens"]})
    grads = unflatten(treedef, list(torch.autograd.grad(loss, live)))
    assert all(n == 0 for n in ops.launch_counts().values())  # the CPU launches no kernel
    loss = float(loss.detach())
    assert abs(loss - setup["jloss"]) <= LOSS_TOL, (loss, setup["jloss"])
    got = _ref_layout(grads, tcfg)
    want = dict(optim._paths(setup["jgrads"]))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        limit = GRAD_RTOL * float(np.max(np.abs(w))) + GRAD_ATOL
        assert float(np.max(np.abs(g - w))) <= limit, (path, float(np.max(np.abs(g - w))), limit)


def test_recurrentgemma_sgdm_train_step_matches_jax(setup):
    """One train step on both sides from the same state: the reference's
    state converted by ``convert.train_state_from_jax``."""
    jcfg, tcfg = _cfgs(optimizer="sgdm")
    jts, jinit, *_ = jax_make_train_step(jax_build_model(jcfg), lr=1e-2)
    jstate = jinit(jax.random.key(0))
    tstate = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg)
    jnew, jm = jax.jit(jts)(jstate, {"tokens": jnp.asarray(setup["tokens"])})
    ts, _ = make_train_step(build_model(tcfg), lr=1e-2)
    tnew, tm = ts(tstate, {"tokens": setup["tokens"]})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL
    assert int(tnew["step"]) == int(jnew["step"]) == 1
    # params move by lr x (the gradient): the gradient's tolerance times lr
    jmom = jax.tree.map(np.asarray, jnew["opt"])
    got = _ref_layout(tnew["params"], tcfg)
    for path, w in optim._paths(jax.tree.map(np.asarray, jnew["params"])):
        m = jmom
        for key in path:
            m = m[key]
        limit = 1e-2 * (GRAD_RTOL * float(np.max(np.abs(np.asarray(m["m"])))) + GRAD_ATOL) + 1e-7
        assert float(np.max(np.abs(got[path] - w))) <= limit, path


def test_recurrentgemma_loss_falls_on_a_repeated_batch(setup):
    model = build_model(setup["tcfg"])
    ts, init_state = make_train_step(model, lr=3e-3)
    state = init_state(torch.Generator().manual_seed(0))
    losses = []
    for _ in range(4):
        state, m = ts(state, {"tokens": setup["tokens"]})
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert int(state["step"]) == 4


def test_recurrentgemma_float32_masters_cast_at_use(setup):
    """Training keeps float32 masters and bf16 activations: every RG-LRU
    weight but the float32 gate leaves is cast at use, so the masters give
    the serving weights' logits bit for bit, and the loss's gradients reach
    every leaf in the masters' dtype."""
    _, tcfg = _cfgs(dtype="bfloat16")
    model = build_model(tcfg)
    serve = convert.from_jax_values(setup["values_np"], tcfg)
    master = convert.from_jax_values(setup["values_np"], tcfg, param_dtype=torch.float32)
    assert serve["layers"][0]["rec"]["wx"].dtype == torch.bfloat16
    assert master["layers"][0]["rec"]["wx"].dtype == torch.float32
    assert serve["layers"][0]["rec"]["wa"].dtype == torch.float32
    tokens = torch.from_numpy(setup["tokens"]).long()
    with torch.inference_mode():
        a, _ = model.prefill(serve, tokens)
        b, _ = model.prefill(master, tokens)
    assert torch.equal(a, b)
    leaves, treedef = flatten(master)
    live = [p.detach().requires_grad_() for p in leaves]
    loss = model.loss(unflatten(treedef, live), {"tokens": setup["tokens"]})
    grads = torch.autograd.grad(loss, live)
    assert np.isfinite(float(loss.detach()))
    for p, g in zip(live, grads):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
