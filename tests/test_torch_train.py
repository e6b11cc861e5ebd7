"""The port's training path against the JAX package on the same numpy inputs
(reduced gemma-2b: 2 layers, d 64, head dim 16, float32, MQA with 4 query
heads): the loss, every gradient leaf, the backward kernels' plain
versions, each optimizer's update on identical gradients, one train step
end to end; and the refusals of the kernels that have no backward yet.

On the CPU the port's attention and norms run their plain forward and
backward versions inside the same autograd Functions that run the CUDA
kernels on the card."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro.models import build_model as jax_build_model
from repro.models.layers import norm_apply as jax_norm_apply
from repro.train import optim as jax_optim
from repro.train.step import make_train_step as jax_make_train_step
from repro.utils.tree import split_params
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import token_batches
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import build_model, model_api
from repro_torch.models.model_api import _stacks_for
from repro_torch.train import optim
from repro_torch.train.step import make_decode_step, make_prefill_step, make_train_step
from repro_torch.utils.tree import flatten, unflatten

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

B, S = 2, 32
LOSS_TOL = 1e-5
# gradient leaves: 1e-4 of the reference leaf's largest magnitude, plus 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# the backward plain versions against autograd / jax.grad, float32
BWD_TOL = 2e-5
# optimizer updates on identical gradients: float32 elementwise arithmetic
# in the same order on both sides, up to one rounding of a fused operation
OPT_TOL = 1e-6


def _cfgs(**change):
    jcfg = dataclasses.replace(jax_get_arch("gemma-2b").reduced(), **change)
    tcfg = dataclasses.replace(get_arch("gemma-2b").reduced(), **change)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jmodel = jax_build_model(jcfg)
    values, _ = split_params(jmodel.init(jax.random.key(0)))
    values_np = jax.tree.map(np.asarray, values)
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab, (B, S), dtype=np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda v: jmodel.loss(v, {"tokens": jnp.asarray(tokens)})))(values)
    return dict(tcfg=tcfg, values_np=values_np, tokens=tokens, jloss=float(jloss),
                jgrads=jax.tree.map(np.asarray, jgrads))


def _port_params(setup, cfg=None):
    return convert.from_jax_values(setup["values_np"], cfg or setup["tcfg"],
                                   param_dtype=torch.float32)


def _port_grads(model, params, tokens):
    leaves, treedef = flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss = model.loss(unflatten(treedef, live), {"tokens": tokens})
    grads = torch.autograd.grad(loss, live)
    return float(loss.detach()), unflatten(treedef, list(grads))


def _ref_layout(tree, cfg):
    """The port's per-layer tree -> {reference path: stacked numpy}."""
    return {path: np.stack([t.detach().numpy() for t in ts]) if stacked
            else ts[0].detach().numpy()
            for path, ts, stacked in optim.leaf_groups(tree, _stacks_for(cfg))}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("ce_chunk", [512, 8], ids=["one_chunk", "four_chunks"])
def test_loss_and_grads_match_jax(setup, remat, ce_chunk, monkeypatch):
    monkeypatch.setattr(model_api, "CE_CHUNK", ce_chunk)
    tcfg = dataclasses.replace(setup["tcfg"], remat=remat)
    model = build_model(tcfg)
    params = _port_params(setup, tcfg)
    ops.reset_launch_counts()
    loss, grads = _port_grads(model, params, setup["tokens"])
    assert all(n == 0 for n in ops.launch_counts().values())  # the CPU launches no kernel
    assert abs(loss - setup["jloss"]) <= LOSS_TOL, (loss, setup["jloss"])
    got = _ref_layout(grads, tcfg)
    want = dict(optim._paths(setup["jgrads"]))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        limit = GRAD_RTOL * float(np.max(np.abs(w))) + GRAD_ATOL
        assert float(np.max(np.abs(g - w))) <= limit, (path, float(np.max(np.abs(g - w))), limit)


def test_loss_falls_on_a_repeated_batch(setup):
    model = build_model(setup["tcfg"])
    ts, init_state = make_train_step(model, lr=3e-3)
    state = init_state(torch.Generator().manual_seed(0))
    losses = []
    for _ in range(4):
        state, m = ts(state, {"tokens": setup["tokens"]})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
    assert int(state["step"]) == 4


# ---------------------------------------------------------------------------
# the backward kernels' plain versions
# ---------------------------------------------------------------------------

ATTN_CASES = [  # B, H, K, S, hd, causal, window
    (2, 4, 4, 40, 16, True, 0),    # g 1
    (2, 4, 2, 40, 16, True, 0),    # g 2
    (1, 8, 2, 33, 32, True, 0),    # g 4, ragged
    (2, 4, 1, 48, 16, True, 12),   # window, MQA
    (1, 4, 2, 24, 16, False, 0),   # not causal
]


@pytest.mark.parametrize("B_,H,K,S_,hd,causal,window", ATTN_CASES)
def test_flash_attention_bwd_ref_matches_autograd_and_jax(B_, H, K, S_, hd, causal, window):
    rng = np.random.default_rng(S_ + 7 * H + K)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((B_, H, S_, hd), (B_, K, S_, hd), (B_, K, S_, hd)))
    dout = rng.standard_normal((B_, H, S_, hd)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = fa.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    want_t = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(dout))
    _, vjp = jax.vjp(lambda a, b, c: jax_attention_ref(a, b, c, causal=causal, window=window),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_j = vjp(jnp.asarray(dout))
    o2, lse = fa.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                                     window=window, return_lse=True)
    got = fa.flash_attention_bwd_ref(*(torch.from_numpy(a) for a in (q, k, v)), o2,
                                     torch.from_numpy(dout), lse, causal=causal, window=window)
    for name, g, wt, wj in zip(("dq", "dk", "dv"), got, want_t, want_j):
        assert g.shape == wt.shape, name
        np.testing.assert_allclose(g.numpy(), wt.numpy(), atol=BWD_TOL, rtol=BWD_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(wj), atol=BWD_TOL, rtol=BWD_TOL,
                                   err_msg=name)
    # the dispatch's autograd Function runs the same plain versions on the CPU
    got_ops = torch.autograd.grad(ops.flash_attention(tq, tk, tv, causal=causal, window=window),
                                  (tq, tk, tv), torch.from_numpy(dout))
    for g, w in zip(got_ops, got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape", [(4, 64), (2, 8, 128), (3, 100)])
def test_rmsnorm_bwd_ref_matches_autograd_and_jax(shape):
    rng = np.random.default_rng(sum(shape))
    x, dy = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    tx, ts = torch.from_numpy(x).requires_grad_(), torch.from_numpy(scale).requires_grad_()
    want_t = torch.autograd.grad(rn.rmsnorm_ref(tx, ts), (tx, ts), torch.from_numpy(dy))
    _, vjp = jax.vjp(lambda a, s: jax_norm_apply({"scale": s}, a), jnp.asarray(x),
                     jnp.asarray(scale))
    want_j = vjp(jnp.asarray(dy))
    got = rn.rmsnorm_bwd_ref(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(dy))
    for g, wt, wj in zip(got, want_t, want_j):
        np.testing.assert_allclose(g.numpy(), wt.numpy(), atol=BWD_TOL, rtol=BWD_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(wj), atol=BWD_TOL, rtol=BWD_TOL)
    got_ops = torch.autograd.grad(ops.rmsnorm(tx, ts), (tx, ts), torch.from_numpy(dy))
    for g, w in zip(got_ops, got):
        assert torch.equal(g, w)


def test_rmsnorm_bwd_blocks_cover_every_row():
    for rows in (1, 7, 511, 512, 513, 2048, 100003):
        for d in (64, 2048, 4096):
            blocks, per, slots = rn.bwd_plan(rows, d)
            assert blocks <= rn.BWD_MAX_BLOCKS and per % slots == 0
            assert blocks * per >= rows > (blocks - 1) * per


# ---------------------------------------------------------------------------
# optimizers on identical gradients
# ---------------------------------------------------------------------------


def _random_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)


def _assert_tree_close(got_ref_layout, want_tree, tol, what):
    want = dict(optim._paths(want_tree))
    assert set(got_ref_layout) == set(want), what
    for path, w in want.items():
        np.testing.assert_allclose(got_ref_layout[path], np.asarray(w), atol=tol, rtol=tol,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("kind", ["adamw", "adafactor", "sgdm"])
def test_optimizer_update_matches_jax(setup, kind):
    tcfg = setup["tcfg"]
    stacks = _stacks_for(tcfg)
    jinit, jupdate = jax_optim.make_optimizer(kind, lr=1e-3)
    tinit, tupdate = optim.make_optimizer(kind, stacks, lr=1e-3)
    jparams = jax.tree.map(jnp.asarray, setup["values_np"])
    jstate = jinit(jparams)
    tparams = _port_params(setup)
    tstate = tinit(tparams)
    for step in range(2):  # the second step reads the state the first wrote
        grads = _random_like(setup["values_np"], 10 + step)
        jparams, jstate = jupdate(jparams, jax.tree.map(jnp.asarray, grads), jstate,
                                  jnp.int32(step))
        tgrads = convert.from_jax_values(grads, tcfg, param_dtype=torch.float32)
        tparams, tstate = tupdate(tparams, tgrads, tstate, torch.tensor(step, dtype=torch.int32))
    _assert_tree_close(_ref_layout(tparams, tcfg), jparams, OPT_TOL, f"{kind} params")
    got_state = {p: t.numpy() for p, t in optim._paths(tstate)}
    _assert_tree_close(got_state, jstate, OPT_TOL, f"{kind} state")


def test_int8_compression_with_error_feedback_matches_jax(setup):
    tcfg = setup["tcfg"]
    stacks = _stacks_for(tcfg)
    jefb = jax_optim.init_error_fb(jax.tree.map(jnp.asarray, setup["values_np"]))
    tefb = optim.init_error_fb(_port_params(setup), stacks)
    for step in range(2):
        grads = _random_like(setup["values_np"], 20 + step)
        jq, jefb = jax_optim.compress_grads_int8(jax.tree.map(jnp.asarray, grads), jefb)
        tq, tefb = optim.compress_grads_int8(
            convert.from_jax_values(grads, tcfg, param_dtype=torch.float32), tefb, stacks)
        _assert_tree_close(_ref_layout(tq, tcfg), jq, OPT_TOL, "dequantised grads")
        got_efb = {p: t.numpy() for p, t in optim._paths(tefb)}
        _assert_tree_close(got_efb, jefb, OPT_TOL, "error feedback")


@pytest.mark.parametrize("compression", [False, True], ids=["plain", "int8"])
def test_sgdm_train_step_matches_jax(setup, compression):
    """One train step end to end on both sides from the same state: the
    reference's state converted by ``convert.train_state_from_jax``."""
    jcfg, tcfg = _cfgs(optimizer="sgdm")
    jts, jinit, *_ = jax_make_train_step(jax_build_model(jcfg), lr=1e-2,
                                         grad_compression=compression)
    jstate = jinit(jax.random.key(0))
    tstate = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg)
    batch = {"tokens": setup["tokens"]}
    jnew, jm = jax.jit(jts)(jstate, {"tokens": jnp.asarray(setup["tokens"])})
    ts, _ = make_train_step(build_model(tcfg), lr=1e-2, grad_compression=compression)
    tnew, tm = ts(tstate, batch)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL
    assert int(tnew["step"]) == int(jnew["step"]) == 1
    # params move by lr x (the gradient): the gradient's tolerance times lr.
    # int8 compression rounds each gradient to a step of max|g| / 127; a
    # gradient within its tolerance may round to the neighbouring step
    # where the two sides straddle a half step, so those leaves are held
    # to one step (x lr) instead.
    jgrads = jax.tree.map(np.asarray, jnew["opt"])
    got = _ref_layout(tnew["params"], tcfg)
    for path, w in optim._paths(jax.tree.map(np.asarray, jnew["params"])):
        m = np.asarray(_get(jgrads, path)["m"])
        step = float(np.max(np.abs(m))) / 127.0 if compression else 0.0
        limit = 1e-2 * (GRAD_RTOL * float(np.max(np.abs(m))) + GRAD_ATOL + step) + 1e-7
        assert float(np.max(np.abs(got[path] - w))) <= limit, path


# ---------------------------------------------------------------------------
# the path's other pieces, and what is refused
# ---------------------------------------------------------------------------


def test_prefill_and_decode_steps_run_the_model(setup):
    tcfg = setup["tcfg"]
    model = build_model(tcfg)
    params = convert.from_jax_values(setup["values_np"], tcfg)
    with torch.inference_mode():
        logits, caches = make_prefill_step(model)(params, {"tokens": setup["tokens"]},
                                                  cache_len=S + 1)
        want, _ = model.prefill(params, torch.from_numpy(setup["tokens"]).long(), cache_len=S + 1)
        assert torch.equal(logits, want)
        tok = torch.argmax(logits, -1)[:, None]
        nxt, _ = make_decode_step(model)(params, tok, S, caches)
    assert nxt.shape == (B, tcfg.vocab) and torch.isfinite(nxt).all()


def test_float32_masters_serve_like_activation_dtype_weights(setup):
    """``param_dtype`` moves only the storage: float32 masters cast at use
    give the serving weights' logits."""
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    model = build_model(tcfg)
    serve = convert.from_jax_values(setup["values_np"], tcfg)
    master = convert.from_jax_values(setup["values_np"], tcfg, param_dtype=torch.float32)
    assert serve["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert master["layers"][0]["attn"]["wq"].dtype == torch.float32
    tokens = torch.from_numpy(setup["tokens"]).long()
    with torch.inference_mode():
        a, _ = model.prefill(serve, tokens)
        b, _ = model.prefill(master, tokens)
    assert torch.equal(a, b)
    gen = torch.Generator().manual_seed(1)
    p32 = model.init(gen, "cpu", param_dtype=torch.float32)
    assert p32["embed"].dtype == torch.float32 and p32["final_ln"]["scale"].dtype == torch.float32
    assert model.init(torch.Generator().manual_seed(1), "cpu")["embed"].dtype == torch.bfloat16


def test_synthetic_batches_are_deterministic_in_seed_and_step():
    mk = token_batches(seed=5, batch=2, seq=8, vocab=100)
    a, b = mk(3)["tokens"], mk(3)["tokens"]
    assert a.dtype == np.int32 and a.shape == (2, 8) and np.array_equal(a, b)
    assert not np.array_equal(a, mk(4)["tokens"])
    assert not np.array_equal(a, token_batches(6, 2, 8, 100)(3)["tokens"])
    assert a.min() >= 0 and a.max() < 100


@pytest.mark.parametrize("name", ["flash_decode", "wkv6", "rglru"])
def test_kernels_without_backward_raise_under_grad(name, monkeypatch):
    """On the kernel path (forced here on CPU tensors) the three kernels
    that have no backward refuse inputs that need a gradient, instead of
    handing back an output with no grad_fn."""
    monkeypatch.setattr(ops, "_use_kernel", lambda t: True)
    x = torch.zeros((1, 2, 4, 16), requires_grad=True)
    calls = {"flash_decode": lambda: ops.flash_decode(x[:, :, 0], x[:, :1], x[:, :1],
                                                      torch.zeros((1, 4), dtype=torch.int32), 3),
             "wkv6": lambda: ops.wkv6(x, x, x, x, torch.zeros((2, 16)),
                                      torch.zeros((1, 2, 16, 16))),
             "rglru": lambda: ops.rglru(x[0], x[0], x[0, :, 0])}
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1, item 9"):
        calls[name]()


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b"])
def test_loss_refuses_blocks_without_backward_kernels(arch):
    model = build_model(get_arch(arch).reduced())
    params = model.init(torch.Generator().manual_seed(0), "cpu", param_dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1, item 9"):
        model.loss(params, {"tokens": np.zeros((1, 8), dtype=np.int32)})
