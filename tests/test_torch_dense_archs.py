"""The dense swiglu configs deepseek-7b (MHA, head dim 128), granite-3-2b
(GQA g 4, head dim 64, tied, vocab 49155) and qwen2.5-3b (GQA g 8, head dim
128, tied, qkv bias) against the JAX package on the same weights: prefill and
decode logits in float32 and bf16, and the loss and every gradient leaf.

Each runs at two sizes: the reference's ``reduced()`` (head dim 16, vocab
512, at most 2 KV heads) and a narrow variant, the same change on both
sides, that keeps what ``reduced()`` hides: 2 layers and d_model 64, but
the real head dim, a real group ratio and the real vocab. qwen's biases
get nonzero random values before conversion (the reference initialises
them to zeros, which would hide a missing or misplaced add)."""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.train.step import make_train_step as jax_make_train_step
from repro.utils.tree import split_params
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.models import build_model
from repro_torch.models.model_api import _stacks_for
from repro_torch.train import optim
from repro_torch.train.step import make_train_step
from repro_torch.utils.tree import flatten, unflatten

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

ARCHS = ("deepseek-7b", "granite-3-2b", "qwen2.5-3b")
# the narrow variant: reduced(), then the real head dim, a real group ratio
# (deepseek MHA, granite g 4, qwen g 8) and the real vocab
NARROW = {
    "deepseek-7b": dict(n_heads=4, n_kv_heads=4, head_dim=128, vocab=102400),
    "granite-3-2b": dict(n_heads=8, n_kv_heads=2, head_dim=64, vocab=49155),
    "qwen2.5-3b": dict(n_heads=8, n_kv_heads=1, head_dim=128, vocab=151936),
}
SIZES = ("reduced", "narrow")
BIAS_KEYS = ("bq", "bk", "bv")

B, S, STEPS = 2, 16, 3
LOGITS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # tests/test_torch_model.py
# tests/test_torch_train.py's limits: the loss, and each gradient leaf within
# 1e-4 of the reference leaf's largest magnitude plus 1e-6
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _cfgs(arch: str, size: str, **change):
    """(reference config, port config): reduced, or narrow, with ``change``."""
    if size == "narrow":
        change = {**NARROW[arch], **change}
    jcfg = dataclasses.replace(jax_get_arch(arch).reduced(), **change)
    tcfg = dataclasses.replace(get_arch(arch).reduced(), **change)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _values(arch: str, size: str):
    """The reference's initial values (numpy), qkv biases made nonzero."""
    jcfg, _ = _cfgs(arch, size)
    values, _ = split_params(jax_build_model(jcfg).init(jax.random.key(0)))
    values = jax.tree.map(np.asarray, values)
    if jcfg.qkv_bias:
        rng = np.random.default_rng(11)
        attn = values["stack0"]["b0"]["attn"]
        for key in BIAS_KEYS:
            attn[key] = 0.5 * rng.standard_normal(attn[key].shape).astype(np.float32)
    return values


def _tokens(vocab: int, seed: int = 7):
    return np.random.default_rng(seed).integers(0, vocab, (B, S), dtype=np.int32)


def _run_both(arch: str, size: str, dtype: str):
    """Prefill then STEPS decode steps on both sides, both fed the reference's
    greedy token: [(reference logits, port logits)] as float32 numpy."""
    jcfg, tcfg = _cfgs(arch, size, dtype=dtype)
    values = _values(arch, size)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    params = convert.from_jax_values(values, tcfg)
    jvalues = jax.tree.map(jnp.asarray, values)
    prompt = _tokens(tcfg.vocab)
    cache_len = S + STEPS
    jl, jc = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, cache_len=cache_len))(
        jvalues, jnp.asarray(prompt))
    jdecode = jax.jit(lambda p, t, pos, c: jmodel.decode(p, t, pos, c))
    with torch.inference_mode():
        tl, tc = tmodel.prefill(params, torch.from_numpy(prompt).long(), cache_len=cache_len)
        pairs = [(np.asarray(jl.astype(jnp.float32)), tl.float().numpy())]
        for i in range(STEPS):
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
            jl, jc = jdecode(jvalues, jnp.asarray(tok), jnp.int32(S + i), jc)
            tl, tc = tmodel.decode(params, torch.from_numpy(tok).long(), S + i, tc)
            pairs.append((np.asarray(jl.astype(jnp.float32)), tl.float().numpy()))
    return tcfg, pairs


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_f32_match_jax(arch, size):
    ops.reset_launch_counts()
    tcfg, pairs = _run_both(arch, size, "float32")
    for step, (want, got) in enumerate(pairs):
        assert got.shape == want.shape == (B, tcfg.vocab)
        np.testing.assert_allclose(got, want, atol=LOGITS_TOL["float32"],
                                   rtol=LOGITS_TOL["float32"], err_msg=f"step {step}")
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1), err_msg=f"step {step}")
    assert not any(ops.launch_counts().values())  # the CPU launches no kernel


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_bf16_match_jax(arch, size):
    _, pairs = _run_both(arch, size, "bfloat16")
    for step, (want, got) in enumerate(pairs):
        np.testing.assert_allclose(got, want, atol=LOGITS_TOL["bfloat16"],
                                   rtol=LOGITS_TOL["bfloat16"], err_msg=f"step {step}")


def _ref_layout(tree, cfg):
    """The port's per-layer tree -> {reference path: stacked numpy}."""
    return {path: np.stack([t.detach().numpy() for t in ts]) if stacked
            else ts[0].detach().numpy()
            for path, ts, stacked in optim.leaf_groups(tree, _stacks_for(cfg))}


def _assert_grads_close(got, want_tree):
    want = dict(optim._paths(want_tree))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        limit = GRAD_RTOL * float(np.max(np.abs(w))) + GRAD_ATOL
        assert float(np.max(np.abs(g - w))) <= limit, (path, float(np.max(np.abs(g - w))), limit)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, size):
    """The port's ``ModelDef.loss`` and autograd against the reference's
    ``jax.grad``, float32, leaf by leaf (the qkv biases among them)."""
    jcfg, tcfg = _cfgs(arch, size)
    values = _values(arch, size)
    tokens = _tokens(tcfg.vocab, seed=3)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda v: jax_build_model(jcfg).loss(v, {"tokens": jnp.asarray(tokens)})))(
            jax.tree.map(jnp.asarray, values))
    params = convert.from_jax_values(values, tcfg, param_dtype=torch.float32)
    leaves, treedef = flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss = build_model(tcfg).loss(unflatten(treedef, live), {"tokens": tokens})
    grads = unflatten(treedef, list(torch.autograd.grad(loss, live)))
    loss = float(loss.detach())
    assert abs(loss - float(jloss)) <= LOSS_TOL, (loss, float(jloss))
    got = _ref_layout(grads, tcfg)
    if tcfg.qkv_bias:
        assert all(("stack0", "b0", "attn", key) in got for key in BIAS_KEYS)
    _assert_grads_close(got, jax.tree.map(np.asarray, jgrads))


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_train_step_matches_jax(arch):
    """One AdamW train step from the reference's state converted by
    ``convert.train_state_from_jax`` (qkv biases float32, in the params and
    the moments): the loss, both moments and the updated parameters, each
    within the gradients' tolerance carried through the step."""
    jcfg, tcfg = _cfgs(arch, "reduced")
    lr = 1e-3
    jts, jinit, *_ = jax_make_train_step(jax_build_model(jcfg), lr=lr)
    jstate = jinit(jax.random.key(0))
    tstate = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg)
    if tcfg.qkv_bias:
        attn = tstate["params"]["layers"][0]["attn"]
        assert all(attn[key].dtype == torch.float32 for key in BIAS_KEYS)
        assert all(key in tstate["opt"]["stack0"]["b0"]["attn"] for key in BIAS_KEYS)
    tokens = _tokens(tcfg.vocab, seed=5)
    jnew, jm = jax.jit(jts)(jstate, {"tokens": jnp.asarray(tokens)})
    ts, _ = make_train_step(build_model(tcfg), lr=lr)
    tnew, tm = ts(tstate, {"tokens": tokens})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL
    assert int(tnew["step"]) == int(jnew["step"]) == 1
    moments = {path: t.numpy() for path, t in optim._paths(tnew["opt"])}
    want = dict(optim._paths(jax.tree.map(np.asarray, jnew["opt"])))
    assert set(moments) == set(want)
    params = _ref_layout(tnew["params"], tcfg)
    want_params = dict(optim._paths(jax.tree.map(np.asarray, jnew["params"])))
    assert set(params) == set(want_params)
    if tcfg.qkv_bias:
        assert all(("stack0", "b0", "attn", key) in params for key in BIAS_KEYS)
    for path, w in want_params.items():
        m, v = want[path + ("m",)], want[path + ("v",)]
        g = np.abs(m) / 0.1  # |the reference's gradient|: m = 0.1 g, v = 0.05 g^2
        g_tol = GRAD_RTOL * float(np.max(g)) + GRAD_ATOL
        assert float(np.max(np.abs(moments[path + ("m",)] - m))) <= 0.1 * g_tol, path
        v_tol = 0.05 * g_tol * (2 * float(np.max(g)) + g_tol)
        assert float(np.max(np.abs(moments[path + ("v",)] - v))) <= v_tol, path
        # the first step moves a parameter by lr (g / (|g| + eps) + wd p):
        # lr sign(g) where |g| clears the gradients' tolerance tenfold, and
        # anything within 2 lr where a gradient that near zero may flip sign
        limit = np.where(g > 10 * g_tol, 1e-4 * lr, 2 * lr) + 1e-6
        assert np.all(np.abs(params[path] - w) <= limit), path


def test_convert_carries_the_qkv_bias():
    """Serving stores the biases in the activation dtype (the reference casts
    them at use), training in float32; a fresh port model has them at zero."""
    jcfg, tcfg = _cfgs("qwen2.5-3b", "reduced", dtype="bfloat16")
    values = _values("qwen2.5-3b", "reduced")
    serve_p = convert.from_jax_values(values, tcfg)
    master = convert.from_jax_values(values, tcfg, param_dtype=torch.float32)
    H, K, hd = tcfg.n_heads, tcfg.n_kv_heads, tcfg.resolved_head_dim
    for i, (lp, mp) in enumerate(zip(serve_p["layers"], master["layers"])):
        for key, heads in zip(BIAS_KEYS, (H, K, K)):
            want = values["stack0"]["b0"]["attn"][key][i]
            assert lp["attn"][key].shape == mp["attn"][key].shape == (heads, hd)
            assert lp["attn"][key].dtype == torch.bfloat16
            assert mp["attn"][key].dtype == torch.float32
            assert np.array_equal(mp["attn"][key].numpy(), want)
    fresh = build_model(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    assert all(not lp["attn"][key].any() for lp in fresh["layers"] for key in BIAS_KEYS)
    no_bias = build_model(get_arch("granite-3-2b").reduced()).init(torch.Generator(), "cpu")
    assert not any(key in no_bias["layers"][0]["attn"] for key in BIAS_KEYS)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_and_train_on_cpu(arch, capsys):
    """``launch.serve`` and ``launch.train`` take the three through the same
    entry points as the other families (reduced, ``--device cpu``)."""
    rc = serve.main(["--arch", arch, "--device", "cpu", "--json", "--batch", "2",
                     "--prompt-len", "12", "--new-tokens", "4"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["status"] == "ok" and res["arch"] == arch
    res = train.run(["--arch", arch, "--device", "cpu", "--steps", "4", "--batch", "2",
                     "--seq", "16", "--policy", "none", "--repeat-batch", "--lr", "3e-3",
                     "--json"])
    assert res["status"] == "ok" and res["steps"] == 4
    assert res["losses"][-1] < res["losses"][0]
