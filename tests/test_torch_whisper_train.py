"""whisper-tiny's training (``ModelDef.loss`` with ``cfg.encoder_layers``)
against the JAX package on the same inputs: the plain backward of
``flash_attention`` with a key length of its own against ``jax.vjp`` of the
reference's ``_sdpa`` (which its cross-attention runs), ``ops.flash_attention``
under autograd against ``jax.grad``, the loss and every gradient leaf
against ``jax.value_and_grad`` of the reference's ``loss``, and one
``make_train_step`` step against the reference's train step.

The sizes are ``tests/test_torch_whisper.py``'s: the reference's
``reduced()`` and whisper's real widths with 1 encoder and 2 decoder
layers, every bias made nonzero before conversion. Float32 throughout;
inputs from numpy seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build_model
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models.model_api import _stacks_for
from repro_torch.train import optim
from repro_torch.train.step import make_train_step
from repro_torch.utils.tree import flatten, unflatten
from test_torch_flash_bwd import jax_cross_vjp
from test_torch_whisper import (B, KEY_LENGTHS, PIECE_TOL, S, SIZES, _cfgs, _inputs,
                                _nonzero_biases, _rng, _values)

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

# tests/test_torch_train.py's limits: the loss, and each gradient leaf within
# 1e-4 of the reference leaf's largest magnitude plus 1e-6
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
LR = 1e-3


# ---------------------------------------------------------------------------
# the backward of a cross-attention
# ---------------------------------------------------------------------------


def _cross_inputs(Sk: int, g: int, seed: int):
    """q (B, H, Sq, hd), k / v (B, K, Sk, hd) and dout (B, H, Sq, hd),
    float32 numpy: the ragged key lengths' shapes of chip_smoke.py."""
    rng = _rng(seed)
    Bq, Sq, K, hd = 2, 40, 2, 32
    H = K * g
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((Bq, H, Sq, hd), (Bq, K, Sk, hd), (Bq, K, Sk, hd), (Bq, H, Sq, hd))]


@pytest.mark.parametrize("Sk", KEY_LENGTHS)
@pytest.mark.parametrize("g", [1, 2])
def test_flash_attention_bwd_plain_key_length_matches_jax_vjp(Sk, g):
    """``flash_attention_bwd_ref`` with k / v of Sk keys (not causal), from
    the plain forward's output and lse, against ``jax.vjp`` of the
    reference's ``_sdpa``: dq (40 rows), dk and dv (Sk rows, summed over
    each group) within 1e-5."""
    q, k, v, dout = _cross_inputs(Sk, g, seed=Sk + g)
    _, want = jax_cross_vjp(q, k, v, dout)
    qt, kt, vt, gt = (torch.from_numpy(a) for a in (q, k, v, dout))
    o, lse = fa.flash_attention_ref(qt, kt, vt, causal=False, return_lse=True)
    got = fa.flash_attention_bwd_ref(qt, kt, vt, o, gt, lse, causal=False)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert tuple(a.shape) == w.shape, name
        np.testing.assert_allclose(a.numpy(), w, atol=PIECE_TOL, rtol=PIECE_TOL, err_msg=name)


@pytest.mark.parametrize("Sk", KEY_LENGTHS)
def test_ops_flash_attention_autograd_key_length_matches_jax_grad(Sk):
    """``ops.flash_attention`` under autograd with Sk != S (the autograd
    Function, its plain versions on the CPU) against ``jax.grad`` of the
    reference's ``_sdpa`` on the same loss, sum(out * dout): the output
    and the three gradients within 1e-5; no kernel launches on the CPU."""
    q, k, v, dout = _cross_inputs(Sk, 2, seed=100 + Sk)
    want_out, want = jax_cross_vjp(q, k, v, dout)
    ops.reset_launch_counts()
    live = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ops.flash_attention(*live, causal=False)
    grads = torch.autograd.grad((out * torch.from_numpy(dout)).sum(), live)
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=PIECE_TOL, rtol=PIECE_TOL)
    for name, a, w in zip(("dq", "dk", "dv"), grads, want):
        np.testing.assert_allclose(a.numpy(), w, atol=PIECE_TOL, rtol=PIECE_TOL, err_msg=name)
    assert not any(ops.launch_counts().values())


# ---------------------------------------------------------------------------
# the loss, its gradients and a train step
# ---------------------------------------------------------------------------


def _grads(cfg, values, batch):
    """(the port's loss, {reference path: its gradient, stacked})."""
    params = convert.from_jax_values(values, cfg, param_dtype=torch.float32)
    leaves, treedef = flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss = build_model(cfg).loss(unflatten(treedef, live), batch)
    grads = unflatten(treedef, list(torch.autograd.grad(loss, live)))
    return float(loss.detach()), _ref_layout(grads, cfg)


def _ref_layout(tree, cfg):
    """The port's per-layer tree -> {reference path: stacked numpy}."""
    return {path: np.stack([t.detach().numpy() for t in ts]) if stacked
            else ts[0].detach().numpy()
            for path, ts, stacked in optim.leaf_groups(tree, _stacks_for(cfg))}


@pytest.mark.parametrize("size", SIZES)
def test_loss_and_grads_match_jax(size):
    """``loss`` over the tokens and the frames and every gradient leaf (the
    encoder's, ``enc_pos``, ``pos_embed`` and both attentions' among them)
    against the reference's ``jax.value_and_grad``: the loss within 1e-5,
    each leaf within 1e-4 of the reference leaf's largest magnitude plus
    1e-6."""
    jcfg, cfg = _cfgs(size)
    values = _values(size)
    tokens, frames = _inputs(cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda v: jax_build_model(jcfg).loss(v, {"tokens": jnp.asarray(tokens),
                                                 "frames": jnp.asarray(frames)})))(
        jax.tree.map(jnp.asarray, values))
    ops.reset_launch_counts()
    loss, got = _grads(cfg, values, {"tokens": tokens, "frames": torch.from_numpy(frames)})
    assert not any(ops.launch_counts().values())  # the CPU launches no kernel
    assert abs(loss - float(jloss)) <= LOSS_TOL, (loss, float(jloss))
    want = dict(optim._paths(jax.tree.map(np.asarray, jgrads)))
    assert set(got) == set(want)
    assert ("encoder", "b0", "attn", "wq") in got and ("enc_pos",) in got
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        limit = GRAD_RTOL * float(np.max(np.abs(w))) + GRAD_ATOL
        assert float(np.max(np.abs(got[path] - w))) <= limit, path


def test_adamw_train_step_matches_jax():
    """One ``make_train_step`` AdamW step at reduced size, from the
    reference's initial state (every bias made nonzero) converted by
    ``convert.train_state_from_jax``, frames in the batch: the loss, both
    moments and the updated parameters, each within the gradients'
    tolerance carried through the step (as
    ``tests/test_torch_dense_archs.py`` holds the dense configs)."""
    jcfg, cfg = _cfgs("reduced")
    jts, jinit, *_ = jax_make_train_step(jax_build_model(jcfg), lr=LR)
    jstate = jax.tree.map(np.asarray, jinit(jax.random.key(0)))
    _nonzero_biases(jstate["params"], _rng(11))
    tokens, frames = _inputs(cfg)
    jnew, jm = jax.jit(jts)(jax.tree.map(jnp.asarray, jstate),
                            {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)})
    tstate = convert.train_state_from_jax(jstate, cfg)
    ts, _ = make_train_step(build_model(cfg), lr=LR)
    tnew, tm = ts(tstate, {"tokens": tokens, "frames": torch.from_numpy(frames)})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL
    assert int(tnew["step"]) == int(jnew["step"]) == 1
    moments = {path: t.numpy() for path, t in optim._paths(tnew["opt"])}
    want = dict(optim._paths(jax.tree.map(np.asarray, jnew["opt"])))
    assert set(moments) == set(want)
    params = _ref_layout(tnew["params"], cfg)
    want_params = dict(optim._paths(jax.tree.map(np.asarray, jnew["params"])))
    assert set(params) == set(want_params) and ("encoder", "b0", "ffn", "wi") in params
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
        limit = np.where(g > 10 * g_tol, 1e-4 * LR, 2 * LR) + 1e-6
        assert np.all(np.abs(params[path] - w) <= limit), path


def test_loss_depends_on_the_frames():
    """The memory reaches the loss: other frames give another loss (at
    init, with matrices of std 0.02, by ~5e-5 of ~6.24: twenty float32
    steps of the loss), and the encoder's leaves get a nonzero gradient."""
    _, cfg = _cfgs("reduced")
    values = _values("reduced")
    tokens, frames = _inputs(cfg)
    losses, grads = [], None
    for scale in (1.0, -2.0):
        loss, grads = _grads(cfg, values, {"tokens": tokens,
                                           "frames": torch.from_numpy(scale * frames)})
        losses.append(loss)
    assert abs(losses[0] - losses[1]) > 1e-5
    assert float(np.abs(grads[("encoder", "b0", "ffn", "wi")]).max()) > 0
    assert float(np.abs(grads[("enc_pos",)]).max()) > 0


def test_loss_without_frames_raises():
    """A batch without frames raises ValueError naming them, as the
    prefill does."""
    _, cfg = _cfgs("reduced")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu", param_dtype=torch.float32)
    with pytest.raises(ValueError, match="frames"):
        model.loss(params, {"tokens": np.zeros((B, S), np.int32)})
