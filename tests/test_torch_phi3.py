"""phi-3-vision-4.2b (``configs/phi3_vision.py``) against the JAX package on
the same inputs: the attention kernels' plain versions at its head dim of 96
(against the Pallas kernels in interpret mode and ``jax.vjp`` of the
reference's attention), and the whole model with image tokens: the
precomputed patch embeddings prepended to the token embeddings in the
prefill and in the loss, decode steps at positions after the prefilled
ones, the loss's gradients, ``serve.generate`` and the step inputs.

The model runs at two sizes: the reference's ``reduced()`` (4 image tokens,
head dim 16, GQA g 2) and a variant at phi-3-vision's head dim, 4 heads of
96 on 4 KV heads (MHA, as the real config), the same change on both sides.
Float32 throughout; inputs from numpy seeds."""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_arch as jax_get_arch
from repro.kernels.decode_attention import flash_decode as jax_flash_decode
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro.models import build_model as jax_build_model
from repro.utils.tree import split_params
from repro_torch import convert
from repro_torch.configs import SHAPES, get_arch
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.model_api import IMAGE_AXES, _stacks_for
from repro_torch.train import optim
from repro_torch.utils.tree import flatten, unflatten

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

ARCH = "phi-3-vision-4.2b"
HD = 96
# the kernels' plain versions: tests/test_kernels.py's limits
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DECODE_TOL = 3e-5
# the model: the earlier serving slices' float32 limit (tests/test_torch_model.py),
# and tests/test_torch_train.py's for the loss and each gradient leaf (1e-4
# of the reference leaf's largest magnitude plus 1e-6)
LOGITS_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
B, S, STEPS = 2, 16, 4
# phi-3-vision's head dim on the reduced widths: 4 heads of 96, MHA
HD96 = dict(n_heads=4, n_kv_heads=4, head_dim=HD)
SIZES = ("reduced", "hd96")


def _rng(seed: int):
    return np.random.default_rng(seed)


def _pair(a: np.ndarray, dtype: str):
    return (jnp.asarray(a).astype(jnp.dtype(dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


# ---------------------------------------------------------------------------
# the kernels' plain versions at head dim 96
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 48], ids=["causal", "window48"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_hd96_matches_pallas(window, dtype):
    """``flash_attention_ref`` at hd 96 (MHA, as phi-3-vision, and g 2)
    against the Pallas kernel in interpret mode."""
    rng = _rng(96 + window)
    for H, K in ((4, 4), (4, 2)):
        q = rng.standard_normal((2, H, 128, HD)).astype(np.float32)
        k, v = (rng.standard_normal((2, K, 128, HD)).astype(np.float32) for _ in range(2))
        (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
        want = jax_flash_attention(qj, kj, vj, window=window, block_q=32, block_k=32,
                                   interpret=True)
        got = ops.flash_attention(qt, kt, vt, window=window)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   atol=TOL[dtype], rtol=TOL[dtype], err_msg=f"H {H} K {K}")


@pytest.mark.parametrize("window", [0, 40], ids=["causal", "window40"])
def test_flash_attention_bwd_plain_hd96_matches_jax_vjp(window):
    """The float32 backward's plain version at hd 96, given the plain
    forward's output and lse, against ``jax.vjp`` of the reference's
    attention: dq, dk and dv within float32's 2e-5 (S 100, ragged against
    every tile)."""
    rng = _rng(196 + window)
    q = rng.standard_normal((2, 4, 100, HD)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, 100, HD)).astype(np.float32) for _ in range(2))
    dout = rng.standard_normal(q.shape).astype(np.float32)
    # the reference side in float32 whatever x64 state earlier tests in this
    # worker left behind: jax_enable_x64 changes its bits
    with jax.enable_x64(False):
        _, vjp = jax.vjp(lambda a, b, c: jax_attention_ref(a, b, c, causal=True, window=window),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = [np.asarray(w) for w in vjp(jnp.asarray(dout))]
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = fa.flash_attention_ref(qt, kt, vt, window=window, return_lse=True)
    got = fa.flash_attention_bwd_ref(qt, kt, vt, o, torch.from_numpy(dout), lse, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL["float32"],
                                   rtol=TOL["float32"], err_msg=name)


def test_flash_attention_autograd_hd96_matches_jax_grad():
    """Through ``ops.flash_attention``'s autograd Function on the CPU (the
    plain forward and backward) against ``jax.grad`` of the reference's
    attention, float32 and bf16 inputs."""
    rng = _rng(296)
    arrays = [rng.standard_normal((1, 4, 64, HD)).astype(np.float32) for _ in range(3)]
    w = rng.standard_normal((1, 4, 64, HD)).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        jq, jk, jv = (jnp.asarray(a).astype(jnp.dtype(dtype)).astype(jnp.float32)
                      for a in arrays)
        want = jax.grad(lambda a, b, c: jnp.sum(jax_attention_ref(a, b, c) * w),
                        argnums=(0, 1, 2))(jq, jk, jv)
        ts = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_() for a in arrays]
        out = ops.flash_attention(*ts)
        (out.float() * torch.from_numpy(w)).sum().backward()
        for name, t, g in zip(("dq", "dk", "dv"), ts, want):
            np.testing.assert_allclose(t.grad.float().numpy(), np.asarray(g), atol=TOL[dtype],
                                       rtol=TOL[dtype], err_msg=f"{dtype} {name}")


@pytest.mark.parametrize("window", [0, 32])
def test_flash_decode_plain_hd96_matches_pallas(window):
    """``flash_decode_ref`` at hd 96 (MHA) against the Pallas kernel over a
    cache of 800 slots with 772 written (phi-3-vision's serve cache)."""
    Bd, H, W, pos = 2, 4, 800, 771
    rng = _rng(396 + window)
    q = rng.standard_normal((Bd, H, HD)).astype(np.float32)
    k, v = (rng.standard_normal((Bd, H, W, HD)).astype(np.float32) for _ in range(2))
    kpos = np.where(np.arange(W) <= pos, np.arange(W), -1).astype(np.int32)
    kpos = np.broadcast_to(kpos, (Bd, W)).copy()
    want = jax_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kpos),
                            jnp.int32(pos), window=window, block_k=160, interpret=True)
    got = ops.flash_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(kpos), pos, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=DECODE_TOL, rtol=DECODE_TOL)


def test_head_dim_96_is_a_kernel_head_dim():
    """Both wrappers take hd 96 (the CUDA kernels have the instantiation);
    the plain versions run it on the CPU."""
    assert HD in fa.HEAD_DIMS and HD in da.HEAD_DIMS
    cfg = get_arch(ARCH)
    assert cfg.resolved_head_dim == HD and cfg.n_kv_heads == cfg.n_heads == 32


# ---------------------------------------------------------------------------
# the model with image tokens
# ---------------------------------------------------------------------------


def _cfgs(size: str):
    change = HD96 if size == "hd96" else {}
    return (dataclasses.replace(jax_get_arch(ARCH).reduced(), **change),
            dataclasses.replace(get_arch(ARCH).reduced(), **change))


@functools.lru_cache(maxsize=None)
def _values(size: str):
    jcfg, _ = _cfgs(size)
    values, _ = split_params(jax_build_model(jcfg).init(jax.random.key(0)))
    return jax.tree.map(np.asarray, values)


def _inputs(cfg, seed: int = 7):
    rng = _rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    images = rng.standard_normal((B, cfg.num_img_tokens, cfg.d_model)).astype(np.float32)
    return tokens, images


def _run_both(size: str):
    """Prefill (tokens after image tokens) then STEPS decode steps at
    positions S_tot, S_tot + 1, ... on both sides, both fed the reference's
    greedy token: [(reference logits, port logits)], the two caches."""
    jcfg, cfg = _cfgs(size)
    values = _values(size)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    params = convert.from_jax_values(values, cfg)
    jv = jax.tree.map(jnp.asarray, values)
    tokens, images = _inputs(cfg)
    S_tot = S + cfg.num_img_tokens
    jl, jc = jax.jit(lambda p, t, i: jmodel.prefill(p, {"tokens": t, "image_embeds": i},
                                                     cache_len=S_tot + STEPS))(
        jv, jnp.asarray(tokens), jnp.asarray(images))
    jdecode = jax.jit(jmodel.decode)
    with torch.inference_mode():
        tl, tc = model.prefill(params, torch.from_numpy(tokens).long(), cache_len=S_tot + STEPS,
                               image_embeds=torch.from_numpy(images))
        pairs = [(np.asarray(jl), tl.numpy())]
        for i in range(STEPS):
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
            jl, jc = jdecode(jv, jnp.asarray(tok), jnp.int32(S_tot + i), jc)
            tl, tc = model.decode(params, torch.from_numpy(tok).long(), S_tot + i, tc)
            pairs.append((np.asarray(jl), tl.numpy()))
    return cfg, pairs, jax.tree.map(np.asarray, jc), tc


@pytest.mark.parametrize("size", SIZES)
def test_prefill_and_decode_with_image_embeds_match_jax(size):
    """Prefill logits over S + num_img_tokens positions and 4 decode steps'
    within 1e-4 of the reference's, the same greedy tokens; each layer's
    cache (k, v, kpos over S_tot + STEPS slots) within 1e-5."""
    ops.reset_launch_counts()
    cfg, pairs, jc, tc = _run_both(size)
    for step, (want, got) in enumerate(pairs):
        assert got.shape == want.shape == (B, cfg.vocab)
        np.testing.assert_allclose(got, want, atol=LOGITS_TOL, rtol=LOGITS_TOL,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1), err_msg=f"step {step}")
    S_tot = S + cfg.num_img_tokens
    for i, layer in enumerate(tc):
        assert layer["k"].shape[1] == S_tot + STEPS
        for name in ("k", "v", "kpos"):
            np.testing.assert_allclose(layer[name].numpy(), jc["stack0"][0]["attn"][name][i],
                                       atol=1e-5, rtol=1e-5, err_msg=f"{i} {name}")
    assert not any(ops.launch_counts().values())  # the CPU launches no kernel


def _grads(cfg, values, batch):
    params = convert.from_jax_values(values, cfg, param_dtype=torch.float32)
    leaves, treedef = flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss = build_model(cfg).loss(unflatten(treedef, live), batch)
    grads = unflatten(treedef, list(torch.autograd.grad(loss, live)))
    return float(loss.detach()), {
        path: np.stack([t.numpy() for t in ts]) if stacked else ts[0].numpy()
        for path, ts, stacked in optim.leaf_groups(grads, _stacks_for(cfg))}


@pytest.mark.parametrize("images", [True, False], ids=["image_embeds", "text_only"])
@pytest.mark.parametrize("size", SIZES)
def test_loss_and_grads_match_jax(size, images):
    """``loss`` (the cross-entropy over the text positions after the image
    tokens) and every gradient leaf against the reference's ``jax.grad``,
    with and without ``image_embeds`` in the batch (without: the text-only
    model, P_img = 0, on both sides)."""
    jcfg, cfg = _cfgs(size)
    values = _values(size)
    tokens, imgs = _inputs(cfg, seed=3)
    jbatch = {"tokens": jnp.asarray(tokens)}
    batch = {"tokens": tokens}
    if images:
        jbatch["image_embeds"] = jnp.asarray(imgs)
        batch["image_embeds"] = torch.from_numpy(imgs)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda v: jax_build_model(jcfg).loss(v, jbatch)))(jax.tree.map(jnp.asarray, values))
    loss, got = _grads(cfg, values, batch)
    assert abs(loss - float(jloss)) <= LOSS_TOL, (loss, float(jloss))
    want = dict(optim._paths(jax.tree.map(np.asarray, jgrads)))
    assert set(got) == set(want)
    for path, w in want.items():
        limit = GRAD_RTOL * float(np.max(np.abs(w))) + GRAD_ATOL
        assert float(np.max(np.abs(got[path] - w))) <= limit, path


def test_loss_depends_on_the_image_embeds():
    """The image tokens reach the text positions: other embeddings give
    another loss, on both sides alike."""
    jcfg, cfg = _cfgs("reduced")
    values = _values("reduced")
    tokens, imgs = _inputs(cfg, seed=3)
    losses = []
    for scale in (1.0, -2.0):
        batch = {"tokens": tokens, "image_embeds": torch.from_numpy(scale * imgs)}
        losses.append(_grads(cfg, values, batch)[0])
    assert abs(losses[0] - losses[1]) > 1e-4


def test_generate_matches_the_reference_at_positions_after_the_image_tokens():
    """``serve.generate`` with ``make_image_embeds`` gives the greedy tokens
    of the reference's ``ModelDef`` driven on the same weights, prompt and
    image embeddings, its cache S + num_img_tokens + N slots and its decode
    steps at S + num_img_tokens + i (the positions after the prefilled ones;
    ROADMAP.md Queue 3, item 15)."""
    jcfg, cfg = _cfgs("hd96")
    values = _values("hd96")
    model = build_model(cfg)
    params = convert.from_jax_values(values, cfg)
    tokens, _ = _inputs(cfg, seed=5)
    images = serve.make_image_embeds(model, B, "cpu", seed=2)
    N = 6
    gen = serve.generate(model, params, torch.from_numpy(tokens).long(), N,
                         image_embeds=images)
    P = S + cfg.num_img_tokens
    jmodel = jax_build_model(jcfg)
    jv = jax.tree.map(jnp.asarray, values)
    lg, cache = jmodel.prefill(jv, {"tokens": jnp.asarray(tokens),
                                    "image_embeds": jnp.asarray(images.numpy())},
                               cache_len=P + N)
    want = [np.asarray(jnp.argmax(lg, -1))]
    for i in range(N - 1):
        lg, cache = jmodel.decode(jv, jnp.asarray(want[-1][:, None].astype(np.int32)),
                                  jnp.int32(P + i), cache)
        want.append(np.asarray(jnp.argmax(lg, -1)))
    np.testing.assert_array_equal(gen.tokens.numpy(), np.stack(want, axis=1))


def test_make_image_embeds_is_seeded():
    model = build_model(get_arch(ARCH).reduced())
    a, b = serve.make_image_embeds(model, 2, "cpu", 3), serve.make_image_embeds(model, 2, "cpu", 3)
    assert a.shape == (2, 4, 64) and a.dtype == torch.float32 and torch.equal(a, b)
    assert serve.make_image_embeds(build_model(get_arch("gemma-2b").reduced()), 2, "cpu") is None


def test_trees_inputs_and_axes_are_the_references():
    """At full width: the port's parameter leaves, grouped as the reference
    stacks them, have the reference's paths (the untied ``lm_head`` among
    them), shapes and logical axes; ``convert`` carries every leaf; the
    prefill's and train step's inputs are the reference's (the tokens
    S - 256, ``image_embeds`` (B, 256, 3072) bf16 on ("batch", "img",
    None))."""
    jmodel, model = jax_build_model(jax_get_arch(ARCH)), build_model(get_arch(ARCH))
    jvalues, jaxes = split_params(jmodel.abstract_init())
    want = {"/".join(p): (tuple(v.shape), tuple(a))
            for (p, v), (_, a) in zip(optim._paths(jvalues), optim._paths(jaxes))}
    stacks = _stacks_for(model.cfg)
    axes = {"/".join(p): g[0] for p, g, _ in optim.leaf_groups(model.param_axes(), stacks)}
    got = {"/".join(p): (((len(ts),) if stacked else ()) + tuple(ts[0].shape),
                         (("layers",) if stacked else ()) + axes["/".join(p)])
           for p, ts, stacked in optim.leaf_groups(model.abstract_init(), stacks)}
    assert got == want
    assert "lm_head" in got and got["lm_head"][0] == (3072, 32064)
    for shape in ("prefill_32k", "train_4k"):
        values, in_axes = model.input_specs(SHAPES[shape])
        jin, jin_axes = split_params(jmodel.input_specs(JAX_SHAPES[shape]))
        assert set(values) == set(jin) == {"tokens", "image_embeds"}
        for name in values:
            assert tuple(values[name].shape) == tuple(jin[name].shape), name
        assert values["image_embeds"].dtype == torch.bfloat16
        assert in_axes == {k: tuple(v) for k, v in jin_axes.items()}
        assert in_axes["image_embeds"] == IMAGE_AXES
    values, _ = model.input_specs(SHAPES["decode_32k"])
    assert set(values) == {"tokens", "pos"}


def test_convert_carries_every_leaf():
    """``from_jax_values`` of the reduced model's reference values: every
    leaf lands, the untied head too, and the port's tree flattens back to
    the reference's values exactly."""
    _, cfg = _cfgs("reduced")
    values = _values("reduced")
    params = convert.from_jax_values(values, cfg, param_dtype=torch.float32)
    got = {"/".join(p): (np.stack([t.numpy() for t in ts]) if stacked else ts[0].numpy())
           for p, ts, stacked in optim.leaf_groups(params, _stacks_for(cfg))}
    want = {"/".join(p): v for p, v in optim._paths(values)}
    assert set(got) == set(want) and "lm_head" in got
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg=path)


def test_serve_json_on_cpu(capsys):
    """``python -m repro_torch.launch.serve --arch phi-3-vision-4.2b`` on the
    CPU: the reduced model, seeded image embeddings, the reference's
    status line."""
    rc = serve.main(["--arch", ARCH, "--device", "cpu", "--json", "--batch", "2",
                     "--prompt-len", "12", "--new-tokens", "5"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and last["status"] == "ok" and last["arch"] == ARCH
    assert last["tokens_per_s"] > 0
