"""whisper-tiny (``configs/whisper_tiny.py``) against the JAX package on the
same inputs: the layer norm, the encoder's not-causal self-attention, the
cross-attention over the encoder's memory (prefill and decode), the plain
``flash_attention`` with a key length of its own against the reference's
``_sdpa``, and the whole model's prefill and decode. Its training (the loss,
its gradients, the cross-attention's backward) is held in
``tests/test_torch_whisper_train.py``.

The model runs at two sizes: the reference's ``reduced()`` (1 encoder layer,
16 frames, head dim 16) and a variant at whisper's real widths (d_model 384,
6 heads of 64, d_ff 1536, vocab 51865, 1500 frames) with 1 encoder and 2
decoder layers, the same change on both sides. Every bias (the q/k/v
biases of both attentions, the layer norms' and the MLP's) gets nonzero
random values before conversion: the reference initialises them to zeros,
which would hide a missing or misplaced add. Float32 throughout; inputs
from numpy seeds."""
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
from repro.models import layers as JL
from repro.utils.tree import split_params
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.kernels import fake, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.model_api import MEMORY_AXES, _stacks_for
from repro_torch.train import optim

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

ARCH = "whisper-tiny"
# the pieces: float32 sums in another order (tests/test_kernels.py's limit)
PIECE_TOL = 1e-5
# the model: the earlier serving slices' float32 limit (tests/test_torch_model.py)
LOGITS_TOL = 1e-4
B, S, STEPS = 2, 16, 4
# whisper's real widths, its depth cut to 1 encoder and 2 decoder layers
REAL = dict(n_layers=2, d_model=384, n_heads=6, n_kv_heads=6, head_dim=64, d_ff=1536,
            vocab=51865, encoder_layers=1, encoder_seq=1500)
SIZES = ("reduced", "real")


def _cfgs(size: str):
    change = REAL if size == "real" else {}
    return (dataclasses.replace(jax_get_arch(ARCH).reduced(), **change),
            dataclasses.replace(get_arch(ARCH).reduced(), **change))


def _rng(seed: int):
    return np.random.default_rng(seed)


def _nonzero_biases(tree, rng):
    """Every bias and layer-norm shift of a values tree, random (in place)."""
    for key, val in tree.items():
        if isinstance(val, dict):
            _nonzero_biases(val, rng)
        elif key in ("bq", "bk", "bv", "bi", "bo", "bias"):
            tree[key] = 0.5 * rng.standard_normal(val.shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _values(size: str):
    jcfg, _ = _cfgs(size)
    values, _ = split_params(jax_build_model(jcfg).init(jax.random.key(0)))
    values = jax.tree.map(np.asarray, values)
    _nonzero_biases(values, _rng(11))
    return values


def _inputs(cfg):
    rng = _rng(7)
    tokens = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    frames = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return tokens, frames


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    """``norm_apply(kind="layer")`` against the reference's on the same x,
    scale and bias: float32 within 1e-5; bf16 (the result rounded once)
    within one bf16 step."""
    rng = _rng(1)
    x = (3.0 * rng.standard_normal((5, 7, 384)) + 1.5).astype(np.float32)
    p = {"scale": rng.standard_normal(384).astype(np.float32),
         "bias": rng.standard_normal(384).astype(np.float32)}
    jdt = jnp.dtype(dtype)
    want = np.asarray(JL.norm_apply({k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(x).astype(jdt), "layer").astype(jnp.float32))
    got = L.norm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x).to(getattr(torch, dtype)), "layer").float().numpy()
    tol = PIECE_TOL if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    assert L.norm_init(384, "cpu", "layer")["bias"].dtype == torch.float32


def _attn_params(cfg, rng):
    d, H, n, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    shapes = {"wq": (d, H, hd), "wk": (d, n, hd), "wv": (d, n, hd), "wo": (H, hd, d),
              "bq": (H, hd), "bk": (n, hd), "bv": (n, hd)}
    return {k: (0.1 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("q_len", [S, 1], ids=["prefill", "decode"])
def test_cross_attention_matches_jax(size, q_len):
    """``cross_attention`` (plain flash_attention with the memory's key
    length in the prefill; plain flash_decode over the memory with every
    slot valid in a decode step) against the reference's
    ``attention_apply(..., memory=...)``, float32 within 1e-5."""
    jcfg, cfg = _cfgs(size)
    rng = _rng(2)
    p = _attn_params(cfg, rng)
    x = rng.standard_normal((B, q_len, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(q_len, dtype=np.int32), (B, q_len))
    want, _ = JL.attention_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg,
                                 positions=jnp.asarray(pos), causal=False,
                                 memory=jnp.asarray(mem), use_rope=False)
    ops.reset_launch_counts()
    got = L.cross_attention({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                            torch.from_numpy(mem), cfg, decode=q_len == 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PIECE_TOL, rtol=PIECE_TOL)
    assert not any(ops.launch_counts().values())  # the CPU launches no kernel


@pytest.mark.parametrize("size", SIZES)
def test_encoder_self_attention_matches_jax(size):
    """The encoder's attention (``attention_prefill(causal=False,
    rope=False)``) over its frames against the reference's
    ``attention_apply(causal=False, use_rope=False)``, float32 within 1e-5
    of the output's largest magnitude: at 1500 frames each output sums
    1500 keys' and 384 products' float32 roundings in another order (the
    reading at the real widths: 1.3e-5 absolute on outputs up to ~8)."""
    jcfg, cfg = _cfgs(size)
    rng = _rng(3)
    p = _attn_params(cfg, rng)
    Sf = cfg.encoder_seq
    x = rng.standard_normal((B, Sf, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Sf, dtype=np.int32), (B, Sf))
    want, _ = JL.attention_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg,
                                 positions=jnp.asarray(pos), causal=False, use_rope=False)
    got, _, _ = L.attention_prefill({k: torch.from_numpy(v) for k, v in p.items()},
                                    torch.from_numpy(x), cfg, torch.from_numpy(pos.copy()),
                                    causal=False, rope=False)
    want = np.asarray(want)
    assert float(np.abs(got.numpy() - want).max()) <= PIECE_TOL * float(np.abs(want).max())


# the key lengths of chip_smoke.py's ragged cases, each below and above the
# 40 queries: one key, a tile less one, a tile and one, and 1500
KEY_LENGTHS = (1, 63, 65, 1500)


@pytest.mark.parametrize("Sk", KEY_LENGTHS)
@pytest.mark.parametrize("g", [1, 2])
def test_flash_attention_plain_key_length_matches_jax_sdpa(Sk, g):
    """``flash_attention_ref`` with k / v of Sk keys (not causal) against the
    reference's ``_sdpa`` (all keys valid), which its cross-attention runs:
    float32 within 1e-5, and its lse against the log-sum-exp of the scaled
    scores."""
    rng = _rng(4)
    Bq, Sq, K, hd = 2, 40, 2, 32
    H = K * g
    q = rng.standard_normal((Bq, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((Bq, Sk, K, hd)).astype(np.float32)
    v = rng.standard_normal((Bq, Sk, K, hd)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (Bq, Sq))
    kpos = np.broadcast_to(np.arange(Sk, dtype=np.int32), (Bq, Sk))
    want = JL._sdpa(jnp.asarray(q.reshape(Bq, Sq, K, g, hd)), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(qpos), jnp.asarray(kpos), jnp.ones((Bq, Sk), bool), 0, False)
    want = np.asarray(want).reshape(Bq, Sq, H, hd)
    t = [torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)]
    got, lse = fa.flash_attention_ref(*t, causal=False, return_lse=True)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, atol=PIECE_TOL, rtol=PIECE_TOL)
    kk = np.repeat(k, g, axis=2)
    scores = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) / np.sqrt(hd)
    m = scores.max(-1)
    want_lse = m + np.log(np.exp(scores - m[..., None]).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=PIECE_TOL, rtol=PIECE_TOL)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False, window=8)],
                         ids=["causal", "window"])
def test_flash_attention_refuses_a_causal_or_windowed_key_length(kw):
    """A causal or windowed call with Sk != S raises (the reference never
    makes one), on the plain version as in the kernel's wrapper."""
    q, k = torch.zeros((1, 2, 16, 32)), torch.zeros((1, 2, 24, 32))
    with pytest.raises(ValueError, match="cross-attention"):
        fa.flash_attention_ref(q, k, k, **kw)
    with pytest.raises(ValueError, match="cross-attention"):
        ops.flash_attention(q, k, k, **kw)


@pytest.mark.parametrize("Sk", KEY_LENGTHS)
def test_fake_count_of_a_cross_call_is_sq_times_sk(Sk):
    """The dry run's count of a cross call: Sq·Sk (query, key) pairs, the
    FLOPs 4·hd a pair per (b, h)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.roofline.counter import StepCounter

    assert fake.visible_pairs(40, False, 0, Sk) == 40 * Sk
    with FakeTensorMode():
        q, k = torch.empty((2, 6, 40, 64)), torch.empty((2, 6, Sk, 64))
        with StepCounter() as c:
            out = ops.flash_attention(q, k, k, causal=False)
    assert out.shape == q.shape
    assert c.kernels["flash_attention"]["flops"] == 4 * 64 * 40 * Sk * 2 * 6


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _run_both(size: str):
    """Prefill then STEPS decode steps on both sides, both fed the
    reference's greedy token: [(reference logits, port logits)], and the
    two final caches."""
    jcfg, cfg = _cfgs(size)
    values = _values(size)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    params = convert.from_jax_values(values, cfg)
    jv = jax.tree.map(jnp.asarray, values)
    tokens, frames = _inputs(cfg)
    jl, jc = jax.jit(lambda p, t, f: jmodel.prefill(p, {"tokens": t, "frames": f},
                                                     cache_len=S + STEPS))(
        jv, jnp.asarray(tokens), jnp.asarray(frames))
    jdecode = jax.jit(jmodel.decode)
    with torch.inference_mode():
        tl, tc = model.prefill(params, torch.from_numpy(tokens).long(), cache_len=S + STEPS,
                               frames=torch.from_numpy(frames))
        pairs = [(np.asarray(jl), tl.numpy())]
        for i in range(STEPS):
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
            jl, jc = jdecode(jv, jnp.asarray(tok), jnp.int32(S + i), jc)
            tl, tc = model.decode(params, torch.from_numpy(tok).long(), S + i, tc)
            pairs.append((np.asarray(jl), tl.numpy()))
    return cfg, pairs, jax.tree.map(np.asarray, jc), tc


@pytest.mark.parametrize("size", SIZES)
def test_prefill_and_decode_f32_match_jax(size):
    """Prefill logits and 4 decode steps' within 1e-4 of the reference's,
    with the same greedy tokens; the caches' entries (the self-attention's
    k / v / kpos and the memory) within 1e-5."""
    ops.reset_launch_counts()
    cfg, pairs, jc, tc = _run_both(size)
    for step, (want, got) in enumerate(pairs):
        assert got.shape == want.shape == (B, cfg.vocab)
        np.testing.assert_allclose(got, want, atol=LOGITS_TOL, rtol=LOGITS_TOL,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1), err_msg=f"step {step}")
    assert len(tc) == cfg.n_layers + 1
    np.testing.assert_allclose(tc[-1]["memory"].numpy(), jc["memory"], atol=PIECE_TOL,
                               rtol=PIECE_TOL)
    for i, layer in enumerate(tc[:-1]):
        for name in ("k", "v", "kpos"):
            np.testing.assert_allclose(layer[name].numpy(), jc["stack0"][0]["attn"][name][i],
                                       atol=PIECE_TOL, rtol=PIECE_TOL, err_msg=f"{i} {name}")
    assert not any(ops.launch_counts().values())  # the CPU launches no kernel


def test_trees_and_axes_are_the_references():
    """The port's parameter leaves, grouped as the reference stacks them
    (``encoder/b0``, ``stack0/b0``), have the reference's paths, shapes and
    logical axes; the cache (its layers, then the memory) and the prefill's
    inputs (tokens and frames) have the reference's shapes, dtypes and
    axes."""
    jmodel, model = jax_build_model(jax_get_arch(ARCH)), build_model(get_arch(ARCH))
    jvalues, jaxes = split_params(jmodel.abstract_init())
    want = {"/".join(p): (tuple(v.shape), tuple(jaxes_leaf))
            for (p, v), (_, jaxes_leaf) in zip(optim._paths(jvalues), optim._paths(jaxes))}
    stacks = _stacks_for(model.cfg)
    shapes = optim.leaf_groups(model.abstract_init(), stacks)
    axes = {"/".join(p): g[0] for p, g, _ in optim.leaf_groups(model.param_axes(), stacks)}
    got = {"/".join(p): (((len(ts),) if stacked else ()) + tuple(ts[0].shape),
                         (("layers",) if stacked else ()) + axes["/".join(p)])
           for p, ts, stacked in shapes}
    assert got == want
    jcache, jcache_axes = split_params(jmodel.abstract_cache(3, 20))
    cache, cache_axes = model.abstract_cache(3, 20)
    assert cache[-1]["memory"].shape == jcache["memory"].shape == (3, 1500, 384)
    assert cache_axes[-1]["memory"] == jcache_axes["memory"] == MEMORY_AXES
    for i, layer in enumerate(cache[:-1]):
        for name, t in layer.items():
            jt = jcache["stack0"][0]["attn"][name]
            assert tuple(t.shape) == tuple(jt.shape[1:]), name
            assert str(t.dtype).split(".")[-1] == str(jt.dtype), name
            assert cache_axes[i][name] == tuple(jcache_axes["stack0"][0]["attn"][name][1:])
    from repro.configs import SHAPES as JAX_SHAPES
    from repro_torch.configs import SHAPES

    values, in_axes = model.input_specs(SHAPES["prefill_32k"])
    jin, jin_axes = split_params(jmodel.input_specs(JAX_SHAPES["prefill_32k"]))
    assert set(values) == set(jin) == {"tokens", "frames"}
    assert tuple(values["frames"].shape) == tuple(jin["frames"].shape)
    assert values["frames"].dtype == torch.bfloat16 and str(jin["frames"].dtype) == "bfloat16"
    assert in_axes == {k: tuple(v) for k, v in jin_axes.items()}


def test_prefill_without_frames_raises():
    cfg = get_arch(ARCH).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="frames"):
        model.prefill(params, torch.zeros((1, 4), dtype=torch.int64))


def test_serve_json_on_cpu(capsys):
    """``python -m repro_torch.launch.serve --arch whisper-tiny`` on the CPU:
    the reduced model, seeded frames, the reference's status line."""
    rc = serve.main(["--arch", ARCH, "--device", "cpu", "--json", "--batch", "2",
                     "--prompt-len", "12", "--new-tokens", "5"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and last["status"] == "ok" and last["arch"] == ARCH
    assert last["tokens_per_s"] > 0


def test_make_frames_is_seeded():
    model = build_model(get_arch(ARCH).reduced())
    a, b = serve.make_frames(model, 2, "cpu", 3), serve.make_frames(model, 2, "cpu", 3)
    assert a.shape == (2, 16, 64) and a.dtype == torch.float32 and torch.equal(a, b)
    assert serve.make_frames(build_model(get_arch("gemma-2b").reduced()), 2, "cpu") is None
