"""The int8 KV cache (``kv_cache_dtype="int8"``) against the JAX package:
the quantizer and the dequantizer bit for bit, the cache's layout, and
the reduced gemma-2b (full attention), recurrentgemma-9b (a windowed
ring) and olmoe-1b-7b (GQA, the mixture of experts) serving with it.

Compared in the models: the prefill's and 4 decode steps' logits, the
greedy tokens, and the cache's int8 entries and float16 scales after the
last step. Tolerance: logits within the earlier serving slices' 1e-4
(float32), tokens equal; int8 entries within one step and scales within
one float16 step (2^-10 relative) of the reference's, since a
projection's last-bit difference in float32 can move an entry across a
rounding half by one step of its scale and no more (the readings on these
seeds: every entry and scale equal, logits within 2.4e-7)."""
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
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.model_api import _stacks_for

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

INT8 = {"kv_cache_dtype": "int8"}
ARCHS = ("gemma-2b", "recurrentgemma-9b", "olmoe-1b-7b")
LOGITS_TOL = 1e-4
B, S, STEPS = 2, 16, 4  # S: recurrentgemma's reduced window, so its ring wraps exactly
SCALE_RTOL = 2.0 ** -10  # one float16 step


HALVES = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -2.5, 126.5], np.float32)
HALVES_ROUNDED = np.array([127, 2, -4, 0, 0, 2, -2, 126], np.int8)  # half to even


def _halves(rng) -> np.ndarray:
    """(4, 3, 2, 64) float32: random rows, a row whose amax is 127 (scale
    1.0, so x / scale is x) that starts with exact halves (HALVES), an
    all-zero row and a tiny row."""
    x = rng.standard_normal((4, 3, 2, 64)).astype(np.float32)
    x[0, 0, 0, :8] = HALVES
    x[1, 1, 0] = 0.0
    x[2, 2, 1] *= 1e-9
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_is_bit_equal_to_jax(dtype):
    """``_quantize_kv`` on the same array (float32, and bf16 as the model's
    k / v arrive) gives the reference's int8 values and float16 scales bit
    for bit, rounding halves to even."""
    x = _halves(np.random.default_rng(0))
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    wq, ws = JL._quantize_kv(jx)
    q, s = L._quantize_kv(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert q.dtype == torch.int8 and s.dtype == torch.float16
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy().view(np.uint16), np.asarray(ws).view(np.uint16))
    if dtype == "float32":
        np.testing.assert_array_equal(q[0, 0, 0, :8].numpy(), HALVES_ROUNDED)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_is_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(1)
    q = rng.integers(-127, 128, (3, 5, 2, 16)).astype(np.int8)
    s = (rng.random((3, 5, 2)) * 0.05).astype(np.float16)
    want = JL._dequantize_kv(jnp.asarray(q), jnp.asarray(s), jnp.dtype(dtype))
    got = L._dequantize_kv(torch.from_numpy(q), torch.from_numpy(s), getattr(torch, dtype))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_cache_layout_is_the_references():
    """``attention_cache_init`` of an int8 config: the reference's leaves,
    shapes, dtypes and initial values, and its logical axes."""
    jcfg = dataclasses.replace(jax_get_arch("gemma-2b").reduced(), **INT8)
    cfg = dataclasses.replace(get_arch("gemma-2b").reduced(), **INT8)
    jvalues, jaxes = split_params(JL.attention_cache_init(jcfg, 3, 20, jnp.float32))
    got = L.attention_cache_init(cfg, 3, 20, torch.float32, "cpu")
    assert set(got) == set(jvalues) == {"k", "v", "k_scale", "v_scale", "kpos"}
    for name, t in got.items():
        assert tuple(t.shape) == tuple(jvalues[name].shape), name
        assert str(t.dtype).split(".")[-1] == str(jvalues[name].dtype), name
        np.testing.assert_array_equal(t.numpy(), np.asarray(jvalues[name]))
        assert L.cache_axes(cfg)[name] == tuple(jaxes[name]), name


@functools.lru_cache(maxsize=None)
def _run_both(arch: str):
    """Prefill then STEPS decode steps on both sides with the int8 cache,
    both fed the reference's greedy token: ([(reference, port logits)],
    the reference's final caches (numpy), the port's)."""
    jcfg = dataclasses.replace(jax_get_arch(arch).reduced(), **INT8)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **INT8)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    values = jax.tree.map(np.asarray, split_params(jmodel.init(jax.random.key(0)))[0])
    params = convert.from_jax_values(values, cfg)
    jv = jax.tree.map(jnp.asarray, values)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (B, S), dtype=np.int32)
    jl, jc = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, cache_len=S + STEPS))(
        jv, jnp.asarray(tokens))
    jdecode = jax.jit(jmodel.decode)
    with torch.inference_mode():
        tl, tc = model.prefill(params, torch.from_numpy(tokens).long(), cache_len=S + STEPS)
        pairs = [(np.asarray(jl), tl.numpy())]
        for i in range(STEPS):
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
            jl, jc = jdecode(jv, jnp.asarray(tok), jnp.int32(S + i), jc)
            tl, tc = model.decode(params, torch.from_numpy(tok).long(), S + i, tc)
            pairs.append((np.asarray(jl), tl.numpy()))
    return cfg, pairs, jax.tree.map(np.asarray, jc), tc


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    cfg, pairs, _, _ = _run_both(arch)
    for step, (want, got) in enumerate(pairs):
        assert got.shape == want.shape == (B, cfg.vocab)
        np.testing.assert_allclose(got, want, atol=LOGITS_TOL, rtol=LOGITS_TOL,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1), err_msg=f"step {step}")


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_entries_and_scales_match_jax(arch):
    """After the last decode step each attention layer's int8 k / v are
    within one step of the reference's, its scales within one float16
    step, its kpos equal."""
    cfg, _, jc, tc = _run_both(arch)
    first, n_attn = 0, 0
    for si, (unit, reps) in enumerate(_stacks_for(cfg)):
        for r in range(reps):
            for j, kind in enumerate(unit):
                layer = tc[first + r * len(unit) + j]
                if "attn" not in kind:
                    continue
                n_attn += 1
                ref = jc[f"stack{si}"][j]["attn"]
                assert set(layer) == set(ref) == {"k", "v", "k_scale", "v_scale", "kpos"}
                for name in ("k", "v"):
                    got = layer[name].numpy()
                    assert got.dtype == np.int8
                    assert np.abs(got.astype(np.int32) - ref[name][r].astype(np.int32)).max() <= 1
                for name in ("k_scale", "v_scale"):
                    got = layer[name].numpy()
                    assert got.dtype == np.float16
                    np.testing.assert_allclose(got.astype(np.float32),
                                               ref[name][r].astype(np.float32), rtol=SCALE_RTOL,
                                               atol=0)
                np.testing.assert_array_equal(layer["kpos"].numpy(), ref["kpos"][r])
        first += reps * len(unit)
    assert n_attn >= 1


def test_serve_setup_takes_the_int8_cache(capsys):
    """The serving entry point reaches the int8 cache through the config, as
    the dry run's variant does: ``setup(changes=...)`` builds it, and the
    caches it serves from are int8."""
    model, params, prompt = serve.setup(device="cpu", batch=2, prompt_len=8, changes=INT8)
    assert model.cfg.kv_cache_dtype == "int8"
    gen = serve.generate(model, params, prompt, 4)
    assert gen.tokens.shape == (2, 4) and all(torch.isfinite(x).all() for x in gen.logits)
    _, caches = model.prefill(params, prompt, cache_len=12)
    assert caches[0]["k"].dtype == torch.int8 and caches[0]["k_scale"].dtype == torch.float16
    res = serve.summary(model.cfg.name, gen)
    assert json.loads(json.dumps(res))["status"] == "ok"
