"""The port's rwkv6-1.6b and recurrentgemma-9b (reduced: d 64; the hybrid
with its one pattern group of 3 layers and a 5-layer variant with the
remainder stack) against the JAX models on the same weights: caches after
the prefill, prefill and decode logits, greedy tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.utils.tree import split_params
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models.model_api import _stacks_for

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

B, STEPS = 2, 4
F32_TOL = 1e-4  # float32 model, plain versions against the JAX model
BF16_TOL = 2e-2  # bfloat16, teacher-forced (the two frameworks round at other places)
HYBRID_ORDER = ["rec", "rec", "attn_local"] * 12 + ["rec", "rec"]

# (arch, n_layers or None for the reduced default, prompt length)
CASES = {
    "rwkv6": ("rwkv6-1.6b", None, 16),
    "hybrid3-window": ("recurrentgemma-9b", None, 16),  # prompt = the reduced window
    "hybrid3-wrapped": ("recurrentgemma-9b", None, 32),  # the window's ring wraps
    "hybrid5-remainder": ("recurrentgemma-9b", 5, 32),  # stack0 x1 + stack1 (rec, rec)
}
#: constant-initialised leaves (mu 0.5, w0 -6, u 0, lam -4.83, ...) get
#: noise in the tests so that every term of the recurrences matters
_NOISY = {"mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "w0", "u", "ln_scale", "ln_bias",
          "conv_w", "conv_b", "ba", "bi", "lam"}


def _perturb(tree, rng):
    return {k: _perturb(v, rng) if isinstance(v, dict)
            else (v + 0.3 * rng.standard_normal(v.shape).astype(np.float32) if k in _NOISY else v)
            for k, v in tree.items()}


def _models(arch: str, dtype: str, n_layers=None):
    change = dict(dtype=dtype, **({"n_layers": n_layers} if n_layers else {}))
    jcfg = dataclasses.replace(jax_get_arch(arch).reduced(), **change)
    tcfg = dataclasses.replace(get_arch(arch).reduced(), **change)
    jmodel = jax_build_model(jcfg)
    values, _ = split_params(jmodel.init(jax.random.key(0)))
    values = _perturb(jax.tree.map(np.asarray, values), np.random.default_rng(1))
    params = convert.from_jax_values(values, tcfg)
    return jmodel, jax.tree.map(jnp.asarray, values), build_model(tcfg), params


def _reference_layer_caches(jcaches, cfg):
    """The reference's stacked caches, one dict per layer in model order."""
    out = []
    for si, (unit, reps) in enumerate(_stacks_for(cfg)):
        for rep in range(reps):
            for j in range(len(unit)):
                c = jcaches[f"stack{si}"][j]
                c = c.get("attn", c)
                out.append({k: np.asarray(v[rep].astype(jnp.float32)) for k, v in c.items()})
    return out


def _run_both(case: str, dtype: str, teacher_forced: bool):
    arch, n_layers, S = CASES[case]
    jmodel, values, tmodel, params = _models(arch, dtype, n_layers)
    prompt = np.random.default_rng(7).integers(0, tmodel.cfg.vocab, (B, S), dtype=np.int32)
    jprefill = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, cache_len=S + STEPS))
    jdecode = jax.jit(lambda p, t, pos, c: jmodel.decode(p, t, pos, c))

    jl, jc = jprefill(values, jnp.asarray(prompt))
    tl, tc = tmodel.prefill(params, torch.from_numpy(prompt).long(), cache_len=S + STEPS)
    # decode updates the port's caches in place: keep copies of the prefill's
    caches = (_reference_layer_caches(jc, tmodel.cfg),
              [{k: v.clone() for k, v in c.items()} for c in tc])
    pairs = [(np.asarray(jl.astype(jnp.float32)), tl.float().numpy())]
    for i in range(STEPS):
        jtok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        ttok = jtok if teacher_forced else torch.argmax(tl, -1)[:, None].numpy()
        jl, jc = jdecode(values, jnp.asarray(jtok), jnp.int32(S + i), jc)
        tl, tc = tmodel.decode(params, torch.from_numpy(ttok).long(), S + i, tc)
        pairs.append((np.asarray(jl.astype(jnp.float32)), tl.float().numpy()))
    return tmodel, caches, pairs


@pytest.mark.parametrize("case", list(CASES))
def test_reduced_recurrent_f32_matches_jax(case):
    ops.reset_launch_counts()
    with torch.inference_mode():
        tmodel, (want_caches, got_caches), pairs = _run_both(case, "float32", False)
    assert len(got_caches) == len(want_caches) == tmodel.cfg.n_layers
    for layer, (want, got) in enumerate(zip(want_caches, got_caches)):
        assert set(got) == set(want), layer
        for key in want:
            assert tuple(got[key].shape) == want[key].shape, (layer, key)
            np.testing.assert_allclose(got[key].float().numpy(), want[key], atol=F32_TOL,
                                       rtol=F32_TOL, err_msg=f"layer {layer} cache {key}")
    for step, (want, got) in enumerate(pairs):
        assert got.shape == want.shape == (B, 512)
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL, err_msg=f"step {step}")
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1), err_msg=f"step {step}")
    assert ops.launch_counts() == {"rmsnorm": 0, "flash_attention": 0, "flash_decode": 0,
                                   "wkv6": 0, "rglru": 0, "rmsnorm_bwd": 0,
                                   "flash_attention_bwd": 0, "wkv6_bwd": 0,
                                   "rglru_bwd": 0}


@pytest.mark.parametrize("case", list(CASES))
def test_reduced_recurrent_bf16_matches_jax(case):
    with torch.inference_mode():
        _, _, pairs = _run_both(case, "bfloat16", True)
    for step, (want, got) in enumerate(pairs):
        np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL, err_msg=f"step {step}")


F32_CASES = [
    ("rwkv6-1.6b", "tm", {"w0", "u", "ln_scale", "ln_bias"}),
    ("recurrentgemma-9b", "rec", {"wa", "ba", "wi", "bi", "lam"}),
]


def _assert_f32_leaves(params, sub, f32):
    assert params["embed"].dtype == torch.bfloat16
    for layer in params["layers"]:
        for block, leaves in layer.items():
            for name, t in leaves.items():
                norm = block in ("ln1", "ln2")
                want = torch.float32 if norm or (block == sub and name in f32) else torch.bfloat16
                assert t.dtype == want, (block, name, t.dtype)
    assert f32 <= set(params["layers"][0][sub])


@pytest.mark.parametrize("arch,sub,f32", F32_CASES)
def test_convert_keeps_exactly_the_f32_leaves(arch, sub, f32):
    _assert_f32_leaves(_models(arch, "bfloat16")[3], sub, f32)


@pytest.mark.parametrize("arch,sub,f32", F32_CASES)
def test_init_keeps_exactly_the_f32_leaves(arch, sub, f32):
    """The port's own random init keeps the same leaves float32 as convert."""
    tmodel = build_model(dataclasses.replace(get_arch(arch).reduced(), dtype="bfloat16"))
    gen = torch.Generator()
    gen.manual_seed(0)
    _assert_f32_leaves(tmodel.init(gen, torch.device("cpu")), sub, f32)


def test_convert_orders_the_hybrid_layers_in_model_order():
    """At full depth: stack0's unit (rec, rec, attn_local) x 12, then
    stack1's (rec, rec) x 1. Each leaf of a marker tree holds (stack, block,
    repeat), so the order of the converted layers can be read back."""
    cfg = get_arch("recurrentgemma-9b")
    tmodel = build_model(cfg)
    assert tmodel.kinds == HYBRID_ORDER
    values = {"embed": np.zeros((2, 2), np.float32), "final_ln": {"scale": np.ones(2, np.float32)}}
    for si, (unit, reps) in enumerate(_stacks_for(cfg)):
        values[f"stack{si}"] = {
            f"b{j}": {"ln1": {"scale": np.array([[100 * si + 10 * j + r] for r in range(reps)],
                                                np.float32)}}
            for j in range(len(unit))
        }
    layers = convert.from_jax_values(values, cfg)["layers"]
    got = [int(layer["ln1"]["scale"][0]) for layer in layers]
    want = [10 * j + r for r in range(12) for j in range(3)] + [100, 110]
    assert got == want


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b"])
def test_init_cache_matches_reference_layout(arch):
    """Per layer: the same cache keys, shapes and dtypes as the reference's
    stacked ``init_cache`` (bfloat16 activations; float32 recurrent states)."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="bfloat16")
    jcfg = dataclasses.replace(jax_get_arch(arch).reduced(), dtype="bfloat16")
    seq_len = 40  # above the reduced window: the windowed layer keeps 16 slots
    jcaches = split_params(jax_build_model(jcfg).init_cache(B, seq_len))[0]
    want = []
    for si, (unit, reps) in enumerate(_stacks_for(cfg)):
        for _ in range(reps):
            for j in range(len(unit)):
                c = jcaches[f"stack{si}"][j]
                want.append({k: (tuple(v.shape[1:]), str(v.dtype))
                             for k, v in c.get("attn", c).items()})
    got = [{k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in c.items()}
           for c in build_model(cfg).init_cache(B, seq_len, "cpu")]
    assert got == want
