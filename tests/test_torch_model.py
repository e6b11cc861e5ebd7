"""The port's gemma-2b (reduced: 2 layers, d 64) against the JAX model on the
same weights: prefill and decode logits and greedy tokens."""
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

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

B, S, STEPS = 2, 16, 4


def _models(dtype: str):
    jcfg = dataclasses.replace(jax_get_arch("gemma-2b").reduced(), dtype=dtype)
    tcfg = dataclasses.replace(get_arch("gemma-2b").reduced(), dtype=dtype)
    jmodel = jax_build_model(jcfg)
    values, _ = split_params(jmodel.init(jax.random.key(0)))
    params = convert.from_jax_values(jax.tree.map(np.asarray, values), tcfg)
    return jmodel, values, build_model(tcfg), params


def _run_both(dtype: str, cache_len: int, teacher_forced: bool):
    """Prefill then STEPS decode steps on both sides. Each side feeds its own
    greedy token unless teacher_forced, where both take the JAX token."""
    jmodel, values, tmodel, params = _models(dtype)
    prompt = np.random.default_rng(7).integers(0, tmodel.cfg.vocab, (B, S), dtype=np.int32)
    jprefill = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, cache_len=cache_len))
    jdecode = jax.jit(lambda p, t, pos, c: jmodel.decode(p, t, pos, c))

    jl, jc = jprefill(values, jnp.asarray(prompt))
    tl, tc = tmodel.prefill(params, torch.from_numpy(prompt).long(), cache_len=cache_len)
    pairs = [(np.asarray(jl.astype(jnp.float32)), tl.float().numpy())]
    for i in range(STEPS):
        jtok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        ttok = jtok if teacher_forced else torch.argmax(tl, -1)[:, None].numpy()
        jl, jc = jdecode(values, jnp.asarray(jtok), jnp.int32(S + i), jc)
        tl, tc = tmodel.decode(params, torch.from_numpy(ttok).long(), S + i, tc)
        pairs.append((np.asarray(jl.astype(jnp.float32)), tl.float().numpy()))
    return pairs


@pytest.mark.parametrize("cache_len", [S + STEPS, S], ids=["headroom", "wrapped_ring"])
def test_reduced_gemma_f32_matches_jax(cache_len):
    ops.reset_launch_counts()
    with torch.inference_mode():
        pairs = _run_both("float32", cache_len, teacher_forced=False)
    for step, (want, got) in enumerate(pairs):
        assert got.shape == want.shape == (B, 512)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4, err_msg=f"step {step}")
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1), err_msg=f"step {step}")
    assert ops.launch_counts() == {"rmsnorm": 0, "flash_attention": 0, "flash_decode": 0,
                                   "wkv6": 0, "rglru": 0, "rmsnorm_bwd": 0,
                                   "flash_attention_bwd": 0}


def test_reduced_gemma_bf16_matches_jax():
    with torch.inference_mode():
        pairs = _run_both("bfloat16", S + STEPS, teacher_forced=True)
    for step, (want, got) in enumerate(pairs):
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2, err_msg=f"step {step}")


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ["gemma-2b", "rwkv6-1.6b", "recurrentgemma-9b"])
def test_config_matches_reference(arch, reduced):
    """Every field the port's ArchConfig keeps has the reference's value."""
    ours, ref = get_arch(arch), jax_get_arch(arch)
    if reduced:
        ours, ref = ours.reduced(), ref.reduced()
    fields = [f.name for f in dataclasses.fields(ours)]
    assert {n: getattr(ours, n) for n in fields} == {n: getattr(ref, n) for n in fields}
    assert ours.resolved_head_dim == ref.resolved_head_dim


def test_convert_keeps_norms_f32_and_weights_in_activation_dtype():
    _, _, tmodel, params = _models("bfloat16")
    assert params["embed"].dtype == torch.bfloat16
    assert params["final_ln"]["scale"].dtype == torch.float32
    assert len(params["layers"]) == tmodel.cfg.n_layers
    layer = params["layers"][1]
    assert layer["ln1"]["scale"].dtype == torch.float32
    assert layer["attn"]["wq"].shape == (64, 4, 16) and layer["attn"]["wq"].dtype == torch.bfloat16
    assert layer["ffn"]["wg"].shape == (64, 128)
