"""The expert-parallel MoE (``repro_torch.models.moe.moe_apply_manual``) on
gloo meshes of CPU processes against the JAX package's
``moe_apply_manual``.

The reference runs on a 1x1 mesh, once for each data shard's tokens (its
``shard_map`` body sees one data shard; ``aux`` is the mean over the
shards), and its gradients are ``jax.grad`` of sum(y w) + aux over the
global batch. The port runs on (1, 2), (2, 1), (2, 2), (2, 2) with FSDP
and (1, 2) with the sequence-parallel override ``seq -> model``, each rank
on its own shards; its gradients are taken after the train step's
reductions (``tests/torch_mesh.py``). Each mesh runs the drop-free
reduced layer and the real 64 experts / top-8 / capacity factor 1.25
routing, which drops slots; both with one shared expert (column-parallel
over "model")."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh
from repro.configs import get_arch as jax_get_arch
from repro.models import moe as JM
from repro.sharding.rules import MeshRules as JaxMeshRules
from repro_torch.configs import get_arch
from repro_torch.models import moe as M
from repro_torch.sharding.rules import MeshRules, MeshShape

torch.set_num_threads(2)

ARCH = "olmoe-1b-7b"
TOL = 1e-5  # tests/test_moe.py's limit for the manual path, float32
B, S = 4, 16
LAYERS = {"reduced": dict(n_shared_experts=1),  # 4 experts, top-2, capacity factor 4: no drops
          "drops": dict(n_experts=64, top_k=8, capacity_factor=1.25, n_shared_experts=1)}
SEQ = {"seq": ["model"]}
# name -> (n_data, n_model, layer, fsdp, overrides)
MESHES = {"1x2": (1, 2, False, {}), "2x1": (2, 1, False, {}), "2x2": (2, 2, False, {}),
          "2x2-fsdp": (2, 2, True, {}), "1x2-seq": (1, 2, False, SEQ)}
CASES = {f"{mesh}-{layer}": (*MESHES[mesh][:2], layer, *MESHES[mesh][2:])
         for mesh in MESHES for layer in LAYERS}
# the auto path under rules: every leaf whole on every rank, the batch
# split over "data", the aux term the global batch's
AUTO = {f"2x2-auto-{layer}": (2, 2, layer, False, {}) for layer in LAYERS}


def _change(layer: str, fsdp: bool, impl: str = "manual"):
    return dict(LAYERS[layer], fsdp=fsdp, moe_impl=impl)


def _inputs(layer: str):
    """numpy float32 (layer params, x, w) at scales that make y O(1)."""
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), **LAYERS[layer])
    rng = np.random.default_rng(0)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def normal(shape, std):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    p = {"router": normal((d, E), 1 / np.sqrt(d)),
         "wg": normal((E, d, f), 1 / np.sqrt(d)), "wu": normal((E, d, f), 1 / np.sqrt(d)),
         "wo": normal((E, f, d), 1 / np.sqrt(f)),
         "shared": {"wg": normal((d, f), 1 / np.sqrt(d)), "wu": normal((d, f), 1 / np.sqrt(d)),
                    "wo": normal((f, d), 1 / np.sqrt(f))}}
    return p, normal((B, S, d), 1.0), normal((B, S, d), 1.0)


@functools.lru_cache(maxsize=None)
def _reference(name: str):
    """The reference on a 1x1 mesh: (y (B, S, d), aux, grads of p, grad of x)."""
    n_data, _, layer, fsdp, overrides = CASES[name]
    p, x, w = _inputs(layer)
    jcfg = dataclasses.replace(jax_get_arch(ARCH).reduced(), **_change(layer, fsdp))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rules = JaxMeshRules(mesh, fsdp=fsdp, overrides=overrides)

    def layer_fn(p_, x_):
        outs = [JM.moe_apply_manual(p_, xd, jcfg, rules) for xd in jnp.split(x_, n_data)]
        return (jnp.concatenate([y for y, _ in outs]),
                jnp.mean(jnp.stack([aux for _, aux in outs])))

    def loss(p_, x_):
        y, aux = layer_fn(p_, x_)
        return jnp.sum(y * w) + aux

    jp, jx = jax.tree.map(jnp.asarray, p), jnp.asarray(x)
    with mesh:
        y, aux = jax.jit(layer_fn)(jp, jx)
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jx)
    return np.asarray(y), float(aux), jax.tree.map(np.asarray, gp), np.asarray(gx)


@functools.lru_cache(maxsize=None)
def _reference_auto(layer: str):
    """The reference's ``moe_apply_auto`` on the global batch (one device):
    (y, aux, grads of p, grad of x)."""
    p, x, w = _inputs(layer)
    jcfg = dataclasses.replace(jax_get_arch(ARCH).reduced(), **LAYERS[layer])

    def loss(p_, x_):
        y, aux = JM.moe_apply_auto(p_, x_, jcfg)
        return jnp.sum(y * w) + aux

    jp, jx = jax.tree.map(jnp.asarray, p), jnp.asarray(x)
    y, aux = jax.jit(lambda p_, x_: JM.moe_apply_auto(p_, x_, jcfg))(jp, jx)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jx)
    return np.asarray(y), float(aux), jax.tree.map(np.asarray, gp), np.asarray(gx)


def _cases(world: int):
    out = []
    for impl, cases in (("manual", CASES), ("auto", AUTO)):
        for name, (n_data, n_model, layer, fsdp, overrides) in cases.items():
            if n_data * n_model == world:
                p, x, w = _inputs(layer)
                out.append(dict(name=name, n_data=n_data, n_model=n_model,
                                change=_change(layer, fsdp, impl), overrides=overrides, p=p,
                                x=x, w=w))
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{case: [per-rank results]}: one spawn of 2 processes and one of 4."""
    out = {}
    for world in (2, 4):
        ranks = torch_mesh.run(torch_mesh.moe_cases, world,
                               tmp_path_factory.mktemp(f"moe{world}"), _cases(world))
        for name in ranks[0]:
            out[name] = [r[name] for r in ranks]
    return out


def _port_rules(name: str):
    n_data, n_model, layer, fsdp, overrides = CASES[name]
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), **_change(layer, fsdp))
    return cfg, MeshRules(MeshShape(("data", "model"), (n_data, n_model)), fsdp=fsdp,
                          overrides=overrides)


def _x_spec(name: str):
    return ("data", "model" if CASES[name][4] else None, None)


@pytest.mark.parametrize("name", CASES)
def test_manual_layer_matches_jax_per_data_shard(results, name):
    """y (each rank's data shard, or its sequence block under seq -> model)
    and aux against the reference's manual path on each data shard; every
    "model" rank of a data shard holds the same y. The drops layer drops
    slots on every shard, the reduced one none."""
    want_y, want_aux, _, _ = _reference(name)
    cfg, rules = _port_rules(name)
    for r in results[name]:
        want = rules.local_shard(torch.tensor(want_y), _x_spec(name), r["coord"]).numpy()
        np.testing.assert_allclose(r["y"].numpy(), want, atol=TOL, rtol=TOL)
        assert abs(r["aux"] - want_aux) <= TOL * abs(want_aux)
    assert float(np.abs(want_y).max()) > 0.1
    # the routing of each data shard: slots past capacity in the drops layer
    n_data = CASES[name][0]
    p, x, _ = _inputs(CASES[name][2])
    for xd in np.split(x, n_data):
        xs = torch.tensor(xd).reshape(-1, cfg.d_model)
        probs = torch.softmax(xs @ torch.tensor(p["router"]), dim=-1)
        T, E = probs.shape
        cap = int(np.ceil(cfg.top_k * T * cfg.capacity_factor / E))
        dropped = int(M.manual_plan(probs, torch.float32, cfg, 0, E, cap).dropped)
        assert (dropped > 0) == (CASES[name][2] == "drops"), dropped


@pytest.mark.parametrize("name", CASES)
def test_manual_layer_gradients_match_jax(results, name):
    """The gradients of sum(y w) + aux with respect to x and every leaf,
    after the step's reductions, against ``jax.grad`` of the reference on
    the global batch, each rank's block of them."""
    _, _, want_p, want_x = _reference(name)
    cfg, rules = _port_rules(name)
    specs = dict(torch_mesh.items(M.manual_specs(cfg, rules)))
    want_flat = {k: torch.tensor(v) for k, v in torch_mesh.items(want_p)}
    for r in results[name]:
        want = rules.local_shard(torch.tensor(want_x), _x_spec(name), r["coord"]).numpy()
        np.testing.assert_allclose(r["dx"].numpy(), want, atol=TOL, rtol=TOL)
        assert set(r["grads"]) == set(want_flat)
        for k, g in r["grads"].items():
            want = rules.local_shard(want_flat[k], specs[k], r["coord"]).numpy()
            assert g.shape == want.shape, k
            np.testing.assert_allclose(g.numpy(), want, atol=TOL, rtol=TOL, err_msg=k)
    assert float(np.abs(want_p["router"]).max()) > 0


@pytest.mark.parametrize("name", AUTO)
def test_auto_layer_under_rules_matches_jax_global_batch(results, name):
    """``moe_impl="auto"`` under rules on a (2, 2) mesh (the dispatcher's
    other path): each rank runs the auto path on its data shard with every
    leaf whole; y is the reference's ``moe_apply_auto`` on the global batch
    (its groups are batch rows), aux the global batch's (the means of the
    router's probabilities and of the top-1 shares are taken over the data
    axes before their product), and the gradients, the leaves' summed over
    the data axes, ``jax.grad``'s."""
    n_data, n_model, layer, _, _ = AUTO[name]
    want_y, want_aux, want_p, want_x = _reference_auto(layer)
    rules = MeshRules(MeshShape(("data", "model"), (n_data, n_model)))
    for r in results[name]:
        rows = ("data", None, None)
        np.testing.assert_allclose(
            r["y"].numpy(), rules.local_shard(torch.tensor(want_y), rows, r["coord"]).numpy(),
            atol=TOL, rtol=TOL)
        assert abs(r["aux"] - want_aux) <= TOL * abs(want_aux)
        np.testing.assert_allclose(
            r["dx"].numpy(), rules.local_shard(torch.tensor(want_x), rows, r["coord"]).numpy(),
            atol=TOL, rtol=TOL)
        for k, v in torch_mesh.items(want_p):
            np.testing.assert_allclose(r["grads"][k].numpy(), v, atol=TOL, rtol=TOL, err_msg=k)
