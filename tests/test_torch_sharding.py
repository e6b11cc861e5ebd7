"""The port's sharding (``repro_torch.sharding.rules``, ``launch.mesh``,
``core.elastic.remesh_rules``, the layouts and the train step of
``train.step`` under rules) against the JAX package.

Rules parity runs on abstract meshes (the production (16, 16) and (2, 16,
16), as ``tests/test_sharding_roofline.py``'s FakeMesh) at full width,
for every registered config of the reference. The placements and the
train step run on gloo meshes of CPU processes (``tests/torch_mesh.py``)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import all_archs as jax_all_archs
from repro.configs import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.sharding.rules import MeshRules as JaxMeshRules
from repro.train.optim import make_optimizer as jax_make_optimizer
from repro.train.step import make_train_step as jax_make_train_step
from repro.utils.tree import split_params
from repro_torch.configs import SHAPES, all_archs, get_arch
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.model_api import _stacks_for
from repro_torch.sharding.rules import MeshRules, MeshShape, map_specs
from repro_torch.train import step as S
from repro_torch.train.optim import _paths, leaf_groups

torch.set_num_threads(2)

ARCH = "olmoe-1b-7b"
TOL = 1e-5
MESHES = {"single-pod": False, "multi-pod": True}
OVERRIDES = ({}, {"seq": ["model"]}, {"seq": ["__data__"]})  # launch/dryrun.py's variants
PORT_ARCHS = sorted(all_archs())


class FakeMesh:
    """tests/test_sharding_roofline.py's stand-in for a jax Mesh."""

    def __init__(self, shape: MeshShape):
        self.shape = shape.shape
        self.axis_names = shape.axis_names


def _rule_pairs(multi_pod: bool, fsdp: bool, overrides):
    shape = make_production_mesh(multi_pod=multi_pod)
    return (JaxMeshRules(FakeMesh(shape), fsdp=fsdp, overrides=overrides),
            MeshRules(shape, fsdp=fsdp, overrides=overrides))


def _jax_leaves(cfg):
    """(axes, shape) of every leaf the reference lays out: the parameters,
    the inputs of every shape, the decode caches."""
    model = jax_build_model(cfg)
    trees = [split_params(model.abstract_init())]
    trees += [split_params(model.input_specs(s)) for s in JAX_SHAPES.values()]
    trees += [split_params(model.abstract_cache(s.global_batch, s.seq_len))
              for s in JAX_SHAPES.values() if s.kind == "decode"]
    out = []
    for values, axes in trees:
        vals, _ = jax.tree.flatten(values)
        axs = jax.tree.leaves(axes, is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(e, (str, type(None))) for e in x))
        out += [(tuple(a), tuple(v.shape)) for a, v in zip(axs, vals)]
    return out


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", sorted(jax_all_archs()))
def test_spec_for_matches_jax(arch, mesh):
    """``spec_for`` entry for entry on every leaf of every registered config
    at full width: with ``fsdp`` as the config sets it and on, and under the
    dry run's overrides (none, seq -> model, seq -> the data axes)."""
    cfg = jax_get_arch(arch)
    leaves = _jax_leaves(cfg)
    n, combos = 0, 0
    for fsdp in sorted({cfg.fsdp, True}):
        for overrides in OVERRIDES:
            jrules, trules = _rule_pairs(MESHES[mesh], fsdp, overrides)
            combos += 1
            for axes, shape in leaves:
                assert trules.spec_for(axes, shape) == tuple(jrules.spec_for(axes, shape)), \
                    (axes, shape, fsdp, overrides)
                n += 1
    assert n == combos * len(leaves) and len(leaves) >= 20


def _port_pairs(arch: str):
    """(reference config, port config) at full width."""
    return jax_get_arch(arch), get_arch(arch)


def _layer_of(cfg, tree, index: int):
    """The reference's subtree of the port's layer ``index`` (its stack's
    block of the unit: ``b{j}`` in the parameters, the j-th of a tuple in
    the caches), its leading "layers" entry or dim still there."""
    first = 0
    for si, (unit, reps) in enumerate(_stacks_for(cfg)):
        if index < first + reps * len(unit):
            j = (index - first) % len(unit)
            stack = tree[f"stack{si}"]
            return stack[j] if isinstance(stack, tuple) else stack[f"b{j}"]
        first += reps * len(unit)
    raise IndexError(index)


def _drop_layers(tree):
    return jax.tree.map(lambda ax: ax[1:], tree, is_leaf=lambda x: isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x))


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_param_and_cache_axes_match_jax(arch):
    """For the port's own families: ``param_axes`` is the reference's with
    each layer's leading "layers" entry dropped, ``abstract_init`` (the meta
    device) has the reference's shapes, the cache and the inputs carry the
    reference's axes, and the port's spec of each per-layer leaf is the
    reference's stacked leaf's without its first entry. An encoder-decoder's
    encoder layers are held as its decoder layers are (against the
    reference's ``encoder/b0``), and its cache's last entry, the memory, as
    the reference's ``memory``."""
    jcfg, tcfg = _port_pairs(arch)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jvalues, jaxes = split_params(jmodel.abstract_init())
    taxes, tvals = tmodel.param_axes(), tmodel.abstract_init()
    assert {k: v for k, v in taxes.items() if k not in ("layers", "encoder")} == \
        {k: v for k, v in jaxes.items() if not k.startswith("stack") and k != "encoder"}
    for i, enc in enumerate(taxes.get("encoder", ())):
        assert enc == _drop_layers(jaxes["encoder"]["b0"]), i
        assert map_specs(lambda ax, t: tuple(t.shape), enc, tvals["encoder"][i]) == \
            jax.tree.map(lambda v: tuple(v.shape[1:]), jvalues["encoder"]["b0"]), i
    jrules, trules = _rule_pairs(False, False, {})
    for i in range(len(taxes["layers"])):
        want = _layer_of(tcfg, jaxes, i)
        assert taxes["layers"][i] == _drop_layers(want), i
        wshape = _layer_of(tcfg, jvalues, i)
        got_shapes = map_specs(lambda ax, t: tuple(t.shape), taxes["layers"][i],
                               tvals["layers"][i])
        assert got_shapes == jax.tree.map(lambda v: tuple(v.shape[1:]), wshape), i
        for (path, ax), (_, t) in zip(_paths(taxes["layers"][i]), _paths(tvals["layers"][i])):
            stacked = ("layers",) + ax
            assert trules.spec_for(ax, tuple(t.shape)) == \
                tuple(jrules.spec_for(stacked, (1,) + tuple(t.shape)))[1:], path
    assert all(t.device.type == "meta" for _, t in _paths(tvals))
    jc_vals, jc_axes = split_params(jmodel.abstract_cache(2, 64))
    tc_vals, tc_axes = tmodel.abstract_cache(2, 64)
    if tcfg.encoder_layers:
        memory_axes, memory = tc_axes.pop(), tc_vals.pop()
        assert memory_axes == {"memory": tuple(jc_axes["memory"])}
        assert tuple(memory["memory"].shape) == tuple(jc_vals["memory"].shape)
    assert len(tc_axes) == len(tc_vals) == len(tmodel.kinds)
    for i, (ax, val) in enumerate(zip(tc_axes, tc_vals)):
        want = _layer_of(tcfg, jc_axes, i)
        wval = _layer_of(tcfg, jc_vals, i)
        want, wval = (want["attn"], wval["attn"]) if "attn" in want else (want, wval)
        assert ax == _drop_layers(want), i
        assert {k: tuple(v.shape) for k, v in val.items()} == \
            {k: tuple(v.shape[1:]) for k, v in wval.items()}, i
    for shape in SHAPES.values():
        tv, ta = tmodel.input_specs(shape)
        jv, ja = split_params(jmodel.input_specs(JAX_SHAPES[shape.name]))
        assert ta == ja and {k: tuple(v.shape) for k, v in tv.items()} == \
            {k: tuple(v.shape) for k, v in jv.items()}


@pytest.mark.parametrize("optimizer", ("adamw", "adafactor"))
def test_state_batch_and_cache_shardings_match_jax(optimizer):
    """``state_shardings`` (the optimizer leaves following their parameter,
    Adafactor's ``vr`` / ``vc`` the reduced axes), ``batch_shardings`` and
    ``cache_shardings`` on olmoe-1b-7b at full width: the placements of the
    reference's specs, the reference's factories on a 1x1 mesh."""
    jcfg, tcfg = (dataclasses.replace(c, optimizer=optimizer) for c in _port_pairs(ARCH))
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rules = MeshRules(MeshShape(("data", "model"), (1, 1)))
    _, _, _, jstate_sh, jbatch_sh = jax_make_train_step(jmodel, JaxMeshRules(mesh))
    with mesh:
        want_state = jstate_sh()
        want_batch = jbatch_sh(JAX_SHAPES["train_4k"])
    got = S.state_shardings(tmodel, rules)
    want_opt = dict(_paths(jax.tree.map(lambda s: rules.placements(tuple(s.spec)),
                                        want_state["opt"])))
    assert dict(_paths(got["opt"])) == want_opt
    if optimizer == "adafactor":
        assert any(p[-1] in ("vr", "vc") for p in want_opt)
    # a per-layer leaf's placements: those of the stacked leaf's spec
    # without its "layers" entry
    want_params = {path: rules.placements(tuple(s.spec)[1:] if path[0].startswith("stack")
                                          else tuple(s.spec))
                   for path, s in _paths(want_state["params"])}
    assert {path: ts[0] for path, ts, _ in leaf_groups(got["params"], _stacks_for(tcfg))} == \
        want_params
    batch = S.batch_shardings(tmodel, rules, SHAPES["train_4k"])
    assert batch == {"tokens": rules.placements(tuple(want_batch["tokens"].spec))}
    c_sh, c_vals = S.cache_shardings(tmodel, rules, 4, 64)
    assert all(t.device.type == "meta" for _, t in _paths(c_vals))
    assert c_sh[0]["k"] == rules.placements(("data", None, "model", None))


def test_production_meshes_and_host_mesh_refusals():
    """The production meshes as shapes; a host mesh needs a process group
    of its size (without one, only a one-rank mesh makes its own)."""
    assert make_production_mesh() == MeshShape(("data", "model"), (16, 16))
    assert make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        make_host_mesh(2, 2, device_type="cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        make_host_mesh(1, 1, device_type="tpu")


def test_constrain_checks_the_local_shape():
    """``constrain`` returns the tensor itself; with rules it refuses a
    tensor whose dims do not match the logical axes, or whose batch dim the
    rules do not lay over the data axes."""
    from repro_torch.sharding.rules import constrain

    x = torch.zeros((2, 16, 64))
    rules = MeshRules(MeshShape(("data", "model"), (2, 2)))
    assert constrain(x, None, ("batch",)) is x
    assert constrain(x, rules, ("batch", "seq", None)) is x
    with pytest.raises(ValueError, match="logical axes"):
        constrain(x, rules, ("batch", "seq"))
    with pytest.raises(ValueError, match="data axes"):
        constrain(x, MeshRules(rules.mesh, overrides={"batch": ["model"]}),
                  ("batch", "seq", None))


# ---------------------------------------------------------------------------
# on gloo meshes
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _olmoe_values():
    jcfg = dataclasses.replace(jax_get_arch(ARCH).reduced(), moe_impl="manual")
    values, _ = split_params(jax_build_model(jcfg).init(jax.random.key(0)))
    return jax.tree.map(np.asarray, values)


@pytest.fixture(scope="module")
def distributed(tmp_path_factory):
    return torch_mesh.run(torch_mesh.distribute_cases, 4, tmp_path_factory.mktemp("dist"),
                          _olmoe_values(), (False, True))


@pytest.mark.parametrize("fsdp", (False, True))
def test_distribute_tree_gives_the_reference_spec_slices(distributed, fsdp):
    """``distribute_tree`` of olmoe's reduced parameters over a (2, 2)
    mesh: every rank's local shard is the block of the parameter that the
    reference's spec names for that rank (the reference's ``spec_for`` on a
    FakeMesh of the same shape), and ``full_tensor()`` gives the input
    back."""
    from repro_torch import convert

    tcfg = torch_mesh.olmoe_manual()
    params = dict(_paths(convert.from_jax_values(_olmoe_values(), tcfg,
                                                 param_dtype=torch.float32)))
    axes = dict(_paths(build_model(tcfg).param_axes()))
    shape = MeshShape(("data", "model"), (2, 2))
    jrules, trules = JaxMeshRules(FakeMesh(shape), fsdp=fsdp), MeshRules(shape, fsdp=fsdp)
    split = 0
    for r in distributed:
        got = r[fsdp]
        assert set(got) == {"/".join(p) for p in params}
        for path, t in params.items():
            spec = tuple(jrules.spec_for(axes[path], tuple(t.shape)))
            local, whole = got["/".join(path)]
            want = trules.local_shard(t, spec, r["coord"])
            assert whole, path
            assert local.shape == want.shape and torch.equal(local, want), (path, spec)
            split += local.numel() < t.numel()
    assert split >= 4 * 10  # the embedding, attention and expert leaves are split
    if fsdp:
        assert any("data" in str(jrules.spec_for(axes[p], tuple(t.shape)))
                   for p, t in params.items())


# AdamW's first step moves a parameter by about lr whatever its gradient's
# size, so a gradient near zero, summed in another order, can move it by up
# to 2 lr: the parameters are held at lr 1e-4 within TOL, and the moments
# (the gradient's size) within TOL of each leaf's largest
LR = 1e-4
B, S_LEN = 4, 16


@functools.lru_cache(maxsize=None)
def _reference_steps():
    """The reference's single-device steps on the global batches from its
    initial state: {"1x2": one ``make_train_step`` step; "2x1": one step of
    the loss that a (2, 1) mesh computes, the mean over the two data
    shards of the reference's loss (the manual path's aux term is each data
    shard's, averaged: ``pmean`` over the data axes); "remesh": from the
    "2x1" state, the next ``make_train_step`` step}: (loss, {path: leaf} of
    the parameters and the AdamW moments)."""
    jcfg = dataclasses.replace(jax_get_arch(ARCH).reduced(), moe_impl="manual")
    model = jax_build_model(jcfg)
    ts, init, *_ = jax_make_train_step(model, lr=LR)
    _, opt_update = jax_make_optimizer(jcfg.optimizer, lr=LR)

    def ts_2x1(state, batch):
        def loss(p):
            shards = jnp.split(batch["tokens"], 2)
            return jnp.mean(jnp.stack([model.loss(p, {"tokens": t}) for t in shards]))

        value, grads = jax.value_and_grad(loss)(state["params"])
        params, opt = opt_update(state["params"], grads, state["opt"], state["step"])
        return {"params": params, "opt": opt, "step": state["step"] + 1}, {"loss": value}

    state = init(jax.random.key(0))
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab, (2, B, S_LEN), dtype=np.int32)
    first = jax.tree.map(np.asarray, state)

    def run(fn, st, t):
        new, m = jax.jit(fn)(st, {"tokens": jnp.asarray(t)})
        return new, (float(m["loss"]), {**{("params",) + p: v for p, v in
                                           _paths(jax.tree.map(np.asarray, new["params"]))},
                                        **dict(_paths(jax.tree.map(np.asarray, new["opt"])))})

    out = {"1x2": run(ts, state, tokens[0])[1]}
    state_2x1, out["2x1"] = run(ts_2x1, state, tokens[0])
    out["remesh"] = run(ts, state_2x1, tokens[1])[1]
    return first, tokens, out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    first, tokens, _ = _reference_steps()
    return torch_mesh.run(torch_mesh.train_cases, 2, tmp_path_factory.mktemp("train"), first,
                          tokens, LR)


@pytest.mark.parametrize("case", ("1x2", "2x1", "remesh"))
def test_train_step_under_rules_matches_jax(trained, case):
    """A train step of olmoe's reduced manual config under rules, each rank
    on its data shard and its experts: the global loss on every rank and
    each rank's block of the updated parameters and AdamW moments against
    the reference's step on the global batch (``_reference_steps``).
    "remesh": after host 1 is lost the (2, 1) job shrinks to (1, 1)
    (``replan``, ``reshard_batch``, ``remesh_rules``), and the survivor's
    next step matches the reference's next step."""
    loss, want = _reference_steps()[2][case]
    ranks = [r[case] for r in trained if case in r]
    assert len(ranks) == (1 if case == "remesh" else 2)
    tcfg = torch_mesh.olmoe_manual()
    shape = (1, 1) if case == "remesh" else tuple(int(n) for n in case.split("x"))
    rules = MeshRules(MeshShape(("data", "model"), shape))
    specs = {path: (None,) + ts[0] if stacked else ts[0] for path, ts, stacked in
             leaf_groups(build_model(tcfg).run_specs(rules), _stacks_for(tcfg))}
    for r in ranks:
        assert abs(r["loss"] - loss) <= TOL, (r["loss"], loss)
        for path, w in want.items():
            kind = path[0] if path[0] == "params" else path[-1]  # params, m or v
            key = "/".join(path[1:] if kind == "params" else path)
            w = rules.local_shard(torch.tensor(w), specs[path[1:] if kind == "params"
                                                       else path[:-1]], r["coord"]).numpy()
            got = r["state"][key].numpy()
            assert got.shape == w.shape, key
            limit = TOL if kind == "params" else TOL * float(np.abs(w).max()) + 1e-12
            assert float(np.abs(got - w).max()) <= limit, (key, float(np.abs(got - w).max()))
        assert len(r["state"]) == len(want)
    if case == "1x2":
        assert ranks[0]["state"]["stack0/b0/ffn/wg"].shape[1] == tcfg.n_experts // 2
