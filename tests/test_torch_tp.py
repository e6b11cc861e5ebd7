"""The "model"-axis split (tensor parallelism) of whole models under
``MeshRules`` on gloo meshes of CPU processes, against the JAX package.

Every leaf lies as the rules say (``ModelDef.run_specs``): attention heads
(and kv heads where they divide the axis), MLP columns, RG-LRU channels,
RWKV heads, experts and vocabulary over "model". Each rank runs
``prefill``, four decode steps, ``loss`` and one AdamW step on its shards
and its data shard of the batch (``tests/torch_mesh.py::tp_cases``);
whisper-tiny's frames go into its prefill and its loss, split over the
data axes as its tokens are. The serving-only cases (the int8 KV cache) run
the prefill and the decode steps. The
reference runs the same steps on the global batch on one device, as
``tests/test_torch_sharding.py::test_train_step_under_rules_matches_jax``
holds it: XLA's partitioner changes no value under rules, so the
single-device reference is what a rank's slice of the sharded result must
equal. Float32, reduced configs, within 1e-5."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh
from repro.configs import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.sharding.rules import MeshRules as JaxMeshRules
from repro.train.step import make_train_step as jax_make_train_step
from repro.utils.tree import split_params
from repro_torch.configs import all_archs, get_arch
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.model_api import _stacks_for
from repro_torch.sharding.rules import MeshRules, MeshShape
from repro_torch.train.optim import _paths, leaf_groups

torch.set_num_threads(2)

TOL = 1e-5
LR = 1e-4  # tests/test_torch_sharding.py's step
B, S, STEPS = 4, 16, 4
# name -> (arch, change to its reduced config)
CASES = {
    # 4 heads split, its single kv head whole (local group 4 / n), vocab split
    "gemma": ("gemma-2b", {}),
    # K = 2 does not divide the (1, 4) mesh's axis: heads split, kv whole,
    # each rank's 2 heads on one kv head (group 2); both split on 2 ranks
    "gqa": ("granite-3-2b", dict(n_heads=8, n_kv_heads=2)),
    # 12 heads on 3 kv heads: on 2 or 4 ranks a rank's heads read an uneven
    # run of kv heads (one kv head a q head, gathered)
    "gqa-uneven": ("granite-3-2b", dict(n_heads=12, n_kv_heads=3)),
    # heads and kv heads both split (MHA, as the real deepseek-7b)
    "mha": ("deepseek-7b", dict(n_kv_heads=4)),
    "rwkv6": ("rwkv6-1.6b", {}),
    # lru split, local attention over a window of 16
    "recurrentgemma": ("recurrentgemma-9b", {}),
    # the qkv biases, made nonzero
    "qwen": ("qwen2.5-3b", {}),
    # the auto path, its 4 experts over "model"
    "olmoe": ("olmoe-1b-7b", {}),
    # 4 image tokens before the text (replicated, the "img" rule), in the
    # prefill, the loss and the train step; decode after S + 4 positions
    "phi": ("phi-3-vision-4.2b", {}),
    # the encoder-decoder: its 4 heads on 2 kv heads split alike on 2 ranks,
    # kv whole on 4, its cross-attention split as its self-attention (its
    # backward too), the encoder's gradient through the memory; every bias
    # nonzero; frames in the prefill, the loss and the train step
    "whisper": ("whisper-tiny", {}),
}
# serving only: the int8 KV cache with its single kv head whole (gemma) and
# with an uneven map of 12 heads on 3 kv heads (the scales gathered as the
# int8 k / v are)
SERVE_CASES = {"gemma-int8": ("gemma-2b", dict(kv_cache_dtype="int8")),
               "gqa-uneven-int8": ("granite-3-2b", dict(n_heads=12, n_kv_heads=3,
                                                        kv_cache_dtype="int8"))}
ALL_CASES = {**CASES, **SERVE_CASES}
MESHES = ((1, 2), (2, 2), (1, 4))
BIAS_KEYS = ("bq", "bk", "bv")


def _jcfg(name: str):
    arch, change = ALL_CASES[name]
    return dataclasses.replace(jax_get_arch(arch).reduced(), **change)


def _nonzero_biases(tree, rng):
    for key, val in tree.items():
        if isinstance(val, dict):
            _nonzero_biases(val, rng)
        elif key in BIAS_KEYS + ("bi", "bo", "bias"):
            tree[key] = 0.5 * rng.standard_normal(val.shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _frames(name: str):
    """An encoder-decoder's frames (B, F, d), else None."""
    jcfg = _jcfg(name)
    if not jcfg.encoder_layers:
        return None
    return np.random.default_rng(5).standard_normal(
        (B, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _images(name: str):
    """A vision config's image embeddings (B, num_img_tokens, d), else None."""
    jcfg = _jcfg(name)
    if not jcfg.num_img_tokens:
        return None
    return np.random.default_rng(6).standard_normal(
        (B, jcfg.num_img_tokens, jcfg.d_model)).astype(np.float32)


def _batch(name: str):
    """The reference's batch: the tokens, an encoder-decoder's frames, a
    vision config's image embeddings."""
    batch = {"tokens": jnp.asarray(_tokens())}
    if _frames(name) is not None:
        batch["frames"] = jnp.asarray(_frames(name))
    if _images(name) is not None:
        batch["image_embeds"] = jnp.asarray(_images(name))
    return batch


@functools.lru_cache(maxsize=None)
def _serve_reference(name: str):
    """A serving-only case on the global batch: ({"params": its initial
    values (numpy; every bias nonzero)}, the prefill's and each decode
    step's logits, the greedy tokens fed to the decode steps)."""
    jcfg = _jcfg(name)
    model = jax_build_model(jcfg)
    values = jax.tree.map(np.asarray, split_params(model.init(jax.random.key(0)))[0])
    _nonzero_biases(values, np.random.default_rng(11))
    params = jax.tree.map(jnp.asarray, values)
    batch = {"tokens": jnp.asarray(_tokens())}
    if _frames(name) is not None:
        batch["frames"] = jnp.asarray(_frames(name))
    lg, cache = jax.jit(lambda p, b: model.prefill(p, b, cache_len=S + STEPS))(params, batch)
    decode = jax.jit(model.decode)
    logits, feed = [np.asarray(lg)], []
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(lg, -1)).astype(np.int32)
        feed.append(tok)
        lg, cache = decode(params, jnp.asarray(tok[:, None]), jnp.int32(S + i), cache)
        logits.append(np.asarray(lg))
    return {"params": values}, logits, np.stack(feed)


@functools.lru_cache(maxsize=None)
def _tokens():
    return np.random.default_rng(3).integers(0, 512, (B, S), dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _reference(name: str):
    """The reference on the global batch: (its initial train state (numpy;
    qkv biases nonzero, an encoder-decoder's every bias), the prefill's and
    each decode step's logits, the greedy tokens fed to the decode steps
    (STEPS, B), the loss, the loss and the parameters by path after one
    ``make_train_step`` step)."""
    jcfg = _jcfg(name)
    model = jax_build_model(jcfg)
    ts, init, *_ = jax_make_train_step(model, lr=LR)
    state = jax.tree.map(np.asarray, init(jax.random.key(0)))
    if jcfg.encoder_layers:
        _nonzero_biases(state["params"], np.random.default_rng(11))
    elif jcfg.qkv_bias:
        rng = np.random.default_rng(11)
        attn = state["params"]["stack0"]["b0"]["attn"]
        for key in BIAS_KEYS:
            attn[key] = 0.5 * rng.standard_normal(attn[key].shape).astype(np.float32)
    params = jax.tree.map(jnp.asarray, state["params"])
    batch = _batch(name)
    P = S + jcfg.num_img_tokens  # the prefilled positions
    lg, cache = jax.jit(lambda p, b: model.prefill(p, b, cache_len=P + STEPS))(params, batch)
    decode = jax.jit(model.decode)
    logits, feed = [np.asarray(lg)], []
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(lg, -1)).astype(np.int32)
        feed.append(tok)
        lg, cache = decode(params, jnp.asarray(tok[:, None]), jnp.int32(P + i), cache)
        logits.append(np.asarray(lg))
    loss = float(jax.jit(model.loss)(params, batch))
    new, m = jax.jit(ts)(jax.tree.map(jnp.asarray, state), batch)
    stepped = {"/".join(p): np.asarray(v) for p, v in _paths(new["params"])}
    return state, logits, np.stack(feed), loss, float(m["loss"]), stepped


@functools.lru_cache(maxsize=None)
def _ref_specs(name: str, shape):
    """{reference path: (the reference's spec on a mesh of ``shape``, the
    global shape)} of every parameter leaf (stacked: a leading "layers")."""
    rules = JaxMeshRules(_fake_mesh(shape))
    values, axes = split_params(jax_build_model(_jcfg(name)).abstract_init())
    shapes = dict(_paths(values))
    return {"/".join(p): (tuple(rules.spec_for(tuple(ax), tuple(shapes[p].shape))),
                          tuple(shapes[p].shape))
            for p, ax in _paths(axes)}


class FakeMesh:
    """tests/test_sharding_roofline.py's stand-in for a jax Mesh."""

    def __init__(self, shape: MeshShape):
        self.shape = shape.shape
        self.axis_names = shape.axis_names


def _fake_mesh(shape) -> FakeMesh:
    return FakeMesh(MeshShape(("data", "model"), tuple(shape)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{(mesh, case): [per-rank results]}: one spawn of 2 processes, one of 4."""
    cases = []
    for name, (arch, change) in CASES.items():
        state, _, feed, *_ = _reference(name)
        cases.append(dict(name=name, arch=arch, change=change, state=state, feed=feed,
                          frames=_frames(name), images=_images(name)))
    for name, (arch, change) in SERVE_CASES.items():
        state, _, feed = _serve_reference(name)
        cases.append(dict(name=name, arch=arch, change=change, state=state, feed=feed,
                          frames=_frames(name), train=False))
    out = {}
    for world in (2, 4):
        meshes = [m for m in MESHES if m[0] * m[1] == world]
        got = torch_mesh.run(torch_mesh.tp_cases, world, tmp_path_factory.mktemp(f"tp{world}"),
                             meshes, cases, _tokens(), STEPS, LR)
        for key in got[0]:
            out[key] = [r[key] for r in got]
    return out


def _rows(coord, shape):
    n = B // shape[0]
    return slice(coord["data"] * n, (coord["data"] + 1) * n)


@pytest.mark.parametrize("name", ALL_CASES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_prefill_and_decode_match_jax(ranks, mesh, name):
    """Each rank's prefill logits and four decode steps' logits (the whole
    vocabulary, gathered over "model") on its rows of the batch, and their
    greedy tokens, against the reference's."""
    _, logits, feed, *_ = (_serve_reference if name in SERVE_CASES else _reference)(name)
    for r in ranks[(mesh, name)]:
        rows = _rows(r["coord"], mesh)
        for step, (got, want) in enumerate(zip(r["logits"], logits)):
            got = got.numpy()
            assert got.shape == want[rows].shape, step
            assert float(np.abs(got - want[rows]).max()) <= TOL, (step, r["coord"])
            if step < STEPS:
                np.testing.assert_array_equal(got.argmax(-1), feed[step][rows])


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_loss_and_train_step_match_jax(ranks, mesh, name):
    """The global batch's loss on every rank, and each rank's block of every
    parameter after one AdamW step, against the reference's step."""
    _, _, _, loss, step_loss, stepped = _reference(name)
    specs = _ref_specs(name, mesh)
    rules = MeshRules(MeshShape(("data", "model"), mesh))
    for r in ranks[(mesh, name)]:
        assert abs(r["loss"] - loss) <= TOL, (r["loss"], loss)
        assert abs(r["step_loss"] - step_loss) <= TOL, (r["step_loss"], step_loss)
        assert set(r["params"]) == set(stepped)
        for path, w in stepped.items():
            want = rules.local_shard(torch.tensor(w), specs[path][0], r["coord"]).numpy()
            got = r["params"][path].numpy()
            assert got.shape == want.shape, path
            assert float(np.abs(got - want).max()) <= TOL, (path, float(np.abs(got - want).max()))


@pytest.mark.parametrize("name", ALL_CASES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_leaf_shapes_are_the_reference_spec_slices(ranks, mesh, name):
    """Each rank's leaf shapes are the reference spec's slices: the global
    shape divided by the sizes of the axes each dim lies on; and a leaf the
    reference splits is split here."""
    sizes = dict(zip(("data", "model"), mesh))
    for r in ranks[(mesh, name)]:
        for path, (spec, shape) in _ref_specs(name, mesh).items():
            local = tuple(n // int(np.prod([sizes[a] for a in
                                            ((e,) if isinstance(e, str) else e or ())]))
                          for n, e in zip(shape, spec))
            assert tuple(r["params"][path].shape) == local, (path, spec)


def _port_meshes():
    out = {f"{m[0]}x{m[1]}": MeshShape(("data", "model"), m) for m in MESHES}
    out["single-pod"] = make_production_mesh()
    out["multi-pod"] = make_production_mesh(multi_pod=True)
    return out


@pytest.mark.parametrize("mesh", _port_meshes())
@pytest.mark.parametrize("arch", sorted(all_archs()))
def test_run_specs_equal_the_reference_rules(arch, mesh):
    """``run_specs`` is the reference rules' spec of every parameter leaf of
    every ported config at full width, on the production meshes and the
    test meshes: no leaf stays whole where the reference splits it."""
    shape = _port_meshes()[mesh]
    cfg = get_arch(arch)
    jrules = JaxMeshRules(FakeMesh(shape), fsdp=cfg.fsdp)
    values, axes = split_params(jax_build_model(jax_get_arch(arch)).abstract_init())
    shapes = dict(_paths(values))
    want = {p: tuple(jrules.spec_for(tuple(ax), tuple(shapes[p].shape)))
            for p, ax in _paths(axes)}
    got = leaf_groups(build_model(cfg).run_specs(MeshRules(shape, fsdp=cfg.fsdp)),
                      _stacks_for(cfg))
    assert {p for p, _, _ in got} == set(want)
    for path, group, stacked in got:
        for spec in group:
            assert ((None,) + spec if stacked else spec) == want[path], path
