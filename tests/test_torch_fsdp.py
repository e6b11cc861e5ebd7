"""FSDP of the dense leaves (``sharding/fsdp.py``) and the optimizers'
whole-leaf statistics under ``MeshRules`` (``train.optim.LeafLayout``) on
gloo meshes of CPU processes, against the JAX package.

The rules are ``fsdp=True`` on the meshes (2, 1) and (2, 2): every "embed",
"mlp", "expert_mlp" dim that the first pass leaves whole lies over "data",
so each rank holds half of nearly every leaf, and each block gathers its
leaves at its entry. Each rank runs ``prefill``, four decode steps and
``loss`` on its shards and its data shard of the batch, then one train
step from the reference's initial state for each of: AdamW, Adafactor, and
the int8 gradient compression with the config's own optimizer
(``tests/torch_mesh.py::tp_cases``). The reference runs the same steps on
the global batch on one device (XLA's partitioner changes no value under
rules; the manual MoE path's loss is the mean over the data shards of the
reference's, its aux term being each shard's). Each rank's shards are held
against the slices of the reference's result by the reference's specs.

Tolerances, float32: 1e-5 (logits, losses, parameters; the optimizer state
within 1e-5 of each leaf's largest magnitude). The compressed step rounds
g / scale to an integer; where g / scale lies within the float32 noise of
the data sum's order of a half-integer, the two sides may round apart, so
an element's error feedback may differ by one int8 step of its leaf's
scale, and its parameter by the optimizer's whole move: at most ``FLIPS``
elements of a float32 case may do so. A key bias ("bk") has a gradient of
zero (the softmax is invariant to it), so both sides step on rounding
noise: its state is not compared, and its update is held within the
largest move either optimizer can make, 2 lr sqrt(n) (Adafactor clips the
update's RMS to 1).

kimi-k2 (bfloat16 masters, at test_torch_kimi.py's learning rate 1e-2)
keeps ``tests/test_torch_kimi.py``'s limits: logits 1e-4, loss 1e-5, each
updated master within one bfloat16 step of the new value plus 2^-6 of the
reference's move, the statistics within 2^-6 relative. Its gradients are
bfloat16, and each rank's part of a gradient is summed over the data ranks
in bfloat16 (as the reference's own partitioner sums them), one rounding
more than the reference's single-device gradient, whose elements near zero
may then change sign. So a few of a leaf's masters may lie beyond that
limit, by at most one bfloat16 step more and the optimizer's whole move:
at most 1 % of a leaf's elements in the AdamW and Adafactor steps. The
statistics (AdamW's moments, Adafactor's factors) are held within 2^-5 of
their leaf's largest magnitude: a gradient's bfloat16 step is 2^-7 of it,
the sum of two rounded parts doubles that and a square doubles it again.
Every element of the compressed bfloat16 gradient may round to the
neighbouring int8 step, so its error feedback is held within one int8
step plus 2^-7 of the largest |g + e|, and at most 1/8 of a leaf's masters
may lie beyond the limit (the step's Adafactor statistics move with
them). A last test holds Adafactor in pieces under rules against the
whole leaf under rules."""
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
from repro.train.optim import compress_grads_int8 as jax_compress
from repro.train.optim import init_error_fb as jax_init_error_fb
from repro.train.optim import make_optimizer as jax_make_optimizer
from repro.train.step import make_train_step as jax_make_train_step
from repro.utils.tree import split_params
from repro_torch.sharding.rules import MeshRules, MeshShape
from repro_torch.train.optim import _get, _paths

torch.set_num_threads(2)

TOL = 1e-5
LR = 1e-4
LR_BF16 = 1e-2  # tests/test_torch_kimi.py's: a bfloat16 master moves by a few steps
B, S, STEPS = 4, 16, 4
MESHES = ((2, 1), (2, 2))
# name -> (arch, change to its reduced config)
CASES = {
    "gemma": ("gemma-2b", {}),
    "mha": ("deepseek-7b", dict(n_kv_heads=4)),
    "rwkv6": ("rwkv6-1.6b", {}),
    "recurrentgemma": ("recurrentgemma-9b", {}),
    "olmoe": ("olmoe-1b-7b", {}),
    "olmoe-manual": ("olmoe-1b-7b", dict(moe_impl="manual")),
    "whisper": ("whisper-tiny", {}),
    "phi": ("phi-3-vision-4.2b", {}),
    "kimi": ("kimi-k2-1t-a32b", {}),
}
BF16_CASES = ("kimi",)
# label -> (optimizer, int8 compression); None: the config's own optimizer
STEP_KINDS = {"adamw": ("adamw", False), "adafactor": ("adafactor", False),
              "compress": (None, True)}
# elements of a case's compressed step that may round to the neighbouring
# int8 step (see the module docstring)
FLIPS = 4
# the optimizer state (the gradients' statistics) of a float32 case: within
# the gradients' tolerance of tests/test_torch_whisper_train.py, 1e-4 of
# the leaf's largest magnitude
STATE_TOL = 1e-4
# the share of a bfloat16 leaf's masters that may lie beyond its limit
BF16_OUTLIERS = {"adamw": 1 / 100, "adafactor": 1 / 100, "compress": 1 / 8}
NOISE_LEAVES = ("bk",)
BIAS_KEYS = ("bq", "bk", "bv", "bi", "bo", "bias")


def _jcfg(name: str):
    arch, change = CASES[name]
    return dataclasses.replace(jax_get_arch(arch).reduced(), fsdp=True, **change)


def _optimizer(name: str, label: str) -> str:
    return STEP_KINDS[label][0] or _jcfg(name).optimizer


def _lr(name: str) -> float:
    return LR_BF16 if name in BF16_CASES else LR


@functools.lru_cache(maxsize=None)
def _tokens():
    return np.random.default_rng(3).integers(0, 512, (B, S), dtype=np.int32)


def _extra(name: str, key: str, seed: int, n: int):
    jcfg = _jcfg(name)
    if not n:
        return None
    return np.random.default_rng(seed).standard_normal((B, n, jcfg.d_model)).astype(np.float32)


def _batch(name: str, rows=slice(None)):
    jcfg = _jcfg(name)
    batch = {"tokens": jnp.asarray(_tokens()[rows])}
    frames = _extra(name, "frames", 5, jcfg.encoder_seq if jcfg.encoder_layers else 0)
    images = _extra(name, "images", 6, jcfg.num_img_tokens)
    if frames is not None:
        batch["frames"] = jnp.asarray(frames[rows])
    if images is not None:
        batch["image_embeds"] = jnp.asarray(images[rows])
    return batch


def _nonzero_biases(tree, rng):
    for key, val in tree.items():
        if isinstance(val, dict):
            _nonzero_biases(val, rng)
        elif key in BIAS_KEYS:
            tree[key] = (0.5 * rng.standard_normal(val.shape)).astype(val.dtype)


def _ref_step(name: str, label: str, state):
    """One reference step from ``state`` on the global batch: (loss, new
    state as numpy). The manual MoE path's loss is the mean over the two
    data shards of the reference's loss."""
    jcfg = dataclasses.replace(_jcfg(name), optimizer=_optimizer(name, label))
    model = jax_build_model(jcfg)
    compress = STEP_KINDS[label][1]
    batch = _batch(name)
    if jcfg.moe_impl != "manual" and not compress:
        ts, *_ = jax_make_train_step(model, lr=_lr(name))
        new, m = jax.jit(ts)(jax.tree.map(jnp.asarray, state), batch)
        return float(m["loss"]), jax.tree.map(np.asarray, new)
    _, opt_update = jax_make_optimizer(jcfg.optimizer, lr=_lr(name))

    def step(st):
        """``make_train_step``'s step; the compressed one also gives each
        leaf's max |g + e|, 127 int8 steps of its scale."""
        def loss(p):
            if jcfg.moe_impl != "manual":
                return model.loss(p, batch)
            return jnp.mean(jnp.stack([model.loss(p, {"tokens": t})
                                       for t in jnp.split(batch["tokens"], 2)]))

        value, grads = jax.value_and_grad(loss)(st["params"])
        new = {"step": st["step"] + 1}
        if compress:
            new["amax"] = jax.tree.map(lambda g, e: jnp.max(jnp.abs(g.astype(jnp.float32) + e)),
                                       grads, st["efb"])
            grads, new["efb"] = jax_compress(grads, st["efb"])
        new["params"], new["opt"] = opt_update(st["params"], grads, st["opt"], st["step"])
        return new, value

    new, value = jax.jit(step)(jax.tree.map(jnp.asarray, state))
    return float(value), jax.tree.map(np.asarray, new)


@functools.lru_cache(maxsize=None)
def _reference(name: str):
    """The reference on the global batch: ({label: its initial state}, the
    prefill's and each decode step's logits, the greedy tokens fed to the
    decode steps (STEPS, B), the loss, {label: (step loss, state after the
    step)})."""
    jcfg = _jcfg(name)
    model = jax_build_model(jcfg)
    values = jax.tree.map(np.asarray, split_params(model.init(jax.random.key(0)))[0])
    if jcfg.qkv_bias or jcfg.encoder_layers:
        _nonzero_biases(values, np.random.default_rng(11))
    states = {}
    for label, (_, compress) in STEP_KINDS.items():
        opt_init, _ = jax_make_optimizer(_optimizer(name, label), lr=LR)
        params = jax.tree.map(jnp.asarray, values)
        st = {"params": values, "opt": jax.tree.map(np.asarray, opt_init(params)),
              "step": np.int32(0)}
        if compress:
            st["efb"] = jax.tree.map(np.asarray, jax_init_error_fb(params))
        states[label] = st
    params = jax.tree.map(jnp.asarray, values)
    batch = _batch(name)
    P = S + jcfg.num_img_tokens
    lg, cache = jax.jit(lambda p, b: model.prefill(p, b, cache_len=P + STEPS))(params, batch)
    decode = jax.jit(model.decode)
    logits, feed = [np.asarray(lg)], []
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(lg, -1)).astype(np.int32)
        feed.append(tok)
        lg, cache = decode(params, jnp.asarray(tok[:, None]), jnp.int32(P + i), cache)
        logits.append(np.asarray(lg))
    if jcfg.moe_impl == "manual":
        loss = float(np.mean([float(jax.jit(model.loss)(params, _batch(name, rows)))
                              for rows in (slice(0, B // 2), slice(B // 2, B))]))
    else:
        loss = float(jax.jit(model.loss)(params, batch))
    stepped = {label: _ref_step(name, label, st) for label, st in states.items()}
    return states, logits, np.stack(feed), loss, stepped


class FakeMesh:
    """tests/test_sharding_roofline.py's stand-in for a jax Mesh."""

    def __init__(self, shape: MeshShape):
        self.shape = shape.shape
        self.axis_names = shape.axis_names


def _rules(shape):
    mesh = MeshShape(("data", "model"), tuple(shape))
    return JaxMeshRules(FakeMesh(mesh), fsdp=True), MeshRules(mesh, fsdp=True)


@functools.lru_cache(maxsize=None)
def _ref_specs(name: str, shape, label: str = "adamw"):
    """{path: the reference's spec on a (shape) mesh with FSDP} of every
    parameter leaf (by its path) and of every leaf of ``label``'s optimizer
    state ("opt/<param path>/<key>") and error feedback ("efb/<param
    path>"), by the rule of the reference's ``state_shardings``: a state
    leaf of its parameter's shape lies as it, ``vr`` / ``vc`` by the axes
    left after their reduction, anything else whole. (Its NamedShardings
    need a mesh of devices; the spec_for of its rules needs none.)"""
    jrules, _ = _rules(shape)
    jcfg = dataclasses.replace(_jcfg(name), optimizer=_optimizer(name, label))
    values, axes = split_params(jax_build_model(jcfg).abstract_init())
    opt_init, _ = jax_make_optimizer(jcfg.optimizer)
    opt = jax.eval_shape(opt_init, values)
    out = {}
    for path, ax in _paths(axes):
        full = tuple(_get(values, path).shape)
        spec = lambda a, shp: tuple(jrules.spec_for(tuple(a), tuple(shp)))
        key = "/".join(path)
        out[key] = spec(ax, full)
        for k, leaf in _get(opt, path).items():
            shp = tuple(leaf.shape)
            out[f"opt/{key}/{k}"] = (
                spec(ax, shp) if shp == full else spec(ax[:-1], shp) if shp == full[:-1] else
                spec(ax[:-2] + ax[-1:], shp) if shp == full[:-2] + full[-1:] else
                (None,) * len(shp))
        if STEP_KINDS[label][1]:
            out[f"efb/{key}"] = out[key]
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{(mesh, case): [per-rank results]}: one spawn of 2 processes, one of 4."""
    cases = []
    for name, (arch, change) in CASES.items():
        states, _, feed, *_ = _reference(name)
        jcfg = _jcfg(name)
        frames = _extra(name, "frames", 5, jcfg.encoder_seq if jcfg.encoder_layers else 0)
        cases.append(dict(name=name, arch=arch, change=dict(change, fsdp=True),
                          state=states["adamw"], feed=feed, frames=frames,
                          images=_extra(name, "images", 6, jcfg.num_img_tokens),
                          steps={label: (_optimizer(name, label), STEP_KINDS[label][1], st)
                                 for label, st in states.items()}, lr=_lr(name)))
    out = {}
    for world in (2, 4):
        meshes = [m for m in MESHES if m[0] * m[1] == world]
        got = torch_mesh.run(torch_mesh.tp_cases, world, tmp_path_factory.mktemp(f"fsdp{world}"),
                             meshes, cases, _tokens(), STEPS, LR, True)
        for key in got[0]:
            out[key] = [r[key] for r in got]
    return out


def _rows(coord, shape):
    n = B // shape[0]
    return slice(coord["data"] * n, (coord["data"] + 1) * n)


def _slice(w, spec, coord, shape) -> np.ndarray:
    return _rules(shape)[1].local_shard(torch.from_numpy(np.asarray(w, np.float32)), spec,
                                        coord).numpy()


def _bf16_ulp(w: np.ndarray) -> np.ndarray:
    """One bfloat16 step at each value of ``w`` (8 significant bits)."""
    a = np.abs(w.astype(np.float32))
    return np.where(a > 0, 2.0 ** (np.floor(np.log2(np.where(a > 0, a, 1.0))) - 7), 2.0 ** -133)


mesh_ids = pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")


@pytest.mark.parametrize("name", CASES)
@mesh_ids
def test_prefill_and_decode_match_jax(ranks, mesh, name):
    """Each rank's prefill logits and four decode steps' logits on its rows
    of the batch, every leaf gathered at its block's entry, and their
    greedy tokens, against the reference's."""
    _, logits, feed, *_ = _reference(name)
    tol = 1e-4 if name in BF16_CASES else TOL
    for r in ranks[(mesh, name)]:
        rows = _rows(r["coord"], mesh)
        for step, (got, want) in enumerate(zip(r["logits"], logits)):
            got = got.float().numpy()
            assert got.shape == want[rows].shape, step
            assert float(np.abs(got - want[rows]).max()) <= tol, (step, r["coord"])
            if step < STEPS:
                np.testing.assert_array_equal(got.argmax(-1), feed[step][rows])


@pytest.mark.parametrize("name", CASES)
@mesh_ids
def test_leaves_lie_over_the_data_axes(ranks, mesh, name):
    """Each rank's leaves are the slices of the reference's FSDP specs, and
    every leaf with an "embed" dim lies over "data" (by that dim, or by an
    "mlp" / "expert_mlp" dim before it)."""
    specs = _ref_specs(name, mesh)
    sizes = dict(zip(("data", "model"), mesh))
    values, axes = split_params(jax_build_model(_jcfg(name)).abstract_init())
    for path, ax in _paths(axes):
        key, shape = "/".join(path), tuple(_get(values, path).shape)
        spec = specs[key]
        if "embed" in ax:
            assert "data" in spec, (key, spec)
        local = tuple(n // int(np.prod([sizes[a] for a in
                                        ((e,) if isinstance(e, str) else e or ())]))
                      for n, e in zip(shape, spec))
        for r in ranks[(mesh, name)]:
            assert tuple(r["params"][key].shape) == local, (key, spec)


@pytest.mark.parametrize("label", STEP_KINDS)
@pytest.mark.parametrize("name", CASES)
@mesh_ids
def test_train_steps_match_jax(ranks, mesh, name, label):
    """The global loss on every rank, and each rank's block of every updated
    parameter, optimizer-state and error-feedback leaf, against the
    reference's step (limits in the module docstring)."""
    _, _, _, loss, stepped = _reference(name)
    step_loss, new = stepped[label]
    specs = _ref_specs(name, mesh, label)
    bf16, lr = name in BF16_CASES, _lr(name)
    # the largest move of an element in one step: AdamW's |u| <= 1 (+ decay),
    # Adafactor's RMS-clipped update, at most sqrt(n) in one element
    adafactor = _optimizer(name, label) == "adafactor"
    old = {"/".join(p): np.asarray(v, np.float32) for p, v in
           _paths(_reference(name)[0][label]["params"])}
    want = {"/".join(p): v for p, v in _paths(new["params"])}
    want_state = {f"{key}/" + "/".join(p): v for key in ("opt", "efb") if key in new
                  for p, v in _paths(new[key])}

    def whole_move(path):
        return 2 * lr * (np.sqrt(old[path].size) if adafactor else 1.0 + 0.01 * np.abs(
            old[path]).max())

    for r in ranks[(mesh, name)]:
        assert abs(r["loss"] - loss) <= TOL, (r["loss"], loss)
        got = r["steps"][label]
        assert abs(got["loss"] - step_loss) <= TOL, (got["loss"], step_loss)
        moved = {}  # leaf -> its elements whose int8 rounding went the other way
        if label == "compress":
            amax = {"/".join(p): float(v) for p, v in _paths(new["amax"])}
            for path, w in want_state.items():
                if not path.startswith("efb/"):
                    continue
                key = path[4:]
                if key.split("/")[-1] in NOISE_LEAVES:
                    continue
                w = _slice(w, specs[path], r["coord"], mesh)
                e = got["efb"][key].numpy()
                assert e.shape == w.shape, path
                # e = g + e0 - q scale: the gradient's own rounding, and an
                # int8 step more where q rounded the other way
                err, step = np.abs(e - w).reshape(-1), amax[key] / 127.0
                noise = (2.0 ** -7 if bf16 else TOL) * amax[key]
                moved[key] = np.flatnonzero(err > noise)
                assert float(np.max(err, initial=0.0)) <= step + noise, (path, err.max() / step)
            n_moved = sum(len(v) for v in moved.values())
            assert bf16 or n_moved <= FLIPS, {k: len(v) for k, v in moved.items() if len(v)}
        assert set(got["params"]) == set(want)
        for path, w in want.items():
            w32 = _slice(np.asarray(w, np.float32), specs[path], r["coord"], mesh)
            g = got["params"][path].float().numpy()
            assert g.shape == w32.shape, path
            err = np.abs(g - w32).reshape(-1)
            if path.split("/")[-1] in NOISE_LEAVES:
                assert float(err.max()) <= whole_move(path), path
                continue
            if bf16:
                o = _slice(old[path], specs[path], r["coord"], mesh)
                limit = (_bf16_ulp(w32) + 2.0 ** -6 * np.abs(w32 - o)).reshape(-1)
            else:
                limit = np.full(err.shape, TOL, np.float32)
            if len(moved.get(path, ())):
                limit = limit.copy()
                limit[moved[path]] += whole_move(path)
            bad = np.flatnonzero(err > limit)
            if bf16:  # see the module docstring
                assert len(bad) <= BF16_OUTLIERS[label] * err.size, (path, len(bad), err.size)
                beyond = limit[bad] + _bf16_ulp(w32).reshape(-1)[bad] + whole_move(path)
                assert np.all(err[bad] <= beyond), path
                continue
            assert not len(bad), (path, len(bad), float((err - limit).max()))
        for path, w in want_state.items():
            key = path[4:].rsplit("/", 1)[0]
            if path.startswith("efb/") or key.split("/")[-1] in NOISE_LEAVES:
                continue
            w = _slice(w, specs[path], r["coord"], mesh)
            g = got["opt"][path[4:]].numpy()
            assert g.shape == w.shape, path
            if bf16:
                rel = float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)
                assert rel <= 2.0 ** -5, (path, rel)
                continue
            err = np.abs(g - w).reshape(-1) / max(float(np.abs(w).max()), 1e-30)
            if label == "compress" and len(moved.get(key, ())):
                # AdamW's moments of an element whose gradient moved an int8 step
                err = np.delete(err, moved[key])
            assert float(np.max(err, initial=0.0)) <= STATE_TOL, (path, float(np.max(err)))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_adafactor_in_pieces_under_rules_equals_the_whole_leaf(tmp_path, mesh):
    """Adafactor under FSDP rules (kimi-k2 reduced, float32 masters: its
    stacked expert leaves of two layers, the embedding, the norms), two
    steps with the leaves read in pieces of 100 elements (blocks of whole
    rows, each statistic still reduced over the ranks once a leaf) against
    the same steps reading each leaf whole: the masters and the statistics
    within the rounding of sums in another order (tests/test_torch_kimi.py's
    limits for the update in pieces on one device)."""
    n = mesh[0] * mesh[1]
    ranks = torch_mesh.run(torch_mesh.adafactor_piece_cases, n, tmp_path, "kimi-k2-1t-a32b",
                           mesh, (100, 1 << 30), LR)
    for r in ranks:
        (small, st_small), (whole, st_whole) = r[100], r[1 << 30]
        assert set(small) == set(whole) and set(st_small) == set(st_whole)
        for path, b in whole.items():
            a, b = small[path].numpy(), b.numpy()
            assert np.all(np.abs(a - b) <= 1e-6 * np.abs(b) + 1e-5 * LR), path
        for path, b in st_whole.items():
            np.testing.assert_allclose(st_small[path].numpy(), b.numpy(), rtol=1e-5, atol=0,
                                       err_msg=path)
