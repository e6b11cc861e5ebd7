"""The mixture-of-experts FFN (``repro_torch.models.moe``) and olmoe-1b-7b
against the JAX package on the same numpy-seeded inputs.

The reference's ``reduced()`` makes olmoe drop-free (4 experts, top-2,
capacity factor 4.0), which hides the capacity drops, the order of tied
experts among 64 bf16 probabilities and the decode groups of one token.
So each layer test also runs a narrow variant with the real 64 experts,
top-8 and capacity factor 1.25 (a prefill group long enough to drop
slots), and its decode shape (B, 1, d), where every group is one token.
The layer's parameters are drawn with numpy at scales that make the
output O(1) (the init's 0.02 would put every bf16 output inside the
tolerance)."""
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
from repro.models import moe as JM
from repro.roofline import analysis as jax_analysis
from repro.train.step import make_train_step as jax_make_train_step
from repro.utils.tree import split_params
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.model_api import _chunked_ce, _stacks_for
from repro_torch.roofline import analysis
from repro_torch.train import optim
from repro_torch.train.step import make_train_step
from repro_torch.utils.tree import flatten, unflatten

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

ARCH = "olmoe-1b-7b"
# tests/test_moe.py's limits for the layer in float32; bf16 as
# tests/test_kernels.py's (atol and rtol)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the layer's cases: (batch, group size, n_experts, top_k, capacity_factor)
CASES = {
    "reduced": (2, 16, 4, 2, 4.0),  # the reference's reduced(): drop-free
    "narrow": (2, 64, 64, 8, 1.25),  # the real routing: C = 10, slots dropped
    "decode": (4, 1, 64, 8, 1.25),  # a decode step: groups of one token, C = 1
}
DTYPES = ("float32", "bfloat16")


def _cfgs(**change):
    """(reference config, port config): olmoe reduced, with ``change``."""
    return (dataclasses.replace(jax_get_arch(ARCH).reduced(), **change),
            dataclasses.replace(get_arch(ARCH).reduced(), **change))


def _layer_params(cfg, seed: int = 0, router_std: float = 1.0):
    """numpy float32 MoE parameters with the reference's names and shapes."""
    rng = np.random.default_rng(seed)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def normal(shape, std):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    p = {"router": normal((d, E), router_std / np.sqrt(d)),
         "wg": normal((E, d, f), 1 / np.sqrt(d)), "wu": normal((E, d, f), 1 / np.sqrt(d)),
         "wo": normal((E, f, d), 1 / np.sqrt(f))}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"wg": normal((d, fs), 1 / np.sqrt(d)), "wu": normal((d, fs), 1 / np.sqrt(d)),
                       "wo": normal((fs, d), 1 / np.sqrt(fs))}
    return p


def _to_torch(tree, dtype):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    return torch.tensor(tree, dtype=dtype)


def _to_jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), tree)


def _x(shape, seed: int = 1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_dropped(p, x, cfg) -> int:
    """The reference's dropped slots: ``_group_dispatch``'s keep mask, group
    by group, on the probabilities ``moe_apply_auto`` hands it."""
    logits = jnp.einsum("bsd,de->bse", x, p["router"].astype(x.dtype))
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1).astype(x.dtype)
    return sum(int(jnp.sum(~JM._group_dispatch(xg, pg, cfg)[1][3])) for xg, pg in zip(x, probs))


def _layer_both(case: str, dtype: str):
    """The layer on both sides: (reference y, aux, dropped), (port y, aux,
    plan) as float32 numpy / floats."""
    B, S, E, k, cf = CASES[case]
    jcfg, tcfg = _cfgs(n_experts=E, top_k=k, capacity_factor=cf, dtype=dtype)
    p, x = _layer_params(tcfg), _x((B, S, tcfg.d_model))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp, jx = _to_jax(p, jdt), jnp.asarray(x).astype(jdt)
    jy, jaux = JM.moe_apply(jp, jx, jcfg)
    tp, tx = _to_torch(p, tdt), torch.tensor(x).to(tdt)
    ty, taux = M.moe_apply(tp, tx, tcfg)
    plan, _ = M.route(tp, tx, tcfg)
    return ((np.asarray(jy.astype(jnp.float32)), float(jaux), _jax_dropped(jp, jx, jcfg)),
            (ty.float().numpy(), float(taux), plan))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_moe_apply_matches_jax(case, dtype):
    """y and the aux term against the reference's ``moe_apply``; the same
    slots dropped (at least one in the narrow prefill group, none in
    decode, where C = 1 holds a token's 8 distinct experts)."""
    (jy, jaux, jdropped), (ty, taux, plan) = _layer_both(case, dtype)
    B, S, E, k, _ = CASES[case]
    assert ty.shape == jy.shape == (B, S, 64)
    np.testing.assert_allclose(ty, jy, atol=TOL[dtype], rtol=TOL[dtype])
    assert abs(taux - jaux) <= TOL[dtype] * abs(jaux)
    assert int(plan.dropped) == jdropped
    if case == "narrow":
        assert plan.capacity == 10 and jdropped >= 1
    if case == "decode":
        assert plan.capacity == 1 and jdropped == 0
    assert float(np.abs(jy).max()) > 0.1  # an output the tolerance can tell from zero


def test_zero_router_ties_pick_the_first_experts():
    """A zero router makes all 64 probabilities equal: both sides choose
    experts 0-7 for every token, and with C = ceil(8 * 16 * 1.25 / 64) = 3
    each group keeps the first 3 tokens and drops the rest, alike."""
    B, S = 2, 16
    jcfg, tcfg = _cfgs(n_experts=64, top_k=8, capacity_factor=1.25)
    p = _layer_params(tcfg)
    p["router"][:] = 0.0
    x = _x((B, S, tcfg.d_model))
    tp, tx = _to_torch(p, torch.float32), torch.tensor(x)
    probs = torch.softmax((tx @ tp["router"]).float(), dim=-1)
    assert torch.equal(M.top_k(probs, 8), torch.arange(8).expand(B, S, 8))
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 8)
    assert np.array_equal(np.asarray(jidx), np.broadcast_to(np.arange(8), (B, S, 8)))
    plan, _ = M.route(tp, tx, tcfg)
    assert int(plan.dropped) == B * (S - 3) * 8 == _jax_dropped(_to_jax(p, jnp.float32),
                                                                jnp.asarray(x), jcfg)
    jy, _ = JM.moe_apply(_to_jax(p, jnp.float32), jnp.asarray(x), jcfg)
    ty, _ = M.moe_apply(tp, tx, tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL["float32"],
                               rtol=TOL["float32"])
    assert not ty[:, 3:].any()  # the dropped tokens: zero


def test_bf16_ties_from_random_weights_order_as_jax():
    """A weak random router puts the bf16 probabilities of 64 experts
    within a few bf16 steps of 1/64, so many are equal. On the same bf16
    probabilities the port's top-k picks what ``jax.lax.top_k`` picks, in its
    order (lower index first among equals), while ``torch.topk``'s order is
    left open; the layer then matches the reference."""
    B, S = 2, 64
    jcfg, tcfg = _cfgs(n_experts=64, top_k=8, capacity_factor=1.25, dtype="bfloat16")
    p, x = _layer_params(tcfg, router_std=0.05), _x((B, S, tcfg.d_model))
    tp, tx = _to_torch(p, torch.bfloat16), torch.tensor(x).to(torch.bfloat16)
    probs = torch.softmax((tx @ tp["router"]).float(), dim=-1).to(torch.bfloat16)
    ranked = torch.sort(probs.float(), dim=-1, descending=True).values
    ties_at_the_cut = int((ranked[..., 7] == ranked[..., 8]).sum())
    assert ties_at_the_cut >= B * S // 4  # the 8th and 9th largest tie often
    _, jidx = jax.lax.top_k(jnp.asarray(probs.float().numpy()).astype(jnp.bfloat16), 8)
    assert np.array_equal(M.top_k(probs, 8).numpy(), np.asarray(jidx))
    jy, _ = JM.moe_apply(_to_jax(p, jnp.bfloat16), jnp.asarray(x).astype(jnp.bfloat16), jcfg)
    ty, _ = M.moe_apply(tp, tx, tcfg)
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy.astype(jnp.float32)),
                               atol=TOL["bfloat16"], rtol=TOL["bfloat16"])


@pytest.mark.parametrize("case", ("reduced", "narrow"))
def test_moe_ref_matches_jax(case):
    """The dense oracle against the reference's ``moe_ref``; at the reduced
    (drop-free) size the dispatch path equals it too."""
    B, S, E, k, cf = CASES[case]
    jcfg, tcfg = _cfgs(n_experts=E, top_k=k, capacity_factor=cf)
    p, x = _layer_params(tcfg), _x((B, S, tcfg.d_model))
    want = np.asarray(JM.moe_ref(_to_jax(p, jnp.float32), jnp.asarray(x), jcfg))
    tp, tx = _to_torch(p, torch.float32), torch.tensor(x)
    got = M.moe_ref(tp, tx, tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=TOL["float32"], rtol=TOL["float32"])
    if case == "reduced":
        np.testing.assert_allclose(M.moe_apply(tp, tx, tcfg)[0].numpy(), want,
                                   atol=TOL["float32"], rtol=TOL["float32"])


def test_shared_expert_path_matches_jax():
    """n_shared_experts = 2: the shared swiglu (width 2 f) is added."""
    jcfg, tcfg = _cfgs(n_experts=64, top_k=8, capacity_factor=1.25, n_shared_experts=2)
    p, x = _layer_params(tcfg), _x((2, 32, tcfg.d_model))
    assert p["shared"]["wg"].shape == (64, 256)
    jy, _ = JM.moe_apply(_to_jax(p, jnp.float32), jnp.asarray(x), jcfg)
    tp = _to_torch(p, torch.float32)
    ty, _ = M.moe_apply(tp, torch.tensor(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL["float32"],
                               rtol=TOL["float32"])
    no_shared = {k: v for k, v in tp.items() if k != "shared"}
    y0, _ = M.moe_apply(no_shared, torch.tensor(x), dataclasses.replace(tcfg, n_shared_experts=0))
    assert float((ty - y0).abs().max()) > 0.1
    init = M.moe_init(torch.Generator().manual_seed(0), tcfg, "cpu", torch.float32)
    assert {k: v.shape for k, v in init["shared"].items()} == \
        {k: v.shape for k, v in p["shared"].items()}


@pytest.mark.parametrize("case", ("narrow", "decode"))
def test_layer_gradients_match_jax(case):
    """The gradients of sum(y * w) + aux with respect to x and every
    parameter against ``jax.grad``, float32, through the custom dispatch
    and combine backward (dropped slots in the narrow case): each within
    1e-4 of the reference's largest magnitude plus 1e-6."""
    B, S, E, k, cf = CASES[case]
    jcfg, tcfg = _cfgs(n_experts=E, top_k=k, capacity_factor=cf, n_shared_experts=1)
    p, x = _layer_params(tcfg), _x((B, S, tcfg.d_model))
    w = _x((B, S, tcfg.d_model), seed=2)

    def jloss(p_, x_):
        y, aux = JM.moe_apply(p_, x_, jcfg)
        return jnp.sum(y * w) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(_to_jax(p, jnp.float32), jnp.asarray(x))
    tp = _to_torch(p, torch.float32)
    leaves, treedef = flatten(tp)
    live = [t.requires_grad_() for t in leaves]
    tx = torch.tensor(x, requires_grad=True)
    y, aux = M.moe_apply(unflatten(treedef, live), tx, tcfg)
    grads = torch.autograd.grad(torch.sum(y * torch.tensor(w)) + aux, live + [tx])
    got = dict(optim._paths(unflatten(treedef, list(grads[:-1]))))
    want = dict(optim._paths(jax.tree.map(np.asarray, jgp)))
    assert set(got) == set(want)
    for path, g in list(got.items()) + [(("x",), grads[-1])]:
        wv = np.asarray(jgx) if path == ("x",) else want[path]
        limit = 1e-4 * float(np.abs(wv).max()) + 1e-6
        assert float(np.abs(g.numpy() - wv).max()) <= limit, path
    assert float(np.abs(want[("router",)]).max()) > 0  # the router learns (gates and aux)


def test_dispatch_tables_invert_each_other():
    """Every kept slot's buffer row names that slot back; an expert's rows
    fill from its first, in token order; a dropped slot reads the zero row."""
    B, S, E, k, cf = CASES["narrow"]
    _, tcfg = _cfgs(n_experts=E, top_k=k, capacity_factor=cf)
    p, x = _layer_params(tcfg), _x((B, S, tcfg.d_model))
    plan, _ = M.route(_to_torch(p, torch.float32), torch.tensor(x), tcfg)
    R, T = E * B * plan.capacity, B * S
    assert plan.slot_row.shape == (T, k) and plan.row_slot.shape == (R,)
    slots = torch.arange(T * k).view(T, k)
    kept = plan.slot_row < R
    assert int((~kept).sum()) == int(plan.dropped) > 0
    assert torch.equal(plan.row_slot[plan.slot_row[kept]], slots[kept])
    filled = plan.row_slot < T * k
    assert int(filled.sum()) == T * k - int(plan.dropped)
    rows = filled.view(E, B, plan.capacity)
    assert torch.equal(rows, rows.cummin(dim=-1).values)  # no gap before a filled row
    tok = torch.div(plan.row_slot.view(E, B, -1), k, rounding_mode="floor")
    assert bool(torch.all(torch.where(rows[..., 1:], tok[..., 1:] > tok[..., :-1], True)))


def test_forward_and_backward_give_the_same_bits_twice():
    """Two calls on the same inputs, bf16 with dropped slots: the same bits
    in y, aux and every gradient (``chip_smoke.py`` checks it on the card)."""
    B, S, E, k, cf = CASES["narrow"]
    _, tcfg = _cfgs(n_experts=E, top_k=k, capacity_factor=cf, dtype="bfloat16")
    p, x = _layer_params(tcfg), _x((B, S, tcfg.d_model))

    def run():
        tp = {kk: v.requires_grad_() for kk, v in _to_torch(p, torch.bfloat16).items()}
        tx = torch.tensor(x).to(torch.bfloat16).requires_grad_()
        y, aux = M.moe_apply(tp, tx, tcfg)
        return [y, aux] + list(torch.autograd.grad(y.float().sum() + aux, [tx, *tp.values()]))

    assert all(torch.equal(a, b) for a, b in zip(run(), run()))


def test_manual_impl_is_refused():
    """``moe_impl="manual"`` is no longer refused: without rules (no mesh)
    ``moe_apply`` takes the auto path, bit for bit, as the reference's
    dispatcher does, and ``build_model`` accepts the config (the manual path
    itself: ``tests/test_torch_moe_manual.py``)."""
    B, S, E, k, cf = CASES["narrow"]
    _, tcfg = _cfgs(n_experts=E, top_k=k, capacity_factor=cf, dtype="bfloat16")
    mcfg = dataclasses.replace(tcfg, moe_impl="manual")
    tp = _to_torch(_layer_params(tcfg), torch.bfloat16)
    tx = torch.tensor(_x((B, S, tcfg.d_model))).to(torch.bfloat16)
    assert not M.uses_manual(mcfg, None)
    y, aux = M.moe_apply(tp, tx, mcfg)
    y0, aux0 = M.moe_apply(tp, tx, tcfg)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)
    assert build_model(mcfg).cfg.moe_impl == "manual"


def test_olmoe_config_and_param_count_match_jax():
    jcfg, tcfg = jax_get_arch(ARCH), get_arch(ARCH)
    assert dataclasses.asdict(tcfg).items() <= dataclasses.asdict(jcfg).items()
    assert (tcfg.n_experts, tcfg.top_k, tcfg.capacity_factor, tcfg.moe_impl) == (64, 8, 1.25,
                                                                                 "auto")
    assert analysis.param_count(tcfg) == jax_analysis.param_count(jcfg)
    assert analysis.param_count(tcfg)["total"] == 2 * 50304 * 2048 + 16 * (
        4 * 2048 ** 2 + 2048 * 64 + 64 * 3 * 2048 * 1024)
    r = tcfg.reduced()
    assert (r.n_experts, r.top_k, r.capacity_factor) == (4, 2, 4.0)
    assert dataclasses.asdict(r).items() <= dataclasses.asdict(jcfg.reduced()).items()


# ---------------------------------------------------------------------------
# olmoe-1b-7b as a model: logits, loss, gradients, a train step, the CLIs
# ---------------------------------------------------------------------------

# the narrow variant: reduced(), then the real head dim, MHA, the real vocab
# and the real routing (64 experts, top-8, capacity factor 1.25: a prompt
# group of 16 tokens drops slots, C = 3)
NARROW = dict(n_heads=4, n_kv_heads=4, head_dim=128, vocab=50304, n_experts=64, top_k=8,
              capacity_factor=1.25)
SIZES = ("reduced", "narrow")
B, S, STEPS = 2, 16, 3
LOGITS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # tests/test_torch_model.py
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _model_cfgs(size: str, **change):
    return _cfgs(**({**NARROW, **change} if size == "narrow" else change))


@functools.lru_cache(maxsize=None)
def _values(size: str):
    jcfg, _ = _model_cfgs(size)
    values, _ = split_params(jax_build_model(jcfg).init(jax.random.key(0)))
    return jax.tree.map(np.asarray, values)


def _tokens(vocab: int, seed: int = 7):
    return np.random.default_rng(seed).integers(0, vocab, (B, S), dtype=np.int32)


def _run_both(size: str, dtype: str):
    """Prefill then STEPS decode steps on both sides, both fed the
    reference's greedy token: [(reference logits, port logits)]."""
    jcfg, tcfg = _model_cfgs(size, dtype=dtype)
    values = _values(size)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    params = convert.from_jax_values(values, tcfg)
    jvalues = jax.tree.map(jnp.asarray, values)
    prompt = _tokens(tcfg.vocab)
    cache_len = S + STEPS
    jl, jc = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, cache_len=cache_len))(
        jvalues, jnp.asarray(prompt))
    jdecode = jax.jit(lambda p, t, pos, c: jmodel.decode(p, t, pos, c))
    with torch.inference_mode():
        tl, tc = tmodel.prefill(params, torch.from_numpy(prompt).long(), cache_len=cache_len)
        pairs = [(np.asarray(jl.astype(jnp.float32)), tl.float().numpy())]
        for i in range(STEPS):
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
            jl, jc = jdecode(jvalues, jnp.asarray(tok), jnp.int32(S + i), jc)
            tl, tc = tmodel.decode(params, torch.from_numpy(tok).long(), S + i, tc)
            pairs.append((np.asarray(jl.astype(jnp.float32)), tl.float().numpy()))
    return tcfg, pairs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("size", SIZES)
def test_olmoe_prefill_and_decode_match_jax(size, dtype):
    ops.reset_launch_counts()
    tcfg, pairs = _run_both(size, dtype)
    for step, (want, got) in enumerate(pairs):
        assert got.shape == want.shape == (B, tcfg.vocab)
        np.testing.assert_allclose(got, want, atol=LOGITS_TOL[dtype], rtol=LOGITS_TOL[dtype],
                                   err_msg=f"step {step}")
        if dtype == "float32":
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1), err_msg=f"step {step}")
    assert not any(ops.launch_counts().values())  # the CPU launches no kernel


def test_olmoe_narrow_prompt_drops_slots():
    """The narrow model's prompt groups overflow an expert's capacity (the
    parity above runs with drops), its decode groups never do."""
    _, tcfg = _model_cfgs("narrow")
    params = convert.from_jax_values(_values("narrow"), tcfg)
    x = torch.nn.functional.embedding(torch.from_numpy(_tokens(tcfg.vocab)).long(),
                                      params["embed"])
    plan, _ = M.route(params["layers"][0]["ffn"], x, tcfg)
    assert plan.capacity == 3 and int(plan.dropped) > 0
    assert M.capacity(tcfg, 1) == 1


def _ref_layout(tree, cfg):
    return {path: np.stack([t.detach().numpy() for t in ts]) if stacked
            else ts[0].detach().numpy()
            for path, ts, stacked in optim.leaf_groups(tree, _stacks_for(cfg))}


@pytest.mark.parametrize("size", SIZES)
def test_olmoe_loss_and_grads_match_jax(size):
    """``ModelDef.loss`` (cross-entropy + 0.01 x the aux terms, through the
    checkpointed blocks) and every gradient leaf, the router and the
    experts' among them, against ``jax.grad``, float32."""
    jcfg, tcfg = _model_cfgs(size)
    values = _values(size)
    tokens = _tokens(tcfg.vocab, seed=3)
    jmodel = jax_build_model(jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda v: jmodel.loss(v, {"tokens": jnp.asarray(tokens)})))(
            jax.tree.map(jnp.asarray, values))
    params = convert.from_jax_values(values, tcfg, param_dtype=torch.float32)
    leaves, treedef = flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    tmodel = build_model(tcfg)
    loss = tmodel.loss(unflatten(treedef, live), {"tokens": tokens})
    grads = unflatten(treedef, list(torch.autograd.grad(loss, live)))
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_TOL
    # the aux terms flow out of the checkpointed blocks as they do without remat
    plain = build_model(dataclasses.replace(tcfg, remat=False))
    assert float(plain.loss(params, {"tokens": tokens})) == float(loss.detach())
    got = _ref_layout(grads, tcfg)
    want = dict(optim._paths(jax.tree.map(np.asarray, jgrads)))
    assert set(got) == set(want)
    assert ("stack0", "b0", "ffn", "router") in want
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        limit = GRAD_RTOL * float(np.max(np.abs(w))) + GRAD_ATOL
        assert float(np.max(np.abs(g - w))) <= limit, (path, float(np.max(np.abs(g - w))), limit)


def test_olmoe_aux_term_enters_the_loss():
    """The loss is the cross-entropy plus 0.01 x the layers' aux terms summed
    in layer order, bit for bit."""
    _, tcfg = _model_cfgs("reduced")
    params = convert.from_jax_values(_values("reduced"), tcfg)
    tokens = torch.from_numpy(_tokens(tcfg.vocab, seed=3)).long()
    model = build_model(tcfg)
    positions = torch.arange(S, dtype=torch.int32).expand(B, S)
    with torch.no_grad():
        loss = model.loss(params, {"tokens": tokens})
        x, total = model._embed(params, tokens), None
        for kind, lp in zip(model.kinds, params["layers"]):
            x, a = model._block_train(kind, lp, x, positions)
            total = a if total is None else total + a
        h = L.norm_apply(params["final_ln"], x)
        labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        mask = torch.ones((B, S))
        mask[:, -1] = 0.0
        ce = _chunked_ce(h, model._head(params, h.dtype), labels, mask)
    assert total.dtype == torch.float32 and float(total) > 0
    assert float(loss) == float(ce + 0.01 * total)


def test_olmoe_adamw_train_step_matches_jax():
    """One AdamW step from the reference's state converted by
    ``convert.train_state_from_jax`` (the router and the experts with their
    expert axis first, in the params and the moments): the loss and the
    updated parameters."""
    jcfg, tcfg = _model_cfgs("reduced")
    lr = 1e-3
    jts, jinit, *_ = jax_make_train_step(jax_build_model(jcfg), lr=lr)
    jstate = jinit(jax.random.key(0))
    tstate = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg)
    ffn = tstate["params"]["layers"][0]["ffn"]
    assert ffn["wg"].shape == (4, 64, 128) and ffn["wo"].shape == (4, 128, 64)
    assert ffn["router"].shape == (64, 4) and ffn["router"].dtype == torch.float32
    assert "router" in tstate["opt"]["stack0"]["b0"]["ffn"]
    tokens = _tokens(tcfg.vocab, seed=5)
    jnew, jm = jax.jit(jts)(jstate, {"tokens": jnp.asarray(tokens)})
    ts, _ = make_train_step(build_model(tcfg), lr=lr)
    tnew, tm = ts(tstate, {"tokens": tokens})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL
    params = _ref_layout(tnew["params"], tcfg)
    want = dict(optim._paths(jax.tree.map(np.asarray, jnew["params"])))
    assert set(params) == set(want)
    for path, w in want.items():
        # a step moves a parameter by about lr; a gradient near zero may flip
        assert np.all(np.abs(params[path] - w) <= 2 * lr + 1e-6), path
    moved = np.abs(params[("stack0", "b0", "ffn", "wg")] -
                   np.asarray(jstate["params"]["stack0"]["b0"]["ffn"]["wg"]))
    assert float(moved.max()) > 0.5 * lr


def test_olmoe_launch_serve_and_train_on_cpu(capsys):
    """``launch.serve`` and ``launch.train`` take olmoe through the same entry
    points as the other families (reduced, ``--device cpu``)."""
    rc = serve.main(["--arch", ARCH, "--device", "cpu", "--json", "--batch", "2",
                     "--prompt-len", "12", "--new-tokens", "4"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["status"] == "ok" and res["arch"] == ARCH
    res = train.run(["--arch", ARCH, "--device", "cpu", "--steps", "4", "--batch", "2",
                     "--seq", "16", "--policy", "none", "--repeat-batch", "--lr", "3e-3",
                     "--json"])
    assert res["status"] == "ok" and res["steps"] == 4
    assert res["losses"][-1] < res["losses"][0]
