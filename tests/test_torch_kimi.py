"""kimi-k2-1t-a32b (``configs/kimi_k2.py``) against the JAX package on the
same inputs: the attention kernels' plain versions at its head dim of 112
(against the Pallas kernels in interpret mode and ``jax.vjp`` of the
reference's attention), the reduced model (head dim 16, 4 experts top-2
and its shared expert, float32 activations, bfloat16 masters) through the
prefill, decode, the loss and one Adafactor step, Adafactor's update in
pieces, the full-size config's refusal before any allocation, and the
trees at full width.

Inputs from numpy seeds; the reference's weights carried across by
``convert``."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels.decode_attention import flash_decode as jax_flash_decode
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro.models import build_model as jax_build_model
from repro.train.step import make_train_step as jax_make_train_step
from repro.utils.tree import split_params
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.models import build_model, layers
from repro_torch.models.model_api import ModelDef, _stacks_for
from repro_torch.train import optim
from repro_torch.train.step import make_train_step

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

ARCH = "kimi-k2-1t-a32b"
HD = 112
# the kernels' plain versions: tests/test_kernels.py's limits
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DECODE_TOL = 3e-5
# the model: the serving slices' float32 limit (tests/test_torch_model.py)
# and tests/test_torch_train.py's loss limit
LOGITS_TOL = 1e-4
LOSS_TOL = 1e-5
B, S, STEPS = 2, 16, 4
LR = 1e-3


def _rng(seed: int):
    return np.random.default_rng(seed)


def _pair(a: np.ndarray, dtype: str):
    return (jnp.asarray(a).astype(jnp.dtype(dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


# ---------------------------------------------------------------------------
# the kernels' plain versions at head dim 112
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 48], ids=["causal", "window48"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_hd112_matches_pallas(window, dtype):
    """``flash_attention_ref`` at hd 112 (kimi-k2's GQA g 8, and g 2)
    against the Pallas kernel in interpret mode."""
    rng = _rng(112 + window)
    for H, K in ((8, 1), (4, 2)):
        q = rng.standard_normal((2, H, 128, HD)).astype(np.float32)
        k, v = (rng.standard_normal((2, K, 128, HD)).astype(np.float32) for _ in range(2))
        (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
        want = jax_flash_attention(qj, kj, vj, window=window, block_q=32, block_k=32,
                                   interpret=True)
        got = ops.flash_attention(qt, kt, vt, window=window)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   atol=TOL[dtype], rtol=TOL[dtype], err_msg=f"H {H} K {K}")


@pytest.mark.parametrize("window", [0, 40], ids=["causal", "window40"])
def test_flash_attention_bwd_plain_hd112_matches_jax_vjp(window):
    """The float32 backward's plain version at hd 112, given the plain
    forward's output and lse, against ``jax.vjp`` of the reference's
    attention: dq, dk and dv within float32's 2e-5 (S 100, ragged against
    every tile; g 4)."""
    rng = _rng(212 + window)
    q = rng.standard_normal((2, 8, 100, HD)).astype(np.float32)
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


@pytest.mark.parametrize("window", [0, 32])
def test_flash_decode_plain_hd112_matches_pallas(window):
    """``flash_decode_ref`` at hd 112, 64 query heads on 8 KV heads (g 8),
    over kimi-k2's serve cache of 544 slots with 516 written."""
    Bd, H, K, W, pos = 2, 64, 8, 544, 515
    rng = _rng(312 + window)
    q = rng.standard_normal((Bd, H, HD)).astype(np.float32)
    k, v = (rng.standard_normal((Bd, K, W, HD)).astype(np.float32) for _ in range(2))
    kpos = np.where(np.arange(W) <= pos, np.arange(W), -1).astype(np.int32)
    kpos = np.broadcast_to(kpos, (Bd, W)).copy()
    want = jax_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kpos),
                            jnp.int32(pos), window=window, block_k=136, interpret=True)
    got = ops.flash_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(kpos), pos, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=DECODE_TOL, rtol=DECODE_TOL)


def test_head_dim_112_routes():
    """Both wrappers take hd 112; the float32 attention routes raise at it
    (ROADMAP item 9.11), the bfloat16 routes do not."""
    assert HD in fa.HEAD_DIMS and HD in da.HEAD_DIMS and HD not in fa.F32_HEAD_DIMS
    assert get_arch(ARCH).resolved_head_dim == HD
    for what in ("flash_attention", "flash_attention_bwd"):
        with pytest.raises(ValueError, match="item 9.11"):
            fa._check_route(torch.empty((1, 1, 1, HD)), what)
        fa._check_route(torch.empty((1, 1, 1, HD), dtype=torch.bfloat16), what)
        fa._check_route(torch.empty((1, 1, 1, 128)), what)


# ---------------------------------------------------------------------------
# the reduced model against the reference
# ---------------------------------------------------------------------------


def _cfgs():
    return jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()


@functools.lru_cache(maxsize=None)
def _values():
    values, _ = split_params(jax_build_model(_cfgs()[0]).init(jax.random.key(0)))
    return jax.tree.map(np.asarray, values)


def _tokens(vocab: int, seed: int):
    return _rng(seed).integers(0, vocab, (B, S), dtype=np.int32)


def test_config_is_the_references():
    """The registered config and its ``reduced()`` are the reference's,
    field for field (bf16 masters, Adafactor and FSDP kept reduced, FSDP
    dropped, 4 experts top-2 and the shared expert)."""
    got, want = get_arch(ARCH), jax_get_arch(ARCH)
    assert dataclasses.asdict(got) == {k: v for k, v in dataclasses.asdict(want).items()
                                       if k in dataclasses.asdict(got)}
    red = dataclasses.asdict(get_arch(ARCH).reduced())
    assert red == {k: v for k, v in dataclasses.asdict(want.reduced()).items() if k in red}
    r = get_arch(ARCH).reduced()
    assert (r.head_dim, r.n_experts, r.top_k, r.n_shared_experts, r.dtype, r.param_dtype,
            r.optimizer) == (16, 4, 2, 1, "float32", "bfloat16", "adafactor")


def test_prefill_and_decode_match_jax():
    """The reduced model's prefill logits and 4 decode steps' within 1e-4
    of the reference's on its bfloat16 weights, the same greedy tokens."""
    jcfg, cfg = _cfgs()
    values = _values()
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    params = convert.from_jax_values(values, cfg)
    jv = jax.tree.map(jnp.asarray, values)
    tokens = _tokens(cfg.vocab, 7)
    jl, jc = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, cache_len=S + STEPS))(
        jv, jnp.asarray(tokens))
    jdecode = jax.jit(jmodel.decode)
    with torch.inference_mode():
        tl, tc = model.prefill(params, torch.from_numpy(tokens).long(), cache_len=S + STEPS)
        for step in range(STEPS + 1):
            want, got = np.asarray(jl), tl.numpy()
            assert got.shape == want.shape == (B, cfg.vocab)
            np.testing.assert_allclose(got, want, atol=LOGITS_TOL, rtol=LOGITS_TOL,
                                       err_msg=f"step {step}")
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1), err_msg=f"{step}")
            if step == STEPS:
                break
            tok = want.argmax(-1).astype(np.int32)[:, None]
            jl, jc = jdecode(jv, jnp.asarray(tok), jnp.int32(S + step), jc)
            tl, tc = model.decode(params, torch.from_numpy(tok).long(), S + step, tc)


def _ref_layout(params, cfg):
    return {path: (np.stack([t.float().numpy() for t in ts]) if stacked
                   else ts[0].float().numpy())
            for path, ts, stacked in optim.leaf_groups(params, _stacks_for(cfg))}


def _bf16_ulp(w: np.ndarray) -> np.ndarray:
    """One bfloat16 step at each value of ``w`` (8 significant bits)."""
    a = np.abs(w.astype(np.float32))
    return np.where(a > 0, 2.0 ** (np.floor(np.log2(np.where(a > 0, a, 1.0))) - 7), 2.0 ** -133)


def test_adafactor_train_step_matches_jax():
    """One train step from the reference's initial state (bfloat16 masters,
    norm scales too, and Adafactor's factored statistics) carried over by
    ``convert.train_state_from_jax``, at a learning rate at which the norm
    scales move (a bfloat16 step of 1.0 is 2^-7): the loss within 1e-5,
    the statistics within a bfloat16 step of a squared gradient, every
    leaf of the updated masters in bfloat16 within one bfloat16 step of
    the reference's. Where
    the update nearly cancels the old value, the new one is far smaller
    than the update, and its own step is too fine a limit: each side rounds
    the gradient to bfloat16 from its own float32 sums, so a gradient may
    land one bfloat16 step away and move the update by up to 2^-7 of
    itself. The limit is one bfloat16 step of the new value plus 2^-6 of
    the reference's update."""
    jcfg, cfg = _cfgs()
    lr = 1e-2
    jts, jinit, *_ = jax_make_train_step(jax_build_model(jcfg), lr=lr)
    jstate = jinit(jax.random.key(0))
    tstate = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg)
    assert all(t.dtype == torch.bfloat16 for _, t in optim._paths(tstate["params"]))
    tokens = _tokens(cfg.vocab, 5)
    jnew, jm = jax.jit(jts)(jstate, {"tokens": jnp.asarray(tokens)})
    ts, _ = make_train_step(build_model(cfg), lr=lr)
    tnew, tm = ts(tstate, {"tokens": tokens})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL
    assert all(t.dtype == torch.bfloat16 for _, t in optim._paths(tnew["params"]))
    got = _ref_layout(tnew["params"], cfg)
    old, want = ({p: np.asarray(v, np.float32) for p, v in
                  optim._paths(jax.tree.map(np.asarray, st["params"]))} for st in (jstate, jnew))
    assert set(got) == set(want)
    for path, w in want.items():
        limit = _bf16_ulp(w) + 2.0 ** -6 * np.abs(w - old[path])
        assert np.all(np.abs(got[path] - w) <= limit), path
    for path in (("final_ln", "scale"), ("stack0", "b0", "ln1", "scale"),
                 ("stack0", "b0", "ffn", "wg"), ("stack0", "b0", "ffn", "shared", "wg")):
        assert float(np.abs(want[path] - old[path]).max()) > 0, path  # the step moved it
    # the statistics are means of squared bfloat16 gradients, of which one
    # may lie a bfloat16 step (2^-7 of it, 2^-6 of its square) away
    for path, w in optim._paths(jax.tree.map(np.asarray, jnew["opt"])):
        np.testing.assert_allclose(optim._get(tnew["opt"], path).numpy(), w, rtol=2.0 ** -6,
                                   atol=1e-30, err_msg=str(path))


def test_init_holds_every_leaf_in_bf16():
    """``init`` with kimi-k2's masters: every floating leaf in bfloat16, the
    norm scales too (ones), as the reference's ``init`` casts them; a leaf
    past ``DRAW_BLOCK`` elements is drawn in blocks of rows, the same
    numbers from the same seed."""
    cfg = get_arch(ARCH).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu", param_dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for _, t in optim._paths(params))
    assert torch.equal(params["final_ln"]["scale"], torch.ones(cfg.d_model, dtype=torch.bfloat16))
    assert params["layers"][0]["ln1"]["scale"].dtype == torch.bfloat16
    # the serving init keeps the norms float32
    assert build_model(cfg).init(torch.Generator(), "cpu")["final_ln"]["scale"].dtype == \
        torch.float32


def test_large_leaves_are_drawn_in_blocks(monkeypatch):
    """A bfloat16 leaf of more than ``DRAW_BLOCK`` elements: drawn a block
    of leading rows at a time (std 0.02, seeded, every row drawn), a
    float32 leaf whole."""
    monkeypatch.setattr(layers, "DRAW_BLOCK", 1000)
    a = layers._normal(torch.Generator().manual_seed(3), (7, 30, 20), 0.02, "cpu", torch.bfloat16)
    b = layers._normal(torch.Generator().manual_seed(3), (7, 30, 20), 0.02, "cpu", torch.bfloat16)
    assert a.dtype == torch.bfloat16 and a.shape == (7, 30, 20) and torch.equal(a, b)
    assert bool((a.float().abs().sum(dim=(1, 2)) > 0).all())
    assert 0.015 < float(a.float().std()) < 0.025
    whole = torch.randn((7, 30, 20), generator=torch.Generator().manual_seed(3)).mul_(0.02)
    assert torch.equal(layers._normal(torch.Generator().manual_seed(3), (7, 30, 20), 0.02, "cpu",
                                      torch.float32), whole)


# ---------------------------------------------------------------------------
# Adafactor in pieces
# ---------------------------------------------------------------------------


def _adafactor_step(params, grads, stacks, piece, monkeypatch):
    monkeypatch.setattr(optim, "PIECE", piece)
    init, update = optim._adafactor(LR, stacks)
    state = init(params)
    for step in range(2):  # the second step reads the statistics the first wrote
        params, state = update(params, grads[step], state, torch.tensor(step, dtype=torch.int32))
    return params, state


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adafactor_in_pieces_equals_the_whole_leaf(dtype, monkeypatch):
    """A stacked leaf of 3-D layers (3 layers of (5, 40, 24): the experts'
    shape), a 2-D leaf and a stacked leaf of 1-D layers, updated in pieces
    of 100 elements (blocks of 4 rows of the expert leaf, of one row of the
    embedding), against the same update of each leaf whole: the statistics
    and the masters within the rounding of sums in another order. In
    float32 the expert leaf also against the reference's formula written
    out here, whole."""
    stacks = [(("attn",), 3)]
    rng = _rng(77)

    def tree(seed_shift):
        t = lambda *shape: torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dtype)
        return {"embed": t(30, 24), "final_ln": {"scale": t(24)},
                "layers": [{"ffn": {"wg": t(5, 40, 24)}, "ln1": {"scale": t(24)}}
                           for _ in range(3)]}

    params0 = tree(0)
    grads = [tree(1), tree(2)]
    clone = lambda tr: optim.tree_map(lambda x: x.clone(), tr)
    small, st_small = _adafactor_step(clone(params0), grads, stacks, 100, monkeypatch)
    whole, st_whole = _adafactor_step(clone(params0), grads, stacks, 1 << 30, monkeypatch)
    for (path, a), (_, b) in zip(optim._paths(small), optim._paths(whole)):
        a, b = a.float().numpy(), b.float().numpy()
        # float32: its rounding of the value and of the update (the sums'
        # order moves u by ~1e-6 of itself); bfloat16: a master on a
        # rounding boundary may land one step away
        limit = (1e-6 * np.abs(b) if dtype == torch.float32 else _bf16_ulp(b)) + 1e-5 * LR
        assert np.all(np.abs(a - b) <= limit), path
    for (path, a), (_, b) in zip(optim._paths(st_small), optim._paths(st_whole)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=0, err_msg=str(path))
    if dtype != torch.float32:
        return
    # the reference's formula on the stacked expert leaf, whole, float32
    beta = lambda step: 1.0 - (step + 1.0) ** -0.8
    p = torch.stack([lp["ffn"]["wg"] for lp in params0["layers"]]).to(torch.float32)
    vr, vc = torch.zeros(p.shape[:-1]), torch.zeros(p.shape[:-2] + p.shape[-1:])
    for step in range(2):
        gf = torch.stack([lp["ffn"]["wg"] for lp in grads[step]["layers"]]).to(torch.float32)
        g2 = gf * gf + 1e-30
        vr = beta(step) * vr + (1 - beta(step)) * g2.mean(-1)
        vc = beta(step) * vc + (1 - beta(step)) * g2.mean(-2)
        rr = vr / torch.clamp(vr.mean(-1, keepdim=True), min=1e-30)
        u = gf / (rr.sqrt()[..., None] * vc.sqrt()[..., None, :] + 1e-30)
        u = u / torch.clamp(torch.sqrt(torch.mean(u * u) + 1e-12), min=1.0)
        p = p - LR * u
    got = torch.stack([lp["ffn"]["wg"] for lp in small["layers"]]).to(torch.float32)
    np.testing.assert_allclose(got.numpy(), p.numpy(), rtol=1e-6, atol=1e-5 * LR)
    np.testing.assert_allclose(st_small["stack0"]["b0"]["ffn"]["wg"]["vr"].numpy(), vr.numpy(),
                               rtol=1e-5)


def test_adafactor_row_blocks():
    """The blocks cover every row once, at most ``piece`` elements each
    (one row at least); a 1-D leaf is one block."""
    t = torch.zeros((3, 10, 7))
    blocks = optim._row_blocks(t, 50)
    assert [b[1] for b in blocks] == [slice(i, min(i + 2, 10)) for i in range(0, 10, 2)]
    assert all(t[b].numel() <= 50 for b in blocks)
    assert len(optim._row_blocks(t, 1)) == 10
    assert optim._row_blocks(torch.zeros(5), 1) == [(Ellipsis,)]


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def _refuse_real_init(monkeypatch):
    """``ModelDef.init`` allowed on the meta device only: a real allocation of
    the weights fails the test."""
    real = ModelDef.init

    def meta_only(self, gen, device, param_dtype=None):
        assert str(device) == "meta", f"weights allocated on {device}"
        return real(self, gen, device, param_dtype)

    monkeypatch.setattr(ModelDef, "init", meta_only)


@pytest.mark.parametrize("entry", ["serve", "train"])
def test_full_size_fails_before_any_allocation(entry, monkeypatch, capsys):
    """``--full`` is the registered 1 T-parameter config, which no device
    holds: the launcher exits 1 with a plain message, having drawn no
    weight."""
    _refuse_real_init(monkeypatch)
    argv = ["--arch", ARCH, "--full", "--device", "cpu"]
    rc = serve.main(argv) if entry == "serve" else train.main(argv + ["--steps", "1"])
    err = capsys.readouterr().err
    assert rc == 1 and "needs at least" in err and "B parameters" in err and ARCH in err


def test_one_layer_at_full_width_fits_a_card():
    """What the check counts: one layer at the full width (kimi-k2's serve
    run on the card: 19.4 G parameters, 38.8 GB in bfloat16) is under a
    card's 80 GB, the full depth more than 25 cards."""
    from repro_torch.utils.tree import tree_bytes, tree_count

    card = 80e9
    one = build_model(dataclasses.replace(get_arch(ARCH), n_layers=1)).init(None, "meta")
    assert 19.3e9 < tree_count(one) < 19.5e9 and tree_bytes(one) < card
    assert tree_bytes(build_model(get_arch(ARCH)).init(None, "meta")) > 25 * card


def test_launch_serve_and_train_on_cpu(capsys):
    """``launch.serve`` and ``launch.train`` run the reduced kimi-k2 (``--device
    cpu``): bfloat16 masters under Adafactor, the loss falling."""
    rc = serve.main(["--arch", ARCH, "--device", "cpu", "--json", "--batch", "2",
                     "--prompt-len", "12", "--new-tokens", "4"])
    assert rc == 0
    res = train.run(["--arch", ARCH, "--device", "cpu", "--steps", "4", "--batch", "2",
                     "--seq", "16", "--policy", "none", "--repeat-batch", "--lr", "3e-3",
                     "--json"])
    assert res["status"] == "ok" and res["steps"] == 4
    assert res["losses"][-1] < res["losses"][0]


def test_trees_and_axes_are_the_references():
    """At full width: the port's leaves, grouped as the reference stacks
    them, have the reference's paths (the shared expert and the untied
    head among them), shapes, bfloat16 dtype and logical axes."""
    jmodel, model = jax_build_model(jax_get_arch(ARCH)), build_model(get_arch(ARCH))
    jvalues, jaxes = split_params(jmodel.abstract_init())
    want = {"/".join(p): (tuple(v.shape), tuple(a), str(v.dtype))
            for (p, v), (_, a) in zip(optim._paths(jvalues), optim._paths(jaxes))}
    stacks = _stacks_for(model.cfg)
    axes = {"/".join(p): g[0] for p, g, _ in optim.leaf_groups(model.param_axes(), stacks)}
    got = {"/".join(p): (((len(ts),) if stacked else ()) + tuple(ts[0].shape),
                         (("layers",) if stacked else ()) + axes["/".join(p)],
                         str(ts[0].dtype).replace("torch.", ""))
           for p, ts, stacked in optim.leaf_groups(model.abstract_init(), stacks)}
    assert got == want
    assert got["stack0/b0/ffn/wg"][0] == (61, 384, 7168, 2048)
    assert got["stack0/b0/ffn/shared/wg"][0] == (61, 7168, 2048)
    assert got["lm_head"][0] == (7168, 163840)
