"""Training rwkv6 in the port against the JAX package on the same numpy
inputs: the wkv6 backward's plain version and an emulation of the CUDA
backward's chunked algorithm (float64; float32 at strong decay) against
``jax.vjp`` of the reference's chunked form, and the Python mirror of its
launch plan; the dispatch's autograd Function; the reduced rwkv6-1.6b (2 layers,
d 64, 4 heads of 16, float32): its loss, every gradient leaf and one
train step against the reference's, and a falling loss.

On the CPU the wkv6 forward and backward run their plain versions inside
the same autograd Function that runs the CUDA kernels on the card."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.models.rwkv6 import wkv6_chunked as jax_wkv6_chunked
from repro.train.step import make_train_step as jax_make_train_step
from repro.utils.tree import split_params
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6
from repro_torch.models import build_model
from repro_torch.models.model_api import _stacks_for
from repro_torch.train import optim
from repro_torch.train.step import make_train_step
from repro_torch.utils.tree import flatten, unflatten

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

# wkv6's gradients against jax.vjp: 1e-4 of the reference's largest
# magnitude plus 1e-6 (float32 sums in another order and chunking; dwlog
# is a difference of two nearly equal suffix sums at early tokens)
WKV6_GRAD_RTOL, WKV6_GRAD_ATOL = 1e-4, 1e-6
B, S = 2, 32
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
GRAD_NAMES = ("dr", "dk", "dv", "dwlog", "du", "dstate")

# (B, H, S, N, strong decay): the reference test's shapes, S = 40 (ragged
# against the plain version's 64-token chunks), S = 1 and wlog = -8
WKV6_CASES = [(1, 1, 32, 8, False), (2, 4, 128, 16, False), (1, 2, 96, 32, False),
              (2, 3, 40, 16, False), (2, 2, 1, 16, False), (1, 2, 64, 16, True)]
WKV6_IDS = ["1x1x32x8", "2x4x128x16", "1x2x96x32", "ragged_S40", "S1", "wlog_-8"]


def _wkv6_inputs(Bq, H, Sq, N, strong_decay, seed):
    """r/k/v/wlog (B, H, S, N), u, state, dy and dS_T from numpy: the
    distributions of the reference's kernel tests, with a nonzero state."""
    rng = np.random.default_rng(seed)
    r, k, v, dy = (0.5 * rng.standard_normal((Bq, H, Sq, N)).astype(np.float32)
                   for _ in range(4))
    if strong_decay:
        wlog = np.full((Bq, H, Sq, N), -8.0, dtype=np.float32)
    else:
        wlog = -np.exp(rng.standard_normal((Bq, H, Sq, N)).astype(np.float32) * 0.5 - 1)
    u = (0.3 * rng.standard_normal((H, N))).astype(np.float32)
    state = (0.1 * rng.standard_normal((Bq, H, N, N))).astype(np.float32)
    ds_T = (0.1 * rng.standard_normal((Bq, H, N, N))).astype(np.float32)
    return r, k, v, wlog, u, state, dy, ds_T


def _jax_grads(r, k, v, wlog, u, state, dy, ds_T):
    """jax.vjp of the reference's chunked form, (B, H, S, N) in and out."""
    def bshn(a):
        return jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))

    _, vjp = jax.vjp(jax_wkv6_chunked, *(bshn(a) for a in (r, k, v, wlog)), jnp.asarray(u),
                     jnp.asarray(state))
    g = vjp((bshn(dy), jnp.asarray(ds_T)))
    return [np.asarray(t).transpose(0, 2, 1, 3) for t in g[:4]] + [np.asarray(t) for t in g[4:]]


def _assert_grads(got, want, what):
    for name, g, w in zip(GRAD_NAMES, got, want):
        g = np.asarray(g, dtype=np.float64)
        assert g.shape == w.shape, (what, name)
        limit = WKV6_GRAD_RTOL * float(np.max(np.abs(w))) + WKV6_GRAD_ATOL
        err = float(np.max(np.abs(g - w)))
        assert err <= limit, (what, name, err, limit)


@pytest.mark.parametrize("zero_ds_T", [False, True], ids=["ds_T", "no_ds_T"])
@pytest.mark.parametrize("Bq,H,Sq,N,strong", WKV6_CASES, ids=WKV6_IDS)
def test_wkv6_bwd_ref_matches_jax_vjp(Bq, H, Sq, N, strong, zero_ds_T):
    inputs = list(_wkv6_inputs(Bq, H, Sq, N, strong, seed=Sq + N + H))
    if zero_ds_T:
        inputs[7] = np.zeros_like(inputs[7])
    got = rwkv6.wkv6_bwd_ref(*(torch.from_numpy(a) for a in inputs))
    assert [t.dtype for t in got] == [torch.float32] * 6
    _assert_grads([t.numpy() for t in got], _jax_grads(*inputs), "wkv6_bwd_ref")


def _row_pass(a, m, b, c, u, ew, X, order, term, grad, a_prev, b_prev, first_term_zero,
              cols=None):
    """One row pass of csrc/wkv6_bwd.cu over ``order`` (one chunk's tokens):
    per step the row sums of X c_t (out'), g_t, the row's term m_t out'
    (through ``term``; 0 at the first step where ``first_term_zero``), then
    (``cols``) the step's column sums X^T m_t, then X = (X + a' b'^T)
    exp(w_t) with a', b' the previous step's a and b (``a_prev``,
    ``b_prev``: the token next to the chunk, or zeros)."""
    for i, t in enumerate(order):
        outp = np.einsum("bhij,bhj->bhi", X, c[:, :, t])
        q = np.sum(b_prev * c[:, :, t], axis=-1, keepdims=True)
        s = np.sum(b[:, :, t] * c[:, :, t], axis=-1, keepdims=True)
        grad[:, :, t] = outp + a_prev * q + u * a[:, :, t] * s
        term(t, np.zeros_like(outp) if (first_term_zero and i == 0) else m[:, :, t] * outp, s)
        if cols is not None:
            cols(t, np.einsum("bhij,bhi->bhj", X, m[:, :, t]), a_prev, b_prev)
        X = (X + a_prev[..., None] * b_prev[..., None, :]) * ew[:, :, t, :, None]
        a_prev, b_prev = a[:, :, t], b[:, :, t]
    return X


def _chunked_passes(r, k, v, wlog, u, state, dy, ds_T, chunk, dtype=np.float64):
    """The CUDA backward's chunked algorithm (csrc/wkv6_bwd.cu) in ``dtype``.
    S is cut into chunks of ``chunk`` tokens (the last one short). With Z_t
    the state without its newest k v^T and dZ_t the state's gradient
    without its newest r dy^T:
    1. per chunk [t0, t1] after the first: the reverse carry's term M = sum
       over s in [t0 + 1, t1 + 1] of (r_s decayed by w_{t0..s-1}) dy_s^T
       (the token after the chunk in, its first token out) and P = the
       chunk's decay, each decay the exp of a sum of wlog from the chunk's
       start;
    2. the scan: dZ at every chunk's end from dS_T (dZ' = P dZ + M);
    3. row pass 1 over the whole sequence from state_in: dr, A'_t = r_t *
       (Z_t dy_t), and Z at each chunk's end;
    4. row pass 2 per chunk in reverse order from its dZ (dS_T for the last
       chunk), the token after it staged as the previous step: first A'_end
       = rowsum(Z_end * dS_end), dS_end = dS_T for the last chunk, else dZ
       + r dy^T of the token after it (dwlog of the chunk's last token);
       dk, dwlog as a running sum per row from A'_end, then -B'_t (0 at the
       chunk's first step), then +A'_t, B'_t = k_t * (dZ_{t+1} v_t), and one
       du partial per (b, h, chunk); from the same carry X = dZ_{t+1}, dv_t =
       X^T k_t + (r_{t+1} . k_t) dy_{t+1} + (k_t . (u * r_t)) dy_t, and
       dstate = dZ_0 + r_0 dy_0^T from the first chunk;
    du sums the partials in (b, chunk) order."""
    r, k, v, wlog, u, state, dy, ds_T = (np.asarray(a, dtype=dtype)
                                         for a in (r, k, v, wlog, u, state, dy, ds_T))
    Bq, H, Sq, N = r.shape
    C = min(chunk, Sq)
    NC = -(-Sq // C)
    bounds = [(c * C, min(Sq, (c + 1) * C) - 1) for c in range(NC)]
    ew = np.exp(wlog)
    zero = np.zeros((Bq, H, N), dtype)

    def tok(x, t):
        return x[:, :, t] if 0 <= t < Sq else zero

    M, P = [None] * NC, [None] * NC  # 1. chunk contributions
    for c, (t0, t1) in enumerate(bounds[1:], start=1):
        acc, Mc = zero, np.zeros_like(state)
        for t in range(t0, t1 + 1):  # w_t0 .. w_t: the decay of token t + 1
            acc = acc + wlog[:, :, t]
            Mc = Mc + (np.exp(acc) * tok(r, t + 1))[..., None] * tok(dy, t + 1)[..., None, :]
        M[c], P[c] = Mc, np.exp(acc)
    dZ = [ds_T] * NC  # 2. the scan
    for c in range(NC - 2, -1, -1):
        dZ[c] = P[c + 1][..., None] * dZ[c + 1] + M[c + 1]

    dr, dk, dv, dwlog, A = (np.zeros_like(r) for _ in range(5))

    def keep_a(t, term, s):
        A[:, :, t] = term

    fin, X = [], state  # 3. pass 1, the whole sequence
    for c, (t0, t1) in enumerate(bounds):
        X = _row_pass(k, r, v, dy, u, ew, X, range(t0, t1 + 1), keep_a, dr,
                      tok(k, t0 - 1), tok(v, t0 - 1), False)
        dS_end = dZ[c] + tok(r, t1 + 1)[..., None] * tok(dy, t1 + 1)[..., None, :]
        fin.append(np.sum(X * dS_end, axis=-1))  # A'_end
    du_part = np.zeros((Bq, NC, H, N), dtype)
    dstate = None
    for c, (t0, t1) in enumerate(bounds):  # 4. pass 2
        run = fin[c]

        def dwlog_step(t, term, s):
            nonlocal run
            run = run - term
            dwlog[:, :, t] = run
            run = run + A[:, :, t]
            du_part[:, c] += r[:, :, t] * k[:, :, t] * s

        def dv_step(t, cols, a_prev, b_prev):
            p = np.sum(a_prev * k[:, :, t], axis=-1, keepdims=True)
            bonus = np.sum(k[:, :, t] * u * r[:, :, t], axis=-1, keepdims=True)
            dv[:, :, t] = cols + p * b_prev + bonus * dy[:, :, t]

        X = _row_pass(r, k, dy, v, u, ew, dZ[c], range(t1, t0 - 1, -1), dwlog_step, dk,
                      tok(r, t1 + 1), tok(dy, t1 + 1), True, dv_step)
        if c == 0:
            dstate = X + r[:, :, 0, :, None] * dy[:, :, 0, None, :]
    du = np.zeros((H, N), dtype)
    for b in range(Bq):
        for c in range(NC):
            du = du + du_part[b, c]
    return dr, dk, dv, dwlog, du, dstate


#: chunk sizes of the emulation: the whole sequence (one chunk: the unchunked
#: passes), 16 (ragged at S = 40 and 96, larger than S = 1) and 1. The
#: kernel is built for one (rwkv6.BWD_CHUNK, a multiple of its 16-token
#: tile); the algorithm is held at every length
CHUNKS = [None, 16, 1]
CHUNK_IDS = ["C_S", "C16", "C1"]


@pytest.mark.parametrize("chunk", CHUNKS, ids=CHUNK_IDS)
@pytest.mark.parametrize("Bq,H,Sq,N,strong", WKV6_CASES, ids=WKV6_IDS)
def test_kernel_passes_emulated_match_jax_vjp(Bq, H, Sq, N, strong, chunk):
    inputs = _wkv6_inputs(Bq, H, Sq, N, strong, seed=7 * Sq + N)
    _assert_grads(_chunked_passes(*inputs, chunk=chunk or Sq), _jax_grads(*inputs),
                  f"chunked passes, chunk {chunk or Sq}, float64")


#: wlog = -8: the wlog_-8 case and chip_smoke.py's strong-decay shape
STRONG_CASES = [WKV6_CASES[-1], (1, 2, 256, 64, True)]
STRONG_IDS = ["wlog_-8", "wlog_-8_1x2x256x64"]


@pytest.mark.parametrize("chunk", CHUNKS, ids=CHUNK_IDS)
@pytest.mark.parametrize("Bq,H,Sq,N,strong", STRONG_CASES, ids=STRONG_IDS)
def test_kernel_passes_emulated_in_float32_at_strong_decay(Bq, H, Sq, N, strong, chunk):
    """wlog = -8 in float32: exp(w) ~ 3e-4, so an adjacent pair (t - 1, t)
    is ~3000x dwlog's size. The carries are Z and dZ, no A' or B' term
    holds a pair, and every chunk's dwlog starts from the direct A'_end of
    its last token, so dwlog stays within the limits (0.50x of them at
    (1, 2, 256, 64)). Because the terms at a chunk's boundary (its first
    A', its last B') are never used, a chunk of the reverse pass started
    from dS with no token after it reads the same there: this test holds
    the float32 arithmetic, not that fault."""
    inputs = _wkv6_inputs(Bq, H, Sq, N, strong, seed=7 * Sq + N)
    _assert_grads(_chunked_passes(*inputs, chunk=chunk or Sq, dtype=np.float32),
                  _jax_grads(*inputs), f"chunked passes, chunk {chunk or Sq}, float32")


def test_bwd_plan_mirrors_the_kernel_source():
    """``rwkv6.bwd_plan``, the Python mirror of csrc/wkv6_bwd.cu's launches
    and scratch (chip_smoke.py holds it to the built kernels' own plan): at
    the training shape 4 chunks of 128 tokens, the first row pass
    512 blocks of 64 threads over the whole sequence, the second 512 blocks
    of 256 (a chunk each: 4x the first's warps); one chunk runs neither the
    chunk contributions nor the scan; its constants are the source's, and
    the chunk is whole row tiles (the source asserts it too)."""
    import ctypes
    import re

    from repro_torch.kernels import _build

    plan = rwkv6.bwd_plan(4, 32, 512, 64)
    launches = plan["launches"]
    assert (rwkv6.BWD_CHUNK, plan["chunks"]) == (128, 4)
    assert list(launches) == list(rwkv6.BWD_LAUNCHES)
    assert launches["chunk"] == (4 * 32 * 3, 256, (64 * 33 + 2 * 32 * 64 + 64) * 4)
    assert launches["scan"] == (4 * 32 * 64 * 64 // 4 // 256, 256, 0)
    assert launches["rows 1"] == (512, 64, ((3 * 16 + 1) * 16 + 33 * 68 + 32) * 4)
    assert launches["rows 2"] == (512, 256,
                                  ((3 * 16 + 1) * 64 + 33 * 68 + 32 + 16 * 64 + 96) * 4)
    assert launches["du"] == (8, 256, 0)
    assert plan["dynamic"] == 8 * 16 * 64 * 4
    assert plan["scratch"] == 4 * 32 * (512 + 2 * 4 * 64 + 2 * 4) * 64
    # ragged: S = 300 is 128 + 128 + 44; one chunk at S = 1
    ragged = rwkv6.bwd_plan(2, 3, 300, 16)
    assert ragged["chunks"] == 3
    assert ragged["launches"]["rows 1"][:2] == (2 * 3, 64)
    assert ragged["launches"]["rows 2"][:2] == (2 * 3 * 3, 64)
    assert ragged["launches"]["chunk"][:2] == (2 * 3 * 2, 64)
    one = rwkv6.bwd_plan(2, 2, 1, 16)
    assert one["chunks"] == 1
    assert one["launches"]["chunk"][0] == one["launches"]["scan"][0] == 0
    assert one["scratch"] == 2 * 2 * (1 + 2 * 16 + 2) * 16
    src = (_build.SRC_DIR / "wkv6_bwd.cu").read_text()
    assert rwkv6.BWD_CHUNK % rwkv6.BWD_ROW_TILE == 0
    for name, value in (("TR", rwkv6.BWD_ROW_TILE), ("CHUNK", rwkv6.BWD_CHUNK),
                        ("CT", rwkv6.BWD_CHUNK_TILE),
                        ("SCAN_THREADS", rwkv6.BWD_FLAT_THREADS),
                        ("DU_THREADS", rwkv6.BWD_FLAT_THREADS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    tiles = re.findall(r"struct Tile<(\d+)> \{ static constexpr int R = (\d+), C = (\d+), "
                       r"JC = (\d+); \};", (_build.SRC_DIR / "wkv6.cuh").read_text())
    assert {int(n): tuple(map(int, t)) for n, *t in tiles} == rwkv6.TILES
    params = re.search(r'extern "C" int rt_wkv6_bwd_plan\(([^)]*)\)', src).group(1).split(",")
    assert [p.split()[0] for p in params] == ["int"] * 5 + ["int*"]
    assert _build.SIGNATURES["rt_wkv6_bwd_plan"] == [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int)]


def test_ops_wkv6_under_grad_runs_the_autograd_function():
    """On the CPU ``ops.wkv6`` under autograd runs ``_WKV6``: the plain
    forward, and a backward that is ``wkv6_bwd_ref`` bit for bit, with a
    zero dS_T when the final state is dropped; it equals autograd through
    the plain forward; no kernel launches."""
    inputs = _wkv6_inputs(2, 3, 40, 16, False, seed=3)
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs[:6]]
    dy = torch.from_numpy(inputs[6])
    ops.reset_launch_counts()
    y, s_out = ops.wkv6(*leaves)
    assert y.grad_fn is not None and s_out.grad_fn is not None
    want_y, _ = rwkv6.wkv6_ref(*(t.detach() for t in leaves))
    assert torch.equal(y.detach(), want_y)
    got = torch.autograd.grad(y, leaves, dy)
    ref = rwkv6.wkv6_bwd_ref(*(t.detach() for t in leaves), dy, torch.zeros_like(leaves[5]))
    for name, g, w in zip(GRAD_NAMES, got, ref):
        assert torch.equal(g, w), name
    auto = torch.autograd.grad(rwkv6.wkv6_ref(*leaves)[0], leaves, dy)
    for name, g, w in zip(GRAD_NAMES, got, auto):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6, msg=name)
    assert all(n == 0 for n in ops.launch_counts().values())


def test_ops_wkv6_under_grad_on_the_kernel_path_reaches_the_cuda_wrapper(monkeypatch):
    """On the kernel path (forced here on CPU tensors) ``ops.wkv6`` no
    longer refuses a gradient: it reaches the CUDA forward, which takes
    CUDA tensors only; the CUDA backward refuses CPU tensors as well."""
    monkeypatch.setattr(ops, "_use_kernel", lambda t: True)
    x = torch.zeros((1, 2, 4, 16), requires_grad=True)
    u, st = torch.zeros((2, 16)), torch.zeros((1, 2, 16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ops.wkv6(x, x, x, x, u, st)
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6.wkv6_bwd(x.detach(), x.detach(), x.detach(), x.detach(), u, st, x.detach(), st)


def test_plain_versions_reach_autograds_threads():
    """``ops.plain_versions`` holds for the whole process: autograd runs a
    CUDA backward (and the checkpointed blocks' recompute) on a thread of
    its own, which must take the plain versions too."""
    import threading
    import types

    card_tensor = types.SimpleNamespace(device=torch.device("cuda", 0))
    seen = []

    def probe():
        seen.append(ops._use_kernel(card_tensor))

    with ops.plain_versions():
        thread = threading.Thread(target=probe)
        thread.start()
        thread.join()
        seen.append(ops._use_kernel(card_tensor))
    probe()
    assert seen == [False, False, True]


# ---------------------------------------------------------------------------
# the reduced rwkv6-1.6b
# ---------------------------------------------------------------------------

#: constant-initialised leaves get noise so that every term of the
#: recurrence's gradient matters (as tests/test_torch_recurrent.py does)
_NOISY = {"mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "w0", "u", "ln_scale", "ln_bias"}


def _perturb(tree, rng):
    return {k: _perturb(v, rng) if isinstance(v, dict)
            else (v + 0.3 * rng.standard_normal(v.shape).astype(np.float32) if k in _NOISY else v)
            for k, v in tree.items()}


def _cfgs(**change):
    jcfg = dataclasses.replace(jax_get_arch("rwkv6-1.6b").reduced(), **change)
    tcfg = dataclasses.replace(get_arch("rwkv6-1.6b").reduced(), **change)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jmodel = jax_build_model(jcfg)
    values, _ = split_params(jmodel.init(jax.random.key(0)))
    values_np = _perturb(jax.tree.map(np.asarray, values), np.random.default_rng(1))
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab, (B, S), dtype=np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda v: jmodel.loss(v, {"tokens": jnp.asarray(tokens)})))(
            jax.tree.map(jnp.asarray, values_np))
    return dict(tcfg=tcfg, values_np=values_np, tokens=tokens, jloss=float(jloss),
                jgrads=jax.tree.map(np.asarray, jgrads))


def _ref_layout(tree, cfg):
    """The port's per-layer tree -> {reference path: stacked numpy}."""
    return {path: np.stack([t.detach().numpy() for t in ts]) if stacked
            else ts[0].detach().numpy()
            for path, ts, stacked in optim.leaf_groups(tree, _stacks_for(cfg))}


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_rwkv_loss_and_grads_match_jax(setup, remat):
    tcfg = dataclasses.replace(setup["tcfg"], remat=remat)
    model = build_model(tcfg)
    params = convert.from_jax_values(setup["values_np"], tcfg, param_dtype=torch.float32)
    leaves, treedef = flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    ops.reset_launch_counts()
    loss = model.loss(unflatten(treedef, live), {"tokens": setup["tokens"]})
    grads = unflatten(treedef, list(torch.autograd.grad(loss, live)))
    assert all(n == 0 for n in ops.launch_counts().values())  # the CPU launches no kernel
    loss = float(loss.detach())
    assert abs(loss - setup["jloss"]) <= LOSS_TOL, (loss, setup["jloss"])
    got = _ref_layout(grads, tcfg)
    want = dict(optim._paths(setup["jgrads"]))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        limit = GRAD_RTOL * float(np.max(np.abs(w))) + GRAD_ATOL
        assert float(np.max(np.abs(g - w))) <= limit, (path, float(np.max(np.abs(g - w))), limit)


def test_rwkv_sgdm_train_step_matches_jax(setup):
    """One train step on both sides from the same state: the reference's
    state converted by ``convert.train_state_from_jax``."""
    jcfg, tcfg = _cfgs(optimizer="sgdm")
    jts, jinit, *_ = jax_make_train_step(jax_build_model(jcfg), lr=1e-2)
    jstate = jinit(jax.random.key(0))
    tstate = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg)
    jnew, jm = jax.jit(jts)(jstate, {"tokens": jnp.asarray(setup["tokens"])})
    ts, _ = make_train_step(build_model(tcfg), lr=1e-2)
    tnew, tm = ts(tstate, {"tokens": setup["tokens"]})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL
    assert int(tnew["step"]) == int(jnew["step"]) == 1
    # params move by lr x (the gradient): the gradient's tolerance times lr
    jmom = jax.tree.map(np.asarray, jnew["opt"])
    got = _ref_layout(tnew["params"], tcfg)
    for path, w in optim._paths(jax.tree.map(np.asarray, jnew["params"])):
        m = jmom
        for key in path:
            m = m[key]
        limit = 1e-2 * (GRAD_RTOL * float(np.max(np.abs(np.asarray(m["m"])))) + GRAD_ATOL) + 1e-7
        assert float(np.max(np.abs(got[path] - w))) <= limit, path


def test_rwkv_loss_falls_on_a_repeated_batch(setup):
    model = build_model(setup["tcfg"])
    ts, init_state = make_train_step(model, lr=3e-3)
    state = init_state(torch.Generator().manual_seed(0))
    losses = []
    for _ in range(4):
        state, m = ts(state, {"tokens": setup["tokens"]})
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert int(state["step"]) == 4
