"""The dry run (``repro_torch.launch.dryrun``, ``dryrun_all``,
``roofline.counter``, ``roofline.report``, the kernels' shape-only path)
against the JAX package.

Every cell runs in a subprocess of its own (``python -m
repro_torch.launch.dryrun``): its ``fake`` process group of 256 or 512
ranks is the process's. The kernels' fake path, the counter's collectives
and the report run here or in a small subprocess."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import applicable as jax_applicable
from repro.configs import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.roofline import report as jax_report
from repro.roofline.hlo import module_stats
from repro.sharding.rules import MeshRules as JaxMeshRules
from repro.train.step import make_train_step as jax_make_train_step
from repro.utils.tree import split_params, tree_bytes
from repro_torch.configs import SHAPES, all_archs, applicable, get_arch
from repro_torch.kernels import fake, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline import report
from repro_torch.roofline.counter import StepCounter

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
# (arch, shape, mesh, variant): the three cells the checks read, the
# serving cells of whisper-tiny and of the int8 KV cache, whisper-tiny's
# training (its frames in the batch), phi-3-vision's cells (its image
# embeddings in the train and prefill batches), a skipped cell, and cells
# the port cannot run (unported archs and variants)
CELLS = {
    "train": ("gemma-2b", "train_4k", "single", "baseline"),
    "decode": ("olmoe-1b-7b", "decode_32k", "multi", "baseline"),
    "prefill": ("recurrentgemma-9b", "prefill_32k", "single", "baseline"),
    "whisper_prefill": ("whisper-tiny", "prefill_32k", "single", "baseline"),
    "whisper_decode": ("whisper-tiny", "decode_32k", "single", "baseline"),
    "kv_int8": ("gemma-2b", "decode_32k", "single", "kv_int8"),
    "serve_bf16_kv8": ("gemma-2b", "decode_32k", "single", "serve_bf16_kv8"),
    "skipped": ("gemma-2b", "long_500k", "single", "baseline"),
    "kimi": ("kimi-k2-1t-a32b", "train_4k", "single", "baseline"),
    "whisper_train": ("whisper-tiny", "train_4k", "single", "baseline"),
    "phi": ("phi-3-vision-4.2b", "prefill_32k", "multi", "baseline"),
    "phi_train": ("phi-3-vision-4.2b", "train_4k", "single", "baseline"),
    "phi_decode": ("phi-3-vision-4.2b", "decode_32k", "single", "baseline"),
    "sp_model": ("gemma-2b", "train_4k", "single", "sp_model"),
    "fsdp": ("deepseek-7b", "train_4k", "single", "fsdp"),
    "seq_shard": ("gemma-2b", "prefill_32k", "multi", "seq_shard"),
    "flash": ("gemma-2b", "train_4k", "single", "flash"),
}
MAIN = ("train", "decode", "prefill")
SERVE_CELLS = ("whisper_prefill", "whisper_decode", "kv_int8", "serve_bf16_kv8")
PHI_CELLS = ("phi_train", "phi", "phi_decode")
WHISPER_TRAIN = ("whisper_train",)
# each cell's batch: an encoder-decoder's prefill and train steps take its
# frames, a vision config's train and prefill steps its image embeddings
BATCH_NAMES = {"whisper_prefill": {"tokens", "frames"}, "whisper_train": {"tokens", "frames"},
               "phi": {"tokens", "image_embeds"}, "phi_train": {"tokens", "image_embeds"}}
# the config changes of the variants above (the reference's ``launch/dryrun.py``
# VARIANTS entries)
VARIANT_CONFIG = {"baseline": {}, "kv_int8": {"kv_cache_dtype": "int8"},
                  "serve_bf16_kv8": {"kv_cache_dtype": "int8", "param_dtype": "bfloat16"}}
CELL_TIMEOUT_S = 60


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """{name: the cell's JSON}: all cells, four subprocesses at a time."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(REPO / "src"), os.environ.get("PYTHONPATH")) if p)}
    names, out = list(CELLS), {}
    for i in range(0, len(names), 4):
        procs = {}
        for name in names[i:i + 4]:
            arch, shape, mesh, variant = CELLS[name]
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                 shape, "--mesh", mesh, "--variant", variant, "--out", str(tmp / f"{name}.json")],
                env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for name, p in procs.items():
            _, err = p.communicate(timeout=CELL_TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            out[name] = json.loads((tmp / f"{name}.json").read_text())
    return out


def _chips(mesh: str) -> int:
    return int(np.prod(make_production_mesh(multi_pod=mesh == "multi").sizes))


# ---------------------------------------------------------------------------
# the reference's abstract state and its spec slices
# ---------------------------------------------------------------------------


class FakeMesh:
    """tests/test_sharding_roofline.py's stand-in for a jax Mesh."""

    def __init__(self, shape):
        self.shape = shape.shape
        self.axis_names = shape.axis_names


def _reference_trees(name: str):
    """[(values, axes or None)] of the reference's step inputs for the cell:
    its abstract train state, or parameters (and cache), and the batch."""
    arch, shape_name, _, variant = CELLS[name]
    cfg, shape = jax_get_arch(arch), JAX_SHAPES[shape_name]
    model = jax_build_model(dataclasses.replace(cfg, **VARIANT_CONFIG[variant]))
    values, axes = split_params(model.abstract_init())
    if shape.kind == "train":
        _, _, abstract_state, _, _ = jax_make_train_step(model)
        state = abstract_state()
        # AdamW's m and v lie as their parameter (the reference's state_shardings)
        moments = [jax.tree.map(lambda d, key=key: d[key], state["opt"],
                                is_leaf=lambda x: isinstance(x, dict) and "m" in x)
                   for key in ("m", "v")]
        trees = [(state["params"], axes), (moments[0], axes), (moments[1], axes),
                 (state["step"], None)]
    else:
        trees = [(values, axes)]
    if shape.kind == "decode":
        trees.append(split_params(model.abstract_cache(shape.global_batch, shape.seq_len)))
    batch, baxes = split_params(model.input_specs(shape))
    names = ("tokens", "frames", "image_embeds") if shape.kind != "decode" else ("tokens",)
    trees.append(({k: batch[k] for k in names if k in batch},
                  {k: baxes[k] for k in names if k in baxes}))
    return trees


def _local_bytes(values, axes, rules) -> int:
    if axes is None:
        return tree_bytes(values)
    sizes = rules.mesh.shape
    total = 0
    axs = jax.tree.leaves(axes, is_leaf=lambda x: isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x))
    for ax, v in zip(axs, jax.tree.leaves(values), strict=True):
        spec = rules.spec_for(tuple(ax), tuple(v.shape))
        split = int(np.prod([sizes[a] for e in spec for a in
                             ((e,) if isinstance(e, str) else (e or ()))]))
        total += int(np.prod(v.shape)) * np.dtype(v.dtype).itemsize // split
    return total


@pytest.mark.parametrize("name", MAIN + SERVE_CELLS + PHI_CELLS + WHISPER_TRAIN)
def test_state_bytes_global_equal_the_references(cells, name):
    """``state_bytes_global`` is the reference's ``tree_bytes`` of the same
    abstract state (its ``jax.eval_shape``s, no compile)."""
    trees = _reference_trees(name)[:-1]  # the batch is not state
    assert cells[name]["state_bytes_global"] == sum(tree_bytes(v) for v, _ in trees)


@pytest.mark.parametrize("name", MAIN + SERVE_CELLS + PHI_CELLS + WHISPER_TRAIN)
def test_rank0_arguments_are_the_reference_spec_slices(cells, name):
    """Rank 0's argument bytes are the sum of the reference's spec slices of
    its state (or parameters and cache) and batch under the same mesh (an
    encoder-decoder's prefill batch holds its frames, a vision config's
    train and prefill batches its image embeddings). The port's decode
    tokens are int64 (the reference's int32), its train and prefill tokens
    int32."""
    arch, shape_name, mesh, _ = CELLS[name]
    rules = JaxMeshRules(FakeMesh(make_production_mesh(multi_pod=mesh == "multi")))
    trees = _reference_trees(name)
    want = sum(_local_bytes(v, a, rules) for v, a in trees)
    if SHAPES[shape_name].kind == "decode":
        want += _local_bytes(*trees[-1], rules)  # int64 tokens: twice the int32 bytes
    assert set(trees[-1][0]) == BATCH_NAMES.get(name, {"tokens"})
    assert cells[name]["memory"]["argument_bytes"] == want


def test_skipped_cells_equal_the_references_applicable(cells):
    """``applicable`` for every ported arch and shape, and the skipped cell's
    record, are the reference's."""
    for arch in all_archs():
        for shape in SHAPES:
            assert applicable(get_arch(arch), SHAPES[shape]) == jax_applicable(
                jax_get_arch(arch), JAX_SHAPES[shape]), (arch, shape)
    arch, shape, _, _ = CELLS["skipped"]
    ok, why = jax_applicable(jax_get_arch(arch), JAX_SHAPES[shape])
    assert not ok and cells["skipped"]["skipped"] == why
    assert "memory" not in cells["skipped"]


@pytest.mark.parametrize("name", ("kimi", "sp_model", "fsdp", "seq_shard"))
def test_unported_archs_and_variants_give_an_error(cells, name):
    """An arch or variant the port cannot run writes its
    NotImplementedError text under "error", with the cell's keys, and
    exits 0."""
    arch, shape, mesh, variant = CELLS[name]
    r = cells[name]
    assert (r["arch"], r["shape"], r["mesh"], r["variant"]) == (arch, shape, mesh, variant)
    assert "not ported yet" in r["error"] and "ROADMAP.md" in r["error"]
    assert "memory" not in r and "roofline" not in r


@pytest.mark.parametrize("name", MAIN + SERVE_CELLS + PHI_CELLS + WHISPER_TRAIN)
def test_record_keys_and_roofline(cells, name):
    """The reference's keys (``trace_s`` for ``lower_s`` / ``compile_s``),
    the roofline on the H100's peaks, the memory identity."""
    r = cells[name]
    for key in ("arch", "shape", "mesh", "variant", "params_total", "params_active",
                "state_bytes_global", "trace_s", "memory", "cost", "collectives",
                "model_flops_global", "useful_compute_ratio", "roofline"):
        assert key in r, key
    mem = r["memory"]
    assert mem["peak_per_device"] == (mem["argument_bytes"] + mem["output_bytes"]
                                      + mem["temp_bytes"] - mem["alias_bytes"])
    assert mem["fits_hbm"] == (mem["peak_per_device"] <= 80e9)
    assert r["collectives"]["_total"]["count"] > 0
    rf = r["roofline"]
    assert rf["compute_s"] == pytest.approx(r["cost"]["flops_per_device"] / 989e12)
    assert rf["memory_s"] == pytest.approx(r["cost"]["bytes_per_device"] / 3.35e12)
    assert rf["collective_s"] == pytest.approx(
        r["collectives"]["_total"]["wire_bytes"] / 450e9)
    assert r["trace_s"] < CELL_TIMEOUT_S


@pytest.mark.parametrize("name", MAIN)
def test_no_work_is_missing(cells, name):
    """``flops_per_device`` x chips is at least the model's FLOPs of the work
    the step must do: ``model_flops_global`` (6 N D, 2 N D) less the
    embedding lookup, which is a read (the untied table's share of N), and,
    in prefill, the head at every position but the last (the reference's
    prefill, as the port's, takes the last position's logits only).

    Its upper end: no rank does more than its data shard's whole step,
    so the total is at most n_model times the global step (a block whose
    dim does not divide the "model" axis, such as gemma-2b's 8 heads on 16
    ranks, runs whole on each of them, as under the reference's
    partitioner). The global step is at most: the forward twice in
    training (every block recomputed in the backward, 8/6 of 6 N D); the
    experts' capacity buffers padded by the capacity factor, or in decode
    (groups of one token, one buffer row an expert) by E / k; and the
    attention's quadratic term, which N D leaves out: the kernels' own
    counts."""
    arch, shape_name, mesh, _ = CELLS[name]
    r, cfg, shape = cells[name], get_arch(arch), SHAPES[shape_name]
    kind = shape.kind
    k = 6 if kind == "train" else 2
    tokens = shape.global_batch * (1 if kind == "decode" else shape.seq_len)
    vd = cfg.vocab * cfg.d_model
    need = r["model_flops_global"] - (0 if cfg.tie_embeddings else k * vd * tokens)
    if kind == "prefill":
        need -= k * vd * shape.global_batch * (shape.seq_len - 1)
    chips = _chips(mesh)
    total = r["cost"]["flops_per_device"] * chips
    assert total >= need, (total, need)
    n_model = make_production_mesh(multi_pod=mesh == "multi").shape["model"]
    attn = sum(v["flops"] for n, v in r["kernels"].items()
               if n.startswith("flash")) * chips
    moe_pad = 1.0
    if cfg.moe:  # decode groups of one token: each expert's buffer of C = 1 row a token
        moe_pad = cfg.n_experts / cfg.top_k if kind == "decode" else cfg.capacity_factor
    remat = 8 / 6 if kind == "train" else 1.0
    assert total <= n_model * (remat * moe_pad * r["model_flops_global"] + attn), (total, attn)


def test_whisper_train_counts_every_backward_pair(cells):
    """The whisper train cell runs (no "error") and its rank-0
    flash_attention_bwd FLOPs (its 16 of the 256 rows; 6 heads do not
    divide the "model" axis of 16, so whole) are 10·hd a pair per (b, h)
    over each encoder layer's 1500² pairs (not causal), each decoder
    layer's causal S(S+1)/2 and its cross-attention's S·1500: one backward
    call a layer and attention. The forward runs the encoder once and the
    decoder's two attentions twice (every decoder block recomputed in the
    backward; the encoder is not, as in the reference)."""
    cfg, shape = get_arch("whisper-tiny"), SHAPES["train_4k"]
    S, F = shape.seq_len, cfg.encoder_seq
    B_local, H, hd = shape.global_batch // 16, cfg.n_heads, cfg.resolved_head_dim
    r = cells["whisper_train"]
    assert "error" not in r
    bwd = r["kernels"]["flash_attention_bwd"]
    pairs = cfg.encoder_layers * F * F + cfg.n_layers * (S * (S + 1) // 2 + S * F)
    assert bwd["calls"] == cfg.encoder_layers + 2 * cfg.n_layers
    assert bwd["flops"] == 10 * hd * pairs * B_local * H
    assert r["kernels"]["flash_attention"]["calls"] == cfg.encoder_layers + 4 * cfg.n_layers


def test_whisper_prefill_counts_every_cross_pair(cells):
    """The whisper prefill cell's flash_attention FLOPs on rank 0 (its 2 of
    the 32 rows; 6 heads do not divide the "model" axis of 16, so whole):
    per layer the encoder's 1500² pairs (not causal), the decoder's causal
    S(S+1)/2 and the cross-attention's S·1500, 4·hd FLOPs a pair per (b,
    h), 4 encoder and 4 decoder layers."""
    cfg, S = get_arch("whisper-tiny"), SHAPES["prefill_32k"].seq_len
    F = cfg.encoder_seq
    B_local, H, hd = 2, cfg.n_heads, cfg.resolved_head_dim
    pairs = cfg.encoder_layers * F * F + cfg.n_layers * (S * (S + 1) // 2 + S * F)
    k = cells["whisper_prefill"]["kernels"]["flash_attention"]
    assert k["calls"] == cfg.encoder_layers + 2 * cfg.n_layers
    assert k["flops"] == 4 * hd * pairs * B_local * H


def test_whisper_decode_reads_the_memory_in_every_layer(cells):
    """The whisper decode cell: per decoder layer one flash_decode over the
    32768-slot self cache and one over the 1500-frame memory."""
    cfg = get_arch("whisper-tiny")
    k = cells["whisper_decode"]["kernels"]["flash_decode"]
    B_local, H, hd = 128 // 16, cfg.n_heads, cfg.resolved_head_dim
    assert k["calls"] == 2 * cfg.n_layers
    assert k["flops"] == 4 * hd * H * B_local * cfg.n_layers * (32768 + cfg.encoder_seq)


@pytest.mark.parametrize("name", ("phi_train", "phi"))
def test_phi_attention_counts_the_image_positions(cells, name):
    """phi-3-vision's train and prefill cells: per layer one flash_attention
    over the step's seq_len positions, its 256 image tokens and seq_len -
    256 text tokens, causal: 4·hd FLOPs a pair per (b, h) on rank 0's rows
    of the batch and its heads (32 over the "model" axis)."""
    arch, shape_name, mesh, _ = CELLS[name]
    cfg, shape = get_arch(arch), SHAPES[shape_name]
    sizes = make_production_mesh(multi_pod=mesh == "multi").shape
    n_model = sizes["model"]
    B_local = shape.global_batch * n_model // _chips(mesh)
    S = shape.seq_len
    k = cells[name]["kernels"]["flash_attention"]
    per_call = 4 * cfg.resolved_head_dim * (S * (S + 1) // 2) * B_local * (cfg.n_heads // n_model)
    calls = cfg.n_layers * (2 if shape.kind == "train" else 1)  # remat: again in the backward
    assert k["calls"] == calls and k["flops"] == calls * per_call
    if shape.kind == "train":
        assert cells[name]["kernels"]["flash_attention_bwd"]["calls"] == cfg.n_layers


def test_flash_variant_reports_its_base_variants_numbers(cells):
    """A ``flash`` variant reports the base variant's numbers (the port's
    kernels hold no score tensor to remove) and says why."""
    flash, base = cells["flash"], cells["train"]
    for key in ("memory", "cost", "collectives", "roofline", "state_bytes_global"):
        assert flash[key] == base[key], key
    assert "no score tensor" in flash["flash_adjust"]


# ---------------------------------------------------------------------------
# the kernels' shape-only path
# ---------------------------------------------------------------------------


def _inputs(name: str, device="cpu"):
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype).to(device)

    if name == "rmsnorm":
        return (rnd(6, 32), rnd(32)), {}
    if name == "flash_attention":
        return (rnd(2, 4, 24, 16), rnd(2, 2, 24, 16), rnd(2, 2, 24, 16)), {"window": 8}
    if name == "flash_decode":
        kpos = torch.arange(16, dtype=torch.int32).expand(2, 16).contiguous().to(device)
        return (rnd(2, 4, 16), rnd(2, 2, 16, 16), rnd(2, 2, 16, 16), kpos, 15), {}
    if name == "wkv6":
        return (rnd(2, 2, 12, 8), rnd(2, 2, 12, 8), rnd(2, 2, 12, 8),
                -torch.rand((2, 2, 12, 8), generator=g).to(device), rnd(2, 8),
                rnd(2, 2, 8, 8)), {}
    return (-torch.rand((2, 12, 8), generator=g).to(device), rnd(2, 12, 8), rnd(2, 8)), {}


def _formula(name: str, args, kw):
    """(FLOPs, bytes) of a forward call and of its backward: the bound's."""
    nb = fake._bytes
    if name == "rmsnorm":
        x, s = args
        return (4 * x.numel(), 2 * nb(x) + nb(s)), (10 * x.numel(), 3 * nb(x) + 2 * nb(s))
    if name == "flash_attention":
        q, k, v = args
        B, H, S, hd = q.shape
        pairs = int(fa._mask(S, True, kw["window"], "cpu").sum())
        lse = B * H * S * 4
        return ((4 * hd * pairs * B * H, 2 * nb(q) + nb(k, v) + lse),
                (10 * hd * pairs * B * H, 2 * nb(q, k, v) + 2 * nb(q) + lse))
    if name == "flash_decode":
        q, k, v, kpos, pos = args
        B, H, hd = q.shape
        n_valid = int(((kpos >= 0) & (kpos <= pos)).sum())
        return (4 * hd * H * n_valid, 2 * nb(q) + 2 * n_valid * k.shape[1] * hd * 4 + nb(kpos)), None
    if name == "wkv6":
        r, k, v, w, u, st = args
        N = r.shape[-1]
        return ((4 * r.numel() * N, nb(r, k, v, w, u) + 2 * nb(st) + nb(r)),
                (10 * r.numel() * N, 2 * nb(r, k, v, r, w) + nb(u, st, st, u, st)))
    la, m, h0 = args
    return ((3 * la.numel(), nb(la, m, h0) + 4 * la.numel() + nb(h0)),
            (5 * la.numel(), nb(la, la, la, h0, h0, la, la, h0)))


KERNELS = ("rmsnorm", "flash_attention", "flash_decode", "wkv6", "rglru")


def _call(name, args, kw):
    return getattr(ops, name)(*args, **kw)


@pytest.mark.parametrize("name", KERNELS)
def test_fake_path_shapes_and_counts(name, monkeypatch):
    """On fake tensors each entry point returns the plain version's output
    shapes and dtypes, forward and (where it has one) backward, and adds
    its bound's FLOPs and bytes to the counter; no plain version runs and
    no kernel is reached."""
    args, kw = _inputs(name)
    real = [a.clone().requires_grad_() if torch.is_tensor(a) and a.is_floating_point()
            and name != "flash_decode" else a for a in args]
    want = _call(name, real, kw)
    want = want if isinstance(want, tuple) else (want,)
    if name != "flash_decode":
        grads_want = torch.autograd.grad(sum(w.float().sum() for w in want),
                                         [a for a in real if torch.is_tensor(a)
                                          and a.requires_grad])

    def boom(*a, **k):
        raise AssertionError("the plain version or the kernel ran on fake tensors")

    for table in (ops._FWD, ops._BWD):
        if name in table:
            monkeypatch.setitem(table[name], "plain", boom)
            monkeypatch.setitem(table[name], "kernel", boom)
    fwd, bwd = _formula(name, args, kw)
    with FakeTensorMode() as mode:
        fargs = [mode.from_tensor(a).requires_grad_(name != "flash_decode")
                 if torch.is_tensor(a) and a.is_floating_point() else
                 (mode.from_tensor(a) if torch.is_tensor(a) else a) for a in args]
        with StepCounter() as c:
            got = _call(name, fargs, kw)
            got = got if isinstance(got, tuple) else (got,)
        assert [(tuple(t.shape), t.dtype) for t in got] == [
            (tuple(t.shape), t.dtype) for t in want]
        assert c.kernels[name] == {"calls": 1, "flops": fwd[0], "bytes": fwd[1]}
        if name != "flash_decode":
            with StepCounter() as cb:
                grads = torch.autograd.grad(sum(t.float().sum() for t in got),
                                            [a for a in fargs if torch.is_tensor(a)
                                             and a.requires_grad])
            assert [(tuple(t.shape), t.dtype) for t in grads] == [
                (tuple(t.shape), t.dtype) for t in grads_want]
            k = cb.kernels[f"{name}_bwd"]
            assert (k["calls"], k["flops"]) == (1, bwd[0])
            assert k["bytes"] == bwd[1]


def test_prefill_32k_attention_peak_holds_no_score_tensor():
    """A prefill_32k attention call (gemma-2b's 8 heads of 256, a batch row)
    on fake tensors under MemTracker peaks below one (B, H, S, S) float32
    score tensor: the fake path allocates only the kernel's outputs."""
    B, H, S, hd = 1, 8, 32768, 256
    with FakeTensorMode():
        tracker = MemTracker()
        with tracker:
            q = torch.empty((B, H, S, hd), dtype=torch.bfloat16)
            k = torch.empty((B, 1, S, hd), dtype=torch.bfloat16)
            v = torch.empty((B, 1, S, hd), dtype=torch.bfloat16)
            out = ops.flash_attention(q, k, v)
        peak = sum(s["Total"] for s in tracker.get_tracker_snapshot("peak").values())
    assert out.shape == q.shape
    assert peak < B * H * S * S * 4
    assert peak == 2 * q.numel() * 2 + 2 * k.numel() * 2  # q, k, v and the output


# ---------------------------------------------------------------------------
# the counter's collectives against the reference's HLO reading
# ---------------------------------------------------------------------------

_COLLECTIVES = """
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.roofline.counter import StepCounter
from repro_torch.sharding import collectives as C
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = DeviceMesh("cpu", torch.arange(4).view(1, 4), mesh_dim_names=("data", "model"))
with StepCounter() as c:
    C.psum(torch.zeros(1024), mesh, "model")
    C.all_gather(torch.zeros(8, 16), mesh, "model", dim=0)
    C.psum_scatter(torch.zeros(32, 16), mesh, "model", dim=0)
    C.pmax(torch.zeros(8, 8, dtype=torch.bfloat16), mesh, "model")
print(json.dumps(c.stats()["collectives"]))
dist.destroy_process_group()
"""

_HLO = """
HloModule collectives

ENTRY %main (a: f32[1024], b: f32[8,16], c: f32[32,16], d: bf16[8,8]) -> f32[1024] {
  %a = f32[1024]{0} parameter(0)
  %b = f32[8,16]{1,0} parameter(1)
  %c = f32[32,16]{1,0} parameter(2)
  %d = bf16[8,8]{1,0} parameter(3)
  %ar = f32[1024]{0} all-reduce(%a), replica_groups={{0,1,2,3}}
  %ag = f32[32,16]{1,0} all-gather(%b), dimensions={0}, replica_groups={{0,1,2,3}}
  %rs = f32[8,16]{1,0} reduce-scatter(%c), dimensions={0}, replica_groups={{0,1,2,3}}
  %mx = bf16[8,8]{1,0} all-reduce(%d), replica_groups={{0,1,2,3}}
  ROOT %t = f32[1024]{0} copy(%ar)
}
"""


def test_counter_collectives_equal_module_stats():
    """The counter's count, operand bytes and wire bytes of psum, all_gather,
    psum_scatter and pmax on a fake group equal the reference's
    ``module_stats`` on HLO text holding the same collectives."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(REPO / "src"), os.environ.get("PYTHONPATH")) if p)}
    out = subprocess.run([sys.executable, "-c", _COLLECTIVES], env=env, capture_output=True,
                         text=True, timeout=CELL_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    want = module_stats(_HLO)["collectives"]
    assert got == {k: {f: float(v[f]) for f in ("count", "operand_bytes", "wire_bytes")}
                   for k, v in want.items()}


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------


def test_report_tables_equal_the_references(cells, tmp_path):
    """The report's tables from the cells' JSONs (and a hillclimb row of each
    arch) equal the reference's from the same JSONs, but for the HBM
    column's label."""
    for name, r in cells.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(r))
    mine, ref = report.load(str(tmp_path)), jax_report.load(str(tmp_path))
    assert mine == ref
    for mesh in ("single", "multi"):
        assert report.roofline_table(mine, mesh, "baseline") == jax_report.roofline_table(
            ref, mesh, "baseline").replace("fits 16GB", "fits 80GB")
    for arch in ("gemma-2b", "olmoe-1b-7b", "phi-3-vision-4.2b", "kimi-k2-1t-a32b"):
        assert report.perf_rows(mine, arch) == jax_report.perf_rows(ref, arch)
    n_ok, n_skip, n_err, _ = report.dryrun_summary(mine)
    assert (n_ok, n_skip, n_err) == (12, 1, 4)  # whisper's train cell runs
