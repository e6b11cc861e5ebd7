"""The rmsnorm backward's partition and its order of dscale sums
(``csrc/rmsnorm.cu``: ``rmsnorm_bwd_warp_kernel``, ``rmsnorm_bwd_kernel``
and the second pass ``rmsnorm_dscale_kernel``), emulated in float32 torch
and held against the port's plain version and ``jax.vjp`` of the
reference's norm on the same numpy inputs.

The order, fixed by ``rmsnorm.bwd_plan`` from (rows, d) alone:
- warp kernel: slot s of block b adds rows b·per + s + k·slots in k order
  (a lane's register accumulator); the block adds its slots' sums in slot
  order into its partial row;
- block kernel: block b adds its rows b·per, b·per + 1, ... in order;
- second pass: the partial rows in block order within SUM_RUNS runs of
  ceil(blocks / SUM_RUNS) consecutive blocks, then the runs in run order.
Each term is dy·x·r with r = rsqrt(mean(x²) + eps). The kernel fuses a
term's last product into its add (an FMA); the emulation rounds the two
apart, so it checks the order, and on the card ``chip_smoke.py`` holds the
kernels themselves against ``rmsnorm_bwd_ref``.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import norm_apply as jax_norm_apply
from repro_torch.kernels import rmsnorm as rn

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

BWD_TOL = (1e-4, 1e-4)  # chip_smoke.BWD_TOL["float32"]: (atol, rtol)


def slot_rows(rows, d):
    """Every (block, slot, row) of the warp kernel's partition, as numpy
    arrays, in the kernel's order."""
    blocks, per, slots = rn.bwd_plan(rows, d)
    b = np.arange(blocks)[:, None, None]
    s = np.arange(slots)[None, :, None]
    k = np.arange(per // slots)[None, None, :]
    row = np.broadcast_to(b * per + k * slots + s, (blocks, slots, per // slots))
    live = row < rows
    return (np.broadcast_to(b, row.shape)[live], np.broadcast_to(s, row.shape)[live],
            row[live])


def emulate_dscale(x, dy, eps=1e-6, route="warp"):
    """dscale of float32 numpy x, dy (rows, d) in the kernel's order of sums."""
    xf, gf = torch.from_numpy(x), torch.from_numpy(dy)
    rows, d = xf.shape
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    terms = gf * xf * r
    blocks, per, slots = rn.bwd_plan(rows, d)
    part = torch.zeros(blocks, d)
    for b in range(blocks):
        end = min((b + 1) * per, rows)
        if route == "warp":
            sums = []
            for s in range(slots):
                acc = torch.zeros(d)
                for row in range(b * per + s, end, slots):
                    acc = acc + terms[row]
                sums.append(acc)
            block = sums[0]
            for acc in sums[1:]:
                block = block + acc
        else:
            block = torch.zeros(d)
            for row in range(b * per, end):
                block = block + terms[row]
        part[b] = block
    run = -(-blocks // rn.SUM_RUNS)
    runs = []
    for w in range(rn.SUM_RUNS):
        acc = torch.zeros(d)
        for b in range(w * run, min((w + 1) * run, blocks)):
            acc = acc + part[b]
        runs.append(acc)
    total = runs[0]
    for acc in runs[1:]:
        total = total + acc
    return total


@pytest.mark.parametrize("route", ["warp", "block"])
@pytest.mark.parametrize("shape", [(2049, 256), (513, 2048), (7, 4096), (37, 100), (1, 64)])
def test_dscale_order_matches_plain_and_jax(shape, route):
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    x, dy = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    got = emulate_dscale(x, dy, route=route).numpy()
    _, want_plain = rn.rmsnorm_bwd_ref(torch.from_numpy(x), torch.from_numpy(scale),
                                      torch.from_numpy(dy))
    _, vjp = jax.vjp(lambda a, s: jax_norm_apply({"scale": s}, a), jnp.asarray(x),
                     jnp.asarray(scale))
    want_jax = np.asarray(vjp(jnp.asarray(dy))[1])
    np.testing.assert_allclose(got, want_plain.numpy(), atol=BWD_TOL[0], rtol=BWD_TOL[1])
    np.testing.assert_allclose(got, want_jax, atol=BWD_TOL[0], rtol=BWD_TOL[1])


def test_dscale_order_is_the_partition_not_rows_in_turn():
    """Terms whose float32 sum depends on the order: the emulation's order
    (two slots of one block, 2049 rows over runs of blocks) gives a sum
    other than rows added one after another, and the same sum every time."""
    rows, d = 2049, 2048
    x = np.ones((rows, d), np.float32)
    dy = np.zeros((rows, d), np.float32)
    dy[::2] = 1e8  # the big terms fall in one slot, the ones in the other
    dy[1::2] = 1.0
    got = emulate_dscale(x, dy)
    again = emulate_dscale(x, dy)
    terms = torch.from_numpy(dy) * torch.rsqrt(torch.tensor(1.0 + 1e-6))
    in_turn = torch.zeros(d)
    for row in range(rows):
        in_turn = in_turn + terms[row]
    assert torch.equal(got, again)
    assert not torch.equal(got, in_turn)


@pytest.mark.parametrize("d", [64, 100, 2048, 3072, 4096])
@pytest.mark.parametrize("rows", [1, 7, 511, 512, 513, 2048, 2049, 100003])
def test_partition_covers_every_row_once(rows, d):
    blocks, per, slots = rn.bwd_plan(rows, d)
    assert 1 <= blocks <= rn.BWD_MAX_BLOCKS
    assert 1 <= slots <= rn.BWD_MAX_WARPS and per % slots == 0
    assert slots == 1 or slots * d <= rn.BWD_SLOT_ELEMS  # the block's sums in shared memory
    assert blocks * per >= rows > (blocks - 1) * per  # every block owns a row
    _, _, row = slot_rows(rows, d)
    np.testing.assert_array_equal(np.sort(row), np.arange(rows))
    for element_size in (2, 4):  # a block of the warp kernel fits
        split = rn.bwd_warp_split(d, element_size)
        if split is not None:
            packs, warps = split
            assert warps * packs * 32 * 16 == d * element_size
            assert slots * warps <= rn.BWD_MAX_WARPS


def test_partition_depends_on_rows_and_width_alone(monkeypatch):
    assert list(inspect.signature(rn.bwd_plan).parameters) == ["rows", "d"]
    want = [rn.bwd_plan(rows, d) for rows in (7, 2049, 100003) for d in (100, 2048)]

    def no_card(*_a, **_k):
        raise AssertionError("bwd_plan asked the card")

    for name in ("device_count", "get_device_properties", "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    assert [rn.bwd_plan(rows, d) for rows in (7, 2049, 100003) for d in (100, 2048)] == want


@pytest.mark.parametrize("d, element_size, want", [
    (2048, 2, (2, 4)),   # gemma-2b, bf16: a row over four warps
    (4096, 2, (2, 8)),   # recurrentgemma-9b / deepseek-7b, bf16
    (2048, 4, (4, 4)),   # gemma-2b, float32
    (4096, 4, (4, 8)),
    (3072, 2, (2, 6)),   # phi-3-vision's width: six warps
    (1024, 2, (2, 2)),
    (768, 2, (1, 3)),
    (384, 4, (1, 3)),
    (256, 2, (1, 1)),
    (128, 4, (1, 1)),
    (8192, 2, None),     # 16 warps: the block kernel
    (7168, 2, None),     # 14 warps
    (384, 2, None),      # 768 bytes: not a multiple of 512
    (100, 2, None),
    (64, 4, None),
])
def test_warp_split(d, element_size, want):
    assert rn.bwd_warp_split(d, element_size) == want
