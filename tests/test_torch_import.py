"""The PyTorch port stands alone: it imports neither jax nor the JAX package,
and its entry points refuse to fall back to the CPU quietly."""
import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
"""


def test_import_every_module_loads_no_jax():
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
                         text=True, env={"PYTHONPATH": str(REPO / "src"), "PATH": ""},
                         timeout=120)
    assert res.returncode == 0, res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 15


def _forbidden(name: str) -> bool:
    return name in ("jax", "repro") or name.startswith(("jax.", "repro."))


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, node.lineno, names)


def test_serve_without_cuda_and_without_device_cpu_raises(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--new-tokens", "3"])


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never run their plain version themselves."""
    from repro_torch.kernels import decode_attention, flash_attention, rglru, rmsnorm, rwkv6

    x = torch.zeros((2, 16), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm.rmsnorm(x, torch.ones((16,), dtype=torch.float32))
    q = torch.zeros((1, 2, 8, 16), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(q, q[:, :1], q[:, :1])
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention.flash_decode(q[:, :, 0], q[:, :1], q[:, :1],
                                      torch.zeros((1, 8), dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6.wkv6(q, q, q, q, torch.zeros((2, 16)), torch.zeros((1, 2, 16, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        rglru.rglru(q[0], q[0], q[0, :, 0])


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_unported_configs_raise():
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    with pytest.raises(KeyError, match="not ported"):
        get_arch("olmoe-1b-7b")
    cfg = get_arch("gemma-2b")
    for change in (dict(moe=True), dict(encoder_layers=1), dict(num_img_tokens=4),
                   dict(block_pattern=("rec", "full"))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(dataclasses.replace(cfg, **change))
