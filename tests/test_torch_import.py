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
print(" ".join(names))
assert not bad, bad
"""

# the paper's path (fault-tolerance machinery, strategies, simulator, genome job)
PAPER_MODULES = (
    "repro_torch.configs.paper_genome",
    "repro_torch.core", "repro_torch.core.agent", "repro_torch.core.checkpoint",
    "repro_torch.core.cluster", "repro_torch.core.failure", "repro_torch.core.heartbeat",
    "repro_torch.core.hybrid", "repro_torch.core.migration", "repro_torch.core.predictor",
    "repro_torch.core.rules", "repro_torch.core.runtime", "repro_torch.core.sim",
    "repro_torch.core.virtual_core",
    "repro_torch.data", "repro_torch.data.genome",
    "repro_torch.launch.genome", "repro_torch.launch.tables",
    "repro_torch.strategies", "repro_torch.strategies.base", "repro_torch.strategies.builtin",
    "repro_torch.strategies.costmodel", "repro_torch.strategies.placement",
    "repro_torch.strategies.registry",
    "repro_torch.utils", "repro_torch.utils.device", "repro_torch.utils.tree",
)


# the campaign path (telemetry, workloads, scenarios, the replay fold,
# Monte-Carlo, metric frames, arrivals, straggler handling)
CAMPAIGN_MODULES = (
    "repro_torch.core.straggler",
    "repro_torch.launch.campaign",
    "repro_torch.obs", "repro_torch.obs.metrics",
    "repro_torch.scenarios", "repro_torch.scenarios.engine", "repro_torch.scenarios.montecarlo",
    "repro_torch.scenarios.registry", "repro_torch.scenarios.spec",
    "repro_torch.scenarios.trajectory",
    "repro_torch.telemetry", "repro_torch.telemetry.builtin", "repro_torch.telemetry.detector",
    "repro_torch.telemetry.frame", "repro_torch.telemetry.registry",
    "repro_torch.traffic", "repro_torch.traffic.arrivals",
    "repro_torch.workloads", "repro_torch.workloads.base", "repro_torch.workloads.builtin",
    "repro_torch.workloads.registry",
)


# the paper's figures and the campaign's serving branch (SLO billing,
# autoscalers, traces, profiling, the roofline the LLM workloads price on)
SERVING_MODULES = (
    "repro_torch.launch.figures",
    "repro_torch.obs.export", "repro_torch.obs.profile", "repro_torch.obs.trace",
    "repro_torch.roofline", "repro_torch.roofline.analysis",
    "repro_torch.traffic.autoscale", "repro_torch.traffic.registry", "repro_torch.traffic.slo",
    "repro_torch.utils.timing",
)


# the training path (train step, optimizers, synthetic data, the FT trainer,
# elastic re-planning, speculative egress, the launchers)
TRAIN_MODULES = (
    "repro_torch.core.elastic", "repro_torch.core.speculative", "repro_torch.core.trainer",
    "repro_torch.data.synthetic",
    "repro_torch.launch.fig15", "repro_torch.launch.train",
    "repro_torch.train", "repro_torch.train.optim", "repro_torch.train.step",
)


# sharding over a mesh (logical-axis rules, collectives, the pipeline, the
# host and production meshes, elastic re-meshing)
SHARDING_MODULES = (
    "repro_torch.core.elastic", "repro_torch.launch.mesh",
    "repro_torch.sharding", "repro_torch.sharding.collectives", "repro_torch.sharding.pipeline",
    "repro_torch.sharding.rules",
)


# the live orchestrator (daemon, worker, spool, injectors, planning oracle,
# test doubles, CLI)
ORCHESTRATOR_MODULES = (
    "repro_torch.orchestrator", "repro_torch.orchestrator.__main__",
    "repro_torch.orchestrator.cli", "repro_torch.orchestrator.contract",
    "repro_torch.orchestrator.daemon", "repro_torch.orchestrator.injector",
    "repro_torch.orchestrator.plan", "repro_torch.orchestrator.registry",
    "repro_torch.orchestrator.spool", "repro_torch.orchestrator.testing",
    "repro_torch.orchestrator.worker",
)


# the "model"-axis split and the dry run (fake tensors over a fake process
# group, the counter, the kernels' shape-only path, the sweep, the report)
DRYRUN_MODULES = (
    "repro_torch.kernels.fake", "repro_torch.launch.dryrun", "repro_torch.launch.dryrun_all",
    "repro_torch.roofline.counter", "repro_torch.roofline.report", "repro_torch.sharding.tp",
)


# the served configs, each registering on import (whisper-tiny since the
# encoder-decoder slice)
CONFIG_MODULES = (
    "repro_torch.configs.deepseek_7b", "repro_torch.configs.gemma_2b",
    "repro_torch.configs.granite_3_2b", "repro_torch.configs.olmoe_1b_7b",
    "repro_torch.configs.qwen25_3b", "repro_torch.configs.recurrentgemma_9b",
    "repro_torch.configs.rwkv6_1b6", "repro_torch.configs.whisper_tiny",
    "repro_torch.configs.phi3_vision",
)


@pytest.fixture(scope="module")
def import_all():
    """One interpreter that imports every module of the port: (count, names)."""
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
                         text=True, env={"PYTHONPATH": str(REPO / "src"), "PATH": ""},
                         timeout=120)
    assert res.returncode == 0, res.stderr
    count, names = res.stdout.splitlines()[:2]
    return int(count.split()[0]), names.split()


def test_import_every_module_loads_no_jax(import_all):
    n_modules, _ = import_all
    assert n_modules >= 15 + len(PAPER_MODULES) + len(CAMPAIGN_MODULES) + len(SERVING_MODULES) \
        + len(TRAIN_MODULES)


@pytest.mark.parametrize("module", CONFIG_MODULES)
def test_config_module_imported_without_jax(module, import_all):
    """Each served config's module is among those the no-jax import loads."""
    assert module in import_all[1]


@pytest.mark.parametrize("module", PAPER_MODULES)
def test_paper_module_imported_without_jax(module, import_all):
    """Each module of the paper's path is among those the no-jax import loads."""
    assert module in import_all[1]


@pytest.mark.parametrize("module", CAMPAIGN_MODULES)
def test_campaign_module_imported_without_jax(module, import_all):
    """Each module of the campaign path is among those the no-jax import loads."""
    assert module in import_all[1]


@pytest.mark.parametrize("module", SERVING_MODULES)
def test_serving_module_imported_without_jax(module, import_all):
    """Each module of the figures and the serving branch is among those the
    no-jax import loads."""
    assert module in import_all[1]


@pytest.mark.parametrize("module", TRAIN_MODULES)
def test_train_module_imported_without_jax(module, import_all):
    """Each module of the training path is among those the no-jax import
    loads."""
    assert module in import_all[1]


@pytest.mark.parametrize("module", SHARDING_MODULES)
def test_sharding_module_imported_without_jax(module, import_all):
    """Each module of the sharding slice is among those the no-jax import
    loads."""
    assert module in import_all[1]


@pytest.mark.parametrize("module", ORCHESTRATOR_MODULES)
def test_orchestrator_module_imported_without_jax(module, import_all):
    """Each module of the live orchestrator is among those the no-jax import
    loads (``__main__`` too: its CLI call is guarded)."""
    assert module in import_all[1]


@pytest.mark.parametrize("module", DRYRUN_MODULES)
def test_dryrun_module_imported_without_jax(module, import_all):
    """Each module of the "model"-axis split and the dry run is among those
    the no-jax import loads."""
    assert module in import_all[1]


def test_host_mesh_on_cuda_without_a_card_raises(monkeypatch):
    """``make_host_mesh`` and ``remesh_rules`` build on the card unless the
    caller asks for the CPU, and never go on on the CPU without one."""
    from repro_torch.core.elastic import remesh_rules
    from repro_torch.launch.mesh import make_host_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        make_host_mesh(1, 1)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        remesh_rules(1, 1)


def test_trainer_reached_from_core_without_a_cycle():
    """``repro_torch.core.FTTrainer`` resolves, and importing it first thing
    leaves ``repro_torch.telemetry`` importable (no cycle through core)."""
    code = ("from repro_torch.core import FTTrainer, FTReport\n"
            "import repro_torch.telemetry\n"
            "assert FTTrainer.__module__ == 'repro_torch.core.trainer'")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env={"PYTHONPATH": str(REPO / "src"), "PATH": ""}, timeout=120)
    assert res.returncode == 0, res.stderr


def test_cold_telemetry_import_is_not_circular():
    """``import repro_torch.telemetry`` works first thing in an interpreter
    (the reference's needs ``repro.core`` imported before it)."""
    res = subprocess.run([sys.executable, "-c", "import repro_torch.telemetry"], cwd=REPO,
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(REPO / "src"), "PATH": ""}, timeout=120)
    assert res.returncode == 0, res.stderr


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

    # every arch of the reference's registry is ported: a name that neither
    # package registers
    with pytest.raises(KeyError, match="not ported"):
        get_arch("llama-3-8b")
    cfg = get_arch("gemma-2b")
    for change in (dict(kv_cache_dtype="fp8"), dict(block_pattern=("rec", "full"))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(dataclasses.replace(cfg, **change))
