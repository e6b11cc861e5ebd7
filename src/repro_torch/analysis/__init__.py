"""Static invariant linter for the PyTorch port: AST-level proofs of the
port's correctness contracts, run before any test executes (counterpart
of ``repro/analysis``).

The port's guarantees (the torch replay fold trial-for-trial identical
to :class:`~repro_torch.scenarios.engine.CampaignEngine`, a training run
under any fault-tolerance policy bit-identical to a failure-free one) are
enforced at runtime by differential tests, which catch only the drift
they happen to execute. This package is the inspection layer beside
them: a stdlib-``ast`` pass (nothing is imported or executed, and
nothing of ``repro`` is used) over ``src/repro_torch``, its tests
(``tests/test_torch_*.py``, ``tests/torch_mesh.py``) and ``chip_smoke.py``,
which stands in for the bench matrix. It proves six invariant families:

``traced-purity``
    no impure call (wall clock, global RNG, stdout, file I/O, module-
    global mutation) is reachable from a function whose result must be a
    pure function of its tensors: ``forward`` / ``backward`` of every
    ``torch.autograd.Function``, the replay fold that
    ``scenarios/trajectory.py::_compiled_replayer`` builds (and caches),
    ``scenarios/montecarlo.py::_mc_totals_draw``, the workload cost
    surfaces, and any function handed to ``torch.compile``, ``torch.vmap``
    or ``torch.utils.checkpoint`` (which re-runs it in the backward). The
    global torch RNG counts as impure: the port draws from explicit
    ``torch.Generator`` objects.
``parity-coverage``
    every DSL process kind (``scenarios/spec.py``) and every
    ``TraceEvent`` kind (``obs/trace.py``) is threaded through all of its
    consumer sites: dispatch, scenario families, engine-side emitters,
    fold-side reconstruction, tests.
``registry-completeness``
    every ``@register``-ed strategy / detector / workload / autoscaler /
    injector and every scenario family reaches ``chip_smoke.py`` and at
    least one ``test_torch_*`` file.
``units-s``
    time-valued names carry the ``_s`` suffix and seconds never mix with
    other unit suffixes under ``+``/``-``.
``dtype-x64``
    the float64 fold's modules and the kernel modules construct tensors
    and arrays with explicit dtypes, and the fold's modules carry no
    32/16-bit float literals or casts.
``no-wallclock-in-sim``
    only the live orchestrator (and ``obs/profile.py``) reads the wall
    clock or owns an event loop.

Run it as ``python -m repro_torch.analysis src/repro_torch`` (text
report, nonzero exit on findings) or ``--json`` for the machine-readable
record. Suppress a deliberate violation with ``# repro: ignore[rule]`` on
the flagged line, or a whole file with ``# repro: ignore-file[rule]``:
the reference's linter reads the same comments, so one suppression
serves both.

Rules live in a registration-ordered registry: ``@register("my-rule")``
on a :class:`~repro_torch.analysis.base.Rule` subclass adds it to every
run, the CLI, and the JSON schema at once.
"""
from repro_torch.analysis.base import Rule
from repro_torch.analysis.findings import Finding, SEVERITIES
from repro_torch.analysis.project import ModuleSource, Project
from repro_torch.analysis.registry import all_rules, get, names, register, unregister
from repro_torch.analysis.runner import run_analysis

__all__ = [
    "Finding",
    "SEVERITIES",
    "Rule",
    "ModuleSource",
    "Project",
    "register",
    "unregister",
    "get",
    "names",
    "all_rules",
    "run_analysis",
]
