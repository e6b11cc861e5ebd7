"""repro_torch.analysis: the port's invariant linter and its own contract.

The same layers as ``tests/test_analysis.py`` holds the reference's
linter to: the torch-side fixture corpus (each intentional violation
fires its rule and no other, exit code 1), the CLI surface (JSON schema,
rule selection, suppression comments, exit codes), the scope of a run
(``src/repro_torch`` with the port's tests and ``chip_smoke.py``, never
the reference), and the meta-test: the port is clean at HEAD."""
import json
import shutil
from pathlib import Path

import pytest

from repro_torch.analysis import Finding, Rule, names, run_analysis
from repro_torch.analysis.cli import JSON_SCHEMA_VERSION, main, resolve_paths
from repro_torch.analysis.project import Project
from repro_torch.analysis.registry import all_rules, get, register, unregister

pytestmark = pytest.mark.analysis

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FIXTURES = REPO / "tests" / "fixtures" / "analysis_torch"
#: the default `*/fixtures/*` exclude must be overridden to scan the corpus
NO_EXCLUDE = ("--exclude", "*/__none__/*")

RULE_FAMILIES = ("traced-purity", "parity-coverage", "registry-completeness",
                 "units-s", "dtype-x64", "no-wallclock-in-sim")

#: fixture file -> (rule that must fire, symbol of the expected finding)
CORPUS = {
    "bad_purity.py": ("traced-purity", "_Noisy.forward"),
    "bad_purity_nested.py": ("traced-purity", "block"),
    "bad_purity_inplace.py": ("traced-purity", "body"),
    "bad_purity_seed.py": ("traced-purity", "_Reseed.backward"),
    "bad_parity_process.py": ("parity-coverage", "doom"),
    "bad_parity_trace.py": ("parity-coverage", "ghost"),
    "bad_registry.py": ("registry-completeness", "_orphan"),
    "bad_units.py": ("units-s", "Window.duration"),
    "bad_dtype.py": ("dtype-x64", "zeros"),
    "bad_dtype_narrow.py": ("dtype-x64", "float32"),
    "bad_wallclock.py": ("no-wallclock-in-sim", "time.monotonic"),
}


#: fixtures linted at a path of the rule's scope, not their own: the dtype
#: rule's x64 modules are the fold's, by path
LINTED_AS = {
    "bad_dtype.py": "repro_torch/scenarios/trajectory.py",
    "bad_dtype_narrow.py": "repro_torch/scenarios/montecarlo.py",
}


def run_cli(capsys, *argv):
    code = main(list(argv))
    return code, capsys.readouterr().out


def lint(tmp_path, capsys, rel: str, src: str, *argv):
    """Write ``src`` at ``tmp_path / rel`` and lint that file alone; a
    ``pytest.ini`` makes ``tmp_path`` the root its findings are relative to."""
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(src)
    return run_cli(capsys, str(p), "--no-siblings", *argv)


def lint_fixture(tmp_path, capsys, fixture: str, *argv):
    """Lint one fixture of the corpus alone: in place, or at its
    ``LINTED_AS`` path under ``tmp_path``."""
    if fixture in LINTED_AS:
        return lint(tmp_path, capsys, LINTED_AS[fixture], (FIXTURES / fixture).read_text(), *argv)
    return run_cli(capsys, str(FIXTURES / fixture), "--no-siblings", *NO_EXCLUDE, *argv)


# ------------------------------------------------------------ registry ---
def test_all_rule_families_registered_in_order():
    assert names() == list(RULE_FAMILIES)
    for rule in all_rules():
        assert rule.name in RULE_FAMILIES
        assert rule.description


def test_rule_registry_register_unregister_roundtrip():
    @register("throwaway-rule")
    class Throwaway(Rule):
        description = "test-local"

        def check(self, project):
            return []

    try:
        assert "throwaway-rule" in names()
        assert isinstance(get("throwaway-rule"), Throwaway)
        with pytest.raises(KeyError):
            register("throwaway-rule")(Throwaway)  # no silent overwrite
        with pytest.raises(TypeError):
            register("not-a-rule")(object)  # must subclass Rule
    finally:
        unregister("throwaway-rule")
    assert "throwaway-rule" not in names()
    with pytest.raises(KeyError):
        get("throwaway-rule")


# ------------------------------------------------------ fixture corpus ---
def test_corpus_is_the_fixture_directory():
    assert sorted(CORPUS) == sorted(p.name for p in FIXTURES.glob("*.py"))


@pytest.mark.parametrize("fixture,expected", sorted(CORPUS.items()))
def test_fixture_fires_its_rule(tmp_path, capsys, fixture, expected):
    rule, symbol = expected
    code, out = lint_fixture(tmp_path, capsys, fixture)
    assert code == 1, out
    assert f"{rule} (error) [{symbol}]" in out


@pytest.mark.parametrize("fixture,expected", sorted(CORPUS.items()))
def test_fixture_clean_under_every_other_rule(tmp_path, capsys, fixture, expected):
    """Each fixture violates exactly its own family: rule precision."""
    rule, _ = expected
    others = ",".join(r for r in RULE_FAMILIES if r != rule)
    code, out = lint_fixture(tmp_path, capsys, fixture, "--rules", others)
    assert code == 0, out


@pytest.mark.parametrize("fixture,fix", [
    ("bad_purity.py", ("torch.randn(x.shape)", "torch.randn(x.shape, generator=ctx.gen)")),
    ("bad_purity_inplace.py", (".uniform_()", ".uniform_(generator=self.gen)")),
    ("bad_dtype.py", ("torch.zeros(n_hosts)", "torch.zeros(n_hosts, dtype=torch.float64)")),
    ("bad_units.py", ("duration: float", "duration_s: float")),
])
def test_fixture_fixed_goes_clean_of_its_finding(tmp_path, capsys, fixture, fix):
    """The fix each message asks for silences that finding: an explicit
    generator, an explicit dtype, a unit suffix."""
    src = (FIXTURES / fixture).read_text()
    assert fix[0] in src
    rule, symbol = CORPUS[fixture]
    rel = LINTED_AS.get(fixture, fixture)
    code, out = lint(tmp_path, capsys, rel, src.replace(fix[0], fix[1]), "--rules", rule)
    assert f"[{symbol}]" not in out


def test_parity_fires_when_kind_removed_from_handler_site(tmp_path, capsys):
    """Removing a dispatch arm (process kind) or a fold-side emit (trace
    kind) from an otherwise-covered fixture copy flips it dirty."""
    clean_proc = (FIXTURES / "bad_parity_process.py").read_text().replace(
        'if proc.kind == "periodic":', 'if proc.kind in ("periodic", "doom"):')
    assert lint(tmp_path, capsys, "proc.py", clean_proc)[0] == 0
    code, out = lint(tmp_path, capsys, "proc.py", clean_proc.replace(
        'proc.kind in ("periodic", "doom")', 'proc.kind in ("periodic",)'))
    assert code == 1 and "doom" in out and "never dispatched" in out

    emits = 'def reconstruct_traces(rec, t):\n    rec.emit(t, "failure")'
    clean_trace = (FIXTURES / "bad_parity_trace.py").read_text().replace(
        emits, emits + '\n    rec.emit(t, "ghost")')
    assert lint(tmp_path, capsys, "trace.py", clean_trace)[0] == 0
    code, out = lint(tmp_path, capsys, "trace.py", clean_trace.replace(
        emits + '\n    rec.emit(t, "ghost")', emits))
    assert code == 1 and "ghost" in out and "fold-side" in out


# ------------------------------------------------------ torch-side rules ---
@pytest.mark.parametrize("call,dirty", [
    ("torch.zeros(n)", True),
    ("torch.full((n,), 1.0)", True),
    ("torch.arange(n)", True),
    ("torch.tensor([1.0])", True),
    ("torch.as_tensor(x)", True),
    ("np.zeros(n)", True),
    ("np.asarray(x)", True),
    ("torch.zeros(n, dtype=torch.float64)", False),
    ("torch.as_tensor(x, torch.int32)", False),  # dtype by position
    ("np.zeros(n, np.float64)", False),
    ("torch.zeros_like(x)", False),  # takes x's dtype, by definition
])
def test_dtype_constructors_on_the_fold_path(tmp_path, capsys, call, dirty):
    """The fold's own path is an x64 module by its path alone."""
    src = f"import numpy as np\nimport torch\n\n\ndef f(n, x):\n    return {call}\n"
    code, out = lint(tmp_path, capsys, "repro_torch/scenarios/trajectory.py", src,
                     "--rules", "dtype-x64")
    assert code == int(dirty), out


def test_kernel_modules_need_dtypes_but_may_be_narrow(tmp_path, capsys):
    src = ("import torch\n\n\ndef buf(n):\n    return torch.empty(n).to(torch.bfloat16)\n")
    code, out = lint(tmp_path, capsys, "repro_torch/kernels/k.py", src, "--rules", "dtype-x64")
    assert code == 1 and "in a kernel module" in out
    assert out.count("dtype-x64 (error)") == 1  # bf16 is a kernel's business
    fixed = src.replace("torch.empty(n)", "torch.empty(n, dtype=torch.float32)")
    assert lint(tmp_path, capsys, "repro_torch/kernels/k.py", fixed, "--rules", "dtype-x64")[0] == 0
    # the same code outside the kernel and fold modules is none of the rule's business
    assert lint(tmp_path, capsys, "repro_torch/models/m.py", src, "--rules", "dtype-x64")[0] == 0


@pytest.mark.parametrize("call,dirty", [
    ("torch.rand(3)", True),
    ("torch.randint(0, 4, (3,))", True),
    ("torch.randperm(3)", True),
    ("torch.normal(0.0, 1.0, (3,))", True),
    ("torch.seed()", True),
    ("x.normal_()", True),
    ("np.random.rand(3)", True),
    ("print(x)", True),
    ("torch.rand(3, generator=gen)", False),
    ("torch.randperm(3, generator=gen)", False),
    ("x.normal_(generator=gen)", False),
    ("np.random.default_rng(0)", False),
    ("torch.Generator()", False),
])
def test_purity_global_rng_in_an_autograd_backward(tmp_path, capsys, call, dirty):
    src = ("import numpy as np\nimport torch\n\n\n"
           "class F(torch.autograd.Function):\n"
           "    @staticmethod\n    def forward(ctx, x):\n        return x\n\n"
           "    @staticmethod\n    def backward(ctx, x, gen=None):\n"
           f"        y = {call}\n        return x\n")
    code, out = lint(tmp_path, capsys, "mod.py", src, "--rules", "traced-purity")
    assert code == int(dirty), out
    assert not dirty or "[F.backward]" in out


@pytest.mark.parametrize("path,root", [
    ("repro_torch/scenarios/trajectory.py", "_compiled_replayer"),
    ("repro_torch/scenarios/montecarlo.py", "_mc_totals_draw"),
])
def test_purity_roots_the_fold_factory_and_the_mc_draw_by_path(tmp_path, capsys, path, root):
    """The factory is rooted with every closure it returns; the same code
    at another path is not a root."""
    src = (f"import time\n\n\ndef {root}(n):\n    def fold(x):\n"
           f"        return x + time.perf_counter()\n    return fold\n")
    code, out = lint(tmp_path, capsys, path, src, "--rules", "traced-purity")
    assert code == 1 and f"{path}:6: traced-purity (error) [{root}]" in out
    assert lint(tmp_path, capsys, "repro_torch/scenarios/other.py", src,
                "--rules", "traced-purity")[0] == 0


def test_purity_roots_workload_cost_surfaces(tmp_path, capsys):
    src = ("import time\n\n\nclass W:\n    def surfaces(self):\n"
           "        return {'t': time.perf_counter()}\n")
    code, out = lint(tmp_path, capsys, "repro_torch/workloads/w.py", src,
                     "--rules", "traced-purity")
    assert code == 1 and "[surfaces]" in out


def test_wallclock_allowed_in_the_port_s_orchestrator_only(tmp_path, capsys):
    src = "import time\n\n\ndef now_s():\n    return time.monotonic()\n"
    for rel, dirty in (("repro_torch/orchestrator/d.py", False),
                       ("repro_torch/obs/profile.py", False),
                       ("repro/orchestrator/d.py", True),
                       ("repro_torch/scenarios/engine.py", True)):
        code, out = lint(tmp_path, capsys, rel, src, "--rules", "no-wallclock-in-sim")
        assert code == int(dirty), (rel, out)


def test_registry_needs_chip_smoke_and_a_port_test(tmp_path, capsys):
    """A registered strategy counts as covered only when ``chip_smoke.py``
    (the bench) and a ``test_torch_*`` file name it or iterate names()."""
    pkg = tmp_path / "src" / "repro_torch" / "strategies"
    pkg.mkdir(parents=True)
    (pkg / "mine.py").write_text(
        "from repro_torch.strategies.registry import register\n\n\n"
        "@register(\"mine\")\nclass Mine:\n    pass\n")
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    tests = tmp_path / "tests"
    tests.mkdir()
    (tests / "test_torch_x.py").write_text("NAMES = ['mine']\n")
    (tmp_path / "chip_smoke.py").write_text("x = 1\n")
    src = str(tmp_path / "src" / "repro_torch")
    code, out = run_cli(capsys, src, "--rules", "registry-completeness")
    assert code == 1 and "bench matrix" in out and "no test module" not in out
    (tmp_path / "chip_smoke.py").write_text(
        "from repro_torch.strategies import registry\n\nfor n in registry.names():\n    pass\n")
    assert run_cli(capsys, src, "--rules", "registry-completeness")[0] == 0
    (tests / "test_torch_x.py").write_text("NAMES = []\n")
    code, out = run_cli(capsys, src, "--rules", "registry-completeness")
    assert code == 1 and "no test module" in out


# ------------------------------------------------------------ CLI shape ---
def test_list_rules_names_every_family(capsys):
    code, out = run_cli(capsys, "--list-rules")
    assert code == 0
    for rule in RULE_FAMILIES:
        assert rule in out


def test_json_output_schema(capsys):
    code, out = run_cli(capsys, str(FIXTURES / "bad_units.py"), "--json",
                        "--no-siblings", *NO_EXCLUDE)
    assert code == 1
    doc = json.loads(out)
    assert doc["schema_version"] == JSON_SCHEMA_VERSION
    assert doc["rules"] == list(RULE_FAMILIES)
    assert doc["n_files"] == 1 and doc["n_findings"] == 2
    assert doc["clean"] is False
    f = doc["findings"][0]
    assert set(f) == {"rule", "path", "line", "symbol", "msg", "severity"}
    assert f["rule"] == "units-s" and f["severity"] == "error"


def test_json_clean_tree(tmp_path, capsys):
    (tmp_path / "ok.py").write_text("x = 1\n")
    code, out = run_cli(capsys, str(tmp_path), "--json", "--no-siblings")
    assert code == 0
    doc = json.loads(out)
    assert doc["clean"] is True and doc["findings"] == []


def test_missing_path_exits_2(capsys):
    assert main([str(REPO / "no_such_dir_xyz")]) == 2


def test_rules_subset_selection(capsys):
    code, _ = run_cli(capsys, str(FIXTURES / "bad_units.py"), "--rules", "dtype-x64",
                      "--no-siblings", *NO_EXCLUDE)
    assert code == 0  # the units fixture is clean under the dtype rule


def test_fixtures_excluded_by_default(capsys):
    """Scanning the fixtures dir WITHOUT the exclude override finds no
    files: the corpus can never pollute a real run."""
    code, out = run_cli(capsys, str(FIXTURES), "--no-siblings")
    assert code == 0 and "0 file(s)" in out


def test_siblings_are_the_port_s_tests_and_chip_smoke():
    """``src/repro_torch`` pulls in ``tests/test_torch_*.py``,
    ``tests/torch_mesh.py`` and ``chip_smoke.py``; nothing of the reference
    (``src/repro``, its tests, ``benchmarks/``) and no fixture."""
    paths = resolve_paths([str(PORT)], no_siblings=False)
    extra = {p.relative_to(REPO).as_posix() for p in paths[1:]}
    assert {"tests/torch_mesh.py", "chip_smoke.py", "tests/test_torch_analysis.py"} <= extra
    assert all(e in ("tests/torch_mesh.py", "chip_smoke.py") or e.startswith("tests/test_torch_")
               for e in extra)
    assert resolve_paths([str(PORT)], no_siblings=True) == [PORT]
    project = Project.load(paths, exclude=("*/fixtures/*",))
    rels = [m.rel for m in project.modules]
    assert not any(r.startswith(("src/repro/", "benchmarks/")) for r in rels)
    assert {m.rel for m in project.by_role("bench")} == {"chip_smoke.py"}
    assert "tests/torch_mesh.py" in {m.rel for m in project.by_role("test")}


# ---------------------------------------------------------- suppression ---
def test_line_suppression_silences_one_finding(tmp_path, capsys):
    src = (FIXTURES / "bad_units.py").read_text().replace(
        "duration: float  #", "duration: float  # repro: ignore[units-s] —")
    code, out = lint(tmp_path, capsys, "sup.py", src)
    assert code == 1  # the unit-mixing finding survives
    assert "Window.duration" not in out and "budget_ms" in out


def test_file_suppression_silences_whole_module(tmp_path, capsys):
    src = "# repro: ignore-file[units-s]\n" + (FIXTURES / "bad_units.py").read_text()
    assert lint(tmp_path, capsys, "supfile.py", src)[0] == 0


def test_suppression_is_per_rule(tmp_path, capsys):
    """ignore[other-rule] does not waive a units finding."""
    src = (FIXTURES / "bad_units.py").read_text().replace(
        "duration: float  #", "duration: float  # repro: ignore[dtype-x64] —")
    code, out = lint(tmp_path, capsys, "wrong.py", src)
    assert code == 1 and "Window.duration" in out


def test_the_port_s_fold_suppression_is_needed(tmp_path, capsys):
    """The fold's float32 payload line carries ``# repro: ignore[dtype-x64]``
    (read by both linters); without it the port's rule flags the line."""
    src = (PORT / "scenarios" / "trajectory.py").read_text()
    line = next(x for x in src.splitlines() if "repro: ignore[dtype-x64]" in x)
    rel = "repro_torch/scenarios/trajectory.py"
    assert lint(tmp_path, capsys, rel, src, "--rules", "dtype-x64")[0] == 0
    code, out = lint(tmp_path, capsys, rel,
                     src.replace(line, line.split("  # repro:")[0]), "--rules", "dtype-x64")
    assert code == 1 and "[float32]" in out


# ------------------------------------------------------------- API layer ---
def test_run_analysis_returns_sorted_findings():
    project = Project.load([FIXTURES / "bad_units.py"], exclude=())
    findings = run_analysis(project)
    assert findings and all(isinstance(f, Finding) for f in findings)
    assert findings == sorted(findings, key=Finding.sort_key)
    assert [f.line for f in findings] == sorted(f.line for f in findings)


def test_syntax_error_files_are_skipped(tmp_path, capsys):
    (tmp_path / "broken.py").write_text("def oops(:\n")
    (tmp_path / "fine.py").write_text("x = 1\n")
    code, out = run_cli(capsys, str(tmp_path), "--no-siblings")
    assert code == 0 and "1 file(s)" in out


def test_the_linter_imports_nothing_of_the_reference():
    """Stdlib ``ast`` only: no module of the package imports jax, repro or
    the code it scans."""
    for path in sorted((PORT / "analysis").rglob("*.py")):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax", "import repro.", "from repro.",
                                     "import torch", "from torch")), (path, s)
            assert not s.startswith(("import repro_torch", "from repro_torch")) \
                or "repro_torch.analysis" in s, (path, s)


# ------------------------------------------ against the reference's linter ---
#: the framework-neutral fixtures of both corpora (parity, registries,
#: units, wall clock): the two linters must read them alike
NEUTRAL = [f"{corpus}/{name}" for corpus in ("analysis", "analysis_torch")
           for name in ("bad_parity_process.py", "bad_parity_trace.py", "bad_registry.py",
                        "bad_units.py", "bad_wallclock.py")]
UNITS = REPO / "tests" / "fixtures" / "analysis_torch" / "bad_units.py"
#: name -> (where, comment): a suppression comment on the units fixture's
#: ``duration`` line or at the head of the file
SUPPRESSIONS = {
    "line": ("line", "repro: ignore[units-s] —"),
    "line_two_rules": ("line", "repro: ignore[dtype-x64, units-s] —"),
    "line_other_rule": ("line", "repro: ignore[dtype-x64] —"),
    "line_every_rule": ("line", "repro: ignore —"),
    "file": ("file", "repro: ignore-file[units-s]"),
    "file_other_rule": ("file", "repro: ignore-file[dtype-x64]"),
    "file_every_rule": ("file", "repro: ignore-file"),
}


def both_linters(capsys, argv):
    """[(exit code, stdout)] of the reference's linter, then the port's, on
    ``argv``; a run that raises gives the exception's type for its code."""
    from repro.analysis.cli import main as reference_main

    out = []
    for run in (reference_main, main):
        try:
            code = run(list(argv))
        except (Exception, SystemExit) as e:
            code = type(e).__name__
        out.append((code, capsys.readouterr().out))
    return out


def assert_same_json(ref, port):
    """The same exit code and JSON document, messages aside: the keys, the
    schema version, the rules, the counts and each finding's rule, path,
    line, symbol and severity, in order."""
    assert ref[0] == port[0]
    doc_r, doc_p = json.loads(ref[1]), json.loads(port[1])
    assert set(doc_r) == set(doc_p)
    assert {k: v for k, v in doc_r.items() if k != "findings"} == \
        {k: v for k, v in doc_p.items() if k != "findings"}

    def key(f):
        return f["rule"], f["path"], f["line"], f["symbol"], f["severity"]

    assert [set(f) for f in doc_r["findings"]] == [set(f) for f in doc_p["findings"]]
    assert [key(f) for f in doc_r["findings"]] == [key(f) for f in doc_p["findings"]]


@pytest.mark.parametrize("fixture", NEUTRAL)
@pytest.mark.parametrize("rules", [(), ("--rules", "units-s,registry-completeness")])
def test_neutral_fixtures_read_as_the_reference_reads_them(capsys, fixture, rules):
    path = REPO / "tests" / "fixtures" / fixture
    ref, port = both_linters(capsys, [str(path), "--json", "--no-siblings", *NO_EXCLUDE, *rules])
    assert_same_json(ref, port)


@pytest.mark.parametrize("name", sorted(SUPPRESSIONS))
def test_suppressions_read_as_the_reference_reads_them(tmp_path, capsys, name):
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    where, comment = SUPPRESSIONS[name]
    src = UNITS.read_text()
    src = src.replace("duration: float  #", f"duration: float  # {comment}") if where == "line" \
        else f"# {comment}\n{src}"
    (tmp_path / "sup.py").write_text(src)
    ref, port = both_linters(capsys, [str(tmp_path / "sup.py"), "--json", "--no-siblings"])
    assert_same_json(ref, port)


@pytest.mark.parametrize("case", ["clean", "syntax_error", "missing", "fixtures_excluded",
                                  "bad_rule"])
def test_cli_exit_codes_as_the_reference_s(tmp_path, capsys, case):
    """The same exit code (and JSON where one is printed) on a clean tree, a
    tree with a file that does not parse, a missing path, the corpus under
    the default exclude; an unknown rule raises the same exception."""
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    (tmp_path / "fine.py").write_text("x = 1\n")
    if case == "syntax_error":
        (tmp_path / "broken.py").write_text("def oops(:\n")
    argv = {"missing": [str(tmp_path / "no_such_dir")],
            "fixtures_excluded": [str(FIXTURES), "--json"],
            "bad_rule": [str(tmp_path), "--rules", "no-such-rule"]}.get(
        case, [str(tmp_path), "--json"])
    runs = both_linters(capsys, [*argv, "--no-siblings"])
    if "--json" in argv:
        assert_same_json(*runs)
    else:
        assert runs[0][0] == runs[1][0] == {"missing": 2, "bad_rule": "KeyError"}[case]


def test_list_rules_as_the_reference_s(capsys):
    ref, port = both_linters(capsys, ["--list-rules"])
    assert ref[0] == port[0] == 0
    assert [line.split()[0] for line in ref[1].splitlines()] == \
        [line.split()[0] for line in port[1].splitlines()] == list(RULE_FAMILIES)


# -------------------------------------------------------------- meta ---
def test_port_is_clean_at_head(capsys):
    """THE invariant: the port's linter passes on the port itself (plus its
    tests and chip_smoke.py). ``chip_smoke.py`` runs exactly this first."""
    code, out = run_cli(capsys, str(PORT))
    assert code == 0, f"the port is not lint-clean:\n{out}"
    assert "clean: 0 findings" in out


def test_cli_module_runs_from_the_shell(tmp_path):
    """``python -m repro_torch.analysis`` from the repository's root, as
    ``chip_smoke.py`` runs it: exit 0, and 1 on a copy of a fixture."""
    import subprocess
    import sys

    env = {"PYTHONPATH": str(REPO / "src"), "PATH": ""}
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "src/repro_torch"],
                         cwd=REPO, capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    shutil.copy(FIXTURES / "bad_units.py", tmp_path / "bad.py")
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis", str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 1 and "units-s" in res.stdout
