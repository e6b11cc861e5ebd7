"""The four examples of the port (``examples/*_torch.py``) on the CPU, at a
small size, each through its ``main(argv)``: every check of its own passes
and it prints ``OK`` last. Where an example's output depends only on
numpy-seeded data, it is held against the reference's, computed here: the
genome job's hit table, the planted truth, and the failure schedule of
``train_ft``. The token batches come from ``data.synthetic`` on both
sides, but the reference draws them with jax's threefry, which no numpy
generator reproduces: the port's are held to the reference's shape, dtype
and range and to replaying from any step. The examples import neither jax
nor ``repro``, and with ``--device cuda`` on a host without a card they
raise, never taking the CPU on their own."""
import ast
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "train_ft", "genome_search", "serve_decode")
#: the serve_decode arches: one of each family the examples' kernels serve
SERVE_ARCHS = ("gemma-2b", "rwkv6-1.6b", "recurrentgemma-9b", "whisper-tiny",
               "phi-3-vision-4.2b")


def load(name: str):
    """``examples/<name>_torch.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"{name}_torch_example",
                                                  REPO / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(capsys, name: str, *argv):
    """``main(argv + ["--device", "cpu"])``: (its result, its stdout)."""
    res = load(name).main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.rstrip().splitlines()[-1] == "OK", out
    return res, out


def test_quickstart_is_lossless(capsys):
    res, out = run(capsys, "quickstart", "--steps", "8")
    h0, h1 = res["hashes"]
    assert h0 == h1 and "final state identical to failure-free run: True" in out
    ft = res["ft"]
    assert ft.migrations >= 1 and ft.restores >= 1 and ft.steps_run >= 8


def test_train_ft_one_state_across_policies_and_the_reference_s_failures(capsys):
    from repro.core.failure import FailureModel as RFailureModel

    ex = load("train_ft")
    res, out = run(capsys, "train_ft", "--steps", "6")
    assert list(res) == [name for name, _ in ex.POLICIES]
    assert len({h for _, _, h in res.values()}) == 1
    assert "all policies bit-identical final state: True" in out
    for steps in (6, 60, 300):
        want = RFailureModel(kind="random", n_nodes=4, horizon_s=steps,
                             period_s=max(steps / 2, 1), per_window=1, seed=4).events()
        got = ex.failures(steps)
        assert [(e.t, e.node, e.predictable) for e in got] \
            == [(e.t, e.node, e.predictable) for e in want]


def test_train_ft_configs_are_the_reference_s():
    """--full is the reference's ~100 M configuration (8 layers, d 768, head
    dim 64, float32, 8 x 256, 300 steps); the default its ~10 M one."""
    ex = load("train_ft")
    full, steps, batch, seq = ex.config(True)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.head_dim,
            full.d_ff, full.vocab, full.dtype) == (8, 768, 12, 4, 64, 2048, 32000, "float32")
    assert (steps, batch, seq) == (300, 8, 256)
    small, steps, batch, seq = ex.config(False)
    assert (small.n_layers, small.d_model, small.head_dim, small.vocab) == (4, 256, 32, 8192)
    assert (steps, batch, seq) == (60, 4, 128)


def test_token_batches_replay_and_match_the_reference_s_form():
    from repro.data.synthetic import token_batches as r_token_batches

    from repro_torch.data.synthetic import token_batches

    make = token_batches(seed=0, batch=4, seq=64, vocab=512)
    ref = r_token_batches(seed=0, batch=4, seq=64, vocab=512)(3)["tokens"]
    for step in (0, 3, 7):
        a, b = make(step)["tokens"], make(step)["tokens"]
        assert np.array_equal(a, b)  # a step replays
        assert a.shape == ref.shape and a.dtype == ref.dtype == np.int32
        assert 0 <= a.min() and a.max() < 512
    assert not np.array_equal(make(0)["tokens"], make(1)["tokens"])


def test_genome_search_hits_equal_the_reference_s(capsys):
    from repro.data import genome as R

    res, out = run(capsys, "genome_search")
    genome, patterns, truth = R.make_genome(int(0.25 * 1e6), n_patterns=24, seed=7)
    job = R.GenomeSearchJob(genome, patterns, n_search=3)
    states = job.sub_job_states()
    for st in states:
        while job.run_sub_job_step(st):
            pass
    want = job.combine(states)
    assert set(res["hits"]) == set(want) and set(res["reference_hits"]) == set(want)
    assert res["truth"] == truth
    ovh = res["overheads"]
    assert ovh["central_single"] > max(v for k, v in ovh.items() if k != "central_single")
    assert "paper ordering holds" in out


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_decode(capsys, arch):
    gen, out = run(capsys, "serve_decode", "--arch", arch, "--new-tokens", "4")
    assert tuple(gen.tokens.shape) == (4, 4)
    assert all(torch.isfinite(x).all() for x in gen.logits)
    assert f"{arch} (reduced): prefill 4x32" in out and "tok/s on cpu" in out


def test_serve_decode_positions_follow_the_prefill():
    """With image tokens the decode steps continue after the P = S +
    num_img_tokens prefilled positions (``serve.generate``), not at S + i."""
    from repro_torch.launch import serve

    model, params, prompt = serve.setup("phi-3-vision-4.2b", batch=2, prompt_len=8,
                                        device="cpu")
    img = serve.make_image_embeds(model, 2, prompt.device)
    seen = []
    decode = model.decode
    model.decode = lambda p, tok, pos, caches: (seen.append(pos), decode(p, tok, pos, caches))[1]
    serve.generate(model, params, prompt, 4, None, img)
    P = 8 + model.cfg.num_img_tokens
    assert seen == [P, P + 1, P + 2]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_refuses_cuda_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(name).main(["--device", "cuda"])


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_only_the_port(name):
    tree = ast.parse((REPO / "examples" / f"{name}_torch.py").read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    tops = {m.split(".")[0] for m in mods}
    assert "jax" not in tops and "repro" not in tops
    assert any(m.startswith("repro_torch") for m in mods)


def test_examples_run_where_jax_cannot_be_imported():
    """One interpreter in which ``import jax`` and ``import repro`` fail runs
    two examples from the shell's entry point."""
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "for argv in ([r'examples/serve_decode_torch.py', '--new-tokens', '3'],\n"
        "             [r'examples/quickstart_torch.py', '--steps', '2']):\n"
        "    sys.argv = argv + ['--device', 'cpu']\n"
        "    runpy.run_path(argv[0], run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env={"PYTHONPATH": str(REPO / "src"), "PATH": "",
                              "OMP_NUM_THREADS": "2"}, timeout=120)
    assert res.returncode == 0, res.stderr
    assert [line for line in res.stdout.splitlines() if line == "OK"] == ["OK", "OK"], res.stdout
