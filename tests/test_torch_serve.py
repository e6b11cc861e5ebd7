"""``python -m repro_torch.launch.serve`` on the CPU (plain versions) keeps
the reference launcher's ``--json`` status line and exit contract."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.launch import serve

# Two intra-op threads: these tests share the host with the other pytest-xdist
# workers, among them the reference's wall-clock orchestrator tests.
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
KEYS = {"status", "exit_code", "arch", "prefill_s", "decode_p50_s", "decode_p99_s",
        "tokens_per_s"}


def test_serve_json_on_cpu(capsys):
    ops.reset_launch_counts()
    rc = serve.main(["--device", "cpu", "--json", "--batch", "2", "--prompt-len", "12",
                     "--new-tokens", "5"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert set(last) == KEYS
    assert last["status"] == "ok" and last["exit_code"] == 0 and last["arch"] == "gemma-2b"
    assert last["prefill_s"] > 0 and last["tokens_per_s"] > 0
    assert ops.launch_counts() == {"rmsnorm": 0, "flash_attention": 0, "flash_decode": 0,
                                   "wkv6": 0, "rglru": 0, "rmsnorm_bwd": 0,
                                   "flash_attention_bwd": 0, "wkv6_bwd": 0,
                                   "rglru_bwd": 0}


@pytest.mark.parametrize("arch,prompt_len", [("rwkv6-1.6b", 12), ("recurrentgemma-9b", 32)])
def test_serve_json_on_cpu_recurrent_archs(arch, prompt_len, capsys):
    """The reduced rwkv6 and recurrentgemma through the same entry point;
    recurrentgemma's prompt of 32 is twice its reduced window of 16."""
    rc = serve.main(["--arch", arch, "--device", "cpu", "--json", "--batch", "2",
                     "--prompt-len", str(prompt_len), "--new-tokens", "5"])
    out = capsys.readouterr()
    last = json.loads(out.out.strip().splitlines()[-1])
    assert rc == 0 and set(last) == KEYS
    assert last["status"] == "ok" and last["arch"] == arch and last["tokens_per_s"] > 0
    assert "warning" not in out.err


@pytest.mark.parametrize("prompt_len", [12, 20])
def test_serve_warns_when_the_window_ring_does_not_wrap_exactly(prompt_len, capsys):
    """Reduced recurrentgemma (window 16): a prompt shorter than the window
    or not a multiple of it runs, as in the reference, with a warning that
    names the ROADMAP item."""
    rc = serve.main(["--arch", "recurrentgemma-9b", "--device", "cpu", "--json", "--batch", "1",
                     "--prompt-len", str(prompt_len), "--new-tokens", "3"])
    out = capsys.readouterr()
    assert rc == 0 and json.loads(out.out.strip().splitlines()[-1])["status"] == "ok"
    assert f"prompt length {prompt_len} is not a multiple of the window 16" in out.err
    assert "ROADMAP Queue 3, item 6" in out.err


def test_generate_shapes_and_greedy_tokens():
    model, params, prompt = serve.setup(device="cpu", batch=3, prompt_len=10, seed=1)
    gen = serve.generate(model, params, prompt, 4)
    assert gen.tokens.shape == (3, 4) and len(gen.logits) == 4 and len(gen.decode_s) == 3
    for i, logits in enumerate(gen.logits):
        assert logits.shape == (3, model.cfg.vocab) and torch.isfinite(logits).all()
        assert torch.equal(gen.tokens[:, i], logits.argmax(-1))


def test_serve_module_entry_exit_code():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--json",
         "--new-tokens", "3", "--prompt-len", "8"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": ""},
    )
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1])["status"] == "ok"
