"""``python -m repro_torch.launch.serve`` on the CPU (plain versions) keeps
the reference launcher's ``--json`` status line and exit contract."""
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import ops
from repro_torch.launch import serve

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
    assert ops.launch_counts() == {"rmsnorm": 0, "flash_attention": 0, "flash_decode": 0}


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
