"""Serving launcher: batched prefill + greedy decode with per-step latency.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --full \
      --batch 4 --prompt-len 512 --new-tokens 32 [--json] [--device cuda]

The port of ``repro/launch/serve.py``: the same flags and the same exit
contract (``repro_torch.orchestrator.contract``); ``--json`` makes the final
line one JSON status object. Weights and the prompt are random, from a
seeded ``torch.Generator``, and so are an encoder-decoder's frames (B,
encoder_seq, d; ``make_frames``), the stub of precomputed frame embeddings
the reference draws too, and a vision config's image embeddings (B,
num_img_tokens, d; ``make_image_embeds``), its stub of precomputed patch
embeddings. With image tokens the prefill lays down P = S + num_img_tokens
positions, and ``generate`` sizes the cache P + new_tokens and decodes at
positions P, P + 1, ...: they continue after the last prefilled one. The
reference's launcher sizes its cache S + new_tokens and decodes at S + i,
so with image tokens its steps overwrite prompt positions (ROADMAP Queue 3,
item 15); that is a fault of its launcher, not of its model, which the port
follows. The int8 KV cache is a config field (``kv_cache_dtype``), as in
the reference, which has no flag for it: ``setup(..., changes={
"kv_cache_dtype": "int8"})``. It runs on ``cuda`` (the hand-written kernels)
unless ``--device cpu`` is given (the plain torch versions); without a CUDA
device and without that flag it raises. A model whose weights exceed the
device's memory (``--full`` of kimi-k2-1t-a32b: 1 T parameters) exits 1
with a message before anything is allocated; ``setup(..., full=True,
changes={"n_layers": 1})`` serves its full width at one layer.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import all_archs, get_arch
from repro_torch.models import build_model
from repro_torch.orchestrator.contract import EXIT_OK
from repro_torch.utils.device import check_fits, resolve_device
from repro_torch.utils.tree import tree_bytes, tree_count


def setup(arch: str = "gemma-2b", *, full: bool = False, batch: int = 4, prompt_len: int = 64,
          device: str = "cuda", seed: int = 0, changes: Optional[dict] = None):
    """Build the model (its config with ``changes`` applied), its random
    weights and a random prompt (B, S). A model whose weights alone exceed
    the device's memory (the full-size kimi-k2: 2 TB in bfloat16) raises
    MemoryError before anything is allocated."""
    cfg = get_arch(arch)
    if not full:
        cfg = cfg.reduced()
    if changes:
        cfg = dataclasses.replace(cfg, **changes)
    dev = resolve_device(device)
    model = build_model(cfg)
    weights = model.init(None, "meta")
    check_fits(f"serving {cfg.name} ({tree_count(weights) / 1e9:.2f} B parameters)",
               tree_bytes(weights), dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen, dev)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen, device=dev,
                           dtype=torch.int64)
    return model, params, prompt


def make_frames(model, batch: int, device, seed: int = 0) -> Optional[torch.Tensor]:
    """An encoder-decoder's random frames (B, encoder_seq, d), float32 from a
    generator of their own seeded ``seed``, as the reference draws them
    from a key of their own; None for a decoder-only model."""
    cfg = model.cfg
    if not cfg.encoder_layers:
        return None
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randn((batch, cfg.encoder_seq, cfg.d_model), generator=gen, device=dev,
                       dtype=torch.float32)


def make_image_embeds(model, batch: int, device, seed: int = 0) -> Optional[torch.Tensor]:
    """A vision config's random image embeddings (B, num_img_tokens, d),
    float32 from a generator of their own seeded ``seed``, as the reference
    draws them from a key of their own; None for a config without image
    tokens."""
    cfg = model.cfg
    if not cfg.num_img_tokens:
        return None
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randn((batch, cfg.num_img_tokens, cfg.d_model), generator=gen, device=dev,
                       dtype=torch.float32)


def ring_warning(model, prompt_len: int) -> Optional[str]:
    """The warning for a prompt the windowed cache does not wrap exactly.
    An ``attn_local`` layer keeps the reference's ring of min(S, window)
    slots, and decode overwrites a position still inside the window unless
    S is a multiple of the window (ROADMAP Queue 3, item 6). The port
    matches the reference there, so it warns and does not refuse."""
    window = model.cfg.window
    if "attn_local" not in model.kinds or prompt_len % window == 0:
        return None
    return (f"warning: prompt length {prompt_len} is not a multiple of the window {window}: "
            f"decode overwrites cached positions still inside the window, as the reference "
            f"does (ROADMAP Queue 3, item 6); pass --prompt-len {window} for an exact ring")


@dataclass
class Generation:
    tokens: torch.Tensor  # (B, new_tokens): greedy token of the prefill, then of each step
    logits: List[torch.Tensor]  # (B, vocab) per step, the prefill's first
    prefill_s: float
    decode_s: List[float]  # one per decode step


def generate(model, params, prompt: torch.Tensor, new_tokens: int,
             frames: Optional[torch.Tensor] = None,
             image_embeds: Optional[torch.Tensor] = None) -> Generation:
    """Prefill (of ``prompt`` and, for an encoder-decoder, ``frames``, for
    a vision config ``image_embeds``) of P = S (+ num_img_tokens) positions
    with ``cache_len = P + new_tokens``, then ``new_tokens - 1`` greedy
    decode steps at positions P, P + 1, ...; each phase is timed to the
    device's completion."""
    B, S = prompt.shape
    P = S + model.image_tokens(image_embeds)
    on_card = prompt.device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(prompt.device)

    with torch.inference_mode():
        sync()
        t0_s = time.perf_counter()
        logits, caches = model.prefill(params, prompt, cache_len=P + new_tokens, frames=frames,
                                       image_embeds=image_embeds)
        sync()
        prefill_s = time.perf_counter() - t0_s
        tok = torch.argmax(logits, dim=-1)[:, None]
        all_logits, toks, decode_s = [logits], [tok], []
        for i in range(new_tokens - 1):
            t0_s = time.perf_counter()
            logits, caches = model.decode(params, tok, P + i, caches)
            tok = torch.argmax(logits, dim=-1)[:, None]
            sync()
            decode_s.append(time.perf_counter() - t0_s)
            all_logits.append(logits)
            toks.append(tok)
    return Generation(torch.cat(toks, dim=1), all_logits, prefill_s, decode_s)


def summary(arch: str, gen: Generation) -> dict:
    """The ``--json`` status object; the first decode step is left out of the
    latency statistics as a warm-up, as the reference drops its compile step."""
    lat_s = np.array(gen.decode_s[1:])
    B = gen.tokens.shape[0]
    return {
        "status": "ok",
        "exit_code": EXIT_OK,
        "arch": arch,
        "prefill_s": round(float(gen.prefill_s), 6),
        "decode_p50_s": round(float(np.percentile(lat_s, 50)), 6),
        "decode_p99_s": round(float(np.percentile(lat_s, 99)), 6),
        "tokens_per_s": round(float(B / np.mean(lat_s)), 2),
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=sorted(all_archs()))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="final line is one machine-readable JSON status object")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.new_tokens < 3:
        ap.error("--new-tokens must be at least 3 (the first decode step is a warm-up)")

    try:
        model, params, prompt = setup(args.arch, full=args.full, batch=args.batch,
                                      prompt_len=args.prompt_len, device=args.device)
    except MemoryError as e:  # a config no device holds: said before any allocation
        print(f"serve: {e}", file=sys.stderr)
        return 1
    frames = make_frames(model, args.batch, prompt.device)
    image_embeds = make_image_embeds(model, args.batch, prompt.device)
    warning = ring_warning(model, args.prompt_len)
    if warning:
        print(warning, file=sys.stderr)
    gen = generate(model, params, prompt, args.new_tokens, frames, image_embeds)
    res = summary(args.arch, gen)
    if args.as_json:
        print(json.dumps(res))
    else:
        B, S = prompt.shape
        print(f"{args.arch} on {prompt.device}: prefill {B}x{S}: {res['prefill_s'] * 1e3:.1f} ms"
              f" | decode p50 {res['decode_p50_s'] * 1e3:.2f} ms p99 "
              f"{res['decode_p99_s'] * 1e3:.2f} ms | {res['tokens_per_s']:.0f} tok/s")
    return EXIT_OK


if __name__ == "__main__":
    raise SystemExit(main())
