"""Serving example on the PyTorch port: batched prefill + autoregressive
decode with the KV cache / recurrent-state machinery, on a reduced config
of any assigned architecture (including the attention-free and hybrid
ones).

    PYTHONPATH=src python examples/serve_decode_torch.py --arch rwkv6-1.6b --new-tokens 16 \
        [--device cuda]

The port of ``examples/serve_decode.py`` over ``repro_torch``: the same
arguments and check (generated ids of shape (B, N)). Weights and the
prompt come from a ``torch.Generator`` seeded 0 (``launch.serve.setup``),
an encoder-decoder's frames from ``serve.make_frames`` and a vision
config's image embeddings from ``serve.make_image_embeds``. The prefill
lays down P = S + num_img_tokens positions and the decode steps run at
P, P + 1, ... (``serve.generate``; the reference example decodes at
S + i, over the prompt when there are image tokens). ``--device`` is
``cuda`` unless ``--device cpu`` is given (without a card it raises); on
the card prefill and decode run the hand-written kernels (rmsnorm,
flash_attention, flash_decode, wkv6, rglru, as the arch has them).
"""
import argparse

from repro_torch.configs import all_archs
from repro_torch.launch import serve


def main(argv=None):
    """Runs the example; returns the ``serve.Generation``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=sorted(all_archs()))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    B, S, N = args.batch, args.prompt_len, args.new_tokens
    model, params, prompt = serve.setup(args.arch, batch=B, prompt_len=S, device=args.device)
    frames = serve.make_frames(model, B, prompt.device)
    image_embeds = serve.make_image_embeds(model, B, prompt.device)
    gen = serve.generate(model, params, prompt, N, frames, image_embeds)

    t_dec = sum(gen.decode_s)
    print(f"{args.arch} (reduced): prefill {B}x{S} in {gen.prefill_s*1e3:.1f} ms; "
          f"{N-1} decode steps in {t_dec*1e3:.1f} ms "
          f"({(N-1)*B/max(t_dec,1e-9):.0f} tok/s on {prompt.device})")
    print("generated token ids (row 0):", gen.tokens[0].tolist())
    assert gen.tokens.shape == (B, N)
    print("OK")
    return gen


if __name__ == "__main__":
    main()
