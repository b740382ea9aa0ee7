"""Serving launcher of the port: ``python -m repro_torch.launch.serve
--arch <id>``, the twin of ``src/repro/launch/serve.py``.

Batched greedy decoding: one prefill over random prompts into a cache of
``prompt_len + new_tokens`` positions, then ``new_tokens - 1`` serve
steps, each a ``decode_step`` from the cache (recurrent states or KV) and
an argmax.  Prints the prefill time and the decode rate, as the reference
does.  Runs on the card unless ``--device cpu``; serves the ssm family
(Falcon-Mamba), the dense family (StarCoder2, SmolLM, Qwen1.5) and the
hybrid family (RecurrentGemma) and exits with a message for any other
arch: first, as the reference does, for an encoder-only arch (HuBERT:
"<arch> is encoder-only: no decode step"), whose forward the port runs
but which has nothing to serve.  The KV cache (the hybrid's ring
buffers) takes the weights' dtype (``--dtype``).  ``--reduced`` (the
default) keeps head_dim 64, a head dim K4 is built for, so a reduced
dense or hybrid model runs on the card too.

    python -m repro_torch.launch.serve --arch starcoder2-3b --full \\
        --dtype bfloat16 --batch 4 --prompt-len 2048 --new-tokens 32
    python -m repro_torch.launch.serve --arch recurrentgemma-9b --full \\
        --dtype bfloat16 --batch 2 --prompt-len 4096 --new-tokens 32
    python -m repro_torch.launch.serve --arch recurrentgemma-9b \\
        --device cpu --reduced
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..device import resolve_device
from ..models import init_params, prefill
from ..models.transformer import require_served
from ..train import make_serve_step

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, cfg, prompts: torch.Tensor, new_tokens: int):
    """Greedy decoding of ``new_tokens`` tokens per prompt row: the first
    from the prefill's last logits, the rest from ``new_tokens - 1`` serve
    steps, over a cache of ``prompt_len + new_tokens`` positions in the
    model's dtype.  Returns (tokens (B, new_tokens), prefill seconds,
    decode seconds), timed on the host clock around work that ends in a
    device synchronise."""
    dev = prompts.device
    max_len = prompts.shape[1] + new_tokens
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(model, cfg, {"tokens": prompts}, max_len)
    tok = torch.argmax(logits[:, -1], dim=-1)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    serve_step = make_serve_step(cfg)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(new_tokens - 1):
        tok, cache = serve_step(model, {"tokens": tok[:, None]}, cache)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return torch.stack(out, dim=1), t_prefill, t_decode


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="falcon-mamba-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not cfg.supports_decode:
        raise SystemExit(f"{args.arch} is encoder-only: no decode step")
    try:
        require_served(cfg)
    except NotImplementedError as e:
        raise SystemExit(f"{args.arch}: not served by the port yet: {e}")
    if args.reduced:
        cfg = cfg.reduced(n_layers=4, d_model=256, n_heads=4, d_ff=512,
                          vocab=1024)
    dev = resolve_device(args.device)
    model = init_params(cfg, 0, DTYPES[args.dtype], dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    toks, t_prefill, t_decode = generate(model, cfg, prompts,
                                         args.new_tokens)
    tps = args.batch * (args.new_tokens - 1) / t_decode
    print(f"{cfg.name}: prefill {args.batch}x{args.prompt_len} in "
          f"{t_prefill * 1e3:.0f}ms; decoded {args.new_tokens} tokens/seq "
          f"at {tps:.0f} tok/s ({dev}, {args.dtype})")
    print("sample:", toks[0, :16].tolist())
    return toks


if __name__ == "__main__":
    main()
