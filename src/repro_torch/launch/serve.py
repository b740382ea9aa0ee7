"""Serving launcher of the port: ``python -m repro_torch.launch.serve
--arch <id>``, the twin of ``src/repro/launch/serve.py``.

Batched greedy decoding: one prefill over random prompts into a cache of
``prompt_len + new_tokens`` positions, then ``new_tokens - 1`` serve
steps, each a ``decode_step`` from the cache (recurrent states or KV) and
an argmax.  Prints the prefill time and the decode rate, as the reference
does.  Runs on the card unless ``--device cpu``; serves the ssm family
(Falcon-Mamba), the dense family (StarCoder2, SmolLM, Qwen1.5, Gemma2)
and the hybrid family (RecurrentGemma) and exits with a message for any
other arch: first, as the reference does, for an encoder-only arch
(HuBERT: "<arch> is encoder-only: no decode step"), whose forward the
port runs but which has nothing to serve.  As in the reference, the
default arch is ``smollm-135m``, ``--reduced`` (the default) takes the
reference launcher's reduction (4 layers, d_model 128, 4 heads, d_ff 512,
vocab 1024: head_dim 32, a head dim K4 is built for, so a reduced model
runs on the card too) and the KV cache (the hybrid's ring buffers) is
bfloat16 whatever the weights' dtype (``--dtype``, float32 by default).

    python -m repro_torch.launch.serve --arch starcoder2-3b --full \\
        --dtype bfloat16 --batch 4 --prompt-len 2048 --new-tokens 32
    python -m repro_torch.launch.serve --arch gemma2-2b --full \\
        --dtype bfloat16 --batch 2 --prompt-len 8160 --new-tokens 32
    python -m repro_torch.launch.serve --arch gemma2-2b --device cpu
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
#: the KV cache's dtype: the reference's ``prefill`` default, which its
#: launcher serves
CACHE_DTYPE = torch.bfloat16


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, cfg, prompts: torch.Tensor, new_tokens: int):
    """Greedy decoding of ``new_tokens`` tokens per prompt row: the first
    from the prefill's last logits, the rest from ``new_tokens - 1`` serve
    steps, over a cache of ``prompt_len + new_tokens`` positions in
    ``CACHE_DTYPE``.  Returns (tokens (B, new_tokens), prefill seconds,
    decode seconds), timed on the host clock around work that ends in a
    device synchronise."""
    dev = prompts.device
    max_len = prompts.shape[1] + new_tokens
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(model, cfg, {"tokens": prompts}, max_len,
                            CACHE_DTYPE)
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


def config_for(arch: str, reduced: bool):
    """The config ``main`` serves: ``arch``'s, reduced as the reference's
    launcher reduces it when ``reduced``.  Exits with the reference's
    message for an encoder-only arch, and with the slice that brings it
    for an arch the port does not serve yet."""
    cfg = get_config(arch)
    if not cfg.supports_decode:
        raise SystemExit(f"{arch} is encoder-only: no decode step")
    try:
        require_served(cfg)
    except NotImplementedError as e:
        raise SystemExit(f"{arch}: not served by the port yet: {e}")
    if reduced:
        cfg = cfg.reduced(n_layers=4, d_model=128, n_heads=4, d_ff=512,
                          vocab=1024)
    return cfg


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    cfg = config_for(args.arch, args.reduced)
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
