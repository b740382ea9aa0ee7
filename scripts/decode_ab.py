"""Decode-step time of two checkouts of the port, timed alternately in one
process on one card, so that the host's drift falls on both alike.

    python3 scripts/decode_ab.py BASE NEW [--rounds 10] [--out FILE]

BASE and NEW are checkout roots, each holding ``src/repro_torch``; each
is imported as a package of its own (``ab_base``, ``ab_new``: the port's
modules import one another relatively) and builds its own kernels into
its ``src/repro_torch/_build/``.  For each served arch as ``chip_smoke.py``
serves it -- StarCoder2-3B at batch 4 x 2048-token prompts and
RecurrentGemma-9B at 2 x 4096, 32 greedy tokens, bf16 weights from seed 0
-- each checkout builds its model, runs one untimed ``generate``, and
then the two take turns, ``--rounds`` times, in the order A B, B A, A B,
...: one timed ``generate`` each (``launch/serve.py::generate``: ms a
decode step over its 31 serve steps, host clock), then the same 31 serve
steps after a prefill, timed by this thread's CPU clock up to the last
launch (the host's work a step, which a descheduled thread does not
add to; no step waits on the card).  Then, in turns too,
the host side of each checkout's K4 decode wrapper at that arch's decode
shape: 200 back-to-back calls not waited on (fewer launches than the
card's queue holds), ms a call; and ``torch.empty`` of the new decode
form's workspace, the part of its host time a kept workspace would save.
Prints each turn, then per arch the medians and ranges and the median of
the paired differences (NEW - BASE, turn by turn), and ends with them as
one JSON line.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

#: (arch, batch, prompt, decode shape of K4: q (B, 1, H, hd) over a cache
#: of (B, Sk, KV, hd) at length ``length``) as chip_smoke.py serves them
ARCHS = (("starcoder2-3b", 4, 2048, (4, 24, 2, 128, 2080, 2049)),
         ("recurrentgemma-9b", 2, 4096, (2, 16, 1, 256, 2048, 2048)))
NEW_TOKENS = 32
SEED = 0
CALLS = 200


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def load_tree(root: str, name: str):
    """``root``'s ``src/repro_torch`` imported as the package ``name``."""
    pkg = os.path.join(os.path.abspath(root), "src", "repro_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def host_ms(torch, fn) -> float:
    """Host ms a call of ``fn`` over ``CALLS`` calls not waited on, the
    card drained first."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    ms = (time.perf_counter() - t0) / CALLS * 1e3
    torch.cuda.synchronize()
    return ms


def host_step_ms(torch, tree, model, cfg, prompts) -> float:
    """The CPU ms of this thread a serve step, over ``NEW_TOKENS - 1``
    serve steps after a prefill (as ``generate`` runs them)."""
    serve = tree["launch.serve"]
    logits, cache = serve.prefill(model, cfg, {"tokens": prompts},
                                  prompts.shape[1] + NEW_TOKENS,
                                  serve.CACHE_DTYPE)
    tok = torch.argmax(logits[:, -1], dim=-1)
    step = tree["train"].make_serve_step(cfg)
    torch.cuda.synchronize()
    t0 = time.thread_time()
    for _ in range(NEW_TOKENS - 1):
        tok, cache = step(model, {"tokens": tok[:, None]}, cache)
    ms = (time.thread_time() - t0) / (NEW_TOKENS - 1) * 1e3
    torch.cuda.synchronize()
    return ms


def summary(values: dict, order: list) -> dict:
    """Medians and ranges of each side's values and of the paired
    differences NEW - BASE (one a turn)."""
    diffs = [n - b for b, n in zip(values["base"], values["new"])]
    out = {f"{side}_{k}": f(values[side]) for side in ("base", "new")
           for k, f in (("median", statistics.median), ("min", min),
                        ("max", max))}
    out.update(diff_median=statistics.median(diffs), diff_min=min(diffs),
               diff_max=max(diffs), n=len(diffs), order=order)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("base")
    ap.add_argument("new")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("decode_ab: no CUDA card", file=sys.stderr)
        return 2
    log = open(args.out, "w") if args.out else None

    def say(line: str) -> None:
        print(line, flush=True)
        if log:
            print(line, file=log, flush=True)

    say(f"card: {card_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    trees = {}
    for side, root in (("base", args.base), ("new", args.new)):
        name = f"ab_{side}"
        load_tree(root, name)
        mods = {m: importlib.import_module(f"{name}.{m}") for m in (
            "configs", "kernels.build", "kernels.attention.attention",
            "launch.serve", "models", "train")}
        t0 = time.perf_counter()
        mods["kernels.build"].compile_all()
        say(f"{side}: {mods['models'].__file__}, kernels built in "
            f"{time.perf_counter() - t0:.1f} s")
        trees[side] = mods
    order = [("base", "new") if i % 2 == 0 else ("new", "base")
             for i in range(args.rounds)]
    result = {}
    for arch, batch, prompt, shape in ARCHS:
        models = {}
        for side, mods in trees.items():
            cfg = mods["configs"].get_config(arch)
            models[side] = (cfg, mods["models"].init_params(
                cfg, SEED, torch.bfloat16, dev))
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                                generator=gen, device=dev)
        for side, (cfg, model) in models.items():  # warm-up
            trees[side]["launch.serve"].generate(model, cfg, prompts,
                                                 NEW_TOKENS)
        steps, cpu = {"base": [], "new": []}, {"base": [], "new": []}
        for turn in order:
            for side in turn:
                cfg, model = models[side]
                _, _, t_decode = trees[side]["launch.serve"].generate(
                    model, cfg, prompts, NEW_TOKENS)
                steps[side].append(t_decode / (NEW_TOKENS - 1) * 1e3)
                cpu[side].append(host_step_ms(torch, trees[side], model, cfg,
                                              prompts))
            say(f"{arch} step ms: base {steps['base'][-1]:.3f}, new "
                f"{steps['new'][-1]:.3f}; host CPU ms a step: base "
                f"{cpu['base'][-1]:.3f}, new {cpu['new'][-1]:.3f}")
        del models
        torch.cuda.empty_cache()

        bsz, h, kvh, hd, sk, length = shape
        g = torch.Generator(device=dev).manual_seed(SEED)
        q = torch.randn((bsz, 1, h, hd), generator=g, device=dev,
                        dtype=torch.bfloat16)
        k, v = (torch.randn((bsz, sk, kvh, hd), generator=g, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        wrap = {side: mods["kernels.attention.attention"].flash_attention
                for side, mods in trees.items()}
        attn = trees["new"]["kernels.attention.attention"]
        n_split, _ = attn.decode_splits(bsz, sk, kvh, 0,
                                        attn.sm_count(dev.index or 0))
        ws = bsz * kvh * n_split * (h // kvh) * (hd + 2)
        wrapper, empty = {"base": [], "new": []}, []
        for side in wrap:  # warm-up
            host_ms(torch, lambda: wrap[side](q, k, v, length - 1, length))
        for turn in order:
            for side in turn:
                wrapper[side].append(host_ms(torch, lambda: wrap[side](
                    q, k, v, length - 1, length)))
            empty.append(host_ms(torch, lambda: torch.empty(
                ws, dtype=torch.float32, device=dev)))
        result[arch] = {"step_ms": summary(steps, order),
                        "host_cpu_step_ms": summary(cpu, order),
                        "wrapper_host_ms": summary(wrapper, order),
                        "workspace_empty_host_ms": statistics.median(empty),
                        "n_split": n_split}
        for what in ("step_ms", "host_cpu_step_ms", "wrapper_host_ms"):
            s = result[arch][what]
            say(f"{arch} {what}: base median {s['base_median']:.5f} (range "
                f"{s['base_min']:.5f} .. {s['base_max']:.5f}), new median "
                f"{s['new_median']:.5f} (range {s['new_min']:.5f} .. "
                f"{s['new_max']:.5f}); new - base, paired over {s['n']} "
                f"turns: median {s['diff_median']:+.5f} (range "
                f"{s['diff_min']:+.5f} .. {s['diff_max']:+.5f})")
        say(f"{arch}: torch.empty of the workspace ({ws} floats, "
            f"{n_split} splits) {result[arch]['workspace_empty_host_ms']:.5f}"
            f" ms a call on the host")
    say(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
