"""What the kernel-variant scripts (``prefill_variants.py``,
``scan_variants.py``, ``encode_variants.py``) share: variants of a CUDA
source made by text replacement, built together with the port's own
``nvcc`` flags, bound in turn into the port's wrapper in place of its
loaded C entry, measured in turns on one card, and their SASS opcode mix.
Imported by those scripts, not run.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)


def variant_source(src: str, edits) -> str:
    """``src`` with each ``(old, new)`` of ``edits`` replaced.  Each ``old``
    must occur exactly once, so an edited source fails here rather than
    measuring something else."""
    for old, new in edits:
        n = src.count(old)
        if n != 1:
            raise SystemExit(f"variant text found {n} times (1 expected): "
                             f"{old!r}")
        src = src.replace(old, new)
    return src


def logger(path: str | None):
    """A function that prints a line and, with ``path``, writes it there
    too."""
    log_f = open(path, "w") if path else None

    def say(line: str) -> None:
        print(line, flush=True)
        if log_f:
            print(line, file=log_f, flush=True)

    return say


def build_all(sources: dict, out_dir: str, stem: str) -> dict:
    """Compiles each ``{name: CUDA source text}`` into
    ``out_dir/lib<stem><i>.so`` with the port's ``nvcc`` flags, one
    ``nvcc`` a source, all started together.  Returns ``{name: (library
    path, or None where nvcc failed; nvcc's output)}``; the output holds
    the ptxas report (``-Xptxas -v`` is among the flags)."""
    from repro_torch.kernels import build

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        path = os.path.join(out_dir, f"{stem}{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{stem}{i}.so")
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        built[name] = (None if proc.returncode else lib, log)
    return built


def c_entry(lib: str, symbol: str, argtypes):
    """The C function ``symbol`` of the library ``lib``, returning int."""
    fn = getattr(ctypes.CDLL(lib), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def bind(module, fn, attr: str = "_kernel") -> None:
    """Makes the wrapper ``module`` call ``fn`` where it calls its cached
    ``attr()`` (the C entry it loaded)."""
    setattr(module, attr, lambda: fn)


def in_turns(names: list, rounds: int, measure) -> dict:
    """``measure(name)`` for every name in turns (A B C, C B A, ...) for
    ``rounds`` rounds: ``{name: [its result in each round]}``."""
    out = {name: [] for name in names}
    for rnd in range(rounds):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            out[name].append(measure(name))
    return out


def sass_mix(tool: str, lib: str, entry: str) -> dict:
    """Opcodes (without modifiers) of kernel ``entry`` in the SASS of the
    library ``lib`` by ``tool`` (``cuobjdump -sass``), counted as compiled:
    the static mix, the unrolled chunk's steps included once each."""
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True).stdout
    counts: dict[str, int] = {}
    inside = False
    for line in out.splitlines():
        if "Function :" in line:
            inside = entry in line
        elif inside:
            m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                          line)
            if m:
                counts[m[1]] = counts.get(m[1], 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))
