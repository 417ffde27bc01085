"""Seeded input genomes, written as plain FASTA with .fai.

A configuration's `input.generator` names a file inputs/<generator>.py
whose `generate(d, seed, **args)` writes the files into d and returns
their names; `args` is the configuration's `input.args`. A new generator
is a new file there.

Run as a script in a child process of the harness, so that the
generators' arrays never count in the measured process's peak RSS:

    python3 h100bench/benchlib/inputs.py '<input spec json>' <seed> <dir>

prints one JSON object: {"files": [...], "lengths": {name: bp}}.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACGT = np.frombuffer(b"ACGT", np.uint8)


def write_fasta(path, seqs, width=60):
    """Plain FASTA, `width` bases a line, and its .fai (a frozen copy of
    scripts/torch_golden.py's `write_fasta`)."""
    fai = []
    with open(path, "wb") as fh:
        for name, seq in seqs.items():
            fh.write(b">" + name.encode() + b"\n")
            off = fh.tell()
            for i in range(0, len(seq), width):
                fh.write(seq[i:i + width] + b"\n")
            fai.append(f"{name}\t{len(seq)}\t{off}\t{width}\t{width + 1}\n")
    with open(str(path) + ".fai", "w") as fh:
        fh.write("".join(fai))


def generator_path(name: str) -> str:
    return os.path.join(HERE, "inputs", f"{name}.py")


def generator(name: str):
    """The module inputs/<name>.py."""
    spec = importlib.util.spec_from_file_location(
        f"h100bench_input_{name}", generator_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generate(spec: dict, seed: int, d: str) -> dict:
    """Write spec's inputs into d; the files and every sequence's length."""
    files = generator(spec["generator"]).generate(d, seed,
                                                  **spec.get("args", {}))
    lengths = {}
    for f in files:
        if f.endswith(".fai"):
            with open(os.path.join(d, f)) as fh:
                for line in fh:
                    name, n = line.split("\t")[:2]
                    lengths[name] = int(n)
    return {"files": files, "lengths": lengths}


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    print(json.dumps(generate(json.loads(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3])))
