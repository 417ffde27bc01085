"""Upstream's cluster alignment workflow: map once with -m, split the
records into weight-balanced chunks, align each chunk in a job of its
own with -i.

Traffic keys: "chunk_mbp" (query span a chunk carries), "query_prefixes"
(null: map every query sequence; else a list of -Q lists, one drawn from
the seed), "drop_flags" (deployment flags the set-up's mapping leaves
out), "warm_records" (records in the set-up's last, short job),
"warm_kernels" (the port's CUDA libraries the set-up builds and loads:
those the window's jobs launch),
"sample" (records the reference aligns), "limits".
"""

from __future__ import annotations

import random
import re

from benchlib.chunking import query_span, split_chunks
from benchlib.window import p95
from reference.align_check import judge

_IDENTITY = re.compile(r"adjusted to ([0-9.]+)%")


def SPANS():
    from wfmash_tpu_torch.align import biwfa, segmented

    return [(segmented.SegmentedEngine, "align_batch", "align.engine_batch"),
            (biwfa, "finish_records_batched", "align.patch_and_swizzle")]


def _fasta(ctx):
    return [ctx.path(f) for f in ctx.config["fasta"]]


def setup(ctx):
    cfg, tr = ctx.config, ctx.traffic
    rng = random.Random(ctx.seed)
    flags = [f for f in cfg["flags"] if f not in tr["drop_flags"]]
    argv = _fasta(ctx) + flags + ["-m"]
    if tr["query_prefixes"]:
        argv += ["-Q", ",".join(rng.choice(tr["query_prefixes"]))]
    mapping = ctx.path("mapping.paf")
    rc, _, _ = ctx.run_cli(argv, mapping, "setup_mapping")
    if rc != 0:
        raise RuntimeError(f"set-up mapping failed (rc {rc})")
    # a cluster run passes its mapping's identity on to every -i job, so
    # that no job estimates it again
    ident = [] if "-p" in cfg["flags"] else ["-p", _identity(ctx)]
    with open(mapping) as fh:
        lines = [l for l in fh if l.strip()]
    if not lines:
        raise RuntimeError("the set-up mapping wrote no record")
    chunks = split_chunks(lines, tr["chunk_mbp"] * 1e6)
    rng.shuffle(chunks)
    base = _fasta(ctx) + cfg["flags"] + ident
    jobs = []
    for k, chunk in enumerate(chunks):
        path = ctx.path(f"chunk_{k}.paf")
        with open(path, "w") as fh:
            fh.writelines(chunk)
        jobs.append({"argv": base + ["-i", path], "chunk": chunk,
                     "bp": sum(query_span(l) for l in chunk)})
    _warm(ctx, base, lines[:tr["warm_records"]])
    return jobs


def _identity(ctx) -> str:
    with open(ctx.path("setup_mapping.log")) as fh:
        found = _IDENTITY.findall(fh.read())
    if not found:
        raise RuntimeError("the set-up mapping logged no identity estimate")
    return found[-1]


def _warm(ctx, base, lines):
    """The traffic's kernel libraries built and loaded, then one short
    job of the window's kind: the CUDA context, the native libraries and
    the tier solver's buffers are ready before the window opens."""
    if ctx.device.type == "cuda":
        from wfmash_tpu_torch import _build

        for name in ctx.traffic["warm_kernels"]:
            _build.load(name)
    path = ctx.path("warm.paf")
    with open(path, "w") as fh:
        fh.writelines(lines)
    rc, _, _ = ctx.run_cli(base + ["-i", path], ctx.path("warm.out.paf"),
                           "warm")
    if rc != 0:
        raise RuntimeError(f"warm-up job failed (rc {rc})")


def run(ctx, job, k):
    out = ctx.path(f"out_{k}.paf")
    rc, wall, perf = ctx.run_cli(job["argv"], out, "job")
    return {"ok": rc == 0, "wall": wall, "bp": job["bp"], "perf": perf,
            "chunk": job["chunk"], "out": out}


def end_to_end(ctx):
    done = ctx.jobs_done
    return {"aligned_mbps": sum(j["bp"] for j in done) / 1e6 / ctx.window_s,
            "align_chunk_p95_s": p95([j["wall"] for j in done])}


def check(ctx):
    tr = ctx.traffic
    verdict = judge([j for j in ctx.jobs_done if j["ok"]], _fasta(ctx),
                    tuple(ctx.config["penalties"]), tr["sample"], ctx.seed,
                    ctx.device, control=ctx.control)
    sweeps = sum(v for j in ctx.jobs_done for k, v in j["perf"].items()
                 if k.startswith("align.sweep_problems."))
    verdict.setdefault("notes", []).append(
        f"kernel B problems in the window: {sweeps:.0f}; inversion tries "
        "(s) per job: " + " ".join(
            f"{j['perf'].get('align.inversion_s', 0.0):.2f}"
            for j in ctx.jobs_done))
    return verdict
