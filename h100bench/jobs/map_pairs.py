"""Upstream's all-vs-all mapping as per-pair jobs: one -m -T <target
group> -Q <query group> job for each ordered pair of PanSN groups, each
building its own index of the target group.

Traffic keys: "group_level" (all2all_jobs.py's -t/-q grouping),
"drop_flags" (deployment flags the pair jobs leave out), "sample"
(records the reference checks), "control_flags" (flags a control run
adds to every job), "limits".
"""

from __future__ import annotations

import random

from benchlib.chunking import group, pairings
from reference.map_check import judge


def SPANS():
    from wfmash_tpu_torch import runner

    return [(runner, "build_index", "map.index_build"),
            (runner, "_map_queries_device", "map.queries_device")]


def setup(ctx):
    cfg, tr = ctx.config, ctx.traffic
    fasta = ctx.path(cfg["fasta"][0])
    names = list(ctx.inputs["lengths"])
    groups = group(names, tr["group_level"])
    flags = [f for f in cfg["flags"] if f not in tr["drop_flags"]]
    if ctx.control:
        flags += tr["control_flags"]
    jobs = []
    for tg, (qg,) in pairings(groups, groups, 1):
        jobs.append({"argv": [fasta] + flags + ["-m", "-T", f"{tg}#",
                                                "-Q", f"{qg}#"],
                     "target": f"{tg}#", "query": f"{qg}#",
                     "bp": sum(ctx.inputs["lengths"][n]
                               for n in groups[qg])})
    random.Random(ctx.seed).shuffle(jobs)
    # the window's first job, once: the CUDA context, the native
    # libraries and the device stages' first launches
    rc, _, _ = ctx.run_cli(jobs[0]["argv"], ctx.path("warm.paf"), "warm")
    if rc != 0:
        raise RuntimeError(f"warm-up job failed (rc {rc})")
    return jobs


def run(ctx, job, k):
    out = ctx.path(f"out_{k}.paf")
    rc, wall, perf = ctx.run_cli(job["argv"], out, "job")
    return {"ok": rc == 0, "wall": wall, "bp": job["bp"], "perf": perf,
            "out": out, "target": job["target"], "query": job["query"]}


def end_to_end(ctx):
    return {"mapped_mbps": sum(j["bp"] for j in ctx.jobs_done) / 1e6
            / ctx.window_s}


def check(ctx):
    return judge([j for j in ctx.jobs_done if j["ok"]],
                 ctx.path(ctx.config["fasta"][0]), ctx.config["kmer"],
                 ctx.config["mapping_window"], ctx.traffic["sample"],
                 ctx.seed)
