"""One run of one cell: inputs, set-up, the window, the trace, the
correctness check and the result line.

Everything a cell needs is found by name: its configuration in
configs/<config>.json, its traffic in traffic/<traffic>.json, the job
kind the traffic names in jobs/<job>.py and each per-layer metric in
metrics/<metric>.py.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

from . import trace as tracing
from .window import run_window

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "wfmash_tpu")


def load_json(*parts):
    with open(os.path.join(HERE, *parts)) as fh:
        return json.load(fh)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is jax, jaxlib,
    flax or the JAX package."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def metric_reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"h100bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Ctx:
    """What a job kind and a metric reader see of the run."""

    def __init__(self, cell, config, traffic, seed, work, device, control):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.work, self.device = seed, work, device
        self.control = control
        self.inputs: dict = {}
        self.spans = tracing.Spans()
        self.jobs_done: list = []
        self.window_s = 0.0
        self.trace: dict | None = None

    def path(self, name: str) -> str:
        return os.path.join(self.work, name)

    def run_cli(self, argv, out_path, tag):
        """One in-process call of the port's CLI, its stdout to out_path,
        its log to <work>/<tag>.log; (return code, wall seconds, the
        port's perf counters' change over the call)."""
        import torch
        from wfmash_tpu_torch import cli
        from wfmash_tpu_torch.utils import perf

        before = perf.snapshot()
        t0 = time.monotonic()
        with open(out_path, "w") as out, \
                open(self.path(f"{tag}.log"), "w") as log, \
                contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(log), \
                self.spans.span(f"job:{self.traffic['job']}"):
            try:
                rc = cli.main(list(argv))
            except Exception:
                traceback.print_exc()
                rc = -1
            if self.device.type == "cuda":
                torch.cuda.synchronize()
        wall = time.monotonic() - t0
        after = perf.snapshot()
        delta = {k: v - before.get(k, 0.0) for k, v in after.items()
                 if v != before.get(k, 0.0)}
        return rc, wall, delta


def host_sample() -> tuple:
    """(this process's CPU seconds, the machine's /proc/stat cpu ticks)."""
    t = os.times()
    try:
        with open("/proc/stat") as fh:
            ticks = [int(x) for x in fh.readline().split()[1:]]
    except OSError:
        ticks = []
    return t.user + t.system, ticks


def host_note(before: tuple, after: tuple, window_s: float) -> str:
    """How the host spent the window: this process's CPU seconds, and the
    machine's busy, iowait and steal shares of all its CPUs' time."""
    note = (f"host: process cpu {after[0] - before[0]:.1f} s in the "
            f"{window_s:.1f} s window")
    d = [b - a for a, b in zip(before[1], after[1])]
    if len(d) >= 8 and sum(d) > 0:
        total = sum(d)
        note += (f"; machine busy {100 * (total - d[3] - d[4]) / total:.1f}%"
                 f", iowait {100 * d[4] / total:.1f}%"
                 f", steal {100 * d[7] / total:.1f}% of {os.cpu_count()}"
                 " cpus")
    return note


def make_inputs(ctx: Ctx) -> None:
    """The configuration's genomes, written into the work directory by a
    child process (its arrays never count in this process's RSS)."""
    r = subprocess.run(
        [sys.executable, os.path.join(HERE, "benchlib", "inputs.py"),
         json.dumps(ctx.config["input"]), str(ctx.seed), ctx.work],
        capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"input generator failed:\n{r.stderr[-4000:]}")
    ctx.inputs = json.loads(r.stdout.strip().splitlines()[-1])


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, control: bool = False,
             work_root: str | None = None, config: dict | None = None,
             traffic: dict | None = None) -> dict:
    """One run; returns the result object (without the device block) and
    the checks compared, each {"name", "value", "limit"}. `config` and
    `traffic` stand in for the cell's files (tests at a small size)."""
    import torch

    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    config = config or load_json("configs", f"{cell['config']}.json")
    traffic = traffic or load_json("traffic", f"{cell['traffic']}.json")
    kind = importlib.import_module(f"jobs.{traffic['job']}")
    work = tempfile.mkdtemp(prefix="h100bench-",
                            dir=work_root or tempfile.gettempdir())
    try:
        ctx = Ctx(cell, config, traffic, seed, work, device, control)
        make_inputs(ctx)
        jobs = kind.setup(ctx)
        if device.type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.monotonic() - t_start
        ctx.spans = tracing.Spans(annotate=trace)
        prof = None
        with contextlib.ExitStack() as stack:
            if trace:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if device.type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                prof = stack.enter_context(profile(activities=acts))
                stack.enter_context(tracing.wrapped(ctx.spans,
                                                    kind.SPANS()))
            host0 = host_sample()
            with ctx.spans.span("window"):
                ctx.jobs_done, ctx.window_s = run_window(
                    jobs, seconds, lambda job, k: kind.run(ctx, job, k))
            host1 = host_sample()
        peak_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        mem_peak = (torch.cuda.max_memory_allocated()
                    if device.type == "cuda" else 0)
        if prof is not None:
            ctx.trace = tracing.summarize(tracing.read_profile(prof))
            del prof
        found = forbidden_modules()
        if found:
            raise RuntimeError("loaded in the measured process: "
                               + ", ".join(found))
        failed = sum(1 for j in ctx.jobs_done if not j["ok"])
        ctx.values = {"setup_s": setup_s, "peak_rss_gb": peak_rss / 1e9}
        ctx.values.update(kind.end_to_end(ctx))
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        metrics = {}
        for m in bench["per_layer" if trace else "end_to_end"]:
            if cell_name not in m.get("workloads", [cell_name]):
                continue
            v = (metric_reader(m["name"])(ctx) if trace
                 else ctx.values.get(m["name"]))
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        t_check = time.monotonic()
        verdict = kind.check(ctx)
        verdict.setdefault("notes", []).append(
            f"check took {time.monotonic() - t_check:.1f} s; window "
            f"{ctx.window_s:.3f} s, {len(ctx.jobs_done)} jobs; set-up "
            f"{setup_s:.1f} s")
        verdict["notes"].append("the job kind's numbers, reported or not: "
                                + ", ".join(f"{k} {v!r}" for k, v in
                                            sorted(ctx.values.items())))
        verdict["notes"].append(host_note(host0, host1, ctx.window_s))
        verdict["notes"].append("jobs (s, Mbp): " + " ".join(
            f"{j['wall']:.2f}/{j['bp'] / 1e6:.2f}" for j in ctx.jobs_done))
        checks = [{"name": k, "value": v,
                   "limit": traffic["limits"][k]}
                  for k, v in verdict["numbers"].items()]
        correct = (failed == 0 and all(c["value"] <= c["limit"]
                                       for c in checks))
        out = {"correct": correct, "attempted": len(ctx.jobs_done),
               "failed": failed, "metrics": metrics,
               "memory_peak_bytes": mem_peak, "checks": checks,
               "notes": verdict.get("notes", [])}
        if trace:
            out["busy_s"] = ctx.trace["busy_s"]
            out["window_s"] = ctx.window_s
            out["breakdown"] = ctx.trace["breakdown"]
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)
