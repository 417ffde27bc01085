"""Where the mapping's wall goes: `python3 scripts/torch_map_profile.py`.

Runs the port's CLI in-process, mapping only (`-m`, `-t 1`), on the 6 Mb
synthetic pair of tests/test_scale.py: once untimed (builds the native
libraries, loads the CUDA modules), then with the device stages
(WFMASH_TPU_DEVICE_L1=1) and with the host stages (=0) in turns, twice
each, every run under cProfile. Prints each run's wall, its "mapping done
in" line and counters, and for the last run of each route the functions
that hold the most time. The PAFs of all runs must be equal. Needs a CUDA
device unless WFMASH_TPU_TORCH_DEVICE=cpu is set (a rehearsal).
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import io
import os
import pstats
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def run(argv, route, prof=None):
    """(PAF text, wall s, stderr text) of one CLI run on a mapping route."""
    from wfmash_tpu_torch import cli
    from wfmash_tpu_torch.utils import perf

    os.environ["WFMASH_TPU_DEVICE_L1"] = route
    out, err = io.StringIO(), io.StringIO()
    perf.reset()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        if prof is not None:
            prof.enable()
        rc = cli.main(argv)
        if prof is not None:
            prof.disable()
    wall = time.monotonic() - t0
    if rc != 0:
        raise RuntimeError(f"CLI exit {rc}: {err.getvalue()[-2000:]}")
    return out.getvalue(), wall, err.getvalue()


def main() -> int:
    from chip_smoke import card_line, write_pair
    from wfmash_tpu_torch import device
    from wfmash_tpu_torch.utils import perf

    ap = argparse.ArgumentParser()
    ap.add_argument("--bp", type=int, default=6_000_000)
    ap.add_argument("--top", type=int, default=22)
    args = ap.parse_args()
    dev = device.resolve()
    if dev.type == "cuda":
        print(f"[card] {card_line()}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        pt, pq = write_pair(tmp, args.bp)[:2]
        argv = [pt, pq, "-m", "-t", "1"]
        want, wall, _ = run(argv, "1")
        print(f"[first run, device stages] wall {wall:.2f} s", flush=True)
        last = {}
        for route in ("1", "0", "0", "1"):
            prof = cProfile.Profile()
            paf, wall, err = run(argv, route, prof)
            if paf != want:
                raise RuntimeError(f"route {route}: another PAF")
            done = [ln for ln in err.splitlines() if "done in" in ln]
            print(f"[route {route}] wall {wall:.2f} s; {'; '.join(done)}; "
                  + ", ".join(f"{k} {v:.3f}" for k, v in
                              sorted(perf.snapshot().items())), flush=True)
            last[route] = prof
        for route, prof in last.items():
            for key in ("cumulative", "tottime"):
                buf = io.StringIO()
                pstats.Stats(prof, stream=buf).sort_stats(key).print_stats(
                    args.top)
                print(f"[route {route}] by {key}:")
                print("\n".join(
                    ln for ln in buf.getvalue().splitlines()[6:] if ln))
    return 0


if __name__ == "__main__":
    sys.exit(main())
