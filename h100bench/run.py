"""The port's benchmark: one run of one cell on the card.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

The cell is an entry of BENCHMARK.json's "workloads"; everything it
needs is found by name under h100bench/ (see README.md). The last line
of standard output is the result object; standard error ends with each
number the correctness check compared, beside its limit. Without a CUDA
card, or with fewer cards than the cell asks for, it exits 2 and prints
no result.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="put the reference in the program's place for "
                         "the sampled records, at the lower precision "
                         "(for setting limits; the benchmark never asks)")
    return ap.parse_args(argv)


def result_line(res: dict, device: dict) -> str:
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": res["metrics"],
           "device": device}
    if "breakdown" in res:
        out["breakdown"] = res["breakdown"]
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in res["checks"]}
    return json.dumps(out)


def main(argv=None) -> int:
    args = parse(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload}; the cells are "
              + ", ".join(cells), file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return 2
    name = torch.cuda.get_device_name(0)
    print(f"[h100bench] {args.workload} seed {args.seed} on {name}",
          file=sys.stderr)
    os.environ["WFMASH_TPU_TORCH_DEVICE"] = "cuda"
    from benchlib.cell import run_cell

    res = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda"), T_START,
                   control=bool(args.control))
    device = {"platform": "gpu", "kind": name, "count": chips,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    if args.trace:
        device["busy_s"] = res["busy_s"]
        device["window_s"] = res["window_s"]
    for note in res["notes"]:
        print(f"[h100bench] {note}", file=sys.stderr)
    for c in res["checks"]:
        print(f"{c['name']} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(result_line(res, device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
