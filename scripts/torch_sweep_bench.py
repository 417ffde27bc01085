"""Time the sweep kernel (csrc/sweep_wfa.cu) on one GPU on chip_smoke.py's
sweep batches, without the plain PyTorch version:

    python3 scripts/torch_sweep_bench.py [--reps 5] [--only K=1024,boundary]

For each batch of `chip_smoke.sweep_batches` (the same generator and seed
as its `--phases sweep` run; `--only` keeps the batches whose name holds
one of the given strings) it launches the kernel `wfa_sweep.kernel_choice`
names and the global-ring kernel on the same inputs in turns (global,
chosen, chosen, global), requires equal outputs, and prints both times
with the card's name and power limit. With `--clusters` it also times the
shared-memory kernel at every cluster size the shape allows (fewer lanes a
block, more blocks a problem), which shows what the cluster barrier costs.
chip_smoke.py holds both kernels against the plain version; this script is
the short call for comparing kernel versions on one card.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from wfmash_tpu_torch.align import wfa_sweep
    from wfmash_tpu_torch.align.wfa_np import Penalties

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", default="")
    ap.add_argument("--clusters", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    only = [w for w in args.only.split(",") if w]
    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED)
    print(f"[card] {cs.card_line()}", flush=True)
    total = {"chosen": 0.0, "global": 0.0}
    batches, _ = cs.sweep_batches(rng, Penalties(5, 8, 2, 24, 1))
    for name, K, pairs, flip, p, max_s in batches:
        if only and not any(w in name for w in only):
            continue
        d = cs._sweep_inputs(pairs, K, flip)
        ten = [torch.from_numpy(d[k]).to(dev) for k in
               ("query", "target", "par", "seed_off", "seed_anc")]
        cluster = wfa_sweep.kernel_choice(p, K)

        def run(c):
            return wfa_sweep._launch(*ten, p, K, max_s, c)

        cs._cuda_ms(lambda: run(cluster), 1)
        ms = {"chosen": [], "global": []}
        for which, c in (("global", 0), ("chosen", cluster),
                         ("chosen", cluster), ("global", 0)):
            t, out = cs._cuda_ms(lambda: run(c), args.reps)
            ms[which].append(t)
            if which == "chosen":
                kern = out.cpu().numpy()
            else:
                glob = out.cpu().numpy()
        if (kern != glob).any():
            raise RuntimeError(f"{name}: the two kernels disagree on "
                               f"{int((kern != glob).any(1).sum())} rows")
        levels = kern[:, 4].astype(np.int64)
        if args.clusters and cluster:
            for c in (1, 2, 4, 8):
                if K % c or not 32 <= K // c <= wfa_sweep.BLOCK_LANES:
                    continue
                t, out = cs._cuda_ms(lambda: run(c), args.reps)
                if (out.cpu().numpy() != kern).any():
                    raise RuntimeError(f"{name}: cluster of {c} disagrees")
                print(f"[bench {name}] cluster of {c} x {K // c} lanes: "
                      f"{t:.3f} ms, {wfa_sweep.active_clusters(p, K, c)} "
                      "problems at once", flush=True)
        for which in total:
            total[which] += min(ms[which])
        print(f"[bench {name}] {wfa_sweep.kernel_name(cluster)}: "
              f"{ms['chosen'][0]:.3f} {ms['chosen'][1]:.3f} ms; global rings: "
              f"{ms['global'][0]:.3f} {ms['global'][1]:.3f} ms; levels sum "
              f"{int(levels.sum())} deepest {int(levels.max())}; equal "
              "outputs", flush=True)
    print(f"[bench] sum of the faster times: chosen {total['chosen']:.3f} "
          f"ms, global rings {total['global']:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
