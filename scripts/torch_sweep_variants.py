"""Edited copies of the sweep kernel (csrc/sweep_wfa.cu) on one GPU, each
timed beside the committed source on chip_smoke.py's sweep batches:

    python3 scripts/torch_sweep_variants.py [--only 65534,boundary,K=256]

The copies are written to a temporary directory, built with the port's
nvcc flags and launched through `wfa_sweep._launch`; each is also held
against its own global-ring kernel, which shares no ring code with the
shared-memory kernel. They answer two questions the committed kernel
cannot answer about itself:

* `halo-ends-off` puts back a halo test that skips the halo columns of a
  cluster's first and last block. The `boundary` batches must then differ
  from the global-ring kernel (they exist to catch this); other batches
  need not.
* `l1-one-block`, `l1-full`, `l1-none` ask for a fixed shared-memory/L1
  split (one block's share of shared memory, all the blocks' that fit an
  SM, all of it) where the committed launch computes the split from the
  batch. `K=256 x4` is the first ladder batch four times over, 512
  problems, more than one block an SM.
* `clock` counts, per problem, the busiest thread's cycles and bytes in
  the match extension, in the shared-memory kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SPLIT = ("  err = cudaFuncSetAttribute(\n"
         "      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,\n"
         "      (int)(pct > 100 ? 100 : pct));\n")


def _split(expr):
    return [(SPLIT, SPLIT.replace("(int)(pct > 100 ? 100 : pct)", expr))]


# name -> (text to find in the source, text put in its place), found once
VARIANTS = {
    "committed": [],
    "halo-ends-off": [
        ("  const int reach = own ? INT_MAX : (col < H ? col : W - 1 - col);\n",
         "  const int reach = own ? INT_MAX : rank == 0 || rank + 1 == C ? 0\n"
         "                    : (col < H ? col : W - 1 - col);\n")],
    "l1-one-block": _split("(int)((per_block * 100 + SM_SHARED_BYTES - 1) "
                           "/ SM_SHARED_BYTES)"),
    "l1-full": _split("(int)((fit * per_block * 100 + SM_SHARED_BYTES - 1) "
                      "/ SM_SHARED_BYTES)"),
    "l1-none": _split("100"),
    "clock": [
        ("struct Pen {", "__device__ int g_cyc[4096], g_bytes[4096];\n"
                         "struct Pen {"),
        ("  if (pr[4]) {  // solved before the sweep; the same in every block",
         "  long long ext_cyc = 0;\n  int ext_bytes = 0;\n"
         "  if (rank == 0 && tid == 0) g_cyc[b] = g_bytes[b] = 0;\n"
         "  if (pr[4]) {  // solved before the sweep; the same in every block"),
        ("            m_ext = extend(qw, tw, m_off, kv, qlen, tlen);\n",
         "            const long long c0 = clock64();\n"
         "            m_ext = extend(qw, tw, m_off, kv, qlen, tlen);\n"
         "            ext_cyc += clock64() - c0;\n"
         "            ext_bytes += m_ext - m_off;\n"),
        ("  if (rank == 0 && tid == 0) {\n    // levels swept after",
         "  atomicMax(&g_cyc[b], (int)(ext_cyc >> 4));\n"
         "  atomicMax(&g_bytes[b], ext_bytes);\n"
         "  if (rank == 0 && tid == 0) {\n    // levels swept after"),
        ("const char* sweep_wfa_error_string(int code) {",
         "int sweep_wfa_clock(int* cyc, int* bytes, int n) {\n"
         "  cudaDeviceSynchronize();\n"
         "  cudaMemcpyFromSymbol(cyc, g_cyc, n * 4);\n"
         "  cudaMemcpyFromSymbol(bytes, g_bytes, n * 4);\n  return 0;\n}\n"
         "const char* sweep_wfa_error_string(int code) {")],
}


def build(tmp, name, edits):
    """The library of the source with `edits` made, bound as
    wfa_sweep._lib binds the committed one."""
    from wfmash_tpu_torch import _build

    src = open(os.path.join(ROOT, "wfmash_tpu_torch", "csrc",
                            "sweep_wfa.cu")).read()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: marker not found once: {old!r}")
        src = src.replace(old, new)
    cu, so = (os.path.join(tmp, f"{name}{ext}") for ext in (".cu", ".so"))
    with open(cu, "w") as fh:
        fh.write(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sweep_wfa_launch.restype = ci
    lib.sweep_wfa_launch.argtypes = [vp, vp, ci, ci, vp, vp, vp, ci, ci,
                                     ci, ci, ci, ci, ci, ci, vp, vp, vp]
    lib.sweep_wfa_active_clusters.restype = ci
    lib.sweep_wfa_active_clusters.argtypes = [ci] * 7
    lib.sweep_wfa_error_string.restype = ctypes.c_char_p
    lib.sweep_wfa_error_string.argtypes = [ci]
    return lib


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from wfmash_tpu_torch.align import wfa_sweep
    from wfmash_tpu_torch.align.wfa_np import Penalties

    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="65534,boundary,40 kb,K=256,K=4096")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    only = [w for w in args.only.split(",") if w]
    dev = torch.device("cuda")
    print(f"[card] {cs.card_line()}", flush=True)
    batches, _ = cs.sweep_batches(np.random.default_rng(cs.SEED),
                                  Penalties(5, 8, 2, 24, 1))
    data = {}
    for name, K, pairs, flip, p, max_s in batches:
        if not wfa_sweep.kernel_choice(p, K) or \
                not any(w in name for w in only):
            continue
        d = cs._sweep_inputs(pairs, K, flip)
        ten = [torch.from_numpy(d[k]).to(dev) for k in
               ("query", "target", "par", "seed_off", "seed_anc")]
        data[name] = (ten, p, K, max_s)
        if name == "K=256":
            data["K=256 x4"] = ([t.repeat(4, 1) for t in ten], p, K, max_s)
    with tempfile.TemporaryDirectory() as tmp:
        for variant, edits in VARIANTS.items():
            lib = build(tmp, variant, edits)
            wfa_sweep._lib = lambda: lib
            for name, (ten, p, K, max_s) in data.items():
                cluster = wfa_sweep.kernel_choice(p, K)

                def run(c):
                    return wfa_sweep._launch(*ten, p, K, max_s, c)

                cs._cuda_ms(lambda: run(cluster), 1)
                g_ms, glob = cs._cuda_ms(lambda: run(0), args.reps)
                k_ms, kern = cs._cuda_ms(lambda: run(cluster), args.reps)
                bad = int((glob != kern).any(1).sum())
                line = (f"[{variant}] {name}: "
                        f"{wfa_sweep.kernel_name(cluster)} {k_ms:.3f} ms "
                        f"({wfa_sweep.active_clusters(p, K)} problems at "
                        f"once), global rings {g_ms:.3f} ms, rows that "
                        f"differ {bad} of {len(kern)}")
                if variant == "clock":
                    B = len(kern)
                    cyc, nb = (ctypes.c_int * B)(), (ctypes.c_int * B)()
                    lib.sweep_wfa_clock(cyc, nb, B)
                    i = int(np.argmax(cyc))
                    line += (f"; busiest extension: {cyc[i] * 16} cycles "
                             f"over {nb[i]} bytes in problem {i} (lengths "
                             f"{int(ten[2][i, 0])}, {int(ten[2][i, 1])})")
                print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
