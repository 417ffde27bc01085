"""wfmash_tpu_torch stands alone: it imports torch, never jax, and nothing
of wfmash_tpu; its copies of the host modules still compute what the
originals compute.

* In a subprocess (this process has jax loaded by tests/conftest.py):
  import the CLI, run `python -m wfmash_tpu_torch` on a small seeded pair
  on the CPU, mapping through the device stages (WFMASH_TPU_DEVICE_L1=1:
  the torch programs on CPU tensors), for the default switches (the
  native host engine there),
  for the card's default composition (WFMASH_TPU_SEGMENTED=1) and for
  WFMASH_TPU_SEGMENTED=0, then once more with the mesh routes over eight
  logical CPU shards (WFMASH_TPU_DEVICE_L1=mesh, WFMASH_TPU_ALIGN_MESH=
  force), then look at sys.modules.
* A source scan: no file of the package, nor chip_smoke.py, has an import
  of jax or of wfmash_tpu (wfmash_tpu_torch is allowed). chip_smoke.py's
  `golden` phase reads tests/torch_golden/ as data: a subprocess loads
  its manifest, a golden file and a case's inputs through chip_smoke.py
  and finds no jax and no wfmash_tpu in sys.modules.
* The copied host modules against the originals on seeded inputs where a
  whole-path test would not reach them. Tolerance: exact.
"""

import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from util import mutate, random_dna, write_fasta

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "wfmash_tpu_torch"

_CHILD = r"""
import contextlib, io, json, os, runpy, sys
import torch
import wfmash_tpu_torch.cli
from wfmash_tpu_torch.align import rkmh, wfa_seg
from wfmash_tpu_torch.parallel import dryrun, mesh
mesh.mesh_devices = lambda device=None: [torch.device("cpu")] * 8
sharded = []
_real = wfa_seg._run_seg_sharded
def _count(*a, **kw):
    got = _real(*a, **kw)
    sharded.append(len(got[1]))
    return got
wfa_seg._run_seg_sharded = _count
out = {}
for mode, seg, l1, amesh in (("default", "auto", "1", "0"),
                             ("segmented", "1", "1", "0"),
                             ("exact", "0", "1", "0"),
                             ("mesh", "1", "mesh", "force")):
    os.environ.update(WFMASH_TPU_SEGMENTED=seg, WFMASH_TPU_DEVICE_L1=l1,
                      WFMASH_TPU_ALIGN_MESH=amesh)
    sys.argv = ["wfmash_tpu_torch"] + sys.argv[1:]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            runpy.run_module("wfmash_tpu_torch", run_name="__main__")
        except SystemExit as e:
            out[mode + "_rc"] = e.code
    out[mode] = buf.getvalue()
out["bad"] = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "jaxlib"))
                    or m == "wfmash_tpu" or m.startswith("wfmash_tpu."))
out["ran"] = sorted(m for m in ("wfa_exact", "wfa_seg", "wfa_sweep")
                    if "wfmash_tpu_torch.align." + m in sys.modules)
out["mapped"] = sorted(m for m in ("l1_device", "l2_device")
                       if "wfmash_tpu_torch.map." + m in sys.modules)
from wfmash_tpu_torch.utils import perf
out["device_calls"] = [perf.get("map.device_calls"),
                       perf.get("map.l2_device_calls")]
out["sharded_launches"] = sum(sharded)
print(json.dumps(out))
"""


def test_cli_runs_both_paths_without_jax_or_reference(tmp_path):
    rng = np.random.default_rng(4)
    t = random_dna(rng, 12_000)
    q = mutate(rng, t[:6_000], 0.02) + mutate(rng, t[6_030:], 0.01)
    tfa, qfa = str(tmp_path / "t.fa"), str(tmp_path / "q.fa")
    write_fasta(tfa, {"t1": t})
    write_fasta(qfa, {"q1": q})
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("WFMASH_TPU_")}
    env.update(PYTHONPATH=str(REPO), WFMASH_TPU_TORCH_DEVICE="cpu",
               WFMASH_TPU_DEVICE_L1="1")
    r = subprocess.run([sys.executable, "-c", _CHILD, tfa, qfa, "-t", "1"],
                       capture_output=True, text=True, timeout=900, env=env,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert out["ran"] == ["wfa_exact", "wfa_seg", "wfa_sweep"]
    assert out["mapped"] == ["l1_device", "l2_device"]
    assert min(out["device_calls"]) >= 4        # one of each a CLI run
    modes = ("default", "segmented", "exact", "mesh")
    assert [out[m + "_rc"] for m in modes] == [0, 0, 0, 0]
    assert out["mesh"] == out["segmented"] and out["sharded_launches"] > 0
    for mode in modes:
        rows = [ln for ln in out[mode].splitlines() if "\tcg:Z:" in ln]
        assert rows, mode
        cov = sum(int(f[3]) - int(f[2])
                  for f in (ln.split("\t") for ln in rows))
        assert cov >= 0.9 * len(q), mode


_IMPORT = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|wfmash_tpu)\b(?!_)", re.M)
_DYNAMIC = re.compile(
    r"(?:import_module|__import__)\(\s*['\"](?:jax|wfmash_tpu)\b(?!_)")


def test_sources_import_neither_jax_nor_the_reference():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 40
    assert _IMPORT.search("from wfmash_tpu.align import x")
    assert _IMPORT.search("    import jax.numpy as jnp")
    assert not _IMPORT.search("from wfmash_tpu_torch.align import x")
    bad = [str(f.relative_to(REPO)) for f in files
           if _IMPORT.search(f.read_text()) or _DYNAMIC.search(f.read_text())]
    assert bad == []
    names = {str(f.relative_to(PKG)) for f in files[:-1]}
    assert {"map/l1_device.py", "map/l2_device.py", "parallel/mesh.py",
            "parallel/dryrun.py", "align/rkmh.py"} <= names
    # the files the port does not copy: ported under other names, or left
    # out on purpose (the TPU's 64-bit emulation, the JAX compile cache)
    for name in ("ops", "align/wfa_jax.py", "align/wfa_pallas.py",
                 "align/wfa_pallas_seg.py", "utils/jaxcache.py"):
        assert not (PKG / name).exists(), name


_GOLDEN_CHILD = r"""
import json, sys, tempfile
sys.path.insert(0, sys.argv[1])
import chip_smoke
man = chip_smoke.golden_manifest()
e = man["cases"]["A2"]
with tempfile.TemporaryDirectory() as d:
    same = chip_smoke.golden_inputs(e, d) == e["inputs"]
print(json.dumps(dict(
    cases=sorted(man["cases"]), same=same,
    rows=chip_smoke.golden_bytes(e).count(b"\n"),
    dir=chip_smoke.GOLDEN_DIR, phases=list(chip_smoke.PHASES),
    leaked=sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "wfmash_tpu")))))
"""


def _golden_section(src):
    """chip_smoke.py's `golden` phase: from its section header to the
    next one."""
    a = src.index("# golden: ")
    return src[a:src.index("\n# ----", src.index("def golden_phase", a))]


def test_golden_phase_reads_goldens_without_the_reference():
    src = (REPO / "chip_smoke.py").read_text()
    sec = _golden_section(src)
    assert "def golden_phase" in sec and '"torch_golden"' in sec
    assert not _IMPORT.search(sec) and not _DYNAMIC.search(sec)
    assert "jax" not in sec.replace("JAX package", "")
    r = subprocess.run([sys.executable, "-c", _GOLDEN_CHILD, str(REPO)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["leaked"] == []
    assert got["same"] and got["rows"] == 3
    assert got["dir"] == str(REPO / "tests" / "torch_golden")
    assert "golden" in got["phases"]
    assert {"M1", "A0", "A1", "A2", "A3", "S1"} <= set(got["cases"])


# ---------------------------------------------------------------------------
# copies against originals
# ---------------------------------------------------------------------------


def _pairs(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = random_dna(rng, int(rng.integers(lo, hi)))
        q = mutate(rng, t, 0.06)
        a = int(rng.integers(10, len(q) - 10))
        out.append((q[:a] + q[a + int(rng.integers(0, 6)):], t))
    return out


def _cmp_cigar(ref, port):
    for q, t in _pairs(1, 6, 80, 300):
        _, ops = ref["wfa_vec"].wfa_align(q, t, ref["P"])
        s = ref["cigar"].format_ops(ops)
        assert port["cigar"].format_ops(ops) == s
        assert port["cigar"].parse(s) == ref["cigar"].parse(s)
        assert port["cigar"].stats(ops) == ref["cigar"].stats(ops)
        assert port["cigar"].merge_ops(ops + ops) == \
            ref["cigar"].merge_ops(ops + ops)
        assert port["cigar"].validate(ops, q, t, 0, 0)
        bad = q[1:] + b"A"
        assert port["cigar"].validate(ops, bad, t, 0, 0) == \
            ref["cigar"].validate(ops, bad, t, 0, 0)


def _cmp_wfa(ref, port):
    from wfmash_tpu.align.wfa_np import EndsFree as RE
    from wfmash_tpu_torch.align.wfa_np import EndsFree as PE

    for i, (q, t) in enumerate(_pairs(2, 6, 60, 220)):
        efs = [(None, None),
               (RE(target_begin=len(t), query_begin=len(q)),
                PE(target_begin=len(t), query_begin=len(q))),
               (RE(target_end=30, query_end=20), PE(target_end=30,
                                                    query_end=20))]
        r_ef, p_ef = efs[i % 3]
        want = ref["wfa_np"].wfa_align(q, t, ref["P"], r_ef)
        assert port["wfa_np"].wfa_align(q, t, port["P"], p_ef) == want
        assert port["wfa_vec"].wfa_align(q, t, port["P"], p_ef) == \
            ref["wfa_vec"].wfa_align(q, t, ref["P"], r_ef)
        assert port["wfa_vec"].wfa_align_py(q, t, port["P"], p_ef) == want
        assert port["wfa_np"].dp_align(q, t, port["P"], p_ef) == want[0]
        assert port["wfa_np"].score_cigar(want[1], port["P"]) == \
            ref["wfa_np"].score_cigar(want[1], ref["P"])


def _job(mod, q, t, rev=False):
    return mod.AlignmentJob(
        query_name="q1", query=q, query_total_length=len(q) + 50,
        query_offset=20, query_length=len(q), query_is_rev=rev,
        target_name="t1", target=t, target_total_length=len(t) + 70,
        target_offset=30, target_length=len(t),
        mashmap_estimated_identity=0.95, chain_id=3, chain_length=2,
        chain_pos=1)


def _cmp_sam(ref, port):
    for i, (q, t) in enumerate(_pairs(3, 4, 150, 400)):
        _, ops = ref["wfa_vec"].wfa_align(q, t, ref["P"])
        outs = []
        for side in (ref, port):
            buf = io.StringIO()
            side["sam"].write_sam_row(
                buf, _job(side["biwfa"], q, t, rev=bool(i % 2)), ops, 0.0,
                0, 0.0, no_seq=bool(i // 2), emit_md=True)
            side["biwfa"].write_paf_row(
                buf, _job(side["biwfa"], q, t, rev=bool(i % 2)), ops, 0.0,
                0, 0.0)
            outs.append(buf.getvalue())
        assert outs[0] == outs[1] and outs[0].count("\n") == 2


def _mappings(mod, rng, n):
    """n colinear-ish mappings of one query on one target, sorted by query
    start, every third on the reverse strand."""
    m = np.zeros(n, mod.MAPPING_DTYPE)
    pos = np.sort(rng.integers(0, 200_000, n))
    m["query_start"] = pos
    m["block_length"] = rng.integers(800, 5000, n)
    m["ref_start"] = pos + 1000 + rng.integers(0, 300, n)
    m["n_merged"] = rng.integers(1, 6, n)
    m["conserved_sketches"] = rng.integers(10, 60, n)
    m["nuc_identity"] = rng.integers(8000, 10000, n)
    m["kmer_complexity"] = rng.integers(60, 100, n)
    m["flags"] = np.where(np.arange(n) % 3 == 0, mod.FLAG_REV, 0)
    return m


def _cmp_map(ref, port):
    from wfmash_tpu.params import MapParams as RP
    from wfmash_tpu_torch.params import MapParams as PP

    assert ref["l1l2"].MAPPING_DTYPE == port["l1l2"].MAPPING_DTYPE
    for seed in (5, 6):
        got = []
        for side, cls in ((ref, RP), (port, PP)):
            m = _mappings(side["l1l2"], np.random.default_rng(seed), 60)
            params = cls()
            merged, chains = side["chain"].merge_mappings_with_chains(
                m, params.chain_gap, params)
            keep = side["filters"].filter_weak_mappings(
                merged, 3, params, lambda sid: 400_000, 260_000)
            keep2 = side["filters"].filter_false_high_identity(merged, params)
            hashes = [side["filters"].mapping_struct_hash(r) for r in merged]
            got.append((merged.tobytes(), chains.tobytes(), keep.tobytes(),
                        keep2.tobytes(), hashes, len(merged)))
        assert got[0] == got[1]
        assert 0 < got[0][5] < 60


def _cmp_debugplot(ref, port):
    """-G / -u: the plan dumps of both engine modules, file for file."""
    import tempfile
    from types import SimpleNamespace

    rng = np.random.default_rng(9)
    t = random_dna(rng, 6000)
    q = mutate(rng, t[:2500], 0.03) + mutate(rng, t[3100:], 0.03)
    dumps = []
    for side in (ref, port):
        with tempfile.TemporaryDirectory() as d:
            params = SimpleNamespace(
                wavefront_tsv_prefix=os.path.join(d, "w."),
                wavefront_png_prefix=os.path.join(d, "p."),
                wfplot_max_size=300)
            jobs = [_job(side["biwfa"], q, t),
                    _job(side["biwfa"], q[:40], t[:50])]
            if side is port:
                side["engine"]._dump_plans(params, jobs, 7)
            for i, job in enumerate(jobs if side is ref else ()):
                # the reference's run_alignment names its dumps so
                stem = f"{7 + i:06d}.q1_20_t1_30"
                rows = side["debugplot"].plan_rows(job.query, job.target)
                side["debugplot"].write_plan_tsv(
                    f"{params.wavefront_tsv_prefix}{stem}.tsv", job, rows)
                side["debugplot"].write_plan_png(
                    f"{params.wavefront_png_prefix}{stem}.png", rows,
                    job.query_length, job.target_length, 300)
            dumps.append({f: open(os.path.join(d, f), "rb").read()
                          for f in sorted(os.listdir(d))})
        assert side["debugplot"].plan_rows(q, t)[-1] == (len(t), len(q), 2)
    assert dumps[0] == dumps[1] and len(dumps[0]) == 4
    assert sum(f.endswith(".png") for f in dumps[0]) == 2


def _modules():
    import importlib

    def side(pkg):
        get = lambda n: importlib.import_module(f"{pkg}.{n}")  # noqa: E731
        d = {k: get(f"align.{k}") for k in ("cigar", "wfa_np", "wfa_vec",
                                             "sam", "biwfa", "debugplot")}
        if pkg == "wfmash_tpu_torch":
            d["engine"] = get("align.engine")
        d.update({k: get(f"map.{k}") for k in ("filters", "chain", "l1l2")})
        d["P"] = d["wfa_np"].Penalties(5, 8, 2, 24, 1)
        return d

    return side("wfmash_tpu"), side("wfmash_tpu_torch")


@pytest.mark.parametrize("check", [_cmp_cigar, _cmp_wfa, _cmp_sam, _cmp_map,
                                   _cmp_debugplot],
                         ids=["cigar", "wfa_np-wfa_vec", "sam",
                              "map-filters-chain", "debugplot-png"])
def test_copied_module_matches_original(check):
    ref, port = _modules()
    for k in ref:
        if k != "P":   # (the port's "engine" has no counterpart to compare)
            assert ref[k] is not port[k]
            assert port[k].__name__.startswith("wfmash_tpu_torch.")
    check(ref, port)
