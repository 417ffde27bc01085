"""The reference's golden outputs (tests/torch_golden/) and the port held
to them on the CPU.

scripts/torch_golden.py ran the JAX package's CLI (`python -m wfmash_tpu`,
its Pallas kernels in interpret mode) over generated inputs and recorded
each case in tests/torch_golden/manifest.json; chip_smoke.py's `golden`
phase holds the port on the card to the same bytes. This file checks that
the goldens cannot go stale and that the port meets them here:

(a) every input regenerates to its recorded sha256, through the script's
    generator and through chip_smoke.py's own copy of it;
(b) the manifest's hash of the reference package is the tree's;
(c) the reference's CLI writes the mapping-only goldens (M1-M7) again,
    byte for byte;
(d) the port's CLI writes them on its host mapping stages
    (WFMASH_TPU_DEVICE_L1=0), and M1 on its device stages over CPU
    tensors (=1; M2-M7 on that route: test_torch_golden_device.py);
(e) the port's CLI writes the smallest full-alignment goldens (A2, S1)
    with the plain versions of both kernels under the five-tier
    composition, its tiers taking the jobs the reference's took;
(f) the golden files are those the manifest names, with its hashes.
"""

from __future__ import annotations

import contextlib
import gzip
import hashlib
import io
import json
import os
import sys
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import chip_smoke  # noqa: E402
import torch_golden  # noqa: E402

torch.set_num_threads(1)

MANIFEST = json.load(open(os.path.join(torch_golden.GOLDEN,
                                       "manifest.json")))
# the cases at the size users run (chip_smoke.py's scale phase) take
# minutes each: tests/test_torch_scale.py checks their files and inputs
CASES = {c: e for c, e in MANIFEST["cases"].items()
         if c not in torch_golden.SCALE}
MAPPING = [c for c in CASES if "-m" in CASES[c]["argv"]]
SMALL_ALIGN = ("A2", "S1")


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    """Input directories by (source, generator, args), made once."""
    cache: dict = {}

    def get(case, source="script"):
        e = CASES[case]
        key = (source, json.dumps([e["generator"], e["args"]],
                                  sort_keys=True))
        if key not in cache:
            d = tmp_path_factory.mktemp(f"{source}_{case}")
            if source == "script":
                hashes = torch_golden.make_inputs(case, str(d))
            else:
                hashes = chip_smoke.golden_inputs(e, str(d))
            cache[key] = (str(d), hashes)
        return cache[key]

    return get


@pytest.mark.parametrize("source", ["script", "chip_smoke"])
@pytest.mark.parametrize("case", list(CASES))
def test_inputs_regenerate(made, case, source):
    """(a) the inputs hash as recorded, from either copy of the
    generators; the script's table agrees with the manifest."""
    _, hashes = made(case, source)
    assert hashes == CASES[case]["inputs"]
    gen, args, argv, env = torch_golden.CASES[case]
    assert (gen, args, argv) == (CASES[case]["generator"],
                                 CASES[case]["args"], CASES[case]["argv"])
    assert CASES[case]["env"] == {**torch_golden.ENV, **env}


def test_reference_hash():
    """(b) no file of the reference package changed since the goldens
    were written."""
    assert torch_golden.reference_hash() == MANIFEST["reference_sha256"]


def _cli(main, argv, d, env, monkeypatch):
    """One in-process run of a CLI's main in directory d with env set and
    no other WFMASH_TPU_* variable (other test modules set some when they
    are imported): (exit code, output bytes, wall s)."""
    monkeypatch.chdir(d)
    for k in list(os.environ):
        if k.startswith("WFMASH_TPU_"):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rc = main(list(argv))
    return rc, out.getvalue().encode(), time.monotonic() - t0


def _sha(b):
    return hashlib.sha256(b).hexdigest()


@pytest.mark.parametrize("case", MAPPING)
def test_reference_regenerates_mapping(made, case, monkeypatch):
    """(c) `wfmash_tpu.cli.main` (what `python -m wfmash_tpu` runs) writes
    the mapping golden again."""
    from wfmash_tpu import cli

    e = CASES[case]
    d, _ = made(case)
    rc, out, wall = _cli(cli.main, e["argv"], d, e["env"], monkeypatch)
    print(f"[{case}] reference CLI {wall:.2f} s")
    assert rc == 0
    assert _sha(out) == e["output_sha256"]


def port_run(made, case, monkeypatch, **env):
    """The port's CLI in-process on the CPU on a case's inputs, with the
    case's engine switch and `env`; (output bytes, perf counters, wall)."""
    from wfmash_tpu_torch import cli
    from wfmash_tpu_torch.utils import perf

    e = CASES[case]
    d, _ = made(case)
    perf.reset()
    rc, out, wall = _cli(
        cli.main, e["argv"], d,
        {"WFMASH_TPU_SEGMENTED": e["env"]["WFMASH_TPU_SEGMENTED"],
         "WFMASH_TPU_TORCH_DEVICE": "cpu", **env}, monkeypatch)
    assert rc == 0
    return out, perf.snapshot(), wall


@pytest.mark.parametrize("case,route",
                         [(c, "0") for c in MAPPING] + [("M1", "1")])
def test_port_reproduces_mapping(made, case, route, monkeypatch):
    """(d) the port's mapping bytes on its host stages, and M1 on its
    device stages (CPU tensors)."""
    out, snap, wall = port_run(made, case, monkeypatch,
                               WFMASH_TPU_DEVICE_L1=route)
    print(f"[{case}] port CLI, WFMASH_TPU_DEVICE_L1={route}: {wall:.2f} s")
    assert (snap.get("map.device_calls", 0) > 0) == (route == "1")
    assert out == torch_golden.read_output(CASES[case])


@pytest.mark.parametrize("case", SMALL_ALIGN)
def test_port_reproduces_alignment(made, case, monkeypatch):
    """(e) the port's PAF / SAM bytes with the plain kernel versions under
    the five-tier composition, and the same jobs a tier as the
    reference's (t3-t5 among them)."""
    out, snap, wall = port_run(made, case, monkeypatch)
    print(f"[{case}] port CLI: {wall:.2f} s")
    e = CASES[case]
    assert out == torch_golden.read_output(e)
    tiers, spans = chip_smoke.golden_counts(snap)
    assert (tiers, spans) == (e["tier_jobs"], e["sweep_problems"])
    assert chip_smoke.golden_reach(snap) == e["reach"]
    assert all(e["reach"][t] for t in ("t3", "t4", "t5"))


def test_golden_files():
    """(f) the directory holds the manifest and the files it names, each
    with its recorded hashes, size and rows."""
    every = MANIFEST["cases"]
    names = {e["output"] for e in every.values()}
    assert set(os.listdir(torch_golden.GOLDEN)) == names | {"manifest.json"}
    for case, e in every.items():
        raw = open(os.path.join(torch_golden.GOLDEN, e["output"]), "rb").read()
        assert _sha(raw) == e["stored_sha256"], case
        data = gzip.decompress(raw) if e["output"].endswith(".gz") else raw
        if case in torch_golden.DIGESTS:
            # the output's row digests; the output itself is not kept
            assert _sha(data) == e["digests_sha256"], case
        else:
            assert _sha(data) == e["output_sha256"], case
            assert len(data) == e["output_bytes"], case
        assert e["output"] == torch_golden.output_name(
            case, e["output_bytes"], "-a" in e["argv"]), case
        assert e["rows"] == sum(1 for ln in data.splitlines()
                                if not ln.startswith(b"@")), case
        assert e["rows"] > 0, case
        assert e["reach"] == torch_golden.reach(e["tier_jobs"],
                                                e["sweep_problems"]), case
    # what the acceptance asks of the set of cases
    assert {"M1", "A0", "A1", "A2", "A3", "S1"} <= set(CASES)
    assert {"B1", "Y1", "Y2"} <= set(every)
    assert len([c for c in MAPPING if c != "M1"]) >= 4
    assert CASES["A3"]["env"]["WFMASH_TPU_SEGMENTED"] == "0"
    assert CASES["A3"]["reach"]["K>=1024"]
