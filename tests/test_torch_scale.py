"""The inputs of chip_smoke.py's `scale` phase (tests/torch_golden/ B0,
B1, Y1, Y2: the 100 Mb pair of scripts/scale_demo.py and a yeast-sized
8-genome PanSN pangenome) and the port held to the reference on them at a
reduced size, on the CPU.

(a) both copies of `yeast_pangenome` (scripts/torch_golden.py and
    chip_smoke.py's) write the same bytes at 2% of its lengths; at full
    size (marked slow: minutes) both copies of each generator write the
    inputs the manifest records;
(b) on the reduced pangenome the port's CLI writes the reference CLI's
    bytes under upstream's yeast mapping test (`-p 95 -n 7 -m -L -Y '#'`),
    on the host stages and on the device stages over CPU tensors;
(c) B0's row digests: chip_smoke.py's copy equals the script's, and a
    doctored output is named by its first differing row;
(d) the manifest's scale entries name the script's cases, generators and
    inputs, and chip_smoke.py's gates read PAF rows as pafcheck does.
"""

from __future__ import annotations

import hashlib
import os

import pytest

from test_torch_golden import MANIFEST, _cli

import chip_smoke
import torch_golden

REDUCED = dict(seed=8, scale=0.02)
Y_MAP = ["pan.fa", "-p", "95", "-n", "7", "-m", "-L", "-Y", "#"]


@pytest.fixture(scope="module")
def reduced(tmp_path_factory):
    """The pangenome at 2% of its lengths, from the script's generator."""
    d = tmp_path_factory.mktemp("yeast_reduced")
    torch_golden.yeast_pangenome(str(d), **REDUCED)
    return str(d)


@pytest.fixture(scope="module")
def reference_y(reduced, tmp_path_factory):
    """The reference CLI's mapping bytes on the reduced pangenome."""
    from wfmash_tpu import cli

    mp = pytest.MonkeyPatch()
    try:
        rc, out, _ = _cli(cli.main, Y_MAP, reduced,
                          {"JAX_PLATFORMS": "cpu"}, mp)
    finally:
        mp.undo()
    assert rc == 0
    return out


def test_yeast_copies_agree(reduced, tmp_path):
    """(a) chip_smoke.py's copy writes the script's bytes, and the shape is
    yeast's at 2%: 8 genomes x 16 chromosomes in PanSN names."""
    got = chip_smoke._golden_yeast_pangenome(str(tmp_path), **REDUCED)
    assert got == ["pan.fa", "pan.fa.fai"]
    for name in got:
        assert (open(os.path.join(reduced, name), "rb").read()
                == open(tmp_path / name, "rb").read()), name
    names = [ln.split("\t")[0] for ln in open(tmp_path / "pan.fa.fai")]
    assert names == [f"g{h}#1#chr{c}" for h in range(8) for c in range(1, 17)]
    total = sum(int(ln.split("\t")[1]) for ln in open(tmp_path / "pan.fa.fai"))
    assert abs(total - 8 * 0.02 * 12_071_000) < 0.01 * total


@pytest.mark.slow
@pytest.mark.parametrize("source", ["script", "chip_smoke"])
@pytest.mark.parametrize("case", ["B1", "Y1"])
def test_full_inputs_regenerate(case, source, tmp_path):
    """(a) at full size the inputs hash as the manifest records (B1's are
    B0's, Y1's Y2's; chip_smoke.py's scale phase checks the same)."""
    e = MANIFEST["cases"][case]
    if source == "script":
        got = torch_golden.make_inputs(case, str(tmp_path))
    else:
        got = chip_smoke.golden_inputs(e, str(tmp_path))
    assert got == e["inputs"]


@pytest.mark.parametrize("route", ["0", "1"])
def test_port_matches_reference_on_reduced_yeast(reduced, reference_y,
                                                 route, monkeypatch):
    """(b) the port's CLI on the CPU, on its host mapping stages (0) and
    on its device stages over CPU tensors (1), writes the reference's
    bytes."""
    from wfmash_tpu_torch import cli
    from wfmash_tpu_torch.utils import perf

    perf.reset()
    rc, out, _ = _cli(cli.main, Y_MAP, reduced,
                      {"WFMASH_TPU_TORCH_DEVICE": "cpu",
                       "WFMASH_TPU_DEVICE_L1": route}, monkeypatch)
    assert rc == 0
    assert (perf.get("map.device_calls") > 0) == (route == "1")
    assert out.count(b"\n") > 300
    assert out == reference_y


def test_row_digests_name_the_first_differing_row():
    """(c) both copies of the digests agree; a doctored output's first
    differing row is named, whether its coordinates or its tags differ."""
    out = torch_golden.read_output(MANIFEST["cases"]["A0"])
    digests = torch_golden.row_digests(out)
    assert digests == chip_smoke.golden_row_digests(out)
    assert digests.count(b"\n") == out.count(b"\n")
    assert chip_smoke.first_difference(
        chip_smoke.golden_row_digests(out), digests) is None
    rows = out.splitlines(keepends=True)
    for row, col in ((57, 3), (100, 13)):
        f = rows[row].split(b"\t")
        f[col] = f[col][:-1] + (b"0" if f[col][-1:] != b"0" else b"1")
        doctored = b"".join(rows[:row] + [b"\t".join(f)] + rows[row + 1:])
        assert hashlib.sha256(doctored).hexdigest() != hashlib.sha256(
            out).hexdigest()
        line, port, ref = chip_smoke.first_difference(
            chip_smoke.golden_row_digests(doctored), digests)
        assert line == row + 1
        assert (port.split(b"\t")[:12] == ref.split(b"\t")[:12]) == (col > 11)


def test_case_inputs_beside_the_golden_phase(tmp_path, monkeypatch):
    """(d) the scale phase makes its inputs in directories of its own
    beside the golden phase's, in the one temporary directory of a run
    (a whole chip_smoke.py run once stopped after B1: both phases
    numbered directories golden<n> from 0), each case's argv names them, and
    inputs that hash otherwise than the manifest records stop the case
    as input drift."""
    e = dict(generator="yeast_pangenome", args=REDUCED, argv=Y_MAP)
    os.makedirs(tmp_path / "hashes")
    e["inputs"] = chip_smoke.golden_inputs(e, str(tmp_path / "hashes"))
    assert sorted(e["inputs"]) == ["pan.fa", "pan.fa.fai"]
    run = tmp_path / "run"
    os.makedirs(run)
    argv = {prefix: chip_smoke.golden_case_argv(str(run), "Y1", e, {},
                                                *extra)
            for prefix, extra in (("golden", ()), ("scale", ("scale",)))}
    assert argv["golden"][0] == str(run / "golden0" / "pan.fa")
    assert argv["scale"][0] == str(run / "scale0" / "pan.fa")
    assert argv["golden"][1:] == argv["scale"][1:] == Y_MAP[1:]
    made = {}
    chip_smoke.golden_case_argv(str(run), "Y1", e, made, "twice")
    chip_smoke.golden_case_argv(str(run), "Y2", e, made, "twice")
    assert sorted(os.listdir(run)) == ["golden0", "scale0", "twice0"]
    drift = dict(e, inputs=dict(e["inputs"], **{"pan.fa": "0" * 64}))
    with pytest.raises(RuntimeError, match=r"input drift: \['pan.fa'\]"):
        chip_smoke.golden_case_argv(str(run), "Y1", drift, {}, "drift")

    # the directories' names each phase asks for: stopped at its first
    class Asked(Exception):
        pass

    def ask(tmp, case, e, made, prefix="golden"):
        raise Asked(prefix)

    monkeypatch.setattr(chip_smoke, "golden_case_argv", ask)
    asked = []
    for phase in (chip_smoke.golden_phase, chip_smoke.scale_phase):
        with pytest.raises(Asked) as got:
            phase(str(tmp_path))
        asked.append(got.value.args[0])
    assert asked == ["golden", "scale"]


def test_scale_entries():
    """(d) every case of the scale phase is in the manifest with the
    script's generator, arguments, argv and inputs, and the wall the
    reference took."""
    cases = MANIFEST["cases"]
    assert set(torch_golden.SCALE) <= set(cases)
    assert set(chip_smoke.SCALE_CASES) == set(torch_golden.SCALE)
    assert chip_smoke.GOLDEN_DIGESTS == torch_golden.DIGESTS
    for case in torch_golden.SCALE:
        e = cases[case]
        gen, args, argv, env = torch_golden.CASES[case]
        assert (e["generator"], e["args"], e["argv"]) == (gen, args, argv)
        assert e["env"] == {**torch_golden.ENV, **env}
        assert e["wall_s"] > 0 and e["rows"] > 0
        names = {"scale_pair": ["anc.fa.gz", "anc.fa.gz.fai", "der.fa.gz",
                                "der.fa.gz.fai"],
                 "yeast_pangenome": ["pan.fa", "pan.fa.fai"]}[gen]
        assert sorted(e["inputs"]) == names
        assert all(len(h) == 64 for h in e["inputs"].values())
    assert cases["B0"]["inputs"] == cases["B1"]["inputs"]
    assert cases["Y1"]["inputs"] == cases["Y2"]["inputs"]
    assert cases["B1"]["args"] == {"bp": 100_000_000, "seed": 42}
    # Y2 reaches every tier, as the port must on the card
    assert all(cases["Y2"]["reach"][t] for t in ("t3", "t4", "t5"))


def test_replay_and_coverage_gates(tmp_path):
    """(d) chip_smoke.py's row replay holds a CIGAR to its row's spans
    (pafcheck's rule) and its matches; per-sequence coverage leaves out
    the sequences `-L` gives no target and merges overlapping rows."""
    t = b"ACGTACGTAAACCCGGGTTT"
    q = b"ACGTTCGTAAACCCGGG"
    (tmp_path / "s.fa").write_bytes(b">t\n" + t + b"\n>q\n" + q + b"\n")
    (tmp_path / "s.fa.fai").write_text(
        f"t\t{len(t)}\t3\t{len(t)}\t{len(t) + 1}\n"
        f"q\t{len(q)}\t{len(t) + 7}\t{len(q)}\t{len(q) + 1}\n")
    seqs = chip_smoke._Seqs([str(tmp_path / "s.fa")])

    def row(qe, te, cigar):
        return (f"q\t{len(q)}\t0\t{qe}\t+\tt\t{len(t)}\t0\t{te}\t0\t0\t60\t"
                f"cg:Z:{cigar}\n")

    assert chip_smoke.replay_row(row(17, 17, "4=1X12="), seqs) == (True, 17)
    assert chip_smoke.replay_row(row(17, 17, "17="), seqs)[0] is False
    assert chip_smoke.replay_row(row(17, 18, "4=1X12="), seqs)[0] is False
    assert chip_smoke.replay_row(row(17, 20, "4=1X12=3D"), seqs) == (True, 17)
    fai = tmp_path / "p.fa.fai"
    fai.write_text("a#1#c1\t100\t0\t60\t61\nb#1#c1\t100\t0\t60\t61\n"
                   "b#1#c2\t50\t0\t60\t61\n")
    paf = (b"b#1#c1\t100\t0\t60\t+\ta#1#c1\t100\t0\t60\n"
           b"b#1#c1\t100\t40\t90\t+\ta#1#c1\t100\t40\t90\n")
    assert chip_smoke.seq_coverage(paf, str(fai)) == {"b#1#c1": 0.9,
                                                      "b#1#c2": 0.0}



def test_identity_sketch_in_blocks(monkeypatch):
    """The identity estimate's sequence sketch, taken a block of k-mers at
    a time (a 100 Mb sequence's whole hash arrays peaked at +3.1 GB of
    RSS on the card's host), is the reference's bottom multiset at every
    block size, Ns and sequences shorter than k among the inputs."""
    import numpy as np

    from wfmash_tpu.map import ani as ref_ani
    from wfmash_tpu_torch.map import ani

    rng = np.random.default_rng(5)
    for n in (0, 20, 21, 22, 3000, 50_000):
        seq = np.frombuffer(b"ACGTN", np.uint8)[rng.choice(
            5, n, p=[0.24, 0.24, 0.24, 0.24, 0.04])].tobytes()
        want = np.sort(ref_ani._sequence_sketch(seq, 21, 512))
        for block in (1, 7, 1000, 1 << 22):
            monkeypatch.setattr(ani, "SKETCH_BLOCK", block)
            assert np.array_equal(ani._sequence_sketch(seq, 21, 512),
                                  want), (n, block)


def test_native_scan_equals_reference_across_blocks():
    """The port's native minmer scan, which now hashes k-mers a block of
    2^20 at a time and keeps its backlog in 16-byte items on a deque,
    writes the reference's records: across block boundaries, with Ns,
    repeats (equal hashes in the backlog) and both strands."""
    import numpy as np

    from wfmash_tpu.native import canonical_hashes_native as ref_hashes
    from wfmash_tpu.native import winnow_minmers_native as ref_scan
    from wfmash_tpu_torch.native import canonical_hashes_native, \
        winnow_minmers_native

    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, 2_300_000).astype(np.uint8)
    unit = codes[:2000].copy()
    for at in rng.integers(0, len(codes) - 2000, 40):
        codes[at:at + 2000] = unit if at % 2 else 3 - unit[::-1]
    seq = bytearray(np.frombuffer(b"ACGT", np.uint8)[codes].tobytes())
    for at in (5, (1 << 20) - 10, (1 << 20) + 3, 2_000_000):
        seq[at:at + 30] = b"N" * 30
    seq = bytes(seq)
    for k, w, s in ((19, 1000, 24), (15, 300, 8)):
        got, want = winnow_minmers_native(seq, k, w, s, seq_id=2), \
            ref_scan(seq, k, w, s, seq_id=2)
        assert len(got) > 1000 and got.tobytes() == want.tobytes()
    for a, b in zip(canonical_hashes_native(seq, 21), ref_hashes(seq, 21)):
        assert np.array_equal(a, b)


_PEAK = """
import importlib, sys
import numpy as np
sys.path.insert(0, {repo!r})
def hwm():
    for ln in open("/proc/self/status"):
        if ln.startswith("VmHWM"):
            return int(ln.split()[1]) * 1024
native = importlib.import_module(sys.argv[1] + ".native")
ani = importlib.import_module(sys.argv[1] + ".map.ani")
native.get_lib()
bp = int(sys.argv[2])
seq = np.frombuffer(b"ACGT", np.uint8)[
    np.random.default_rng(1).integers(0, 4, bp)].tobytes()
base = hwm()
native.winnow_minmers_native(seq, 19, 1000, 24, seq_id=3)
scan = hwm() - base
ani._sequence_sketch(seq, 21, 4096)
print(scan / bp, (hwm() - base) / bp)
"""


def test_host_memory_per_base():
    """The fault B0 showed on the card: 9.35 GB of peak RSS against
    scale_demo's 8 GB, of which the index's minmer scan took +4.5 GB and
    the identity sketch +3.1 GB at 100 Mb (torch's import alone is
    4.65 GB there). In a fresh process on 8 Mb the port's scan and
    sketch now peak below 16 bytes a base over the start (the reference's
    scan: over 30); both outputs are held to the reference's above."""
    import subprocess
    import sys

    code = _PEAK.format(repo=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    per_base = {}
    for pkg in ("wfmash_tpu_torch", "wfmash_tpu"):
        r = subprocess.run([sys.executable, "-c", code, pkg, "8000000"],
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        per_base[pkg] = [float(x) for x in r.stdout.split()]
    port, ref = per_base["wfmash_tpu_torch"], per_base["wfmash_tpu"]
    assert port[0] < 16 and port[1] < 16, per_base
    assert ref[0] > 2 * port[0], per_base
