"""Faults in the align loop: which ones skip a record and which end the run.

A record whose extraction raises (`build_job`, the host-side read of the
FASTA) is logged and skipped by both packages, whatever the exception
(reference: `except Exception` around `build_job` in
wfmash_tpu/align/engine.py::run_alignment). An error of the port's engine
still ends its run: the port does not retry record by record.
"""

from __future__ import annotations

import io

import numpy as np
import pytest

from util import mutate, random_dna, write_fasta


def _inputs(tmp_path):
    """Target, query and the reference's mapping PAF of three queries."""
    from wfmash_tpu.params import MapParams
    from wfmash_tpu.runner import run_mapping

    rng = np.random.default_rng(21)
    t = random_dna(rng, 30_000)
    write_fasta(tmp_path / "t.fa", {"t1": t})
    write_fasta(tmp_path / "q.fa", {
        f"q{i}": mutate(rng, t[i * 9_000:i * 9_000 + 8_000], 0.01)
        for i in range(3)})
    mp = MapParams(ref_sequences=[str(tmp_path / "t.fa")],
                   query_sequences=[str(tmp_path / "q.fa")],
                   percentage_identity=0.9, auto_pct_identity=False,
                   scaffold_gap=0).finalize()
    buf = io.StringIO()
    run_mapping(mp, buf)
    assert len(buf.getvalue().splitlines()) >= 3
    (tmp_path / "m.paf").write_text(buf.getvalue())
    return mp.window_length


def _align(pkg, tmp_path, window, monkeypatch, fail_at=None):
    """run_alignment of `pkg` on the mapping PAF, its build_job raising a
    RuntimeError on call number `fail_at`; (output, stderr of the run)."""
    import importlib

    engine = importlib.import_module(f"{pkg}.align.engine")
    params = importlib.import_module(f"{pkg}.params")
    real = engine.build_job
    calls = [0]

    def failing(*a, **kw):
        calls[0] += 1
        if calls[0] == fail_at:
            raise RuntimeError("unreadable record (test)")
        return real(*a, **kw)

    monkeypatch.setattr(engine, "build_job", failing)
    ap = params.AlignParams(
        ref_sequences=[str(tmp_path / "t.fa")],
        query_sequences=[str(tmp_path / "q.fa")],
        mashmap_paf_file=str(tmp_path / "m.paf"),
        target_padding=100, query_padding=100).finalize(window)
    out = io.StringIO()
    if pkg == "wfmash_tpu":
        engine.run_alignment(ap, out)
    else:
        import torch

        engine.run_alignment(ap, out, torch.device("cpu"))
    return out.getvalue()


def test_extraction_error_skips_the_record(tmp_path, monkeypatch, capsys):
    """Both packages log the second record's extraction error, skip that
    record and write the others: the same bytes."""
    monkeypatch.delenv("WFMASH_TPU_SEGMENTED", raising=False)
    monkeypatch.setenv("WFMASH_TPU_TORCH_DEVICE", "cpu")
    window = _inputs(tmp_path)
    capsys.readouterr()
    outs, errs = [], []
    for pkg in ("wfmash_tpu", "wfmash_tpu_torch"):
        outs.append(_align(pkg, tmp_path, window, monkeypatch, fail_at=2))
        errs.append(capsys.readouterr().err)
    full = _align("wfmash_tpu_torch", tmp_path, window, monkeypatch)
    assert outs[0] == outs[1]
    rows, all_rows = outs[1].splitlines(), full.splitlines()
    assert len(rows) == len(all_rows) - 1 >= 2
    assert rows == all_rows[:1] + all_rows[2:]
    line = ("[wfmash::align] Error extracting record: unreadable record "
            "(test)")
    assert line in errs[0] and line in errs[1]


def test_engine_error_ends_the_run(tmp_path, monkeypatch):
    """A RuntimeError from the port's engine propagates out of
    run_alignment: no row is dropped while the run goes on."""
    import torch

    from wfmash_tpu_torch.align import engine
    from wfmash_tpu_torch.params import AlignParams

    monkeypatch.setenv("WFMASH_TPU_TORCH_DEVICE", "cpu")
    window = _inputs(tmp_path)

    def broken(*a, **kw):
        raise RuntimeError("kernel fault (test)")

    monkeypatch.setattr(engine, "align_records_batched", broken)
    ap = AlignParams(ref_sequences=[str(tmp_path / "t.fa")],
                     query_sequences=[str(tmp_path / "q.fa")],
                     mashmap_paf_file=str(tmp_path / "m.paf"),
                     target_padding=100, query_padding=100).finalize(window)
    with pytest.raises(RuntimeError, match="kernel fault"):
        engine.run_alignment(ap, io.StringIO(), torch.device("cpu"))
