"""Whole runs of a cell at a small size on the CPU (the look for a card
skipped, the port's CPU paths underneath), with the cell's own limits:
a sound run is correct, the control is not, and neither is a run with
the timed path broken in each way the cell can break: records left out,
an answer altered where it is produced, a job that returns without
doing its work. (One card: there is no exchange between cards to leave
out.)"""

import io
import json
import os
import time

import pytest
import torch

from benchlib.cell import ROOT, load_json, run_cell

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("WFMASH_TPU_TORCH_DEVICE", "cpu")


def _run(tmp_path, cell, config, control=False):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    with open(os.path.join(DATA, f"{config}.json")) as fh:
        cfg = json.load(fh)
    w = next(w for w in bench["workloads"] if w["name"] == cell)
    traffic = dict(load_json("traffic", f"{w['traffic']}.json"), sample=6)
    res = run_cell(bench, cell, 2 ** 31 + 99, 1.0, False,
                   torch.device("cpu"), time.monotonic(), control=control,
                   work_root=str(tmp_path), config=cfg, traffic=traffic)
    return res, {c["name"]: c for c in res["checks"]}


def _fails(checks, name):
    return checks[name]["value"] > checks[name]["limit"]


def test_align_sound_run_is_correct(tmp_path):
    res, checks = _run(tmp_path, "yeast8.align", "yeast8_tiny")
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_pair_sound_run_passes_the_mappings_identity_on(tmp_path):
    res, checks = _run(tmp_path, "pair100m.align", "pair_tiny")
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_align_control_is_not_correct(tmp_path):
    res, checks = _run(tmp_path, "yeast8.align", "yeast8_tiny", control=True)
    assert not res["correct"] and _fails(checks, "score_excess")


def test_align_half_the_records_left_out(tmp_path, monkeypatch):
    from wfmash_tpu_torch.align import engine

    real = engine.align_records_batched

    def half(chunk, *a, **kw):
        ops = real(chunk, *a, **kw)
        return [o if i % 2 else None for i, o in enumerate(ops)]

    monkeypatch.setattr(engine, "align_records_batched", half)
    res, checks = _run(tmp_path, "yeast8.align", "yeast8_tiny")
    assert not res["correct"] and _fails(checks, "uncovered_share")


def test_align_answer_altered(tmp_path, monkeypatch):
    from wfmash_tpu_torch.align import engine

    real = engine.write_paf_row

    def altered(out, job, ops, *a, **kw):
        ops = list(ops)
        k = next(i for i, (n, op) in enumerate(ops) if op == "=" and n > 1)
        ops[k:k + 1] = [(ops[k][0] - 1, "="), (1, "X")]
        return real(out, job, ops, *a, **kw)

    monkeypatch.setattr(engine, "write_paf_row", altered)
    res, checks = _run(tmp_path, "yeast8.align", "yeast8_tiny")
    assert not res["correct"] and _fails(checks, "bad_records")


def test_align_job_that_does_nothing(tmp_path, monkeypatch):
    from wfmash_tpu_torch.align import engine

    monkeypatch.setattr(engine, "run_alignment", lambda *a, **kw: None)
    res, checks = _run(tmp_path, "yeast8.align", "yeast8_tiny")
    assert not res["correct"] and _fails(checks, "uncovered_share")


def _mapping_through(monkeypatch, edit):
    """runner.run_mapping with its output passed through edit(lines)."""
    from wfmash_tpu_torch import runner

    real = runner.run_mapping

    def run_mapping(params, out, *a, **kw):
        buf = io.StringIO()
        real(params, buf, *a, **kw)
        out.writelines(edit(buf.getvalue().splitlines(keepends=True)))

    monkeypatch.setattr(runner, "run_mapping", run_mapping)


def test_map_sound_run(tmp_path):
    res, checks = _run(tmp_path, "yeast8.map", "yeast8_small")
    assert res["failed"] == 0
    assert not _fails(checks, "bad_records")
    assert not _fails(checks, "identity_gap")
    assert not _fails(checks, "uncovered_share")


def test_map_control_is_not_correct(tmp_path):
    res, checks = _run(tmp_path, "yeast8.map", "yeast8_small", control=True)
    assert not res["correct"] and _fails(checks, "uncovered_share")


def test_map_half_the_records_left_out(tmp_path, monkeypatch):
    _mapping_through(monkeypatch, lambda lines: lines[::2])
    res, checks = _run(tmp_path, "yeast8.map", "yeast8_small")
    assert not res["correct"] and _fails(checks, "uncovered_share")


def test_map_answer_altered(tmp_path, monkeypatch):
    def shift(lines):
        out = []
        for line in lines:
            f = line.split("\t")
            f[7] = str(int(f[7]) // 2)
            f[8] = str(int(f[7]) + int(f[3]) - int(f[2]))
            out.append("\t".join(f))
        return out

    _mapping_through(monkeypatch, shift)
    res, checks = _run(tmp_path, "yeast8.map", "yeast8_small")
    assert not res["correct"] and _fails(checks, "identity_gap")


def test_map_job_that_does_nothing(tmp_path, monkeypatch):
    _mapping_through(monkeypatch, lambda lines: [])
    res, checks = _run(tmp_path, "yeast8.map", "yeast8_small")
    assert not res["correct"] and _fails(checks, "uncovered_share")
