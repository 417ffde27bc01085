"""The port's device mapping stages held to the reference's golden bytes
under every mapping mode of tests/torch_golden/ (M2-M7: all-vs-all, -o,
-L -n 7, -M, -x, -N -j 0 on the 8-haplotype PanSN input).

The port's CLI runs on the CPU with WFMASH_TPU_DEVICE_L1=1: DeviceL1 and
DeviceL2 as torch programs on CPU tensors, the rows they leave going to
the host stages row by row. The same cases on the host stages, M1 on both
routes and the rest of the golden checks are in test_torch_golden.py; the
card runs every case in chip_smoke.py's `golden` phase.
"""

from __future__ import annotations

import pytest

from test_torch_golden import CASES, MAPPING, made, port_run  # noqa: F401

import torch_golden


@pytest.mark.parametrize("case", [c for c in MAPPING if c != "M1"])
def test_port_device_route_reproduces_mapping(made, case,  # noqa: F811
                                              monkeypatch):
    out, snap, wall = port_run(made, case, monkeypatch,
                               WFMASH_TPU_DEVICE_L1="1")
    print(f"[{case}] port CLI, device stages on CPU tensors: {wall:.2f} s, "
          f"rows left to the host: L1 {snap.get('map.l1_host_rows')}, "
          f"L2 {snap.get('map.l2_host_rows')}")
    assert snap.get("map.device_calls", 0) > 0
    assert snap.get("map.l2_device_calls", 0) > 0
    assert out == torch_golden.read_output(CASES[case])
