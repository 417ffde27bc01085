"""A forward step and a multi-device dry run of the port: the counterpart
of __graft_entry__.py.

* `entry()` returns a function that runs 16 levels of the batched
  gap-affine-2p wavefront advance (`advance_torch`) and example tensors
  at __graft_entry__.entry()'s shapes, on the port's device.
* `dryrun_multichip(n)` runs the sharded paths over an n-device mesh on
  small inputs: ShardedDeviceL1 on a tiny index, the segment tiers with
  each chunk split over the devices (every CIGAR must equal wfa_np's),
  and one problem's diagonals split over the devices; it prints the
  reference's two `[wfmash-tpu] multichip ...` lines.

`python -m wfmash_tpu_torch.parallel.dryrun` runs `entry()`, then
`dryrun_multichip(8)` over eight logical shards of the port's device
(device.py: `WFMASH_TPU_TORCH_DEVICE`, default cuda).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as device_mod
from ..align.wfa_np import Penalties
from ..align.wfa_sweep import NEG_I, advance_torch, ring_size
from .mesh import Mesh, make_mesh, mesh_devices

LEVELS = 16          # levels entry()'s function runs


def entry(device=None):
    """(fn, example_args): fn(*example_args) runs levels 1..16 of
    advance_torch on a batch of 8 problems of 512 bytes a side over
    K = 257 lanes under wfmash's patching penalties and returns the
    offsets ring (8, R, 5, 257)."""
    dev = device_mod.resolve(device)
    p = Penalties(5, 8, 2, 24, 1)  # wfmash's patching penalties
    R = ring_size(p)
    B, K, L = 8, 257, 512

    rng = np.random.default_rng(0)
    q = rng.integers(65, 69, (B, L), dtype=np.uint8)
    t = q.copy()
    t[:, ::13] = 65
    off = np.full((B, R, 5, K), NEG_I, np.int32)
    off[:, 0, 0, K // 2] = 0
    tlen = torch.full((B,), L - 16, dtype=torch.int32, device=dev)

    def fn(off, anc_v, anc_h, open_a, query, target, qlen, tlen, axis_q,
           mid):
        for s in range(1, LEVELS + 1):
            off, anc_v, anc_h, open_a = advance_torch(
                off, anc_v, anc_h, open_a, s, query, target, qlen, tlen,
                axis_q, mid, K, R, p)[:4]
        return off

    anc = torch.full((B, R, 5, K), -1, dtype=torch.int32, device=dev)
    example_args = (
        torch.from_numpy(off).to(dev), anc, anc,
        torch.full((B, R, 4, K), -1, dtype=torch.int32, device=dev),
        torch.from_numpy(q).to(dev), torch.from_numpy(t).to(dev),
        tlen.clone(), tlen, torch.zeros(B, dtype=torch.bool, device=dev),
        tlen // 2)
    return fn, example_args


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the sharded paths over an n-device mesh (`devices`: a list of
    at least n torch devices, repeats allowed; default `mesh_devices()`):

    1. the mapping L1 over a (shard, data) mesh, ShardedDeviceL1 on a
       tiny real index;
    2. the align step: the segment tiers with every chunk split over the
       n devices, solving end-to-end and ends-free jobs to CIGARs equal
       to wfa_np's;
    3. one problem's diagonals split over the n devices.

    Prints two lines and returns their numbers."""
    from ..align.wfa_np import EndsFree, wfa_align
    from ..align.wfa_seg import TieredSegmentSolver
    from ..index.build import build_index
    from ..map.stats import compute_sketch_cutoffs
    from ..params import MapParams
    from ..sketch.minhash import sketch_fragment
    from .mesh import ShardedDeviceL1, diagonal_sharded_wfa_steps

    devices = list(devices) if devices is not None else mesh_devices()
    if len(devices) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")
    devices = devices[:n_devices]
    # factor n into (shard, data): a 2-D mesh where n allows one
    n_shard = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_data = n_devices // n_shard
    mesh = make_mesh(n_shard, n_data, devices)

    # -- sharded L1 on a real (tiny) index -------------------------------
    mp = MapParams(percentage_identity=0.85, auto_pct_identity=False,
                   window_length=400, kmer_size=15)
    mp.ref_sequences = mp.query_sequences = ["dryrun"]
    mp = mp.finalize()
    rng = np.random.default_rng(3)
    lut = np.frombuffer(b"ACGT", np.uint8)
    base = lut[rng.integers(0, 4, 6000)].tobytes()
    index = build_index(mp, [(0, base), (1, base[1000:5000])],
                        log=lambda m: None)
    cutoffs = compute_sketch_cutoffs(mp.sketch_size, mp.kmer_size, 0.0,
                                     0.999)
    l1 = ShardedDeviceL1(index, np.array([0, 1], np.int32), mp, cutoffs,
                         mesh, cap=1024, maxc=16)
    frags = []
    for i in range(2 * n_data):
        sk = sketch_fragment(base[i * 317:i * 317 + 400], mp.kmer_size,
                             mp.sketch_size)
        frags.append(dict(hashes=sk.hashes, n=sk.sketch_size, q_len=400,
                          q_seqid=99, q_group=99, min_hits=2))
    n_cand = sum(len(c) for c in l1.candidates(frags) if c)
    if n_cand == 0:
        raise RuntimeError("sharded L1 found no candidates")
    epc = l1.shard_ep_counts
    l1_balance = (min(epc) / max(epc)) if max(epc) else 1.0

    # -- the sharded align step ------------------------------------------
    p = Penalties(5, 8, 2, 24, 1)
    amesh = Mesh(devices, ("data",))
    solver = TieredSegmentSolver(p, devices[0], mesh=amesh)
    jobs = []
    for i in range(2 * n_devices):
        t = base[i * 101:i * 101 + 180]
        q = bytearray(t)
        q[40] = ord("A") if q[40] != ord("A") else ord("C")
        jobs.append((bytes(q), t, None))
    # one ends-free boundary-patch job exercises the free-span seeding
    jobs.append((base[:90], base[10:100],
                 EndsFree(target_begin=90, query_begin=90)))
    got = solver.solve(jobs)
    n_solved = sum(1 for o in got if o is not None)
    for (q, t, ef), ops in zip(jobs, got):
        if ops is not None and ops != wfa_align(q, t, p, ef)[1]:
            raise RuntimeError("sharded align: CIGAR differs from wfa_np's")
    if n_solved < 2 * n_devices:
        raise RuntimeError(f"sharded align solved {n_solved} of "
                           f"{len(jobs)} jobs")
    # per-device align work: the swept levels of the tier-1 chunk's job
    # rows in each device's row range (a device whose range holds no job
    # was not launched)
    t1 = solver.tiers[0]
    per = t1.max_call // n_devices
    lv = t1.last_row_levels
    align_dev_levels = [int(lv[d * per:(d + 1) * per].sum())
                        for d in range(n_devices)]
    busy = [x for x in align_dev_levels if x > 0]
    align_balance = (min(busy) / max(busy)) if busy else 0.0

    # -- one problem's diagonals over the devices --------------------------
    R = ring_size(p)
    K = 32 * n_devices
    L = 400
    qarr = np.frombuffer(base[:L], np.uint8)[None, :].copy()
    tarr = qarr.copy()
    tarr[:, ::17] = ord("A")
    dev0 = devices[0]
    off = np.full((1, R, 5, K), NEG_I, np.int32)
    off[:, 0, 0, K // 2] = 0
    anc = torch.full((1, R, 5, K), -1, dtype=torch.int32, device=dev0)
    lens = torch.full((1,), L - 8, dtype=torch.int32, device=dev0)
    got_off = diagonal_sharded_wfa_steps(
        torch.from_numpy(off).to(dev0), anc, anc,
        torch.full((1, R, 4, K), -1, dtype=torch.int32, device=dev0),
        torch.from_numpy(qarr).to(dev0), torch.from_numpy(tarr).to(dev0),
        lens, lens, torch.zeros(1, dtype=torch.bool, device=dev0),
        lens // 2, amesh, 24, p)[0]
    lanes_live = (got_off[:, 24 % R, 0, :] > NEG_I).cpu().numpy()  # (1, K)
    n_live = int(lanes_live.sum())
    if n_live == 0:
        raise RuntimeError("diagonal-sharded wavefront advanced no lanes")
    lane_per = K // n_devices
    wf_dev_lanes = [int(lanes_live[0, d * lane_per:(d + 1) * lane_per]
                        .sum()) for d in range(n_devices)]
    print(f"[wfmash-tpu] multichip dryrun OK on mesh (shard={n_shard}, "
          f"data={n_data}): production L1 candidates={n_cand}, "
          f"sharded align solved {n_solved}/{len(jobs)} (bit-identical), "
          f"diagonal-sharded wavefront live lanes={n_live}", flush=True)
    print(f"[wfmash-tpu] multichip balance: L1 per-shard endpoints={epc} "
          f"(min/max {l1_balance:.3f}); align per-device swept levels="
          f"{align_dev_levels} (busy-device min/max {align_balance:.3f}; "
          f"tiny dryrun fills only the first devices' rows — production "
          f"chunks fill all); wavefront per-device live lanes="
          f"{wf_dev_lanes}", flush=True)
    return dict(n_shard=n_shard, n_data=n_data, n_cand=n_cand,
                n_solved=n_solved, n_jobs=len(jobs), n_live=n_live,
                shard_ep_counts=epc, align_dev_levels=align_dev_levels,
                wf_dev_lanes=wf_dev_lanes)


if __name__ == "__main__":
    dev = device_mod.resolve()
    fn, args = entry(dev)
    out = fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"[wfmash-tpu] entry() ran on {dev}: {tuple(out.shape)}",
          flush=True)
    dryrun_multichip(8, [dev] * 8)
