"""Several devices for mapping and alignment: the counterpart of
wfmash_tpu/parallel/mesh.py, with its functions under the same names.

The reference drives a `jax.sharding.Mesh` from one Python process with
`shard_map`. The port keeps the single controller. A `Mesh` here is an
array of `torch.device`s with named axes, ("shard", "data") or one axis
such as the align mesh's ("data",). Each shard's tensors live on its
device, and the collectives are copies that this process makes:

* all_gather: a `torch.cat` of `.to(dev)` copies, in the reference's
  order;
* psum / pmax: the shards' results brought to one device and summed or
  maxed;
* ppermute of a halo lane: a one-column `.to(neighbour)`.

No `torch.distributed`: it needs a process a rank, and NCCL refuses two
ranks on one GPU, so a one-card machine could never run a sharded path
at more than one shard. A device may repeat in the list. Eight logical
shards on one card (chip_smoke.py) or on the CPU (the tests) run every
split, copy and merge of the sharded code, as the eight virtual devices
that `--xla_force_host_platform_device_count=8` gives the reference's
tests. A CLI run gets such a list when `mesh_devices` is replaced
in-process. On a repeated device a copy is no copy: every function here
leaves its inputs unwritten and builds new tensors, so no shard writes
what another reads.

The axes:

* "shard": the target minmer index split into hash ranges
  (ShardedDeviceL1, sharded_hit_counts); each shard joins the fragments
  against its own range;
* "data": fragments and WFA problems split into contiguous row ranges
  (ShardedDeviceL1's sweep, data_parallel_wfa_steps; align/wfa_seg.py
  splits the segment kernel's chunks over the first axis of its mesh);
* the last axis also splits ONE problem's diagonals
  (diagonal_sharded_wfa_steps), with one halo lane a side a level.
"""

from __future__ import annotations


import numpy as np
import torch

from .. import device as device_mod
from ..align.wfa_sweep import NEG_I, advance_torch, ring_size
from ..map.l1_device import (_join_endpoints, _order_key, _sweep_candidates,
                             answer_rows, pack_fragments)


class Mesh:
    """An array of torch devices with named axes: `devices`, `axis_names`
    and `shape` (axis name -> size) as jax.sharding.Mesh has them."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names) or arr.size == 0:
            raise ValueError(f"devices of shape {arr.shape} for axes "
                             f"{self.axis_names}")
        self.devices = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(*arr.shape):
            self.devices[idx] = torch.device(arr[idx])

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list:
        """The devices along `axis`, at index 0 of every other axis."""
        idx = [0] * self.devices.ndim
        idx[self.axis_names.index(axis)] = slice(None)
        return list(self.devices[tuple(idx)])


def mesh_devices(device=None) -> list:
    """The devices a mesh takes when none are given: every card of the
    machine for a CUDA device, the one CPU device for the CPU (`device`:
    device.py's). Tests and chip_smoke.py replace this function in-process
    to run the CLI over logical shards."""
    dev = device_mod.resolve(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_mesh(n_shard: int, n_data: int, devices=None) -> Mesh:
    devices = list(devices) if devices is not None else mesh_devices()
    if len(devices) < n_shard * n_data:
        raise ValueError(f"a ({n_shard}, {n_data}) mesh needs "
                         f"{n_shard * n_data} devices, got {len(devices)}")
    devs = devices[:n_shard * n_data]
    return Mesh([devs[i * n_data:(i + 1) * n_data] for i in range(n_shard)],
                ("shard", "data"))


def _ranges(n_rows: int, n: int):
    """Contiguous row ranges (i, a, b) of n_rows split n ways, the empty
    ones left out."""
    return [(i, n_rows * i // n, n_rows * (i + 1) // n) for i in range(n)
            if n_rows * (i + 1) // n > n_rows * i // n]


class ShardedDeviceL1:
    """The L1 stage with the index split into hash ranges over the mesh's
    "shard" axis and fragments split over "data". Each shard joins a data
    slot's fragments against its range on its own device with a cap of
    cap // n_shard endpoints; the shards' event arrays then come together
    on the slot's first device in shard order (the reference's
    all_gather), the overflow flag is their maximum, and the slot sweeps
    its fragments. Candidates, and the rows left to the host (None), are
    those of the reference's ShardedDeviceL1 row for row: the sort before
    the sweep is keyed on all four event arrays, so the order in which
    events arrive does not show in its result.

    The ranges are balanced by endpoint count as the reference's are
    (`shard_ep_counts` keeps each range's count). They are not padded to
    a common size: eager torch needs no common shape, and the reference's
    padding keys have no endpoints."""

    BATCH = 256     # fragments a data slot takes per chunk (DeviceL1's)

    def __init__(self, index, group_arr, params, sketch_cutoffs,
                 mesh: Mesh, cap: int = 4096, maxc: int = 64):
        self.mesh = mesh
        self.n_shard = mesh.shape["shard"]
        self.n_data = mesh.shape["data"]
        self.cap = cap
        self.maxc = maxc
        self.params = params
        uh = _order_key(np.asarray(index.unique_hashes))
        offs = np.asarray(index.endpoint_offsets, np.int64)
        ep = index.endpoints
        U, E = len(uh), len(ep)
        bounds = [0]
        for s in range(1, self.n_shard):
            bounds.append(int(np.searchsorted(offs, E * s // self.n_shard)))
        bounds.append(U)
        self.bounds = bounds      # shard s holds unique hashes [b_s, b_s+1)
        self.shard_ep_counts = [
            int(offs[bounds[i + 1]] - offs[bounds[i]])
            for i in range(self.n_shard)]
        # each range is uploaded once to every distinct device of its
        # shard row; the read-only tables a slot's sweep needs, once to
        # every distinct device
        self._index: dict = {}
        self._tables: dict = {}
        for s in range(self.n_shard):
            a, b = bounds[s], bounds[s + 1]
            ea, eb = int(offs[a]), int(offs[b])
            host = (uh[a:b], (offs[a:b + 1] - ea).astype(np.int32),
                    np.asarray(ep["pos"][ea:eb], np.int32),
                    np.asarray(ep["seq_id"][ea:eb], np.int32),
                    np.asarray(ep["side"][ea:eb], np.int8))
            for dev in self.mesh.devices[s]:
                if (s, dev) not in self._index:
                    self._index[s, dev] = tuple(
                        torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                        for x in host)
        for dev in self.mesh.devices.flat:
            if dev not in self._tables:
                self._tables[dev] = (
                    torch.from_numpy(np.asarray(group_arr, np.int32)).to(dev),
                    torch.from_numpy(np.asarray(sketch_cutoffs, np.int32))
                    .to(dev),
                    torch.tensor([max(1.0, params.sketch_size / 1000.0)],
                                 dtype=torch.float32, device=dev))

    def candidates(self, frags):
        """DeviceL1.candidates over the mesh: per fragment dict, its
        candidate list or None for the host route."""
        out: list = []
        step = self.BATCH * self.n_data
        for c0 in range(0, len(frags), step):
            out.extend(self._candidates_chunk(frags[c0:c0 + step]))
        return out

    def _candidates_chunk(self, frags):
        from ..utils import perf

        if not frags:
            return []
        p = self.params
        qh, q_nh, meta = pack_fragments(frags)
        with perf.span("map.l1.device") as run:
            slots = _ranges(len(frags), self.n_data)
            joined = {}
            for d, a, b in slots:           # every join before any merge
                for s in range(self.n_shard):
                    dev = self.mesh.devices[s, d]
                    uh, offs, ep_pos, ep_seq, ep_side = self._index[s, dev]
                    mt = torch.from_numpy(meta[a:b]).to(dev)
                    n = b - a
                    joined[s, d] = _join_endpoints(
                        torch.from_numpy(qh[a:b]).to(dev),
                        torch.from_numpy(q_nh[a:b]).to(dev), uh, offs,
                        ep_pos, ep_seq, ep_side, self._tables[dev][0],
                        mt[:, 0], mt[:, 1],
                        torch.full((n,), bool(p.skip_self or p.skip_prefix),
                                   device=dev),
                        torch.full((n,), bool(p.lower_triangular), device=dev),
                        cap=self.cap // self.n_shard)
            swept = []
            for d, a, b in slots:
                dev = self.mesh.devices[0, d]
                parts = [joined[s, d] for s in range(self.n_shard)]
                pos, seq, side, grp = (
                    torch.cat([part[j].to(dev) for part in parts], dim=1)
                    for j in range(4))
                over = torch.stack([part[4].to(dev) for part in parts]).any(0)
                _, cutoffs, cut_div = self._tables[dev]
                mt = torch.from_numpy(meta[a:b]).to(dev)
                cand, ncand, run_over = _sweep_candidates(
                    pos, seq, side, grp, mt[:, 2], mt[:, 3], cutoffs, cut_div,
                    int(p.window_length), maxc=self.maxc,
                    stage1=bool(p.stage1_topANI_filter))
                swept.append((cand, ncand, over | run_over))
            cand_l, ncand_l, over_l = [], [], []
            for cand, ncand, over in swept:
                n = ncand.cpu().tolist()
                ncand_l += n
                over_l += over.cpu().tolist()
                cand_l += cand[:, :max(n)].cpu().tolist()
        perf.add("map.device_s", run.seconds)
        perf.add("map.device_calls", 1)
        return answer_rows(frags, cand_l, ncand_l, over_l, p)


def sharded_hit_counts(query_hashes, index_hashes, mesh: Mesh):
    """Per query row, the number of its hashes present in the sorted
    index, with the index split into n_shard contiguous slices over the
    "shard" axis (each shard counts against its slice, and the counts are
    summed: the reference's psum). query_hashes (B, S) and index_hashes
    (H,) hold uint32 values (the reference's surrogate keys); H must
    divide by the axis size, as shard_map requires. Returns (B,) int32 on
    the first device of the axis."""
    devs = mesh.axis_devices("shard")
    n = len(devs)
    ih = torch.as_tensor(index_hashes).to(torch.int64)
    H = ih.shape[0]
    if H % n:
        raise ValueError(f"{H} index hashes do not split over {n} shards")
    qh = torch.as_tensor(query_hashes).to(torch.int64)
    counts = []
    for i, dev in enumerate(devs):
        sl = ih[i * H // n:(i + 1) * H // n].to(dev)
        q = qh.to(dev)
        idx = torch.searchsorted(sl, q).clamp_(0, sl.shape[0] - 1)
        counts.append((sl[idx] == q).sum(1, dtype=torch.int32))
    return torch.stack([c.to(devs[0]) for c in counts]).sum(
        0, dtype=torch.int32)


def data_parallel_wfa_steps(off, query, target, qlen, tlen, mesh: Mesh,
                            n_steps: int, penalties):
    """Advance a batch of wavefront rings n_steps score levels with the
    batch split into contiguous row ranges over the "data" axis. off:
    (B, R, 5, K) int32 score-0 rings; query/target: (B, L) uint8 rows;
    every problem splits on the target axis at tlen // 2, anchors start
    unset (as the reference's local_steps). Returns the advanced offsets,
    concatenated in order on off's device."""
    B, R, _, K = off.shape
    devs = mesh.axis_devices("data")
    shards = []
    for i, a, b in _ranges(B, len(devs)):
        dev = devs[i]
        o = off[a:b].to(dev)
        tl = tlen[a:b].to(dev)
        shards.append(dict(
            state=(o, torch.full_like(o, -1), torch.full_like(o, -1),
                   torch.full((b - a, R, 4, K), -1, dtype=torch.int32,
                              device=dev)),
            seq=(query[a:b].to(dev), target[a:b].to(dev), qlen[a:b].to(dev),
                 tl, torch.zeros(b - a, dtype=torch.bool, device=dev),
                 tl // 2)))
    for s in range(1, n_steps + 1):
        for sh in shards:
            sh["state"] = advance_torch(*sh["state"], s, *sh["seq"], K, R,
                                        penalties)[:4]
    return torch.cat([sh["state"][0].to(off.device) for sh in shards])


def diagonal_sharded_wfa_steps(off, anc_v, anc_h, open_a, query, target,
                               qlen, tlen, axis_is_query, mid, mesh: Mesh,
                               n_steps: int, penalties):
    """Advance wavefront rings n_steps score levels with the DIAGONAL axis
    split over the mesh's last axis: the sequence-parallel path for one
    alignment wider than one device's band. Each shard owns a contiguous
    window of K / n lanes. A level reads only lanes k-1, k, k+1, so before
    each level a shard's state is widened by one halo lane a side, copied
    from its neighbours (the mesh's ends take none: NEG_I / -1); the shard
    advances the widened window with its global diagonals as `kvec`, and
    drops the halo lanes, which its neighbours own and computed with
    their own neighbours. Ring state stays on each shard's device between
    levels; only the two halo columns move. Sequences are replicated.
    Bit-identical to advance_torch (and wfa_jax._advance) unsharded.

    off/anc_v/anc_h: (B, R, 5, K); open_a: (B, R, 4, K); K must divide by
    the axis size. Returns the four rings, concatenated on off's device."""
    axis = mesh.axis_names[-1]
    devs = mesh.axis_devices(axis)
    n = len(devs)
    B, R, _, K = off.shape
    if K % n:
        raise ValueError(f"K={K} not divisible by '{axis}' size {n}")
    Kl = K // n
    seqs: dict = {}
    shards = []
    for i, dev in enumerate(devs):
        if dev not in seqs:
            seqs[dev] = tuple(a.to(dev) for a in (query, target, qlen, tlen,
                                                  axis_is_query, mid))
        kvec = (torch.arange(Kl + 2, dtype=torch.int32, device=dev) - 1
                + i * Kl - K // 2)[None, :]
        shards.append(dict(
            dev=dev, kvec=kvec, seq=seqs[dev],
            state=tuple(a[..., i * Kl:(i + 1) * Kl].to(dev)
                        for a in (off, anc_v, anc_h, open_a))))
    fills = (NEG_I, -1, -1, -1)

    def halo(i, j):
        """State j of shard i widened by its neighbours' edge lanes."""
        a = shards[i]["state"][j]
        dev = shards[i]["dev"]
        edge = torch.full_like(a[..., :1], fills[j])
        left = shards[i - 1]["state"][j][..., -1:].to(dev) if i else edge
        right = shards[i + 1]["state"][j][..., :1].to(dev) \
            if i < n - 1 else edge
        return torch.cat([left, a, right], dim=-1)

    for s in range(1, n_steps + 1):
        wide = [tuple(halo(i, j) for j in range(4)) for i in range(n)]
        for sh, st in zip(shards, wide):
            got = advance_torch(*st, s, *sh["seq"], Kl + 2, R, penalties,
                                kvec=sh["kvec"])
            sh["state"] = tuple(a[..., 1:-1] for a in got[:4])
    return tuple(torch.cat([sh["state"][j].to(off.device) for sh in shards],
                           dim=-1) for j in range(4))


def multichip_step(mesh: Mesh, penalties, n_steps: int = 8):
    """The full step of the dry run: the hash-join hit counts over the
    sharded index and the data-parallel wavefront advance, with the
    reference's example inputs on the mesh's first device. Returns (fn,
    example_args); fn(*example_args) -> (counts (B,), offsets)."""
    n_shard = mesh.shape["shard"]
    n_data = mesh.shape["data"]
    R = ring_size(penalties)
    B = 2 * n_data
    K = 129
    L = 256
    S = 16
    H = 64 * n_shard

    rng = np.random.default_rng(0)
    q = rng.integers(65, 69, (B, L), dtype=np.uint8)
    t = q.copy()
    t[:, ::17] = 65  # a few mismatches
    qlen = np.full(B, L - 8, np.int32)
    tlen = np.full(B, L - 8, np.int32)
    off = np.full((B, R, 5, K), NEG_I, np.int32)
    off[:, 0, 0, K // 2] = 0

    qhash = rng.integers(0, 1 << 30, (B, S), dtype=np.uint32)
    ihash = rng.integers(0, 1 << 30, (H,), dtype=np.uint32)
    ihash[: S // 2] = qhash[0, : S // 2]  # guarantee some hits
    ihash = np.sort(ihash)

    def step(off, query, target, qlen, tlen, qhash, ihash):
        counts = sharded_hit_counts(qhash, ihash, mesh)
        out = data_parallel_wfa_steps(off, query, target, qlen, tlen, mesh,
                                      n_steps, penalties)
        return counts, out

    dev = mesh.devices.flat[0]
    args = tuple(torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                                  else a).to(dev)
                 for a in (off, q, t, qlen, tlen, qhash, ihash))
    return step, args
