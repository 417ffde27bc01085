"""How upstream's cluster workflows cut a run into jobs.

Frozen copies, so that a later change to the scripts cannot move the
yardstick:
- `mapping_weight` and `balance` from
  scripts/split_approx_mappings_in_chunks.py (map once with -m, split the
  records into weight-balanced -i chunks);
- `group_key`, `group` and `pairings` from scripts/all2all_jobs.py
  (all-vs-all mapping as per-pair -T/-Q jobs).
"""

from __future__ import annotations


def mapping_weight(line: str) -> float:
    f = line.rstrip("\n").split("\t")
    qspan = int(f[3]) - int(f[2])
    tspan = int(f[8]) - int(f[7])
    identity = None
    for tag in f[12:]:
        if tag.startswith("id:f:"):
            identity = float(tag[5:]) / 100.0
            break
    if identity is None:
        # column 13 in mashmap output style; fall back to fully divergent
        identity = 0.0
    return max(qspan, tspan) * (1.0 - identity)


def balance(weights: list[float], n: int) -> list[list[int]]:
    """Greedy least-loaded assignment preserving input order per chunk."""
    chunks: list[list[int]] = [[] for _ in range(n)]
    loads = [0.0] * n
    for i, w in enumerate(weights):
        k = loads.index(min(loads))
        chunks[k].append(i)
        loads[k] += w
    return chunks


def group_key(name: str, level: str) -> str:
    if "#" not in name:
        return name
    parts = name.split("#")
    if level in ("g", "genome"):
        return parts[0]
    if level in ("h", "haplotype"):
        return "#".join(parts[:2])
    return name  # contig level


def group(names: list[str], level: str) -> dict[str, list[str]]:
    out: dict[str, list[str]] = {}
    for n in names:
        out.setdefault(group_key(n, level), []).append(n)
    return out


def pairings(targets: dict, queries: dict, per_job: int):
    for tg in targets:
        pool = [q for q in queries if q != tg]
        for i in range(0, len(pool), per_job):
            yield tg, pool[i:i + per_job]


def query_span(line: str) -> int:
    f = line.split("\t")
    return int(f[3]) - int(f[2])


def split_chunks(lines: list[str], chunk_bp: float) -> list[list[str]]:
    """The records cut into weight-balanced chunks of about `chunk_bp` of
    query span each (their number rounded, at least one); empty chunks
    are dropped."""
    n = max(1, round(sum(query_span(l) for l in lines) / chunk_bp))
    return [[lines[i] for i in idx]
            for idx in balance([mapping_weight(l) for l in lines], n) if idx]
