"""Sequence id, length, and PanSN group management.

Equivalent of skch::SequenceIdManager (reference:
src/map/include/sequenceIds.hpp:16-446):

* ids assigned from ``.fai`` files, TARGETS FIRST then queries, in file
  order (sequenceIds.hpp:366-374 — keeps target ids stable for index reuse);
* optional name-list and prefix filters per side;
* group ids from explicit prefixes or the PanSN prefix before the LAST
  occurrence of the delimiter (default '#'); group numbering follows the
  lexicographic order of sequence names, starting at 1
  (buildRefGroups, sequenceIds.hpp:284-345).
"""

from __future__ import annotations

from .fasta import read_fai


class SequenceIdManager:
    def __init__(
        self,
        query_files: list[str],
        target_files: list[str],
        query_prefixes: list[str] | None = None,
        target_prefixes: list[str] | None = None,
        prefix_delim: str = "#",
        query_list: str = "",
        target_list: str = "",
    ):
        self.prefix_delim = prefix_delim or ""
        self.query_prefixes = [p for p in (query_prefixes or []) if p]
        self.target_prefixes = [p for p in (target_prefixes or []) if p]
        self.all_prefixes = self.query_prefixes + self.target_prefixes

        self.name_to_id: dict[str, int] = {}
        self.names: list[str] = []
        self.lengths: list[int] = []
        self.group_ids: list[int] = []
        self.group_id_to_prefix: dict[int, str] = {}
        self.query_names: list[str] = []
        self.target_names: list[str] = []

        allowed_targets = self._read_list(target_list)
        allowed_queries = self._read_list(query_list)

        # Targets first to keep their IDs stable (sequenceIds.hpp:368)
        for f in target_files:
            self._read_file(f, self.target_prefixes, allowed_targets, is_query=False)
        for f in query_files:
            self._read_file(f, self.query_prefixes, allowed_queries, is_query=True)

        self._build_ref_groups()

    @staticmethod
    def _read_list(list_file: str) -> set[str] | None:
        if not list_file:
            return None
        with open(list_file) as fh:
            return {line.rstrip("\n") for line in fh if line.strip()}

    def _read_file(self, file_name, prefixes, allowed, is_query):
        for rec in read_fai(file_name + ".fai"):
            if prefixes and not any(rec.name.startswith(p) for p in prefixes):
                continue
            if allowed is not None and rec.name not in allowed:
                continue
            self._add_sequence(rec.name, rec.length)
            (self.query_names if is_query else self.target_names).append(rec.name)

    def _add_sequence(self, name: str, length: int) -> int:
        sid = self.name_to_id.get(name)
        if sid is not None:
            self.lengths[sid] = length
            return sid
        sid = len(self.names)
        self.name_to_id[name] = sid
        self.names.append(name)
        self.lengths.append(length)
        self.group_ids.append(0)
        return sid

    def _build_ref_groups(self):
        # Lexicographic order of names drives group numbering
        # (sequenceIds.hpp:284-347).
        current_group = 0
        group_map: dict[str, int] = {}
        for name in sorted(self.names):
            idx = self.name_to_id[name]
            group_key = ""
            for prefix in self.all_prefixes:
                if name.startswith(prefix):
                    group_key = prefix
                    break
            if not group_key and self.prefix_delim:
                pos = name.rfind(self.prefix_delim)
                if pos != -1:
                    group_key = name[:pos]
            if not group_key:
                group_key = name
            if group_key not in group_map:
                current_group += 1
                group_map[group_key] = current_group
                self.group_id_to_prefix[current_group] = group_key
            self.group_ids[idx] = group_map[group_key]

    # -- accessors (mirroring the reference API) ----------------------------
    def get_sequence_id(self, name: str) -> int:
        return self.name_to_id[name]

    def get_sequence_name(self, seq_id: int) -> str:
        return self.names[seq_id]

    def get_sequence_length(self, seq_id: int) -> int:
        return self.lengths[seq_id]

    def get_ref_group(self, seq_id: int) -> int:
        return self.group_ids[seq_id]

    def get_query_sequence_names(self) -> list[str]:
        return list(self.query_names)

    def get_target_sequence_names(self) -> list[str]:
        return list(self.target_names)
