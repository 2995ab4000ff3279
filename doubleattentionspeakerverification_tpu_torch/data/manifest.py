"""Manifest parsing: a copy of the JAX package's ``data/manifest.py``.

Reference label files are lines of ``relative/path label [-1]``
(``scripts/data.py:66-71``); trial files are ``utt1 utt2`` pairs
(``scripts/train.py:117-133``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple


@dataclass(frozen=True)
class Utterance:
    path: str   # relative path, without extension suffixing decisions
    label: int


def parse_train_manifest(lines: Sequence[str]) -> List[Utterance]:
    out = []
    for line in lines:
        parts = line.strip().split()
        if not parts:
            continue
        out.append(Utterance(path=parts[0], label=int(parts[1])))
    return out


def load_train_manifest(path: str) -> List[Utterance]:
    with open(path, "r") as f:
        return parse_train_manifest(f.readlines())


def load_trials(path: str) -> List[Tuple[str, str]]:
    pairs = []
    with open(path, "r") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) >= 2:
                pairs.append((parts[0], parts[1]))
    return pairs


def shard_for_host(items: Sequence, host_id: int, num_hosts: int) -> List:
    """Deterministic per-host shard (round-robin) for multi-host training.

    Every host receives exactly ``len(items) // num_hosts`` items (the
    remainder is dropped): uneven shards would give hosts different
    steps-per-epoch, and the host with the extra step would block forever in
    the step's gradient all-reduce while the others have already left
    the epoch loop.
    """
    if num_hosts <= 1:
        return list(items)
    per = len(items) // num_hosts
    return [items[host_id + i * num_hosts] for i in range(per)]
