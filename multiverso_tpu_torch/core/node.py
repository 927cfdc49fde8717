"""Per-process role record.

TPU-native equivalent of the reference's ``Node``/``Role``
(ref: include/multiverso/node.h:6-27, src/node.cpp:5-12). On TPU the natural
deployment is role=ALL on every process (each host both computes and owns a
shard of the tables in its devices' HBM), but WORKER/SERVER-only roles are
preserved for API parity with the reference's ``-ps_role`` flag.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class Role(enum.IntFlag):
    NONE = 0
    WORKER = 1
    SERVER = 2
    ALL = 3


@dataclass
class Node:
    rank: int = -1
    role: int = int(Role.ALL)
    worker_id: int = -1
    server_id: int = -1


def is_worker(role: int) -> bool:
    return bool(role & Role.WORKER)


def is_server(role: int) -> bool:
    return bool(role & Role.SERVER)


def role_from_string(name: str) -> Role:
    """Parse the -ps_role flag value (default/worker/server/all)."""
    name = name.strip().lower()
    if name in ("default", "all"):
        return Role.ALL
    if name == "worker":
        return Role.WORKER
    if name == "server":
        return Role.SERVER
    if name == "none":
        return Role.NONE
    raise ValueError(f"unknown ps_role: {name}")
