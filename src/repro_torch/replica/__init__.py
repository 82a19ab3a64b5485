"""Replicated, self-healing serving plane (R replicas a shard).

The port of ``repro.replica``.  ``ReplicaSet`` slots in behind the
``ShardBackend`` protocol, so the coordinator, partitioning, merge and
service layers are unchanged; the ``IngestJournal`` write-ahead log plus
the ``Supervisor``'s respawn-replay-verify-rejoin loop make a killed
replica a transient loss of redundancy instead of an outage.  The journal
is the reference's byte for byte, and the workers are the port's, each
with its store on the plane's device.  See each module's docstring.
"""

from .journal import IngestJournal, JournalRecord, scan_journal
from .replicaset import (REPLICA_STATE_FILE, ReplicaLane, ReplicaSet,
                         ReplicatedSketchStore, connect_replicated,
                         snapshot_journal_seq, spawn_replicated)
from .supervisor import Supervisor

__all__ = [
    "IngestJournal", "JournalRecord", "scan_journal",
    "REPLICA_STATE_FILE", "ReplicaLane", "ReplicaSet",
    "ReplicatedSketchStore", "connect_replicated", "snapshot_journal_seq",
    "spawn_replicated", "Supervisor",
]
