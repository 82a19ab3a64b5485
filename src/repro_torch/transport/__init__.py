"""Multi-process transport plane for the sharded serving store.

The port of ``repro.transport``, byte-compatible with it on the wire.  The
in-process ``ShardedSketchStore`` already computes with the seams explicit:
one band-hash broadcast out to every shard, one ``TopKPartial`` back per
shard, reduced by the associative ``distributed.collectives.merge_topk``.
This package turns those seams into a cross-process transport:

  * ``wire``    -- versioned, length-prefixed binary framing with zero-copy
                  numpy (de)serialization and checksummed frames;
  * ``server``  -- a shard worker process hosting one ``SketchStore`` on a
                  device (the card by default), serving framed requests
                  over a TCP socket;
  * ``client``  -- the coordinator side: per-worker connections, a
                  nonblocking fan-out/gather group, and the ``RemoteShard``
                  backend that plugs workers into ``ShardedSketchStore``;
  * ``faults``  -- the deterministic fault-injection plan.

Every worker runs the same candidate + partial-top-k code as the
in-process backend and the merge is associative, so tcp answers are
bit-identical to the in-process plane on the same items.  Overload
hardening rides the same seams: wire deadlines (``deadline_scope``),
bounded worker admission with retryable ``Overloaded`` replies, one
plane-wide ``RetryBudget`` and per-lane ``CircuitBreaker``\\ s.
"""

from .client import (CircuitBreaker, DeadlineExceeded, FanoutGroup,
                     HedgePolicy, Overloaded, RemoteShard, RetryBudget,
                     ShardConnection, TransportError, TransportTimeout,
                     WorkerError, connect_sharded, current_deadline,
                     deadline_scope, shutdown_plane)
from .faults import (FAULT_LOG_ENV, FAULTS_ENV, KILL_EXIT_CODE, FaultEvent,
                     FaultPlan, faults_env_value, install_client_plan,
                     read_fired_log)
from .server import AdmissionGate, WorkerHandle, spawn_workers

__all__ = ["CircuitBreaker", "DeadlineExceeded", "FanoutGroup",
           "HedgePolicy", "Overloaded", "RemoteShard", "RetryBudget",
           "ShardConnection", "TransportError", "TransportTimeout",
           "WorkerError", "connect_sharded", "current_deadline",
           "deadline_scope", "shutdown_plane",
           "FAULT_LOG_ENV", "FAULTS_ENV", "KILL_EXIT_CODE", "FaultEvent",
           "FaultPlan", "faults_env_value", "install_client_plan",
           "read_fired_log", "AdmissionGate", "WorkerHandle",
           "spawn_workers"]
