"""Request-level continuous-batching retrieval serving on the port.

The batch serve path (``core.serve.retrieve_topk``) answers "score
this [B, L] batch"; this package answers "single-user requests arrive
one at a time — batch them yourself": an async micro-batching queue
with bucketed fixed-shape padding (``queue``), replicas with shareable
warm-threshold EMAs (``replica``), a catalogue registry with validated
versioned hot-swap of prebuilt pruning state, built on a stream of its
own on the card (``registry``), JSON observability (``metrics``), and an
open-loop Poisson load generator (``loadgen``).
``server.RetrievalServer`` composes them (under a mesh on rank 0, the
other ranks running ``server.follow``); ``repro_torch.launch.server``
is the CLI.  The names are the JAX package's ``repro.serve``'s.

Every response is bit-exact against the same request served alone
through the same batch shape — ``tests/test_torch_server.py`` for the
proof on the CPU, ``chip_smoke.py`` for the card.
"""
from repro_torch.serve.loadgen import (VirtualClock, poisson_arrivals,
                                       request_stream, run_open_loop)
from repro_torch.serve.metrics import (METRICS_SCHEMA, ServerMetrics,
                                       validate_snapshot)
from repro_torch.serve.queue import PAD_ID, Batch, MicroBatchQueue, Request
from repro_torch.serve.registry import (CatalogueRegistry, CatalogueVersion,
                                        codes_hash)
from repro_torch.serve.replica import Replica, ReplicaPool, Result
from repro_torch.serve.server import RetrievalServer

__all__ = [
    "PAD_ID", "Batch", "MicroBatchQueue", "Request",
    "CatalogueRegistry", "CatalogueVersion", "codes_hash",
    "Replica", "ReplicaPool", "Result",
    "ServerMetrics", "METRICS_SCHEMA", "validate_snapshot",
    "VirtualClock", "poisson_arrivals", "request_stream",
    "run_open_loop",
    "RetrievalServer",
]
