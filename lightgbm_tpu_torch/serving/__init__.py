"""Online serving on the card: micro-batched inference + hot-swap.

The port of the JAX package's ``serving/`` core over kernel P1
(``ops/predict.py``):

* :mod:`engine`  — the packed ensemble resident on the engine's device,
  padded-shape power-of-two bucketing, pre-warmed buckets.
* :mod:`queue`   — micro-batching request queue: concurrent ``submit``s
  coalesce into one bucketed dispatch under a max-latency / max-batch
  policy; results scatter back to futures; shedding, deadlines, drain.
* :mod:`hotswap` — checksum-verified adoption of a new boosting round
  under load: verify the ``.sha256`` sidecar, pack + prewarm off-path,
  atomic flip; corrupt candidates are refused loudly.
* :mod:`server`  — stdlib HTTP/JSON front end plus the in-process
  client the tests use, and ``serve_from_config`` (``task=serve``).
* :mod:`batch`   — the batch tier: a data file streamed through reader,
  P1 and writer threads into a result file (``task=predict``).

Not ported yet: the fleet supervisor (``serve_fleet``; it needs
``resilience/retry``, ROADMAP A9).  Its names raise
``NotImplementedError`` naming the item.
"""

from .batch import format_block, pipelined_predict_file, predict_chunk_stream
from .engine import PackedModel, ServingEngine, power_of_two_buckets
from .hotswap import adopt_model, load_packed_model
from .queue import (DeadlineExpired, MicroBatchQueue, PredictionResult,
                    QueueDraining, QueueFull, RequestShed)
from .server import (InProcessClient, ServingServer, serve_from_config,
                     write_serving_manifest)

__all__ = [
    "PackedModel", "ServingEngine", "power_of_two_buckets",
    "adopt_model", "load_packed_model",
    "MicroBatchQueue", "PredictionResult",
    "RequestShed", "QueueFull", "DeadlineExpired", "QueueDraining",
    "InProcessClient", "ServingServer", "serve_from_config",
    "write_serving_manifest", "format_block", "pipelined_predict_file",
    "predict_chunk_stream",
]

# the JAX package's serving names that are not ported, with their item
DEFERRED = {
    **dict.fromkeys(("ReplicaSupervisor", "SubprocessReplica",
                     "ThreadReplica", "FleetFrontEnd", "FleetRequestFailed",
                     "FleetBudgetExhausted", "serve_fleet_from_config",
                     "supervisor"),
                    "A9: the fleet supervisor needs resilience/retry"),
}


def __getattr__(name):
    if name in DEFERRED:
        raise NotImplementedError(
            f"serving.{name} is not ported to lightgbm_tpu_torch yet "
            f"(ROADMAP queue {DEFERRED[name]})")
    raise AttributeError(name)
