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
* :mod:`supervisor` — the fleet: replicas (``task=serve`` subprocesses
  or in-process threads) under a supervisor that restarts them with
  ``resilience/retry``'s backoff and retries a request once on another
  replica, behind one front end (``task=serve_fleet``).
"""

from .batch import format_block, pipelined_predict_file, predict_chunk_stream
from .engine import PackedModel, ServingEngine, power_of_two_buckets
from .hotswap import adopt_model, load_packed_model
from .queue import (DeadlineExpired, MicroBatchQueue, PredictionResult,
                    QueueDraining, QueueFull, RequestShed)
from .server import (InProcessClient, ServingServer, serve_from_config,
                     write_serving_manifest)
from .supervisor import (FleetBudgetExhausted, FleetFrontEnd,
                         FleetRequestFailed, ReplicaSupervisor,
                         SubprocessReplica, ThreadReplica,
                         serve_fleet_from_config, subprocess_factory)

__all__ = [
    "PackedModel", "ServingEngine", "power_of_two_buckets",
    "adopt_model", "load_packed_model",
    "MicroBatchQueue", "PredictionResult",
    "RequestShed", "QueueFull", "DeadlineExpired", "QueueDraining",
    "InProcessClient", "ServingServer", "serve_from_config",
    "write_serving_manifest", "format_block", "pipelined_predict_file",
    "predict_chunk_stream",
    "ReplicaSupervisor", "SubprocessReplica", "ThreadReplica",
    "FleetFrontEnd", "FleetRequestFailed", "FleetBudgetExhausted",
    "serve_fleet_from_config", "subprocess_factory",
]
