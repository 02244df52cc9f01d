"""Command-line application: ``python -m lightgbm_tpu_torch config=train.conf``.

Counterpart of lightgbm_tpu/cli.py (the reference's Application,
src/application/application.cpp, src/main.cpp): ``key=value`` argv
merged over a config file (argv wins, application.cpp:46-104), then

* ``task=train`` (application.cpp:187-239): load the data file and the
  ``valid_data`` files (io/dataset.py), continue ``input_model`` if given,
  train with the per-iteration log, metric output every ``metric_freq``
  and early stopping (under a ``torch.profiler`` trace into
  ``profile_dir`` with ``profile=true``), save the model (atomically,
  with its ``.sha256`` sidecar) and write a run manifest beside it;
* ``task=predict`` (application.cpp:242-256): stream ``data`` through the
  batch tier (serving/batch.py) into ``output_result``;
* ``task=serve``: the online service (serving/server.py
  ``serve_from_config``);
* ``task=train_many``: ``num_models`` models on one binned dataset, model
  i with ``seed + i``, saved to ``<output_model>.<i>``;
* ``task=serve_fleet``: supervised ``task=serve`` replicas behind one
  front end (serving/supervisor.py ``serve_fleet_from_config``).

``task=train`` checkpoints (resilience/checkpoint.py): every
``snapshot_freq`` iterations into ``snapshot_dir`` (default
``<output_model>.ckpt/``) and on SIGTERM / SIGINT, after which it exits
75; ``resume=true`` (``--resume``) continues from the newest checkpoint
and the final model is bitwise the uninterrupted run's.

Reference ``train.conf`` files parse unchanged.  Every task runs on the
``device`` argument of :func:`main` (CUDA unless ``"cpu"``); no config
key selects it.  ``boosting_type=dart`` trains DART (models/dart.py) and
``nonfinite_policy`` guards the gradients (resilience/guards.py; the
guard's parked counts drain before the model is saved).
``hist_dtype=float64`` trains (float64 histograms, A5).

Under ``torchrun`` (``WORLD_SIZE > 1`` in the environment) ``task=train``
joins the world the environment describes (:func:`torchrun_world`): each
rank on ``cuda:LOCAL_RANK`` over NCCL, or on the CPU over gloo where
``main`` is given ``device="cpu"``; ``tree_learner`` then picks the
parallel learner and ``num_machines`` (if set) must equal the world's
size, each rank loading its partition of ``data``.  Every rank writes the
same model.  Bringing a world up from a machine list (``num_machines >
1`` without one) and ``task=train_fleet`` are refused, naming ROADMAP A8
step 3.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Dict, List, Optional

import torch

from .backend import resolve_device
from .config import (Config, key_alias_transform, parse_config_file,
                     parse_line_params)
from .io.dataset import BinnedDataset
from .log import Log
from .models.dart import create_boosting
from .models.gbdt import GBDT, check_supported
from .obs import flightrec
from .resilience.guards import NonFiniteError
from .obs import RunManifest, manifest_path, telemetry
from .parallel.mesh import env_world, init_world, world_size
from .objectives import create_objective
from .resilience.atomic import atomic_write
from .serving.batch import DEFAULT_CHUNK_ROWS, DEFAULT_STREAM_THRESHOLD


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to lightgbm_tpu_torch yet (ROADMAP queue "
        f"{item})")


def load_parameters(argv: List[str]) -> Dict[str, str]:
    """argv ``key=value`` pairs + optional config file; argv wins
    (application.cpp:46-104), aliases resolved before the merge.  Bare
    ``--flag`` tokens are ``flag=true``."""
    argv = [a[2:] + "=true" if a.startswith("--") and "=" not in a
            else a.lstrip("-") for a in argv]
    params = key_alias_transform(parse_line_params(argv))
    conf_path = params.pop("config_file", "")
    if conf_path:
        file_params = key_alias_transform(parse_config_file(conf_path))
        for k, v in file_params.items():
            params.setdefault(k, v)
    params.pop("config_file", None)
    return params


class Predictor:
    """Batch file prediction -> result file (src/application/predictor.hpp:
    24-155) through serving/batch.py: one line per row, tab-separated for
    multi-output.  Inputs above ``stream_threshold`` bytes stream through
    the reader / P1 / writer pipeline; ``overlap=False`` runs the stages
    in sequence.  Both write the same bytes."""

    stream_threshold = DEFAULT_STREAM_THRESHOLD
    chunk_rows = DEFAULT_CHUNK_ROWS
    overlap = True

    def __init__(self, booster, is_raw_score: bool,
                 is_predict_leaf_index: bool):
        self.booster = booster
        self.is_raw_score = is_raw_score
        self.is_leaf = is_predict_leaf_index

    def predict_file(self, data_path: str, result_path: str,
                     has_header: bool = False,
                     num_iteration: int = -1) -> dict:
        from .serving.batch import pipelined_predict_file

        return pipelined_predict_file(
            self.booster, data_path, result_path, has_header=has_header,
            num_iteration=num_iteration, raw_score=self.is_raw_score,
            pred_leaf=self.is_leaf, stream_threshold=self.stream_threshold,
            chunk_rows=self.chunk_rows, overlap=self.overlap)


def _output_metrics(gbdt: GBDT, iter_num: int, names: List[str],
                    is_training_metric: bool) -> List[tuple]:
    """OutputMetric (gbdt.cpp:299-356): log, and return (set_idx, metric,
    value, bigger_is_better) rows of the valid sets for early stopping.
    A metric at several positions is judged by its last one."""
    rows = []
    sets = [(0, "training")] if is_training_metric else []
    sets.extend((i + 1, names[i]) for i in range(len(names)))
    for data_idx, name in sets:
        metrics = (gbdt.train_metrics if data_idx == 0
                   else gbdt.valid_metrics[data_idx - 1])
        vals = gbdt.eval_at(data_idx)
        for m in metrics:
            keys = ([f"{m.name}@{k}" for k in m.eval_at]
                    if hasattr(m, "eval_multi") else [m.name])
            for key in keys:
                Log.info(f"Iteration: {iter_num}, {name} {key} : "
                         f"{vals[key]:g}")
            if data_idx > 0 and keys:
                rows.append((data_idx, m.name, vals[keys[-1]],
                             m.bigger_is_better))
    return rows


def _refuse_unported(cfg: Config) -> None:
    """Fail before any data loads on what the port does not run."""
    if cfg.num_machines > 1 and world_size() != cfg.num_machines:
        raise _not_ported(
            f"num_machines={cfg.num_machines} without a torch.distributed "
            "world of that size", "A8 step 3: the machine-list bootstrap")
    check_supported(cfg)


@contextlib.contextmanager
def torchrun_world(device=None):
    """The device to train on, inside the world ``torchrun``'s
    environment describes (``RANK``, ``WORLD_SIZE`` > 1, ``LOCAL_RANK``,
    ``MASTER_ADDR`` / ``MASTER_PORT``): gloo with ``device="cpu"``, else
    NCCL with this rank on ``cuda:LOCAL_RANK``.  A world already up, or
    none described, is left as it is and ``device`` passes through.  A
    failed join raises; the joined world is left on the way out."""
    env = env_world()
    if env is None or torch.distributed.is_initialized():
        yield device
        return
    rank, size, local = env
    cpu = device is not None and torch.device(device).type == "cpu"
    dev = torch.device("cpu") if cpu else resolve_device(f"cuda:{local}")
    init_world("gloo" if cpu else "nccl", rank, size, device=dev)
    try:
        yield dev
    finally:
        torch.distributed.destroy_process_group()


def run_train(cfg: Config, device=None) -> GBDT:
    """InitTrain + Train (application.cpp:187-239) on ``device``, with
    checkpoints: ``resume=true`` continues from the newest checkpoint
    (resilience/checkpoint.py; none at all starts fresh, with a warning;
    a corrupt one or one written under another config raises), and the
    loop runs inside a ``CheckpointManager`` (``snapshot_freq``, the
    stop signals).  A preempted run raises ``TrainingPreempted`` and
    writes no model."""
    from .resilience import checkpoint as ckpt

    _refuse_unported(cfg)
    dev = resolve_device(device)
    # a preempted or poisoned run dumps its flight recorder next to the
    # model it was training (LGBM_TPU_FLIGHTREC_DIR overrides)
    flightrec.configure_dir(
        os.path.dirname(os.path.abspath(cfg.output_model)))
    t0 = time.perf_counter()
    train = BinnedDataset.from_file(cfg.data, cfg)
    Log.info(f"Finish loading data, use {time.perf_counter() - t0:.6f} "
             "seconds")
    objective = (create_objective(cfg, train.metadata, train.num_data, dev)
                 if cfg.objective != "none" else None)
    booster = create_boosting(cfg, train, objective, device=dev)
    valid_names: List[str] = []
    for path in cfg.valid_data:
        booster.add_valid_dataset(
            BinnedDataset.from_file(path, cfg, reference=train))
        valid_names.append(os.path.basename(path))
    if cfg.input_model:
        from .basic import Booster

        init = Booster(model_file=cfg.input_model, device=dev)
        booster.merge_from(init._gbdt, prepend=True)
        Log.info(f"Continued training from {cfg.input_model} "
                 f"({init._gbdt.num_trees} trees)")
    # early-stopping state per (valid set, metric) (gbdt.cpp:336-347),
    # out here so that a checkpoint carries it
    best_score: Dict[tuple, float] = {}
    best_iter: Dict[tuple, int] = {}
    start_iter = 0
    if cfg.resume:
        t1 = time.perf_counter()
        found = ckpt.load_latest_for(cfg)
        if found is not None:
            ck_path, payload = found
            start_iter = ckpt.restore_training_state(
                booster, payload, best_score, best_iter)
            Log.info(f"Resumed from {ck_path}: {booster.num_trees} trees, "
                     f"continuing at iteration {start_iter + 1} (read, "
                     f"checked and restored in "
                     f"{time.perf_counter() - t1:.6f} seconds)")
        else:
            Log.warning("resume=true but no checkpoint found in "
                        f"{ckpt.checkpoint_dir(cfg)}; starting fresh")
    start = time.perf_counter()
    with _profiled(cfg, dev), ckpt.CheckpointManager(
            cfg, booster, best_score, best_iter) as ckmgr:
        stop_iter = _train_loop(cfg, booster, valid_names, best_score,
                                best_iter, start, start_iter, ckmgr)
    # the guard's parked counts drain before the save and the manifest
    # (a short clip run would report no clipped values otherwise)
    booster.finalize_guards()
    # slice counts iterations from the model start, so prepended init-model
    # trees are part of the budget (gbdt.cpp:589-592)
    num_iteration = (booster.num_init_iteration + stop_iter + 1
                     if stop_iter is not None else -1)
    atomic_write(cfg.output_model,
                 booster.save_model_to_string(num_iteration), checksum=True)
    Log.info(f"Finished training, saved model to {cfg.output_model}")
    _write_train_manifest(cfg, booster, time.perf_counter() - start)
    return booster


def run_train_many(cfg: Config, params: Dict[str, str],
                   device=None) -> list:
    """``task=train_many`` (the JAX package's cli.py:427-463): ``num_models``
    models on one binned dataset, each round advanced for all of them
    (``engine.train_many``: one forest a round where every model may grow
    as a lane).  Model i trains with ``seed + i`` and is saved, atomically
    with its ``.sha256`` sidecar, to ``<output_model>.<i>``; each is the
    model ``task=train`` with that seed writes, bitwise."""
    from .basic import Dataset
    from .engine import train_many

    _refuse_unported(cfg)
    if cfg.resume or cfg.snapshot_freq > 0:
        # the JAX package's run_train_many does not read them: a knob
        # accepted without being read would be silently ignored
        raise ValueError(
            "task=train_many does not checkpoint (resume, snapshot_freq "
            "are read by task=train only, as in the JAX package)")
    if cfg.num_models < 1:
        Log.fatal("num_models must be >= 1 for task=train_many")
    dev = resolve_device(device)
    base = {k: v for k, v in params.items()
            if k not in ("task", "num_models", "data", "output_model")}
    plist = [dict(base, seed=cfg.seed + i) for i in range(cfg.num_models)]
    t0 = time.perf_counter()
    ds = Dataset(cfg.data, params=dict(base), device=dev)
    boosters = train_many(plist, ds, num_boost_round=cfg.num_iterations,
                          device=dev)
    Log.info(f"Finished training {len(boosters)} models in "
             f"{time.perf_counter() - t0:.6f} seconds")
    for i, bst in enumerate(boosters):
        path = f"{cfg.output_model}.{i}"
        bst.save_model(path)
        Log.info(f"Saved model {i} ({bst.num_trees()} trees) to {path}")
    return boosters


@contextlib.contextmanager
def _profiled(cfg: Config, dev):
    """``profile=true``: a ``torch.profiler`` trace of the training loop
    (host, and the card's kernels on CUDA) written into ``profile_dir``
    as a Chrome trace (the JAX CLI's ``jax.profiler`` trace,
    lightgbm_tpu/cli.py:218-226); no-op otherwise."""
    if not cfg.profile:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(dev).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    Log.info("profile=true: the manifest's phase breakdown from the trace "
             "is not ported (ROADMAP A10)")
    with profile(activities=acts) as prof:
        yield
    os.makedirs(cfg.profile_dir, exist_ok=True)
    path = os.path.join(cfg.profile_dir, f"train.{os.getpid()}.trace.json")
    prof.export_chrome_trace(path)
    Log.info(f"Saved profiler trace to {path}")


def _write_train_manifest(cfg: Config, booster: GBDT, train_s: float) -> None:
    """A RunManifest beside the saved model (``<output_model>.manifest
    .json``).  Best-effort: a failed manifest does not fail a finished
    training run."""
    try:
        from .obs import memory as obs_memory

        manifest = RunManifest.collect(
            "cli.train", config=cfg,
            result={"num_trees": booster.num_trees,
                    "train_wall_s": round(train_s, 3),
                    "output_model": cfg.output_model},
            per_tree_reservoir="tree_dispatch_s",
            memory={"watermarks": obs_memory.watermarks()})
        path = manifest.write(manifest_path(cfg.output_model))
        Log.info(f"Wrote run manifest to {path}")
        if cfg.verbose >= 2:
            Log.debug("telemetry " + json.dumps(
                telemetry.get_telemetry().snapshot(), sort_keys=True))
        telemetry.emit_if_json()
    except (OSError, ValueError, TypeError) as e:
        Log.warning(f"run manifest write failed: {type(e).__name__}: {e}")


def _train_loop(cfg: Config, booster: GBDT, valid_names: List[str],
                best_score: Dict[tuple, float], best_iter: Dict[tuple, int],
                start: float, start_iter: int, ckmgr) -> Optional[int]:
    """The iteration loop (application.cpp:223-239) from ``start_iter``;
    returns the best 0-based iteration when early stopping fired, else
    None.  Early stopping fires as soon as ANY (valid set, metric) pair
    has gone ``early_stopping_round`` iterations without improving, and
    the model is cut to THAT pair's best iteration (gbdt.cpp:336-349).
    ``ckmgr.after_iteration`` runs once a completed iteration that did
    not end the run, after the early-stop bookkeeping (the JAX package's
    cli.py:414-419), so a checkpoint at k carries k's bests."""
    for it in range(start_iter, cfg.num_iterations):
        finished = booster.train_one_iter()
        Log.info(f"{time.perf_counter() - start:.6f} seconds elapsed, "
                 f"finished iteration {it + 1}")
        if cfg.metric_freq > 0 and (it + 1) % cfg.metric_freq == 0:
            rows = _output_metrics(booster, it + 1, valid_names,
                                   cfg.is_training_metric)
            if cfg.early_stopping_round > 0:
                for data_idx, mname, v, bigger in rows:
                    key = (data_idx, mname)
                    if key not in best_score or (
                            v > best_score[key] if bigger
                            else v < best_score[key]):
                        best_score[key], best_iter[key] = v, it
                    elif it - best_iter[key] >= cfg.early_stopping_round:
                        Log.info(f"Early stopping at iteration {it + 1}, the "
                                 f"best iteration round is "
                                 f"{best_iter[key] + 1}")
                        return best_iter[key]
        if finished:
            Log.info("Stopped training because there are no more leaves "
                     "that meet the split requirements.")
            break
        if ckmgr is not None:
            ckmgr.after_iteration(it)
    return None


def run_predict(cfg: Config, device=None) -> dict:
    """Application::Predict (application.cpp:242-256): ``data`` through
    the batch tier into ``output_result``; returns its stage stats."""
    from .basic import Booster

    if not cfg.input_model:
        Log.fatal("input_model should not be empty for prediction task")
    booster = Booster(model_file=cfg.input_model, device=device)
    t0 = time.perf_counter()
    stats = Predictor(booster, cfg.is_predict_raw_score,
                      cfg.is_predict_leaf_index).predict_file(
        cfg.data, cfg.output_result, cfg.has_header,
        num_iteration=cfg.num_iteration_predict)
    Log.info(f"Finish prediction, use {time.perf_counter() - t0:.6f} "
             f"seconds; saved to {cfg.output_result}")
    if cfg.verbose >= 2:
        Log.debug("predict pipeline " + json.dumps(stats, sort_keys=True))
    return stats


def run_serve(cfg: Config, device=None, block: bool = True):
    """``task=serve``: the micro-batched service over the model file
    (serving/server.py ``serve_from_config``).  ``block=True`` serves
    until SIGINT/SIGTERM, drains and returns 75; ``block=False`` returns
    the started server."""
    from .serving import serve_from_config

    if not cfg.input_model:
        Log.fatal("input_model should not be empty for serve task")
    return serve_from_config(cfg, block=block, device=device)


def run_serve_fleet(cfg: Config, device=None) -> int:
    """``task=serve_fleet``: the replica supervisor (serving/supervisor.py)
    — ``serve_replicas`` ``task=serve`` subprocesses behind one
    round-robin front end, health-checked, restarted on crash or
    preemption with jittered backoff, scaled between ``serve_replicas``
    and ``serve_max_replicas`` off the queue-depth gauge.  The replicas
    are ``python -m lightgbm_tpu_torch`` processes, which run on the
    card: ``device`` must be the card (in process, ``ReplicaSupervisor``
    over ``ThreadReplica(device="cpu")`` runs a CPU fleet)."""
    from .serving.supervisor import serve_fleet_from_config

    if not cfg.input_model:
        Log.fatal("input_model should not be empty for serve_fleet task")
    if resolve_device(device).type != "cuda":
        raise ValueError(
            "task=serve_fleet runs its replicas as python -m "
            "lightgbm_tpu_torch processes, on the card; in process, "
            "supervise ThreadReplica(..., device='cpu') instead")
    return int(serve_fleet_from_config(cfg) or 0)


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """main.cpp:4-22: 0 on success, 1 (with the message on stderr) on an
    error, 75 (``EXIT_PREEMPTED``) when a stop signal preempted training
    after its checkpoint; what the port does not run raises
    ``NotImplementedError``."""
    from .resilience import EXIT_PREEMPTED
    from .resilience.checkpoint import TrainingPreempted

    argv = sys.argv[1:] if argv is None else list(argv)
    try:
        params = load_parameters(argv)
        cfg = Config.from_dict(params)
        Log.reset_log_level(cfg.verbose)
        if cfg.task == "train":
            with torchrun_world(device) as dev:
                run_train(cfg, dev)
        elif cfg.task in ("predict", "prediction", "test"):
            run_predict(cfg, device)
        elif cfg.task == "serve":
            return int(run_serve(cfg, device, block=True) or 0)
        elif cfg.task == "train_many":
            run_train_many(cfg, params, device)
        elif cfg.task == "serve_fleet":
            return run_serve_fleet(cfg, device)
        elif cfg.task == "train_fleet":
            raise _not_ported("task=train_fleet",
                              "A8 step 3: the gang supervisor")
        else:
            Log.fatal(f"Unknown task: {cfg.task!r}")
    except NotImplementedError:
        raise
    except TrainingPreempted as ex:
        # sysexits EX_TEMPFAIL: a supervisor relaunches with resume=true
        # and loses nothing.  The flight recorder dumps last, so its tail
        # is the preemption itself.
        print(f"Preempted:\n{ex}", file=sys.stderr)
        flightrec.record("preempted", iteration=ex.iteration,
                         checkpoint=ex.path)
        flightrec.dump(reason="preempted")
        return EXIT_PREEMPTED
    except Exception as ex:  # noqa: BLE001 — the CLI's error boundary
        if isinstance(ex, NonFiniteError):
            # the guard recorded its trip; the dump's tail names the abort
            flightrec.record("nonfinite_abort", error=str(ex)[:400])
            flightrec.dump(reason="nonfinite")
        print(f"Met Exceptions:\n{ex}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
