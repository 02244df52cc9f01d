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
  ``serve_from_config``).

Reference ``train.conf`` files parse unchanged.  Every task runs on the
``device`` argument of :func:`main` (CUDA unless ``"cpu"``); no config
key selects it.  ``boosting_type=dart`` trains DART (models/dart.py) and
``nonfinite_policy`` guards the gradients (resilience/guards.py; the
guard's parked counts drain before the model is saved).  Refused,
naming their ROADMAP item: ``task=train_many`` (A7), ``task=serve_fleet``
(A9), ``task=train_fleet`` (A8/A9), checkpoints and ``resume`` (A9),
``num_machines > 1`` (A8) and the configurations
``models/gbdt.check_supported`` refuses (parallel learners: A8).
``hist_dtype=float64`` trains (float64 histograms, A5).
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
    if cfg.num_machines > 1:
        raise _not_ported(f"num_machines={cfg.num_machines}", "A8: parallel")
    if cfg.resume or cfg.snapshot_freq > 0:
        raise _not_ported("checkpoints (resume, snapshot_freq)",
                          "A9: resilience")
    check_supported(cfg)


def run_train(cfg: Config, device=None) -> GBDT:
    """InitTrain + Train (application.cpp:187-239) on ``device``."""
    _refuse_unported(cfg)
    dev = resolve_device(device)
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
    start = time.perf_counter()
    with _profiled(cfg, dev):
        stop_iter = _train_loop(cfg, booster, valid_names, start)
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
                start: float) -> Optional[int]:
    """The iteration loop (application.cpp:223-239); returns the best
    0-based iteration when early stopping fired, else None.  Early
    stopping fires as soon as ANY (valid set, metric) pair has gone
    ``early_stopping_round`` iterations without improving, and the model
    is cut to THAT pair's best iteration (gbdt.cpp:336-349)."""
    best_score: Dict[tuple, float] = {}
    best_iter: Dict[tuple, int] = {}
    for it in range(cfg.num_iterations):
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


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """main.cpp:4-22: 0 on success, 1 (with the message on stderr) on an
    error; what the port does not run raises ``NotImplementedError``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    try:
        params = load_parameters(argv)
        cfg = Config.from_dict(params)
        Log.reset_log_level(cfg.verbose)
        if cfg.task == "train":
            run_train(cfg, device)
        elif cfg.task in ("predict", "prediction", "test"):
            run_predict(cfg, device)
        elif cfg.task == "serve":
            return int(run_serve(cfg, device, block=True) or 0)
        elif cfg.task == "train_many":
            raise _not_ported("task=train_many", "A7: learners/forest.py")
        elif cfg.task == "serve_fleet":
            raise _not_ported("task=serve_fleet", "A9: the fleet supervisor")
        elif cfg.task == "train_fleet":
            raise _not_ported("task=train_fleet",
                              "A8/A9: gang training needs parallel and "
                              "resilience")
        else:
            Log.fatal(f"Unknown task: {cfg.task!r}")
    except NotImplementedError:
        raise
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
