"""Training callbacks (counterpart of lightgbm_tpu/callback.py).

The reference's protocol (python-package/lightgbm/callback.py): each
callback receives a ``CallbackEnv`` per iteration; callbacks with
``before_iteration`` run before ``Booster.update``, the others after the
evaluation, each list sorted by ``order``.  ``early_stopping`` raises
:class:`EarlyStopException` and stamps ``booster.best_iteration``.  Pure
Python: nothing here touches a device.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional


class EarlyStopException(Exception):
    """Raised to stop training early (callback.py:9-14); ``best_score``
    is the evaluation list of the best iteration."""

    def __init__(self, best_iteration: int, best_score: Optional[list] = None):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score or []


CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def _format_eval_result(value, show_stdv: bool = True) -> str:
    """callback.py:22-37."""
    if len(value) == 4:
        return f"{value[0]}'s {value[1]}:{value[2]:.6g}"
    if len(value) == 5:  # cv: (name, metric, mean, bigger_is_better, std)
        if show_stdv:
            return f"{value[0]}'s {value[1]}:{value[2]:.6g}+{value[4]:.6g}"
        return f"{value[0]}'s {value[1]}:{value[2]:.6g}"
    raise ValueError("Wrong metric value")


def print_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    """Print the metrics every ``period`` iterations (callback.py:40-62)."""

    def callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list and (
                (env.iteration + 1) % period == 0):
            result = "\t".join(_format_eval_result(x, show_stdv)
                               for x in env.evaluation_result_list)
            print(f"[{env.iteration + 1}]\t{result}")

    callback.order = 10
    return callback


def record_evaluation(eval_result: Dict[str, Dict[str, List[float]]]
                      ) -> Callable:
    """Fill ``eval_result`` with the evaluation history, as
    ``{data_name: {metric: [value per iteration]}}`` (callback.py:65-98)."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result has to be a dictionary")
    eval_result.clear()

    def callback(env: CallbackEnv) -> None:
        for data_name, eval_name, result, *_ in env.evaluation_result_list:
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, []).append(result)

    callback.order = 20
    return callback


def reset_parameter(**kwargs: Any) -> Callable:
    """Reset parameters before each iteration; each value is a list (one
    entry per iteration) or a function of the iteration's offset from
    the first (callback.py:101-123)."""

    def callback(env: CallbackEnv) -> None:
        new_parameters = {}
        for key, value in kwargs.items():
            if key in ("num_class", "boosting_type", "metric"):
                raise RuntimeError(f"cannot reset {key} during training")
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(f"Length of list {key!r} has to equal "
                                     "to 'num_boost_round'.")
                new_parameters[key] = value[env.iteration
                                            - env.begin_iteration]
            elif callable(value):
                new_parameters[key] = value(env.iteration
                                            - env.begin_iteration)
            else:
                raise ValueError(
                    "Only list and callable values are supported.")
        env.model.reset_parameter(new_parameters)
        env.params.update(new_parameters)

    callback.before_iteration = True
    callback.order = 10
    return callback


def early_stopping(stopping_rounds: int, verbose: bool = True) -> Callable:
    """Stop when no metric of a validation set has improved in
    ``stopping_rounds`` rounds (callback.py:126-192).  Sets
    ``model.best_iteration`` (1-based).  The training set's metrics are
    tracked but never stop training; that set is the one named
    ``model.train_data_name``."""
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List[Optional[list]] = []
    cmp_op: List[Callable[[float, float], bool]] = []

    def init(env: CallbackEnv) -> None:
        if not env.evaluation_result_list:
            raise ValueError("For early stopping, at least one dataset and "
                             "eval metric is required for evaluation")
        if verbose:
            print("Training until validation scores don't improve for "
                  f"{stopping_rounds} rounds.")
        for entry in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
            if entry[3]:  # bigger is better
                best_score.append(float("-inf"))
                cmp_op.append(lambda a, b: a > b)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda a, b: a < b)

    def callback(env: CallbackEnv) -> None:
        if not best_score:
            init(env)
        train_name = getattr(env.model, "train_data_name", "training")
        for i, (data_name, _, score, *_) in enumerate(
                env.evaluation_result_list):
            if best_score_list[i] is None or cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            elif data_name == train_name:
                continue
            elif env.iteration - best_iter[i] >= stopping_rounds:
                if env.model is not None:
                    env.model.best_iteration = best_iter[i] + 1
                if verbose:
                    print("Early stopping, best iteration is:")
                    print(f"[{best_iter[i] + 1}]\t" + "\t".join(
                        _format_eval_result(x) for x in best_score_list[i]))
                raise EarlyStopException(best_iter[i], best_score_list[i])

    callback.order = 30
    return callback
