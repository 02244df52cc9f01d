"""One rank of a gloo world on the CPU, for the port's multi-process tests.

``python tests/torch_parallel_worker.py SPEC OUT RANK WORLD PORT`` joins a
world of WORLD ranks at ``tcp://127.0.0.1:PORT`` (a 60 s deadline on
every collective), runs the cases of the pickle SPEC (a list of ``(name,
function, kwargs)``) in order and writes ``{name: result}`` to
``OUT/rank<RANK>.pkl``; a rank whose case raised prints the traceback
and exits 1.  ``World`` starts the ranks and kills them all past its
deadline.  Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    """``world`` rank processes running ``cases`` (started at once; the
    caller may work meanwhile).  ``results`` waits for them."""

    def __init__(self, cases, world: int, tmp_dir: str,
                 deadline_s: float = 240.0):
        os.makedirs(tmp_dir, exist_ok=True)
        spec = os.path.join(tmp_dir, "spec.pkl")
        with open(spec, "wb") as f:
            pickle.dump(cases, f)
        # gloo over the loopback device: the ranks share this host
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT,
                   GLOO_SOCKET_IFNAME="lo")
        port = str(free_port())
        self.tmp_dir = tmp_dir
        self.end = time.monotonic() + deadline_s
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), spec, tmp_dir, str(r),
             str(world), port], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(world)]

    def results(self):
        """The ranks' result dicts in rank order.  Raises (after killing
        every rank) past the deadline, on an exit code or a case error."""
        try:
            for p in self.procs:
                p.wait(timeout=max(self.end - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
            logs = [p.communicate()[0].decode(errors="replace")
                    for p in self.procs]
        out = []
        for r, p in enumerate(self.procs):
            path = os.path.join(self.tmp_dir, f"rank{r}.pkl")
            if p.returncode != 0 or not os.path.exists(path):
                raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                                   + logs[r][-4000:])
            with open(path, "rb") as f:
                out.append(pickle.load(f))
        return out


def run_world(cases, world: int, tmp_dir: str, deadline_s: float = 240.0):
    """``World(...).results()``."""
    return World(cases, world, tmp_dir, deadline_s).results()


# ------------------------------------------------------------------ cases
def tree_dict(tree) -> dict:
    from lightgbm_tpu_torch.models.tree import TREE_FIELDS

    d = {k: getattr(tree, k).cpu().numpy() for k in TREE_FIELDS}
    d["num_leaves"] = int(tree.num_leaves)
    return d


def _tensors(problem):
    import torch

    keys = ("bins", "grad", "hess", "bag", "fmask", "nbpf", "iscat")
    return [torch.from_numpy(np.ascontiguousarray(problem[k])) for k in keys]


def grow(problem, L, params, learner="data", growth="leafwise",
         hist_pool=0, hist_dtype="float32", top_k=20, grid=(2, 2)):
    """One tree of a parallel learner; its tree, leaf ids, the census
    and the collective calls it made."""
    import torch

    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.learners.serial import TreeLearnerParams
    from lightgbm_tpu_torch.obs.dist import collective_census
    from lightgbm_tpu_torch.parallel import (data_mesh, grid_mesh,
                                             make_data_parallel_grower,
                                             make_feature_parallel_grower,
                                             make_grid_parallel_grower,
                                             make_voting_parallel_grower)
    from lightgbm_tpu_torch.parallel import mesh as mesh_mod

    dt = torch.float64 if hist_dtype == "float64" else torch.float32
    kw = dict(num_bins=problem["B"], max_leaves=L, hist_pool=hist_pool,
              hist_dtype=dt)
    if learner == "data":
        g = make_data_parallel_grower(data_mesh(), growth=growth, **kw)
    elif learner == "feature":
        g = make_feature_parallel_grower(data_mesh(), **kw)
    elif learner == "voting":
        g = make_voting_parallel_grower(data_mesh(), top_k=top_k, **kw)
    else:
        g = make_grid_parallel_grower(grid_mesh(grid), **kw)
    before = collective_census()
    calls = mesh_mod.CALLS
    tree, lid = g(*_tensors(problem),
                  TreeLearnerParams.from_config(Config(**params)))
    after = collective_census()
    return dict(tree=tree_dict(tree), leaf_id=lid.numpy(),
                census={k: v - before.get(k, 0) for k, v in after.items()
                        if v != before.get(k, 0)},
                calls=mesh_mod.CALLS - calls)


def exact_fobj(preds, train_data):
    """A binary objective whose gradients are integers in [-4, 4] and
    hessians 1: every histogram sum is exact in float32."""
    y = train_data.get_label()
    p = 1.0 / (1.0 + np.exp(-np.asarray(preds, np.float64)))
    grad = np.clip(np.round(4.0 * (p - y)), -4, 4)
    return grad.astype(np.float32), np.ones_like(grad, np.float32)


def train(params, X, y, rounds, exact=False):
    """``lt.train`` on the CPU (with ``exact_fobj`` where ``exact``);
    its model text."""
    import lightgbm_tpu_torch as lt

    bst = lt.train(dict(params, verbose=-1),
                   lt.Dataset(X, label=y, device="cpu"), rounds,
                   fobj=exact_fobj if exact else None, device="cpu")
    return dict(model=bst.model_to_string())


def load(path, params, valid=None):
    """``BinnedDataset.from_file`` of this rank under ``params``, its
    binned rows, labels and mappers (and ``valid``'s, loaded with it as
    the reference)."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import BinnedDataset

    cfg = Config.from_dict(params)
    ds = BinnedDataset.from_file(path, cfg)
    out = dict(bins=ds.dense_bins(), label=ds.metadata.label,
               partition_rank=ds.partition_rank,
               mappers=[m.to_dict() for m in ds.bin_mappers])
    if valid is not None:
        dv = BinnedDataset.from_file(valid, cfg, reference=ds)
        out["valid_bins"] = dv.dense_bins()
    return out


def cli_train(argv, model_path):
    """``cli.main(argv + output_model)`` on the CPU: exit code, model."""
    from lightgbm_tpu_torch import cli

    rc = cli.main(list(argv) + [f"output_model={model_path}"], device="cpu")
    with open(model_path) as f:
        return dict(rc=rc, model=f.read())


def find_mappers(sample, num_machines, max_bin, categorical_features=()):
    """``distributed_find_bin_mappers`` over the world."""
    import torch.distributed as dist

    from lightgbm_tpu_torch.io.distributed import distributed_find_bin_mappers

    ms = distributed_find_bin_mappers(
        sample, dist.get_rank(), num_machines, max_bin=max_bin,
        categorical_features=categorical_features)
    return [m.to_dict() for m in ms]


CASES = dict(grow=grow, train=train, load=load, cli_train=cli_train,
             find_mappers=find_mappers)


def main(argv):
    spec, out, rank, world, port = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from lightgbm_tpu_torch.parallel.mesh import init_world

    init_world("gloo", rank, world, f"tcp://127.0.0.1:{port}", timeout_s=60)
    with open(spec, "rb") as f:
        cases = pickle.load(f)
    results = {}
    try:
        for name, fn, kw in cases:
            results[name] = CASES[fn](**kw)
    except Exception:
        results = {"__error__": traceback.format_exc()}
        print(results["__error__"], flush=True)
    tmp = os.path.join(out, f"rank{rank}.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(results, f)
    os.replace(tmp, os.path.join(out, f"rank{rank}.pkl"))
    if "__error__" not in results:
        dist.destroy_process_group()
    else:
        os._exit(1)


if __name__ == "__main__":
    main(sys.argv[1:])
