"""The world of ranks the parallel learners run over.

Counterpart of lightgbm_tpu/parallel/mesh.py.  The JAX package shards
over a ``jax.sharding.Mesh`` of one process's devices; the port's world
is a ``torch.distributed`` process group, one process a rank, set up by
the caller (``torchrun``'s environment through the CLI, or
``init_process_group`` by hand) with a deadline, so that a rank that
skips a collective fails the others instead of hanging them.

A :class:`Mesh` is one axis of that world: a process group (the whole
world, or a sub-group of the grid learner), its size and this process's
rank in it, and the device the rank's tensors live on.  Its collectives
are the three the learners use: ``psum``, ``psum_scatter`` (tiled, as
``jax.lax.psum_scatter(..., tiled=True)``) and ``all_gather`` (a new
leading axis of the group's size).  Each returns its result on the
input's device and, given a ``site``, records itself in the census
(obs/dist.py).

The backend is the caller's: gloo on the CPU, NCCL on the card where
each rank has its own device (a CPU input is uploaded first), gloo on
the card where ranks share one device (NCCL refuses two ranks on one
card; gloo takes the CUDA tensors of every op here as they are).
``init_world`` raises when ``init_process_group`` fails; nothing falls
back to another backend or device.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..obs.dist import record_collective_site

ROW_AXIS = "row"  # data-parallel axis (rows sharded)
FEATURE_AXIS = "feature"  # feature-parallel axis (split search sharded)

# the deadline of every collective of a world init_world makes (seconds)
DEFAULT_TIMEOUT_S = 60.0

# collective calls and their host seconds since the last reset_counters
# (chip_smoke.py reads them)
CALLS = 0
SECONDS = 0.0


def reset_counters() -> None:
    global CALLS, SECONDS
    CALLS, SECONDS = 0, 0.0


def init_world(backend: str, rank: int, world_size: int,
               init_method: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S, device=None) -> None:
    """``init_process_group`` with a deadline on every collective.
    ``init_method`` defaults to ``env://`` (``MASTER_ADDR`` /
    ``MASTER_PORT``, as torchrun sets them).  ``device`` (a CUDA device)
    binds NCCL's rank to it.  Raises on any failure."""
    kw = {}
    if backend == "nccl" and device is not None:
        kw["device_id"] = torch.device(device)
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)


def world_size() -> int:
    """The size of the default process group, 1 where none is up."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def default_device_count() -> int:
    """The ranks of the world (the JAX package counts devices)."""
    return world_size()


class Mesh:
    """One axis of the world: ``group`` (None: the whole world), named
    ``axis_name``, over ranks whose tensors live on ``device``."""

    def __init__(self, group=None, axis_name: str = ROW_AXIS, device=None):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("a Mesh needs a torch.distributed process "
                               "group: call init_process_group first")
        self.group = group
        self.axis_name = axis_name
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        self.device = torch.device("cpu" if device is None else device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an NCCL mesh needs a CUDA device")
        self.shape = {axis_name: self.size}

    def _run(self, op: str, site: Optional[str], x: torch.Tensor, body):
        """``body(w)`` on a fresh copy ``w`` of ``x`` on the backend's
        side (the body may overwrite it), the result moved back to
        ``x``'s device."""
        global CALLS, SECONDS
        t0 = time.perf_counter()
        w = (x.to(self.device, copy=True) if self.backend == "nccl"
             else x.clone())
        out = body(w)
        if out.device != x.device:
            out = out.to(x.device)
        SECONDS += time.perf_counter() - t0
        CALLS += 1
        if site:
            record_collective_site(site, op, out.numel() * out.element_size())
        return out

    # ----------------------------------------------------- collectives
    def psum(self, x: torch.Tensor, site: Optional[str] = None):
        """The sum over the group, on every rank."""
        def body(w):
            dist.all_reduce(w, op=dist.ReduceOp.SUM, group=self.group)
            return w
        return self._run("all-reduce", site, x, body)

    def psum_scatter(self, x: torch.Tensor, dim: int = 0,
                     site: Optional[str] = None):
        """The sum over the group, split along ``dim`` into ``size``
        equal blocks: rank r keeps block r (``x.shape[dim]`` must divide
        by the group's size)."""
        if x.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                             f"into {self.size} blocks")

        def body(w):
            out = w.new_empty((w.shape[0] // self.size,) + tuple(w.shape[1:]))
            dist.reduce_scatter_tensor(out, w, op=dist.ReduceOp.SUM,
                                       group=self.group)
            return out
        front = x.movedim(dim, 0).contiguous()
        return self._run("reduce-scatter", site, front,
                         body).movedim(0, dim).contiguous()

    def all_gather(self, x: torch.Tensor, site: Optional[str] = None):
        """``[size, *x.shape]``: every rank's ``x`` in rank order."""
        def body(w):
            out = w.new_empty((self.size * w.numel(),))
            dist.all_gather_into_tensor(out, w.reshape(-1), group=self.group)
            return out.reshape((self.size,) + tuple(w.shape))
        return self._run("all-gather", site, x, body)

    def child_counts_fn(self, site: Optional[str] = None):
        """``grow_tree``'s ``child_counts_fn`` over this group: one
        all-gather of the two local counts (the JAX package's ``[W, 2]``
        gather), then their sums."""
        def counts(nl, nr):
            return self.all_gather(torch.stack([nl, nr]).to(torch.int32),
                                   site=site).sum(0)
        return counts


def data_mesh(num_devices: Optional[int] = None, group=None,
              axis_name: str = ROW_AXIS, device=None) -> Mesh:
    """A 1-D mesh over ``group`` (default: the whole world), the
    analog of the reference's ``num_machines`` world (network.cpp:
    20-38).  ``num_devices``, where given, must equal the group's size:
    a process group has no subset of itself to take."""
    mesh = Mesh(group, axis_name, device)
    if num_devices is not None and num_devices != mesh.size:
        raise ValueError(f"num_devices={num_devices} but the group has "
                         f"{mesh.size} ranks")
    return mesh


def row_block(n: int, num_shards: int, shard: int):
    """Rank ``shard``'s contiguous block of ``n`` rows padded to
    ``num_shards`` equal blocks: (start, stop, pad) with ``stop - start
    + pad`` = ceil(n / num_shards); only the last blocks pad."""
    size = -(-n // num_shards)
    start = min(shard * size, n)
    stop = min(start + size, n)
    return start, stop, size - (stop - start)


def row_padded_grower(sharded_fn, mesh: Mesh):
    """Wrap a grow fn over a rank's own rows so that it takes every row:
    each rank keeps its contiguous block of ``ceil(n / size)`` rows, the
    last block padded with rows of bin 0 whose ``bag_mask`` (and
    gradients) are 0, invisible to histograms and sums (mesh.py:40-62).
    The blocks' leaf ids are all-gathered and trimmed to ``n``, so every
    rank returns the whole row -> leaf map."""
    def grow(bins_T, grad, hess, bag_mask, feature_mask, nbpf, is_cat,
             params):
        n = bins_T.shape[1]
        start, stop, pad = row_block(n, mesh.size, mesh.rank)

        def block(t, dim):
            part = t.narrow(dim, start, stop - start)
            if not pad:
                return part.contiguous()
            shape = list(part.shape)
            shape[dim] = pad
            return torch.cat([part, part.new_zeros(shape)], dim)

        tree, leaf_id = sharded_fn(
            block(bins_T, 1), block(grad, 0), block(hess, 0),
            block(bag_mask, 0), feature_mask, nbpf, is_cat, params)
        every = mesh.all_gather(leaf_id, site="dp.leaf_id_allgather")
        return tree, every.reshape(-1)[:n]

    return grow


def env_world() -> Optional[tuple]:
    """(rank, world size, local rank) from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) where ``WORLD_SIZE`` > 1,
    else None."""
    ws = int(os.environ.get("WORLD_SIZE", "1"))
    if ws <= 1:
        return None
    return (int(os.environ["RANK"]), ws,
            int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
