"""Multi-process training: forming the world from a machine list, the
cross-rank config sync, and the per-tree tracing and desync sentinel of
the parallel learners.

Counterpart of lightgbm_tpu/parallel/multihost.py, the replacement for
the reference's Network::Init bootstrap (src/application/
application.cpp:187-198, src/network/linkers_socket.cpp:20-61).  The
JAX package attaches each process to its coordination service with
``jax.distributed.initialize``; the port forms a ``torch.distributed``
world (parallel/mesh.py ``init_world``) at ``tcp://<coordinator>``.
The world is described by either

* the env triple ``LGBM_TPU_COORDINATOR`` (``host:port``),
  ``LGBM_TPU_NUM_PROCESSES`` and ``LGBM_TPU_PROCESS_ID``, or
* the reference's ``machine_list_file`` (``ip port`` lines,
  linkers_socket.cpp:73-109) with ``num_machines > 1``: the first line
  is the coordinator, and this process's rank is the position of a
  local address in the list (linkers_socket.cpp:31-44), or
  ``LGBM_TPU_PROCESS_ID`` where the list does not say (several lines of
  one host).

Backend and device are decided from the topology before the world is
formed, and logged: a rank takes ``cuda:<local index % device_count>``
(its local index is its position among the lines of its host), over
NCCL where every local rank has a card of its own and over gloo on the
card where local ranks share one (NCCL refuses two ranks on one card;
gloo takes the CUDA tensors of the learners' collectives as they are);
gloo on the CPU only where the caller passes ``device="cpu"``.  Nothing
falls back after a failure: 20 attempts paced under ``time_out``
minutes, then a loud failure.

A process with the env pair (``LGBM_TPU_PROCESS_ID`` /
``LGBM_TPU_NUM_PROCESSES``) and no coordinator — a gang supervisor's
rank child (resilience/gang.py) — forms no world.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from ..log import Log
from .mesh import init_world, world_size

# attempts at forming the world (linkers_socket.cpp:182-197 retries its
# connects 20 times)
ATTEMPTS = 20


def _parse_machine_list(path: str) -> List[Tuple[str, int]]:
    machines: List[Tuple[str, int]] = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 2:
                machines.append((parts[0], int(parts[1])))
    return machines


def _local_addresses() -> set:
    """Best-effort local interface addresses (GetLocalIpList,
    socket_wrapper.hpp:157-197)."""
    addrs = {"127.0.0.1", "localhost", "0.0.0.0"}
    try:
        hostname = socket.gethostname()
        addrs.add(hostname)
        for info in socket.getaddrinfo(hostname, None):
            addrs.add(info[4][0])
    except OSError:
        pass
    return addrs


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)) or default)


def resolve_world(cfg=None) -> Optional[dict]:
    """The world this process belongs to, as the env triple or the
    machine list describes it: ``{coordinator, num_processes,
    process_id, local_index, local_count}``, or None where neither asks
    for more than one process (a gang child: the env pair without a
    coordinator).  Raises where the list is short or names no single
    rank for this host without ``LGBM_TPU_PROCESS_ID``."""
    coord = os.environ.get("LGBM_TPU_COORDINATOR", "")
    nproc = _env_int("LGBM_TPU_NUM_PROCESSES", 0)
    pid = _env_int("LGBM_TPU_PROCESS_ID", -1)
    mlist = getattr(cfg, "machine_list_file", "") if cfg is not None else ""
    want = getattr(cfg, "num_machines", 1) if cfg is not None else nproc
    local_index, local_count = max(pid, 0), max(nproc, 1)
    if not coord and mlist and want > 1:
        machines = _parse_machine_list(mlist)
        if len(machines) < want:
            Log.fatal(f"machine_list_file lists {len(machines)} machines, "
                      f"num_machines={want}")
        machines = machines[:want]
        coord = f"{machines[0][0]}:{machines[0][1]}"
        nproc = want
        if pid < 0:
            local = _local_addresses()
            ranks = [i for i, (ip, _) in enumerate(machines) if ip in local]
            if len(ranks) != 1:
                Log.fatal("cannot determine this machine's rank from "
                          f"machine_list_file (matches: {ranks}); set "
                          "LGBM_TPU_PROCESS_ID")
            pid = ranks[0]
        if not 0 <= pid < nproc:
            Log.fatal(f"LGBM_TPU_PROCESS_ID={pid} is not a rank of the "
                      f"{nproc} machines of {mlist}")
        host = machines[pid][0]
        same = [i for i, (ip, _) in enumerate(machines) if ip == host]
        local_index, local_count = same.index(pid), len(same)
    elif coord and coord.rpartition(":")[0] not in _local_addresses():
        # the env triple says nothing of placement: a remote coordinator
        # is taken to mean one process a host
        local_index, local_count = 0, 1
    if not (coord and nproc > 1 and 0 <= pid < nproc):
        return None
    return {"coordinator": coord, "num_processes": nproc,
            "process_id": pid, "local_index": local_index,
            "local_count": local_count}


def plan_backend(world: dict, device=None) -> Tuple[str, torch.device]:
    """(backend, device) of this rank, from the topology alone: gloo on
    the CPU where ``device`` is the CPU; else ``cuda:<local index %
    device_count>``, over NCCL where the host's ranks each have a card
    and over gloo where they share one."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo", torch.device("cpu")
    from ..backend import resolve_device

    resolve_device("cuda")  # raises without a card
    cards = torch.cuda.device_count()
    dev = torch.device("cuda", world["local_index"] % cards)
    return ("nccl" if world["local_count"] <= cards else "gloo"), dev


# the device initialize_from_config chose for this rank (None: no world
# formed here)
_STATE: dict = {"device": None}


def initialize_from_config(cfg=None, device=None) -> bool:
    """Form the world the config or env describes, when it asks for
    more than one process.  True when this process is then a rank of a
    world of more than one; idempotent (a world already up, e.g.
    torchrun's, is left as it is).  The device this rank trains on is
    kept for :func:`config_world`."""
    if tdist.is_available() and tdist.is_initialized():
        return world_size() > 1
    world = resolve_world(cfg)
    if world is None:
        return False
    backend, dev = plan_backend(world, device)
    coord, nproc, pid = (world["coordinator"], world["num_processes"],
                         world["process_id"])
    Log.info(f"Initializing distributed runtime: coordinator={coord}, "
             f"num_processes={nproc}, process_id={pid}, backend={backend} "
             f"on {dev} (local rank {world['local_index']} of "
             f"{world['local_count']} on this host)")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # a bounded retry loop under the config's time_out budget (minutes,
    # config.h:227), as the reference paces its connects
    # (linkers_socket.cpp:182-197); each attempt's timeout is also the
    # formed world's collective deadline
    timeout_s = 60 * int(getattr(cfg, "time_out", 120) or 120)
    deadline = time.monotonic() + timeout_s
    for attempt in range(1, ATTEMPTS + 1):
        left = max(1, int(deadline - time.monotonic()))
        try:
            init_world(backend, pid, nproc, f"tcp://{coord}",
                       timeout_s=max(10, min(timeout_s // ATTEMPTS, left)),
                       device=dev if backend == "nccl" else None)
            break
        except Exception as e:  # noqa: BLE001 — every init failure retries
            if tdist.is_initialized():
                tdist.destroy_process_group()
            if attempt == ATTEMPTS or time.monotonic() >= deadline:
                Log.fatal(f"distributed init failed (attempt {attempt}/"
                          f"{ATTEMPTS}, time_out={timeout_s // 60}min): "
                          f"{type(e).__name__}: {e}")
            Log.warning(f"distributed init attempt {attempt}/{ATTEMPTS} "
                        f"failed ({type(e).__name__}); retrying")
            time.sleep(min(10.0, max(0.0, deadline - time.monotonic())))
    _STATE["device"] = dev
    return world_size() > 1


@contextlib.contextmanager
def config_world(cfg, device=None):
    """The device to train on, inside the world ``cfg`` describes
    (``num_machines > 1``; see :func:`initialize_from_config`), with the
    config synced across the ranks of any world of more than one
    (:func:`sync_config_across_processes`; torchrun's too).  A world it
    formed is left on the way out; a world already up is used and left
    up; where none is, ``device`` passes through."""
    formed = False
    if cfg.num_machines > 1:
        if cfg.local_listen_port != 12400:
            raise ValueError(
                f"local_listen_port={cfg.local_listen_port}: neither "
                "package reads it — the world's address is the first line "
                "of machine_list_file (or LGBM_TPU_COORDINATOR); drop the "
                "key")
        if not (tdist.is_available() and tdist.is_initialized()):
            initialize_from_config(cfg, device)
            formed = tdist.is_initialized()
    try:
        sync_config_across_processes(cfg)
        yield _STATE["device"] if formed else device
    finally:
        if formed and tdist.is_initialized():
            tdist.destroy_process_group()
            _STATE["device"] = None


def describe_topology() -> dict:
    """This process's rank-topology block (checkpoint manifests, rank
    telemetry): the live world where one is up, else the launcher env
    (``LGBM_TPU_PROCESS_ID`` / ``LGBM_TPU_NUM_PROCESSES``), so a gang
    supervisor's rank children report the shape a world would; the gang
    stamp where ``LGBM_TPU_GANG_DIR`` is set."""
    topo = {
        "process_id": _env_int("LGBM_TPU_PROCESS_ID", 0),
        "num_processes": _env_int("LGBM_TPU_NUM_PROCESSES", 1),
        "local_devices": 0,
        "global_devices": 0,
        "platform": "",
    }
    if tdist.is_available() and tdist.is_initialized():
        dev = _STATE["device"]
        cuda = (dev is not None and dev.type == "cuda") or \
            str(tdist.get_backend()) == "nccl"
        topo["process_id"] = tdist.get_rank()
        topo["num_processes"] = tdist.get_world_size()
        topo["local_devices"] = torch.cuda.device_count() if cuda else 1
        topo["global_devices"] = tdist.get_world_size()
        topo["platform"] = "cuda" if cuda else "cpu"
    gang_dir = os.environ.get("LGBM_TPU_GANG_DIR", "")
    if gang_dir:
        topo["gang_id"] = os.environ.get("LGBM_TPU_GANG_ID", "gang")
        topo["gang_slot"] = _env_int("LGBM_TPU_GANG_SLOT", 0)
    return topo


# the 14 structural parameters every rank must share (a mismatch is
# fatal): the JAX package's list
STRUCTURAL_KEYS = (
    "objective", "num_iterations", "learning_rate", "num_leaves_",
    "max_bin", "min_data_in_leaf", "min_sum_hessian_in_leaf",
    "lambda_l1", "lambda_l2", "max_depth", "tree_learner",
    "tree_growth", "boosting_type", "num_class",
)
SEED_KEYS = ("data_random_seed", "feature_fraction_seed", "bagging_seed")
FRACTION_KEYS = ("feature_fraction", "bagging_fraction")


def structural_fingerprint(cfg) -> int:
    """crc32 (int31) of the 14 structural parameters, as the JAX
    package computes it."""
    import zlib

    src = "|".join(f"{k}={getattr(cfg, k, None)}" for k in STRUCTURAL_KEYS)
    return zlib.crc32(src.encode()) & 0x7FFFFFFF


def sync_config_across_processes(cfg) -> None:
    """GlobalSyncUpByMin (application.cpp:110-127, 190-198): the three
    seeds and two fractions take their MIN across the ranks, so every
    rank samples alike, and the 14 structural parameters are
    fingerprinted and must match (a mismatch stops every rank, naming
    the fingerprints).  Seven int32 words a rank, as the JAX package
    sends them: the seeds, then each fraction's float64 bit pattern in
    two words (lossless).  Both exchanges are traced collectives
    (obs/dist.py) under ``collective_deadline_s``.  A no-op without a
    world of more than one rank.  Mutates ``cfg``."""
    if world_size() <= 1 or cfg is None:
        return
    from ..obs import dist
    from ..resilience.retry import collective_deadline_s

    seeds = np.asarray([int(getattr(cfg, k, 0)) for k in SEED_KEYS],
                       np.int32)
    fracs = np.asarray([float(getattr(cfg, k, 1.0)) for k in FRACTION_KEYS],
                       np.float64)
    payload = np.concatenate([seeds, fracs.view(np.int32)])  # [3 + 4]
    world = world_size()
    deadline = collective_deadline_s(cfg)
    gathered = dist.traced_collective(
        lambda: dist.world_allgather_int32(payload, site="config_sync"),
        op="all-gather", label="config_sync",
        payload_bytes=int(payload.size) * 4 * world,
        barrier_fn=lambda: dist.world_barrier("config_sync"),
        deadline_s=deadline)
    gathered = np.ascontiguousarray(np.asarray(gathered, np.int32))
    seed_min = gathered[:, :3].min(axis=0)
    frac_min = gathered[:, 3:].copy().view(np.float64).min(axis=0)
    for k, v in zip(SEED_KEYS, seed_min):
        if hasattr(cfg, k):
            setattr(cfg, k, int(v))
    for k, v in zip(FRACTION_KEYS, frac_min):
        if hasattr(cfg, k):
            setattr(cfg, k, float(v))
    fp = structural_fingerprint(cfg)
    fps = dist.traced_collective(
        lambda: dist.world_allgather_int32([fp], site="config_fingerprint"),
        op="all-gather", label="config_fingerprint",
        payload_bytes=4 * world, deadline_s=deadline).ravel()
    if len(set(int(x) for x in fps)) > 1:
        Log.fatal(
            "training config differs across processes (fingerprints "
            f"{sorted(set(int(x) for x in fps))}, rank by rank "
            f"{[int(x) for x in fps]}); every rank must run with identical "
            f"structural parameters ({', '.join(STRUCTURAL_KEYS)})")


def _tree_bytes(tree) -> List[bytes]:
    """The grown tree as host bytes, in one counted host read: its leaf
    count and every field's bytes, in ``TREE_FIELDS`` order."""
    from ..learners.serial import _host
    from ..models.tree import TREE_FIELDS

    blob = _host(torch.cat([getattr(tree, k).contiguous().reshape(-1)
                            .view(torch.uint8) for k in TREE_FIELDS]))
    return [np.int32(tree.num_leaves).tobytes(), blob.tobytes()]


def make_multihost_grower(grow, mesh, collective_deadline=None):
    """Wrap a parallel learner's ``grow`` (any of parallel/*, over the
    world ``mesh`` of more than one rank) with the JAX package's
    multi-process observability (its ``make_multihost_data_parallel_
    grower``, multihost.py:289-394): the ``dist.grow.dispatch`` span
    around the growth, and on the sentinel's cadence
    (``LGBM_TPU_DESYNC_CHECK``) the ``dist.grow.fetch`` span around one
    host read of the grown tree, then the desync sentinel — one barrier
    and one ``int32[3]`` all-gather of (step, crc32 of the tree's bytes,
    rank) over ``mesh`` (census site ``desync_sentinel``), raising
    :class:`~lightgbm_tpu_torch.obs.dist.DesyncError` naming a rank whose
    tree differs within the iteration.  ``collective_deadline`` (seconds)
    bounds the sentinel's collectives; None reads the env override
    alone."""
    from ..obs import dist, telemetry
    from ..resilience.retry import collective_deadline_s

    deadline = (collective_deadline_s(None) if collective_deadline is None
                else collective_deadline)

    def gather(row):
        return dist.traced_collective(
            lambda: mesh.all_gather(torch.from_numpy(row),
                                    site="desync_sentinel").numpy(),
            op="all-gather", label="desync_sentinel",
            payload_bytes=int(row.size) * 4 * mesh.size,
            barrier_fn=lambda: dist.world_barrier("desync_sentinel"),
            deadline_s=deadline, rank=mesh.rank)

    sentinel = dist.DesyncSentinel(world=mesh.size, rank=mesh.rank,
                                   gather_fn=gather, deadline_s=deadline)
    state = {"step": 0, "cfg_crc": None}

    def grown(bins_T, grad, hess, bag_mask, fmask, nbpf, is_cat, params):
        with telemetry.span("dist.grow.dispatch"):
            tree, leaf_id = grow(bins_T, grad, hess, bag_mask, fmask, nbpf,
                                 is_cat, params)
        state["step"] += 1
        step = state["step"]
        if sentinel.should_check(step):
            with telemetry.span("dist.grow.fetch"):
                blobs = _tree_bytes(tree)
            if state["cfg_crc"] is None:
                state["cfg_crc"] = dist.config_crc(params)
            sentinel.verify(step, dist.state_fingerprint(
                step, state["cfg_crc"], *blobs))
        return tree, leaf_id

    return grown
