"""The port's parallel learners (parallel/*) against the JAX package's.

One gloo world of W = 4 CPU processes (tests/torch_parallel_worker.py,
started once for the module, every rank killed past a deadline) grows
every case; the JAX package grows the same seeded numpy inputs on its
virtual CPU mesh (``data_mesh(num_devices=4)``, ``grid_mesh((2, 2))``).
Problems: n = 1024 rows and n = 1002 (ragged: the last rank's block is
padded by 2 rows), F = 12 features with two categorical, 63 bins.

* Float data (random gradients): the structure is exact (``num_leaves``
  and every node's feature, threshold bin, decision type and children),
  the row -> leaf maps equal (trimmed for the ragged case), and leaf and
  internal values agree within rtol 1e-5 / atol 1e-6, the float32
  tolerance of tests/test_torch_depthwise.py: both packages reduce the W
  partials in their backend's order and sum a histogram's rows in their
  own.
* Exact-sum data (gradients and hessians small multiples of 2**-6, every
  sum exact in float32): every learner, and data-parallel depthwise,
  hybrid, pooled and float64, is bitwise the port's serial learner and
  (float32) the JAX package's parallel learner.  The JAX package's
  float64 route needs x64, which the suite leaves off, so float64 is
  held against the port's serial float64 tree.
* The census (obs/dist.py): a leaf-wise data-parallel tree makes 3
  collectives a split plus the root's 3 (and one leaf-id all-gather), a
  depthwise tree 2 a level; the sites, ops and bytes a call are the JAX
  package's where it records the same site.
"""

import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.learners.serial import TreeLearnerParams as JaxParams
from lightgbm_tpu.obs import telemetry as jax_telemetry
from lightgbm_tpu.parallel import (data_mesh as jax_data_mesh,
                                   grid_mesh as jax_grid_mesh,
                                   make_data_parallel_grower as jax_dp,
                                   make_feature_parallel_grower as jax_fp,
                                   make_grid_parallel_grower as jax_gp,
                                   make_voting_parallel_grower as jax_vp)

import lightgbm_tpu_torch.learners.depthwise as port_depthwise
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.learners.depthwise import grow_tree_depthwise
from lightgbm_tpu_torch.learners.hybrid import grow_tree_hybrid
from lightgbm_tpu_torch.learners.serial import TreeLearnerParams, grow_tree
from lightgbm_tpu_torch.ops.cuda_histogram import (histogram_single_leaf,
                                                   make_level_hist_fn)
from lightgbm_tpu_torch.parallel.split_comm import (
    combine_gathered_split_infos, combine_packed, pack_split, unpack_split)
from lightgbm_tpu_torch.ops.split import SplitResult

from torch_parallel_worker import World

W, F, B, L = 4, 12, 63, 15
PARAMS = dict(min_data_in_leaf=20, min_sum_hessian_in_leaf=1e-3)
NODE = ("split_feature", "threshold_bin", "decision_type", "left_child",
        "right_child")
LEAF = ("leaf_parent", "leaf_depth", "leaf_count")
VALUES = ("leaf_value", "internal_value", "split_gain")


def _problem(n, exact=False, seed=3):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(F, n)).astype(np.uint8)
    bins[0] %= 10  # categorical features of 10 and 6 bins
    bins[1] %= 6
    if exact:
        grad = (rng.randint(-256, 257, n) / 64.0).astype(np.float32)
        hess = (rng.randint(1, 129, n) / 64.0).astype(np.float32)
    else:
        grad = rng.randn(n).astype(np.float32)
        hess = (np.abs(rng.randn(n)) + 0.1).astype(np.float32)
    nbpf = np.full(F, B, np.int32)
    nbpf[:2] = (10, 6)
    iscat = np.zeros(F, bool)
    iscat[:2] = True
    bag = (rng.rand(n) < 0.9).astype(np.float32)
    fmask = np.ones(F, bool)
    fmask[5] = False
    return dict(bins=bins, grad=grad, hess=hess, bag=bag, fmask=fmask,
                nbpf=nbpf, iscat=iscat, B=B)


PROBLEMS = {"f1024": _problem(1024), "f1002": _problem(1002, seed=5),
            "x1024": _problem(1024, exact=True),
            "x1002": _problem(1002, exact=True, seed=5)}

# (case, problem, learner kwargs); top_k 6 is degenerate (2·6 = F)
LEARNERS = {
    "data": dict(learner="data"),
    "depthwise": dict(learner="data", growth="depthwise"),
    "hybrid": dict(learner="data", growth="hybrid"),
    "pooled": dict(learner="data", hist_pool=4),
    "float64": dict(learner="data", hist_dtype="float64"),
    "feature": dict(learner="feature"),
    "voting6": dict(learner="voting", top_k=6),
    "voting2": dict(learner="voting", top_k=2),
    "grid": dict(learner="grid", grid=(2, 2)),
}
FLOAT_CASES = [("f1024", k) for k in LEARNERS if k != "float64"] + [
    ("f1002", "data")]
EXACT_CASES = ([("x1024", k) for k in LEARNERS]
               + [("x1002", k) for k in ("data", "voting6", "grid")])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case grown once on the 4-rank world (the JAX package's trees
    are grown meanwhile); the ranks' results."""
    cases = [(f"{p}-{k}", "grow", dict(problem=PROBLEMS[p], L=L,
                                        params=PARAMS, **LEARNERS[k]))
             for p, k in FLOAT_CASES + EXACT_CASES]
    ranks = World(cases, W, str(tmp_path_factory.mktemp("world")),
                  deadline_s=300)
    for p, k in FLOAT_CASES + EXACT_CASES:
        if k != "float64":
            jax_tree(p, k)
    return ranks.results()


# ------------------------------------------------------------- references
@functools.lru_cache(maxsize=None)
def _jax_grower(key, n):
    kw = dict(LEARNERS[key])
    learner = kw.pop("learner")
    if learner == "data":
        return jax_dp(jax_data_mesh(num_devices=W), num_bins=B, max_leaves=L,
                      growth=kw.get("growth", "leafwise"),
                      hist_pool=kw.get("hist_pool", 0))
    if learner == "feature":
        return jax_fp(jax_data_mesh(num_devices=W), num_bins=B, max_leaves=L)
    if learner == "voting":
        return jax_vp(jax_data_mesh(num_devices=W), num_bins=B, max_leaves=L,
                      top_k=kw["top_k"])
    return jax_gp(jax_grid_mesh((2, 2)), num_bins=B, max_leaves=L)


def _jax_counters():
    return dict(jax_telemetry.get_telemetry().snapshot()["counters"])


_JAX_CENSUS = {}


@functools.lru_cache(maxsize=None)
def jax_tree(pname, key):
    p = PROBLEMS[pname]
    args = [jnp.asarray(p[k]) for k in ("bins", "grad", "hess", "bag",
                                         "fmask", "nbpf", "iscat")]
    before = _jax_counters()
    tree, lid = _jax_grower(key, p["bins"].shape[1])(
        *args, JaxParams.from_config(JaxConfig(**PARAMS)))
    after = _jax_counters()
    _JAX_CENSUS.setdefault(key, {k: v - before.get(k, 0)
                                 for k, v in after.items()
                                 if k.startswith("collective_site")
                                 and v != before.get(k, 0)})
    d = {k: np.asarray(getattr(tree, k)) for k in NODE + LEAF + VALUES}
    d["num_leaves"] = int(tree.num_leaves)
    return d, np.asarray(lid)


def port_serial(pname, key):
    """The port's serial learner on the same inputs (the order route, as
    on the CPU)."""
    p = PROBLEMS[pname]
    args = [torch.from_numpy(p[k]) for k in ("bins", "grad", "hess", "bag",
                                              "fmask", "nbpf", "iscat")]
    prm = TreeLearnerParams.from_config(Config(**PARAMS))
    kw = LEARNERS[key]
    dt = (torch.float64 if kw.get("hist_dtype") == "float64"
          else torch.float32)
    hf = functools.partial(histogram_single_leaf, num_bins=B, acc_dtype=dt)
    if kw.get("growth") == "depthwise":
        return grow_tree_depthwise(*args, prm, B, L,
                                   hist_fn=make_level_hist_fn(B, dt))
    if kw.get("growth") == "hybrid":
        return grow_tree_hybrid(*args, prm, B, L, hist_fn=hf,
                                level_hist_fn=make_level_hist_fn(B, dt))
    return grow_tree(*args, prm, B, L, hist_fn=hf,
                     hist_pool=kw.get("hist_pool", 0))


def _tree_np(tree):
    d = {k: getattr(tree, k).numpy() for k in NODE + LEAF + VALUES}
    d["num_leaves"] = int(tree.num_leaves)
    return d


def _assert_structure(got, want):
    nl = want["num_leaves"]
    assert got["num_leaves"] == nl
    for k in NODE:
        np.testing.assert_array_equal(got[k][:nl - 1], want[k][:nl - 1],
                                      err_msg=k)
    for k in LEAF:
        np.testing.assert_array_equal(got[k][:nl], want[k][:nl], err_msg=k)


def _assert_bitwise(got, want):
    _assert_structure(got, want)
    nl = want["num_leaves"]
    np.testing.assert_array_equal(got["leaf_value"][:nl],
                                  want["leaf_value"][:nl])
    for k in ("internal_value", "split_gain"):
        np.testing.assert_array_equal(got[k][:nl - 1], want[k][:nl - 1],
                                      err_msg=k)


def _rank0(world, name):
    r0 = world[0][name]
    for r in range(1, W):  # the same tree and map on every rank
        for k, v in r0["tree"].items():
            np.testing.assert_array_equal(world[r][name]["tree"][k], v,
                                          err_msg=f"rank {r} {k}")
        np.testing.assert_array_equal(world[r][name]["leaf_id"],
                                      r0["leaf_id"])
    return r0


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("pname,key", FLOAT_CASES,
                         ids=[f"{p}-{k}" for p, k in FLOAT_CASES])
def test_float_data_matches_jax(world, pname, key):
    got = _rank0(world, f"{pname}-{key}")
    want, lid = jax_tree(pname, key)
    assert want["num_leaves"] > 4
    _assert_structure(got["tree"], want)
    np.testing.assert_array_equal(got["leaf_id"], lid)
    nl = want["num_leaves"]
    np.testing.assert_allclose(got["tree"]["leaf_value"][:nl],
                               want["leaf_value"][:nl], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["tree"]["internal_value"][:nl - 1],
                               want["internal_value"][:nl - 1], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("pname,key", EXACT_CASES,
                         ids=[f"{p}-{k}" for p, k in EXACT_CASES])
def test_exact_data_bitwise(world, pname, key):
    got = _rank0(world, f"{pname}-{key}")
    if key != "voting2":  # restricted voting is not the serial tree
        tree, lid = port_serial(pname, key)
        _assert_bitwise(got["tree"], _tree_np(tree))
        np.testing.assert_array_equal(got["leaf_id"], lid.numpy())
    if key != "float64":
        want, lid = jax_tree(pname, key)
        _assert_bitwise(got["tree"], want)
        np.testing.assert_array_equal(got["leaf_id"], lid)


def test_census_leafwise_three_a_split(world):
    got = _rank0(world, "f1024-data")
    S = got["tree"]["num_leaves"] - 1
    c = got["census"]
    per = {k.split(".")[2]: v for k, v in c.items()
           if k.startswith("collective_site.")}
    assert per == {"child_counts_allgather": S, "split_allgather": S,
                   "hist_reduce_scatter": S + 1, "root_split_allgather": 1,
                   "root_sums_allreduce": 1, "leaf_id_allgather": 1}
    assert got["calls"] == 3 * S + 3 + 1
    jax_tree("f1024", "data")
    jc = _JAX_CENSUS["data"]
    jax_sites = {k for k in jc if k.startswith("collective_site.")}
    assert jax_sites and jax_sites <= set(c)  # same site names and ops
    for k in jax_sites:
        site = k.split(".")[2]
        bytes_key = f"collective_site_bytes.dp.{site}"
        # bytes a call: the JAX package records once a trace
        assert c[bytes_key] / c[k] == jc[bytes_key] / jc[k], site


def test_census_depthwise_two_a_level(world):
    got = _rank0(world, "f1024-depthwise")
    c = got["census"]
    levels = c["collective_site.dp.level_hist_reduce_scatter.reduce-scatter"]
    assert c["collective_site.dp.split_allgather_leaves.all-gather"] == levels
    assert got["calls"] == 2 * levels + 1  # and the leaf-id all-gather
    before = port_depthwise.LEVELS
    port_serial("f1024", "depthwise")
    assert levels == port_depthwise.LEVELS - before >= 2
    jax_tree("f1024", "depthwise")
    jc = _JAX_CENSUS["depthwise"]
    assert {k for k in jc if k.startswith("collective_site.")} == {
        "collective_site.dp.level_hist_reduce_scatter.reduce-scatter",
        "collective_site.dp.split_allgather_leaves.all-gather"}


def test_combine_ties_to_smaller_feature():
    """The deterministic max: the larger gain, ties to the smaller
    feature, a rank without a split (feature -1) never wins a tie."""
    g = torch.tensor([[1.0, 7, 3], [2.0, 9, 1], [2.0, 4, 5], [2.0, -1, 0]])
    rows = torch.zeros((4, 11))
    rows[:, :3] = g
    assert combine_packed(rows)[1].item() == 4
    r = unpack_split(rows)
    w = combine_gathered_split_infos(r)
    assert isinstance(w, SplitResult) and int(w.feature) == 4
    assert torch.equal(pack_split(unpack_split(rows)), rows)
    none = torch.zeros((2, 11))
    none[:, 0], none[:, 1] = float("-inf"), -1
    assert combine_packed(none)[1].item() == -1
