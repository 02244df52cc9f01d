"""Kernel P1's layout and configuration on the CPU.

P1 (``csrc/predict.cu``) reads each internal node as one 16-byte record,
``PackedTrees.node``: ``{split_feature | categorical << 31, the
threshold's float32 bits, left_child, right_child}``.  The plain versions
read the separate arrays, so the record must decode to them exactly; a
record that did not would route the card's walks elsewhere than the plain
version's.  ``p1_config`` picks P1's block shape from the input's shape:
those choices are arithmetic and are held here; the kernel itself runs
only on the card (``chip_smoke.py`` phase 18).
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.models import tree as jax_tree

from lightgbm_tpu_torch.convert import tree_from_numpy
from lightgbm_tpu_torch.models import tree as port_tree
from lightgbm_tpu_torch.ops import cuda_predict

from test_torch_predict import KINDS, _data, _port, _queries, models  # noqa: F401

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "lightgbm_tpu_torch", "csrc", "predict.cu")


def _decode(node):
    """The record's fields: (split_feature, threshold, categorical,
    left_child, right_child)."""
    return (node[:, 0] & 0x7FFFFFFF, node[:, 1].view(torch.float32),
            node[:, 0] < 0, node[:, 2], node[:, 3])


def _assert_decodes(p):
    feat, thr, cat, left, right = _decode(p.node)
    assert p.node.shape == (p.split_feature.shape[0], 4)
    assert p.node.dtype == torch.int32
    np.testing.assert_array_equal(feat.numpy(), p.split_feature.numpy())
    np.testing.assert_array_equal(thr.view(torch.int32).numpy(),
                                  p.threshold.view(torch.int32).numpy())
    np.testing.assert_array_equal(cat.numpy(),
                                  (p.decision_type == 1).numpy())
    np.testing.assert_array_equal(p.decision_type.numpy(),
                                  cat.to(torch.uint8).numpy())
    np.testing.assert_array_equal(left.numpy(), p.left_child.numpy())
    np.testing.assert_array_equal(right.numpy(), p.right_child.numpy())
    nodes = (p.num_leaves - 1).numpy()
    np.testing.assert_array_equal(
        p.node_offset.numpy(), np.concatenate([[0], np.cumsum(nodes)]))
    assert p.max_tree_nodes == int(nodes.max(initial=0))


@pytest.mark.parametrize("kind", KINDS)
def test_node_record_decodes_to_the_arrays(models, kind):
    """Numerical, categorical, multiclass, one-leaf and mixed-budget
    ensembles: each record is exactly its node's five fields."""
    p = _port(models[kind])._gbdt._packed()
    _assert_decodes(p)
    if kind in ("categorical", "multiclass"):
        assert bool((p.node[:, 0] < 0).any())  # a categorical flag is set
    if kind == "stumps":
        assert p.node.shape[0] == 0 and p.max_tree_nodes == 0


def test_threshold_bits_are_kept(models):
    """The record keeps the threshold's bits: -0.0, the smallest
    subnormal, +-inf, float32 max and a NaN are neither rounded nor
    folded."""
    special = np.array([-0.0, 1e-45, np.inf, -np.inf,
                        np.finfo(np.float32).max, np.nan], np.float32)
    trees = list(_port(models["mixed"])._gbdt.models)
    t = trees[0]
    thr = t.threshold_real.clone()
    thr[:len(special)] = torch.from_numpy(special)
    trees[0] = t.replace(threshold_real=thr)
    p = port_tree.pack_trees(trees)
    _assert_decodes(p)
    np.testing.assert_array_equal(
        p.node[:len(special), 1].numpy(), special.view(np.int32))


def _jax_tree_dict(t):
    return {k: np.asarray(v) for k, v in t._asdict().items()}


def test_negative_split_feature_reads_column_zero(models):
    """A used node whose split feature is negative reads column 0, as the
    JAX walk's ``maximum(f, 0)``: its record holds 0, and the plain walk
    on the record's tables equals the JAX walk bitwise."""
    jb = models["binary"]
    trees = list(jb._gbdt.models)
    d = _jax_tree_dict(trees[1])
    sf = d["split_feature_real"].copy()
    sf[1] = -1  # a used internal node
    d["split_feature_real"] = sf
    bad = jax_tree.Tree(**{k: jnp.asarray(v) if k != "num_leaves" else v
                           for k, v in d.items()})
    port = [tree_from_numpy(_jax_tree_dict(t), "cpu") for t in trees]
    port[1] = tree_from_numpy(d, "cpu")
    p = port_tree.pack_trees(port)
    _assert_decodes(p)
    node1 = int(p.node_offset[1]) + 1
    assert int(p.node[node1, 0]) == 0
    Q = np.ascontiguousarray(_queries(_data()[0]), np.float32)
    want = np.asarray(jax_tree.predict_leaf_raw(bad, jnp.asarray(Q)))
    got = port_tree.ensemble_leaves_raw(p, torch.from_numpy(Q), len(port))
    np.testing.assert_array_equal(got[1].numpy(), want)
    assert (want != np.asarray(jax_tree.predict_leaf_raw(
        trees[1], jnp.asarray(Q)))).any()


def test_empty_ensemble_has_empty_records():
    p = port_tree.pack_trees([])
    assert p.node.shape == (0, 4) and p.node_offset.tolist() == [0]
    assert p.max_tree_nodes == 0


# ----------------------------------------------------------- configuration
SMS = 132  # an H100 SXM's streaming processors


def _source_constant(name):
    with open(CSRC) as fh:
        m = re.search(rf"constexpr int {name} = ([0-9 *]+);", fh.read())
    return eval(m.group(1))  # noqa: S307 — an integer product


def test_wrapper_constants_match_the_kernel():
    assert cuda_predict.THREADS == _source_constant("kThreads")
    assert cuda_predict.SMEM_BYTES == _source_constant("kSmemLimit")


@pytest.mark.parametrize("n", [1, 8, 128, 1024])
def test_small_batches_walk_one_tree_a_slot(n):
    """At serving's sizes every tree of the bench model (100 trees) has a
    slot of its own, so a row's chain is one tree deep."""
    rows, tiled, stage = cuda_predict.p1_config(n, 28, 100, 1, SMS, 254)
    assert cuda_predict.THREADS // rows >= 100
    assert tiled and stage == 0


@pytest.mark.parametrize("leaves", [False, True])
def test_large_batch_stages_records(leaves):
    rows, tiled, stage = cuda_predict.p1_config(1_000_000, 28, 100, 1, SMS,
                                                254, leaves)
    assert (rows, tiled, stage) == (cuda_predict.THREADS, True,
                                    cuda_predict.STAGE_RECORDS)
    # trees larger than a stage are read through L1, at fewer rows a block
    rows, tiled, stage = cuda_predict.p1_config(
        1_000_000, 28, 100, 1, SMS, cuda_predict.STAGE_RECORDS + 1, leaves)
    assert (rows, tiled, stage) == (cuda_predict.UNSTAGED_ROWS, True, 0)


@pytest.mark.parametrize("n,tiled", [(1024, True), (4096, False),
                                     (1_000_000, False)])
def test_wide_input_reads_x_from_global_memory(n, tiled):
    """F = 5,000: a tile of a few rows still fits; past that X is read
    from global memory (the wide configuration)."""
    rows, got, stage = cuda_predict.p1_config(n, 5000, 100, 1, SMS, 254)
    assert got == tiled and stage == 0


@pytest.mark.parametrize("n", [1, 100, 20_000, 1_000_000])
@pytest.mark.parametrize("F,T,K", [(28, 100, 1), (136, 10, 1), (28, 20, 5),
                                   (5000, 100, 1), (28, 1, 1),
                                   (28, 300, 100)])
@pytest.mark.parametrize("leaves", [False, True])
def test_every_configuration_fits(n, F, T, K, leaves):
    """Whatever the shape, the choice is a block shape the kernel takes:
    rows a divisor of the block, shared memory within the limit, records
    staged only in a tile of the block's full rows."""
    rows, tiled, stage = cuda_predict.p1_config(n, F, T, K, SMS, 254, leaves)
    assert cuda_predict.THREADS % rows == 0
    assert cuda_predict.smem_bytes(rows, F, K, tiled, leaves, stage) \
        <= cuda_predict.SMEM_BYTES
    assert not stage or (tiled and rows == cuda_predict.THREADS)


def test_cuda_wrappers_refuse_a_cpu_tensor(models):
    p = _port(models["binary"])._gbdt._packed()
    X = torch.zeros((4, 5), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_predict.ensemble_sum_cuda(p, X, p.num_trees, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_predict.ensemble_leaves_cuda(p, X, p.num_trees)
