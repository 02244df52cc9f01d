"""Kernel P2's wrapper (ops/cuda_predict_binned.py): it takes only CUDA
tensors and counts only the launches it makes; on the card it is bitwise
its plain version (models/tree.py ``binned_update_`` /
``binned_replay_``).  No JAX here: the card test's trees come from the
port's own CPU training (chip_smoke.py holds P2 at the bench shape)."""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.models import tree as pt
from lightgbm_tpu_torch.ops import cuda_predict_binned as P2
from lightgbm_tpu_torch.ops import predict as ops_predict


def _trees(K=1, max_bin=63, cat=False, stumps=False, n=800, seed=4):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[:, 1] = rng.randint(0, 5, n)
    z = X[:, 0] + X[:, 2] * (X[:, 1] == 2) + 0.3 * rng.randn(n)
    y = ((z > 0).astype(np.float32) if K == 1
         else np.digitize(z, [-0.5, 0.5]).astype(np.float32))
    params = {"objective": "binary" if K == 1 else "multiclass",
              "num_leaves": 15, "min_data_in_leaf": 5, "max_bin": max_bin,
              "verbose": -1}
    if K > 1:
        params["num_class"] = K
    if stumps:
        params["min_gain_to_split"] = 1e9
    ds = lt.Dataset(X, label=y, categorical_feature=[1] if cat else None,
                    device="cpu")
    bst = lt.train(params, ds, 4, device="cpu")
    return bst._gbdt.models, bst._gbdt._bins_T


def test_wrapper_takes_only_cuda_tensors():
    trees, bins = _trees()
    table = pt.binned_table(trees)
    scores = torch.zeros(1, bins.shape[1])
    before = P2.LAUNCHES
    with pytest.raises((ValueError, RuntimeError)):
        P2.binned_update_cuda_(scores, table, bins, [0] * len(trees),
                               [1.0] * len(trees))
    with pytest.raises((ValueError, RuntimeError)):
        P2.binned_replay_cuda_(scores, table, bins, 1, 2)
    assert P2.LAUNCHES == before
    # the dispatcher sends a CPU tensor to the plain version
    ops_predict.ensemble_update_binned_(scores, table, bins,
                                        [0] * len(trees), [1.0] * len(trees))
    assert P2.LAUNCHES == before and bool(scores.abs().sum() > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["u8", "u16", "categorical", "stumps",
                                  "multiclass"])
def test_kernel_matches_plain_on_card(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")
    K = 3 if kind == "multiclass" else 1
    trees, bins = _trees(K=K, max_bin=300 if kind == "u16" else 63,
                         cat=kind in ("categorical", "multiclass"),
                         stumps=kind == "stumps")
    assert (bins.dtype == torch.uint16) == (kind == "u16")
    T = len(trees)
    init = torch.from_numpy(
        np.random.RandomState(1).randn(K, bins.shape[1]).astype(np.float32))
    classes = [t % K for t in range(T)]
    scales = [(1.0, -1.0, 2 / 3, 2 / 3 - 1)[t % 4] for t in range(T)]
    want = pt.binned_update_(init.clone(), pt.binned_table(trees), bins,
                             classes, scales)
    gtrees = [t.replace(**{f: getattr(t, f).cuda() for f in pt.TREE_FIELDS})
              for t in trees]
    table = pt.binned_table(gtrees)
    before = P2.LAUNCHES
    got = P2.binned_update_cuda_(init.cuda(), table, bins.cuda(), classes,
                                 scales)
    again = P2.binned_update_cuda_(init.cuda(), table, bins.cuda(), classes,
                                   scales)
    torch.cuda.synchronize()
    assert P2.LAUNCHES == before + 2
    assert torch.equal(got, again)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    rwant = pt.binned_replay_(init.clone(), pt.binned_table(trees), bins, K,
                              2)
    rgot = P2.binned_replay_cuda_(init.cuda(), table, bins.cuda(), K, 2)
    np.testing.assert_array_equal(rgot.cpu().numpy(), rwant.numpy())
