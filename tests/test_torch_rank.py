"""LambdaRank: the port's DCG helpers, its LambdarankNDCG objective, its
NDCG metric, query-granular bagging, the query fields of its Dataset and
its trees against the JAX package's.

The gradients are held to ``_lambdarank_grads`` at rtol 1e-5 / atol 1e-7:
rows of buckets of 64 and more are the JAX package's bit for bit (the port
sums the pair terms in XLA's CPU order); in buckets of 16 and 32 XLA fuses
the pair terms into its reduction and rounds some of them otherwise.  So
trees are held structurally equal on data whose queries all have more
than 32 rows: every gradient, so every histogram input, is then the JAX
package's, and the trees differ only where the histogram's own float32
summation order does, as in tests/test_torch_slice.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu.dcg as jax_dcg
import lightgbm_tpu.engine as jax_engine
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.io.metadata import Metadata as JaxMetadata
from lightgbm_tpu.metrics_rank import NDCGMetric as JaxNDCG
from lightgbm_tpu.models.gbdt import GBDT as JaxGBDT
from lightgbm_tpu.objectives_rank import LambdarankNDCG as JaxLambdarank

import lightgbm_tpu_torch as lt
import lightgbm_tpu_torch.dcg as port_dcg
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.metrics_rank import NDCGMetric
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.objectives_rank import LambdarankNDCG

from test_torch_objectives import assert_same_trees

PARAMS = {"objective": "lambdarank", "min_data_in_leaf": 20,
          "hist_impl": "matmul", "tree_growth": "leafwise", "num_leaves": 15,
          "verbose": -1}


def _rank_data(sizes, seed=29, F=6):
    """Graded labels 0-4 by within-query quantile of a latent score (the
    generator of tools/bench_lambdarank.py at a small size)."""
    rng = np.random.RandomState(seed)
    sizes = np.asarray(sizes, np.int64)
    n = int(sizes.sum())
    X = rng.randn(n, F)
    score = X @ rng.randn(F) + 0.5 * rng.randn(n)
    y = np.zeros(n, np.float32)
    start = 0
    for s in sizes:
        q = score[start:start + s]
        ranks = np.searchsorted(np.sort(q), q) / max(s - 1, 1)
        y[start:start + s] = np.clip((ranks * 5).astype(int), 0, 4)
        start += s
    return X, y, sizes


def _skewed_sizes(seed=3):
    """Sizes 1-69 (buckets 16, 32, 64 and 128), the bounds 16/17 and 32/33
    themselves, and two queries of 2,100 and 3,000 rows: their bucket of
    4,096 holds one query a chunk (2^24 / 4096^2), so it runs in two."""
    rng = np.random.RandomState(seed)
    sizes = np.concatenate([rng.randint(1, 70, 60), [2100, 3000],
                            [16, 17, 32, 33]])
    rng.shuffle(sizes)
    return sizes


def test_dcg_functions_equal():
    labels = np.random.RandomState(0).randint(0, 5, 37)
    for name in ("K_MAX_POSITION", "_MAX_LABEL"):
        assert getattr(port_dcg, name) == getattr(jax_dcg, name)
    np.testing.assert_array_equal(port_dcg.default_label_gains(),
                                  jax_dcg.default_label_gains())
    for lg in ([], [0.0, 1.0, 3.0, 7.0, 15.0], [0.5, 2.0, 9.0, 9.5, 30.0]):
        gains = port_dcg.label_gains_from_config(lg)
        np.testing.assert_array_equal(gains,
                                      jax_dcg.label_gains_from_config(lg))
        for k in (1, 3, 10, 100):
            assert port_dcg.max_dcg_at_k(k, labels, gains) == \
                jax_dcg.max_dcg_at_k(k, labels, gains)
            assert port_dcg.dcg_at_k(k, labels, gains) == \
                jax_dcg.dcg_at_k(k, labels, gains)
    for n in (1, 16, 1250):
        np.testing.assert_array_equal(port_dcg.position_discounts(n),
                                      jax_dcg.position_discounts(n))
    qb = np.concatenate([[0], np.cumsum([3, 1, 7, 2])])
    for a, b in zip(port_dcg.build_padded_query_layout(qb, 13),
                    jax_dcg.build_padded_query_layout(qb, 13)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("weighted", [False, True])
def test_lambdarank_gradients_match_jax(weighted):
    sizes = _skewed_sizes()
    qb = np.concatenate([[0], np.cumsum(sizes)])
    n = int(qb[-1])
    rng = np.random.RandomState(5)
    y = rng.randint(0, 5, n).astype(np.float32)
    y[qb[3]:qb[4]] = 0  # a query with no positive label
    s = (rng.randn(n) * 2).astype(np.float32)
    s[:30] = 0.5  # tied scores
    w = rng.rand(n).astype(np.float32) if weighted else None
    meta = JaxMetadata(label=y, weights=w, query_boundaries=qb)
    ref = JaxLambdarank(JaxConfig(objective="lambdarank"))
    ref.init(meta, n)
    ours = LambdarankNDCG(Config(objective="lambdarank"))
    ours.init(meta, n, "cpu")
    bounds = [int(b["pad_idx"].shape[1]) for b in ours._buckets]
    assert bounds == [16, 32, 64, 128, 4096]
    assert [b["chunk"] for b in ours._buckets][-1] == 1
    gj, hj = (np.asarray(a) for a in ref.get_gradients(jnp.asarray(s)))
    g, h = (a.numpy() for a in ours.get_gradients(torch.from_numpy(s)))
    np.testing.assert_allclose(g, gj, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(h, hj, rtol=1e-5, atol=1e-7)
    big = np.repeat(sizes > 32, sizes)  # rows of buckets of 64 and more
    np.testing.assert_array_equal(g[big], gj[big])
    np.testing.assert_array_equal(h[big], hj[big])


def test_lambdarank_needs_query_information():
    X, y, _ = _rank_data([20, 30])
    with pytest.raises(ValueError, match="query information"):
        lt.train(dict(PARAMS), lt.Dataset(X, label=y, device="cpu"), 1,
                 device="cpu")


@pytest.mark.parametrize("layout", ["padded", "per-query", "weighted"])
def test_ndcg_matches_jax(layout):
    """The padded path, the per-query fallback (one giant query among
    small ones makes nq * Q exceed 8n), query weights, and queries with no
    positive label (NDCG 1)."""
    sizes = {"padded": [5, 9, 1, 30, 12, 7],
             "per-query": [3] * 40 + [400],
             "weighted": [5, 9, 1, 30, 12, 7]}[layout]
    X, y, sizes = _rank_data(sizes)
    qb = np.concatenate([[0], np.cumsum(sizes)])
    y[qb[1]:qb[2]] = 0
    w = (np.random.RandomState(2).rand(len(y)).astype(np.float32)
         if layout == "weighted" else None)
    s = np.random.RandomState(4).randn(len(y))
    s[:6] = 1.0  # ties
    cfg = dict(ndcg_eval_at=[1, 3, 5, 10])
    meta = JaxMetadata(label=y, weights=w, query_boundaries=qb)
    ref = JaxNDCG(JaxConfig(**cfg))
    ref.init(meta, len(y))
    ours = NDCGMetric(Config(**cfg))
    ours.init(meta, len(y))
    assert ours._use_padded == (layout != "per-query")
    want = ref.eval_multi(s)
    got = ours.eval_multi(s)
    assert len(got) == 4
    for a, b in zip(got, want):
        assert a == pytest.approx(b, rel=1e-6)


def test_query_bagging_masks_bitwise():
    """gbdt.py:523-531: floor(nq * fraction) whole queries drawn with the
    bagging RNG every bagging_freq iterations, mask for mask."""
    X, y, sizes = _rank_data([5, 40, 17, 3, 66, 21, 9, 30])
    qb = np.concatenate([[0], np.cumsum(sizes)])
    cfg = dict(objective="lambdarank", bagging_fraction=0.6, bagging_freq=2,
               bagging_seed=11)
    jd = lgb.Dataset(X, label=y, group=sizes).construct()
    pd_ = lt.Dataset(X, label=y, group=sizes, device="cpu").construct()
    np.testing.assert_array_equal(pd_.metadata.query_boundaries, qb)
    jg, pg = JaxGBDT(JaxConfig(**cfg), jd), GBDT(Config(**cfg), pd_,
                                                 device="cpu")
    for it in range(6):
        jg.iter_ = pg.iter_ = it
        jg._update_bagging()
        pg._update_bagging()
        mask = pg._bag_mask.numpy()
        np.testing.assert_array_equal(mask, np.asarray(jg._bag_mask))
        kept = np.add.reduceat(mask, qb[:-1])
        assert sorted(set(kept / sizes)) == [0.0, 1.0]  # whole queries
        assert int((kept > 0).sum()) == int(len(sizes) * 0.6)


@pytest.fixture(scope="module")
def rank_pair():
    """Every query has 33-120 rows: every gradient is the JAX package's
    bit for bit (buckets of 64 and 128)."""
    rng = np.random.RandomState(7)
    X, y, sizes = _rank_data(rng.randint(33, 121, 14))
    Xv, yv, sv = _rank_data(rng.randint(33, 121, 6), seed=30)
    params = dict(PARAMS, bagging_fraction=0.7, bagging_freq=1,
                  ndcg_eval_at=[1, 3, 5])
    dj = lgb.Dataset(X, label=y, group=sizes, max_bin=63)
    bj = jax_engine.train(dict(params), dj, num_boost_round=3,
                          valid_sets=[dj.create_valid(Xv, label=yv,
                                                      group=sv)],
                          valid_names=["va"], verbose_eval=False)
    dt = lt.Dataset(X, label=y, group=sizes, max_bin=63, device="cpu")
    bt = lt.train(dict(params), dt, num_boost_round=3,
                  valid_sets=[dt.create_valid(Xv, label=yv, group=sv)],
                  valid_names=["va"], device="cpu")
    return X, bj, bt


def test_rank_trees_match_jax(rank_pair):
    _, bj, bt = rank_pair
    assert_same_trees(bj._gbdt.models, bt._gbdt.models)


@pytest.mark.parametrize("which", ["eval_train", "eval_valid"])
def test_rank_eval_reports_each_position(rank_pair, which):
    """basic.py:474-476: one ndcg@k per ndcg_eval_at position."""
    _, bj, bt = rank_pair
    ref, ours = getattr(bj, which)(), getattr(bt, which)()
    assert [r[1] for r in ours] == ["ndcg@1", "ndcg@3", "ndcg@5"]
    assert [r[:2] + r[3:] for r in ours] == [r[:2] + r[3:] for r in ref]
    for a, b in zip(ours, ref):
        assert a[2] == pytest.approx(b[2], rel=1e-6)


def test_rank_model_text(rank_pair):
    X, bj, bt = rank_pair
    text = bj.model_to_string()
    assert "objective=lambdarank" in text
    loaded = lt.Booster(model_str=text, device="cpu")
    np.testing.assert_allclose(loaded.predict(X), bj.predict(X), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5)


def test_dataset_group_fields():
    """set_field / get_field("group") before and after construction, as
    the JAX package's Dataset has them (group sizes in, sizes out)."""
    X, y, sizes = _rank_data([4, 6, 5])
    ours = lt.Dataset(X, label=y, device="cpu")
    ref = lgb.Dataset(X, label=y)
    for d in (ours, ref):
        d.set_field("group", sizes)
    np.testing.assert_array_equal(ours.get_field("group"),
                                  ref.get_field("group"))
    ours.construct()
    ref.construct()
    np.testing.assert_array_equal(ours.get_field("group"), sizes)
    np.testing.assert_array_equal(ours.get_field("query"),
                                  ref.get_field("query"))
    for d in (ours, ref):
        d.set_field("group", [7, 8])
    np.testing.assert_array_equal(ours.get_field("group"), [7, 8])
    np.testing.assert_array_equal(ours.construct().metadata.query_boundaries,
                                  ref.construct().metadata.query_boundaries)


@pytest.mark.cuda
def test_card_lambdarank_gradients_match_plain():
    """Every op is elementwise in a fixed order, so the card is expected
    to give the plain version's bits; held to rtol 1e-5 / atol 1e-7."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's LambdaRank phase "
                    "runs this check there)")
    sizes = _skewed_sizes()
    qb = np.concatenate([[0], np.cumsum(sizes)])
    n = int(qb[-1])
    rng = np.random.RandomState(8)
    meta = JaxMetadata(label=rng.randint(0, 5, n).astype(np.float32),
                       query_boundaries=qb)
    s = torch.from_numpy((rng.randn(n) * 2).astype(np.float32))
    out = []
    for dev in ("cuda", "cpu"):
        obj = LambdarankNDCG(Config(objective="lambdarank"))
        obj.init(meta, n, dev)
        out.append([t.cpu() for t in obj.get_gradients(s.to(dev))])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
