"""The port's analytic memory model (obs/memmodel.py) and the training
dispatch's obs hooks against the JAX package's.

* The components both packages model (raw_input, dataset, scores,
  bag_mask, grad_hess, serving) are bitwise ``lightgbm_tpu.obs.memmodel
  .predict``'s on a grid of shapes: rows, features, bins across 256,
  classes, world, forest batch, float64 and serving buckets; the JAX
  routings (``prefix``, ``onehot``, ``order``) are accepted.
* The port's own components mirror the buffers' sources (the record's
  height, the chunk and tile sizes, ``scratch_shape``, ForestStep's
  constants).
* The JAX package's census test, on a CPU booster: the ``dataset`` and
  ``scores`` owners (``GBDT.reset_training_data``) agree with the model
  within max(20 %, 8 KiB); its shape, monotonicity and tolerance tests.
* ``oom_dispatch`` at ``train_one_iter`` leaves a flight-recorder dump
  whose tail is ``oom`` with the census (a ``dataset`` owner) and the
  prediction; ``oom.train`` goes up by one; the booster trains on after.
* A trained booster counts ``train_iters`` and fills ``tree_dispatch_s``,
  and the CLI's manifest carries it as ``per_tree``.
"""

import gc
import json
import os

import numpy as np
import pytest

from lightgbm_tpu.obs import memmodel as jmm

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import cli
from lightgbm_tpu_torch.obs import flightrec, memmodel, memory, telemetry
from lightgbm_tpu_torch.ops import cuda_forest, cuda_histogram, histogram
from lightgbm_tpu_torch.ops import record as rec_ops
from lightgbm_tpu_torch.resilience import faults

SHARED = ("raw_input", "dataset", "scores", "bag_mask", "grad_hess",
          "serving")

GRID = [
    dict(rows=1, features=1),
    dict(rows=2048, features=4, bins=255, leaves=7),
    dict(rows=4096, features=8, bins=63, leaves=15),
    dict(rows=123457, features=28, bins=256, leaves=255),
    dict(rows=123457, features=28, bins=257, leaves=255),
    dict(rows=10 ** 6, features=28, bins=255, leaves=255, num_class=5),
    dict(rows=10 ** 6, features=136, bins=1024, leaves=31, world=4),
    dict(rows=999_999, features=28, bins=255, world=3, forest_batch=8),
    dict(rows=2048, features=28, num_class=3, forest_batch=4),
    dict(rows=10 ** 6, features=28, hist_prec="float64"),
    dict(rows=50_000, features=10, hist_prec="float64", world=2,
         forest_batch=2, num_class=2),
    dict(rows=10 ** 5, features=28, bucket_rows=(8, 32, 128, 1024)),
    dict(rows=10 ** 5, features=28, num_class=4, bucket_rows=(1, 64)),
]


def _ids(cases):
    return ["-".join(f"{k}={v}" for k, v in c.items()) for c in cases]


@pytest.mark.parametrize("routing", ["prefix", "onehot", "order"])
@pytest.mark.parametrize("case", GRID, ids=_ids(GRID))
def test_shared_components_bitwise_jax(case, routing):
    got = memmodel.predict(routing=routing, **case)
    want = jmm.predict(routing=routing, **case)
    for c in SHARED:
        assert got["components"][c] == want["components"][c], c
    assert got["schema"] == want["schema"]
    assert got["params"]["rows_per_shard"] == \
        want["params"]["rows_per_shard"]
    assert got["phases"]["binning"] == want["phases"]["binning"]
    assert set(got["phases"]) == set(memmodel.PHASES) == set(jmm.PHASES)
    assert got["peak_bytes"] == max(got["phases"].values())


def test_tolerance_constants_are_jax():
    assert memmodel.TOLERANCE_PCT == jmm.TOLERANCE_PCT
    assert memmodel.TOLERANCE_ABS_BYTES == jmm.TOLERANCE_ABS_BYTES
    assert memmodel.SCHEMA == jmm.SCHEMA


def test_constants_mirror_the_buffers():
    assert memmodel._CHUNK_ROWS == histogram.CHUNK_ROWS
    assert memmodel._GROUP_CHUNKS == histogram.GROUP_CHUNKS
    assert memmodel._TILE == rec_ops.TILE
    assert (memmodel._FOREST_INFO, memmodel._FOREST_STEP,
            memmodel._FOREST_BEST) == (cuda_forest.INFO_INTS,
                                       cuda_forest.STEP_INTS,
                                       cuda_forest._PER_FEATURE)
    for F, bins in ((28, 255), (5, 256), (136, 257), (1, 1024)):
        bb = 1 if bins <= 256 else 2
        assert memmodel._rec_height(F, bb) == rec_ops.rec_height(
            F, 4 if bb == 1 else 2)
    csrc = os.path.join(os.path.dirname(cuda_forest.__file__), "..", "csrc")
    for name, const in (("histogram.cu", "kWalkMinChunks = "
                         f"{memmodel._F64_WALK_CHUNKS};"),
                        ("forest.cu", "kTileThreads = "
                         f"{memmodel._FOREST_TILE_THREADS};")):
        with open(os.path.join(csrc, name), encoding="utf-8") as fh:
            assert const in fh.read(), (name, const)


@pytest.mark.parametrize("cnt", [1, 2048, 2049, 131_072, 10 ** 6])
def test_single_hist_is_scratch_shape(cnt):
    F, nb = 28, 255
    cells = F * nb * 3
    for f64, hb in ((False, 4), (True, 8)):
        group = (histogram.GROUP_CHUNKS
                 if f64 and -(-cnt // histogram.CHUNK_ROWS)
                 >= memmodel._F64_WALK_CHUNKS else 1)
        parts = cuda_histogram.scratch_shape(F, cnt, nb, group)
        want = (int(np.prod(parts)) + cells) * hb
        assert memmodel._single_hist(cnt, cells, hb, f64) == want


def test_port_routes_model_their_buffers():
    n, F, nb, L = 10 ** 6, 28, 255, 255
    cells = F * nb * 3
    kw = dict(rows=n, features=F, bins=nb, leaves=L)
    W = rec_ops.rec_height(F, 4)
    mega = memmodel.predict(routing="mega", **kw)["components"]
    rec = memmodel.predict(routing="record", **kw)["components"]
    order = memmodel.predict(routing="order", **kw)["components"]
    assert mega["routing"] == rec["routing"] == W * n * 4
    assert order["routing"] == n * 8
    run = -(-n // rec_ops.TILE) * (W - 1) * 2 * rec_ops.TILE * 4
    assert rec["partition"] == run
    assert mega["partition"] == run + -(-n // histogram.CHUNK_ROWS) \
        * cells * 4
    assert mega["histograms"] == L * cells * 4
    # JAX's prefix routing is the port's record route
    assert memmodel.predict(routing="prefix", **kw)["components"] == rec
    pooled = memmodel.predict(routing="order", pool_slots=48, **kw)
    assert pooled["components"]["histograms"] == 48 * cells * 4
    f64 = memmodel.predict(routing="mega", hist_prec="float64", **kw)
    assert f64["components"]["histograms"] == L * cells * 8
    # float64 grows on the order route
    assert f64["components"]["routing"] == n * 8
    forest = memmodel.predict(routing="order", forest_batch=4, **kw)
    assert forest["components"]["histograms"] == 4 * L * cells * 4
    assert forest["components"]["routing"] == 4 * n * 4
    assert forest["components"]["forest_step"] > 0
    lanes = memmodel.predict(routing="forest", num_class=5, **kw)
    assert lanes["components"]["histograms"] == 5 * L * cells * 4
    # hybrid's best-first splits take the order route; a depthwise level
    # pass covers every leaf so far, at most L - 1
    hybrid = memmodel.predict(routing="mega", growth="hybrid", **kw)
    assert hybrid["components"]["routing"] == n * 8
    depth = memmodel.predict(growth="depthwise", **kw)["components"]
    assert depth["histograms"] == (L - 1) * cells * 4
    assert depth["search_scratch"] == 7 * depth["histograms"]
    with pytest.raises(ValueError):
        memmodel.predict(routing="nope", **kw)
    with pytest.raises(ValueError):
        memmodel.predict(growth="nope", **kw)


def test_training_peak_and_limiting_component():
    pred = memmodel.predict(rows=10 ** 6, features=28, leaves=255,
                            routing="mega")
    phase, peak = memmodel.training_peak(pred)
    assert phase == "partition" and peak == pred["phases"]["partition"]
    name, nbytes = memmodel.limiting_component(pred)
    assert name in pred["components"]
    assert nbytes == max(pred["components"][c]
                         for c in memmodel._LIVE[pred["peak_phase"]])


# --------------------------------------------- the JAX package's tests

def _make_booster(n=2048, F=4, bins=255, leaves=7, iters=1, seed=3,
                  **extra):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    y = (X[:, 0] > 0).astype(np.float32)
    params = dict(objective="binary", num_leaves=leaves, max_bin=bins,
                  min_data_in_leaf=5, verbose=-1, **extra)
    ds = lt.Dataset(X, label=y, params=params, device="cpu")
    return lt.train(params, ds, iters, device="cpu")


MEMMODEL_SHAPES = (
    dict(n=2048, F=4, bins=255, leaves=7),
    dict(n=4096, F=8, bins=63, leaves=15),
    dict(n=8192, F=16, bins=63, leaves=15),
)


@pytest.mark.parametrize("shape", MEMMODEL_SHAPES,
                         ids=[f"n{s['n']}_F{s['F']}_b{s['bins']}"
                              for s in MEMMODEL_SHAPES])
def test_memmodel_agrees_with_census(shape):
    """The model's dataset and scores components match the census of the
    booster's owners within max(20 %, 8 KiB)."""
    gc.collect()
    bst = _make_booster(n=shape["n"], F=shape["F"], bins=shape["bins"],
                        leaves=shape["leaves"])
    try:
        census = memory.live_buffer_census()["by_owner"]
        pred = memmodel.predict(rows=shape["n"], features=shape["F"],
                                bins=shape["bins"], leaves=shape["leaves"])
        comp = pred["components"]
        meas_ds = census["dataset"]["bytes"]
        assert memmodel.within_tolerance(comp["dataset"], meas_ds), (
            f"dataset: model {comp['dataset']} vs census {meas_ds}")
        meas_sc = census["scores"]["bytes"]
        model_sc = comp["scores"] + comp["bag_mask"]
        assert memmodel.within_tolerance(model_sc, meas_sc), (
            f"scores: model {model_sc} vs census {meas_sc}")
        # the booster's own shape, in the model's terms
        params = bst._gbdt._memmodel_params()
        assert params["routing"] == "order" and params["rows"] == shape["n"]
        assert memmodel.predict(**params)["components"]["dataset"] == \
            comp["dataset"]
    finally:
        del bst


def test_dropped_booster_leaves_the_census():
    gc.collect()
    base = memory.live_buffer_census()["by_owner"].get(
        "dataset", {}).get("bytes", 0)
    bst = _make_booster(n=4096, F=8)
    assert memory.live_buffer_census()["by_owner"]["dataset"]["bytes"] > base
    del bst
    gc.collect()
    assert memory.live_buffer_census()["by_owner"].get(
        "dataset", {}).get("bytes", 0) == base


def test_memmodel_shapes_and_monotonicity():
    pred = memmodel.predict(rows=10 ** 6, features=100, bins=255,
                            leaves=255)
    assert pred["schema"] == memmodel.SCHEMA
    assert set(pred["phases"]) == set(memmodel.PHASES)
    assert pred["peak_bytes"] == max(pred["phases"].values())
    smaller = memmodel.predict(rows=10 ** 5, features=100, bins=255,
                               leaves=255)
    assert smaller["peak_bytes"] < pred["peak_bytes"]
    params = dict(features=100, bins=255, leaves=255)
    assert memmodel.max_rows(2 ** 34, **params) > \
        memmodel.max_rows(2 ** 30, **params)
    sharded = memmodel.predict(rows=10 ** 6, features=100, bins=255,
                               leaves=255, world=8)
    assert sharded["peak_bytes"] < pred["peak_bytes"]
    fb = dict(rows=10 ** 6, features=28, leaves=255)
    assert memmodel.max_forest_batch(2 ** 33, **fb) > \
        memmodel.max_forest_batch(2 ** 30, **fb) >= 1
    curve = memmodel.rows_curve(2 ** 32, [10 ** 6, 10 ** 9], **params)
    assert [p["fits"] for p in curve["points"]] == [True, False]
    assert curve["wall"]["limiting_component"] in curve["wall"]["components"]


def test_memmodel_tolerance_predicate():
    assert memmodel.within_tolerance(100, 100)
    assert memmodel.within_tolerance(0, 8192)
    assert memmodel.within_tolerance(119, 100)
    assert not memmodel.within_tolerance(130_000, 100_000)
    assert memmodel.within_tolerance(119_000, 100_000)


def test_classify_dispatch_error_is_oom_only():
    assert memory.classify_dispatch_error(
        ValueError("shape mismatch"), "train.dispatch") is None
    ev = memory.classify_dispatch_error(
        RuntimeError("RESOURCE_EXHAUSTED: out of memory allocating "
                     "1073741824 bytes"),
        "train.dispatch", predict_params=dict(rows=4096, features=8))
    assert ev is not None and ev["where"] == "train.dispatch"
    assert ev["predicted_peak_bytes"] == memmodel.predict(
        rows=4096, features=8)["peak_bytes"]


def test_injected_oom_at_train_dispatch_leaves_postmortem(tmp_path):
    bst = _make_booster()
    flightrec.set_dump_dir(str(tmp_path))
    flightrec.reset()
    before = telemetry.get_telemetry().snapshot()["counters"].get(
        "oom.train", 0)
    faults.set_fault("oom_dispatch")
    try:
        with pytest.raises(faults.InjectedResourceExhausted,
                           match="RESOURCE_EXHAUSTED"):
            bst.update()
    finally:
        faults.clear_faults()
        flightrec.set_dump_dir(None)
    after = telemetry.get_telemetry().snapshot()["counters"].get(
        "oom.train", 0)
    assert after == before + 1
    dumps = [f for f in os.listdir(tmp_path)
             if f.startswith("flightrec_") and f.endswith(".json")]
    assert dumps, "no flight-recorder dump after the injected OOM"
    with open(tmp_path / dumps[0]) as fh:
        rec = json.load(fh)
    assert rec["reason"] == "oom"
    tail = rec["events"][-1]
    assert tail["kind"] == "oom" and tail["where"] == "train.dispatch"
    assert tail["census"]["total_bytes"] > 0
    assert "dataset" in tail["census"]["by_owner"]
    params = bst._gbdt._memmodel_params()
    assert tail["shape"] == params
    assert tail["predicted_peak_bytes"] == \
        memmodel.predict(**params)["peak_bytes"]
    assert tail["predicted_phases"] == memmodel.predict(**params)["phases"]
    # the fault consumed itself: the next iteration trains
    trees = bst.num_trees()
    bst.update()
    assert bst.num_trees() == trees + 1


def test_memmodel_params_name_the_route():
    assert _make_booster()._gbdt._memmodel_params()["routing"] == "order"
    pooled = _make_booster(histogram_pool_size=0.01)._gbdt
    assert pooled._memmodel_params()["pool_slots"] == \
        pooled._hist_pool_slots() > 0
    rng = np.random.RandomState(0)
    X = rng.randn(600, 4)
    y = rng.randint(0, 3, 600).astype(np.float32)
    params = dict(objective="multiclass", num_class=3, num_leaves=7,
                  verbose=-1, forest_batching="on")
    mc = lt.train(params, lt.Dataset(X, label=y, device="cpu"), 1,
                  device="cpu")._gbdt
    got = mc._memmodel_params()
    assert got["routing"] == "forest" and got["num_class"] == 3
    assert got["growth"] == "leafwise" and got["hist_prec"] == "float32"
    depth = _make_booster(tree_growth="depthwise")._gbdt._memmodel_params()
    assert (depth["routing"], depth["growth"]) == ("order", "depthwise")


def test_train_iters_and_dispatch_reservoir():
    tel = telemetry.get_telemetry()
    base = tel.snapshot()["counters"].get("train_iters", 0)
    before = (tel.reservoir("tree_dispatch_s").as_dict().get("count", 0)
              if tel.reservoir("tree_dispatch_s") else 0)
    _make_booster(iters=3)
    assert tel.snapshot()["counters"]["train_iters"] - base == 3
    res = tel.reservoir("tree_dispatch_s").as_dict()
    assert res["count"] - before == 3 and res["p50_s"] > 0


def test_cli_manifest_has_per_tree(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = np.random.RandomState(0)
    X = rng.randn(800, 5)
    np.savetxt("d.csv", np.column_stack([X[:, 0] > 0, X]), fmt="%.6g",
               delimiter=",")
    assert cli.main(["data=d.csv", "objective=binary", "num_trees=3",
                     "num_leaves=7", "output_model=m.txt"],
                    device="cpu") == 0
    with open("m.txt.manifest.json") as fh:
        man = json.load(fh)
    assert man["per_tree"]["count"] >= 3 and man["per_tree"]["p50_s"] > 0
    assert man["phases"] == {}  # no profile=true
