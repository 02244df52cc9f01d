"""The port's trace phases (obs/device_time.py) against the JAX package's.

* ``classify_event`` agrees with ``lightgbm_tpu.obs.device_time``'s on the
  event names of the JAX package's bucketing test.
* Fixed synthetic ``torch.profiler`` traces bucket to stated seconds: a
  ``gpu_user_annotation`` scope (nested scopes: the innermost), kernels
  by name, a copy, a memset, host events dropped, two devices.
* A real CPU ``torch.profiler`` trace of a training run has no device
  seconds; ``phase_scope`` records ``lgbm.<phase>`` only under a
  profiler.
* Every ``__global__`` kernel of ``lightgbm_tpu_torch/csrc`` has a phase.
* ``load_trace_events`` reads one file, or the newest under a directory
  (gzip too); the CLI's ``profile=true`` writes its trace's phases.
"""

import gzip
import json
import os
import re
import time

import numpy as np
import pytest

from lightgbm_tpu.obs import device_time as jdt

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import cli
from lightgbm_tpu_torch.obs import device_time as dt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "lightgbm_tpu_torch", "csrc")

# the names of the JAX package's tests/test_telemetry.py
# test_bucket_events_by_scope_and_kernel_name
JAX_TEST_NAMES = [
    ("fusion.7", "jit(f)/lgbm.histogram/dot_general"),
    ("fusion.8", "jit(f)/lgbm.split_search/reduce"),
    ("split_step_kernel", ""),
    ("copy.3", "copy.3"),
    ("$builtins isinstance", ""),
    ("x", "lgbm.leaf_update/add"),
    ("lgbm.histogram/host-noise", ""),
    ("whatever", "lgbm.predict/dot"),
    ("unrelated.op", ""),
]


@pytest.mark.parametrize("name,long_name", JAX_TEST_NAMES)
def test_classify_event_agrees_with_jax(name, long_name):
    assert dt.classify_event(name, long_name) == \
        jdt.classify_event(name, long_name)


def test_phases_and_scopes_are_jax():
    assert dt.PHASES == jdt.PHASES
    assert dt.SCOPE_TO_PHASE == jdt.SCOPE_TO_PHASE
    assert set(dt.KERNEL_PHASES.values()) <= set(dt.PHASES)


def _ev(cat, name, ts, dur, pid=0, tid=7):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur}


# a torch.profiler Chrome trace's shapes: device events on the card's pid
# (stream tid), the GPU ranges of record_function, host events
TRACE = [
    {"ph": "M", "name": "process_name", "pid": 0,
     "args": {"name": "python"}},
    _ev("cpu_op", "aten::index_put_", 10, 400, pid=4242, tid=4242),
    _ev("user_annotation", "lgbm.partition", 10, 500, pid=4242, tid=4242),
    _ev("cuda_runtime", "cudaLaunchKernel", 11, 5, pid=4242, tid=4242),
    _ev("gpu_user_annotation", "lgbm.leaf_update", 100, 60),
    _ev("gpu_user_annotation", "lgbm.partition", 110, 20),
    # inside leaf_update only
    _ev("kernel", "void at::native::vectorized_elementwise_kernel<4>()",
        102, 3),
    # inside both: the innermost (partition) wins
    _ev("kernel", "void at::native::index_put_kernel_impl<8>()", 115, 10),
    # a scope overrides the kernel's own name
    _ev("kernel", "void p2_rows_kernel(Args)", 150, 5),
    # by name
    _ev("kernel", "void split_step_kernel<unsigned char>(StepArgs)",
        200, 700),
    _ev("kernel", "void place_kernel(int const*, long)", 950, 40),
    _ev("kernel", "void sorted_partial_kernel<Rows, float>(Rows, Chunks)",
        1000, 30),
    _ev("kernel", "void hist_reduce_kernel<float>(float const*, int)",
        1040, 8),
    _ev("kernel", "void search2_kernel<float>(float const*)", 1050, 12),
    _ev("kernel", "void p1_kernel(Args)", 1100, 9),
    # no scope, no name: unattributed (the copy and the memset too)
    _ev("kernel", "void at::native::reduce_kernel<512, 1>()", 1200, 6),
    _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1300, 4),
    _ev("gpu_memset", "Memset (Device)", 1310, 2),
    # another device: the range of device 0 does not cover it
    _ev("kernel", "void at::native::reduce_kernel<512, 1>()", 105, 50,
        pid=1),
]


def test_bucket_synthetic_trace():
    out = dt.bucket_events(TRACE)
    assert out == {
        "leaf-update": pytest.approx(3e-6 + 5e-6),
        "partition": pytest.approx(10e-6 + 700e-6 + 40e-6),
        "histogram": pytest.approx(38e-6),
        "split-search": pytest.approx(12e-6),
        "predict": pytest.approx(9e-6),
        "unattributed": pytest.approx(6e-6 + 4e-6 + 2e-6 + 50e-6),
    }
    assert sum(out.values()) == pytest.approx(dt.device_seconds(TRACE))
    kernels = dt.bucket_events(TRACE, cats=("kernel",))
    assert "unattributed" in kernels
    assert sum(kernels.values()) == pytest.approx(
        dt.device_seconds(TRACE, cats=("kernel",)))
    assert dt.bucket_events(TRACE[:4]) == {}


def test_real_cpu_trace_has_no_device_seconds(tmp_path):
    rng = np.random.RandomState(0)
    X = rng.randn(500, 4)
    y = (X[:, 0] > 0).astype(np.float32)
    ds = lt.Dataset(X, label=y, device="cpu")
    assert dt.phase_scope("histogram") is dt.phase_scope("partition")
    with dt.trace_phases(str(tmp_path)) as result:
        lt.train({"objective": "binary", "num_leaves": 7, "verbose": -1},
                 ds, 2, device="cpu")
    assert result.path and os.path.exists(result.path)
    events = dt.load_trace_events(result.path)
    assert events and result.phases == {}
    assert dt.device_seconds(events) == 0.0
    names = {e.get("name") for e in events
             if e.get("cat") == "user_annotation"}
    # the learner's and the booster's scopes, host side only on the CPU
    assert {"lgbm.partition", "lgbm.split_search",
            "lgbm.leaf_update"} <= names


def test_every_kernel_has_a_phase():
    kernels = set()
    for name in sorted(os.listdir(CSRC)):
        if not name.endswith((".cu", ".cuh")):
            continue
        with open(os.path.join(CSRC, name), encoding="utf-8") as fh:
            src = re.sub(r"//[^\n]*", "", fh.read())
        for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__"
                             r"\([^)]*\)\s+)?(\w+)\s*\(", src):
            kernels.add(m.group(1))
    assert len(kernels) >= 27
    missing = sorted(kernels - set(dt.KERNEL_PHASES))
    assert not missing, f"kernels with no phase: {missing}"
    assert not sorted(set(dt.KERNEL_PHASES) - kernels)
    for k in kernels:
        assert dt.classify_event(f"void {k}<float>(int, float*)") == \
            dt.KERNEL_PHASES[k]


def _trace_file(path, events, gz=False):
    opener = gzip.open if gz else open
    with opener(path, "wt", encoding="utf-8") as fh:
        json.dump({"traceEvents": events}, fh)
    return str(path)


def test_load_reads_one_file_or_the_newest(tmp_path):
    old = _trace_file(tmp_path / "train.1.trace.json",
                      [_ev("kernel", "void p1_kernel(Args)", 0, 1000)])
    past = time.time() - 100
    os.utime(old, (past, past))
    sub = tmp_path / "later"
    sub.mkdir()
    new = _trace_file(sub / "train.2.trace.json.gz",
                      [_ev("kernel", "void search2_kernel(float)", 0, 2000)],
                      gz=True)
    assert dt.phase_breakdown_from_trace(str(tmp_path)) == {
        "split-search": pytest.approx(0.002)}
    assert dt.phase_breakdown_from_trace(old) == {
        "predict": pytest.approx(0.001)}
    assert dt.phase_breakdown_from_trace(new) == {
        "split-search": pytest.approx(0.002)}
    (tmp_path / "broken.json").write_text("{")
    os.utime(tmp_path / "broken.json", (past - 10, past - 10))
    assert dt.load_trace_events(str(tmp_path / "broken.json")) == []
    assert dt.load_trace_events(str(tmp_path / "missing")) == []


def test_cli_profile_writes_its_trace_phases(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = np.random.RandomState(1)
    X = rng.randn(600, 4)
    np.savetxt("d.csv", np.column_stack([X[:, 0] > 0, X]), fmt="%.6g",
               delimiter=",")
    os.makedirs("prof")
    # an earlier run's trace in the same profile_dir is not read
    _trace_file(tmp_path / "prof" / "old.trace.json",
                [_ev("kernel", "void p1_kernel(Args)", 0, 5000)])
    assert cli.main(["data=d.csv", "objective=binary", "num_trees=2",
                     "num_leaves=7", "output_model=m.txt", "profile=true",
                     "profile_dir=prof"], device="cpu") == 0
    traces = sorted(os.listdir("prof"))
    assert len(traces) == 2 and any(t.startswith("train.") for t in traces)
    with open("m.txt.manifest.json") as fh:
        man = json.load(fh)
    assert man["phases"] == {}  # the CPU run's trace: no device seconds
    assert man["per_tree"]["count"] >= 2
