"""The port's concurrency analysis (analysis/concurrency.py) against the
JAX package's.

* The known-bad fixture corpus (``tests/fixtures/concurrency/``) and every
  synthetic source of ``tests/test_concurrency_analysis.py`` give the same
  (rule, line) findings from both analyzers, with the paths mapped from
  ``lightgbm_tpu/`` to ``lightgbm_tpu_torch/`` (and the JAX sync spelling
  ``.block_until_ready()`` to the port's ``.cpu()``, on the same line).
* Each of the port's device-sync spellings under a lock in ``serving/``
  fires; outside the lock, or outside serving/obs, none does.
* The port itself is clean, and each of its suppressions states the
  invariant that protects it in a comment on or just above its line.
"""

import ast
import os
import re
import textwrap

import pytest

from lightgbm_tpu.analysis import concurrency as jconc

from lightgbm_tpu_torch.analysis import (CONCURRENCY_RULES,
                                         lint_concurrency_paths,
                                         lint_concurrency_source,
                                         lint_concurrency_sources)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "concurrency")
JAX_TESTS = os.path.join(ROOT, "tests", "test_concurrency_analysis.py")
PKG = os.path.join(ROOT, "lightgbm_tpu_torch")

JAX_PATHS = ("lightgbm_tpu/serving/mod.py", "lightgbm_tpu/resilience/mod.py",
             "lightgbm_tpu/obs/mod.py", "lightgbm_tpu/learners/mod.py")


def _port_path(path):
    return path.replace("lightgbm_tpu/", "lightgbm_tpu_torch/", 1)


def _port_source(src):
    return src.replace(".block_until_ready()", ".cpu()")


def _pairs(findings):
    return sorted((f.rule, f.line) for f in findings)


def _jax_sources():
    """The synthetic sources of the JAX package's tests: every string
    constant there that parses as a module using threading or signal."""
    with open(JAX_TESTS, encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Constant)
                and isinstance(node.value, str)):
            continue
        src = textwrap.dedent(node.value.replace("{line_pragma}", ""))
        if "threading" not in src and "signal" not in src:
            continue
        try:
            ast.parse(src)
        except SyntaxError:
            continue
        out.append(src)
    return out


SOURCES = _jax_sources()


def test_rule_table_is_jax():
    assert set(CONCURRENCY_RULES) == set(jconc.CONCURRENCY_RULES)


def test_jax_synthetic_sources_found():
    assert len(SOURCES) >= 14


@pytest.mark.parametrize("path", JAX_PATHS)
@pytest.mark.parametrize("i", range(len(SOURCES)))
def test_synthetic_sources_match_jax(i, path):
    src = SOURCES[i]
    want = jconc.lint_concurrency_source(src, path=path)
    got = lint_concurrency_source(_port_source(src), path=_port_path(path))
    assert _pairs(got) == _pairs(want)


@pytest.mark.parametrize("name", sorted(
    n for n in os.listdir(FIXTURES) if n.endswith(".py")))
@pytest.mark.parametrize("path", JAX_PATHS[:2])
def test_fixture_corpus_matches_jax(name, path):
    with open(os.path.join(FIXTURES, name), encoding="utf-8") as fh:
        src = fh.read()
    want = jconc.lint_concurrency_source(src, path=path)
    got = lint_concurrency_source(_port_source(src), path=_port_path(path))
    assert _pairs(got) == _pairs(want)


def test_cross_module_signal_path_matches_jax():
    obs_src = textwrap.dedent("""
    import threading

    _lock = threading.Lock()

    def flush():
        with _lock:
            return 1
    """)
    res_src = textwrap.dedent("""
    import signal

    from ..obs import sink

    def _on_sigterm(signum, frame):
        sink.flush()

    signal.signal(signal.SIGTERM, _on_sigterm)
    """)
    srcs = {"lightgbm_tpu/obs/sink.py": obs_src,
            "lightgbm_tpu/resilience/handler.py": res_src}
    want = jconc.lint_concurrency_sources(srcs)
    got = lint_concurrency_sources(
        {_port_path(p): s for p, s in srcs.items()})
    assert [(f.rule, _port_path(f.path), f.line) for f in want] == \
        [(f.rule, f.path, f.line) for f in got]
    assert [f.rule for f in got] == ["signal-unsafe-lock"]


SYNCS = ["x.item()", "x.tolist()", "x.cpu()", "x.numpy()",
         "torch.cuda.synchronize()", "np.asarray(x)", "np.array(x)"]


@pytest.mark.parametrize("sync", SYNCS)
def test_torch_sync_under_lock_fires(sync):
    src = textwrap.dedent(f"""
    import threading

    import numpy as np
    import torch

    _lock = threading.Lock()

    def read(x):
        with _lock:
            return {sync}

    def read_after(x):
        with _lock:
            y = x
        return {sync.replace("x", "y") if "x" in sync else sync}
    """)
    fs = lint_concurrency_source(src, path="lightgbm_tpu_torch/serving/m.py")
    assert [(f.rule, f.line) for f in fs] == \
        [("device-sync-under-lock", 11)]
    assert lint_concurrency_source(
        src, path="lightgbm_tpu_torch/learners/m.py") == []


def test_the_port_is_clean():
    assert lint_concurrency_paths([PKG]) == []


def test_suppressions_state_their_invariant():
    # a pragma after code on its line (not the analyzer's own docs)
    pragma = re.compile(r"^[^#`]*\S[^#`]*#\s*jaxlint:\s*disable(-file)?=")
    found = 0
    for root, _dirs, names in os.walk(PKG):
        for n in names:
            if not n.endswith(".py"):
                continue
            with open(os.path.join(root, n), encoding="utf-8") as fh:
                lines = fh.read().splitlines()
            for i, line in enumerate(lines):
                if not pragma.search(line):
                    continue
                found += 1
                above = [ln.strip() for ln in lines[max(0, i - 4):i]]
                assert any(ln.startswith("#") for ln in above), (
                    f"{n}:{i + 1}: a suppression without its invariant")
    assert found >= 3
