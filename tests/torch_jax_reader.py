"""The JAX package's native reader built privately, for the port's tests
that compare file parsing with the JAX package's.

``jax_reader`` (a module-scoped fixture) compiles the JAX package's reader
source into a private directory and points its bindings there for the
module's tests.  Its own loader builds ``lightgbm_tpu/lib`` in place (a
``make`` that rewrites the library) and remembers a failed load for the
life of the process: under several test workers another worker's build
can hand this one a half-written library, and the JAX package then parses
with its pandas reader, whose floats differ from the port's in the last
bits.  A module takes it by name (``jax_reader`` as an argument) or for
every test (``pytestmark = pytest.mark.usefixtures("jax_reader")``),
after ``from torch_jax_reader import jax_reader``.
"""

from __future__ import annotations

import subprocess

import pytest

from lightgbm_tpu import native as jax_native


@pytest.fixture(scope="module")
def jax_reader(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_native") / "liblgbm_native.so")
    subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-fopenmp",
                    "-shared", "-o", out, jax_native._SRC], check=True,
                   capture_output=True, timeout=600)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB_PATH", out)
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_tried", False)
        assert jax_native.available()
        yield jax_native
