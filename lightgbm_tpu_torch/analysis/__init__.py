"""Analysis tools of the port: the runtime lock sanitizer (``lockcheck``)
and the static concurrency analysis of the threaded modules
(``concurrency``, the JAX package's copy pointed at this package).

The JAX package's other static analyses (``ast_rules``, ``hlo_audit``,
``recompile``) read JAX programs and are not ported.
"""

from . import lockcheck  # noqa: F401
from .concurrency import (  # noqa: F401
    CONCURRENCY_RULES,
    lint_concurrency_paths,
    lint_concurrency_source,
    lint_concurrency_sources,
)
