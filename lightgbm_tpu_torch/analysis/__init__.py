"""Analysis tools of the port: the runtime lock sanitizer (``lockcheck``).

The JAX package's static analyses (``ast_rules``, ``hlo_audit``,
``recompile``, ``concurrency``) read JAX programs and its own source and
are not ported.
"""

from . import lockcheck  # noqa: F401
