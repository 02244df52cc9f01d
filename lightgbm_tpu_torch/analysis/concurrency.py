"""Concurrency analysis of the port's threaded control plane.

A copy of the JAX package's ``analysis/concurrency.py`` (stdlib only; its
"jaxlint stage 3") pointed at ``lightgbm_tpu_torch``, with the device
syncs spelled in PyTorch.  The threaded modules (``serving/``, ``obs/``,
``resilience/`` and ``native.py``: the queue, the engine, the fleet's
supervisor, telemetry, the flight recorder, the memory census, the
cross-rank layer, retry, checkpoints and the gang) have the runtime
sanitizer (``analysis/lockcheck.py``) and this static pass between them
and a race.

Scope model
-----------
A module is **threaded scope** when it lives under ``serving/``,
``obs/``, or ``resilience/``, or is ``native.py`` — the tier where
dispatcher threads, scrape handlers, and signal handlers interleave.
``device-sync-under-lock`` narrows to ``serving/``/``obs/`` (the
request path where a sync while holding a lock serializes the queue).
``signal-unsafe-lock`` is package-wide: it follows the call graph from
every registered signal handler, across modules.

Thread-entry inference: a function is thread-side when it is a
``threading.Thread(target=...)``, when it blocks in a
``Condition.wait`` loop (the consumer half of a producer/consumer
pair), or when it is registered as a signal handler in a
``resilience/`` module (CPython delivers signals as asynchronous
interleaves on the main thread — same shared-state discipline).

Device syncs: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
``torch.cuda.synchronize()`` and ``np.asarray`` / ``np.array`` (of a
tensor: the analysis cannot see the argument's type, so any).

Known static limits (the runtime sanitizer covers the gap): calls
through singleton accessors (``get_telemetry().count(...)``), locks
passed as arguments, and in-place mutation of container attributes via
method calls (``self.buf.append(...)``) are not tracked.

Suppression: the JAX package's pragmas —
``# jaxlint: disable=<rule>`` on the flagged line, or
``# jaxlint: disable-file=<rule>`` anywhere in the file.  A suppression
must state the protecting invariant inline: a suppression without the
reason a race cannot happen is a finding in itself.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

_PRAGMA_LINE = re.compile(r"#\s*jaxlint:\s*disable=([\w,\-]+)")
_PRAGMA_FILE = re.compile(r"#\s*jaxlint:\s*disable-file=([\w,\-]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _suppressions(source: str) -> Tuple[Set[str], Dict[int, Set[str]]]:
    """(rules disabled for the file, line -> rules disabled there)."""
    file_rules: Set[str] = set()
    line_rules: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _PRAGMA_FILE.search(line)
        if m:
            file_rules.update(r.strip() for r in m.group(1).split(","))
            continue
        m = _PRAGMA_LINE.search(line)
        if m:
            line_rules.setdefault(i, set()).update(
                r.strip() for r in m.group(1).split(","))
    return file_rules, line_rules

# rule id -> one-line description (the CLI prints this table)
CONCURRENCY_RULES: Dict[str, str] = {
    "shared-state-unlocked": (
        "an instance/module attribute shared between thread-entry code "
        "(Thread targets, Condition.wait consumers, resilience/ signal "
        "handlers) and other callers is written without a common "
        "`with <lock>:` guard — a torn read/lost update under "
        "interleaving.  Guard both sides with the same lock, or "
        "suppress with the invariant that makes the race impossible "
        "written inline"
    ),
    "lock-order-cycle": (
        "the module's lock-acquisition graph (nested `with lock:` "
        "scopes plus calls made while a lock is held) contains a "
        "cycle: two threads taking the locks in opposite orders "
        "deadlock.  Impose one global order (acquire A before B "
        "everywhere) or collapse to a single lock"
    ),
    "device-sync-under-lock": (
        "a host sync/materialization (np.asarray/np.array, .item(), "
        ".tolist(), .cpu(), .numpy(), torch.cuda.synchronize) lexically "
        "inside a `with lock:` body in a serving/obs module: every "
        "other thread queues behind a device round-trip — the p99 "
        "hazard where one dispatch serializes the whole queue.  Move "
        "the sync outside the critical section (snapshot under the "
        "lock, materialize after)"
    ),
    "signal-unsafe-lock": (
        "a plain threading.Lock is acquired on a path reachable from a "
        "registered signal handler: a signal delivered while the main "
        "thread already holds the lock re-enters and self-deadlocks "
        "(the hazard obs/telemetry.py's store RLock exists for).  Use "
        "an RLock, or keep the handler path lock-free"
    ),
}

_THREADED_DIR_PARTS = ("serving", "obs", "resilience")
_THREADED_FILES = ("native.py",)
_SYNC_SCOPE_DIR_PARTS = ("serving", "obs")

# lock-constructor spellings -> lock kind; both the raw threading
# primitives and the analysis.lockcheck factories (the instrumented
# spellings the threaded modules adopt) classify identically
_LOCK_CTORS: Dict[str, str] = {
    "threading.Lock": "lock", "Lock": "lock",
    "threading.RLock": "rlock", "RLock": "rlock",
    "threading.Condition": "condition", "Condition": "condition",
    "lockcheck.make_lock": "lock", "make_lock": "lock",
    "lockcheck.make_rlock": "rlock", "make_rlock": "rlock",
    "lockcheck.make_condition": "condition", "make_condition": "condition",
}

_SYNC_CALLS = {
    "np.asarray", "np.array", "np.ascontiguousarray",
    "numpy.asarray", "numpy.array", "numpy.ascontiguousarray",
    "torch.cuda.synchronize",
}
_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy"}

_THREAD_CTORS = ("threading.Thread", "Thread")
_PKG = "lightgbm_tpu_torch"


def _is_threaded_scope(path: str) -> bool:
    parts = path.replace(os.sep, "/").split("/")
    if any(p in _THREADED_DIR_PARTS for p in parts[:-1]):
        return True
    return parts[-1] in _THREADED_FILES


def _is_sync_scope(path: str) -> bool:
    parts = path.replace(os.sep, "/").split("/")
    return any(p in _SYNC_SCOPE_DIR_PARTS for p in parts[:-1])


def _is_resilience(path: str) -> bool:
    parts = path.replace(os.sep, "/").split("/")
    return "resilience" in parts[:-1]


def _module_name(path: str) -> str:
    """Dotted package-relative module name ('obs.flightrec')."""
    parts = path.replace(os.sep, "/").split("/")
    if _PKG in parts:
        parts = parts[parts.index(_PKG) + 1:]
    name = "/".join(parts)
    if name.endswith(".py"):
        name = name[:-3]
    return name.replace("/", ".") or "<module>"


def _lock_kind(value: ast.AST) -> Optional[str]:
    if not isinstance(value, ast.Call):
        return None
    d = _dotted(value.func)
    return _LOCK_CTORS.get(d) if d else None


class _FnRecord:
    """Everything one function body contributes to the analysis."""

    __slots__ = ("key", "line", "accesses", "global_accesses",
                 "acquire_sites", "nest_edges", "calls", "sync_sites",
                 "wait_entry", "thread_targets", "signal_handlers")

    def __init__(self, key: Tuple[Optional[str], str], line: int) -> None:
        self.key = key
        self.line = line
        # (attr, is_write, line, guards) for self.<attr> accesses
        self.accesses: List[Tuple[str, bool, int, frozenset]] = []
        # (name, is_write, line, guards) for module-global accesses
        self.global_accesses: List[Tuple[str, bool, int, frozenset]] = []
        # (lock_id, kind, line) — every `with lock:` / lock.acquire()
        self.acquire_sites: List[Tuple[str, str, int]] = []
        # (held_lock_id, acquired_lock_id, line) from lexical nesting
        self.nest_edges: List[Tuple[str, str, int]] = []
        # (dotted_callee, line, guards)
        self.calls: List[Tuple[str, int, frozenset]] = []
        # (label, line, guards) — host-sync patterns
        self.sync_sites: List[Tuple[str, int, frozenset]] = []
        self.wait_entry = False
        # dotted Thread target= expressions seen in this body
        self.thread_targets: List[str] = []
        # dotted signal.signal handler expressions seen in this body
        self.signal_handlers: List[str] = []


class _ClassInfo:
    __slots__ = ("name", "methods", "locks")

    def __init__(self, name: str) -> None:
        self.name = name
        self.methods: Dict[str, ast.AST] = {}
        self.locks: Dict[str, str] = {}  # attr -> kind


class _ModuleInfo:
    __slots__ = ("name", "path", "source", "tree", "module_locks",
                 "module_globals", "classes", "functions", "records",
                 "import_map")

    def __init__(self, name: str, path: str, source: str,
                 tree: ast.Module) -> None:
        self.name = name
        self.path = path
        self.source = source
        self.tree = tree
        self.module_locks: Dict[str, str] = {}
        self.module_globals: Set[str] = set()
        self.classes: Dict[str, _ClassInfo] = {}
        # every def in the module (incl. nested), by bare name
        self.functions: Dict[str, ast.AST] = {}
        self.records: Dict[Tuple[Optional[str], str], _FnRecord] = {}
        self.import_map: Dict[str, str] = {}  # alias -> dotted module


class _BodyWalker(ast.NodeVisitor):
    """Walk one function body (or module top level) tracking the stack
    of lexically held locks; nested defs are recorded but not entered
    (each gets its own record)."""

    def __init__(self, mod: _ModuleInfo, cls: Optional[_ClassInfo],
                 rec: _FnRecord) -> None:
        self.mod = mod
        self.cls = cls
        self.rec = rec
        self.guards: List[str] = []

    # ------------------------------------------------------ lock naming
    def _resolve_lock(self, expr: ast.AST) -> Optional[Tuple[str, str]]:
        d = _dotted(expr)
        if not d:
            return None
        if d.startswith("self.") and self.cls is not None:
            attr = d[len("self."):]
            kind = self.cls.locks.get(attr)
            if kind:
                return f"{self.cls.name}.{attr}", kind
            return None
        kind = self.mod.module_locks.get(d)
        if kind:
            return d, kind
        return None

    def _guardset(self) -> frozenset:
        return frozenset(self.guards)

    # -------------------------------------------------------- structure
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass  # separate record; do not descend

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        pass  # nested classes: out of scope

    def visit_With(self, node: ast.With) -> None:
        pushed = 0
        for item in node.items:
            resolved = self._resolve_lock(item.context_expr)
            if resolved is None:
                self.visit(item.context_expr)
                continue
            lock_id, kind = resolved
            line = item.context_expr.lineno
            self.rec.acquire_sites.append((lock_id, kind, line))
            if self.guards:
                self.rec.nest_edges.append((self.guards[-1], lock_id, line))
            self.guards.append(lock_id)
            pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(pushed):
            self.guards.pop()

    visit_AsyncWith = visit_With

    # ------------------------------------------------------ assignments
    def _record_target(self, tgt: ast.AST) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self._record_target(e)
            return
        if isinstance(tgt, ast.Starred):
            self._record_target(tgt.value)
            return
        # peel subscripts: `self.d[k] = v` writes attribute d
        node = tgt
        while isinstance(node, ast.Subscript):
            node = node.value
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            self.rec.accesses.append(
                (node.attr, True, tgt.lineno, self._guardset()))
        elif (isinstance(node, ast.Name)
              and node.id in self.mod.module_globals):
            self.rec.global_accesses.append(
                (node.id, True, tgt.lineno, self._guardset()))
        if isinstance(tgt, ast.Subscript):
            self.visit(tgt.slice)

    def visit_Assign(self, node: ast.Assign) -> None:
        # record self.<attr> lock constructions for completeness (the
        # collector pre-pass already indexed them)
        for tgt in node.targets:
            self._record_target(tgt)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_target(node.target)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_target(node.target)
            self.visit(node.value)

    # ------------------------------------------------------------ reads
    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (isinstance(node.value, ast.Name) and node.value.id == "self"
                and isinstance(node.ctx, ast.Load)):
            self.rec.accesses.append(
                (node.attr, False, node.lineno, self._guardset()))
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if (isinstance(node.ctx, ast.Load)
                and node.id in self.mod.module_globals):
            self.rec.global_accesses.append(
                (node.id, False, node.lineno, self._guardset()))

    # ------------------------------------------------------------ calls
    def visit_Call(self, node: ast.Call) -> None:
        d = _dotted(node.func)
        guards = self._guardset()
        if d:
            self.rec.calls.append((d, node.lineno, guards))
            if d in _SYNC_CALLS and guards:
                self.rec.sync_sites.append((d, node.lineno, guards))
            if d in _THREAD_CTORS:
                for kw in node.keywords:
                    if kw.arg == "target":
                        t = _dotted(kw.value)
                        if t:
                            self.rec.thread_targets.append(t)
            if d == "signal.signal" and len(node.args) == 2:
                h = _dotted(node.args[1])
                if h:
                    self.rec.signal_handlers.append(h)
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in _SYNC_ATTRS and guards:
                self.rec.sync_sites.append(
                    (f".{attr}()", node.lineno, guards))
            if attr in ("wait", "wait_for"):
                resolved = self._resolve_lock(node.func.value)
                if resolved is not None and resolved[1] == "condition":
                    self.rec.wait_entry = True
            if attr == "acquire":
                resolved = self._resolve_lock(node.func.value)
                if resolved is not None:
                    self.rec.acquire_sites.append(
                        (resolved[0], resolved[1], node.lineno))
        self.generic_visit(node)


# ------------------------------------------------------------- collection
def _collect_module(path: str, source: str,
                    tree: ast.Module) -> _ModuleInfo:
    mod = _ModuleInfo(_module_name(path), path, source, tree)

    # module-level names + locks
    for stmt in tree.body:
        targets: List[ast.AST] = []
        value: Optional[ast.AST] = None
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        if value is None:
            continue
        kind = _lock_kind(value)
        for tgt in targets:
            if not isinstance(tgt, ast.Name):
                continue
            if kind:
                mod.module_locks[tgt.id] = kind
            else:
                mod.module_globals.add(tgt.id)

    # classes: methods + instance locks (self.<x> = Lock() anywhere)
    for stmt in tree.body:
        if not isinstance(stmt, ast.ClassDef):
            continue
        ci = _ClassInfo(stmt.name)
        for item in stmt.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ci.methods[item.name] = item
        for item in ast.walk(stmt):
            if not isinstance(item, ast.Assign):
                continue
            kind = _lock_kind(item.value)
            if not kind:
                continue
            for tgt in item.targets:
                if (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    ci.locks[tgt.attr] = kind
        mod.classes[stmt.name] = ci

    # every def in the module, by bare name (nested defs included so
    # Thread targets like retry.py's deadline worker resolve)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            mod.functions.setdefault(node.name, node)

    # walk bodies: methods (with class context), functions, module level
    walked: Set[int] = set()

    def walk_body(fn: ast.AST, key: Tuple[Optional[str], str],
                  cls: Optional[_ClassInfo]) -> None:
        rec = _FnRecord(key, getattr(fn, "lineno", 0))
        walker = _BodyWalker(mod, cls, rec)
        for stmt in fn.body:  # type: ignore[attr-defined]
            walker.visit(stmt)
        mod.records[key] = rec

    for cname, ci in mod.classes.items():
        for mname, fn in ci.methods.items():
            walked.add(id(fn))
            walk_body(fn, (cname, mname), ci)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if id(node) in walked:
                continue
            walked.add(id(node))
            walk_body(node, (None, node.name), None)

    # module top level (registrations like signal.signal at import)
    top = _FnRecord((None, "<module>"), 1)
    walker = _BodyWalker(mod, None, top)
    for stmt in tree.body:
        walker.visit(stmt)
    mod.records[(None, "<module>")] = top
    return mod


def _resolve_imports(mods: Dict[str, _ModuleInfo]) -> None:
    """alias -> package module, for cross-module call resolution."""
    for mod in mods.values():
        pkg_parts = mod.name.split(".")[:-1]
        for stmt in ast.walk(mod.tree):
            if isinstance(stmt, ast.Import):
                for alias in stmt.names:
                    name = alias.name
                    if name.startswith(_PKG + "."):
                        name = name[len(_PKG) + 1:]
                    if name in mods:
                        mod.import_map[alias.asname
                                       or alias.name.split(".")[-1]] = name
            elif isinstance(stmt, ast.ImportFrom):
                if stmt.level == 0:
                    base = (stmt.module or "").split(".")
                    if base and base[0] == _PKG:
                        base = base[1:]
                    elif stmt.module not in (None, _PKG):
                        continue  # stdlib / third-party
                else:
                    keep = len(pkg_parts) - (stmt.level - 1)
                    if keep < 0:
                        continue
                    base = pkg_parts[:keep]
                    if stmt.module:
                        base = base + stmt.module.split(".")
                for alias in stmt.names:
                    cand = ".".join(base + [alias.name]).strip(".")
                    if cand in mods:
                        mod.import_map[alias.asname or alias.name] = cand


# -------------------------------------------------------- thread entries
def _resolve_local(mod: _ModuleInfo, dotted: str,
                   cls: Optional[str]) -> Optional[Tuple[Optional[str], str]]:
    """A dotted callee/target -> a record key in the SAME module."""
    if dotted.startswith("self.") and cls is not None:
        m = dotted[len("self."):]
        if "." not in m and m in mod.classes[cls].methods:
            return (cls, m)
        return None
    if "." not in dotted:
        if dotted in mod.functions:
            return (None, dotted)
    return None


def _class_thread_entries(mod: _ModuleInfo) -> Dict[str, Set[str]]:
    """class name -> method names that run on the thread side."""
    entries: Dict[str, Set[str]] = {c: set() for c in mod.classes}
    resilience = _is_resilience(mod.path)
    for key, rec in mod.records.items():
        cls = key[0]
        for tgt in rec.thread_targets:
            resolved = _resolve_local(mod, tgt, cls)
            if resolved and resolved[0] is not None:
                entries[resolved[0]].add(resolved[1])
        if resilience:
            for h in rec.signal_handlers:
                resolved = _resolve_local(mod, h, cls)
                if resolved and resolved[0] is not None:
                    entries[resolved[0]].add(resolved[1])
        if rec.wait_entry and cls is not None:
            entries[cls].add(key[1])
    return entries


def _module_fn_entries(mod: _ModuleInfo) -> Set[str]:
    """Module-level functions that run on the thread side."""
    entries: Set[str] = set()
    resilience = _is_resilience(mod.path)
    for key, rec in mod.records.items():
        for tgt in rec.thread_targets:
            resolved = _resolve_local(mod, tgt, key[0])
            if resolved and resolved[0] is None:
                entries.add(resolved[1])
        if resilience:
            for h in rec.signal_handlers:
                resolved = _resolve_local(mod, h, key[0])
                if resolved and resolved[0] is None:
                    entries.add(resolved[1])
        if rec.wait_entry and key[0] is None and key[1] != "<module>":
            entries.add(key[1])
    return entries


def _closure(seed: Set[str], edges: Dict[str, Set[str]]) -> Set[str]:
    out = set(seed)
    frontier = list(seed)
    while frontier:
        cur = frontier.pop()
        for nxt in edges.get(cur, ()):
            if nxt not in out:
                out.add(nxt)
                frontier.append(nxt)
    return out


# ------------------------------------------------- rule: shared state
def _rule_shared_state(mod: _ModuleInfo) -> List[Finding]:
    findings: List[Finding] = []
    class_entries = _class_thread_entries(mod)

    for cname, ci in mod.classes.items():
        seed = class_entries.get(cname) or set()
        if not seed:
            continue
        # intra-class call graph over self.<m>() calls
        edges: Dict[str, Set[str]] = {}
        for mname in ci.methods:
            rec = mod.records.get((cname, mname))
            if rec is None:
                continue
            outs: Set[str] = set()
            for d, _line, _g in rec.calls:
                r = _resolve_local(mod, d, cname)
                if r is not None and r[0] == cname:
                    outs.add(r[1])
            edges[mname] = outs
        thread_side = _closure(seed, edges)

        # attr -> [(is_thread_side, is_write, line, guards)]
        by_attr: Dict[str, List[Tuple[bool, bool, int, frozenset]]] = {}
        for mname in ci.methods:
            if mname == "__init__":
                continue  # construction happens-before every thread
            rec = mod.records.get((cname, mname))
            if rec is None:
                continue
            side = mname in thread_side
            for attr, is_write, line, guards in rec.accesses:
                if attr in ci.locks:
                    continue
                by_attr.setdefault(attr, []).append(
                    (side, is_write, line, guards))

        for attr in sorted(by_attr):
            acc = by_attr[attr]
            writes = [a for a in acc if a[1]]
            if not writes:
                continue
            sides = {a[0] for a in acc}
            if len(sides) < 2:
                continue  # not shared across the thread boundary
            common = frozenset.intersection(*[a[3] for a in writes])
            if common:
                continue
            bad = min((w for w in writes if not w[3]),
                      default=min(writes, key=lambda w: w[2]),
                      key=lambda w: w[2])
            entry_names = ", ".join(sorted(seed))
            findings.append(Finding(
                "shared-state-unlocked", mod.path, bad[2],
                f"'{cname}.{attr}' is written here and shared with "
                f"thread-entry code ({entry_names}) without a common "
                "`with <lock>:` guard on every write — guard both "
                "sides with one lock, or state the invariant inline "
                "and suppress"))

    # module-global half
    fn_entries = _module_fn_entries(mod)
    if fn_entries:
        edges = {}
        for key, rec in mod.records.items():
            if key[0] is not None:
                continue
            outs = set()
            for d, _line, _g in rec.calls:
                r = _resolve_local(mod, d, None)
                if r is not None and r[0] is None:
                    outs.add(r[1])
            edges[key[1]] = outs
        thread_side = _closure(fn_entries, edges)
        by_name: Dict[str, List[Tuple[bool, bool, int, frozenset]]] = {}
        for key, rec in mod.records.items():
            if key[0] is not None or key[1] == "<module>":
                continue
            side = key[1] in thread_side
            for name, is_write, line, guards in rec.global_accesses:
                by_name.setdefault(name, []).append(
                    (side, is_write, line, guards))
        for name in sorted(by_name):
            acc = by_name[name]
            writes = [a for a in acc if a[1]]
            if not writes or len({a[0] for a in acc}) < 2:
                continue
            common = frozenset.intersection(*[a[3] for a in writes])
            if common:
                continue
            bad = min((w for w in writes if not w[3]),
                      default=min(writes, key=lambda w: w[2]),
                      key=lambda w: w[2])
            findings.append(Finding(
                "shared-state-unlocked", mod.path, bad[2],
                f"module global '{name}' is written here and shared "
                f"with thread-entry code ({', '.join(sorted(fn_entries))}) "
                "without a common lock guard on every write"))
    return findings


# ------------------------------------------------- rule: lock order
def _rule_lock_order(mod: _ModuleInfo) -> List[Finding]:
    kinds: Dict[str, str] = dict(mod.module_locks)
    for cname, ci in mod.classes.items():
        for attr, kind in ci.locks.items():
            kinds[f"{cname}.{attr}"] = kind
    if len(kinds) == 0:
        return []

    # per-function may-acquire sets, closed over intra-module calls
    acq: Dict[Tuple[Optional[str], str], Set[str]] = {
        key: {a[0] for a in rec.acquire_sites}
        for key, rec in mod.records.items()}
    call_edges: Dict[Tuple[Optional[str], str],
                     Set[Tuple[Optional[str], str]]] = {}
    for key, rec in mod.records.items():
        outs = set()
        for d, _line, _g in rec.calls:
            r = _resolve_local(mod, d, key[0])
            if r is not None and r in mod.records:
                outs.add(r)
        call_edges[key] = outs
    changed = True
    while changed:
        changed = False
        for key, outs in call_edges.items():
            before = len(acq[key])
            for o in outs:
                acq[key] |= acq[o]
            changed = changed or len(acq[key]) != before

    # edges: lexical nesting + calls made while a lock is held
    edge_line: Dict[Tuple[str, str], int] = {}

    def add_edge(a: str, b: str, line: int) -> None:
        if a == b:
            return
        if (a, b) not in edge_line or line < edge_line[(a, b)]:
            edge_line[(a, b)] = line

    self_nest: Dict[str, int] = {}
    for key, rec in mod.records.items():
        for a, b, line in rec.nest_edges:
            if a == b and kinds.get(a) == "lock":
                if a not in self_nest or line < self_nest[a]:
                    self_nest[a] = line
            add_edge(a, b, line)
        for d, line, guards in rec.calls:
            if not guards:
                continue
            r = _resolve_local(mod, d, key[0])
            if r is None or r not in mod.records:
                continue
            for held in guards:
                for inner in acq[r]:
                    add_edge(held, inner, line)

    findings: List[Finding] = []
    for lock, line in sorted(self_nest.items()):
        findings.append(Finding(
            "lock-order-cycle", mod.path, line,
            f"non-reentrant lock '{lock}' is re-acquired while already "
            "held — guaranteed self-deadlock (use an RLock if "
            "re-entry is intended)"))

    # SCCs of the acquisition graph (iterative Tarjan)
    graph: Dict[str, Set[str]] = {}
    for (a, b) in edge_line:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:
        work = [(v, iter(sorted(graph[v])))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(graph[w]))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                if len(scc) > 1:
                    sccs.append(sorted(scc))

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)

    for scc in sorted(sccs):
        members = set(scc)
        lines = [line for (a, b), line in edge_line.items()
                 if a in members and b in members]
        findings.append(Finding(
            "lock-order-cycle", mod.path, min(lines),
            "lock-acquisition cycle between "
            + " <-> ".join(f"'{name}'" for name in scc)
            + ": two threads taking them in opposite orders deadlock — "
            "impose one global acquisition order"))
    return findings


# ------------------------------------------- rule: sync under lock
def _rule_sync_under_lock(mod: _ModuleInfo) -> List[Finding]:
    findings: List[Finding] = []
    for rec in mod.records.values():
        for label, line, guards in rec.sync_sites:
            held = ", ".join(f"'{g}'" for g in sorted(guards))
            findings.append(Finding(
                "device-sync-under-lock", mod.path, line,
                f"{label} blocks on the device while holding {held}: "
                "every other thread queues behind the round-trip — "
                "move the materialization outside the critical section"))
    return findings


# ------------------------------------------ rule: signal-unsafe lock
def _rule_signal_unsafe(mods: Dict[str, _ModuleInfo]) -> List[Finding]:
    NodeKey = Tuple[str, Optional[str], str]  # (module, class, fn)

    def resolve(mod: _ModuleInfo, dotted: str,
                cls: Optional[str]) -> Optional[NodeKey]:
        local = _resolve_local(mod, dotted, cls)
        if local is not None:
            return (mod.name, local[0], local[1])
        parts = dotted.split(".")
        if len(parts) == 2 and parts[0] in mod.import_map:
            target = mods[mod.import_map[parts[0]]]
            if parts[1] in target.functions:
                return (target.name, None, parts[1])
            if parts[1] in target.classes:
                if "__init__" in target.classes[parts[1]].methods:
                    return (target.name, parts[1], "__init__")
        return None

    # seeds: every registered handler, package-wide
    seeds: List[Tuple[NodeKey, str]] = []
    for mod in mods.values():
        for key, rec in mod.records.items():
            for h in rec.signal_handlers:
                r = resolve(mod, h, key[0])
                if r is not None:
                    seeds.append((r, f"{mod.name}.{h}"))

    # BFS over the cross-module call graph, remembering one path
    origin: Dict[NodeKey, Tuple[str, Optional[NodeKey]]] = {}
    frontier: List[NodeKey] = []
    for node, label in seeds:
        if node not in origin:
            origin[node] = (label, None)
            frontier.append(node)
    while frontier:
        cur = frontier.pop()
        mod = mods[cur[0]]
        rec = mod.records.get((cur[1], cur[2]))
        if rec is None:
            continue
        label = origin[cur][0]
        for d, _line, _g in rec.calls:
            nxt = resolve(mod, d, cur[1])
            if nxt is not None and nxt not in origin:
                origin[nxt] = (label, cur)
                frontier.append(nxt)

    findings: List[Finding] = []
    seen: Set[Tuple[str, int]] = set()
    for node in origin:
        mod = mods[node[0]]
        rec = mod.records.get((node[1], node[2]))
        if rec is None or node[2] == "<module>":
            continue
        for lock_id, kind, line in rec.acquire_sites:
            if kind != "lock":
                continue  # RLock re-entry is exactly the safe pattern
            if (mod.path, line) in seen:
                continue
            seen.add((mod.path, line))
            handler = origin[node][0]
            findings.append(Finding(
                "signal-unsafe-lock", mod.path, line,
                f"plain Lock '{lock_id}' is acquired on a path "
                f"reachable from signal handler {handler}: a signal "
                "delivered while the main thread holds it re-enters "
                "and self-deadlocks — use an RLock (the telemetry "
                "store precedent) or keep the handler path lock-free"))
    return findings


# ------------------------------------------------------------ entry points
def lint_concurrency_sources(sources: Dict[str, str],
                             rules: Optional[Iterable[str]] = None
                             ) -> List[Finding]:
    """Analyze a set of ``{path: source}`` modules as one package."""
    findings: List[Finding] = []
    mods: Dict[str, _ModuleInfo] = {}
    for path in sorted(sources):
        src = sources[path]
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            findings.append(
                Finding("syntax-error", path, e.lineno or 0, str(e.msg)))
            continue
        mi = _collect_module(path, src, tree)
        mods[mi.name] = mi
    _resolve_imports(mods)

    for name in sorted(mods):
        mi = mods[name]
        if _is_threaded_scope(mi.path):
            findings.extend(_rule_shared_state(mi))
            findings.extend(_rule_lock_order(mi))
        if _is_sync_scope(mi.path):
            findings.extend(_rule_sync_under_lock(mi))
    findings.extend(_rule_signal_unsafe(mods))

    active = set(rules) if rules is not None else set(CONCURRENCY_RULES)
    out: List[Finding] = []
    for f in findings:
        if f.rule == "syntax-error":
            out.append(f)
            continue
        if f.rule not in active:
            continue
        src = sources.get(f.path)
        file_sup, line_sup = _suppressions(src) if src else (set(), {})
        if f.rule in file_sup or f.rule in line_sup.get(f.line, ()):
            continue
        out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def lint_concurrency_source(source: str,
                            path: str = "lightgbm_tpu_torch/serving/mod.py",
                            rules: Optional[Iterable[str]] = None
                            ) -> List[Finding]:
    """Analyze one module in isolation (tests/fixtures)."""
    return lint_concurrency_sources({path: source}, rules=rules)


def lint_concurrency_paths(paths: Iterable[str],
                           rules: Optional[Iterable[str]] = None
                           ) -> List[Finding]:
    """The analysis over .py files (recursing into directories).

    The whole argument set is analyzed as ONE package, so
    ``signal-unsafe-lock`` follows handler paths across modules."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                if "__pycache__" in root:
                    continue
                for n in sorted(names):
                    if n.endswith(".py"):
                        files.append(os.path.join(root, n))
        elif p.endswith(".py"):
            files.append(p)
    sources: Dict[str, str] = {}
    for fp in sorted(files):
        with open(fp, encoding="utf-8") as fh:
            sources[fp] = fh.read()
    return lint_concurrency_sources(sources, rules=rules)
