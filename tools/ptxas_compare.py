#!/usr/bin/env python3
"""The float32 CUDA kernels' registers, stack, spills and shared memory,
against another checkout's.

    python3 tools/ptxas_compare.py --parent-csrc DIR

Builds every ``csrc/<name>.cu`` of this checkout and of ``DIR`` (another
checkout's ``lightgbm_tpu_torch/csrc``) with ``ops/_build.py``'s flags,
all ``nvcc`` runs started together, into ``build/ptxas_compare``, and
reads each kernel's ``-Xptxas -v`` lines.  A kernel instantiated with a
``double`` template argument (the float64 kernels) is skipped and printed
as ``double``.  For each source, the other kernels' resource tuples must
equal the other checkout's as a multiset: the same number of kernels and
the same (registers, stack, spill stores, spill loads, smem) for each,
whatever the names (the float32 kernels took a ``float`` template
argument when the histogram and search code was templated on its
accumulator).  One line a source, the last line a JSON summary; the exit
code is 1 when a source differs.  Needs nvcc and ``cu++filt`` from the
CUDA toolkit, no card.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "lightgbm_tpu_torch", "csrc")
WORK = os.path.join(ROOT, "build", "ptxas_compare")

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_USED = re.compile(r"Used (\d+) registers")
_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_SMEM = re.compile(r"(\d+) bytes smem")
_PROPS = re.compile(r"Function properties for (\S+)")


def _demangle(names):
    tool = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    if len(out) != len(names):
        raise SystemExit("cu++filt returned another number of names")
    return dict(zip(names, out))


def _is_double(name: str) -> bool:
    """True when the demangled kernel name's template arguments (the name
    without its parameter list, the last parenthesised group) hold
    ``double``."""
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            break
    return re.search(r"\bdouble\b", name[:i]) is not None


def _report(text: str):
    """kernel mangled name -> (registers, stack, spill stores, spill
    loads, smem) from one ``-Xptxas -v`` output."""
    out, cur = {}, None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = m.group(1)
            out[cur] = [0, 0, 0, 0, 0]
            continue
        p = _PROPS.search(line)
        if p:  # a device function's properties belong to no kernel
            cur = p.group(1) if p.group(1) in out else None
            continue
        if cur is None:
            continue
        s = _STACK.search(line)
        if s:
            out[cur][1:4] = [int(x) for x in s.groups()]
        u = _USED.search(line)
        if u:
            out[cur][0] = int(u.group(1))
            sm = _SMEM.search(line)
            out[cur][4] = int(sm.group(1)) if sm else 0
    return {k: tuple(v) for k, v in out.items()}


def _build(tag: str, csrc: str):
    from lightgbm_tpu_torch.ops import _build as B

    d = os.path.join(WORK, tag)
    os.makedirs(d, exist_ok=True)
    procs = {}
    for name in B.SOURCES:
        src = os.path.join(csrc, f"{name}.cu")
        if not os.path.exists(src):
            continue
        cmd = [B._nvcc(), *B.NVCC_FLAGS, "-o", os.path.join(d, f"{name}.so"),
               src]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    return procs


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--parent-csrc" not in argv:
        raise SystemExit(__doc__)
    parent = os.path.abspath(argv[argv.index("--parent-csrc") + 1])
    shutil.rmtree(WORK, ignore_errors=True)
    runs = {"this": _build("this", CSRC), "parent": _build("parent", parent)}
    reports = {}
    for tag, procs in runs.items():
        for name, p in procs.items():
            text, _ = p.communicate()
            if p.returncode != 0:
                raise SystemExit(f"nvcc failed for {tag} {name}.cu:\n{text}")
            reports[(tag, name)] = _report(text)
    summary = {"same": 0, "differ": [], "double": 0}
    for name in sorted({n for _, n in reports}):
        mine = reports.get(("this", name), {})
        other = reports.get(("parent", name), {})
        names = _demangle(sorted(set(mine) | set(other)))
        theirs = Counter(v for k, v in other.items()
                         if not _is_double(names[k]))
        ours = Counter()
        for k, v in sorted(mine.items(), key=lambda kv: names[kv[0]]):
            if _is_double(names[k]):
                summary["double"] += 1
                print(f"[ptxas {name}] double {names[k]}: regs={v[0]} "
                      f"stack={v[1]} spill_st={v[2]} spill_ld={v[3]} "
                      f"smem={v[4]}", flush=True)
            else:
                ours[v] += 1
        n = sum(ours.values())
        if ours == theirs:
            summary["same"] += n
            verdict = "equal"
        else:
            summary["differ"].append(name)
            verdict = (f"DIFFER: only here {dict(ours - theirs)}, only "
                       f"there {dict(theirs - ours)}")
        print(f"[ptxas {name}] {n} kernels here, {sum(theirs.values())} "
              f"there (regs, stack, spill_st, spill_ld, smem): {verdict}",
              flush=True)
    print(json.dumps(summary), flush=True)
    return 1 if summary["differ"] else 0


if __name__ == "__main__":
    sys.exit(main())
