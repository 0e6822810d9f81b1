"""Lock acquisition graph: edges, deadlock candidates, hierarchy doc.

Nodes are class-level lock identities (``module.Class.attr``).  An edge
``A -> B`` means some code path acquires B while holding A — either a
lexically nested ``with``/``.acquire()`` in one function, or a call
made under A to a function whose transitive acquisition closure
contains B (receiver types resolved through ``self.attr =
ClassName(...)`` assignments).

The rule reports:

- **cycles** in the graph (strongly connected components with more than
  one node): deadlock candidates — two threads walking the component in
  different orders can each hold what the other needs;
- **plain-Lock self-deadlock**: a call made while holding a
  non-reentrant ``threading.Lock`` into code that re-acquires the same
  lock (an RLock re-acquisition is reentrant and fine);
- **factory-name drift**: a ``make_lock("name")`` literal that does not
  match its defining ``module.Class.attr`` site — the literal is what
  the runtime `LockWitness` reports, so drift would break the
  static/runtime cross-validation.

`static_order` exports the DAG's transitive closure for the witness.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from repro_torch.devtools.scan import (Finding, TreeModel, resolve_callee)

# (src, dst) -> [(path, line, scope, provenance)]
EdgeMap = Dict[Tuple[str, str], List[Tuple[str, int, str, str]]]


def build_edges(tm: TreeModel) -> Tuple[EdgeMap, List[Finding]]:
    edges: EdgeMap = {}
    findings: List[Finding] = []
    for (modname, qual), fm in tm.funcs.items():
        mm = tm.modules[modname]
        scope = f"{modname}.{qual}"
        for acq in fm.acquires:
            for h in acq.held:
                if h != acq.lock:
                    edges.setdefault((h, acq.lock), []).append(
                        (fm.path, acq.line, scope, f"nested {acq.via}"))
        for ci in fm.calls:
            if not ci.held:
                continue
            callee = resolve_callee(tm, mm, fm, ci)
            if callee is None:
                continue
            cscope = f"{callee.module}.{callee.qualname}"
            for lock in sorted(callee.acquires_closure):
                held_last = ci.held[-1]
                if lock in ci.held:
                    ld = tm.locks.get(lock)
                    if ld is not None and ld.kind == "lock":
                        f = Finding(
                            rule="lock-order", path=fm.path, line=ci.line,
                            scope=scope,
                            detail=f"self:{lock}:{cscope}",
                            message=(f"call to {cscope}() while holding "
                                     f"non-reentrant Lock {lock}, which it "
                                     f"re-acquires — self-deadlock"))
                        if tm.pragma_for(mm, "lock-order", ci.line) is None:
                            findings.append(f)
                    continue
                edges.setdefault((held_last, lock), []).append(
                    (fm.path, ci.line, scope, f"via {cscope}"))
                for h in ci.held[:-1]:
                    edges.setdefault((h, lock), []).append(
                        (fm.path, ci.line, scope, f"via {cscope}"))
    return edges, findings


def _sccs(nodes: Set[str], adj: Dict[str, Set[str]]) -> List[List[str]]:
    """Tarjan strongly-connected components (iterative)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    onstack: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    for start in sorted(nodes):
        if start in index:
            continue
        work = [(start, iter(sorted(adj.get(start, ()))))]
        index[start] = low[start] = counter[0]
        counter[0] += 1
        stack.append(start)
        onstack.add(start)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    onstack.add(w)
                    work.append((w, iter(sorted(adj.get(w, ())))))
                    advanced = True
                    break
                if w in onstack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    onstack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                out.append(comp)
    return out


def check(tm: TreeModel) -> Tuple[List[Finding], EdgeMap]:
    edges, findings = build_edges(tm)
    adj: Dict[str, Set[str]] = {}
    nodes: Set[str] = set(tm.locks)
    for (a, b) in edges:
        nodes.add(a)
        nodes.add(b)
        adj.setdefault(a, set()).add(b)
    for comp in _sccs(nodes, adj):
        if len(comp) < 2:
            continue
        comp = sorted(comp)
        sites = []
        for (a, b), occ in sorted(edges.items()):
            if a in comp and b in comp:
                p, ln, scope, prov = occ[0]
                sites.append(f"{a} -> {b} at {p}:{ln} ({prov})")
        # anchor the finding at the first in-component edge site
        first = None
        for (a, b), occ in sorted(edges.items()):
            if a in comp and b in comp:
                first = occ[0]
                break
        path, line = (first[0], first[1]) if first else ("", 0)
        findings.append(Finding(
            rule="lock-order", path=path, line=line,
            scope="acquisition-graph",
            detail="cycle:" + ">".join(comp),
            message=("lock-order cycle (deadlock candidate): "
                     + " / ".join(sites))))
    # factory literal must match the defining site
    for name, ld in sorted(tm.locks.items()):
        if not ld.via_factory:
            continue
        canonical = (f"{ld.module}.{ld.cls}.{ld.attr}" if ld.cls
                     else f"{ld.module}.{ld.attr}")
        if name != canonical and not name.startswith(f"{ld.module}."):
            mm = tm.modules.get(ld.module)
            if mm is not None and tm.pragma_for(
                    mm, "lock-order", ld.line) is not None:
                continue
            findings.append(Finding(
                rule="lock-order", path=ld.path, line=ld.line,
                scope=canonical, detail=f"name-drift:{name}",
                message=(f"make_lock name {name!r} does not match its "
                         f"defining site {canonical!r} — witness and "
                         f"static model would disagree")))
    return findings, edges


def transitive_closure(edges: EdgeMap) -> Dict[str, FrozenSet[str]]:
    adj: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        adj.setdefault(a, set()).add(b)
    out: Dict[str, FrozenSet[str]] = {}
    for start in adj:
        seen: Set[str] = set()
        stack = list(adj[start])
        while stack:
            v = stack.pop()
            if v in seen:
                continue
            seen.add(v)
            stack.extend(adj.get(v, ()))
        out[start] = frozenset(seen)
    return out


def static_order(targets: List[str],
                 root=None) -> Dict[str, FrozenSet[str]]:
    """Scan `targets` and return the acquisition graph's transitive
    closure: name -> every lock some path acquires after it.  The
    runtime witness treats 'acquire A while holding B' as an inversion
    when A-before-B holds here and B-before-A does not."""
    from repro_torch.devtools.scan import scan_tree
    tm = scan_tree(targets, root)
    edges, _ = build_edges(tm)
    return transitive_closure(edges)


def render_hierarchy(tm: TreeModel, edges: EdgeMap) -> str:
    """Markdown lock-hierarchy doc (deterministic: no timestamps)."""
    adj: Dict[str, Set[str]] = {}
    rdeg: Dict[str, int] = {}
    nodes: Set[str] = set(tm.locks)
    for (a, b) in edges:
        nodes.add(a)
        nodes.add(b)
        adj.setdefault(a, set()).add(b)
    for n in nodes:
        rdeg.setdefault(n, 0)
    for (a, b) in edges:
        rdeg[b] += 1
    # Kahn levels: level(n) = longest chain of must-precede locks above n
    level: Dict[str, int] = {}
    ready = sorted(n for n in nodes if rdeg[n] == 0)
    for n in ready:
        level[n] = 0
    queue = list(ready)
    deg = dict(rdeg)
    while queue:
        n = queue.pop(0)
        for m in sorted(adj.get(n, ())):
            level[m] = max(level.get(m, 0), level[n] + 1)
            deg[m] -= 1
            if deg[m] == 0:
                queue.append(m)
    in_cycle = sorted(n for n in nodes if n not in level)

    lines = [
        "# Lock hierarchy (generated)",
        "",
        "Derived by `istore-lint` from the lock-acquisition graph of",
        "`src/repro_torch`.  Regenerate with:",
        "",
        "    PYTHONPATH=src python -m repro_torch.devtools.lint src/repro_torch \\",
        "        --emit-hierarchy docs/lock_hierarchy.md",
        "",
        "An edge `A -> B` means some path acquires B while holding A;",
        "every runtime acquisition order must be consistent with this",
        "partial order (enforced by `repro_torch.devtools.witness.LockWitness`",
        "under the conformance suite and the chaos soak).  Locks at the",
        "same level with no edge between them are unordered — a future",
        "path may pick either order, but must then keep it.",
        "",
        "## Levels (a lock may only be acquired while holding locks of a",
        "## strictly lower level along an edge path)",
        "",
    ]
    by_level: Dict[int, List[str]] = {}
    for n, lv in level.items():
        by_level.setdefault(lv, []).append(n)
    for lv in sorted(by_level):
        lines.append(f"- **level {lv}**: " +
                     ", ".join(f"`{n}`" for n in sorted(by_level[lv])))
    if in_cycle:
        lines.append("- **UNORDERED (cycle!)**: " +
                     ", ".join(f"`{n}`" for n in in_cycle))
    lines += ["", "## Edges", ""]
    if not edges:
        lines.append("(none — no nested acquisitions found)")
    for (a, b), occ in sorted(edges.items()):
        p, ln, scope, prov = occ[0]
        extra = f" (+{len(occ) - 1} more sites)" if len(occ) > 1 else ""
        lines.append(f"- `{a}` -> `{b}` — {p}:{ln} in `{scope}` "
                     f"[{prov}]{extra}")
    lines += ["", "## Lock inventory", "",
              "| lock | kind | defined at | witnessed |",
              "|---|---|---|---|"]
    for name in sorted(tm.locks):
        ld = tm.locks[name]
        lines.append(f"| `{name}` | {ld.kind} | {ld.path}:{ld.line} | "
                     f"{'yes' if ld.via_factory else 'no'} |")
    lines.append("")
    return "\n".join(lines)
