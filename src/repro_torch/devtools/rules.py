"""Rules 2-5: blocking-under-lock, fault-site, atomic-counter,
resource-lifecycle.  All consume the `repro_torch.devtools.scan` model."""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from repro_torch.devtools.scan import (CallInfo, Finding, FuncModel, ModuleModel,
                                 TreeModel, resolve_callee)

# ---------------------------------------------------------------------------
# rule: blocking-under-lock
# ---------------------------------------------------------------------------

# attribute calls that block: sleeps, socket/pipe sends+receives,
# future.result(), journal sync(), fsync
BLOCKING_ATTRS = {
    "sleep", "sendall", "send", "recv", "recv_bytes", "recv_into",
    "accept", "connect", "create_connection", "result", "sync", "fsync",
}
# bare-name function calls that block (module-level helpers)
BLOCKING_FUNCS = {"send_frame", "recv_frame", "sleep", "fsync",
                  "create_connection"}
# COS I/O: these methods on a receiver chain ending in `cos`
COS_METHODS = {"put", "get", "put_async", "get_async", "delete",
               "list_keys", "exists", "read_through"}


def _direct_block_label(ci: CallInfo) -> Optional[str]:
    if ci.recv is not None:
        if ci.recv == "self":
            return None          # self-method calls go through propagation
        base = ci.recv.split(".")[-1]
        if ci.name in COS_METHODS and (base == "cos" or base.endswith("_cos")):
            return f"COS I/O {ci.recv}.{ci.name}()"
        if ci.name in BLOCKING_ATTRS:
            return f"{ci.recv}.{ci.name}()"
        return None
    if ci.name in BLOCKING_FUNCS:
        return f"{ci.name}()"
    return None


def _compute_may_block(tm: TreeModel) -> Dict[Tuple[str, str], str]:
    """qual-key -> label of a blocking call reachable from the function
    body (pragma'd sites excluded — a waiver covers its callers)."""
    out: Dict[Tuple[str, str], str] = {}
    for key, fm in tm.funcs.items():
        mm = tm.modules[key[0]]
        for ci in fm.calls:
            label = _direct_block_label(ci)
            if label is None:
                continue
            if tm.pragma_for(mm, "blocking-under-lock", ci.line) is not None:
                continue
            out[key] = label
            break
    changed = True
    while changed:
        changed = False
        for key, fm in tm.funcs.items():
            if key in out:
                continue
            mm = tm.modules[key[0]]
            for ci in fm.calls:
                callee = resolve_callee(tm, mm, fm, ci)
                if callee is None:
                    continue
                ckey = (callee.module, callee.qualname)
                if ckey in out:
                    if tm.pragma_for(mm, "blocking-under-lock",
                                     ci.line) is not None:
                        continue
                    out[key] = (f"{callee.module}.{callee.qualname}() "
                                f"-> {out[ckey]}")
                    changed = True
                    break
    return out


def blocking_under_lock(tm: TreeModel) -> List[Finding]:
    may_block = _compute_may_block(tm)
    findings: List[Finding] = []
    for (modname, qual), fm in tm.funcs.items():
        mm = tm.modules[modname]
        scope = f"{modname}.{qual}"
        flagged_lines: Set[int] = set()
        for ci in fm.calls:
            if not ci.held:
                continue
            label = _direct_block_label(ci)
            if label is not None:
                findings.append(Finding(
                    rule="blocking-under-lock", path=fm.path, line=ci.line,
                    scope=scope,
                    detail=f"{ci.held[-1]}|{ci.recv or ''}.{ci.name}",
                    message=(f"{label} while holding {ci.held[-1]}")))
                flagged_lines.add(ci.line)
                continue
            callee = resolve_callee(tm, mm, fm, ci)
            if callee is None:
                continue
            ckey = (callee.module, callee.qualname)
            if ckey in may_block and ci.line not in flagged_lines:
                findings.append(Finding(
                    rule="blocking-under-lock", path=fm.path, line=ci.line,
                    scope=scope,
                    detail=f"{ci.held[-1]}|call:{ckey[0]}.{ckey[1]}",
                    message=(f"call to {ckey[0]}.{ckey[1]}() while holding "
                             f"{ci.held[-1]} — it may block "
                             f"({may_block[ckey]})")))
                flagged_lines.add(ci.line)
    return findings


# ---------------------------------------------------------------------------
# rule: fault-site
# ---------------------------------------------------------------------------

def _requires_match(site: str) -> bool:
    return site.startswith("net.") or site.startswith("hb")


def fault_site(tm: TreeModel) -> List[Finding]:
    findings: List[Finding] = []
    manifest = tm.fault_manifest
    for (modname, qual), fm in tm.funcs.items():
        if modname == "faults":
            continue             # the plan's own internals are exempt
        scope = f"{modname}.{qual}"
        for ci in fm.calls:
            if ci.name == "fire" and ci.recv is not None:
                if ci.recv not in ci.guarded:
                    findings.append(Finding(
                        rule="fault-site", path=fm.path, line=ci.line,
                        scope=scope, detail=f"unguarded:{ci.recv}",
                        message=(f"{ci.recv}.fire() without an enclosing "
                                 f"`{ci.recv} is not None` guard — a "
                                 f"plan-less run would crash here")))
                if ci.arg0 is None:
                    findings.append(Finding(
                        rule="fault-site", path=fm.path, line=ci.line,
                        scope=scope, detail=f"nonliteral:{ci.recv}",
                        message=(f"{ci.recv}.fire() site is not a string "
                                 f"literal — the manifest check cannot "
                                 f"see it")))
                elif manifest and ci.arg0 not in manifest:
                    findings.append(Finding(
                        rule="fault-site", path=fm.path, line=ci.line,
                        scope=scope, detail=f"unregistered:{ci.arg0}",
                        message=(f"fire site {ci.arg0!r} is not in "
                                 f"faults.FAULT_SITES — a typo'd site "
                                 f"silently never fires")))
            if ci.name == "FaultPoint":
                site = ci.kw_site or ci.arg0
                if site is None:
                    continue
                if manifest and site not in manifest:
                    findings.append(Finding(
                        rule="fault-site", path=fm.path, line=ci.line,
                        scope=scope, detail=f"point-unregistered:{site}",
                        message=(f"FaultPoint site {site!r} is not in "
                                 f"faults.FAULT_SITES")))
                if _requires_match(site) and "match" not in ci.kwargs:
                    findings.append(Finding(
                        rule="fault-site", path=fm.path, line=ci.line,
                        scope=scope, detail=f"point-no-match:{site}",
                        message=(f"FaultPoint site {site!r} must set "
                                 f"`match=` — unmatched heartbeat traffic "
                                 f"would consume hit indices and break "
                                 f"log determinism")))
    return findings


# ---------------------------------------------------------------------------
# rule: metric-site
# ---------------------------------------------------------------------------

_OBS_CALLS = ("span", "record", "event")


def _is_obs_recv(recv: str) -> bool:
    """True for receivers that name an ObsPlane handle by convention:
    `obs`, `self.obs`, `self._obs`, `store.obs`, ..."""
    return recv.rsplit(".", 1)[-1] in ("obs", "_obs")


def metric_site(tm: TreeModel) -> List[Finding]:
    """Every `<obs>.span/record/event(...)` instrumentation site must
    (a) sit under an `<obs> is not None` guard (the plane is optional
    and off by default), and (b) pass a literal site name registered in
    `repro_torch.obs.sites.METRIC_SITES` — a typo'd site would silently
    record into nothing (span/event) or KeyError at runtime (record)."""
    findings: List[Finding] = []
    manifest = tm.metric_manifest
    for (modname, qual), fm in tm.funcs.items():
        if "obs/" in fm.path.replace("\\", "/"):
            continue             # the plane's own internals are exempt
        scope = f"{modname}.{qual}"
        for ci in fm.calls:
            if ci.name not in _OBS_CALLS or ci.recv is None \
                    or not _is_obs_recv(ci.recv):
                continue
            # a parameter-bound plane (callback closures with `obs=obs`
            # defaults) is the caller's contract: the binding site only
            # exists inside the caller's own non-None guard
            if ci.recv not in ci.guarded and ci.recv not in fm.params:
                findings.append(Finding(
                    rule="metric-site", path=fm.path, line=ci.line,
                    scope=scope, detail=f"unguarded:{ci.recv}",
                    message=(f"{ci.recv}.{ci.name}() without an "
                             f"enclosing `{ci.recv} is not None` guard "
                             f"— a plane-less store would crash here")))
            if ci.arg0 is None:
                findings.append(Finding(
                    rule="metric-site", path=fm.path, line=ci.line,
                    scope=scope, detail=f"nonliteral:{ci.recv}",
                    message=(f"{ci.recv}.{ci.name}() site is not a "
                             f"string literal — the manifest check "
                             f"cannot see it")))
            elif manifest and ci.arg0 not in manifest:
                findings.append(Finding(
                    rule="metric-site", path=fm.path, line=ci.line,
                    scope=scope, detail=f"unregistered:{ci.arg0}",
                    message=(f"site {ci.arg0!r} is not in "
                             f"obs.METRIC_SITES — register it or fix "
                             f"the typo (unregistered names never "
                             f"surface in the export)")))
    return findings


# ---------------------------------------------------------------------------
# rule: atomic-counter
# ---------------------------------------------------------------------------

def atomic_counter(tm: TreeModel) -> List[Finding]:
    findings: List[Finding] = []
    for modname, mm in tm.modules.items():
        for (line, scope, recv, attr) in mm.augassigns:
            # scope is "module.qualname"; find the owning class
            qual = scope[len(modname) + 1:]
            fm = mm.funcs.get(qual)
            if fm is None or fm.cls is None:
                continue
            if not recv.startswith("self.") or recv.count(".") != 1:
                continue
            stats_attr = recv[5:]
            cm = mm.classes.get(fm.cls)
            if cm is None or stats_attr not in cm.storestats_attrs:
                continue
            findings.append(Finding(
                rule="atomic-counter", path=mm.relpath, line=line,
                scope=scope, detail=f"rmw:{stats_attr}.{attr}",
                message=(f"read-modify-write on StoreStats counter "
                         f"{recv}.{attr} — lost updates under "
                         f"concurrency; use {recv}.inc({attr!r})")))
    return findings


# ---------------------------------------------------------------------------
# rule: resource-lifecycle
# ---------------------------------------------------------------------------

TEARDOWN_ROOTS = ("close", "shutdown", "stop", "__exit__")
TEARDOWN_CALLS = {"join", "shutdown", "close", "unlink", "stop",
                  "terminate", "kill", "cancel"}


def _reachable_methods(tm: TreeModel, mm: ModuleModel,
                       cls: str) -> Set[str]:
    roots = [r for r in TEARDOWN_ROOTS
             if f"{cls}.{r}" in mm.funcs]
    seen: Set[str] = set(roots)
    queue = list(roots)
    while queue:
        meth = queue.pop(0)
        fm = mm.funcs.get(f"{cls}.{meth}")
        if fm is None:
            continue
        for ci in fm.calls:
            if ci.resolved and ci.resolved[0] == "method" \
                    and ci.resolved[1] == cls:
                m = ci.resolved[2]
                if m not in seen:
                    seen.add(m)
                    queue.append(m)
    return seen


def resource_lifecycle(tm: TreeModel) -> List[Finding]:
    findings: List[Finding] = []
    for (modname, cname), cm in tm.classes.items():
        if not cm.init_resources:
            continue
        mm = tm.modules[modname]
        reach = _reachable_methods(tm, mm, cname)
        torn_down: Set[str] = set()
        for meth in reach:
            fm = mm.funcs.get(f"{cname}.{meth}")
            if fm is None:
                continue
            for ci in fm.calls:
                if ci.recv and ci.recv.startswith("self.") \
                        and ci.name in TEARDOWN_CALLS:
                    torn_down.add(ci.recv[5:])
        for attr, (ctor, line) in sorted(cm.init_resources.items()):
            if attr in torn_down:
                continue
            roots = [r for r in TEARDOWN_ROOTS if r in cm.methods]
            why = (f"no {'/'.join(TEARDOWN_ROOTS[:2])} method on the class"
                   if not roots else
                   f"not reachable from {'/'.join(roots)}")
            findings.append(Finding(
                rule="resource-lifecycle", path=cm.path, line=line,
                scope=f"{modname}.{cname}", detail=f"leak:{attr}:{ctor}",
                message=(f"{ctor} in self.{attr} (constructed in __init__) "
                         f"has no join/shutdown/unlink {why} — leaked on "
                         f"close")))
    return findings
