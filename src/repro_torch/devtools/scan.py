"""AST scan producing the semantic model the lint rules consume.

One pass per module collects lock definitions (``threading.Lock`` /
``RLock`` / ``Condition`` aliases / ``make_lock("name")``), class
attribute types (``self.x = ClassName(...)``), resource constructions,
and imports.  A second pass walks every function body tracking

- the stack of locks held at each point (``with <lock>:`` regions, with
  explicit ``lock.release()`` / ``lock.acquire()`` toggling inside a
  region honored),
- every call made, with receiver chain, held-lock snapshot and the set
  of expressions guarded non-None at that point (for the fault-site
  rule),
- lock acquisition events with provenance.

Everything downstream — the acquisition graph, blocking-under-lock,
fault-site, atomic-counter and resource-lifecycle rules — reads this
model; no rule re-walks the AST.

Static model limits (documented, deliberate): lock identity is
class-level (``module.Class.attr``), not per-instance; receivers typed
only via ``self.attr = ClassName(...)`` assignments resolvable inside
the scanned tree (dict/parameter-typed objects are opaque); lambdas are
scanned in their enclosing context; nested ``def`` bodies run with an
empty held-lock stack (they execute later, not at definition).
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

LOCK_FACTORIES = {"make_lock": "lock", "make_rlock": "rlock"}
RAW_LOCK_CTORS = {"Lock": "lock", "RLock": "rlock"}

_PRAGMA_RE = re.compile(
    r"#\s*lint:\s*allow\(([\w\-, ]+)\)\s*(?::\s*(.*\S))?\s*$")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # repo-relative posix path
    line: int
    scope: str         # module.Class.func (or module.Class / module)
    detail: str        # stable, line-independent discriminator
    message: str

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}|{self.path}|{self.scope}|{self.detail}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] {self.message}"
                f"  ({self.scope})")


@dataclass
class LockDef:
    name: str          # canonical node name, e.g. "host._ShardProxy._order_lock"
    kind: str          # "lock" | "rlock"
    module: str
    cls: Optional[str]
    attr: str
    path: str
    line: int
    via_factory: bool  # created through make_lock/make_rlock


@dataclass
class CallInfo:
    line: int
    held: Tuple[str, ...]         # lock names held at the call
    recv: Optional[str]           # dotted receiver ("self.cos"), None for Name calls
    name: str                     # final attr / function name
    resolved: Optional[tuple]     # ("method",cls,meth) | ("attrmethod",cls,attr,meth)
                                  # | ("localfunc",qual) | ("func",mod,name)
    guarded: frozenset            # expr strings known non-None here
    arg0: Optional[str]           # first positional arg when a str constant
    kw_site: Optional[str]        # site= kwarg when a str constant
    kwargs: frozenset             # kwarg names present


@dataclass
class AcqEvent:
    lock: str
    line: int
    via: str                      # "with" | "acquire"
    held: Tuple[str, ...]         # locks already held when acquiring


@dataclass
class FuncModel:
    qualname: str                 # "Class.meth" | "func" | "outer.inner"
    module: str
    cls: Optional[str]
    path: str
    line: int
    acquires: List[AcqEvent] = field(default_factory=list)
    calls: List[CallInfo] = field(default_factory=list)
    # parameter names (incl. defaults-bound closure captures) — rules
    # may treat a parameter receiver as a caller-guaranteed value
    params: frozenset = frozenset()
    # fixed-point results (filled by link step)
    acquires_closure: Set[str] = field(default_factory=set)
    may_block: Optional[str] = None   # label of the first blocking call, or None


@dataclass
class ClassModel:
    name: str
    module: str
    path: str
    line: int
    methods: Set[str] = field(default_factory=set)
    # attr -> (module, Class) for self.attr = ClassName(...) assignments
    attr_types: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    # attr -> lock name (includes Condition aliases)
    lock_attrs: Dict[str, str] = field(default_factory=dict)
    # resources constructed in __init__: attr -> (ctor name, line)
    init_resources: Dict[str, Tuple[str, int]] = field(default_factory=dict)
    # attrs assigned StoreStats() (for the atomic-counter rule)
    storestats_attrs: Set[str] = field(default_factory=set)


@dataclass
class ModuleModel:
    path: Path
    relpath: str
    modname: str
    tree: ast.Module
    classes: Dict[str, ClassModel] = field(default_factory=dict)
    funcs: Dict[str, FuncModel] = field(default_factory=dict)
    locks: Dict[str, LockDef] = field(default_factory=dict)
    module_lock_vars: Dict[str, str] = field(default_factory=dict)
    local_lock_vars: Dict[Tuple[str, str], str] = field(default_factory=dict)
    imports: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    # line -> [(rule, reason-or-None)]
    pragmas: Dict[int, List[Tuple[str, Optional[str]]]] = \
        field(default_factory=dict)
    fault_manifest: Optional[Set[str]] = None
    metric_manifest: Optional[Set[str]] = None
    # AugAssign on <recv>.<attr>: (line, scope, recv, attr)
    augassigns: List[Tuple[int, str, str, str]] = field(default_factory=list)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def dotted(node: ast.AST) -> Optional[str]:
    """'self.cos.put' -> 'self.cos' receiver chains; None if not a plain
    Name/Attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_nonnull_test(test: ast.AST) -> Optional[str]:
    """'X is not None' -> dotted X."""
    if (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], ast.IsNot)
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value is None):
        return dotted(test.left)
    return None


def _is_null_test(test: ast.AST) -> Optional[str]:
    """'X is None' -> dotted X."""
    if (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Is)
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value is None):
        return dotted(test.left)
    return None


def _terminates(stmts: Sequence[ast.stmt]) -> bool:
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))


def scan_pragmas(source: str) -> Dict[int, List[Tuple[str, Optional[str]]]]:
    out: Dict[int, List[Tuple[str, Optional[str]]]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _PRAGMA_RE.search(line)
        if m:
            rules = [r.strip() for r in m.group(1).split(",") if r.strip()]
            reason = m.group(2)
            out[i] = [(r, reason) for r in rules]
    return out


# ---------------------------------------------------------------------------
# pass 1: declarations (locks, types, resources, imports, manifest)
# ---------------------------------------------------------------------------

class _DeclVisitor(ast.NodeVisitor):
    def __init__(self, mm: ModuleModel):
        self.mm = mm
        self.cls_stack: List[str] = []
        self.func_stack: List[str] = []

    # -- context -----------------------------------------------------------

    def _qual(self) -> str:
        return ".".join(self.func_stack)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        if self.func_stack:          # classes inside functions: skip
            return
        cm = ClassModel(name=node.name, module=self.mm.modname,
                        path=self.mm.relpath, line=node.lineno)
        self.mm.classes[node.name] = cm
        self.cls_stack.append(node.name)
        self.generic_visit(node)
        self.cls_stack.pop()

    def _visit_func(self, node) -> None:
        cls = self.cls_stack[-1] if self.cls_stack else None
        if cls and not self.func_stack:
            self.mm.classes[cls].methods.add(node.name)
        self.func_stack.append(node.name)
        self.generic_visit(node)
        self.func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            name = a.asname or a.name.split(".")[0]
            self.mm.imports[name] = (a.name, "")

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        for a in node.names:
            self.mm.imports[a.asname or a.name] = (mod, a.name)

    # -- lock / type / resource extraction ---------------------------------

    def _lock_ctor(self, value: ast.AST) -> Optional[Tuple[str, Optional[str], Optional[ast.AST]]]:
        """Return (kind, factory-name-literal, condition-underlying-expr)
        when `value` constructs a lock/rlock/condition; else None."""
        if not isinstance(value, ast.Call):
            return None
        fn = value.func
        fname = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else None)
        if fname in LOCK_FACTORIES:
            lit = None
            if value.args and isinstance(value.args[0], ast.Constant) \
                    and isinstance(value.args[0].value, str):
                lit = value.args[0].value
            return (LOCK_FACTORIES[fname], lit, None)
        if fname in RAW_LOCK_CTORS and self._is_threading(fn):
            return (RAW_LOCK_CTORS[fname], None, None)
        if fname == "Condition" and self._is_threading(fn):
            under = value.args[0] if value.args else None
            return ("lock", None, under if under is not None else False)
        return None

    def _is_threading(self, fn: ast.AST) -> bool:
        if isinstance(fn, ast.Attribute):
            return dotted(fn.value) == "threading"
        if isinstance(fn, ast.Name):
            src = self.mm.imports.get(fn.id)
            return bool(src and src[0] == "threading")
        return False

    def _class_call(self, value: ast.AST) -> Optional[Tuple[str, Optional[str]]]:
        """(call name, base chain) when `value` (or a sub-expression of an
        IfExp/BoolOp) is `Name(...)` or `base.Name(...)` — e.g.
        ('Thread', 'threading'), ('create', 'ShmArena'), ('COS', None)."""
        for node in ast.walk(value) if isinstance(
                value, (ast.IfExp, ast.BoolOp)) else [value]:
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if isinstance(fn, ast.Name):
                return (fn.id, None)
            if isinstance(fn, ast.Attribute):
                return (fn.attr, dotted(fn.value))
        return None

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        if len(node.targets) != 1:
            return
        tgt = node.targets[0]
        cls = self.cls_stack[-1] if self.cls_stack else None
        in_init = bool(self.func_stack) and self.func_stack[0] == "__init__"

        # site manifests: FAULT_SITES / METRIC_SITES = frozenset({...})
        if (isinstance(tgt, ast.Name)
                and tgt.id in ("FAULT_SITES", "METRIC_SITES")
                and not self.func_stack and not self.cls_stack):
            sites = {n.value for n in ast.walk(node.value)
                     if isinstance(n, ast.Constant)
                     and isinstance(n.value, str)}
            if tgt.id == "FAULT_SITES":
                self.mm.fault_manifest = sites
            else:
                self.mm.metric_manifest = sites
            return

        lock = self._lock_ctor(node.value)
        is_self_attr = (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self" and cls is not None)

        if lock is not None:
            kind, lit, cond_under = lock
            if cond_under not in (None,):
                # Condition: alias to the underlying lock when resolvable
                if cond_under is not False:
                    under = dotted(cond_under)
                    target_lock = None
                    if under and under.startswith("self.") and cls:
                        target_lock = self.mm.classes[cls].lock_attrs.get(
                            under[5:])
                    elif under:
                        target_lock = self._lookup_var(under)
                    if target_lock is not None:
                        self._bind_lock_target(tgt, cls, target_lock)
                        return
                # Condition() with its own implicit lock: fall through as
                # a fresh plain lock named after the attribute
            name = lit
            if is_self_attr:
                attr = tgt.attr
                if name is None:
                    name = f"{self.mm.modname}.{cls}.{attr}"
                self.mm.classes[cls].lock_attrs[attr] = name
                self.mm.locks[name] = LockDef(
                    name=name, kind=kind, module=self.mm.modname, cls=cls,
                    attr=attr, path=self.mm.relpath, line=node.lineno,
                    via_factory=lit is not None)
            elif isinstance(tgt, ast.Name):
                var = tgt.id
                if self.func_stack:
                    qual = (f"{cls}.{self._qual()}" if cls else self._qual())
                    if name is None:
                        name = f"{self.mm.modname}.{qual}.{var}"
                    self.mm.local_lock_vars[(qual, var)] = name
                else:
                    if name is None:
                        name = f"{self.mm.modname}.{var}"
                    self.mm.module_lock_vars[var] = name
                self.mm.locks[name] = LockDef(
                    name=name, kind=kind, module=self.mm.modname, cls=None,
                    attr=var, path=self.mm.relpath, line=node.lineno,
                    via_factory=lit is not None)
            return

        if is_self_attr:
            attr = tgt.attr
            cm = self.mm.classes[cls]
            called = self._class_call(node.value)
            if called is not None:
                cname, base = called
                if in_init and cname in ("Thread", "ThreadPoolExecutor",
                                         "SharedMemory"):
                    cm.init_resources[attr] = (cname, node.lineno)
                if cname == "StoreStats":
                    cm.storestats_attrs.add(attr)
                # `ClassName(...)` or `ClassName.classmethod(...)`
                resolved = self._resolve_class(cname)
                if resolved is None and base is not None and "." not in base:
                    resolved = self._resolve_class(base)
                if resolved is not None:
                    cm.attr_types[attr] = resolved

    def _bind_lock_target(self, tgt, cls, lockname: str) -> None:
        if (isinstance(tgt, ast.Attribute) and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self" and cls is not None):
            self.mm.classes[cls].lock_attrs[tgt.attr] = lockname
        elif isinstance(tgt, ast.Name):
            if self.func_stack:
                qual = (f"{cls}.{self._qual()}" if cls else self._qual())
                self.mm.local_lock_vars[(qual, tgt.id)] = lockname
            else:
                self.mm.module_lock_vars[tgt.id] = lockname

    def _lookup_var(self, var: str) -> Optional[str]:
        cls = self.cls_stack[-1] if self.cls_stack else None
        if self.func_stack:
            qual = (f"{cls}.{self._qual()}" if cls else self._qual())
            hit = self.mm.local_lock_vars.get((qual, var))
            if hit:
                return hit
        return self.mm.module_lock_vars.get(var)

    def _resolve_class(self, name: str) -> Optional[Tuple[str, str]]:
        """Map a local class name to (module, Class); linked globally later."""
        if name in self.mm.classes:
            return (self.mm.modname, name)
        src = self.mm.imports.get(name)
        if src and src[1]:
            return (src[0].split(".")[-1], src[1])
        return None


# ---------------------------------------------------------------------------
# pass 2: function-body walk (held locks, calls, guards, acquisitions)
# ---------------------------------------------------------------------------

class _FuncWalker:
    def __init__(self, mm: ModuleModel, fm: FuncModel,
                 lock_scope: Dict[str, str]):
        self.mm = mm
        self.fm = fm
        self.lock_scope = dict(lock_scope)   # local var -> lock name
        self.nested: List[Tuple[ast.AST, str, Dict[str, str]]] = []

    # -- lock expression resolution ----------------------------------------

    def _resolve_lock(self, expr: ast.AST) -> Optional[str]:
        d = dotted(expr)
        if d is None:
            return None
        if d.startswith("self.") and self.fm.cls:
            cm = self.mm.classes.get(self.fm.cls)
            if cm:
                return cm.lock_attrs.get(d[5:])
            return None
        if "." not in d:
            if d in self.lock_scope:
                return self.lock_scope[d]
            return self.mm.module_lock_vars.get(d)
        return None

    # -- statement walking --------------------------------------------------

    def walk(self, body: Sequence[ast.stmt], held: Tuple[str, ...],
             guards: frozenset) -> None:
        self._stmts(body, list(held), guards)

    def _stmts(self, body: Sequence[ast.stmt], held: List[str],
               guards: frozenset) -> None:
        for stmt in body:
            # bare `L.release()` / `L.acquire()` statements bracket a
            # region within this list (e.g. a with-body that explicitly
            # drops the lock around a blocking call and re-takes it in a
            # `finally`) — honored at any nesting depth
            tog = self._toggle(stmt)
            if tog is not None:
                name, op = tog
                if op == "release" and name in held:
                    held.remove(name)
                    continue
                if op == "acquire" and name not in held:
                    self.fm.acquires.append(AcqEvent(
                        lock=name, line=stmt.lineno, via="acquire",
                        held=tuple(held)))
                    held.append(name)
                    continue
            guards = self._stmt(stmt, held, guards)

    def _stmt(self, stmt: ast.stmt, held: List[str],
              guards: frozenset) -> frozenset:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            qual = f"{self.fm.qualname}.{stmt.name}"
            self.nested.append((stmt, qual, dict(self.lock_scope)))
            return guards
        if isinstance(stmt, ast.With):
            return self._with(stmt, held, guards)
        if isinstance(stmt, ast.If):
            nn = _is_nonnull_test(stmt.test)
            null = _is_null_test(stmt.test)
            self._expr(stmt.test, held, guards)
            nns = {nn} if nn else set()
            if not nns and isinstance(stmt.test, ast.BoolOp) \
                    and isinstance(stmt.test.op, ast.And):
                # `if X is not None and <...>:` — every non-null
                # conjunct guards the body
                nns = {g for g in (_is_nonnull_test(v)
                                   for v in stmt.test.values) if g}
            if nns:
                self._stmts(stmt.body, held, guards | nns)
                self._stmts(stmt.orelse, held, guards)
                return guards
            self._stmts(stmt.body, held, guards)
            self._stmts(stmt.orelse, held,
                        guards | ({null} if null else set()))
            if null and _terminates(stmt.body):
                return guards | {null}   # `if X is None: return` pattern
            return guards
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._expr(stmt.iter, held, guards)
            self._stmts(stmt.body, held, guards)
            self._stmts(stmt.orelse, held, guards)
            return guards
        if isinstance(stmt, ast.While):
            self._expr(stmt.test, held, guards)
            self._stmts(stmt.body, held, guards)
            self._stmts(stmt.orelse, held, guards)
            return guards
        if isinstance(stmt, ast.Try):
            self._stmts(stmt.body, held, guards)
            for h in stmt.handlers:
                self._stmts(h.body, held, guards)
            self._stmts(stmt.orelse, held, guards)
            self._stmts(stmt.finalbody, held, guards)
            return guards
        if isinstance(stmt, ast.AugAssign):
            recv_attr = stmt.target
            if isinstance(recv_attr, ast.Attribute):
                recv = dotted(recv_attr.value)
                if recv is not None:
                    self.mm.augassigns.append(
                        (stmt.lineno,
                         f"{self.mm.modname}.{self.fm.qualname}",
                         recv, recv_attr.attr))
            self._expr(stmt.value, held, guards)
            return guards
        # everything else: walk expressions for calls
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._expr(child, held, guards)
            elif isinstance(child, ast.stmt):
                self._stmt(child, held, guards)
        return guards

    def _with(self, stmt: ast.With, held: List[str],
              guards: frozenset) -> frozenset:
        pushed: List[str] = []
        for item in stmt.items:
            self._expr(item.context_expr, held, guards)
            lock = self._resolve_lock(item.context_expr)
            if lock is not None and lock not in held:
                self.fm.acquires.append(AcqEvent(
                    lock=lock, line=stmt.lineno, via="with",
                    held=tuple(held)))
                held.append(lock)
                pushed.append(lock)
        self._stmts(stmt.body, held, guards)
        for lock in pushed:
            if lock in held:         # a nested toggle may have dropped it
                held.remove(lock)
        return guards

    def _toggle(self, stmt: ast.stmt) -> Optional[Tuple[str, str]]:
        """`L.release()` / `L.acquire()` as a bare statement on a lock."""
        if not (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)):
            return None
        call = stmt.value
        if not (isinstance(call.func, ast.Attribute)
                and call.func.attr in ("release", "acquire")):
            return None
        lock = self._resolve_lock(call.func.value)
        if lock is None:
            return None
        return (lock, call.func.attr)

    # -- expression walking --------------------------------------------------

    def _expr(self, node: ast.expr, held: List[str],
              guards: frozenset) -> None:
        if isinstance(node, ast.Call):
            self._call(node, held, guards)
            return
        if isinstance(node, ast.BoolOp) and isinstance(node.op, ast.And):
            g = guards
            for v in node.values:
                self._expr(v, held, g)
                nn = _is_nonnull_test(v)
                if nn:
                    g = g | {nn}
            return
        if isinstance(node, ast.IfExp):
            nn = _is_nonnull_test(node.test)
            self._expr(node.test, held, guards)
            self._expr(node.body, held, guards | ({nn} if nn else set()))
            self._expr(node.orelse, held, guards)
            return
        if isinstance(node, ast.Lambda):
            self._expr(node.body, held, guards)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr(child, held, guards)
            elif isinstance(child, ast.comprehension):
                self._expr(child.iter, held, guards)
                for c in child.ifs:
                    self._expr(c, held, guards)

    def _call(self, node: ast.Call, held: List[str],
              guards: frozenset) -> None:
        fn = node.func
        recv = None
        name = None
        resolved = None
        if isinstance(fn, ast.Attribute):
            name = fn.attr
            recv = dotted(fn.value)
            if recv == "self" and self.fm.cls:
                resolved = ("method", self.fm.cls, name)
            elif recv and recv.startswith("self.") and self.fm.cls \
                    and recv.count(".") == 1:
                resolved = ("attrmethod", self.fm.cls, recv[5:], name)
            # explicit acquire events outside `with` (edge provenance)
            if name == "acquire":
                lock = self._resolve_lock(fn.value)
                if lock is not None and lock not in held:
                    self.fm.acquires.append(AcqEvent(
                        lock=lock, line=node.lineno, via="acquire",
                        held=tuple(held)))
        elif isinstance(fn, ast.Name):
            name = fn.id
            # bare-name calls resolve at link time (the target function
            # may be defined later in the file / in another module)
            resolved = ("name", name)
        if name is not None:
            arg0 = None
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                arg0 = node.args[0].value
            kw_site = None
            kwargs = set()
            for kw in node.keywords:
                if kw.arg:
                    kwargs.add(kw.arg)
                    if kw.arg == "site" and isinstance(kw.value, ast.Constant) \
                            and isinstance(kw.value.value, str):
                        kw_site = kw.value.value
            self.fm.calls.append(CallInfo(
                line=node.lineno, held=tuple(held), recv=recv, name=name,
                resolved=resolved, guarded=frozenset(guards), arg0=arg0,
                kw_site=kw_site, kwargs=frozenset(kwargs)))
        for a in node.args:
            self._expr(a, held, guards)
        for kw in node.keywords:
            self._expr(kw.value, held, guards)
        if isinstance(fn, (ast.Attribute, ast.Subscript)):
            self._expr(fn.value, held, guards)


# ---------------------------------------------------------------------------
# module + tree scan
# ---------------------------------------------------------------------------

def scan_module(path: Path, root: Path) -> ModuleModel:
    source = path.read_text()
    tree = ast.parse(source, filename=str(path))
    try:
        rel = path.relative_to(root).as_posix()
    except ValueError:
        rel = path.as_posix()
    mm = ModuleModel(path=path, relpath=rel, modname=path.stem, tree=tree)
    mm.pragmas = scan_pragmas(source)
    _DeclVisitor(mm).visit(tree)

    # queue every function (methods, module funcs), walk with nesting
    queue: List[Tuple[ast.AST, str, Optional[str], Dict[str, str]]] = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            queue.append((node, node.name, None, {}))
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    queue.append((sub, f"{node.name}.{sub.name}",
                                  node.name, {}))
    while queue:
        node, qual, cls, scope = queue.pop(0)
        # local lock vars declared anywhere in this function body
        local_scope = dict(scope)
        for (q, var), lockname in mm.local_lock_vars.items():
            if q == qual:
                local_scope[var] = lockname
        a = node.args
        params = frozenset(
            p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs))
        fm = FuncModel(qualname=qual, module=mm.modname, cls=cls,
                       path=mm.relpath, line=node.lineno, params=params)
        mm.funcs[qual] = fm
        walker = _FuncWalker(mm, fm, local_scope)
        walker.walk(node.body, held=(), guards=frozenset())
        for sub, subqual, subscope in walker.nested:
            queue.append((sub, subqual, cls, subscope))
    return mm


def iter_py_files(targets: Sequence[str]) -> List[Path]:
    out: List[Path] = []
    for t in targets:
        p = Path(t)
        if p.is_dir():
            out.extend(sorted(f for f in p.rglob("*.py")
                              if "__pycache__" not in f.parts))
        elif p.suffix == ".py":
            out.append(p)
    return out


@dataclass
class TreeModel:
    root: Path
    modules: Dict[str, ModuleModel]           # modname -> model
    classes: Dict[Tuple[str, str], ClassModel] = field(default_factory=dict)
    funcs: Dict[Tuple[str, str], FuncModel] = field(default_factory=dict)
    locks: Dict[str, LockDef] = field(default_factory=dict)
    fault_manifest: Set[str] = field(default_factory=set)
    metric_manifest: Set[str] = field(default_factory=set)

    def pragma_for(self, mm: ModuleModel, rule: str,
                   line: int) -> Optional[Tuple[str, Optional[str]]]:
        """A pragma waives a finding from its own line or the line above."""
        for ln in (line, line - 1):
            for r, reason in mm.pragmas.get(ln, ()):
                if r == rule:
                    return (r, reason)
        return None


def scan_tree(targets: Sequence[str], root: Optional[Path] = None) -> TreeModel:
    files = iter_py_files(targets)
    root = root or Path.cwd()
    modules: Dict[str, ModuleModel] = {}
    for f in files:
        mm = scan_module(f, root)
        if mm.modname in modules:
            # same-stem collision (e.g. package __init__): suffix it
            mm.modname = f"{f.parent.name}.{f.stem}"
        modules[mm.modname] = mm
    tm = TreeModel(root=root, modules=modules)
    for mm in modules.values():
        for cname, cm in mm.classes.items():
            tm.classes[(mm.modname, cname)] = cm
        for qual, fmod in mm.funcs.items():
            tm.funcs[(mm.modname, qual)] = fmod
        for name, ld in mm.locks.items():
            tm.locks[name] = ld
        if mm.fault_manifest:
            tm.fault_manifest |= mm.fault_manifest
        if mm.metric_manifest:
            tm.metric_manifest |= mm.metric_manifest
    _link(tm)
    return tm


# ---------------------------------------------------------------------------
# link step: resolve calls across modules, fixed-point closures
# ---------------------------------------------------------------------------

def resolve_callee(tm: TreeModel, mm: ModuleModel,
                   fm: FuncModel, ci: CallInfo) -> Optional[FuncModel]:
    r = ci.resolved
    if r is None:
        return None
    if r[0] == "method":
        return tm.funcs.get((mm.modname, f"{r[1]}.{r[2]}"))
    if r[0] == "attrmethod":
        _, cls, attr, meth = r
        cm = tm.classes.get((mm.modname, cls))
        if cm is None:
            return None
        t = cm.attr_types.get(attr)
        if t is None:
            return None
        return tm.funcs.get((t[0], f"{t[1]}.{meth}"))
    if r[0] == "name":
        name = r[1]
        # sibling nested function (closure), then module-level function,
        # then an imported module-level function
        if "." in fm.qualname:
            parent = fm.qualname.rsplit(".", 1)[0]
            hit = tm.funcs.get((mm.modname, f"{parent}.{name}"))
            if hit is not None:
                return hit
        hit = tm.funcs.get((mm.modname, name))
        if hit is not None:
            return hit
        src = mm.imports.get(name)
        if src and src[1]:
            return tm.funcs.get((src[0].split(".")[-1], src[1]))
        return None
    return None


def _link(tm: TreeModel) -> None:
    # resolve cross-module attr types: ("spill", "SpillJournal") keys are
    # already module-stem based; nothing further needed here. Compute the
    # acquires closure to a fixed point.
    for fmod in tm.funcs.values():
        fmod.acquires_closure = {a.lock for a in fmod.acquires}
    changed = True
    while changed:
        changed = False
        for (modname, _), fmod in tm.funcs.items():
            mm = tm.modules[modname]
            for ci in fmod.calls:
                callee = resolve_callee(tm, mm, fmod, ci)
                if callee is None:
                    continue
                add = callee.acquires_closure - fmod.acquires_closure
                if add:
                    fmod.acquires_closure |= add
                    changed = True
