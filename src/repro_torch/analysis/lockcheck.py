"""Lock/field discipline static pass (pure AST — imports nothing it
analyzes).

Enforced rules, against the conventions of
:mod:`repro.analysis.annotations`:

* ``undeclared-lock`` — a class constructs a ``threading`` lock but
  carries no ``@guarded_by`` declaration.
* ``unused-lock`` — a declared lock no method ever acquires (dead
  "thread safety" that protects nothing).
* ``unranked-lock`` — a ``@guarded_by`` class missing from the
  ``LOCK_ORDER`` hierarchy (its own module's or the global one).
* ``unguarded-field`` — a declared guarded field mutated outside a
  ``with self.<lock>`` scope (methods named ``*_locked`` or marked
  ``# analysis: caller-locks`` are entered with the lock held).
* ``lock-order`` — a lexical nesting, or a one-hop call into a locking
  method of a typed collaborator, that acquires locks against the
  declared hierarchy (the PR 4 broker-deadlock shape).
* ``lock-free`` — a threading primitive (acquisition or construction)
  reachable from a ``@lock_free`` class through ``self.*`` calls — the
  ``threadsafe=False`` fast-path contract.
* ``single-writer`` — a ``@single_writer`` class mutating undeclared
  fields outside ``__init__``, or acquiring any lock.

Type information is heuristic and deliberately shallow: parameter
annotations, ``self.x = ClassName(...)`` constructor assignments, and
``x: ClassName`` annotations.  Anything unresolved is skipped, never
guessed — the runtime witness covers what static typing cannot see.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .annotations import LOCK_ORDER as GLOBAL_LOCK_ORDER
from .report import CALLER_LOCKS_RE, Finding, Suppressions

__all__ = ["collect", "check", "run_lockcheck", "ClassInfo"]

_LOCK_FACTORIES = {"Lock", "RLock"}
_THREAD_PRIMITIVES = {"Lock", "RLock", "Condition", "Event", "Semaphore",
                      "BoundedSemaphore", "Barrier", "Thread"}
_MUTATORS = {"append", "appendleft", "add", "discard", "remove", "pop",
             "popleft", "popitem", "clear", "update", "extend", "insert",
             "setdefault", "sort", "reverse"}


@dataclass
class MethodInfo:
    node: ast.FunctionDef
    caller_locks: bool = False
    acquires_own_lock: bool = False


@dataclass
class ClassInfo:
    name: str
    path: str
    node: ast.ClassDef
    guarded: tuple[str, ...] = ()
    lock_attr: str | None = None
    decorated: bool = False          # carries @guarded_by
    lock_free: bool = False
    single_writer: tuple[str, ...] | None = None
    created_locks: list[tuple[str, int]] = field(default_factory=list)
    methods: dict[str, MethodInfo] = field(default_factory=dict)
    #: self attribute → candidate class names (first resolvable wins)
    attr_types: dict[str, list[str]] = field(default_factory=dict)
    bases: list[str] = field(default_factory=list)


@dataclass
class ModuleInfo:
    path: str
    tree: ast.Module
    source_lines: list[str]
    classes: list[ClassInfo] = field(default_factory=list)
    lock_order: tuple[str, ...] | None = None


# ---------------------------------------------------------------------------
# small AST helpers
# ---------------------------------------------------------------------------


def _decorator_name(dec: ast.expr) -> tuple[str, ast.Call | None]:
    """('guarded_by', call-node) for both bare and called decorators."""
    target = dec.func if isinstance(dec, ast.Call) else dec
    call = dec if isinstance(dec, ast.Call) else None
    if isinstance(target, ast.Attribute):
        return target.attr, call
    if isinstance(target, ast.Name):
        return target.id, call
    return "", call


def _annotation_names(node: ast.expr | None) -> list[str]:
    """Candidate class names mentioned in a type annotation."""
    if node is None:
        return []
    out = []
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.append(n.id)
        elif isinstance(n, ast.Constant) and isinstance(n.value, str):
            # string annotations: "TaskMonitor | None"
            out.extend(p.strip() for p in n.value.split("|"))
    return [n for n in out if n and n not in ("None", "Optional")]


def _self_field(node: ast.expr) -> str | None:
    """Field name when ``node`` is (a subscript/attribute of)
    ``self.<field>`` — the base guarded object of a mutation target."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        inner = node.value
        if (isinstance(node, ast.Attribute)
                and isinstance(inner, ast.Name) and inner.id == "self"):
            return node.attr
        node = inner
    return None


def _is_threading_primitive(call: ast.Call) -> str | None:
    f = call.func
    if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
            and f.value.id == "threading"
            and f.attr in _THREAD_PRIMITIVES):
        return f.attr
    if isinstance(f, ast.Name) and f.id in _THREAD_PRIMITIVES:
        return f.id  # from threading import Lock
    return None


def _mutated_fields(stmt: ast.stmt) -> list[tuple[str, int]]:
    """``self.<field>`` names mutated by one statement (no recursion
    into nested statements — the walker handles those)."""
    out: list[tuple[str, int]] = []
    if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        for t in targets:
            elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
            for e in elts:
                f = _self_field(e)
                if f is not None:
                    out.append((f, e.lineno))
    elif isinstance(stmt, ast.Delete):
        for t in stmt.targets:
            f = _self_field(t)
            if f is not None:
                out.append((f, t.lineno))
    for call in _calls_in_stmt_exprs(stmt):
        fn = call.func
        if isinstance(fn, ast.Attribute) and fn.attr in _MUTATORS:
            f = _self_field(fn.value)
            if f is not None:
                out.append((f, call.lineno))
    return out


_BLOCK_FIELDS = ("body", "orelse", "finalbody")


def _calls_in_stmt_exprs(stmt: ast.stmt) -> list[ast.Call]:
    """Call nodes in the *expressions* of one statement, not descending
    into nested statement blocks or nested function bodies."""
    out: list[ast.Call] = []
    stack: list[ast.AST] = []
    for name, value in ast.iter_fields(stmt):
        if name in _BLOCK_FIELDS or name == "handlers":
            continue
        if isinstance(value, ast.expr):
            stack.append(value)
        elif isinstance(value, list):
            stack.extend(v for v in value if isinstance(v, ast.expr))
    while stack:
        n = stack.pop()
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            stack.append(child)
        if isinstance(n, ast.Call):
            out.append(n)
    return out


# ---------------------------------------------------------------------------
# collection
# ---------------------------------------------------------------------------


def _collect_attr_types(cls: ClassInfo) -> None:
    for m in cls.methods.values():
        fn = m.node
        params = {a.arg: _annotation_names(a.annotation)
                  for a in (fn.args.posonlyargs + fn.args.args
                            + fn.args.kwonlyargs)}
        for node in ast.walk(fn):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue
                cands = _value_type_candidates(node.value, params)
                if isinstance(node, ast.AnnAssign):
                    cands = _annotation_names(node.annotation) + cands
                if cands:
                    cls.attr_types.setdefault(t.attr, []).extend(cands)
    # class-level annotations: ``monitor: TaskMonitor``
    for stmt in cls.node.body:
        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target,
                                                          ast.Name):
            cands = _annotation_names(stmt.annotation)
            if cands:
                cls.attr_types.setdefault(stmt.target.id, []).extend(cands)


def _value_type_candidates(value: ast.expr | None,
                           params: dict[str, list[str]]) -> list[str]:
    if value is None:
        return []
    if isinstance(value, ast.Call) and isinstance(value.func, ast.Name):
        return [value.func.id]
    if isinstance(value, ast.Name):
        return params.get(value.id, [])
    if isinstance(value, ast.IfExp):
        return (_value_type_candidates(value.body, params)
                + _value_type_candidates(value.orelse, params))
    return []


def collect(path: str, source: str) -> ModuleInfo:
    tree = ast.parse(source, filename=path)
    mod = ModuleInfo(path=path, tree=tree,
                     source_lines=source.splitlines())
    for stmt in tree.body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and stmt.targets[0].id == "LOCK_ORDER"
                and isinstance(stmt.value, (ast.Tuple, ast.List))):
            names = [e.value for e in stmt.value.elts
                     if isinstance(e, ast.Constant)
                     and isinstance(e.value, str)]
            mod.lock_order = tuple(names)
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            mod.classes.append(_collect_class(node, mod))
    return mod


def _collect_class(node: ast.ClassDef, mod: ModuleInfo) -> ClassInfo:
    cls = ClassInfo(name=node.name, path=mod.path, node=node,
                    bases=[b.id for b in node.bases
                           if isinstance(b, ast.Name)])
    for dec in node.decorator_list:
        name, call = _decorator_name(dec)
        if name == "guarded_by":
            cls.decorated = True
            cls.lock_attr = "_lock"
            if call is not None:
                cls.guarded = tuple(a.value for a in call.args
                                    if isinstance(a, ast.Constant)
                                    and isinstance(a.value, str))
                for kw in call.keywords:
                    if kw.arg == "lock" and isinstance(kw.value,
                                                       ast.Constant):
                        cls.lock_attr = kw.value.value
        elif name == "lock_free":
            cls.lock_free = True
        elif name == "single_writer":
            cls.single_writer = tuple(
                a.value for a in (call.args if call else [])
                if isinstance(a, ast.Constant) and isinstance(a.value, str))
    for stmt in node.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            caller_locks = (
                stmt.name.endswith("_locked")
                or _has_marker(mod, stmt.lineno)
                or any(_has_marker(mod, d.lineno)
                       for d in stmt.decorator_list))
            cls.methods[stmt.name] = MethodInfo(node=stmt,
                                                caller_locks=caller_locks)
    # lock creation + own-lock acquisition, per method
    for m in cls.methods.values():
        lock_attr = cls.lock_attr
        for sub in ast.walk(m.node):
            if (isinstance(sub, ast.Assign)
                    and isinstance(sub.value, ast.Call)
                    and _is_threading_primitive(sub.value)
                    in _LOCK_FACTORIES):
                for t in sub.targets:
                    f = _self_field(t)
                    if f is not None:
                        cls.created_locks.append((f, sub.lineno))
            if lock_attr is not None:
                if (isinstance(sub, (ast.With, ast.AsyncWith))
                        and any(_self_field(i.context_expr) == lock_attr
                                for i in sub.items)):
                    m.acquires_own_lock = True
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in ("acquire", "release")
                        and _self_field(sub.func.value) == lock_attr):
                    m.acquires_own_lock = True
    _collect_attr_types(cls)
    return cls


def _has_marker(mod: ModuleInfo, lineno: int) -> bool:
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(mod.source_lines) \
                and CALLER_LOCKS_RE.search(mod.source_lines[ln - 1]):
            return True
    return False


# ---------------------------------------------------------------------------
# checking
# ---------------------------------------------------------------------------


class _Checker:
    def __init__(self, modules: list[ModuleInfo]) -> None:
        self.modules = modules
        self.classes: dict[str, ClassInfo] = {}
        for mod in modules:
            for cls in mod.classes:
                self.classes.setdefault(cls.name, cls)
        self.ranks: dict[str, int] = {n: i for i, n
                                      in enumerate(GLOBAL_LOCK_ORDER)}
        for mod in modules:
            if mod.lock_order:
                for i, n in enumerate(mod.lock_order):
                    self.ranks[n] = i
        self.findings: list[Finding] = []

    # -- type resolution ---------------------------------------------------

    def _resolve(self, name_candidates: list[str]) -> ClassInfo | None:
        for n in name_candidates:
            cls = self.classes.get(n)
            if cls is not None:
                return cls
        return None

    def _mro(self, cls: ClassInfo) -> list[ClassInfo]:
        out, seen, queue = [], set(), [cls.name]
        while queue:
            n = queue.pop(0)
            if n in seen:
                continue
            seen.add(n)
            c = self.classes.get(n)
            if c is not None:
                out.append(c)
                queue.extend(c.bases)
        return out

    def _effective_lock_attr(self, cls: ClassInfo) -> str | None:
        for c in self._mro(cls):
            if c.lock_attr is not None:
                return c.lock_attr
        return None

    def _effective_rank(self, cls: ClassInfo) -> int | None:
        for c in self._mro(cls):
            if c.name in self.ranks:
                return self.ranks[c.name]
        return None

    def _find_method(self, cls: ClassInfo, name: str) -> MethodInfo | None:
        for c in self._mro(cls):
            if name in c.methods:
                return c.methods[name]
        return None

    def _is_locking_method(self, cls: ClassInfo, name: str) -> bool:
        m = self._find_method(cls, name)
        return m is not None and m.acquires_own_lock

    def _expr_type(self, expr: ast.expr, cls: ClassInfo,
                   local_types: dict[str, list[str]]) -> ClassInfo | None:
        """Resolve the class of an attribute chain rooted at ``self`` or
        a typed local/parameter (depth-limited, heuristic)."""
        if isinstance(expr, ast.Name):
            if expr.id == "self":
                return cls
            return self._resolve(local_types.get(expr.id, []))
        if isinstance(expr, ast.Attribute):
            base = self._expr_type(expr.value, cls, local_types)
            if base is None:
                return None
            for c in self._mro(base):
                cands = c.attr_types.get(expr.attr)
                if cands:
                    return self._resolve(cands)
            return None
        return None

    def _resolve_with_lock(self, expr: ast.expr, cls: ClassInfo,
                           local_types: dict[str, list[str]],
                           ) -> tuple[int, str] | None:
        """(rank, owner-name) when ``expr`` is a known lock object."""
        if not isinstance(expr, ast.Attribute):
            return None
        owner = self._expr_type(expr.value, cls, local_types)
        if owner is None:
            return None
        if expr.attr != self._effective_lock_attr(owner):
            return None
        rank = self._effective_rank(owner)
        if rank is None:
            return None
        return rank, owner.name

    def _resolve_call_lock(self, call: ast.Call, cls: ClassInfo,
                           local_types: dict[str, list[str]],
                           ) -> tuple[int, str] | None:
        """(rank, owner) when ``call`` transiently acquires a known
        collaborator's lock (one-hop interprocedural edge)."""
        fn = call.func
        if not isinstance(fn, ast.Attribute):
            return None
        owner = self._expr_type(fn.value, cls, local_types)
        if owner is None or not self._is_locking_method(owner, fn.attr):
            return None
        rank = self._effective_rank(owner)
        if rank is None:
            return None
        return rank, owner.name

    # -- rules -------------------------------------------------------------

    def check(self) -> list[Finding]:
        for mod in self.modules:
            for cls in mod.classes:
                self._check_class(mod, cls)
        return self.findings

    def _emit(self, mod: ModuleInfo, rule: str, line: int,
              message: str) -> None:
        self.findings.append(Finding(rule=rule, path=mod.path, line=line,
                                     message=message))

    def _check_class(self, mod: ModuleInfo, cls: ClassInfo) -> None:
        if cls.created_locks and not cls.decorated and not cls.lock_free:
            for attr, line in cls.created_locks:
                self._emit(mod, "undeclared-lock", line,
                           f"{cls.name} constructs a lock in self.{attr} "
                           "but declares no @guarded_by discipline")
        if cls.decorated:
            if cls.name not in self.ranks:
                self._emit(mod, "unranked-lock", cls.node.lineno,
                           f"{cls.name} is @guarded_by-declared but "
                           "missing from LOCK_ORDER")
            if cls.created_locks and not any(
                    m.acquires_own_lock for m in cls.methods.values()):
                self._emit(mod, "unused-lock", cls.created_locks[0][1],
                           f"{cls.name}.{cls.lock_attr} is constructed "
                           "but never acquired by any method (dead lock "
                           "— remove it or guard the fields with it)")
            if not cls.lock_free:
                self._check_guarded_fields(mod, cls)
        if cls.lock_free:
            self._check_lock_free(mod, cls)
        if cls.single_writer is not None:
            self._check_single_writer(mod, cls)
        self._check_lock_order(mod, cls)

    # unguarded-field ------------------------------------------------------

    def _check_guarded_fields(self, mod: ModuleInfo, cls: ClassInfo) -> None:
        guarded = set(cls.guarded)
        if not guarded:
            return
        lock_attr = cls.lock_attr

        def walk(stmts: list[ast.stmt], held: bool) -> None:
            for s in stmts:
                if isinstance(s, (ast.With, ast.AsyncWith)):
                    now_held = held or any(
                        _self_field(i.context_expr) == lock_attr
                        for i in s.items)
                    walk(s.body, now_held)
                    continue
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    walk(s.body, False)  # closures may run lock-less
                    continue
                if not held:
                    for fname, line in _mutated_fields(s):
                        if fname in guarded:
                            self._emit(
                                mod, "unguarded-field", line,
                                f"{cls.name}.{fname} is declared guarded "
                                f"by self.{lock_attr} but mutated "
                                "outside it")
                for block in _BLOCK_FIELDS:
                    walk(getattr(s, block, []) or [], held)
                for h in getattr(s, "handlers", []) or []:
                    walk(h.body, held)

        for name, m in cls.methods.items():
            if name in ("__init__", "__new__") or m.caller_locks:
                continue
            walk(m.node.body, False)

    # lock-order -----------------------------------------------------------

    def _local_types(self, fn: ast.FunctionDef) -> dict[str, list[str]]:
        out = {a.arg: _annotation_names(a.annotation)
               for a in (fn.args.posonlyargs + fn.args.args
                         + fn.args.kwonlyargs)}
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Name)):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out.setdefault(t.id, []).append(node.value.func.id)
        return out

    def _check_lock_order(self, mod: ModuleInfo, cls: ClassInfo) -> None:
        own_rank = self._effective_rank(cls)

        def check_acquire(rank: int, owner: str, line: int,
                          held: list[tuple[int, str]]) -> None:
            for h_rank, h_owner in held:
                if h_rank >= rank:
                    what = ("re-acquisition of the non-reentrant "
                            f"{owner} lock"
                            if h_owner == owner else
                            f"acquiring {owner} (rank {rank}) while "
                            f"holding {h_owner} (rank {h_rank})")
                    self._emit(mod, "lock-order", line,
                               f"{what} inverts the declared LOCK_ORDER")
                    return

        def scan_exprs(stmt: ast.stmt, held: list[tuple[int, str]],
                       local_types: dict[str, list[str]]) -> None:
            for call in _calls_in_stmt_exprs(stmt):
                hit = self._resolve_call_lock(call, cls, local_types)
                if hit is not None:
                    check_acquire(hit[0], hit[1], call.lineno, held)

        def walk(stmts: list[ast.stmt], held: list[tuple[int, str]],
                 local_types: dict[str, list[str]]) -> None:
            for s in stmts:
                if isinstance(s, (ast.With, ast.AsyncWith)):
                    scan_exprs(s, held, local_types)
                    inner = list(held)
                    for item in s.items:
                        hit = self._resolve_with_lock(item.context_expr,
                                                      cls, local_types)
                        if hit is not None:
                            check_acquire(hit[0], hit[1],
                                          item.context_expr.lineno, inner)
                            inner = inner + [hit]
                    walk(s.body, inner, local_types)
                    continue
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    walk(s.body, [], self._local_types(s))
                    continue
                scan_exprs(s, held, local_types)
                for block in _BLOCK_FIELDS:
                    walk(getattr(s, block, []) or [], held, local_types)
                for h in getattr(s, "handlers", []) or []:
                    walk(h.body, held, local_types)

        for name, m in cls.methods.items():
            # caller-locks methods run with the instance lock held — the
            # worst case their call sites guarantee
            held0 = ([(own_rank, cls.name)]
                     if m.caller_locks and own_rank is not None else [])
            walk(m.node.body, held0, self._local_types(m.node))

    # lock-free ------------------------------------------------------------

    def _check_lock_free(self, mod: ModuleInfo, cls: ClassInfo) -> None:
        # transitive closure over self.<method>() calls, through bases
        reachable: dict[str, MethodInfo] = {}
        queue = [n for n in cls.methods]
        while queue:
            name = queue.pop()
            if name in reachable:
                continue
            m = self._find_method(cls, name)
            if m is None:
                continue
            reachable[name] = m
            for sub in ast.walk(m.node):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and isinstance(sub.func.value, ast.Name)
                        and sub.func.value.id == "self"
                        and sub.func.attr not in reachable):
                    queue.append(sub.func.attr)
        lock_attr = self._effective_lock_attr(cls)
        for name, m in reachable.items():
            if name == "__init__":
                continue  # base __init__ may build the lock it never uses
            for sub in ast.walk(m.node):
                if isinstance(sub, (ast.With, ast.AsyncWith)):
                    for item in sub.items:
                        f = _self_field(item.context_expr)
                        if f is not None and f == lock_attr:
                            self._emit(
                                mod, "lock-free", item.context_expr.lineno,
                                f"@lock_free {cls.name} reaches a lock "
                                f"acquisition in {name}()")
                elif isinstance(sub, ast.Call):
                    prim = _is_threading_primitive(sub)
                    if prim is not None:
                        self._emit(
                            mod, "lock-free", sub.lineno,
                            f"@lock_free {cls.name} reaches "
                            f"threading.{prim}() in {name}()")
                    elif (isinstance(sub.func, ast.Attribute)
                          and sub.func.attr == "acquire"
                          and _self_field(sub.func.value) == lock_attr):
                        self._emit(
                            mod, "lock-free", sub.lineno,
                            f"@lock_free {cls.name} reaches a lock "
                            f"acquire in {name}()")

    # single-writer --------------------------------------------------------

    def _check_single_writer(self, mod: ModuleInfo, cls: ClassInfo) -> None:
        declared = set(cls.single_writer or ())
        for name, m in cls.methods.items():
            if name in ("__init__", "__new__"):
                continue
            for sub in ast.walk(m.node):
                if isinstance(sub, (ast.With, ast.AsyncWith)):
                    for item in sub.items:
                        f = _self_field(item.context_expr)
                        if f is not None and f.endswith("_lock"):
                            self._emit(
                                mod, "single-writer", item.context_expr
                                .lineno,
                                f"@single_writer {cls.name} acquires a "
                                f"lock in {name}() — declare @guarded_by "
                                "instead")
            for stmt in ast.walk(m.node):
                if isinstance(stmt, ast.stmt):
                    for fname, line in _mutated_fields(stmt):
                        if fname not in declared:
                            self._emit(
                                mod, "single-writer", line,
                                f"{cls.name}.{fname} mutated in {name}() "
                                "but not declared in @single_writer(...)")


def check(modules: list[ModuleInfo]) -> list[Finding]:
    return _Checker(modules).check()


def run_lockcheck(files: list[tuple[str, str]]) -> tuple[list[Finding], int]:
    """Run the pass over ``(path, source)`` pairs; returns (findings,
    files analyzed).  Suppressions are applied per file."""
    modules = [collect(path, source) for path, source in files]
    raw = check(modules)
    out: list[Finding] = []
    for mod in modules:
        sup = Suppressions(mod.path, mod.source_lines)
        out.extend(sup.apply([f for f in raw if f.path == mod.path]))
    return out, len(modules)
