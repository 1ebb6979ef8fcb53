"""Determinism lint for simulation/replay/trace modules (pure AST).

The simulator's contract is bit-identical replays: same seed, same
trace, same report.  Three classes of hazard break that silently:

* ``wall-clock`` — ``time.time()`` / ``time.monotonic()`` /
  ``datetime.now()`` etc. leaking host time into sim results.  Virtual
  time comes from the event loop; the only sanctioned real clock lives
  in ``thread_executor.py`` (real threads genuinely wait), which is
  excluded from this pass's scope by the CLI.
* ``unseeded-random`` — module-level ``random.*`` / ``numpy.random.*``
  draws from hidden global state.  Sanctioned form: an explicit
  ``random.Random(seed)`` instance (or ``numpy.random.default_rng``)
  threaded through the call graph.
* ``set-iteration`` — iterating a set (or materializing one into an
  ordered container) leaks hash-order into schedules and traces.
  Dicts are insertion-ordered and fine; ``sorted(...)`` over a set is
  fine.

Scope selection (which files get this pass) is the CLI's job; this
module just checks sources handed to it.
"""

from __future__ import annotations

import ast

from .report import Finding, Suppressions

__all__ = ["run_determinism", "check_source"]

_WALL_CLOCK = {
    ("time", "time"), ("time", "time_ns"), ("time", "monotonic"),
    ("time", "monotonic_ns"), ("time", "perf_counter"),
    ("time", "perf_counter_ns"),
    ("datetime", "now"), ("datetime", "utcnow"), ("datetime", "today"),
    ("date", "today"),
}

#: global-state draws on the ``random`` module (``random.Random`` and
#: ``random.seed``-free instance use are the sanctioned alternative)
_GLOBAL_RANDOM = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "normalvariate", "expovariate",
    "betavariate", "paretovariate", "triangular", "vonmisesvariate",
    "weibullvariate", "lognormvariate", "getrandbits", "randbytes",
}

_NP_NAMES = {"np", "numpy"}
_NP_OK = {"default_rng", "Generator", "SeedSequence", "PCG64"}


def _dotted(node: ast.expr) -> tuple[str, ...] | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _is_setish(node: ast.expr) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        if node.func.id in ("set", "frozenset"):
            return True
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        # set algebra: a | b, a - b, ... — setish if either side is
        return _is_setish(node.left) or _is_setish(node.right)
    return False


def check_source(path: str, source: str) -> list[Finding]:
    tree = ast.parse(source, filename=path)
    findings: list[Finding] = []

    def emit(rule: str, line: int, message: str) -> None:
        findings.append(Finding(rule=rule, path=path, line=line,
                                message=message))

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            dotted = _dotted(node.func)
            if dotted is None:
                continue
            # wall clock: time.time(), datetime.datetime.now(), ...
            if len(dotted) >= 2 and dotted[-2:] in _WALL_CLOCK:
                emit("wall-clock", node.lineno,
                     f"{'.'.join(dotted)}() reads the host clock — sim "
                     "results must derive from virtual time")
            # unseeded global random
            elif (len(dotted) == 2 and dotted[0] == "random"
                    and dotted[1] in _GLOBAL_RANDOM):
                emit("unseeded-random", node.lineno,
                     f"{'.'.join(dotted)}() draws from the global PRNG — "
                     "thread an explicit random.Random(seed) instead")
            elif (len(dotted) == 3 and dotted[0] in _NP_NAMES
                    and dotted[1] == "random"
                    and dotted[2] not in _NP_OK):
                emit("unseeded-random", node.lineno,
                     f"{'.'.join(dotted)}() uses numpy's global PRNG — "
                     "use numpy.random.default_rng(seed)")
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            if _is_setish(node.iter):
                emit("set-iteration", node.lineno,
                     "iterating a set leaks hash-order into control "
                     "flow — sort it or use an ordered container")
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                if _is_setish(gen.iter):
                    emit("set-iteration", gen.iter.lineno,
                         "comprehension over a set leaks hash-order — "
                         "sort it or use an ordered container")
    # list(set(...)) / tuple(set(...)) — order-leaking materialization
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in ("list", "tuple")
                and len(node.args) == 1 and _is_setish(node.args[0])):
            findings.append(Finding(
                rule="set-iteration", path=path, line=node.lineno,
                message=f"{node.func.id}() over a set materializes "
                        "hash-order — use sorted(...)"))
    return findings


def run_determinism(files: list[tuple[str, str]],
                    ) -> tuple[list[Finding], int]:
    """Run the lint over ``(path, source)`` pairs with suppressions."""
    out: list[Finding] = []
    for path, source in files:
        raw = check_source(path, source)
        sup = Suppressions(path, source.splitlines())
        # bad-suppression findings are lockcheck's to report when both
        # passes see a file; here keep only filtering
        kept = [f for f in raw if not sup.allows(f)]
        out.extend(kept)
    return out, len(files)
