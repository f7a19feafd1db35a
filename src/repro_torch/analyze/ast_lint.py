"""Pass 2: stdlib-``ast`` lint over ``src/repro_torch`` (counterpart of
``repro.analyze.ast_lint``): the source hazards that have a PyTorch meaning.

Rules (the ids are the reference's where a rule is shared; the CLI keys on
them):

``traced-branch``
    ``if``/``while`` on a parameter of a function passed to (or decorated
    with) ``torch.func.vmap``/``torch.vmap``, or nested in one. Under
    ``vmap`` a parameter may be a batched tensor, whose truth value raises.
    ``is None`` / ``is not None`` tests are static and exempt.
``raw-timer``
    ``time.perf_counter()`` / ``time.time()`` / ``time.monotonic()``
    outside ``obs/timeline.py``. CUDA launches are asynchronous: a timer
    pair without a fence measures the queueing; use ``obs.fenced`` /
    ``obs.time_fenced`` / a span. ``obs/timeline.py`` is exempt: it is the
    timer implementation, and every timer there fences.
``unhoisted-const``
    A ``torch`` constant builder (``zeros``/``ones``/``full``/``eye``/
    ``arange``/``tensor`` of literals) in a ``for``/``while`` body: made
    (and, on the card, copied or filled) every iteration; hoist it.
``bare-except``
    ``except:`` with no exception type.
``label-link``
    The ``client_fwd`` of a ``SplitStep`` names a label-like name
    (``targets``/``labels``/``y*``): its output crosses the client->server
    link, so labels would leave the client, the split's privacy boundary.
``host-sync``
    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, or ``float``/
    ``int``/``bool`` of a parameter, in a ``vmap``-scoped function or in
    a round or step body (a closure of a ``make_*round``/``make_*step``
    factory): each waits for the device and copies to the host once a
    call. The source form of the reference's ``jaxpr-callback`` hazard.

Escape hatch: a ``repro: ignore[<rule>] -- <reason>`` comment on the
finding's line. The reason is mandatory: an ignore without one, or one
naming an unknown rule, is itself a finding (``bad-suppression``) and
suppresses nothing.

Not ported, by design (``NOT_PORTED``): ``key-reuse`` and ``magic-fold``.
A ``torch.Generator`` advances with every draw, so one generator consumed
twice gives two different draws, not correlated ones; and
``sim/streams.env_generator`` takes a registered ``KeySlot``, never a
literal, so there is no fold literal to find.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterable, Optional

from .findings import Finding, Report

RULES = (
    "traced-branch", "raw-timer", "unhoisted-const", "bare-except",
    "label-link", "host-sync", "bad-suppression",
)
NOT_PORTED = {
    "key-reuse": "a torch.Generator advances with every draw: two draws "
                 "from one generator are not correlated",
    "magic-fold": "sim/streams.env_generator takes a registered KeySlot, "
                  "never a literal",
}

# functions that batch a function passed to / decorated by them (matched on
# the last attribute segment: torch.func.vmap, torch.vmap, vmap)
_VMAP_WRAPPERS = frozenset({"vmap"})
# factories whose closures are the engines' round and step bodies
_HOT_FACTORY = re.compile(r"^make_\w*(round|step)$")
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_SYNC_BUILTINS = frozenset({"float", "int", "bool"})
_CONST_BUILDERS = frozenset({"zeros", "ones", "full", "eye", "arange",
                             "tensor"})
_TIMERS = ("time.time", "time.perf_counter", "time.monotonic")
_LABELISH = frozenset({"targets", "labels", "y", "yy", "by"})

_SUPPRESS_RE = re.compile(
    r"#\s*repro:\s*ignore\[([a-z-]+)\](\s*--\s*(\S.*))?")


def _func_name(node: ast.AST) -> Optional[str]:
    """Last dotted segment of a call target (``torch.func.vmap`` ->
    ``vmap``)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _dotted(node: ast.AST) -> Optional[str]:
    """Full dotted name of an expression, or None if not a plain path."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _Suppressions:
    """Per-line ``repro: ignore[<rule>] -- <reason>`` map for one file."""

    def __init__(self, source: str, path: str):
        self.by_line: dict[int, str] = {}
        self.bad: list[Finding] = []
        for i, line in enumerate(source.splitlines(), start=1):
            m = _SUPPRESS_RE.search(line)
            if m is None:
                continue
            rule, reason = m.group(1), m.group(3)
            if rule not in RULES:
                self.bad.append(Finding(
                    "bad-suppression", f"{path}:{i}",
                    f"ignore[{rule}] names an unknown rule "
                    f"(known: {', '.join(sorted(RULES))})"))
            elif not reason:
                self.bad.append(Finding(
                    "bad-suppression", f"{path}:{i}",
                    f"ignore[{rule}] has no reason; write "
                    f"'# repro: ignore[{rule}] -- <why this is safe>'"))
            else:
                self.by_line[i] = rule

    def covers(self, line: int, rule: str) -> bool:
        return self.by_line.get(line) == rule


class _Scope:
    """One function on the visitor's stack: its parameters (with those of
    the enclosing scopes of the same kind), whether ``vmap`` batches it and
    whether it is a round or step body."""

    def __init__(self, params: set, vmapped: bool, hot: bool,
                 factory: bool):
        self.params, self.vmapped, self.hot = params, vmapped, hot
        self.factory = factory


class _FileLinter(ast.NodeVisitor):
    def __init__(self, path: str, source: str, *,
                 is_timer_module: bool = False):
        self.path = path
        self.is_timer_module = is_timer_module
        self.suppressions = _Suppressions(source, path)
        self.findings: list[Finding] = list(self.suppressions.bad)
        self._scopes: list[_Scope] = []
        self._loop_depth = 0
        # names of functions passed (by name) to vmap anywhere in the file:
        # their defs are batched too (collected up front)
        self._wrapped_names: set[str] = set()

    # ---- helpers ----------------------------------------------------------

    def _emit(self, rule: str, node: ast.AST, message: str):
        line = getattr(node, "lineno", 0)
        if self.suppressions.covers(line, rule):
            return
        self.findings.append(Finding(rule, f"{self.path}:{line}", message))

    def lint(self, tree: ast.Module) -> list[Finding]:
        self._collect_wrapped(tree)
        self.visit(tree)
        return self.findings

    def _collect_wrapped(self, tree: ast.Module):
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and _func_name(node.func) in _VMAP_WRAPPERS):
                for arg in list(node.args) + [kw.value for kw in node.keywords]:
                    if isinstance(arg, ast.Name):
                        self._wrapped_names.add(arg.id)

    @property
    def _scope(self) -> Optional[_Scope]:
        return self._scopes[-1] if self._scopes else None

    @staticmethod
    def _params_of(node) -> set:
        a = node.args
        names = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
        if a.vararg:
            names.add(a.vararg.arg)
        if a.kwarg:
            names.add(a.kwarg.arg)
        return names

    # ---- scope tracking ---------------------------------------------------

    def _visit_func(self, node):
        outer = self._scope
        vmapped = bool(outer and outer.vmapped) or node.name in \
            self._wrapped_names or any(
                _func_name(d) in _VMAP_WRAPPERS for d in node.decorator_list)
        hot = vmapped or bool(outer and (outer.hot or outer.factory))
        params = self._params_of(node)
        if outer is not None and (outer.vmapped or outer.hot):
            params |= outer.params          # closure over the outer's names
        self._scopes.append(_Scope(params, vmapped, hot,
                                   bool(_HOT_FACTORY.match(node.name))))
        # a def inside a loop body is not executed per iteration: loop
        # context does not extend into a nested function's body
        outer_loops, self._loop_depth = self._loop_depth, 0
        self.generic_visit(node)
        self._loop_depth = outer_loops
        self._scopes.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Lambda(self, node: ast.Lambda):
        outer = self._scope
        self._scopes.append(outer if outer is not None
                            else _Scope(set(), False, False, False))
        outer_loops, self._loop_depth = self._loop_depth, 0
        self.generic_visit(node)
        self._loop_depth = outer_loops
        self._scopes.pop()

    # ---- rules ------------------------------------------------------------

    def _batched_names_in_test(self, test: ast.AST) -> list[str]:
        """Parameter names of a vmapped scope that a branch test reads,
        minus those that only appear in static ``is (not) None``
        comparisons."""
        scope = self._scope
        if scope is None or not scope.vmapped:
            return []
        static: set[int] = set()
        for node in ast.walk(test):
            if isinstance(node, ast.Compare) and all(
                    isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                for sub in ast.walk(node):
                    static.add(id(sub))
        return [n.id for n in ast.walk(test)
                if isinstance(n, ast.Name) and n.id in scope.params
                and id(n) not in static]

    def visit_If(self, node: ast.If):
        for name in self._batched_names_in_test(node.test):
            self._emit("traced-branch", node,
                       f"Python `if` on parameter {name!r} of a vmapped "
                       f"function; use torch.where (a batched tensor has no "
                       f"truth value)")
        self.generic_visit(node)

    def visit_While(self, node: ast.While):
        for name in self._batched_names_in_test(node.test):
            self._emit("traced-branch", node,
                       f"Python `while` on parameter {name!r} of a vmapped "
                       f"function (a batched tensor has no truth value)")
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    def visit_For(self, node: ast.For):
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    def visit_ExceptHandler(self, node: ast.ExceptHandler):
        if node.type is None:
            self._emit("bare-except", node,
                       "bare `except:` swallows KeyboardInterrupt/SystemExit; "
                       "name the exception type")
        self.generic_visit(node)

    def _check_host_sync(self, node: ast.Call):
        scope = self._scope
        if scope is None or not scope.hot:
            return
        where = "a vmapped function" if scope.vmapped else \
            "a round or step body"
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _SYNC_METHODS and not node.args):
            self._emit("host-sync", node,
                       f".{node.func.attr}() in {where} waits for the device "
                       f"and copies to the host every call; keep the value "
                       f"on the device")
        elif (isinstance(node.func, ast.Name)
              and node.func.id in _SYNC_BUILTINS and len(node.args) == 1
              and isinstance(node.args[0], ast.Name)
              and node.args[0].id in scope.params):
            self._emit("host-sync", node,
                       f"{node.func.id}({node.args[0].id}) in {where} reads a "
                       f"tensor parameter on the host (a device sync every "
                       f"call)")

    def visit_Call(self, node: ast.Call):
        dotted = _dotted(node.func)
        if not self.is_timer_module and dotted in _TIMERS:
            self._emit("raw-timer", node,
                       f"raw {dotted}() window; CUDA launches are async: use "
                       f"obs.fenced/time_fenced or an obs span")
        if (self._loop_depth > 0 and dotted is not None
                and dotted.split(".")[0] == "torch"
                and dotted.split(".")[-1] in _CONST_BUILDERS
                and node.args and all(_is_literal(a) for a in node.args)):
            self._emit("unhoisted-const", node,
                       f"{dotted}(...) of literals rebuilt every loop "
                       f"iteration; hoist it above the loop")
        if _func_name(node.func) == "SplitStep":
            for kw in node.keywords:
                if kw.arg != "client_fwd":
                    continue
                for sub in ast.walk(kw.value):
                    if isinstance(sub, ast.Name) and (
                            sub.id in _LABELISH or sub.id.startswith("y_")):
                        self._emit(
                            "label-link", kw.value,
                            f"client_fwd references label-like name "
                            f"{sub.id!r}; its output crosses the "
                            f"client->server link: labels must not leave "
                            f"the client tier")
        self._check_host_sync(node)
        self.generic_visit(node)


def _is_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(_is_literal(e) for e in node.elts)
    if isinstance(node, ast.UnaryOp):
        return _is_literal(node.operand)
    # dtype names (torch.float32) count as literal-ish
    if isinstance(node, ast.Attribute):
        return _dotted(node) is not None
    return False


def _shown(path: Path, repo_root: Optional[Path]) -> str:
    """``path`` relative to ``repo_root`` when it lies under it."""
    if repo_root is not None and path.is_relative_to(repo_root):
        return str(path.relative_to(repo_root))
    return str(path)


def lint_file(path: Path, repo_root: Optional[Path] = None) -> list[Finding]:
    source = path.read_text()
    rel = _shown(path, repo_root)
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as e:
        return [Finding("bare-except", f"{rel}:{e.lineno}",
                        f"file does not parse: {e.msg}", severity="error")]
    linter = _FileLinter(rel, source, is_timer_module=str(path).replace(
        "\\", "/").endswith("obs/timeline.py"))
    return linter.lint(tree)


def lint_paths(paths: Iterable[Path],
               repo_root: Optional[Path] = None) -> Report:
    """Lint every ``.py`` under ``paths`` (files or directories)."""
    report = Report()
    files: list[Path] = []
    for p in paths:
        p = Path(p)
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    for f in files:
        report.findings.extend(lint_file(f, repo_root))
        report.checked.append(_shown(f, repo_root))
    return report


def lint_source(source: str, path: str = "<string>") -> list[Finding]:
    """Lint a source string (the tests' fixture entry point)."""
    tree = ast.parse(source, filename=path)
    return _FileLinter(path, source).lint(tree)
