"""Repo-specific static lint for one-sided RMA code (§14).

AST-level rules over ``src/repro_torch`` that encode the project's protocol
discipline — the things ruff cannot know:

  * **ANL001** — bare ``except:``: swallows `ConformanceError` /
    `FabricError` and turns protocol violations into silent retries.
  * **ANL002** — a raw lock acquire (``lock_exclusive`` / ``lock_shared``
    / ``lock_all``) that is not exception-safe: the acquire must either be
    the context-manager form (`LockOrigin.exclusive/.shared/.all_shared`)
    or pair with a matching ``unlock_*`` in a ``finally`` block (as the
    statement right before the ``try`` or inside its body).
  * **ANL003** — direct `Fabric` mutation that bypasses the `OpCounter`
    ledger: writing through ``<fabric>.regions[...]`` or calling
    ``apply_add`` outside the two fabric implementations.  The golden-
    trace diff tests only pin what the ledger *sees*; a bypass makes the
    conformance accounting silently wrong.
  * **ANL004** — a one-way fabric call (``put`` / ``add`` / ``fence_add``
    on a fabric receiver) in a scope with no completion call (``flush`` /
    ``flush_remote`` / ``fence`` / ``close``): one-sided ops outside an
    epoch scope never complete.
  * **ANL005** — ``begin_plan`` in a function that never closes or
    flushes: the recorded ops would be dropped on the floor.
  * **ANL006** — a ``serve.request.*`` trace event or span without a
    ``rid=`` keyword: request-lifecycle events are the nodes of the §15
    causal DAG, and one un-stamped site silently disconnects every request
    that flows through it (the stitcher cannot know the event was theirs).

Run as ``python -m repro_torch.analysis.lint [paths...]`` (default:
``src/repro_torch``); exits 1 on findings.  `check_source` is the testable API.
"""

from __future__ import annotations

import ast
import os
import sys
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_ACQUIRES: Dict[str, str] = {
    "lock_exclusive": "unlock_exclusive",
    "lock_shared": "unlock_shared",
    "lock_all": "unlock_all",
}
_ONE_WAY = frozenset({"put", "add", "fence_add"})
_SYNCS = frozenset({"flush", "flush_remote", "fence", "close"})
_FABRIC_NAMES = frozenset({"fab", "fabric", "_fab", "_fabric"})

# files allowed to touch region stores / apply_add directly (they ARE the
# transport) or to issue raw lock AMOs (they ARE the lock implementation)
_FABRIC_IMPLS = ("core/fabric.py", "sim/fabric.py")
_LOCK_IMPLS = ("core/locks_sim.py",)


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def _attr_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Call):
        node = node.func
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_fabric_receiver(func: ast.AST) -> bool:
    """True when a call's receiver looks like a fabric handle."""
    if not isinstance(func, ast.Attribute):
        return False
    base = func.value
    if isinstance(base, ast.Name):
        return base.id in _FABRIC_NAMES
    if isinstance(base, ast.Attribute):  # self.fabric.put(...), q.fab.add(...)
        return base.attr in _FABRIC_NAMES
    return False


def _calls_in(node: ast.AST) -> Iterable[ast.Call]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            yield sub


def _call_attrs(node: ast.AST) -> set:
    return {a for a in (_attr_name(c) for c in _calls_in(node))
            if a is not None}


def _endswith(path: str, suffixes: Tuple[str, ...]) -> bool:
    norm = path.replace(os.sep, "/")
    return any(norm.endswith(s) for s in suffixes)


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: List[Finding] = []
        self._func_stack: List[ast.AST] = []
        self._class_attrs: List[set] = []

    def flag(self, node: ast.AST, rule: str, message: str) -> None:
        self.findings.append(
            Finding(self.path, getattr(node, "lineno", 0), rule, message))

    # ---------------------------------------------------------- ANL001
    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        if node.type is None:
            self.flag(node, "ANL001",
                      "bare `except:` swallows protocol errors — name the "
                      "exception (or `except Exception`)")
        self.generic_visit(node)

    # ------------------------------------------------- scope bookkeeping
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_attrs.append(_call_attrs(node))
        self.generic_visit(node)
        self._class_attrs.pop()

    def _visit_func(self, node) -> None:
        self._func_stack.append(node)
        self._check_lock_pairing(node)
        self._check_one_way(node)
        self._check_begin_plan(node)
        self.generic_visit(node)
        self._func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    # ---------------------------------------------------------- ANL002
    def _finally_unlocks(self, try_node: ast.Try) -> set:
        out = set()
        for stmt in try_node.finalbody:
            out |= _call_attrs(stmt)
        return out

    def _check_lock_pairing(self, func) -> None:
        if _endswith(self.path, _LOCK_IMPLS):
            return
        # pass 1 — mark exception-safe acquire Calls: (a) inside a Try
        # whose finally has the matching release, (b) in the statement
        # immediately before such a Try
        safe: set = set()
        for body in self._stmt_lists(func):
            for i, stmt in enumerate(body):
                if not isinstance(stmt, ast.Try):
                    continue
                unlocks = self._finally_unlocks(stmt)
                region = list(stmt.body)
                if i > 0:
                    region.append(body[i - 1])
                for part in region:
                    for call in _calls_in(part):
                        name = _attr_name(call)
                        if name in _ACQUIRES and _ACQUIRES[name] in unlocks:
                            safe.add(id(call))
        # pass 2 — everything else is an unprotected raw acquire
        for call in _calls_in(func):
            name = _attr_name(call)
            if name in _ACQUIRES and id(call) not in safe:
                self.flag(
                    call, "ANL002",
                    f"`{name}` without `{_ACQUIRES[name]}` on the "
                    "exception path — use the context-manager form "
                    "(LockOrigin.exclusive/.shared) or a try/finally")

    def _stmt_lists(self, node: ast.AST) -> Iterable[List[ast.stmt]]:
        for sub in ast.walk(node):
            for field in ("body", "orelse", "finalbody"):
                stmts = getattr(sub, field, None)
                if isinstance(stmts, list) and stmts and \
                        isinstance(stmts[0], ast.stmt):
                    yield stmts

    # ---------------------------------------------------------- ANL004
    def _check_one_way(self, func) -> None:
        if _endswith(self.path, _FABRIC_IMPLS):
            return
        attrs_here = _call_attrs(func)
        if attrs_here & _SYNCS:
            return
        class_ok = bool(self._class_attrs and
                        (self._class_attrs[-1] & _SYNCS))
        if class_ok:
            return
        for call in _calls_in(func):
            name = _attr_name(call)
            if name in _ONE_WAY and _is_fabric_receiver(call.func):
                self.flag(
                    call, "ANL004",
                    f"one-way fabric `{name}` outside any epoch scope — "
                    "no flush/flush_remote/fence/close in this function "
                    "or class ever completes it")

    # ---------------------------------------------------------- ANL005
    def _check_begin_plan(self, func) -> None:
        attrs_here = _call_attrs(func)
        if "begin_plan" not in attrs_here:
            return
        if func.name == "begin_plan":
            return
        if attrs_here & {"close", "flush", "complete", "unlock"}:
            return
        self.flag(func, "ANL005",
                  "`begin_plan` in a scope that never closes the epoch or "
                  "flushes the plan — recorded ops would be dropped")

    # ---------------------------------------------------------- ANL003
    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._check_region_write(t)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_region_write(node.target)
        self.generic_visit(node)

    def _check_region_write(self, target: ast.AST) -> None:
        if _endswith(self.path, _FABRIC_IMPLS):
            return
        node: Optional[ast.AST] = target
        while isinstance(node, ast.Subscript):
            node = node.value
        if isinstance(node, ast.Attribute) and node.attr == "regions" \
                and not (isinstance(node.value, ast.Name)
                         and node.value.id == "self"):
            self.flag(target, "ANL003",
                      "direct write through `<fabric>.regions[...]` "
                      "bypasses the OpCounter ledger — go through "
                      "fab.put/add/fence_add")

    def visit_Call(self, node: ast.Call) -> None:
        if not _endswith(self.path, _FABRIC_IMPLS) and \
                isinstance(node.func, ast.Name) and \
                node.func.id == "apply_add":
            self.flag(node, "ANL003",
                      "`apply_add` outside the fabric implementations "
                      "bypasses the OpCounter ledger")
        self._check_request_event(node)
        self.generic_visit(node)

    # ---------------------------------------------------------- ANL006
    def _check_request_event(self, node: ast.Call) -> None:
        name = _attr_name(node)
        if name not in ("event", "span") or not node.args:
            return
        first = node.args[0]
        if not (isinstance(first, ast.Constant) and
                isinstance(first.value, str) and
                first.value.startswith("serve.request.")):
            return
        # a literal rid= keyword, or a **kwargs splat that may carry it
        if any(kw.arg == "rid" or kw.arg is None for kw in node.keywords):
            return
        self.flag(node, "ANL006",
                  f"`{first.value}` without `rid=` — request-lifecycle "
                  "events stitch the §15 causal DAG; an un-stamped event "
                  "disconnects the request it belongs to")


def check_source(src: str, path: str = "<string>") -> List[Finding]:
    """Lint one source string; returns findings (testable entry point)."""
    tree = ast.parse(src, filename=path)
    linter = _Linter(path)
    linter.visit(tree)
    # nested functions are walked at every enclosing scope: dedupe
    return sorted(dict.fromkeys(linter.findings),
                  key=lambda f: (f.path, f.line, f.rule))


def check_paths(paths: Sequence[str]) -> List[Finding]:
    findings: List[Finding] = []
    for root in paths:
        if os.path.isfile(root):
            files = [root]
        else:
            files = sorted(
                os.path.join(dp, f)
                for dp, _, fns in os.walk(root)
                for f in fns if f.endswith(".py"))
        for f in files:
            with open(f, encoding="utf-8") as fh:
                findings.extend(check_source(fh.read(), f))
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    paths = args or ["src/repro_torch"]
    findings = check_paths(paths)
    for f in findings:
        print(f)
    n = len(findings)
    print(f"repro_torch.analysis.lint: {n} finding(s) in {', '.join(paths)}")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
