"""AST lint of the port's host code — the two rules of
``repro.analysis.lint`` that apply to torch code (the reference's other
five guard JAX version seams and buffer donation, which torch has not):

  * ``state-leaf-alias``: ``<...system...>.state.<leaf>`` outside
    ``runtime/system.py``. The sharded modes hold a tuple of per-shard
    trees in ``system.state`` and the engines replace the tree every
    batch; host code reads through the snapshot accessors;
  * ``lock-multi-acquire``: under ``runtime/``, a with-lock inside a
    loop, a nested acquire of the same lock, or a call of a sibling
    method that re-acquires the held lock (batch first, lock once).

The AST logic is a copy of the reference's (``repro.analysis.lint``), so
that the port imports nothing of ``repro``. Suppress one line with
``# lint: allow[<rule-id>]`` on it or on the line above. There is no
baseline: the tree lints clean.

CLI::

    python -m repro_torch.analysis.lint [paths...]
    python -m repro_torch.analysis.lint --list-rules
"""
from __future__ import annotations

import argparse
import ast
import glob
import os
import re
import sys
from typing import Dict, List, Optional, Set

from repro_torch.analysis.contracts import LINT_RULES, Violation

_PRAGMA = re.compile(r"#\s*lint:\s*allow\[([a-z0-9,\- ]*)\]")


def default_paths(root: str = ".") -> List[str]:
    """The port package and the port examples, under ``root``."""
    return ([os.path.join(root, "src", "repro_torch")]
            + sorted(glob.glob(os.path.join(root, "examples", "port_*.py"))))


def _dotted(node) -> Optional[str]:
    """Attribute/Name chain -> dotted string, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _FileLint(ast.NodeVisitor):
    def __init__(self, rel: str, tree: ast.AST, lines: List[str]):
        self.rel = rel
        self.lines = lines
        norm = "/" + rel.replace(os.sep, "/")
        self.in_runtime = "/runtime/" in norm
        self.is_system = norm.endswith("/runtime/system.py")
        self.violations: List[Violation] = []
        self._parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent
        # class -> method -> set of lock expr strings acquired in its body
        self._class_locks: Dict[ast.ClassDef, Dict[str, Set[str]]] = {}
        for n in ast.walk(tree):
            if isinstance(n, ast.ClassDef):
                self._class_locks[n] = {
                    m.name: self._locks_acquired(m)
                    for m in n.body if isinstance(m, ast.FunctionDef)}
        self._with_locks: List[str] = []    # lexical stack of held locks
        self._loop_depth = 0

    # --- plumbing -----------------------------------------------------------
    def _suppressed(self, lineno: int, rule: str) -> bool:
        for ln in (lineno, lineno - 1):
            if 1 <= ln <= len(self.lines):
                m = _PRAGMA.search(self.lines[ln - 1])
                if m and (not m.group(1).strip()
                          or rule in re.split(r"[,\s]+", m.group(1))):
                    return True
        return False

    def _flag(self, node, rule: str, message: str):
        if self._suppressed(node.lineno, rule):
            return
        self.violations.append(Violation(
            rule=rule, message=message, label=self.rel,
            source=f"{self.rel}:{node.lineno}"))

    def _enclosing(self, node, *types):
        cur = node
        while cur in self._parents:
            prev, cur = cur, self._parents[cur]
            if isinstance(cur, types):
                yield cur, prev

    @staticmethod
    def _is_lockish(expr) -> bool:
        src = _dotted(expr) or ""
        return "lock" in src.lower()

    def _locks_acquired(self, fn: ast.FunctionDef) -> Set[str]:
        out: Set[str] = set()
        for n in ast.walk(fn):
            if isinstance(n, ast.With):
                for item in n.items:
                    if self._is_lockish(item.context_expr):
                        out.add(_dotted(item.context_expr) or "")
        return out

    # --- state-leaf-alias -----------------------------------------------------
    def visit_Attribute(self, node: ast.Attribute):
        if (isinstance(node.value, ast.Attribute)
                and node.value.attr == "state"
                and isinstance(node.value.value, ast.Name)
                and not self.is_system):
            recv = node.value.value.id.lower()
            if recv == "sys" or "system" in recv:
                self._flag(node, "state-leaf-alias",
                           f"aliases a pipeline-state leaf "
                           f"('{node.value.value.id}.state.{node.attr}'): "
                           "the sharded modes hold per-shard trees there "
                           "and the engines replace the tree each batch — "
                           "read through the snapshot accessors "
                           "(snapshot_state / snapshot_norm / "
                           "export_replay)")
        self.generic_visit(node)

    # --- lock-multi-acquire ---------------------------------------------------
    def visit_Call(self, node: ast.Call):
        # a call to a sibling that re-acquires a held lock
        if self.in_runtime and self._with_locks \
                and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == "self":
            for cls, methods in self._class_locks.items():
                locks = methods.get(node.func.attr)
                if locks is None:
                    continue
                held = set(self._with_locks) & locks
                if held and self._in_class(node, cls):
                    self._flag(node, "lock-multi-acquire",
                               f"calls self.{node.func.attr}() while "
                               f"holding {sorted(held)[0]}, which that "
                               "method re-acquires — split out a _locked "
                               "helper (one acquire per call)")
        self.generic_visit(node)

    def _in_class(self, node, cls) -> bool:
        return any(anc is cls for anc, _ in self._enclosing(node,
                                                            ast.ClassDef))

    def visit_With(self, node: ast.With):
        if not self.in_runtime:
            return self.generic_visit(node)
        lock_exprs = [_dotted(i.context_expr) or "" for i in node.items
                      if self._is_lockish(i.context_expr)]
        for le in lock_exprs:
            if self._loop_depth > 0:
                self._flag(node, "lock-multi-acquire",
                           f"acquires {le} inside a for-loop: batch the "
                           "items first and hold the lock once per call "
                           "(the one-lock-per-call rule)")
            if le in self._with_locks:
                self._flag(node, "lock-multi-acquire",
                           f"nested acquire of {le} (already held by an "
                           "enclosing with) — deadlocks a non-reentrant "
                           "lock")
        self._with_locks.extend(lock_exprs)
        self.generic_visit(node)
        del self._with_locks[len(self._with_locks) - len(lock_exprs):]

    def visit_For(self, node: ast.For):
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    def visit_FunctionDef(self, node: ast.FunctionDef):
        # loop depth / held locks are per-function lexical properties: a
        # nested def runs later, outside the enclosing with/for
        saved = (self._loop_depth, self._with_locks)
        self._loop_depth, self._with_locks = 0, []
        self.generic_visit(node)
        self._loop_depth, self._with_locks = saved

    visit_AsyncFunctionDef = visit_FunctionDef


def lint_source(src: str, rel: str) -> List[Violation]:
    """Lint one file's source, named ``rel`` (its path decides which rules
    bind: ``runtime/`` for the lock rule, ``runtime/system.py`` exempt from
    the alias rule)."""
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as e:
        return [Violation(rule="parse-error", message=str(e), label=rel,
                          source=f"{rel}:{e.lineno or 0}")]
    lint = _FileLint(rel, tree, src.splitlines())
    lint.visit(tree)
    return lint.violations


def iter_py_files(paths):
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            yield p
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def run_paths(paths) -> List[Violation]:
    out: List[Violation] = []
    for f in iter_py_files(paths):
        with open(f, "r", encoding="utf-8") as fh:
            out.extend(lint_source(fh.read(), os.path.relpath(f)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="The port's host-code lint (state-leaf-alias, "
                    "lock-multi-acquire)")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: src/repro_torch and "
                         "examples/port_*.py)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rid, desc in LINT_RULES.items():
            print(f"  {rid}: {desc}")
        return 0
    paths = args.paths or default_paths()
    found = run_paths(paths)
    for v in found:
        print(f"{v.source}: {v.format()}")
    files = len(list(iter_py_files(paths)))
    print(f"lint: {files} files, {len(found)} finding(s)")
    return 1 if found or not files else 0


if __name__ == "__main__":
    sys.exit(main())
