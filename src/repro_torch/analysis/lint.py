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
``# lint: allow[<rule-id>]`` on it or on the line above.

The command line is the reference's: a baseline of grandfathered findings
fingerprinted on (rule, file, stripped code), so that line shifts keep
them (``--baseline PATH``, default ``lint_baseline.json`` beside this
module; a missing file is an empty baseline, and none is committed: the
tree lints clean), ``--no-baseline``, ``--update-baseline``; ``--format
text|json|github`` with the reference's fields and GitHub Actions
``::error`` annotations; and ``--builtins``, the counterpart of its
``--jaxpr-builtins``: ``analysis.check.check_builtins`` over every
builtin policy, reward and decide path, with every registry policy
certified.

CLI::

    python -m repro_torch.analysis.lint [paths...] [--format json]
    python -m repro_torch.analysis.lint --builtins
    python -m repro_torch.analysis.lint --update-baseline
    python -m repro_torch.analysis.lint --list-rules
"""
from __future__ import annotations

import argparse
import ast
import glob
import json
import os
import re
import sys
import time
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


# ------------------------------------------------------------- baseline
DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__),
                                "lint_baseline.json")


def _fingerprint(v: Violation, lines_cache: Dict[str, List[str]]) -> dict:
    """Line numbers shift; fingerprint on (rule, file, stripped code)."""
    fname, _, lineno = v.source.rpartition(":")
    code = ""
    try:
        if fname not in lines_cache:
            with open(fname, "r", encoding="utf-8") as f:
                lines_cache[fname] = f.read().splitlines()
        code = lines_cache[fname][int(lineno) - 1].strip()
    except (OSError, ValueError, IndexError):
        pass
    return {"rule": v.rule, "file": fname.replace(os.sep, "/"),
            "code": code}


def apply_baseline(violations: List[Violation], baseline_path: str):
    """Split into (new, baselined) against the baseline's fingerprints,
    each fingerprint absorbing one finding; no file is an empty
    baseline."""
    try:
        with open(baseline_path, "r", encoding="utf-8") as f:
            entries = json.load(f).get("violations", [])
    except FileNotFoundError:
        entries = []
    pool = [tuple(sorted(e.items())) for e in entries]
    cache: Dict[str, List[str]] = {}
    new, old = [], []
    for v in violations:
        fp = tuple(sorted(_fingerprint(v, cache).items()))
        if fp in pool:
            pool.remove(fp)
            old.append(v)
        else:
            new.append(v)
    return new, old


def write_baseline(violations: List[Violation], baseline_path: str):
    cache: Dict[str, List[str]] = {}
    data = {"comment": "lint findings grandfathered for their own PR; "
                       "python -m repro_torch.analysis.lint "
                       "--update-baseline",
            "violations": [_fingerprint(v, cache) for v in violations]}
    with open(baseline_path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")


def _annotation(text: str) -> str:
    """A GitHub Actions workflow-command message: % and newlines escaped."""
    return text.replace("%", "%25").replace("\n", "%0A")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="The port's host-code lint (state-leaf-alias, "
                    "lock-multi-acquire)")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: src/repro_torch and "
                         "examples/port_*.py)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--no-baseline", action="store_true")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline with the current findings")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--builtins", action="store_true",
                    help="also run the contract checks over every builtin "
                         "policy/reward/decide path and certify the policy "
                         "registry (analysis.check.check_builtins)")
    ap.add_argument("--format", choices=("text", "json", "github"),
                    default="text",
                    help="finding output: human text (default), a "
                         "machine-readable JSON document (rule, file, "
                         "line, fingerprint per finding), or GitHub "
                         "Actions ::error per-line annotations")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rid, desc in LINT_RULES.items():
            print(f"  {rid}: {desc}")
        return 0

    t0 = time.perf_counter()
    paths = args.paths or default_paths()
    found = run_paths(paths)
    if args.update_baseline:
        write_baseline(found, args.baseline)
        print(f"wrote {len(found)} finding(s) to {args.baseline}")
        return 0
    if args.no_baseline:
        new, old = found, []
    else:
        new, old = apply_baseline(found, args.baseline)

    if args.format == "github":
        for v in new:
            fname, _, lineno = v.source.rpartition(":")
            print(f"::error file={fname},line={lineno or 1},"
                  f"title=lint {v.rule}::{_annotation(v.format())}")
    elif args.format == "text":
        for v in new:
            print(f"{v.source}: {v.format()}")

    n_builtin, builtin_error = 0, None
    if args.builtins:
        from repro_torch.analysis.check import check_builtins
        try:
            n_builtin = check_builtins()
        except Exception as e:
            builtin_error = str(e)
            if args.format == "text":
                print(f"builtin contract check FAILED:\n{e}")
            elif args.format == "github":
                print("::error title=builtin contract check::"
                      + _annotation(builtin_error))

    dt = time.perf_counter() - t0
    files = len(list(iter_py_files(paths)))
    if args.format == "json":
        cache: Dict[str, List[str]] = {}

        def entry(v, baselined):
            fname, _, lineno = v.source.rpartition(":")
            return {"rule": v.rule, "file": fname.replace(os.sep, "/"),
                    "line": int(lineno) if lineno.isdigit() else 0,
                    "message": v.message, "baselined": baselined,
                    "fingerprint": _fingerprint(v, cache)}

        doc = {"files": files, "new": len(new), "baselined": len(old),
               "elapsed_s": round(dt, 3),
               "findings": [entry(v, False) for v in new]
               + [entry(v, True) for v in old]}
        if args.builtins:
            doc["builtins"] = {"checked": n_builtin, "error": builtin_error}
        print(json.dumps(doc, indent=2, sort_keys=True))
    else:
        extra = f", {n_builtin} builtin fns checked" if n_builtin else ""
        print(f"lint: {files} files, {len(new)} finding(s), {len(old)} "
              f"baselined{extra} [{dt:.1f}s]")
    return 1 if new or builtin_error is not None or not files else 0


if __name__ == "__main__":
    sys.exit(main())
