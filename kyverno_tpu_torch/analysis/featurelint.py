"""KT5xx feature-lane lint: the KTPU_* switch matrix is closed.

Statically enumerates (pure AST walk, nothing imported) every read of a
``KTPU_*`` environment switch across the engine tree (the package
``kyverno_tpu_torch/`` and its card driver ``chip_smoke.py``) and checks
it against the declaration registry in
:mod:`kyverno_tpu_torch.runtime.featureplane`:

- **KT501** (ERROR) a read names a switch the registry does not declare
  — the switch has no owner, no default, and no parity gate.
- **KT502** (ERROR) a declaration has no remaining reference outside the
  registry — a dead kill switch that can never affect behavior but
  still reads as supported surface.
- **KT503** (ERROR) a module reads ``os.environ`` / ``os.getenv``
  directly for a ``KTPU_*`` name instead of going through the
  featureplane accessors — bypassing the registry default and the
  undeclared-switch guard.

Writes (``os.environ[...] = ...``), ``setdefault``, ``pop``, ``del``
and dynamic (non-literal) names are out of scope: tests and smoke
drivers legitimately pin switches, and the lint must never force the
registry to enumerate test-only scaffolding. ``tests/`` is excluded
from the scan entirely; its string constants still count for KT502
liveness (a switch exercised only by its parity gate is live).
"""

from __future__ import annotations

import ast
import sys
from dataclasses import dataclass
from pathlib import Path

from .diagnostics import Diagnostic, make

_PREFIX = "KTPU_"
_REGISTRY_FILE = "runtime/featureplane.py"
_ACCESSORS = frozenset((
    "declared", "raw", "is_set", "enabled", "enabled_strict",
    "int_value", "float_value"))


@dataclass(frozen=True)
class SwitchRead:
    name: str
    path: str
    line: int
    direct: bool          # True: os.environ/os.getenv; False: accessor


def _dotted(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _str_const(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _reads_in(tree: ast.AST, relpath: str) -> list[SwitchRead]:
    out: list[SwitchRead] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = _dotted(node.func)
            arg = _str_const(node.args[0]) if node.args else None
            if arg is None or not arg.startswith(_PREFIX):
                continue
            if fn.endswith("environ.get") or fn in ("os.getenv", "getenv"):
                out.append(SwitchRead(arg, relpath, node.lineno, True))
            elif fn.rpartition(".")[2] in _ACCESSORS and (
                    "featureplane" in fn or fn in _ACCESSORS):
                out.append(SwitchRead(arg, relpath, node.lineno, False))
        elif isinstance(node, ast.Subscript) and isinstance(
                node.ctx, ast.Load):
            if not _dotted(node.value).endswith("environ"):
                continue
            arg = _str_const(node.slice)
            if arg is not None and arg.startswith(_PREFIX):
                out.append(SwitchRead(arg, relpath, node.lineno, True))
    return out


def _constants_in(tree: ast.AST) -> set[str]:
    out: set[str] = set()
    for node in ast.walk(tree):
        s = _str_const(node)
        if s is not None and s.startswith(_PREFIX):
            out.add(s)
    return out


def _scan_targets(root: Path) -> list[Path]:
    files: list[Path] = []
    d = root / "kyverno_tpu_torch"
    if d.is_dir():
        files.extend(sorted(d.rglob("*.py")))
    driver = root / "chip_smoke.py"
    if driver.is_file():
        files.append(driver)
    return files


def _liveness_targets(root: Path) -> list[Path]:
    # tests count for KT502 liveness (parity gates pin switches there)
    # but are never scanned for KT501/KT503.
    t = root / "tests"
    return sorted(t.rglob("*.py")) if t.is_dir() else []


def _declared_switches(root: Path) -> set[str] | None:
    """Parse the registry declarations without importing the module."""
    reg = root / "kyverno_tpu_torch" / _REGISTRY_FILE
    try:
        tree = ast.parse(reg.read_text(), filename=str(reg))
    except (OSError, SyntaxError):
        return None
    # every _S("KTPU_X", ...) / Switch("KTPU_X", ...) call declares one
    out: set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = _dotted(node.func)
        if fn not in ("_S", "Switch"):
            continue
        name = _str_const(node.args[0]) if node.args else None
        if name is not None and name.startswith(_PREFIX):
            out.add(name)
    return out


def scan_tree(root: str | Path = ".") -> list[Diagnostic]:
    """Run the KT5xx pass over a repo tree; returns diagnostics."""
    root = Path(root)
    declared = _declared_switches(root)
    if declared is None:
        return [make(
            "KT501",
            f"cannot parse the switch registry "
            f"(kyverno_tpu_torch/{_REGISTRY_FILE})", component="featurelint")]

    reads: list[SwitchRead] = []
    live: set[str] = set()
    for f in _scan_targets(root):
        rel = str(f.relative_to(root))
        try:
            tree = ast.parse(f.read_text(), filename=rel)
        except SyntaxError as e:
            return [make("KT501", f"cannot parse {rel}: {e}",
                         component="featurelint")]
        if rel.endswith(_REGISTRY_FILE):
            continue  # the registry's own reads/declarations don't count
        reads.extend(_reads_in(tree, rel))
        live |= _constants_in(tree)
    for f in _liveness_targets(root):
        try:
            live |= _constants_in(ast.parse(f.read_text()))
        except SyntaxError:
            continue

    diags: list[Diagnostic] = []
    for r in reads:
        where = f"{r.path}:{r.line}"
        if r.name not in declared:
            diags.append(make(
                "KT501",
                f"read of undeclared switch {r.name} at {where}; "
                f"declare it in kyverno_tpu_torch/{_REGISTRY_FILE}",
                component=where))
        if r.direct:
            diags.append(make(
                "KT503",
                f"direct environment read of {r.name} at {where}; use "
                f"the featureplane accessors so the registry default "
                f"and undeclared-switch guard apply",
                component=where))
    for name in sorted(declared - live):
        diags.append(make(
            "KT502",
            f"declared switch {name} has no read or reference outside "
            f"the registry; remove the declaration or the lane it "
            f"guarded", component=f"kyverno_tpu_torch/{_REGISTRY_FILE}"))
    return diags


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = argv[0] if argv else "."
    diags = scan_tree(root)
    for d in diags:
        print(d.format())
    if diags:
        print(f"featurelint: {len(diags)} finding(s)", file=sys.stderr)
        return 1
    print("featurelint: switch matrix closed "
          "(all reads declared, no dead lanes, no bypasses)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
