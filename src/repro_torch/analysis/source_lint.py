"""Repo source lint (static analysis pass 3 of 3) — AST-based.

The port of ``repro.analysis.source_lint``, for the port's own source
(``src/repro_torch/``, ``chip_smoke.py``, ``tools/``).  Rules the generic
linters don't know:

  BLE001   ``except Exception`` without a ``# noqa: BLE001 — why`` tag on
           the except line.  Broad handlers are sometimes right (capability
           probes, corruption quarantine) but each one must say why — and
           because ``Exception`` excludes ``BaseException``, a tagged
           handler still re-raises KeyboardInterrupt/SystemExit.
  BLE002   bare ``except:`` or ``except BaseException`` — swallows
           KeyboardInterrupt/SystemExit; never acceptable, no tag honored.
  TCH001   module/class-scope ``torch.*`` computation or CUDA call — runs
           at import: it allocates tensors, and a ``torch.cuda`` call
           initializes the card, before the caller has chosen a device
           (the port builds and launches kernels only inside the functions
           that use them; the counterpart of the reference's JNP001).
           Constructors of descriptors (``torch.device``, ``torch.finfo``,
           ``torch.iinfo``, ``torch.Size``) are allowed.
  DEP001   deprecated shim entry points referenced inside ``src/`` — new
           code goes through the operator API (the reference's tables,
           under ``repro_torch``).
  JIT001   wall-clock calls (``time.time``/``perf_counter``/
           ``datetime.now``) inside a function decorated with
           ``torch.compile``, ``torch.jit.script`` or ``triton.jit`` — the
           clock is read once while tracing/compiling and burned into the
           program.

The reference's PYT001 (unhashable pytree aux data) has no counterpart:
the port registers no pytrees.

A trailing ``# noqa: <RULE>`` comment on the offending line suppresses
that rule (BLE002 excepted); the committed baseline ratchets the rest.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional

from .findings import Finding

__all__ = ["lint_source", "lint_file", "run_source_lint"]

_NOQA = re.compile(r"#\s*noqa:\s*([A-Z]+\d+)")

# deprecated entry points (name -> the module that legitimately defines
# it) and deprecated modules; any OTHER src/ module referencing one is
# flagged (the reference's tables, under repro_torch)
_DEPRECATED: Dict[str, str] = {
    "spmv": "repro_torch.core.spmv",
    "build_spmv": "repro_torch.core.spmv",
    "build_dist_spmv": "repro_torch.core.dist_spmv",
    "build_sharded_spmv": "repro_torch.core.dist_spmv",
    "build_allgather_spmv": "repro_torch.core.dist_spmv",
    "from_dense": "repro_torch.core.sparse_linear",
}
_DEPRECATED_MODULES = {"repro_torch.core.dist_spmv"}

_CLOCK_CALLS = {
    ("time", "time"), ("time", "perf_counter"), ("time", "monotonic"),
    ("time", "process_time"), ("datetime", "now"), ("datetime", "utcnow"),
}

# decorators that trace or compile the function they wrap
_JIT_DECORATORS = {"torch.compile", "torch.jit.script", "triton.jit"}

# module-scope torch calls that build descriptors, not tensors
_TORCH_ALLOWED = {"torch.device", "torch.finfo", "torch.iinfo",
                  "torch.Size"}


def _suppressed(lines: List[str], lineno: int, rule: str) -> bool:
    if 1 <= lineno <= len(lines):
        return rule in _NOQA.findall(lines[lineno - 1])
    return False


def _is_exception_name(node) -> Optional[str]:
    """'Exception'/'BaseException' if the except clause catches one."""
    targets = [node] if not isinstance(node, ast.Tuple) else list(node.elts)
    for t in targets:
        name = t.id if isinstance(t, ast.Name) else (
            t.attr if isinstance(t, ast.Attribute) else None)
        if name in ("Exception", "BaseException"):
            return name
    return None


def _dotted(node) -> Optional[str]:
    """'a.b.c' for an attribute/name chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _Visitor(ast.NodeVisitor):
    def __init__(self, site: str, lines: List[str], module: str):
        self.site = site
        self.lines = lines
        self.module = module
        self.out: List[Finding] = []
        self._func_depth = 0
        self._jit_depth = 0
        # local name -> the dotted torch/triton path it stands for
        self._aliases: Dict[str, str] = {}

    def _emit(self, node, rule: str, severity: str, msg: str,
              taggable: bool = True) -> None:
        if taggable and _suppressed(self.lines, node.lineno, rule):
            return
        self.out.append(Finding(severity, f"{self.site}:{node.lineno}",
                                rule, msg))

    def _resolve(self, dotted: Optional[str]) -> Optional[str]:
        """``dotted`` with its root alias expanded (``th.zeros`` ->
        ``torch.zeros``, ``jit`` from ``from triton import jit`` ->
        ``triton.jit``)."""
        if dotted is None:
            return None
        root, _, rest = dotted.partition(".")
        full = self._aliases.get(root)
        if full is None:
            return dotted
        return f"{full}.{rest}" if rest else full

    # ---- imports: track aliases, catch deprecated shims --------------------

    def visit_Import(self, node):
        for a in node.names:
            if a.name.split(".")[0] in ("torch", "triton"):
                if a.asname:
                    self._aliases[a.asname] = a.name
                else:
                    root = a.name.split(".")[0]
                    self._aliases[root] = root
            if a.name in _DEPRECATED_MODULES \
                    and self.module not in _DEPRECATED_MODULES:
                self._emit(node, "DEP001", "error",
                           f"import of deprecated module {a.name!r}; use "
                           f"the operator API (repro_torch.api)")
        self.generic_visit(node)

    def visit_ImportFrom(self, node):
        mod = node.module or ""
        abs_mod = self._absolutize(mod, node.level)
        if abs_mod in _DEPRECATED_MODULES \
                and self.module not in _DEPRECATED_MODULES:
            self._emit(node, "DEP001", "error",
                       f"import from deprecated module {abs_mod!r}; use "
                       f"the operator API (repro_torch.api)")
        for a in node.names:
            if node.level == 0 and mod.split(".")[0] in ("torch", "triton"):
                self._aliases[a.asname or a.name] = f"{mod}.{a.name}"
            if f"{abs_mod}.{a.name}" in _DEPRECATED_MODULES \
                    and self.module not in _DEPRECATED_MODULES:
                self._emit(node, "DEP001", "error",
                           f"import of deprecated module "
                           f"{abs_mod}.{a.name!r}; use the operator API "
                           f"(repro_torch.api)")
                continue
            home = _DEPRECATED.get(a.name)
            if home is not None and abs_mod == home \
                    and self.module != home:
                self._emit(node, "DEP001", "error",
                           f"import of deprecated entry point "
                           f"{a.name!r} from {home}; new src/ code goes "
                           f"through the operator API")
        self.generic_visit(node)

    def _absolutize(self, mod: str, level: int) -> str:
        if level == 0:
            return mod
        parts = self.module.split(".")
        base = parts[: len(parts) - level]
        return ".".join(base + ([mod] if mod else [])).rstrip(".")

    # ---- broad excepts ----------------------------------------------------

    def visit_ExceptHandler(self, node):
        if node.type is None:
            self._emit(node, "BLE002", "error",
                       "bare except: swallows KeyboardInterrupt/SystemExit"
                       " — catch Exception (tagged) instead",
                       taggable=False)
        else:
            which = _is_exception_name(node.type)
            if which == "BaseException":
                self._emit(node, "BLE002", "error",
                           "except BaseException swallows "
                           "KeyboardInterrupt/SystemExit — catch "
                           "Exception (tagged) instead", taggable=False)
            elif which == "Exception":
                self._emit(node, "BLE001", "error",
                           "broad `except Exception` without a "
                           "`# noqa: BLE001 — why` justification tag")
        self.generic_visit(node)

    # ---- module-scope torch work; clocks under a compiler ------------------

    def visit_Call(self, node):
        dotted = self._resolve(_dotted(node.func))
        if dotted is not None:
            if self._func_depth == 0 and dotted.startswith("torch.") and \
                    dotted not in _TORCH_ALLOWED:
                self._emit(node, "TCH001", "error",
                           f"module-scope torch call ({dotted}(...)) runs "
                           f"at import: it allocates or initializes the "
                           f"card before callers choose a device")
            if self._jit_depth > 0:
                tail = tuple(dotted.split(".")[-2:])
                if tail in _CLOCK_CALLS:
                    self._emit(node, "JIT001", "error",
                               f"wall-clock call {dotted}() inside a "
                               f"compiled function is read once while "
                               f"compiling and burned into the program")
        self.generic_visit(node)

    # ---- function context -------------------------------------------------

    def _visit_func(self, node):
        jitted = any(self._resolve(_dotted(getattr(d, "func", d)))
                     in _JIT_DECORATORS for d in node.decorator_list)
        self._func_depth += 1
        self._jit_depth += 1 if jitted else 0
        self.generic_visit(node)
        self._jit_depth -= 1 if jitted else 0
        self._func_depth -= 1

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Lambda(self, node):
        self._func_depth += 1
        self.generic_visit(node)
        self._func_depth -= 1


def lint_source(src: str, site: str,
                module: str = "") -> List[Finding]:
    """Lint one source string (``site`` labels findings, ``module`` is the
    dotted module path used by the DEP001 defining-module exemption)."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding("error", f"{site}:{e.lineno or 0}", "syntax",
                        f"unparsable source: {e.msg}")]
    v = _Visitor(site, src.splitlines(), module)
    v.visit(tree)
    return v.out


def lint_file(path, rel_to=None, module: Optional[str] = None
              ) -> List[Finding]:
    path = Path(path)
    site = str(path.relative_to(rel_to)) if rel_to else str(path)
    if module is None:
        parts = list(path.with_suffix("").parts)
        if "repro_torch" in parts:
            module = ".".join(parts[parts.index("repro_torch"):])
            if module.endswith(".__init__"):
                module = module[: -len(".__init__")]
        else:
            module = path.stem
    return lint_source(path.read_text(), site, module)


def _repo_root() -> Path:
    return Path(__file__).resolve().parents[3]


def run_source_lint(root=None) -> List[Finding]:
    """Lint every Python file of the port: ``src/repro_torch/``,
    ``chip_smoke.py`` and ``tools/``."""
    root = Path(root) if root else _repo_root()
    paths = sorted((root / "src" / "repro_torch").rglob("*.py"))
    paths += [p for p in [root / "chip_smoke.py"] if p.is_file()]
    if (root / "tools").is_dir():
        paths += sorted((root / "tools").rglob("*.py"))
    out: List[Finding] = []
    for path in paths:
        out += lint_file(path, rel_to=root)
    return out
