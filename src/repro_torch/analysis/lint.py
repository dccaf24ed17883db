"""Repo-invariant AST lint: custom rules the stock ruff families cannot
express, enforced over library code (tests are exempt: pytest rewrites
their asserts and they may exercise raw randomness on purpose). The rules
are the JAX package's (`repro.analysis.lint`), with the torch spellings of
each added, so the lint gives the same findings as JAX's over `src/repro`
and holds `src/repro_torch` to the same invariants.

  ANA001  no bare ``assert`` in library code. `python -O` strips asserts,
          so a contract guarded by one silently vanishes in optimized
          deployments: raise ValueError/TypeError instead.
  ANA002  no ad-hoc membrane clamping outside `core/quant.py`: any
          ``clip(...)`` (numpy/jnp) or ``torch.clamp``/``clip``/
          ``clamp_min``/``clamp_max``/``.clamp(...)`` bounded by the
          V-word constants (V_MIN / V_MAX / +-1024 / 1023), any
          ``% V_SPAN`` wrap, or ``torch.remainder(..., V_SPAN)``. Exactly
          one wrap and one saturate implementation may exist
          (`quant.clamp_v` / `clamp_v_np`), or backends drift apart one
          copied clamp at a time.
  ANA003  no unseeded randomness in library paths: legacy global-state
          ``np.random.<fn>()`` draws, ``default_rng()`` / ``RandomState()``
          constructed without a seed, and ``torch.rand*``/``randint``/
          ``randperm``/``bernoulli``/``multinomial``/``normal`` (and the
          in-place ``Tensor.normal_``/``uniform_``/... draws) without a
          ``generator=``. Reproducibility (bit-identical rasters,
          deterministic benchmarks) requires every stream of randomness to
          be explicitly keyed.
  ANA004  the user-facing API surface (`core/pipeline.py`, `serve/`,
          `dist/`) documents itself: every public function or public-class
          method there needs a docstring, and when it takes parameters the
          docstring must mention at least one by name.
  ANA005  no float casts in int-domain modules (`kernels/fused_snn_net/`,
          `core/isa.py`, `core/macro.py`): any ``.astype(<float dtype>)``,
          ``.float()``/``.double()``/``.half()``/``.bfloat16()``, or
          ``jnp.float*`` / ``np.float*`` / ``torch.float*`` dtype reference
          (``.to(torch.float64)`` and ``dtype=torch.float32`` included).
          The word-level semantics are exact-integer end to end; one stray
          f32 round-trip breaks bit-identity silently on values past 2**24.
          The trace pass (`check_trace`) proves the same property on the
          traced aten graph; ANA005 catches it at the source level.

Suppress a finding with ``# noqa: ANA00x`` on the offending line.

Pure stdlib (ast) on purpose: the lint runs without torch.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Optional

RULES = {
    "ANA001": "bare assert in library code (stripped under python -O); "
              "raise ValueError/TypeError",
    "ANA002": "ad-hoc membrane clamp; route through quant.clamp_v / "
              "quant.clamp_v_np / quant.spike_compare",
    "ANA003": "unseeded randomness in library code; pass an explicit "
              "seed/key",
    "ANA004": "public API function without a parameter-documenting "
              "docstring (core/pipeline.py, serve/, dist/)",
    "ANA005": "float cast in int-domain module; integer kernels are exact "
              "end to end — float belongs in core/quant.py or the float "
              "backend",
}

#: files whose public surface ANA004 holds to documented-call standard:
#: exact path suffixes and directory fragments under the package
_DOC_SCOPE_SUFFIXES = ("core/pipeline.py",)
_DOC_SCOPE_DIRS = ("/serve/", "/dist/")

#: modules whose arithmetic must stay exact-integer (ANA005): the fused
#: kernels and the word-level macro/ISA models
_INT_DOMAIN_DIRS = ("/kernels/fused_snn_net/",)
_INT_DOMAIN_SUFFIXES = ("core/isa.py", "core/macro.py")
#: floating dtype attribute names on jnp/np (jnp.float32, np.bfloat16, ...)
_FLOAT_DTYPE_ATTRS = {"float16", "float32", "float64", "float128",
                      "bfloat16", "float_", "half", "single", "double"}
#: module roots those attributes are flagged under
_ARRAY_ROOTS = {"jnp", "np", "numpy", "jax", "jax_numpy", "torch"}
#: torch's own float dtype aliases beyond the numpy names (``torch.float``)
_TORCH_FLOAT_ATTRS = {"float", "cfloat", "cdouble"}
#: tensor methods that cast to a float dtype (``x.float()``)
_FLOAT_CAST_METHODS = {"float", "double", "half", "bfloat16"}

#: the one module allowed to implement clamping
_CLAMP_HOME = ("core", "quant.py")
#: names/constants that mark a clip call as a *membrane* clamp
_V_NAMES = {"V_MIN", "V_MAX"}
_V_CONSTS = {-1024, 1023, 1024}
#: legacy numpy global-RNG draw functions (always unseeded global state)
_NP_GLOBAL_DRAWS = {
    "rand", "randn", "randint", "random", "random_sample", "ranf",
    "sample", "choice", "bytes", "shuffle", "permutation", "uniform",
    "normal", "standard_normal", "poisson", "binomial", "beta", "gamma",
    "exponential", "geometric",
}
#: torch draws that take an explicit ``generator=`` (global state without)
_TORCH_DRAWS = {"rand", "rand_like", "randn", "randn_like", "randint",
                "randint_like", "randperm", "bernoulli", "multinomial",
                "normal", "poisson"}
#: in-place tensor draws (``x.normal_()``), global state without generator=
_TORCH_INPLACE_DRAWS = {"normal_", "uniform_", "bernoulli_", "random_",
                        "exponential_", "geometric_", "cauchy_",
                        "log_normal_"}
#: clamp spellings whose bounds ANA002 inspects: numpy/jnp ``clip`` and the
#: torch functions and methods
_CLAMP_FNS = {"clip", "clamp", "clamp_min", "clamp_max", "clip_", "clamp_",
              "clamp_min_", "clamp_max_"}
#: modulo spellings whose divisor ANA002 inspects
_MOD_FNS = {"remainder", "remainder_"}


@dataclass(frozen=True)
class LintViolation:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


def _attr_chain(node: ast.AST) -> list:
    """['np', 'random', 'default_rng'] for np.random.default_rng."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return parts[::-1]


def _mentions_v_const(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in _V_NAMES:
            return True
        if isinstance(sub, ast.Constant) and sub.value in _V_CONSTS:
            return True
        if (isinstance(sub, ast.UnaryOp) and isinstance(sub.op, ast.USub)
                and isinstance(sub.operand, ast.Constant)
                and isinstance(sub.operand.value, int)
                and -sub.operand.value in _V_CONSTS):
            return True
    return False


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, clamp_home: bool,
                 doc_scope: bool = False, int_scope: bool = False) -> None:
        self.path = path
        self.clamp_home = clamp_home
        self.doc_scope = doc_scope
        self.int_scope = int_scope
        self._class_public: list[bool] = []   # enclosing-class publicness
        self._fn_depth = 0
        self.found: list[LintViolation] = []

    def _add(self, node: ast.AST, rule: str, message: str) -> None:
        self.found.append(LintViolation(
            path=self.path, line=node.lineno, col=node.col_offset + 1,
            rule=rule, message=message))

    # ANA001 ---------------------------------------------------------------
    def visit_Assert(self, node: ast.Assert) -> None:
        self._add(node, "ANA001", RULES["ANA001"])
        self.generic_visit(node)

    # ANA004 ---------------------------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_public.append(not node.name.startswith("_"))
        self.generic_visit(node)
        self._class_public.pop()

    def _check_doc(self, node) -> None:
        """ANA004: public functions of the API surface carry docstrings
        that name at least one of their parameters."""
        public = (not node.name.startswith("_")
                  and self._fn_depth == 0
                  and all(self._class_public))
        if not (self.doc_scope and public):
            return
        doc = ast.get_docstring(node)
        if not doc:
            self._add(node, "ANA004",
                      f"'{node.name}' has no docstring; " + RULES["ANA004"])
            return
        a = node.args
        params = [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]
        params += [p.arg for p in (a.vararg, a.kwarg) if p is not None]
        params = [p for p in params if p not in ("self", "cls")]
        if params and not any(
                re.search(rf"\b{re.escape(p)}\b", doc) for p in params):
            self._add(node, "ANA004",
                      f"'{node.name}' docstring names none of its "
                      f"parameters {params}; " + RULES["ANA004"])

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._check_doc(node)
        self._fn_depth += 1
        self.generic_visit(node)
        self._fn_depth -= 1

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._check_doc(node)
        self._fn_depth += 1
        self.generic_visit(node)
        self._fn_depth -= 1

    # ANA002 ---------------------------------------------------------------
    def visit_BinOp(self, node: ast.BinOp) -> None:
        if (not self.clamp_home and isinstance(node.op, ast.Mod)
                and isinstance(node.right, ast.Name)
                and node.right.id == "V_SPAN"):
            self._add(node, "ANA002", "wrap via '% V_SPAN'; "
                      + RULES["ANA002"])
        self.generic_visit(node)

    # ANA002 + ANA003 ------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func)
        if not self.clamp_home and chain and chain[-1] in _CLAMP_FNS:
            # a module function (np.clip(v, lo, hi), torch.clamp(v, ...))
            # takes the clamped value first; a method (v.clamp(lo, hi))
            # takes only the bounds
            bounds = (node.args[1:] if chain[0] in _ARRAY_ROOTS
                      else node.args)
            if any(_mentions_v_const(a) for a in bounds) or any(
                    _mentions_v_const(k.value) for k in node.keywords):
                self._add(node, "ANA002",
                          f"{chain[-1]} to the V word; " + RULES["ANA002"])
        if (not self.clamp_home and chain and chain[-1] in _MOD_FNS
                and any(isinstance(a, ast.Name) and a.id == "V_SPAN"
                        for a in node.args)):
            self._add(node, "ANA002", f"wrap via '{chain[-1]}(..., V_SPAN)'; "
                      + RULES["ANA002"])
        if len(chain) >= 2 and chain[-2] == "random" and chain[0] in (
                "np", "numpy"):
            fn = chain[-1]
            if fn in _NP_GLOBAL_DRAWS:
                self._add(node, "ANA003", f"np.random.{fn} draws from "
                          "global state; " + RULES["ANA003"])
            elif fn in ("default_rng", "RandomState") and not node.args \
                    and not node.keywords:
                self._add(node, "ANA003", f"np.random.{fn}() without a "
                          "seed; " + RULES["ANA003"])
        seeded = any(k.arg == "generator" for k in node.keywords)
        if not seeded and ((len(chain) == 2 and chain[0] == "torch"
                            and chain[1] in _TORCH_DRAWS)
                           or (len(chain) >= 2
                               and chain[-1] in _TORCH_INPLACE_DRAWS)):
            self._add(node, "ANA003", f"{'.'.join(chain)} without a "
                      "generator= draws from global state; "
                      + RULES["ANA003"])
        if (self.int_scope and chain and chain[-1] == "astype"
                and node.args and self._float_dtype_arg(node.args[0])):
            self._add(node, "ANA005",
                      "astype to a float dtype; " + RULES["ANA005"])
        if (self.int_scope and isinstance(node.func, ast.Attribute)
                and node.func.attr in _FLOAT_CAST_METHODS
                and not node.args and not node.keywords
                and chain and chain[0] not in _ARRAY_ROOTS):
            self._add(node, "ANA005",
                      f".{node.func.attr}() casts to a float dtype; "
                      + RULES["ANA005"])
        self.generic_visit(node)

    # ANA005 ---------------------------------------------------------------
    @staticmethod
    def _float_dtype_arg(node: ast.AST) -> bool:
        """True for the astype args visit_Attribute can't see: the builtin
        ``float`` and dtype strings ("float32", "bfloat16", ...).
        jnp.float* / np.float* attribute args are caught by
        visit_Attribute directly."""
        if isinstance(node, ast.Name) and node.id == "float":
            return True
        return (isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and node.value.lstrip("b").startswith("float"))

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if self.int_scope and (node.attr in _FLOAT_DTYPE_ATTRS
                               or node.attr in _TORCH_FLOAT_ATTRS):
            chain = _attr_chain(node)
            if chain and (chain[0] in _ARRAY_ROOTS
                          if node.attr in _FLOAT_DTYPE_ATTRS
                          else chain == ["torch", node.attr]):
                self._add(node, "ANA005",
                          f"{'.'.join(chain)} in an int-domain module; "
                          + RULES["ANA005"])
        self.generic_visit(node)


def _noqa_lines(source: str) -> dict:
    """line number -> set of suppressed rule ids ({'*'} for bare noqa)."""
    out: dict[int, set] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        if "noqa" not in line:
            continue
        _, _, tail = line.partition("noqa")
        tail = tail.lstrip(" :")
        rules = {t.strip().rstrip(",") for t in tail.split()
                 if t.strip().startswith("ANA")}
        out[i] = rules or {"*"}
    return out


def lint_source(source: str, path: str = "<string>") -> list:
    """Lint one module's ``source``; returns the surviving violations
    (``path`` scopes the path-dependent rules and labels findings)."""
    norm = path.replace("\\", "/")
    clamp_home = norm.endswith("/".join(_CLAMP_HOME))
    doc_scope = (norm.endswith(_DOC_SCOPE_SUFFIXES)
                 or any(d in norm for d in _DOC_SCOPE_DIRS))
    int_scope = (norm.endswith(_INT_DOMAIN_SUFFIXES)
                 or any(d in norm for d in _INT_DOMAIN_DIRS))
    tree = ast.parse(source, filename=path)
    visitor = _Visitor(path, clamp_home, doc_scope, int_scope)
    visitor.visit(tree)
    noqa = _noqa_lines(source)
    return [v for v in visitor.found
            if not (v.line in noqa
                    and ("*" in noqa[v.line] or v.rule in noqa[v.line]))]


def lint_file(path) -> list:
    p = Path(path)
    return lint_source(p.read_text(), str(p))


def lint_paths(paths: Iterable, *, exclude: Optional[Iterable] = None
               ) -> list:
    """Lint every ``*.py`` under the given files/directories (sorted), for
    stable, diffable output. ``exclude``: path substrings to skip."""
    exclude = tuple(exclude or ())
    files: list[Path] = []
    for root in paths:
        root = Path(root)
        files.extend(sorted(root.rglob("*.py")) if root.is_dir() else [root])
    out = []
    for f in files:
        s = str(f)
        if any(e in s for e in exclude):
            continue
        out.extend(lint_file(f))
    return out
