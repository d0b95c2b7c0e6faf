"""Replicated-control-flow lint (pure AST; imports no torch).

Port of `repro/analysis/replicated_lint.py`, pointed at the port's
control plane (`repro_torch/api/loop.py` and `repro_torch/api/engines/
*.py`) with torch's policy. Every per-round decision must derive from
values that are the same on every process by construction:

  * the `HostRoundInfo` landed by `fetch_round_info` (the round's
    reduced scalars, one transfer a round),
  * the resolved `FitConfig` and engine statics (seed-determined),
  * the sanctioned primitives `run.sync_flag` / `run.resolve_resume`.

Anything else — a live tensor, the wall clock, an unseeded RNG draw —
is process-local: a branch on it can diverge across ranks, and a host
coercion of it is also a hidden device synchronisation per round. The
lint walks the per-round code and flags three kinds:

  branch         an if/while/ternary/assert/comprehension condition
                 whose value does not derive from the safe roots
  host-coercion  float()/int()/bool()/np.asarray()/.item()/.tolist()/
                 .cpu()/.numpy() applied to a non-derived value
  rng-draw       any RNG call in per-round code (sanctioned streams are
                 allowlisted with the seed-derivation argument)

Scope: the bodies of `run_loop`'s top-level loops plus its nested
helpers, and the per-round methods of every engine class (nested_step /
lloyd_step / mb_step / eval_mse / sync_flag / _ensure_prefix / _fetch /
_fetch_block). The derivation analysis is a fixpoint over local
assignments: a name is safe iff every assignment to it is a safe
expression. ``torch.*`` calls give device values (unsafe) but for the
topology calls `torch.distributed.get_rank`/`get_world_size`; ``time.*``
is host-local entropy. A new unsafe-looking site is a finding even if
benign: derive it from `RoundInfo`, or add an ``allowlist.txt`` entry
WITH A REASON.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.report import Violation, rel, repo_root

# -- policy ------------------------------------------------------------------

#: engine methods that run in the steady-state loop (directly or via a
#: sanctioned scope); everything else on an engine is begin/end-of-fit.
PER_ROUND_METHODS = {
    "nested_step", "lloyd_step", "mb_step", "eval_mse", "sync_flag",
    "_ensure_prefix", "_fetch", "_fetch_block",
}

#: attributes of `run`/`self` that ARE live device state (unsafe);
#: every other run/self attribute is an engine static by contract.
RUN_UNSAFE_ATTRS = {"state", "_Xd", "_Xv", "_mb_idx"}

#: parameters that carry device state into per-round methods.
UNSAFE_PARAM_NAMES = {"state", "new_state", "arr", "stats", "X", "Xs", "seg"}

#: calls whose result is process-replicated even though the root module
#: is otherwise unsafe (cluster topology statics).
SAFE_QUALIFIED_CALLS = {
    "torch.distributed.get_rank", "torch.distributed.get_world_size",
}

#: module roots whose call results are device values (branching on them
#: would sync) or host-local entropy (wall clock).
DEVICE_MODULE_ROOTS = {"torch"}
UNSAFE_MODULE_ROOTS = {"time"}

#: calls that sanitise an unsafe value into a replicated host value.
SANITIZER_METHODS = {"sync_flag", "resolve_resume"}   # on run/self
SANITIZER_FUNCS = {"fetch_round_info"}                # bare names

#: tensor metadata: identical on every process regardless of the
#: tensor's safety (structure, not contents).
METADATA_ATTRS = {
    "shape", "dtype", "ndim", "nbytes", "device", "is_cuda", "layout",
}

#: builtins that are safe when their arguments are safe.
SAFE_BUILTINS = {
    "float", "int", "bool", "str", "min", "max", "abs", "len", "sorted",
    "sum", "round", "tuple", "list", "dict", "set", "range", "enumerate",
    "zip", "isinstance", "type", "getattr", "hasattr", "repr", "divmod",
    "next", "iter", "map", "filter", "all", "any",
}

#: method names safe to call on safe objects (pure container reads and
#: (de)serialisers of host dicts/records).
SAFE_METHODS = {
    "get", "items", "keys", "values", "copy", "to_dict", "from_dict",
    "as_posix", "bit_length", "startswith", "endswith", "split", "strip",
}

#: builtins whose result is process-replicated no matter the argument:
#: they read type/shape structure, not device contents.
METADATA_BUILTINS = {"isinstance", "len", "type"}

#: host coercions (device->host syncs when applied to device values).
COERCION_BUILTINS = {"float", "int", "bool"}
COERCION_NP_ATTRS = {"asarray", "array"}
COERCION_METHODS = {"item", "tolist", "cpu", "numpy"}

#: RNG fingerprints: any dotted-path segment in here marks a draw.
RNG_SEGMENTS = {"rng", "_rng", "random"}
RNG_FUNCS = {"default_rng"}


# -- small AST helpers -------------------------------------------------------

def _dotted(node: ast.AST) -> Optional[List[str]]:
    """['np', 'random', 'default_rng'] for np.random.default_rng; None
    when the chain is not rooted at a plain Name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def _snippet(source: str, node: ast.AST) -> str:
    seg = ast.get_source_segment(source, node) or type(node).__name__
    seg = " ".join(seg.split())
    return seg if len(seg) <= 88 else seg[:85] + "..."


# -- derivation environment --------------------------------------------------

@dataclasses.dataclass
class _Env:
    """name -> list of value-expressions assigned to it (fixpoint input);
    `safety` is the fixpoint output. ``parent`` chains a nested helper
    to its enclosing function's environment (closure reads)."""
    assigns: Dict[str, List[Optional[ast.AST]]]
    safety: Dict[str, bool]
    parent: Optional["_Env"] = None

    def is_local(self, name: str) -> bool:
        return (name in self.assigns
                or (self.parent is not None
                    and self.parent.is_local(name)))

    def safe(self, name: str) -> bool:
        # names never bound locally resolve outward: the enclosing
        # function first, then module scope — functions, classes,
        # imports, constants are safe as VALUES (their calls are
        # judged separately).
        if name in self.safety:
            return self.safety[name]
        if self.parent is not None:
            return self.parent.safe(name)
        return True


def _bind(env: Dict[str, List[Optional[ast.AST]]],
          target: ast.AST, value: Optional[ast.AST]) -> None:
    if isinstance(target, ast.Name):
        env.setdefault(target.id, []).append(value)
    elif isinstance(target, (ast.Tuple, ast.List)):
        elts = target.elts
        if (isinstance(value, (ast.Tuple, ast.List))
                and len(value.elts) == len(elts)):
            for t, v in zip(elts, value.elts):
                _bind(env, t, v)
        else:
            for t in elts:
                _bind(env, t, value)
    elif isinstance(target, ast.Starred):
        _bind(env, target.value, value)
    # attribute/subscript targets: safety of self._x reads is governed
    # by the RUN_UNSAFE_ATTRS policy, not by local flow.


class _Sentinel(ast.AST):
    """Stands in for 'definitely safe' / 'definitely unsafe' bindings."""
    def __init__(self, safe: bool):
        self.safe = safe


def _walk_own_scope(func: ast.FunctionDef):
    """Walk ``func``'s body without descending into nested function or
    lambda scopes (their locals must not leak into this env); the
    nested def/lambda node itself IS yielded so its name gets bound."""
    stack = list(func.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def build_env(func: ast.FunctionDef,
              parent: Optional[_Env] = None) -> _Env:
    """Collect ``func``'s own local bindings (nested helpers get their
    own child env via ``parent``) and solve the safety fixpoint."""
    assigns: Dict[str, List[Optional[ast.AST]]] = {}
    args = func.args
    for a in (list(args.posonlyargs) + list(args.args)
              + list(args.kwonlyargs)
              + ([args.vararg] if args.vararg else [])
              + ([args.kwarg] if args.kwarg else [])):
        assigns.setdefault(a.arg, []).append(
            _Sentinel(a.arg not in UNSAFE_PARAM_NAMES))
    for node in _walk_own_scope(func):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                _bind(assigns, t, node.value)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            _bind(assigns, node.target, node.value)
        elif isinstance(node, ast.AugAssign):
            # x += v : final safety = old AND safety(v); the fixpoint
            # ANDs contributions, so recording v alone is exact.
            _bind(assigns, node.target, node.value)
        elif isinstance(node, ast.NamedExpr):
            _bind(assigns, node.target, node.value)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            _bind(assigns, node.target, node.iter)
        elif isinstance(node, ast.comprehension):
            _bind(assigns, node.target, node.iter)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if item.optional_vars is not None:
                    _bind(assigns, item.optional_vars, item.context_expr)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            assigns.setdefault(node.name, []).append(_Sentinel(True))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                name = (alias.asname or alias.name).split(".")[0]
                assigns.setdefault(name, []).append(_Sentinel(True))
        elif isinstance(node, ast.ExceptHandler) and node.name:
            assigns.setdefault(node.name, []).append(_Sentinel(True))

    env = _Env(assigns=assigns, safety={n: True for n in assigns},
               parent=parent)
    for _ in range(len(assigns) + 2):       # monotone: converges
        changed = False
        for name, values in assigns.items():
            ok = all(_expr_safe(v, env) if not isinstance(v, _Sentinel)
                     else v.safe
                     for v in values if v is not None)
            if ok != env.safety[name]:
                env.safety[name] = ok
                changed = True
        if not changed:
            break
    return env


# -- expression safety -------------------------------------------------------

def _is_sanitizer(func: ast.AST) -> bool:
    if isinstance(func, ast.Name):
        return func.id in SANITIZER_FUNCS
    if isinstance(func, ast.Attribute):
        return (isinstance(func.value, ast.Name)
                and func.value.id in ("run", "self")
                and func.attr in SANITIZER_METHODS)
    return False


def _is_rng(func: ast.AST) -> bool:
    parts = _dotted(func)
    if parts is None:
        return False
    return (bool(set(parts) & RNG_SEGMENTS)
            or parts[-1] in RNG_FUNCS)


def _call_safe(call: ast.Call, env: _Env) -> bool:
    func = call.func
    if _is_sanitizer(func):
        return True
    if _is_rng(func):
        return False
    parts = _dotted(func)
    args_safe = (all(_expr_safe(a, env) for a in call.args)
                 and all(_expr_safe(k.value, env) for k in call.keywords))
    if parts is not None:
        qual = ".".join(parts)
        if qual in SAFE_QUALIFIED_CALLS:
            return True
        root = parts[0]
        if root in DEVICE_MODULE_ROOTS or root in UNSAFE_MODULE_ROOTS:
            return False
        if len(parts) == 1:
            # bare name: builtin / module-level function / local callable
            if root in METADATA_BUILTINS:
                return True       # reads structure, never device values
            if root in SAFE_BUILTINS:
                return args_safe
            if env.is_local(root):
                return env.safe(root) and args_safe
            return args_safe      # module-level def/import
        # dotted: method/function on some object
        if root in ("run", "self"):
            return False          # non-sanctioned engine method result
        if env.is_local(root):
            # method on a runtime object (store.latest_step(), ...)
            return (env.safe(root) and parts[-1] in SAFE_METHODS
                    and args_safe)
        # module- or class-rooted helper (np.unique, math.isfinite,
        # Telemetry.from_dict)
        return args_safe
    # calls on computed receivers: self._store.take(...).astype(...)
    if isinstance(func, ast.Attribute):
        return (func.attr in SAFE_METHODS and _expr_safe(func.value, env)
                and args_safe)
    return False


def _expr_safe(node: Optional[ast.AST], env: _Env) -> bool:
    if node is None:
        return True
    if isinstance(node, _Sentinel):
        return node.safe
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return env.safe(node.id)
    if isinstance(node, ast.Attribute):
        if node.attr in METADATA_ATTRS:
            return True
        if (isinstance(node.value, ast.Name)
                and node.value.id in ("run", "self")):
            return node.attr not in RUN_UNSAFE_ATTRS
        return _expr_safe(node.value, env)
    if isinstance(node, ast.Call):
        return _call_safe(node, env)
    if isinstance(node, ast.Compare):
        # presence tests read structure, never device values
        if (all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops)
                and all(isinstance(c, ast.Constant) and c.value is None
                        for c in node.comparators)):
            return True
        return (_expr_safe(node.left, env)
                and all(_expr_safe(c, env) for c in node.comparators))
    if isinstance(node, (ast.BoolOp,)):
        return all(_expr_safe(v, env) for v in node.values)
    if isinstance(node, ast.BinOp):
        return _expr_safe(node.left, env) and _expr_safe(node.right, env)
    if isinstance(node, ast.UnaryOp):
        return _expr_safe(node.operand, env)
    if isinstance(node, ast.IfExp):
        return (_expr_safe(node.test, env) and _expr_safe(node.body, env)
                and _expr_safe(node.orelse, env))
    if isinstance(node, ast.Subscript):
        return _expr_safe(node.value, env) and _expr_safe(node.slice, env)
    if isinstance(node, ast.Slice):
        return (_expr_safe(node.lower, env) and _expr_safe(node.upper, env)
                and _expr_safe(node.step, env))
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return all(_expr_safe(e, env) for e in node.elts)
    if isinstance(node, ast.Dict):
        return (all(_expr_safe(k, env) for k in node.keys if k is not None)
                and all(_expr_safe(v, env) for v in node.values))
    if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
        return (_expr_safe(node.elt, env)
                and all(_expr_safe(g.iter, env)
                        and all(_expr_safe(i, env) for i in g.ifs)
                        for g in node.generators))
    if isinstance(node, ast.DictComp):
        return (_expr_safe(node.key, env) and _expr_safe(node.value, env)
                and all(_expr_safe(g.iter, env) for g in node.generators))
    if isinstance(node, ast.JoinedStr):
        return all(_expr_safe(v, env) for v in node.values)
    if isinstance(node, ast.FormattedValue):
        return _expr_safe(node.value, env)
    if isinstance(node, (ast.Lambda, ast.Starred)):
        return True
    return False          # unknown node kind: conservative


# -- region scanning ---------------------------------------------------------

@dataclasses.dataclass
class _Region:
    qualname: str
    stmts: List[ast.stmt]
    env: _Env


def _scan_region(region: _Region, source: str, path: str
                 ) -> List[Violation]:
    out: List[Violation] = []
    env = region.env

    def flag(kind: str, node: ast.AST, what: ast.AST) -> None:
        out.append(Violation(
            checker="lint", kind=kind, file=path, line=node.lineno,
            qualname=region.qualname, detail=_snippet(source, what)))

    seen: Set[int] = set()
    for stmt in region.stmts:
        for node in ast.walk(stmt):
            if id(node) in seen:
                continue
            seen.add(id(node))
            if isinstance(node, (ast.If, ast.While)):
                if not _expr_safe(node.test, env):
                    flag("branch", node, node.test)
            elif isinstance(node, ast.IfExp):
                if not _expr_safe(node.test, env):
                    flag("branch", node, node.test)
            elif isinstance(node, ast.Assert):
                if not _expr_safe(node.test, env):
                    flag("branch", node, node.test)
            elif isinstance(node, ast.comprehension):
                for cond in node.ifs:
                    if not _expr_safe(cond, env):
                        flag("branch", cond, cond)
            elif isinstance(node, ast.Call):
                if _is_rng(node.func):
                    flag("rng-draw", node, node)
                    continue
                f = node.func
                coercing = False
                obj: Optional[ast.AST] = None
                if (isinstance(f, ast.Name)
                        and f.id in COERCION_BUILTINS
                        and not env.is_local(f.id)):
                    coercing = any(not _expr_safe(a, env)
                                   for a in node.args)
                elif isinstance(f, ast.Attribute):
                    parts = _dotted(f)
                    if (parts and parts[0] in ("np", "numpy")
                            and f.attr in COERCION_NP_ATTRS):
                        coercing = any(not _expr_safe(a, env)
                                       for a in node.args)
                    elif f.attr in COERCION_METHODS:
                        obj = f.value
                        coercing = not _expr_safe(obj, env)
                if coercing:
                    flag("host-coercion", node, node)
    return out


# -- scope extraction --------------------------------------------------------

def _loop_regions(tree: ast.Module) -> List[_Region]:
    """Regions for run_loop: the bodies of its top-level for/while
    loops (the round loop) plus its nested helpers, which execute every
    round and close over the loop's locals."""
    out: List[_Region] = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == "run_loop":
            outer = build_env(node)
            for stmt in node.body:
                if isinstance(stmt, (ast.For, ast.While)):
                    out.append(_Region("run_loop", list(stmt.body),
                                       outer))
                elif isinstance(stmt, ast.FunctionDef):
                    out.append(_Region(
                        f"run_loop.{stmt.name}", list(stmt.body),
                        build_env(stmt, parent=outer)))
    return out


def _engine_regions(tree: ast.Module) -> List[_Region]:
    out: List[_Region] = []
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if (isinstance(item, ast.FunctionDef)
                        and item.name in PER_ROUND_METHODS):
                    out.append(_Region(f"{node.name}.{item.name}",
                                       list(item.body), build_env(item)))
    return out


def lint_file(path, mode: str) -> List[Violation]:
    """Lint one file. ``mode``: "loop" (run_loop regions) or "engine"
    (per-round methods of every class)."""
    path = Path(path)
    source = path.read_text()
    tree = ast.parse(source, filename=str(path))
    regions = (_loop_regions(tree) if mode == "loop"
               else _engine_regions(tree))
    relpath = rel(path)
    violations: List[Violation] = []
    for region in regions:
        violations.extend(_scan_region(region, source, relpath))
    return violations


def default_files() -> List[Tuple[Path, str]]:
    root = repo_root()
    files: List[Tuple[Path, str]] = [
        (root / "src/repro_torch/api/loop.py", "loop")]
    for p in sorted((root / "src/repro_torch/api/engines").glob("*.py")):
        if p.name != "__init__.py":
            files.append((p, "engine"))
    return files


def run(files: Optional[Iterable[Tuple[Path, str]]] = None,
        allowlist_path=None, check_stale: bool = True
        ) -> List[Violation]:
    """Lint the control plane; returns unexcused violations (plus stale
    allowlist entries when ``check_stale``)."""
    from repro_torch.analysis import allowlist as al
    found: List[Violation] = []
    for path, mode in (files if files is not None else default_files()):
        found.extend(lint_file(path, mode))
    entries = al.load(allowlist_path)
    kept, used = al.apply(found, entries)
    if check_stale:
        kept.extend(al.unused_entries(entries, used, allowlist_path))
    return kept
