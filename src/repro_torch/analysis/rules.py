"""simlint rules for the port — the simulator's invariants as AST checks.

The port of the JAX package's ``analysis/rules.py``: the same four
families and codes, recast for torch.

SIM1xx  RNG discipline
    SIM101  the global torch RNG in library code: ``torch.manual_seed``
            (or ``torch.cuda.manual_seed*``), or a torch draw
            (``torch.rand``/``randn``/``randint``/``randperm``/
            ``multinomial``/``bernoulli``/``normal``/..., a tensor's
            ``normal_``/``uniform_``/...) without ``generator=``: its
            stream is shared process-wide, so any other draw moves it.
            (The reference's SIM101 is JAX key reuse; a
            ``torch.Generator`` carries its own state, so its analogue is
            a draw that takes no generator at all.)
    SIM102  a generator seeded from a literal (``.manual_seed(0)``) in
            library code — seeds must flow from config or arguments.
    SIM103  ``np.random`` / stdlib ``random`` under ``src/repro_torch/`` —
            host RNG streams are allowed only where a pinned draw
            schedule is documented (baseline / suppression).
    SIM104  an RNG draw inside a Python-level branch: the draw *schedule*
            then depends on host data (``advance_to(t1); advance_to(t2)``
            consuming another stream than ``advance_to(t2)``).

SIM2xx  host/device boundary (hot-path modules only)
    SIM201  ``.item()`` / ``.tolist()`` — implicit device→host sync.
    SIM202  ``.cpu()`` / ``.numpy()`` / ``np.asarray`` / ``np.array`` —
            host materialisation; each hot-path use needs a
            justification.
    SIM203  ``float()/int()/bool()`` directly on a ``torch`` expression —
            an implicit blocking transfer.

SIM3xx  purity of traced code: the functions handed to ``torch.func``'s
        ``grad``/``vmap``/``jvp``/``vjp`` (and ``jacrev``, ``jacfwd``,
        ``hessian``, ``grad_and_value``), the ``forward``/``backward`` of
        ``torch.autograd.Function`` subclasses, and what they call.  Eager
        torch re-runs them on every call, but a transform runs them on
        wrapped tensors once for a whole batch (vmap) or on a level of its
        own (grad, jvp): a side effect happens once instead of per example,
        and a tensor stored outside escapes its transform.
    SIM301  ``print`` / ``breakpoint`` inside traced code.
    SIM302  wall-clock reads (``time.*`` / ``datetime.now``).
    SIM303  tracer/telemetry calls (``obs.CURRENT.span`` etc.).
    SIM304  mutation of enclosing state (``global``/``nonlocal``, stores
            into free or parameter containers; an autograd ``Function``'s
            ``ctx`` is exempt: storing into it is its job).

SIM4xx  observability read-only
    SIM401  ``src/repro_torch/obs`` importing simulator packages.
    SIM402  obs code calling state-mutating simulator APIs.

Every rule yields precise ``file:line:col`` findings; scoping decisions
(which paths a rule patrols) live here, next to the rule they belong to.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.core import Finding, ModuleInfo, in_hot_path

__all__ = ["REGISTRY", "Rule", "rule"]


class Rule:
    code = "SIM000"
    name = "abstract"
    doc = ""

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        raise NotImplementedError


REGISTRY: List[Rule] = []


def rule(cls):
    REGISTRY.append(cls())
    return cls


# ----------------------------------------------------------------------
# import alias resolution
# ----------------------------------------------------------------------
class Aliases:
    """Maps local names to canonical dotted module paths, so rules see
    ``F.normalize`` as ``torch.nn.functional.normalize`` and know whether
    a bare ``random`` is the stdlib module."""

    def __init__(self, tree: ast.Module):
        self.names: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.names[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.names[a.asname or a.name] = \
                        f"{node.module}.{a.name}"

    def resolve(self, expr: ast.expr) -> Optional[str]:
        """Canonical dotted path of a Name/Attribute chain, or None."""
        parts: List[str] = []
        node = expr
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        base = self.names.get(node.id, node.id)
        parts.append(base)
        return ".".join(reversed(parts))


def dotted(expr: ast.expr) -> Optional[str]:
    """Literal dotted text of a Name/Attribute chain (no alias mapping)."""
    parts: List[str] = []
    node = expr
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


# torch functions that draw from an RNG (the global one unless given
# ``generator=``), and the tensor methods that do
TORCH_DRAWS = {
    "bernoulli", "multinomial", "normal", "poisson", "rand", "rand_like",
    "randint", "randint_like", "randn", "randn_like", "randperm",
}
TENSOR_DRAW_METHODS = {
    "bernoulli_", "cauchy_", "exponential_", "geometric_", "log_normal_",
    "normal_", "random_", "uniform_",
}
GLOBAL_SEEDERS = {"torch.manual_seed", "torch.random.manual_seed",
                  "torch.seed", "torch.cuda.manual_seed",
                  "torch.cuda.manual_seed_all"}
# numpy Generator draw methods (receiver name must look like an rng)
NP_DRAW_METHODS = {
    "beta", "binomial", "bytes", "chisquare", "choice", "dirichlet",
    "exponential", "f", "gamma", "geometric", "gumbel", "integers",
    "laplace", "logistic", "lognormal", "multinomial",
    "multivariate_normal", "negative_binomial", "noncentral_chisquare",
    "normal", "pareto", "permutation", "permuted", "poisson", "power",
    "random", "rayleigh", "shuffle", "standard_cauchy",
    "standard_exponential", "standard_gamma", "standard_normal",
    "standard_t", "triangular", "uniform", "vonmises", "wald", "weibull",
    "zipf",
}


def _torch_draw(aliases: Aliases, call: ast.Call) -> Optional[str]:
    """'torch.randn' (or '.normal_') for a call that draws from a torch
    RNG, else None."""
    path = aliases.resolve(call.func)
    if path and path.startswith("torch.") \
            and path.rsplit(".", 1)[-1] in TORCH_DRAWS \
            and path.count(".") == 1:
        return path
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr in TENSOR_DRAW_METHODS:
        return f".{call.func.attr}"
    return None


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


def _rng_method(func: ast.expr) -> Optional[Tuple[str, str]]:
    """(receiver, method) for ``<something rng-ish>.<draw-method>()``."""
    if not isinstance(func, ast.Attribute):
        return None
    recv = dotted(func.value)
    if recv is None:
        return None
    leaf = recv.rsplit(".", 1)[-1]
    if (leaf == "rng" or leaf.endswith("_rng") or leaf == "gen") \
            and func.attr in NP_DRAW_METHODS:
        return recv, func.attr
    return None


def _calls_in_order(node: ast.AST) -> List[ast.Call]:
    out: List[ast.Call] = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            out.append(sub)
    out.sort(key=lambda c: (c.lineno, c.col_offset))
    return out


def _library(mod: ModuleInfo) -> bool:
    return mod.in_src_repro() and not mod.is_testish()


# ----------------------------------------------------------------------
# SIM101 — the global torch RNG
# ----------------------------------------------------------------------
@rule
class GlobalTorchRng(Rule):
    code = "SIM101"
    name = "global-torch-rng"
    doc = ("torch.manual_seed, or a torch draw without generator=, in "
           "library code: the global stream is shared process-wide, so "
           "any other draw moves it; take a torch.Generator")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not _library(mod):
            return
        aliases = Aliases(mod.tree)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            path = aliases.resolve(node.func)
            if path in GLOBAL_SEEDERS:
                yield Finding(
                    self.code, mod.path, node.lineno, node.col_offset,
                    f"{path}() seeds the global RNG in library code; "
                    f"take a torch.Generator instead")
                continue
            draw = _torch_draw(aliases, node)
            if draw is not None and not _has_generator(node):
                yield Finding(
                    self.code, mod.path, node.lineno, node.col_offset,
                    f"{draw}() without generator= draws from the global "
                    f"torch RNG in library code")


# ----------------------------------------------------------------------
# SIM102 — literal seeds in library code
# ----------------------------------------------------------------------
@rule
class LiteralSeed(Rule):
    code = "SIM102"
    name = "literal-generator-seed"
    doc = ("<generator>.manual_seed(<literal>) in library code — seeds "
           "must come from config/arguments (tests and examples are "
           "exempt)")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not _library(mod):
            return
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "manual_seed" \
                    and node.args and isinstance(node.args[0], ast.Constant):
                yield Finding(
                    self.code, mod.path, node.lineno, node.col_offset,
                    f"manual_seed({node.args[0].value!r}) with a literal "
                    f"seed in library code; plumb the seed from config")


# ----------------------------------------------------------------------
# SIM103 — host RNG under src/repro_torch
# ----------------------------------------------------------------------
@rule
class HostRng(Rule):
    code = "SIM103"
    name = "host-rng-in-library"
    doc = ("np.random / stdlib random under src/repro_torch — host RNG "
           "streams need a documented, pinned draw schedule (baseline "
           "each one)")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not mod.in_src_repro():
            return
        aliases = Aliases(mod.tree)
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                modname = (node.module or "" if
                           isinstance(node, ast.ImportFrom)
                           else "")
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else [])
                if modname == "random" or "random" in names:
                    yield Finding(
                        self.code, mod.path, node.lineno,
                        node.col_offset,
                        "stdlib 'random' imported in library code; use "
                        "a seeded np.random.Generator or torch.Generator")
                continue
            if not isinstance(node, ast.Call):
                continue
            path = aliases.resolve(node.func)
            if path is None:
                continue
            if path.startswith("numpy.random.") or \
                    path.startswith("np.random."):
                member = path.rsplit(".", 1)[-1]
                kind = ("module-level numpy RNG (shared global state)"
                        if member not in ("default_rng", "Generator",
                                          "SeedSequence", "PCG64")
                        else "host RNG stream")
                yield Finding(
                    self.code, mod.path, node.lineno, node.col_offset,
                    f"{kind}: np.random.{member} in library code — "
                    f"host draws need a pinned, documented schedule")
            elif path.startswith("random.") and \
                    aliases.names.get("random", "random") == "random":
                yield Finding(
                    self.code, mod.path, node.lineno, node.col_offset,
                    f"stdlib {path} in library code; use a seeded "
                    f"np.random.Generator or torch.Generator")


# ----------------------------------------------------------------------
# SIM104 — draw schedule branches on Python data
# ----------------------------------------------------------------------
@rule
class BranchedDraw(Rule):
    code = "SIM104"
    name = "data-dependent-draw-schedule"
    doc = ("an RNG draw inside a Python-level branch makes the draw "
           "*schedule* depend on host data; hoist the draw to a fixed "
           "schedule")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not mod.in_src_repro():
            return
        aliases = Aliases(mod.tree)
        yield from self._walk(mod, aliases, mod.tree.body, 0)

    def _walk(self, mod: ModuleInfo, aliases: Aliases,
              stmts: Sequence[ast.stmt], depth: int) -> Iterator[Finding]:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._walk(mod, aliases, stmt.body, 0)
                continue
            if isinstance(stmt, ast.ClassDef):
                yield from self._walk(mod, aliases, stmt.body, depth)
                continue
            if isinstance(stmt, ast.If):
                yield from self._exprs(mod, aliases, [stmt.test], depth)
                yield from self._walk(mod, aliases, stmt.body, depth + 1)
                yield from self._walk(mod, aliases, stmt.orelse,
                                      depth + 1)
                continue
            if isinstance(stmt, ast.While):
                yield from self._exprs(mod, aliases, [stmt.test],
                                       depth + 1)
                yield from self._walk(mod, aliases, stmt.body, depth + 1)
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                yield from self._exprs(mod, aliases, [stmt.iter], depth)
                yield from self._walk(mod, aliases, stmt.body, depth)
                yield from self._walk(mod, aliases, stmt.orelse, depth)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                yield from self._walk(mod, aliases, stmt.body, depth)
                continue
            if isinstance(stmt, ast.Try):
                for block in (stmt.body, stmt.orelse, stmt.finalbody):
                    yield from self._walk(mod, aliases, block, depth)
                for h in stmt.handlers:
                    yield from self._walk(mod, aliases, h.body, depth + 1)
                continue
            yield from self._exprs(mod, aliases, [stmt], depth)

    def _exprs(self, mod: ModuleInfo, aliases: Aliases,
               nodes: Sequence[ast.AST], depth: int) -> Iterator[Finding]:
        for node in nodes:
            for call in _calls_in_order(node):
                extra = self._cond_depth(node, call)
                if depth + extra == 0:
                    continue
                what = _torch_draw(aliases, call)
                if what is None and _rng_method(call.func) is not None:
                    what = dotted(call.func)
                if what is None:
                    continue
                yield Finding(
                    self.code, mod.path, call.lineno, call.col_offset,
                    f"{what} draw inside a conditional: the RNG draw "
                    f"schedule now depends on Python-level state")

    @staticmethod
    def _cond_depth(root: ast.AST, call: ast.Call) -> int:
        """Extra conditional nesting of ``call`` *within* a statement:
        ternaries and comprehension ifs."""
        depth = 0
        for node in ast.walk(root):
            if isinstance(node, ast.IfExp):
                for branch in (node.body, node.orelse):
                    if call in ast.walk(branch):
                        depth += 1
            elif isinstance(node, (ast.ListComp, ast.SetComp,
                                   ast.DictComp, ast.GeneratorExp)):
                for gen in node.generators:
                    for cond in gen.ifs:
                        if call in ast.walk(cond):
                            depth += 1
        return depth


# ----------------------------------------------------------------------
# SIM2xx — host/device boundary in hot-path modules
# ----------------------------------------------------------------------
def _imports_torch(mod: ModuleInfo) -> bool:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            if any(a.name == "torch" or a.name.startswith("torch.")
                   for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] == "torch":
                return True
    return False


@rule
class HostSyncMethods(Rule):
    code = "SIM201"
    name = "implicit-host-sync-method"
    doc = (".item()/.tolist() in a hot-path module — implicit "
           "device-to-host sync; move it off the per-event path or "
           "justify with a suppression")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not in_hot_path(mod.path) or not _imports_torch(mod):
            return
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("item", "tolist"):
                yield Finding(
                    self.code, mod.path, node.lineno, node.col_offset,
                    f".{node.func.attr}() blocks on device work in a "
                    f"hot-path module")


@rule
class HostMaterialise(Rule):
    code = "SIM202"
    name = "host-materialisation"
    doc = (".cpu() / .numpy() / np.asarray / np.array in a hot-path module "
           "pulls device values to the host when fed a tensor; every use "
           "needs a justification (suppression) or a redesign")

    TARGETS = ("numpy.asarray", "numpy.array", "np.asarray", "np.array")
    METHODS = ("cpu", "numpy")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not in_hot_path(mod.path) or not _imports_torch(mod):
            return
        aliases = Aliases(mod.tree)
        # ``x.cpu().numpy()`` is one materialisation: report the chain once
        chained = {id(n.func.value) for n in ast.walk(mod.tree)
                   if isinstance(n, ast.Call)
                   and isinstance(n.func, ast.Attribute)
                   and n.func.attr == "numpy"}
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or id(node) in chained:
                continue
            path = aliases.resolve(node.func)
            if path in self.TARGETS:
                what = path
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in self.METHODS and not node.args:
                what = f".{node.func.attr}()"
            else:
                continue
            yield Finding(
                self.code, mod.path, node.lineno, node.col_offset,
                f"{what} in a hot-path module — host materialisation; "
                f"justify (host-only value) or keep it on device")


@rule
class ScalarCoercion(Rule):
    code = "SIM203"
    name = "scalar-coercion-of-device-value"
    doc = ("float()/int()/bool() wrapped directly around a torch "
           "expression is an implicit blocking device sync (static "
           "metadata reads — .shape/.ndim/.dtype — are exempt)")

    METADATA = ("shape", "ndim", "dtype", "itemsize")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not in_hot_path(mod.path) or not _imports_torch(mod):
            return
        aliases = Aliases(mod.tree)
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id in ("float", "int", "bool")
                    and node.args):
                continue
            # anything consumed through a .shape/.ndim/... attribute is a
            # static metadata read, not a device value
            meta_subtrees = [
                a.value for a in ast.walk(node.args[0])
                if isinstance(a, ast.Attribute) and a.attr in self.METADATA]
            for sub in ast.walk(node.args[0]):
                if isinstance(sub, ast.Call):
                    if any(sub in ast.walk(m) for m in meta_subtrees):
                        continue
                    path = aliases.resolve(sub.func)
                    if path and path.startswith("torch."):
                        yield Finding(
                            self.code, mod.path, node.lineno,
                            node.col_offset,
                            f"{node.func.id}() directly on a torch "
                            f"expression — implicit device sync")
                        break


# ----------------------------------------------------------------------
# SIM3xx — purity of what torch.func transforms and autograd Functions run
# ----------------------------------------------------------------------
# transforms whose function arguments run transformed (arg indices)
TRACED_CALLS: Dict[str, Tuple[int, ...]] = {
    "torch.func.grad": (0,), "torch.func.grad_and_value": (0,),
    "torch.func.vmap": (0,), "torch.vmap": (0,), "torch.func.jvp": (0,),
    "torch.func.vjp": (0,), "torch.func.jacrev": (0,),
    "torch.func.jacfwd": (0,), "torch.func.hessian": (0,),
}
AUTOGRAD_FUNCTION = ("torch.autograd.Function",
                     "torch.autograd.function.Function")
AUTOGRAD_METHODS = ("forward", "backward")


class _FnNode:
    def __init__(self, node, qual: str):
        self.node = node
        self.qual = qual
        self.calls: Set[str] = set()      # simple callee names
        self.root = False


def _callees(node: ast.AST) -> Set[str]:
    """Names of the module functions and ``self`` methods ``node``
    calls."""
    out: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            if isinstance(sub.func, ast.Name):
                out.add(sub.func.id)
            elif isinstance(sub.func, ast.Attribute) \
                    and isinstance(sub.func.value, ast.Name) \
                    and sub.func.value.id in ("self", "cls"):
                out.add(sub.func.attr)
    return out


def _collect_traced_graph(mod: ModuleInfo, aliases: Aliases
                          ) -> Tuple[List[_FnNode], List[ast.Lambda]]:
    """The module's functions reachable from a traced root, and the traced
    lambdas."""
    by_name: Dict[str, List[_FnNode]] = {}
    fns: List[_FnNode] = []

    def visit(node: ast.AST, prefix: str, autograd_fn: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                fn = _FnNode(child, f"{prefix}{child.name}")
                fn.root = autograd_fn and child.name in AUTOGRAD_METHODS
                fns.append(fn)
                by_name.setdefault(child.name, []).append(fn)
                visit(child, f"{prefix}{child.name}.", False)
            elif isinstance(child, ast.ClassDef):
                is_fn = any(aliases.resolve(b) in AUTOGRAD_FUNCTION
                            for b in child.bases)
                visit(child, f"{prefix}{child.name}.", is_fn)
            else:
                visit(child, prefix, False)

    visit(mod.tree, "", False)
    for fn in fns:
        fn.calls = _callees(fn.node)

    lambdas: List[ast.Lambda] = []
    lambda_calls: Set[str] = set()

    def mark(target: ast.expr) -> None:
        if isinstance(target, ast.Lambda):
            lambdas.append(target)
            lambda_calls.update(_callees(target.body))
            return
        name = (target.id if isinstance(target, ast.Name) else
                target.attr if isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self" else None)
        for fn in by_name.get(name, []):
            fn.root = True

    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            path = aliases.resolve(node.func)
            for i in TRACED_CALLS.get(path, ()):
                if i < len(node.args):
                    mark(node.args[i])
    for fn in fns:
        for dec in fn.node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            if aliases.resolve(target) in TRACED_CALLS:
                fn.root = True

    # closure: roots + the module functions they (or traced lambdas) call
    work = [fn for fn in fns if fn.root]
    for name in lambda_calls:
        work.extend(fn for fn in by_name.get(name, []) if not fn.root)
    reachable: List[_FnNode] = []
    seen: Set[int] = set()
    while work:
        fn = work.pop()
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        reachable.append(fn)
        for callee in fn.calls:
            work.extend(c for c in by_name.get(callee, [])
                        if id(c) not in seen)
    reachable.sort(key=lambda f: f.node.lineno)
    return reachable, lambdas


def _local_bindings(fn_node) -> Set[str]:
    """Names bound by simple assignment/for/with inside the function
    (parameters excluded — mutating a parameter container leaks out)."""
    bound: Set[str] = set()
    for sub in ast.walk(fn_node):
        if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Store):
            bound.add(sub.id)
        elif isinstance(sub, (ast.For, ast.AsyncFor)):
            for t in ast.walk(sub.target):
                if isinstance(t, ast.Name):
                    bound.add(t.id)
        elif isinstance(sub, ast.comprehension):
            for t in ast.walk(sub.target):
                if isinstance(t, ast.Name):
                    bound.add(t.id)
    return bound


def _own_body(fn_node) -> Iterator[ast.AST]:
    """Walk a function body without descending into nested defs (they are
    separate graph nodes)."""
    stack: List[ast.AST] = list(fn_node.body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            stack.append(child)


MUTATOR_METHODS = {"append", "extend", "add", "update", "pop", "clear",
                   "insert", "remove", "setdefault", "popitem",
                   "discard", "sort", "reverse"}


class _TracedPurityBase(Rule):
    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        aliases = Aliases(mod.tree)
        reachable, lambdas = _collect_traced_graph(mod, aliases)
        emitted: Set[Tuple[str, int]] = set()
        for fn in reachable:
            for f in self.check_fn(mod, aliases, fn.node, fn.qual,
                                   list(_own_body(fn.node)),
                                   _local_bindings(fn.node)):
                k = (f.code, f.line)
                if k not in emitted:
                    emitted.add(k)
                    yield f
        for lam in lambdas:
            body = list(ast.walk(lam.body))
            for f in self.check_fn(mod, aliases, lam, "<lambda>", body,
                                   set()):
                k = (f.code, f.line)
                if k not in emitted:
                    emitted.add(k)
                    yield f

    def check_fn(self, mod, aliases, fn_node, qual, body, local):
        raise NotImplementedError


@rule
class TracedPrint(_TracedPurityBase):
    code = "SIM301"
    name = "print-in-traced-code"
    doc = ("print/breakpoint inside a function a torch.func transform or "
           "an autograd Function runs: under vmap it prints once for the "
           "whole batch, and shows wrapped tensors")

    def check_fn(self, mod, aliases, fn_node, qual, body, local):
        for node in body:
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Name) \
                    and node.func.id in ("print", "breakpoint") \
                    and node.func.id not in local:
                yield Finding(
                    self.code, mod.path, node.lineno, node.col_offset,
                    f"{node.func.id}() inside traced '{qual}' — runs on "
                    f"wrapped tensors, once a transform call")


@rule
class TracedClock(_TracedPurityBase):
    code = "SIM302"
    name = "wall-clock-in-traced-code"
    doc = ("time.*/datetime.now inside traced code times the transform's "
           "dispatch, not the device work — time the call outside, or use "
           "obs.device_call")

    CLOCKS = {"time.time", "time.perf_counter", "time.monotonic",
              "time.process_time", "time.time_ns", "time.sleep",
              "datetime.datetime.now", "datetime.datetime.utcnow"}

    def check_fn(self, mod, aliases, fn_node, qual, body, local):
        for node in body:
            if isinstance(node, ast.Call):
                path = aliases.resolve(node.func)
                if path in self.CLOCKS:
                    yield Finding(
                        self.code, mod.path, node.lineno,
                        node.col_offset,
                        f"{path}() inside traced '{qual}' reads the "
                        f"host's clock mid-transform")


@rule
class TracedTracer(_TracedPurityBase):
    code = "SIM303"
    name = "telemetry-in-traced-code"
    doc = ("obs tracer spans/counters inside traced code measure the "
           "transform's dispatch, not the work — wrap the *call* instead")

    METHODS = {"span", "add", "device_call", "counter"}

    def check_fn(self, mod, aliases, fn_node, qual, body, local):
        for node in body:
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self.METHODS):
                continue
            recv = dotted(node.func.value) or ""
            parts = recv.split(".")
            if "CURRENT" in parts or parts[0] in ("obs", "tracer") \
                    or recv == "tr":
                yield Finding(
                    self.code, mod.path, node.lineno, node.col_offset,
                    f"tracer call {recv}.{node.func.attr}() inside "
                    f"traced '{qual}' — instrument the call, not the "
                    f"traced body")


@rule
class TracedMutation(_TracedPurityBase):
    code = "SIM304"
    name = "state-mutation-in-traced-code"
    doc = ("global/nonlocal or stores into enclosing/parameter containers "
           "inside traced code: a transform runs the body once for a "
           "batch, and a stored tensor escapes its transform wrapped "
           "(an autograd Function's 'ctx' is exempt)")

    EXEMPT = ("ctx",)

    def check_fn(self, mod, aliases, fn_node, qual, body, local):
        for node in body:
            if isinstance(node, (ast.Global, ast.Nonlocal)):
                kw = ("global" if isinstance(node, ast.Global)
                      else "nonlocal")
                yield Finding(
                    self.code, mod.path, node.lineno, node.col_offset,
                    f"'{kw} {', '.join(node.names)}' inside traced "
                    f"'{qual}' mutates enclosing state")
                continue
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, (ast.Subscript, ast.Attribute)):
                        root = t
                        while isinstance(root, (ast.Subscript,
                                                ast.Attribute)):
                            root = root.value
                        name = (root.id if isinstance(root, ast.Name)
                                else None)
                        if name is not None and name not in local \
                                and name not in self.EXEMPT:
                            yield Finding(
                                self.code, mod.path, t.lineno,
                                t.col_offset,
                                f"store into non-local container "
                                f"'{name}' inside traced '{qual}' "
                                f"— traced functions must be pure")
                continue
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in MUTATOR_METHODS \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id not in local \
                    and node.func.value.id not in self.EXEMPT:
                yield Finding(
                    self.code, mod.path, node.lineno, node.col_offset,
                    f".{node.func.attr}() on enclosing-scope "
                    f"'{node.func.value.id}' inside traced "
                    f"'{qual}' — traced functions must be pure")


# ----------------------------------------------------------------------
# SIM4xx — observability read-only
# ----------------------------------------------------------------------
OBS_ALLOWED_IMPORTS = ("repro_torch.obs", "repro_torch.utils",
                       "repro_torch.config", "repro_torch.analysis")


@rule
class ObsImports(Rule):
    code = "SIM401"
    name = "obs-imports-simulator"
    doc = ("src/repro_torch/obs must not import simulator packages — the "
           "telemetry layer is read-only by construction; pass objects "
           "in, do not reach out")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not mod.in_obs():
            return
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                mods = [(a.name, node) for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [(node.module or "", node)]
            else:
                continue
            for name, n in mods:
                if name.split(".")[0] in ("repro", "repro_torch") and not any(
                        name == ok or name.startswith(ok + ".")
                        for ok in OBS_ALLOWED_IMPORTS):
                    yield Finding(
                        self.code, mod.path, n.lineno, n.col_offset,
                        f"obs module imports simulator package "
                        f"'{name}' — the telemetry layer must stay "
                        f"read-only/import-free of the simulator")


MUTATING_SIM_API = {
    "on_arrival", "on_arrival_batch", "on_round_batch", "advance_to",
    "handover", "cloud_sync", "step", "step_many", "sample_fading",
    "sample_fading_batch", "make_servers", "pre_requeue",
    "bind_link_budget", "round_update", "compute_payloads",
    "compute_payloads_stacked",
}


@rule
class ObsMutates(Rule):
    code = "SIM402"
    name = "obs-calls-simulator-mutator"
    doc = ("obs code calling a state-mutating simulator API (advance_to,"
           " on_arrival, sample_fading, ...) breaks the read-only "
           "contract: tracing must never perturb a trajectory")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not mod.in_obs():
            return
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in MUTATING_SIM_API:
                yield Finding(
                    self.code, mod.path, node.lineno, node.col_offset,
                    f".{node.func.attr}() called from the observability "
                    f"layer — obs is read-only; it may look, not touch")
