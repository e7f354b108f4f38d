"""Torch-aware lint rules: the port's counterparts of the JAX package's
R001-R008 (``repro.analysis.rules``), one for one by code.

Each rule is a function registered under its code with a one-line
summary and a fix hint; ``python -m repro_torch.analysis --list-rules``
prints the registry, and the README's table of the port's rules must
quote the summaries (``tests/test_torch_reprolint.py`` checks it).

Every rule is purely syntactic (stdlib ``ast``, no torch import) and errs
on the side of silence: a rule fires only on a pattern that is very likely
the hazard it names, and a finding can be waived by an inline
``# reprolint: disable=R00x`` pragma or by a triaged entry in the port's
baseline (``lint_baseline.json`` beside this module).  What each rule
guards in the port:

* R001: a compiled callable, a CUDA graph or a kernel library built on
  every pass of a loop (``torch.compile``'s frames, nvcc's build).
* R002: a host sync a loop pass (the decode wrappers' host cost is 21-53
  µs a call already).
* R003: the port's rule of explicit ``torch.Generator``\\ s, since the
  JAX package's keys and torch's global RNG cannot agree.
* R004-R006: the traps around ``torch.func``, caches and the steps that
  update their trees in place.
* R007: a broad ``except`` hides a kernel's build or launch failure, and
  the port never falls back from a CUDA tensor to a plain version.
* R008: mutable defaults.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Callable, Iterable, Optional

# ---------------------------------------------------------------------------
# Findings and the rule registry.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint hit: where, which rule, and a human-actionable message."""

    path: str
    line: int
    col: int
    code: str
    message: str

    def key(self):
        return (self.path, self.line, self.col, self.code)

    def as_dict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Rule:
    code: str
    summary: str
    hint: str
    doc: str
    check: Callable  # (ModuleContext) -> list[Finding]


RULES: dict[str, Rule] = {}


def rule(code: str, summary: str, hint: str):
    """Register a checker under ``code``; its docstring is the long doc."""

    def deco(fn):
        RULES[code] = Rule(code=code, summary=summary, hint=hint,
                           doc=(fn.__doc__ or "").strip(), check=fn)
        return fn

    return deco


# ---------------------------------------------------------------------------
# Shared AST plumbing.
# ---------------------------------------------------------------------------

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
_DEF_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)
_LOOP_NODES = (ast.For, ast.AsyncFor, ast.While)

# Builders of compiled callables (R001, and R004's traced scopes).
COMPILE_NAMES = {"torch.compile", "torch.jit.script", "torch.jit.trace"}
# CUDA graph capture: a context manager, and a builder of graphed callables.
GRAPH_NAMES = {"torch.cuda.graph", "torch.cuda.make_graphed_callables"}
# torch.func transforms whose function argument runs under a trace.
FUNC_TRANSFORMS = {"vmap", "grad", "grad_and_value", "jacrev", "jacfwd",
                   "vjp", "jvp", "functional_call", "hessian"}
# Module values whose metadata is host-side (no sync, no traced value).
_METADATA = {"shape", "ndim", "dtype", "size", "dim", "numel", "device",
             "is_cuda", "requires_grad", "is_floating_point", "layout"}
_STATIC_CALLS = {"len", "isinstance", "type", "callable", "hasattr", "id"}


def dotted(node) -> Optional[str]:
    """"torch.cuda.synchronize" for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _target_names(target) -> list:
    """All plain/dotted names bound by an assignment target tree."""
    out = []
    for node in ast.walk(target):
        if isinstance(node, ast.Name):
            out.append(node.id)
        elif isinstance(node, ast.Attribute):
            d = dotted(node)
            if d:
                out.append(d)
    return out


def is_test_path(path: str) -> bool:
    """A pytest module: ``test_*.py``/``*_test.py`` or ``conftest.py``."""
    name = os.path.basename(path)
    return (name.startswith("test_") or name.endswith("_test.py")
            or name == "conftest.py")


class ModuleContext:
    """One parsed module + the shared lookups every rule needs."""

    def __init__(self, tree: ast.Module, path: str, source: str):
        self.tree, self.path, self.source = tree, path, source
        self.parents = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self._traced = None
        self._aliases = None

    # -- structure ----------------------------------------------------------

    def parent(self, node):
        return self.parents.get(node)

    def ancestors(self, node):
        node = self.parents.get(node)
        while node is not None:
            yield node
            node = self.parents.get(node)

    def enclosing_function(self, node):
        for a in self.ancestors(node):
            if isinstance(a, _FUNC_NODES):
                return a
        return None

    def enclosing_loop(self, node):
        """Nearest For/While ancestor *within* the node's own function —
        "lexically inside a loop"."""
        for a in self.ancestors(node):
            if isinstance(a, _LOOP_NODES):
                return a
            if isinstance(a, _FUNC_NODES):
                return None
        return None

    def scope_of(self, node):
        """The function owning ``node``, or the module for top-level code."""
        return self.enclosing_function(node) or self.tree

    def scope_nodes(self, scope):
        """All nodes whose nearest enclosing function is ``scope`` (nested
        function bodies are their own scopes and are excluded)."""
        for node in ast.walk(scope):
            if node is scope:
                continue
            if self.scope_of(node) is scope:
                yield node

    def imports_torch(self) -> bool:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                if any(a.name.split(".")[0] == "torch" for a in node.names):
                    return True
            elif isinstance(node, ast.ImportFrom):
                if (node.module or "").split(".")[0] == "torch":
                    return True
        return False

    # -- names --------------------------------------------------------------

    def aliases(self) -> dict:
        """Local name -> canonical dotted name for the imports the rules
        read: ``torch`` under another name, ``from torch.func import
        vmap``, ``from torch import compile``, and the port's kernel build
        module (``repro_torch.kernels.build``, canonical ``build``)."""
        if self._aliases is not None:
            return self._aliases
        out = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "torch" and a.asname:
                        out[a.asname] = "torch"
                    elif a.name == "repro_torch.kernels.build":
                        out[a.asname or a.name] = "build"
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                for a in node.names:
                    local = a.asname or a.name
                    if mod == "repro_torch.kernels" and a.name == "build":
                        out[local] = "build"
                    elif mod == "repro_torch.kernels.build":
                        out[local] = f"build.{a.name}"
                    elif mod in ("torch", "torch.func", "torch.cuda",
                                 "torch.jit", "torch.nn"):
                        out[local] = f"{mod}.{a.name}"
                    elif mod in ("functools",):
                        out[local] = f"{mod}.{a.name}"
        self._aliases = out
        return out

    def canonical(self, node) -> Optional[str]:
        """``dotted(node)`` with its first name resolved through
        :meth:`aliases`."""
        d = dotted(node)
        if d is None:
            return None
        head, _, rest = d.partition(".")
        full = self.aliases().get(head)
        if full is None:
            return d
        return f"{full}.{rest}" if rest else full

    def is_transform(self, d: Optional[str]) -> bool:
        """A torch.func transform (``torch.func.vmap``, ``torch.vmap``)."""
        if not d:
            return False
        head, _, tail = d.rpartition(".")
        return tail in FUNC_TRANSFORMS and head in ("torch.func", "torch",
                                                    "functorch")

    # -- traced scopes ------------------------------------------------------

    def _compiles(self, node) -> bool:
        """A decorator or call that compiles its function argument."""
        target = node.func if isinstance(node, ast.Call) else node
        d = self.canonical(target)
        return d in COMPILE_NAMES or d == "torch.cuda.make_graphed_callables"

    def traced_scopes(self) -> set:
        """Function nodes that run under a trace: defs decorated with
        ``torch.compile``/``torch.jit.script``, and functions given by
        name (or as a lambda) to a torch.func transform, to a compiler or
        to ``make_graphed_callables``, or called by name inside a
        ``with torch.cuda.graph(...)`` capture."""
        if self._traced is not None:
            return self._traced
        traced, names = set(), set()
        for node in ast.walk(self.tree):
            if isinstance(node, _DEF_NODES) and any(
                    self._compiles(dec) for dec in node.decorator_list):
                traced.add(node)
            if isinstance(node, ast.Call) and (
                    self._compiles(node)
                    or self.is_transform(self.canonical(node.func))):
                for a in node.args[:1]:
                    if isinstance(a, ast.Name):
                        names.add(a.id)
                    elif isinstance(a, ast.Lambda):
                        traced.add(a)
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    isinstance(i.context_expr, ast.Call)
                    and self.canonical(i.context_expr.func)
                    == "torch.cuda.graph" for i in node.items):
                for sub in node.body:
                    for c in ast.walk(sub):
                        if isinstance(c, ast.Call) and \
                                isinstance(c.func, ast.Name):
                            names.add(c.func.id)
        for node in ast.walk(self.tree):
            if isinstance(node, _DEF_NODES) and node.name in names:
                traced.add(node)
        self._traced = traced
        return traced

    def nearest_traced_function(self, node):
        traced = self.traced_scopes()
        for a in self.ancestors(node):
            if isinstance(a, _FUNC_NODES) and a in traced:
                return a
        return None

    # -- lightweight dataflow ----------------------------------------------

    def tensor_call(self, call) -> bool:
        """A call that returns a tensor: ``torch.<fn>(...)`` (``torch.cuda``,
        ``torch.distributed`` and ``torch.backends`` excepted: they return
        host values) or ``F.<fn>(...)``."""
        d = self.canonical(call.func) if isinstance(call, ast.Call) else None
        if not d:
            return False
        parts = d.split(".")
        if parts[0] == "torch":
            return len(parts) > 1 and parts[1] not in (
                "cuda", "distributed", "backends", "Generator", "device",
                "Size", "get_num_threads", "is_grad_enabled", "dtype",
                "finfo", "iinfo", "version", "utils", "profiler")
        return parts[0] == "F" and len(parts) == 2

    def device_names(self, scope) -> set:
        """Names assigned in ``scope`` from torch calls — tensors."""
        out = set()
        for node in self.scope_nodes(scope):
            if isinstance(node, ast.Assign) and self.tensor_call(node.value):
                for t in node.targets:
                    out.update(n for n in _target_names(t) if "." not in n)
        return out


def _names_in(expr) -> set:
    return {n.id for n in ast.walk(expr)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def _static_use(ctx: ModuleContext, expr, names: set) -> bool:
    """True if every use of ``names`` inside ``expr`` reads host-side
    metadata (``.shape``, ``.dtype``, ``.device``, ``len(...)``,
    ``isinstance(...)``, ``x is None``) — not a tensor's value."""
    for node in ast.walk(expr):
        if not (isinstance(node, ast.Name) and node.id in names
                and isinstance(node.ctx, ast.Load)):
            continue
        parent = ctx.parent(node)
        if isinstance(parent, ast.Attribute) and parent.attr in _METADATA:
            continue
        if isinstance(parent, ast.Call) and node in parent.args and \
                isinstance(parent.func, ast.Name) and \
                parent.func.id in _STATIC_CALLS:
            continue
        if isinstance(parent, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in parent.ops):
            continue
        return False
    return True


def _assignments(ctx: ModuleContext, scope):
    """(lineno, name, node) for every name bound in ``scope``."""
    out = []
    for node in ctx.scope_nodes(scope):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign, ast.NamedExpr)):
            targets = [node.target]
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            targets = [node.target]
        for t in targets:
            for name in _target_names(t):
                out.append((node.lineno, name, node))
    return out


# ---------------------------------------------------------------------------
# R001 — a compiled callable, graph or kernel library built on a hot path.
# ---------------------------------------------------------------------------

_BUILD_NAMES = {"build.build", "build.load"}


@rule("R001",
      summary="torch.compile / torch.jit / CUDA graph capture / kernel "
              "build constructed inside a loop or immediately invoked — "
              "every pass compiles again",
      hint="build once outside the loop (a compiled callable, a captured "
           "graph, the kernel library) and call it many times; keep it on "
           "the object that owns the hot path")
def check_r001(ctx: ModuleContext) -> list:
    """``torch.compile(f)``, ``torch.jit.script``/``trace`` and
    ``make_graphed_callables`` each return a fresh callable with its own
    compiled state; a ``with torch.cuda.graph(g):`` block captures a graph
    each time it runs; ``build.build``/``build.load`` of the port's kernel
    library start ``nvcc`` (or check its output) each call.  Built inside a
    loop, each pass pays the compile again; ``torch.compile(f)(x)`` or
    ``torch.jit.script(f)(x)`` invoked on the spot throws the compiled
    callable away after one call, so every call site compiles."""
    out = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        d = ctx.canonical(node.func)
        if d not in COMPILE_NAMES and d not in GRAPH_NAMES and \
                d not in _BUILD_NAMES:
            continue
        what = d
        loop = ctx.enclosing_loop(node)
        parent = ctx.parent(node)
        if loop is not None:
            out.append(Finding(
                ctx.path, node.lineno, node.col_offset, "R001",
                f"{what} inside a loop (line {loop.lineno}): each pass "
                f"compiles, captures or builds again; hoist it out of the "
                f"loop"))
        elif d in COMPILE_NAMES and isinstance(parent, ast.Call) and \
                parent.func is node:
            out.append(Finding(
                ctx.path, node.lineno, node.col_offset, "R001",
                f"{what}(...) immediately invoked: the compiled callable is "
                f"discarded after one call, so every call site compiles "
                f"again; bind it once and reuse it"))
    return out


# ---------------------------------------------------------------------------
# R002 — host-device sync on a hot path.
# ---------------------------------------------------------------------------

_SYNC_BUILTINS = {"float", "int", "bool", "complex"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}


def _sync_call(ctx: ModuleContext, node):
    """(label, value-expr) when ``node`` forces a device->host transfer;
    ``torch.cuda.synchronize()`` has no value (None)."""
    if not isinstance(node, ast.Call):
        return None
    d = ctx.canonical(node.func)
    if d in _SYNC_BUILTINS and len(node.args) == 1 and not node.keywords:
        return d, node.args[0]
    if d == "torch.cuda.synchronize":
        return d, None
    if isinstance(node.func, ast.Attribute) and \
            node.func.attr in _SYNC_METHODS and not node.args:
        return f".{node.func.attr}()", node.func.value
    return None


@rule("R002",
      summary="host-device sync (float/int/bool/.item/.tolist/.cpu/.numpy/"
              "torch.cuda.synchronize) on a tensor inside a loop or a traced "
              "function",
      hint="keep the value on the device; gather what the host needs into "
           "one tensor and pull it once a tick or a round, outside the loop")
def check_r002(ctx: ModuleContext) -> list:
    """``float()``, ``int()``, ``bool()``, ``.item()``, ``.tolist()``,
    ``.cpu()`` and ``.numpy()`` of a CUDA tensor wait for the device and
    copy to the host, and ``torch.cuda.synchronize()`` waits for all of it.
    Inside a Python loop they serialize the host and the card once a pass
    (the legacy serve loop's host read a slot a tick is the example the
    port keeps on purpose); inside a function under ``torch.func``,
    ``torch.compile`` or a graph capture they fail or break the graph.
    Fires (a) on any sync of a non-metadata value inside a traced
    function, and (b) inside a ``for``/``while`` loop on
    ``torch.cuda.synchronize()`` or when the synced value is a torch
    expression or a name assigned from one in the same function."""
    if not ctx.imports_torch():
        return []
    out = []
    device_cache = {}
    for node in ast.walk(ctx.tree):
        sync = _sync_call(ctx, node)
        if sync is None:
            continue
        label, value = sync
        if isinstance(value, ast.Constant):
            continue
        if ctx.nearest_traced_function(node) is not None:
            if value is None or not _static_use(ctx, value, _names_in(value)):
                out.append(Finding(
                    ctx.path, node.lineno, node.col_offset, "R002",
                    f"{label} inside a function run under torch.func, "
                    f"torch.compile or a graph capture: a host sync there "
                    f"fails or breaks the graph; keep it on the device"))
            continue
        loop = ctx.enclosing_loop(node)
        if loop is None:
            continue
        if value is None:
            hit = True
        else:
            scope = ctx.scope_of(node)
            if scope not in device_cache:
                device_cache[scope] = ctx.device_names(scope)
            names = device_cache[scope]
            torch_expr = any(ctx.tensor_call(n) for n in ast.walk(value))
            hit = torch_expr or (bool(_names_in(value) & names)
                                 and not _static_use(ctx, value, names))
        if hit:
            what = label if value is None else f"{label} on a tensor"
            out.append(Finding(
                ctx.path, node.lineno, node.col_offset, "R002",
                f"{what} inside a loop (line {loop.lineno}): one host sync "
                f"a pass; keep it on the device and pull once after the "
                f"loop"))
    return out


# ---------------------------------------------------------------------------
# R003 — a draw from torch's global RNG.
# ---------------------------------------------------------------------------

_RNG_FUNCS = {"rand", "rand_like", "randn", "randn_like", "randint",
              "randint_like", "randperm", "normal", "bernoulli",
              "multinomial", "poisson"}
_RNG_METHODS = {"uniform_", "normal_", "bernoulli_", "random_",
                "exponential_", "cauchy_", "log_normal_", "geometric_"}
_INIT_FUNCS = {"uniform_", "normal_", "trunc_normal_", "xavier_uniform_",
               "xavier_normal_", "kaiming_uniform_", "kaiming_normal_",
               "orthogonal_", "sparse_"}
_SEEDS = {"torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
          "torch.cuda.manual_seed_all", "torch.random.manual_seed"}


def _has_generator(call) -> bool:
    """``generator=`` given, or ``**kwargs`` that may carry it."""
    return any(kw.arg in ("generator", None) for kw in call.keywords)


@rule("R003",
      summary="draw from torch's global RNG (torch.rand*/randn*/randint/"
              "randperm/normal/bernoulli/multinomial, in-place uniform_/"
              "normal_) without generator=, or torch.manual_seed outside "
              "tests",
      hint="pass an explicit torch.Generator (generator=gen, seeded from "
           "the run's seed) to every draw; seed that generator, not the "
           "process")
def check_r003(ctx: ModuleContext) -> list:
    """The port draws every random number from an explicit
    ``torch.Generator`` seeded from the run's seed: the JAX package's keys
    and torch's global RNG cannot agree, so a test or a comparison can only
    reproduce a draw whose generator it can name, and a draw from the
    global stream changes every later one in the process (one test then
    moves the next).  Fires on ``torch.rand``/``randn``/``randint``/
    ``randperm`` (and their ``_like`` forms, which take no generator),
    ``torch.normal``/``bernoulli``/``multinomial``/``poisson``, the in-place
    ``.uniform_()``/``.normal_()``/... and ``nn.init``'s random fills
    without ``generator=``; and on ``torch.manual_seed`` (or its CUDA
    forms) outside test modules."""
    if not ctx.imports_torch():
        return []
    out = []
    test = is_test_path(ctx.path)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        d = ctx.canonical(node.func) or ""
        head, _, tail = d.rpartition(".")
        draw = None
        if head in ("torch", "torch.random") and tail in _RNG_FUNCS:
            draw = d
        elif head.endswith("init") and tail in _INIT_FUNCS and \
                head.split(".")[0] in ("torch", "nn", "init"):
            draw = d
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr in _RNG_METHODS and head not in ("np.random",
                                                                "random"):
            draw = f".{node.func.attr}()"
        if draw is not None and not _has_generator(node):
            out.append(Finding(
                ctx.path, node.lineno, node.col_offset, "R003",
                f"{draw} draws from torch's global RNG: pass "
                f"generator= (a torch.Generator seeded from the run's seed)"))
        elif d in _SEEDS and not test:
            out.append(Finding(
                ctx.path, node.lineno, node.col_offset, "R003",
                f"{d} seeds the process-wide RNG outside a test: every "
                f"later global draw in the process depends on it; seed a "
                f"torch.Generator instead"))
    return out


# ---------------------------------------------------------------------------
# R004 — Python control flow on a tensor's value under a trace.
# ---------------------------------------------------------------------------


@rule("R004",
      summary="Python if/while branches on a tensor's value inside a "
              "function given to torch.func, torch.compile or a graph "
              "capture — a trace error, a graph break or a frozen branch",
      hint="use torch.where / masks for data-dependent branches; branch "
           "only on shapes, dtypes and Python arguments")
def check_r004(ctx: ModuleContext) -> list:
    """Under ``torch.func.vmap``/``grad`` a Python ``if`` on a tensor's
    value raises (a batched tensor has no single truth value); under
    ``torch.compile`` it breaks the graph or guards on the value; a
    captured CUDA graph replays the branch it took at capture, whatever
    the value later.  Fires on if/while tests that reference a parameter
    of such a function (or a name assigned there from a torch call),
    except tests that read only metadata (``.shape``, ``.dtype``,
    ``.device``, ``len``, ``isinstance``, ``is None``)."""
    out = []
    for fn in ctx.traced_scopes():
        if isinstance(fn, ast.Lambda):
            continue
        params = {a.arg for a in fn.args.posonlyargs + fn.args.args
                  + fn.args.kwonlyargs}
        tracked = params | ctx.device_names(fn)
        for node in ctx.scope_nodes(fn):
            if not isinstance(node, (ast.If, ast.While)):
                continue
            used = _names_in(node.test) & tracked
            if not used or _static_use(ctx, node.test, used):
                continue
            kind = "if" if isinstance(node, ast.If) else "while"
            out.append(Finding(
                ctx.path, node.lineno, node.col_offset, "R004",
                f"Python {kind!r} on tensor value(s) {sorted(used)} inside "
                f"traced {fn.name!r}: use torch.where or a mask"))
    return out


# ---------------------------------------------------------------------------
# R005 — a cache keyed on tensors.
# ---------------------------------------------------------------------------

_CACHES = {"functools.cache", "functools.lru_cache"}


def _annotation_is_tensor(ann) -> bool:
    return ann is not None and "Tensor" in ast.unparse(ann)


@rule("R005",
      summary="functools.cache / lru_cache on a function with a tensor "
              "parameter — one entry per tensor object, and every cached "
              "tensor stays alive",
      hint="cache on hashable configuration (shapes, dtypes, names) and "
           "pass tensors as plain arguments of the cached result")
def check_r005(ctx: ModuleContext) -> list:
    """A tensor hashes by identity: a cache keyed on one misses for every
    new tensor of equal value, so it grows by one entry (and keeps one
    tensor, often on the card, alive) each call.  Fires on a
    ``functools.cache``/``lru_cache`` decorator on a function with a
    parameter annotated as a ``Tensor``."""
    out = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, _DEF_NODES):
            continue
        cached = any(
            ctx.canonical(dec.func if isinstance(dec, ast.Call) else dec)
            in _CACHES for dec in node.decorator_list)
        if not cached:
            continue
        args = node.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            if _annotation_is_tensor(a.annotation):
                out.append(Finding(
                    ctx.path, node.lineno, node.col_offset, "R005",
                    f"{node.name!r} is cached on tensor parameter "
                    f"{a.arg!r}: one entry (and one live tensor) per "
                    f"tensor object"))
    return out


# ---------------------------------------------------------------------------
# R006 — a tree read after a step updated it in place.
# ---------------------------------------------------------------------------

# Callables that take over (update in place, or drop) the trees at these
# positional indices: optim.update_in_place(opt, grads, state, params, step)
# and the steps built by launch/steps.py.
_IN_PLACE = {"update_in_place": (1, 2, 3)}
_STEP_FACTORIES = {"make_phase2_step": (0, 3), "make_pretrain_step": (0, 1)}


@rule("R006",
      summary="tree passed to a step that updates it in place "
              "(optim.update_in_place, the launch/steps.py steps) is read "
              "again without rebinding — it holds the updated values",
      hint="rebind the result over the name (params, state, m = "
           "step(params, state, ...)) or pass a copy of a tree you still "
           "need")
def check_r006(ctx: ModuleContext) -> list:
    """The port's steps write the new parameters and optimizer slots over
    the dicts they are given, leaf by leaf (the JAX package's donated
    buffers; one AdamW state at the peak instead of two), and
    ``update_in_place`` drops each gradient once used.  A name passed at
    such a position and read again after the call, without being rebound,
    sees the updated trees (or the emptied gradients), not the ones it
    named.  Fires on such a read later in the same scope."""
    taken = {}   # callable name -> taken positional indices
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            d = ctx.canonical(node.value.func) or ""
            idxs = _STEP_FACTORIES.get(d.rpartition(".")[2])
            if idxs:
                for t in node.targets:
                    for name in _target_names(t):
                        taken[name] = idxs
    out = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        d = ctx.canonical(node.func) or ""
        tail = d.rpartition(".")[2]
        if isinstance(node.func, ast.Name) and node.func.id in taken:
            idxs, fname = taken[node.func.id], node.func.id
        elif tail in _IN_PLACE:
            idxs, fname = _IN_PLACE[tail], tail
        else:
            continue
        scope = ctx.scope_of(node)
        stores = _assignments(ctx, scope)
        loads = [(n.lineno, n) for n in ctx.scope_nodes(scope)
                 if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)]
        for i in idxs:
            if i >= len(node.args) or not isinstance(node.args[i], ast.Name):
                continue
            arg = node.args[i].id
            for l_line, load in loads:
                if load.id != arg or l_line <= node.lineno:
                    continue
                rebound = any(s_name == arg and node.lineno <= s_line <= l_line
                              for s_line, s_name, _ in stores)
                if not rebound:
                    out.append(Finding(
                        ctx.path, l_line, load.col_offset, "R006",
                        f"{arg!r} was given to {fname!r} (line "
                        f"{node.lineno}, position {i}), which updates it in "
                        f"place, and is read again here without rebinding"))
                    break
    return out


# ---------------------------------------------------------------------------
# R007 — broad exception handlers in a torch module.
# ---------------------------------------------------------------------------

_BROAD = {"Exception", "BaseException"}


@rule("R007",
      summary="bare or broad 'except Exception' in a torch module — hides "
              "kernel build and launch failures behind a fallback",
      hint="catch the narrow expected types (ImportError for an optional "
           "module, ValueError/TypeError for refused input); let a kernel's "
           "build or launch error raise")
def check_r007(ctx: ModuleContext) -> list:
    """The port never falls back from a CUDA tensor to a plain version: a
    kernel that fails to build (nvcc's error) or to launch (a CUDA error)
    must raise.  A broad handler turns that into a silent fallback or a
    wrong number downstream.  Fires on ``except:`` / ``except Exception``
    / ``except BaseException`` in any module that imports torch."""
    if not ctx.imports_torch():
        return []
    out = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        broad = None
        if node.type is None:
            broad = "bare except"
        else:
            types = node.type.elts if isinstance(node.type, ast.Tuple) \
                else [node.type]
            for t in types:
                if dotted(t) in _BROAD:
                    broad = f"except {dotted(t)}"
                    break
        if broad:
            out.append(Finding(
                ctx.path, node.lineno, node.col_offset, "R007",
                f"{broad} in a torch module hides kernel build/launch "
                f"errors; catch the narrow expected exception types"))
    return out


# ---------------------------------------------------------------------------
# R008 — mutable defaults in dataclass fields / signatures.
# ---------------------------------------------------------------------------

_ARRAY_FACTORIES = {"array", "asarray", "tensor", "as_tensor", "zeros",
                    "ones", "empty", "full", "arange", "eye", "linspace"}


def _mutable_default(node) -> Optional[str]:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return "mutable literal"
    if isinstance(node, ast.Call):
        d = dotted(node.func)
        if d and d.split(".")[0] in ("np", "numpy", "torch") and \
                d.split(".")[-1] in _ARRAY_FACTORIES:
            return f"shared tensor ({d})"
        if d in ("list", "dict", "set"):
            return f"mutable {d}()"
    return None


def _is_dataclass(node: ast.ClassDef) -> bool:
    for dec in node.decorator_list:
        d = dotted(dec) or (dotted(dec.func) if isinstance(dec, ast.Call)
                            else None)
        if d in ("dataclass", "dataclasses.dataclass"):
            return True
    return False


@rule("R008",
      summary="mutable default argument in a dataclass field or function "
              "signature — one shared instance across all calls",
      hint="use dataclasses.field(default_factory=...) for fields and "
           "None-with-init for function defaults")
def check_r008(ctx: ModuleContext) -> list:
    """Default values evaluate once: a list, dict or tensor default on a
    dataclass field or a function parameter is one object shared (and
    mutated) by every instance and call — for a config or a state tree it
    aliases state across models."""
    out = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ClassDef) and _is_dataclass(node):
            for stmt in node.body:
                value = None
                name = "?"
                if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                    value, name = stmt.value, _target_names(stmt.target)[0]
                elif isinstance(stmt, ast.Assign):
                    value = stmt.value
                    names = _target_names(stmt.targets[0])
                    name = names[0] if names else "?"
                if value is None:
                    continue
                why = _mutable_default(value)
                if why:
                    out.append(Finding(
                        ctx.path, stmt.lineno, stmt.col_offset, "R008",
                        f"dataclass field {name!r} has a {why} default "
                        f"shared by every instance; use "
                        f"dataclasses.field(default_factory=...)"))
        if isinstance(node, _DEF_NODES):
            args = node.args
            pos = args.posonlyargs + args.args
            defaults = list(zip(pos[len(pos) - len(args.defaults):],
                                args.defaults))
            defaults += [(a, d) for a, d in zip(args.kwonlyargs,
                                                 args.kw_defaults)
                         if d is not None]
            for a, dflt in defaults:
                why = _mutable_default(dflt)
                if why:
                    out.append(Finding(
                        ctx.path, dflt.lineno, dflt.col_offset, "R008",
                        f"parameter {a.arg!r} of {node.name!r} has a {why} "
                        f"default shared across calls; default to None and "
                        f"build inside the function"))
    return out


def iter_rules() -> Iterable[Rule]:
    """Rules in code order — the single source of truth for docs/CLI."""
    return [RULES[c] for c in sorted(RULES)]
