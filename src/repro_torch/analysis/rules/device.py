"""Device hygiene: the port's counterpart of the reference's jit rules.

``repro.analysis.rules.jit`` checks what JAX device code must not do
(branch on tracers, call host numpy in traced bodies, jit in a loop).
The port runs no ``jax.jit`` and no ``pallas_call``; its device code is
eager PyTorch, and its hazards of the same class — device-state
discipline and hidden host round trips — take three shapes:

* A function run on a new thread that reaches the device outside a
  ``use_device(...)`` scope. ``repro_torch.device`` keeps the selected
  device in a context variable, and a new thread starts with an empty
  context, so such a thread runs on ``cuda:0`` whatever its starter
  selected.
* A function run in a forked child that touches CUDA. A child forked
  from a parent that holds a CUDA context cannot initialise CUDA again.
* A host sync (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``.synchronize()``) inside a loop of a hot-path module: the host
  waits for the card once per iteration.

Discovery is syntactic and same-module, like the reference's rules. A
target is resolved when it is a module-level function, a nested ``def``
of an enclosing function, a ``self.`` method of the enclosing class or
a lambda; the rules follow calls into functions resolved the same way,
transitively. What they cannot see: callees in other modules,
functions stored in variables or attributes (the loader's
``_PROC_DECODE``, a decoder picked by name at run time) or bound by
``functools.partial``, and threads and pools started in one module with
a target from another.
"""
from __future__ import annotations

import ast
import re
from typing import Callable, Dict, Optional, Set

from repro_torch.analysis.engine import Module
from repro_torch.analysis.rules.base import (Rule, dotted, enclosing_class,
                                             keyword_value, terminal)

_FnDef = (ast.FunctionDef, ast.AsyncFunctionDef)
_Scope = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)

#: Calls that read or use the selected device (``repro_torch.device``
#: and the decoder registry, whose sessions decode on it).
_DEVICE_CALLS = {"current_device", "selected_device", "open_decoder",
                 "get_decoder"}

#: Pool methods whose first argument runs in a worker.
_POOL_TASKS = {"map", "map_async", "imap", "imap_unordered", "starmap",
               "starmap_async", "apply", "apply_async", "submit"}

_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}

#: The port's hot-path packages, where a per-iteration host sync costs
#: the paths' throughput (the bench's timing loops sync on purpose).
_HOT_PATH = re.compile(r"(^|/)repro_torch/(jpeg|kernels|models|serve|"
                       r"service|data|train|distributed)/")

Hit = Callable[[ast.AST], Optional[str]]


def _fn_name(fn: ast.AST) -> str:
    return "<lambda>" if isinstance(fn, ast.Lambda) else fn.name


def _called(call: ast.Call) -> str:
    """The called name's last segment, also when the receiver is an
    expression (``mp.get_context("fork").Process``)."""
    func = call.func
    if isinstance(func, ast.Attribute):
        return func.attr
    return func.id if isinstance(func, ast.Name) else ""


def _is_use_device(expr: ast.AST) -> bool:
    return isinstance(expr, ast.Call) and _called(expr) == "use_device"


class _Resolver:
    """Same-module function lookup and the reach scan over bodies."""

    def __init__(self, module: Module):
        self.module = module
        # scope node (Module, function, class) -> {name: def}
        self.defs: Dict[ast.AST, Dict[str, ast.AST]] = {}
        for node in ast.walk(module.tree):
            if isinstance(node, _FnDef):
                scope = next((a for a in module.ancestors(node)
                              if isinstance(a, _Scope)), module.tree)
                self.defs.setdefault(scope, {})[node.name] = node

    def resolve(self, ref: ast.AST, site: ast.AST) -> Optional[ast.AST]:
        """The function ``ref`` names at ``site``, or None."""
        if isinstance(ref, ast.Lambda):
            return ref
        if isinstance(ref, ast.Name):
            for anc in self.module.ancestors(site):
                if isinstance(anc, _FnDef) and \
                        ref.id in self.defs.get(anc, {}):
                    return self.defs[anc][ref.id]
            return self.defs.get(self.module.tree, {}).get(ref.id)
        name = dotted(ref)
        if name and name.count(".") == 1 and name.startswith("self."):
            cls = enclosing_class(self.module, site)
            if cls is not None:
                return self.defs.get(cls, {}).get(name.split(".")[1])
        return None

    def reach(self, fn: ast.AST, hit: Hit, honour_scope: bool,
              seen: Optional[Set[ast.AST]] = None) -> Optional[str]:
        """What ``fn`` (or a same-module callee) first does that ``hit``
        names, in source order; None when nothing. ``honour_scope``
        treats the body of a ``with use_device(...)`` as covered."""
        seen = set() if seen is None else seen
        seen.add(fn)
        body = [fn.body] if isinstance(fn, ast.Lambda) else fn.body
        for stmt in body:
            found = self._scan(stmt, hit, honour_scope, seen)
            if found:
                return found
        return None

    def _scan(self, node: ast.AST, hit: Hit, honour_scope: bool,
              seen: Set[ast.AST]) -> Optional[str]:
        if isinstance(node, _Scope):
            return None                    # runs only when called
        if honour_scope and isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if _is_use_device(item.context_expr):
                    return None            # later items and body covered
                found = self._scan(item, hit, honour_scope, seen)
                if found:
                    return found
            children = node.body
        elif isinstance(node, ast.AnnAssign):
            children = [node.target] + ([node.value] if node.value else [])
        else:
            found = hit(node)
            if found:
                return found
            if isinstance(node, ast.Call):
                callee = self.resolve(node.func, node)
                if callee is not None and callee not in seen:
                    found = self.reach(callee, hit, honour_scope, seen)
                    if found:
                        return f"{found} in {_fn_name(callee)}()"
            children = list(ast.iter_child_nodes(node))
        for child in children:
            found = self._scan(child, hit, honour_scope, seen)
            if found:
                return found
        return None


def _reaches_device(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        name = dotted(node)
        if name and name.startswith("torch."):
            return name
    if isinstance(node, ast.Call):
        fname = terminal(dotted(node.func))
        if fname in _DEVICE_CALLS:
            return f"{fname}()"
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr == "decode_batch":
            return ".decode_batch()"
    return None


def _cuda_str(node: Optional[ast.AST]) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str) \
        and node.value.startswith("cuda")


def _touches_cuda(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        name = dotted(node)
        if name and (name == "torch.cuda" or name.startswith("torch.cuda.")):
            return name
    if not isinstance(node, ast.Call):
        return None
    fname = dotted(node.func)
    if isinstance(node.func, ast.Attribute) and node.func.attr == "cuda":
        return ".cuda()"
    if fname == "torch.device" and node.args and _cuda_str(node.args[0]):
        return f'torch.device("{node.args[0].value}")'
    device = keyword_value(node, "device")
    if _cuda_str(device):
        return f'device="{device.value}"'
    if terminal(fname) == "current_device":
        return "current_device()"
    return None


class TorchThreadNoDevice(Rule):
    """Flags a function run on a new thread — a ``threading.Thread``'s
    ``target=``, the first argument of ``.submit(...)`` or ``.map(...)``
    — whose body, or a same-module function or same-class method it
    calls, reaches the device outside a ``use_device(...)`` scope: a
    ``torch.*`` name (annotations aside), or a call of
    ``current_device``, ``selected_device``, ``open_decoder``,
    ``get_decoder`` or ``.decode_batch``. A ``with`` that enters
    ``use_device`` covers its body and the items after it, so
    ``with trace.span(...), use_device(dev):`` is covered. It cannot
    see a decode reached through a stored callable (``self.decode_fn``)
    or another module's function, nor ``asyncio.to_thread``, which
    copies the context and so needs no re-entry."""

    id = "torch-thread-no-device"
    summary = ("a function run on a new thread must reach the device only "
               "inside use_device(...)")
    motivation = ("a use_device scope ends at its thread: the decode "
                  "service's worker threads, started under "
                  "use_device('cpu'), decoded on cuda:0 until each thread "
                  "re-entered the device the service stored "
                  "(service/engine.py _on_device)")

    def setup(self, module: Module) -> None:
        self.fns = _Resolver(module)

    def visit_Call(self, node: ast.Call) -> None:
        target = None
        if _called(node) == "Thread":
            target = keyword_value(node, "target")
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("submit", "map") and node.args:
            target = node.args[0]
        fn = self.fns.resolve(target, node) if target is not None else None
        if fn is not None:
            what = self.fns.reach(fn, _reaches_device, honour_scope=True)
            if what:
                self.report(target,
                            f"{_fn_name(fn)}() runs on a new thread and "
                            f"reaches the device ({what}) outside "
                            f"use_device(...) — a use_device scope ends at "
                            f"its thread; read selected_device() before "
                            f"starting it and re-enter it there")
        self.generic_visit(node)


class TorchCudaInFork(Rule):
    """Flags a function that runs in a forked child and touches CUDA
    (``torch.cuda.*``, ``.cuda()``, ``torch.device("cuda...")``, a
    ``device="cuda..."`` keyword, ``current_device()``), in its body or
    a same-module callee. A forked child is entered through the
    ``initializer=`` of a pool, the function handed to a pool's
    ``map``/``imap``/``imap_unordered``/``apply_async``/``submit`` (and
    their siblings), or the ``target=`` of a ``Process``, when the pool
    or process comes from ``get_context("fork")``, or from
    ``multiprocessing``'s or ``ProcessPoolExecutor``'s default (fork on
    Linux) with no ``mp_context`` of ``spawn``/``forkserver``. A pool is
    followed through a local name, a ``self.`` attribute, and a
    same-module function or ``self.`` method returning it. A context
    the rule cannot trace (a parameter, another module's pool) is not
    judged. It cannot see
    CUDA reached through a callable picked at run time: the loader's
    ``_proc_init``/``_proc_work`` run ``get_decoder(name).fn``, and what
    keeps CUDA out of those children is the decoder registry's
    ``fork_safe`` capability, checked when the loader resolves its path
    for ``ExecContext.PROCESS_POOL``."""

    id = "torch-cuda-in-fork"
    summary = ("a function run in a forked child must not touch CUDA; use "
               "a spawn context")
    motivation = ("a child forked from a parent that holds a CUDA context "
                  "cannot initialise CUDA again; the loader's process mode "
                  "forks such a parent (data/loader.py), and only the "
                  "runtime fork_safe capability keeps its decode in numpy")

    def setup(self, module: Module) -> None:
        self.fns = _Resolver(module)
        self.mp_names = {"multiprocessing"}    # module aliases
        self.mp_members: Set[str] = set()      # from multiprocessing import
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "multiprocessing":
                        self.mp_names.add(alias.asname or alias.name)
            elif isinstance(node, ast.ImportFrom) and \
                    node.module == "multiprocessing":
                self.mp_members.update(a.asname or a.name
                                       for a in node.names)

    def visit_Call(self, node: ast.Call) -> None:
        ctor = _called(node)
        entries = []
        if ctor in ("Pool", "ProcessPoolExecutor") and self._forks(node):
            entries.append(keyword_value(node, "initializer"))
        elif ctor == "Process" and self._forks(node):
            entries.append(keyword_value(node, "target"))
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr in _POOL_TASKS and node.args and \
                self._fork_pool(node.func.value, set()):
            entries.append(node.args[0])
        for ref in entries:
            fn = self.fns.resolve(ref, node) if ref is not None else None
            what = fn and self.fns.reach(fn, _touches_cuda,
                                         honour_scope=False)
            if what:
                self.report(ref,
                            f"{_fn_name(fn)}() runs in a forked child and "
                            f"touches CUDA ({what}) — a child forked from "
                            f"a parent with a CUDA context cannot "
                            f"initialise it again; use "
                            f"get_context('spawn')")
        self.generic_visit(node)

    # ---------------------------------------------------- what forks
    def _forks(self, ctor: ast.Call) -> bool:
        """True when ``ctor`` (a Pool/Process/ProcessPoolExecutor call)
        starts its children by fork."""
        if _called(ctor) == "ProcessPoolExecutor":
            ctx = keyword_value(ctor, "mp_context")
            return ctx is None or self._method(ctx, ctor) == "fork"
        func = ctor.func
        if isinstance(func, ast.Name):
            return func.id in self.mp_members
        if not isinstance(func, ast.Attribute):
            return False
        if dotted(func.value) in self.mp_names:
            return True                        # the default context
        return self._method(func.value, ctor) == "fork"

    def _method(self, ctx: ast.AST, site: ast.AST) -> Optional[str]:
        """Start method of a context expression: a ``get_context(...)``
        call, or a name assigned one in an enclosing scope."""
        if isinstance(ctx, ast.Call) and _called(ctx) == "get_context":
            if not ctx.args:
                return "fork"
            arg = ctx.args[0]
            if isinstance(arg, ast.Constant):
                return "fork" if arg.value is None else arg.value
            return None
        if isinstance(ctx, ast.Name):
            methods = {self._method(v, v)
                       for v in self._assigned(ctx.id, site)}
            return methods.pop() if len(methods) == 1 else None
        return None

    def _assigned(self, name: str, site: ast.AST):
        """Values bound to ``name`` in the scopes around ``site``
        (assignments and ``with ... as name``)."""
        scopes = [a for a in self.module.ancestors(site)
                  if isinstance(a, _FnDef)] + [self.module.tree]
        for scope in scopes:
            for node in ast.walk(scope):
                if isinstance(node, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == name
                        for t in node.targets):
                    yield node.value
                elif isinstance(node, ast.withitem) and \
                        isinstance(node.optional_vars, ast.Name) and \
                        node.optional_vars.id == name:
                    yield node.context_expr

    def _fork_pool(self, expr: ast.AST, seen: Set[ast.AST]) -> bool:
        """True when ``expr`` evaluates to a fork pool: a constructor
        call, a name or ``self.`` attribute bound to one, or a call of a
        same-module function or ``self.`` method returning one."""
        if expr in seen:
            return False
        seen.add(expr)
        if isinstance(expr, ast.Call):
            if _called(expr) in ("Pool", "ProcessPoolExecutor"):
                return self._forks(expr)
            maker = self.fns.resolve(expr.func, expr)
            if isinstance(maker, _FnDef):
                return any(self._fork_pool(r.value, seen)
                           for r in ast.walk(maker)
                           if isinstance(r, ast.Return) and r.value)
            return False
        if isinstance(expr, ast.Name):
            return any(self._fork_pool(v, seen)
                       for v in self._assigned(expr.id, expr))
        name = dotted(expr)
        if name and name.count(".") == 1 and name.startswith("self."):
            cls = enclosing_class(self.module, expr)
            if cls is None:
                return False
            return any(self._fork_pool(n.value, seen)
                       for n in ast.walk(cls)
                       if isinstance(n, ast.Assign)
                       and any(dotted(t) == name for t in n.targets))
        return False


class TorchHostSyncInLoop(Rule):
    """Flags ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` and any
    ``.synchronize()`` (``torch.cuda.synchronize()`` included) lexically
    inside the body of a ``for``/``while`` of the same function — not
    in a ``for``'s iterable, which runs once, nor in a nested ``def`` —
    in the port's hot-path packages only (``jpeg``, ``kernels``,
    ``models``, ``serve``, ``service``, ``data``, ``train``,
    ``distributed``, by path). The rule is syntactic: it cannot tell a
    tensor from a numpy array (whose ``.tolist()`` costs no sync), and
    it does not look into comprehensions or into a helper called from a
    loop. ``bench/`` is out of scope: a sync is the point of a timing
    loop."""

    id = "torch-host-sync-in-loop"
    summary = ("no host sync (.item/.tolist/.cpu/.numpy/.synchronize) "
               "inside a hot-path loop")
    motivation = ("each such call blocks the host on the card once per "
                  "iteration; the cuda-batch path's per-image colour trip "
                  "and the host-bound training and decode steps pay one "
                  "round trip per image or per step")

    def setup(self, module: Module) -> None:
        self.hot = bool(_HOT_PATH.search(module.path))

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if self.hot and isinstance(func, ast.Attribute) and \
                func.attr in _SYNC_METHODS and self._in_loop(node):
            what = dotted(func) or f".{func.attr}"
            self.report(node,
                        f"{what}() inside a loop blocks the host on the "
                        f"card every iteration — hoist it after the loop "
                        f"or keep the values on the device")
        self.generic_visit(node)

    def _in_loop(self, node: ast.AST) -> bool:
        child = node
        for anc in self.module.ancestors(node):
            if isinstance(anc, _Scope):
                return False
            if isinstance(anc, (ast.For, ast.AsyncFor)) and \
                    child in anc.body:
                return True
            if isinstance(anc, ast.While) and \
                    (child is anc.test or child in anc.body):
                return True
            child = anc
        return False
