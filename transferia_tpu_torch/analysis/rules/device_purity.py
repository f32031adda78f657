"""TPU001 — host syncs in the port's kernel-launch code.

The port's counterpart of the reference's device-purity rule (which
looks inside jit/pallas-traced functions).  In the port a device program
is a hand-written kernel of one of the `ops/_build.py` libraries,
launched from a Python wrapper; a `.item()`, `.tolist()`, `.cpu()`,
`.numpy()`, `torch.cuda.synchronize()` or a Python branch on a tensor's
value inside that wrapper stalls the host on the stream the wrapper just
enqueued to, once a launch: the silent throughput killer the tracer can
only observe after the fact.  This rule finds them at parse time.

Launch code recognized (in `ops/`, `parallel/`, `transform/plugins/`
and `predicate/`, where K-C's wrapper `predicate/device.py` lives):
every function whose body loads a kernel library
(`_build.library(...)`) or calls a kernel entry point (an attribute
call whose name starts with `trt_`).

A tensor, for the branch check, is a parameter annotated `torch.Tensor`
(or `Optional[torch.Tensor]`), or a local assigned from a `torch.*`
factory call or from a method call on another tensor.  Tests on a
tensor's metadata are concrete without a sync and are not flagged:
`x is None`, `isinstance(...)`, `len(...)`, `.shape`, `.dtype`,
`.device`, `.is_cuda`, `.numel()`, `.dim()`, `.size(...)`,
`.data_ptr()`, `.is_contiguous()`.
"""

from __future__ import annotations

import ast
from typing import Sequence

from transferia_tpu_torch.analysis.engine import Finding, Rule, dotted_name

_HOST_SYNC_METHODS = {
    "item": ".item() copies the value to the host",
    "tolist": ".tolist() copies the tensor to the host",
    "cpu": ".cpu() copies the tensor to the host",
    "numpy": ".numpy() needs the tensor on the host",
}
# attribute tests / calls that read a tensor's metadata, never its value
_META_ATTRS = {"shape", "dtype", "device", "is_cuda", "ndim", "layout",
               "requires_grad", "type"}
_META_METHODS = {"numel", "dim", "size", "data_ptr", "is_contiguous",
                 "element_size", "stride", "nelement", "storage_offset",
                 "get_device"}
_TRACE_TIME_CALLS = {"isinstance", "len", "callable", "hasattr", "getattr"}
# torch.* calls that do not make a tensor
_NOT_TENSOR_FACTORIES = {"device", "Size", "dtype", "iinfo", "finfo",
                         "get_default_dtype", "is_tensor"}

_dotted = dotted_name


def _is_launch_call(node: ast.Call) -> bool:
    fn = node.func
    if isinstance(fn, ast.Attribute):
        if fn.attr.startswith("trt_"):
            return True
        if fn.attr == "library" and (_dotted(fn.value) or "").endswith(
                "_build"):
            return True
    return False


def _launches(fn: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and _is_launch_call(n)
               for n in ast.walk(fn))


def _is_tensor_annotation(ann) -> bool:
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return "Tensor" in ann.value
    return any((_dotted(n) or "").endswith("Tensor")
               for n in ast.walk(ann)
               if isinstance(n, (ast.Name, ast.Attribute)))


def _makes_tensor(value: ast.AST, tensors: set[str]) -> bool:
    if not isinstance(value, ast.Call):
        return False
    d = _dotted(value.func) or ""
    if d.startswith("torch.") and not d.startswith("torch.cuda.") and \
            d.split(".")[-1] not in _NOT_TENSOR_FACTORIES:
        return True
    fn = value.func
    if isinstance(fn, ast.Attribute) and \
            fn.attr not in _META_METHODS and \
            fn.attr not in _HOST_SYNC_METHODS:
        root = fn.value
        while isinstance(root, (ast.Attribute, ast.Call, ast.Subscript)):
            root = root.func if isinstance(root, ast.Call) else root.value
        return isinstance(root, ast.Name) and root.id in tensors
    return False


def _tensor_names(fn: ast.AST) -> set[str]:
    out: set[str] = set()
    args = getattr(fn, "args", None)
    if args is not None:
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            if _is_tensor_annotation(a.annotation):
                out.add(a.arg)
    # two passes: a local derived from a local tensor assigned earlier
    for _ in range(2):
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and \
                    _makes_tensor(node.value, out):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name) and (
                        _is_tensor_annotation(node.annotation) or (
                            node.value is not None
                            and _makes_tensor(node.value, out))):
                out.add(node.target.id)
    return out


def _reads_value(node: ast.AST, tensors: set[str]) -> bool:
    """Whether `node` reads the value of one of `tensors` (metadata
    reads and identity tests do not count)."""
    if isinstance(node, ast.Name):
        return node.id in tensors
    if isinstance(node, ast.Attribute):
        if node.attr in _META_ATTRS:
            return False
        return _reads_value(node.value, tensors)
    if isinstance(node, ast.Call):
        fn = node.func
        d = _dotted(fn) or ""
        if d in _TRACE_TIME_CALLS:
            return False
        if isinstance(fn, ast.Attribute) and fn.attr in _META_METHODS:
            return False
        return any(_reads_value(c, tensors)
                   for c in [fn] + list(node.args)
                   + [k.value for k in node.keywords])
    if isinstance(node, ast.Compare):
        if any(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return False
        return any(_reads_value(c, tensors)
                   for c in [node.left] + list(node.comparators))
    if isinstance(node, ast.Subscript):
        if isinstance(node.value, ast.Attribute) and \
                node.value.attr in _META_ATTRS:
            return False
        return _reads_value(node.value, tensors)
    return any(_reads_value(c, tensors)
               for c in ast.iter_child_nodes(node))


class DevicePurityRule(Rule):
    id = "TPU001"
    severity = "error"
    description = ("host sync (.item/.tolist/.cpu/.numpy, "
                   "torch.cuda.synchronize, a branch on a tensor's "
                   "value) inside kernel-launch code")
    # where the launch wrappers live; host-side modules read results
    # back legitimately once the launch is done
    paths = ("ops/", "parallel/", "transform/plugins/", "predicate/")

    def check_file(self, relpath: str, tree: ast.AST,
                   lines: Sequence[str]) -> list[Finding]:
        findings: list[Finding] = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and _launches(node):
                self._check_launcher(relpath, node, lines, findings)
        return findings

    def _check_launcher(self, relpath: str, fn: ast.AST,
                        lines: Sequence[str],
                        findings: list[Finding]) -> None:
        tensors = _tensor_names(fn)
        for stmt in fn.body:
            for node in ast.walk(stmt):
                self._check_node(relpath, node, tensors, lines, findings)

    def _check_node(self, relpath: str, node: ast.AST,
                    tensors: set[str], lines: Sequence[str],
                    findings: list[Finding]) -> None:
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) \
                    and fn.attr in _HOST_SYNC_METHODS and not node.args:
                findings.append(self.finding(
                    relpath, node,
                    f"{_HOST_SYNC_METHODS[fn.attr]}: a device->host sync "
                    f"inside kernel-launch code", lines))
                return
            if (_dotted(fn) or "").endswith("cuda.synchronize"):
                findings.append(self.finding(
                    relpath, node,
                    "torch.cuda.synchronize() waits for the whole device "
                    "inside kernel-launch code", lines))
                return
        if isinstance(node, (ast.If, ast.IfExp, ast.While)) and \
                _reads_value(node.test, tensors):
            kind = "while" if isinstance(node, ast.While) else "if"
            findings.append(self.finding(
                relpath, node,
                f"Python `{kind}` on a tensor's value syncs the host to "
                f"the device inside kernel-launch code; decide from "
                f"host-side values or metadata", lines))

    def applies_to(self, relpath: str) -> bool:
        # linkprobe deliberately measures host<->device syncs
        if relpath.endswith("ops/linkprobe.py"):
            return False
        return super().applies_to(relpath)
