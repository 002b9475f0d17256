"""Op-level cost of one run of a PyTorch program (the port's counterpart of
``repro.runtime.hlo_analysis``).

The reference reads FLOPs, HBM bytes and collective bytes off the
compiled HLO text of a jitted step, multiplying loop bodies by their
trip counts.  Eager PyTorch has no HLO to parse: the program is the
sequence of aten ops it dispatches.  So ``count(fn, *args)`` runs ``fn``
once under a ``TorchDispatchMode`` and adds up, op by op:

- **dot FLOPs** from ``torch.utils.flop_counter``'s formulas (mm, bmm,
  addmm, baddbmm, the bmm an einsum becomes, convolutions, the fused
  attention ops);
- **elementwise FLOPs**, one an output element of an arithmetic op
  (``_ELEMENTWISE``: the reference's list in aten's names), and
  **reductions**, one an input element (sums, means, maxima, norms, the
  softmaxes), which enter ``flops`` but neither of the two parts, as in
  ``analyze``.  Comparisons, copies, casts and FFTs count no FLOPs there
  either;
- **HBM bytes**: each op's tensor inputs plus its outputs.  Eager runs no
  fusions, so each op's reads and writes are its memory traffic.  Views,
  metadata ops and allocations (``empty``) count zero;
- **collective bytes** per device from the port's collectives
  (``runtime.collectives``), each logical collective once with the
  reference's ring factors (``_RING``), whatever the backend does to carry
  it out: on any backend but NCCL a reduce-scatter runs as an all-reduce
  and a cut, and counting the c10d ops would read it as 2(g-1)/g of its
  input where NCCL sends (g-1) of its output.  The aten ops inside a
  collective are not counted; its input and output bytes are its HBM
  traffic.  A c10d op outside the port's collectives raises;
- **peak live bytes**: the storages on the device that the run's ops read
  or write, from the arguments onward, each counted from its first use to
  its release (a weak reference's finalizer).  The arguments' bytes are
  ``argument_bytes``, the outputs' ``output_bytes``, and outputs sharing
  storage with an argument (a donated state updated in place)
  ``alias_bytes``.

Loops need no trip counting: the eager run runs every step of them.  A
run on fake tensors (``torch._subclasses.fake_tensor.FakeTensorMode``,
the dry-run's) counts the same ops as on real ones and allocates nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.runtime import collectives

# arithmetic ops: one FLOP an output element (the reference's _ELEMENTWISE
# in aten's names; an in-place twin counts as its op)
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "exp", "exp2",
    "log", "log1p", "expm1", "tanh", "rsqrt", "sqrt", "pow", "neg", "abs",
    "floor", "ceil", "cos", "sin", "sigmoid", "remainder", "fmod", "atan2",
    "erf", "sign", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "logical_and", "logical_or", "logical_xor",
    "logical_not", "clamp", "clamp_min", "clamp_max", "where", "relu",
    "silu", "gelu", "reciprocal", "square", "lerp", "addcmul", "addcdiv",
    "threshold_backward", "silu_backward", "gelu_backward",
    "sigmoid_backward", "tanh_backward", "masked_fill", "polar", "angle",
    "softplus", "softplus_backward",
}
# reductions: one FLOP an input element
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "norm",
    "linalg_vector_norm", "var", "std", "var_mean", "logsumexp", "argmax",
    "argmin", "cumsum", "cumprod", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data", "any", "all",
}
# no traffic: metadata, allocation, aliasing
_NO_BYTES = {
    "detach", "alias", "lift_fresh", "_unsafe_view", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "resize_", "set_",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "is_same_size", "_has_compatible_shallow_copy_type", "_to_copy_meta",
    "record_stream", "_conj", "_neg_view", "conj",
}

# bytes a device sends for a logical collective whose output is ``out``
# bytes over ``g`` ranks (``repro.runtime.hlo_analysis._COLL_FACTOR``)
_RING = {
    "all-gather": lambda out, g: out * (g - 1) / g,
    "all-reduce": lambda out, g: 2.0 * out * (g - 1) / g,
    "reduce-scatter": lambda out, g: out * (g - 1),
    "all-to-all": lambda out, g: out * (g - 1) / g,
}
# output bytes of a collective whose input is ``inp`` bytes over g ranks
_OUT = {
    "all-gather": lambda inp, g: inp * g,
    "all-reduce": lambda inp, g: inp,
    "reduce-scatter": lambda inp, g: inp / g,
    "all-to-all": lambda inp, g: inp,
}


@dataclasses.dataclass
class Cost:
    """One run's cost: ``HloCost``'s fields, then its memory."""

    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_breakdown: dict = dataclasses.field(default_factory=dict)
    dot_flops: float = 0.0
    elementwise_flops: float = 0.0
    peak_bytes: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    ops: int = 0

    def to_dict(self):
        return dataclasses.asdict(self)


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _op_tensors(*parts) -> list:
    """The tensors among an op's arguments or results (tensors, and lists
    or tuples of them: what an aten op takes and gives)."""
    out = []
    for a in parts:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _name(func) -> str:
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.startswith("_") \
        else name


class _Counter(TorchDispatchMode):
    def __init__(self, device: Optional[torch.device]):
        super().__init__()
        self.cost = Cost()
        self.device = device
        self.live = 0
        self._seen: dict = {}  # id(storage) -> its finalizer
        self._inside = 0  # depth of logical collectives under way

    # ---------------------------------------------------------- memory
    def _on_device(self, t: torch.Tensor) -> bool:
        if self.device is None:
            self.device = t.device
        return t.device == self.device

    def _track(self, t: torch.Tensor) -> None:
        if t.layout != torch.strided or not self._on_device(t):
            return
        s = t.untyped_storage()
        key = id(s)
        if key in self._seen:
            return
        n = s.nbytes()
        self.live += n
        self._seen[key] = weakref.finalize(s, self._free, key, n)

    def _free(self, key, n) -> None:
        self.live -= n
        self._seen.pop(key, None)

    def _storages(self, tensors) -> dict:
        return {id(t.untyped_storage()): t.untyped_storage().nbytes()
                for t in tensors
                if t.layout == torch.strided and self._on_device(t)}

    # ----------------------------------------------------- collectives
    @contextlib.contextmanager
    def collective(self, kind: str, t: torch.Tensor, g: int):
        """One logical collective of ``kind`` on ``t`` over ``g`` ranks:
        recorded unless another is under way (a reduce-scatter's
        all-reduce); the aten ops inside it are not counted."""
        if self._inside == 0 and g > 1:
            inp = _nbytes(t)
            out = _OUT[kind](inp, g)
            sent = _RING[kind](out, g)
            cost = self.cost
            cost.collective_bytes += sent
            cost.collective_breakdown[kind] = (
                cost.collective_breakdown.get(kind, 0.0) + sent)
            cost.bytes += inp + out
        self._inside += 1
        try:
            yield
        finally:
            self._inside -= 1

    # ------------------------------------------------------------- ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "prim":  # a fake tensor's metadata query
            return func(*args, **kwargs)
        ins = _op_tensors(*args, *kwargs.values())
        for t in ins:
            self._track(t)
        out = func(*args, **kwargs)
        outs = _op_tensors(out)
        for t in outs:
            self._track(t)
        self.cost.peak_bytes = max(self.cost.peak_bytes, self.live)
        if func.namespace == "c10d":
            if self._inside == 0:
                raise RuntimeError(
                    f"{func} ran outside the port's collectives "
                    "(runtime.collectives): its bytes would not be counted")
            return out
        if self._inside:
            return out
        self.cost.ops += 1
        self._count(func, args, kwargs, ins, out, outs)
        return out

    def _count(self, func, args, kwargs, ins, out, outs) -> None:
        cost, name = self.cost, _name(func)
        packet = func.overloadpacket
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            cost.flops += f
            cost.dot_flops += f
        elif name in _ELEMENTWISE:
            f = float(sum(t.numel() for t in outs[:1]))
            cost.flops += f
            cost.elementwise_flops += f
        elif name in _REDUCTIONS and ins:
            cost.flops += float(ins[0].numel())
        if func.is_view or name in _NO_BYTES:
            return
        cost.bytes += float(sum(_nbytes(t) for t in ins)
                            + sum(_nbytes(t) for t in outs))


def count(fn, *args, device=None, **kwargs) -> Cost:
    """The cost of one run of ``fn(*args, **kwargs)`` on ``device`` (the
    device of the first tensor the run touches when None): FLOPs, HBM
    bytes, collective bytes a device and the peak live bytes on it (the
    module docstring).  The result of ``fn`` is dropped: a train step
    updates its donated state in place."""
    counter = _Counter(None if device is None else torch.device(device))
    args_t = _tensors((args, kwargs))
    collectives.COUNTERS.append(counter)
    try:
        with counter:
            for t in args_t:
                counter._track(t)
            arg_st = counter._storages(args_t)
            counter.cost.argument_bytes = sum(arg_st.values())
            counter.cost.peak_bytes = counter.live
            out = fn(*args, **kwargs)
    finally:
        collectives.COUNTERS.remove(counter)
    out_st = counter._storages(_tensors(out))
    cost = counter.cost
    cost.output_bytes = sum(out_st.values())
    cost.alias_bytes = sum(n for k, n in out_st.items() if k in arg_st)
    for fin in list(counter._seen.values()):
        fin.detach()
    return cost
