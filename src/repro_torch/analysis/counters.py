"""What one call of the port's program costs, counted op by op: the eager
program's counterpart of XLA's ``cost_analysis()`` and
``memory_analysis()``.

:func:`count_call` runs ``fn(*args)`` once under :class:`CountingMode`, a
``TorchDispatchMode`` that sees every aten op the call runs (autograd's
backward and ``torch.utils.checkpoint``'s recompute included, each where
it runs: a recomputed forward is counted once, in the backward), and
records:

* ``flops``: ``torch.utils.flop_counter``'s registered formulas, as
  ``FlopCounterMode`` counts them (an op with a decomposition is
  decomposed, and its parts are counted);
* ``bytes``: each op's tensor inputs read plus its tensor outputs
  written, at the sizes of the views it is given; view and metadata ops
  count 0. This is the traffic of the eager program, op by op: a fusion of
  elementwise chains, or a kernel that keeps its tiles on chip, lowers it;
* ``argument_bytes``: the distinct storages of the call's tensor
  arguments;
* ``peak_live_bytes``: the most bytes of storage live at once, the
  arguments included. A storage is live from the op that first returns it
  until its last C++ reference goes (``StorageWeakRef``): autograd keeps
  the tensors it saves for the backward through C++ tensors that share
  their storage after the Python objects are gone, so a tracker keyed on
  Python tensors would undercount every backward and every remat;
* ``output_bytes``: the storages of the result that no argument holds;
* ``coll_bytes``: the collectives of a partitioned program (the
  ``_c10d_functional`` ops that DTensor's redistributions and the global
  norm run), by the reference's kind names (``all-gather``,
  ``reduce-scatter``, ``all-reduce``, ``all-to-all``) with the
  reference's ``collective_bytes`` rule: the result's bytes, an
  all-reduce twice, a reduce-scatter times its group's size. A
  collective's traffic is counted here and not in ``bytes``; each one is
  also listed in ``collectives`` (kind, group name, group size, result
  shape, bytes) and, at the same index, in ``collective_origins`` (its
  dtype as HLO names it, ``f32``, ``bf16``, ...; and its source: the
  innermost ``repro_torch`` frame outside ``sharding/rules.py`` and this
  module, as ``module:function``, e.g. ``models.layers:_row_parallel``).

A DTensor op is left to DTensor (the mode returns ``NotImplemented``), so
the mode counts the local ops and collectives it runs on each rank's
shards: the counts of one rank's share. A DTensor argument's storage is
its local shard's. The ops DTensor runs on fake tensors to infer a global
shape (the first time it meets an op) are not counted.

The mode counts meta, CPU and CUDA tensors alike, so one program gives the
same counts on each. ``peak_block_bytes`` is the peak in the CUDA caching
allocator's terms: each storage in a block rounded up to 512 bytes
(:func:`block_bytes`). It is what ``torch.cuda.max_memory_allocated``
shows over the call when the allocator splits every block it hands out,
as it does under ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``.
Without that setting the allocator may hand out a cached block unsplit,
up to 1 MiB more than asked, which no count of storages can predict.
Neither peak sees what a kernel allocates inside one op (a library's
workspace).
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Callable, Dict, Iterable, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

__all__ = ["Counts", "CountingMode", "block_bytes", "count_call",
           "storage_bytes"]

_aten = torch.ops.aten
# ops that read metadata only (FlopCounterMode passes the same set through)
_METADATA = {
    _aten.sym_is_contiguous.default, _aten.is_contiguous.default,
    _aten.is_contiguous.memory_format, _aten.is_strides_like_format.default,
    _aten.is_non_overlapping_and_dense.default, _aten.size.default,
    _aten.sym_size.default, _aten.stride.default, _aten.sym_stride.default,
    _aten.storage_offset.default, _aten.sym_storage_offset.default,
    _aten.numel.default, _aten.sym_numel.default, _aten.dim.default,
    torch.ops.prim.layout.default, torch.ops.prim.device.default,
}


# functional collectives -> the reference's kind names; the multiplier of
# the result's bytes is the reference's (reduce-scatter: its group size)
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
}
_XFER = {"all-gather": 1, "all-reduce": 2, "all-to-all": 1}
_HLO_DTYPES = {torch.float64: "f64", torch.float32: "f32",
               torch.float16: "f16", torch.bfloat16: "bf16",
               torch.int64: "s64", torch.int32: "s32", torch.int16: "s16",
               torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred"}
# the CUDA caching allocator's granule: every block is a multiple of it
ALLOC_BLOCK = 512
# frames that carry a collective but do not say where it comes from
_NOT_SOURCES = ("repro_torch.sharding.rules", "repro_torch.analysis.counters")


def _collective_source() -> str:
    """``module:function`` of the innermost ``repro_torch`` frame on this
    thread's stack outside ``_NOT_SOURCES`` (the package prefix dropped),
    or ``"?"`` where there is none."""
    f = sys._getframe(1)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith("repro_torch.") and mod not in _NOT_SOURCES:
            return f"{mod[len('repro_torch.'):]}:{f.f_code.co_name}"
        f = f.f_back
    return "?"


@dataclasses.dataclass
class Counts:
    """One call's counts (see the module docstring)."""
    flops: int
    bytes: int
    argument_bytes: int
    output_bytes: int
    peak_live_bytes: int
    ops: int
    peak_block_bytes: int = 0
    seconds: float = 0.0
    coll_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    collectives: list = dataclasses.field(default_factory=list)
    collective_origins: list = dataclasses.field(default_factory=list)

    @property
    def coll(self) -> int:
        """Collective bytes of every kind."""
        return sum(self.coll_bytes.values())

    @property
    def temp_bytes(self) -> int:
        """The peak less the arguments: what the call needs beyond them."""
        return self.peak_live_bytes - self.argument_bytes


_DECOMPOSES: Dict[Any, bool] = {}


def _decomposes(func) -> bool:
    """Whether ``func`` has a CompositeImplicitAutograd kernel, which
    ``FlopCounterMode`` runs in place of the op (cached per op)."""
    d = _DECOMPOSES.get(func)
    if d is None:
        dk = torch._C.DispatchKey.CompositeImplicitAutograd
        d = _DECOMPOSES[func] = (
            dk in func.py_kernels
            or torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), dk))
    return d


def _tensors(tree) -> Iterable[torch.Tensor]:
    """The tensors of ``tree``, a DTensor as its local shard."""
    return (t._local_tensor if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _storages(tree) -> Dict[int, int]:
    """{storage key: bytes} of the distinct storages of ``tree``'s tensors."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in _tensors(tree)}


def block_bytes(n: int) -> int:
    """The bytes of the block the CUDA caching allocator gives an
    ``n``-byte storage: ``n`` rounded up to ``ALLOC_BLOCK`` (none for 0)."""
    return -(-n // ALLOC_BLOCK) * ALLOC_BLOCK


def storage_bytes(tree, blocks: bool = False) -> int:
    """Bytes of the distinct storages of the tensors in ``tree`` (with
    ``blocks``, of their allocator blocks)."""
    return sum(block_bytes(n) if blocks else n
               for n in _storages(tree).values())


def _view_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CountingMode(TorchDispatchMode):
    """Counts the ops run under it (see the module docstring). The live set
    is swept lazily: a storage's bytes stay in ``_tracked`` until a sweep
    finds it expired, so ``_tracked`` never undercounts; a sweep runs only
    when a new storage could lift either peak, which keeps both exact."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.peak_live_bytes = 0
        self.peak_block_bytes = 0
        self.coll_bytes: Dict[str, int] = {}
        self.collectives: list = []
        self.collective_origins: list = []
        self._live: Dict[int, Tuple[StorageWeakRef, int, int]] = {}
        self._tracked = 0
        self._tracked_blocks = 0

    def _forget(self, key) -> None:
        _, n, b = self._live.pop(key)
        self._tracked -= n
        self._tracked_blocks -= b

    def _sweep(self) -> None:
        for k in [k for k, (ref, *_) in self._live.items() if ref.expired()]:
            self._forget(k)

    def track(self, tree) -> int:
        """Registers the storages of the tensors in ``tree``; returns the
        bytes of those the mode had not seen live."""
        added = 0
        for t in _tensors(tree):
            s = t.untyped_storage()
            key = s._cdata
            old = self._live.get(key)
            if old is not None:
                if not old[0].expired():
                    continue
                self._forget(key)
            n = s.nbytes()
            b = block_bytes(n)
            if (self._tracked + n > self.peak_live_bytes
                    or self._tracked_blocks + b > self.peak_block_bytes):
                self._sweep()
            self._live[key] = (StorageWeakRef(s), n, b)
            self._tracked += n
            self._tracked_blocks += b
            self.peak_live_bytes = max(self.peak_live_bytes, self._tracked)
            self.peak_block_bytes = max(self.peak_block_bytes,
                                        self._tracked_blocks)
            added += n
        return added

    def _collective(self, func, args, out) -> None:
        kind = _COLLECTIVES.get(func._overloadpacket.__name__)
        if kind is None:
            return
        n = sum(_view_bytes(t) for t in _tensors(out))
        size = None
        if kind in ("all-gather", "reduce-scatter"):
            size = int(args[-2])
        n *= size if kind == "reduce-scatter" else _XFER[kind]
        self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + n
        outs = list(_tensors(out))
        self.collectives.append((kind, str(args[-1]), size,
                                 [tuple(t.shape) for t in outs], n))
        dtype = _HLO_DTYPES.get(outs[0].dtype, str(outs[0].dtype)) \
            if outs else "?"
        self.collective_origins.append((dtype, _collective_source()))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # DTensor runs it on local shards
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation infers a global shape by
            # running the op on fake tensors the first time it meets it:
            # not a step of the program
            return func(*args, **kwargs)
        if func in _METADATA:
            return func(*args, **kwargs)
        if func.namespace == "_c10d_functional":
            out = func(*args, **kwargs)
            self._collective(func, args, out)
            self.track(out)
            return out
        if _decomposes(func):
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in tree_leaves(out)):
            return out      # a fake input of that shape inference
        self.ops += 1
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if not func.is_view:
            self.bytes += sum(_view_bytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_view_bytes(t) for t in _tensors(out))
        self.track(out)
        return out


def count_call(fn: Callable, *args, **kwargs) -> Tuple[Any, Counts]:
    """``fn(*args, **kwargs)`` once under a :class:`CountingMode`; returns
    its result and the :class:`Counts` of the call."""
    mode = CountingMode()
    arg_bytes = mode.track((args, kwargs))
    arg_keys = set(mode._live)
    t0 = time.perf_counter()
    with mode:
        out = fn(*args, **kwargs)
    seconds = time.perf_counter() - t0
    out_bytes = sum(n for k, n in _storages(out).items() if k not in arg_keys)
    return out, Counts(flops=mode.flops, bytes=mode.bytes,
                       argument_bytes=arg_bytes, output_bytes=out_bytes,
                       peak_live_bytes=mode.peak_live_bytes, ops=mode.ops,
                       peak_block_bytes=mode.peak_block_bytes,
                       seconds=seconds, coll_bytes=dict(mode.coll_bytes),
                       collectives=list(mode.collectives),
                       collective_origins=list(mode.collective_origins))
