"""Per-rank FLOP, byte, collective and memory counts of one step, the port's
counterpart of the JAX package's ``roofline/hlo.py``.

The reference compiles a cell and parses the partitioned HLO text, whose
shapes are per partition.  The port has no compiled module: it runs the step
once under :class:`OpCounter`, a ``TorchDispatchMode`` that sees every ATen
op this rank runs, and keeps the reference's report (:class:`CollectiveStats`
and its ring accounting, verbatim).

**Per rank.**  A mode sees a DTensor op at its global shape.  The counter
returns ``NotImplemented`` for it, so DTensor runs its sharding propagation
and then this rank's local op, which reaches the counter again on plain
(local) tensors and is counted as it is: an output sharded or partial over
mesh dims of product n is counted at 1/n of the global op (the larger
block where a dim does not divide).  The redistributions DTensor makes on
its own reach the counter too, as ``_c10d_functional`` ops at their local
shapes, with the group size of the mesh dim they run over.  The sharding
propagation itself runs each op once more at its global shape, to learn
the output's shape: the counter pauses inside it (and inside DTensor's
other bookkeeping, :data:`_PAUSED`).  Ops on plain
tensors (the attention blocks, the MoE, the embedding, which run on
``to_local()`` blocks) count as they are.

**FLOPs** are counted exactly for the matmul family (``mm``, ``addmm``,
``bmm``, ``baddbmm``, what ``einsum`` and ``matmul`` decompose into, and
``convolution`` with its backward), through ``torch.utils.flop_counter``'s
formulas; every other ATen op counts none, as the reference counts only
``dot``.  A hand-written kernel registered as a ``repro_torch::`` custom op
counts the FLOPs and bytes of its ``work`` function (in its ``ops.py``, the
count the kernel table's bound uses).  A wrapper given a real CUDA tensor
skips its op's dispatch (19-39 µs of host time a call on the card's host,
``benchmarks/op_dispatch.py``) and launches through :func:`launch`, which
counts the same op in this thread's innermost counter: a real step counts
what its fake trace counts.

**Bytes** are the reference's traffic upper bound: the result plus operand
bytes of every op that materialises.  Views, ``detach``, allocations
without a write and metadata ops are free (the reference's ``_FREE_OPS``);
a result that aliases an operand (an in-place op) is not counted again; an
in-place update into a larger buffer (``index_put_``, ``copy_``, a scatter
into a slice) is charged twice its update (the reference's
``dynamic-update-slice`` rule) and an indexed read twice its result (its
``dynamic-slice`` rule).

**Memory.**  The counter tracks the bytes of the storages allocated while it
runs (a weak reference on each new storage), and their peak: the step's
transient peak over its resident inputs (``peak_bytes``).
"""

from __future__ import annotations

import copy
import threading
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVE_OPS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# _c10d_functional op name -> the HLO collective it is
_COLLECTIVE_OF = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}

# c10d op name (the process-group API's collectives) -> the HLO collective
_C10D_COLLECTIVE_OF = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "collective-permute",
}

_aten = torch.ops.aten
# the matmul family whose FLOPs are counted (torch.utils.flop_counter's formulas)
_FLOP_OPS = (_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm, _aten.convolution,
             _aten._convolution, _aten.convolution_backward)
# ops that move no bytes of their own: allocations without a write, aliases
# and metadata (views are recognised by their schema)
_FREE_OPS = {
    _aten.detach, _aten.alias, _aten.lift_fresh, _aten.empty, _aten.empty_strided,
    _aten.empty_like, _aten.new_empty, _aten.new_empty_strided, _aten.sym_size,
    _aten.sym_stride, _aten.sym_numel, _aten.sym_storage_offset, _aten.is_contiguous,
    _aten.set_, torch.ops.prim.device, torch.ops._c10d_functional.wait_tensor,
}
# in-place updates of a slice of a larger buffer: (op, index of the update operand)
_UPDATE_OPS = {_aten.index_put_: 2, _aten.index_put: 2, _aten._index_put_impl_: 2,
               _aten.slice_scatter: 1, _aten.select_scatter: 1, _aten.copy_: 1}
# indexed reads out of a larger buffer
_GATHER_OPS = {_aten.index, _aten.embedding}


# DTensor's bookkeeping that runs ATen ops which are not this rank's work:
# (module, class, method, whether it must run outside a fake tensor mode,
# whether it is a pure function of its arguments, remembered per counter).
# The sharding propagation runs each op once at its global shape to learn
# the output's; a strided shard sizes its blocks with index tensors, which
# under FakeTensorMode would be fake and ask for their values (torch 2.13).
_PAUSED = (
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
     "_propagate_tensor_meta_non_cached", False, False),
    ("torch.distributed.tensor.placement_types", "_StridedShard",
     "local_shard_size_and_offset", True, True),
)


def _wire_bytes(op: str, result_bytes: int, n: int) -> float:
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * result_bytes * (n - 1) / n
    if op == "all-gather":
        return result_bytes * (n - 1) / n
    if op == "reduce-scatter":
        return float(result_bytes) * (n - 1)
    if op == "all-to-all":
        return result_bytes * (n - 1) / n
    return float(result_bytes)  # collective-permute


@dataclass
class CollectiveStats:
    result_bytes_by_op: Dict[str, int] = field(default_factory=dict)
    wire_bytes_by_op: Dict[str, float] = field(default_factory=dict)
    count_by_op: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.result_bytes_by_op.values())

    def weighted_bytes(self) -> float:
        """Per-chip wire bytes (ring-algorithm accounting)."""
        return sum(self.wire_bytes_by_op.values())

    def summary(self) -> Dict[str, float]:
        return {
            "result_GB": round(self.total_bytes / 1e9, 4),
            "wire_GB": round(self.weighted_bytes() / 1e9, 4),
            **{f"{op}_wire_MB": round(b / 1e6, 3)
               for op, b in sorted(self.wire_bytes_by_op.items())},
            **{f"{op}_count": c for op, c in sorted(self.count_by_op.items())},
        }

    def add(self, op: str, result_bytes: int, n: int) -> None:
        self.wire_bytes_by_op[op] = self.wire_bytes_by_op.get(op, 0.0) + _wire_bytes(
            op, result_bytes, n)
        self.result_bytes_by_op[op] = self.result_bytes_by_op.get(op, 0) + int(result_bytes)
        self.count_by_op[op] = self.count_by_op.get(op, 0) + 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage(t: torch.Tensor):
    """``t``'s untyped storage (the same object for every tensor on it), or
    None for a tensor without one."""
    try:
        return t.untyped_storage()
    except (NotImplementedError, RuntimeError):
        return None


def _kernel_work() -> Dict[object, Callable]:
    """{custom op: its ``work(*args) -> (bytes, flops)``} of the four kernels."""
    from repro_torch.kernels.flash_prefill import ops as flash
    from repro_torch.kernels.mamba2_ssd import ops as ssd
    from repro_torch.kernels.paged_decode import ops as paged
    from repro_torch.kernels.rwkv6_scan import ops as rwkv

    return {m.OP: m.OP_WORK for m in (flash, paged, rwkv, ssd)}


_active = threading.local()  # .counters: this thread's entered counters


def launch(op, fn: Callable, *args):
    """``fn(*args)``, a kernel's launch by its wrapper on real CUDA tensors,
    counted as its custom op ``op`` (``op(*args)`` is what a fake or meta
    tensor runs) in this thread's innermost active :class:`OpCounter`, if
    any; the ATen ops inside ``fn`` count nothing, as they do below the op."""
    counters = getattr(_active, "counters", None)
    if not counters:
        return fn(*args)
    counter = counters[-1]
    counter._paused += 1
    try:
        out = fn(*args)
        # paused here too: ``work`` may read a tensor (paged decode's lens)
        counter._count(op.default, args, {}, out)
    finally:
        counter._paused -= 1
    return out


def _group_size(func, args, kwargs) -> int:
    import torch.distributed.distributed_c10d as c10d

    names = [a.name for a in func._schema.arguments]
    if "group_name" in kwargs:
        name = kwargs["group_name"]
    elif "group_name" in names and names.index("group_name") < len(args):
        name = args[names.index("group_name")]
    else:
        return 2  # the reference's default when it cannot read the group
    return c10d._resolve_process_group(name).size()


class OpCounter(TorchDispatchMode):
    """Counts what one rank runs while it is active (``with OpCounter() as
    c: step(...)``), with :class:`HloModule`'s read-outs:
    :meth:`total_flops`, :meth:`total_traffic_bytes`,
    :meth:`collective_stats`, and :meth:`peak_bytes`.  See the module
    docstring."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.traffic = 0.0
        self.collectives = CollectiveStats()
        self.flops_by_op: Dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self._paused = 0
        self._work = _kernel_work()
        self._seen: "weakref.WeakSet" = weakref.WeakSet()
        self._patched: list = []

    # -- DTensor's own bookkeeping, which is not this rank's work ----------------
    def __enter__(self):
        import importlib

        from torch._subclasses.fake_tensor import unset_fake_temporarily

        counter = self
        self._patched = []
        memo: Dict[tuple, object] = {}
        targets = []
        for module, cls_name, attr, real, pure in _PAUSED:
            cls = getattr(importlib.import_module(module), cls_name, None)
            orig = getattr(cls, attr, None)
            if orig is None:
                # without the pause every op DTensor propagates would count
                # at its global shape as well as this rank's
                raise RuntimeError(f"OpCounter: {module}.{cls_name}.{attr} is missing in "
                                   f"torch {torch.__version__}: its pause cannot be set")
            targets.append((cls, attr, orig, real, pure))
        for cls, attr, orig, real, pure in targets:

            def paused(*a, _orig=orig, _real=real, _pure=pure, **k):
                key = (_orig, a, tuple(sorted(k.items()))) if _pure else None
                if key is not None and key in memo:
                    return copy.deepcopy(memo[key])
                counter._paused += 1
                try:
                    if _real:
                        with unset_fake_temporarily():
                            out = _orig(*a, **k)
                    else:
                        out = _orig(*a, **k)
                finally:
                    counter._paused -= 1
                if key is not None:
                    memo[key] = copy.deepcopy(out)
                return out

            setattr(cls, attr, paused)
            self._patched.append((cls, attr, orig))
        if not hasattr(_active, "counters"):
            _active.counters = []
        _active.counters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _active.counters.remove(self)
            for cls, attr, orig in self._patched:
                setattr(cls, attr, orig)

    # -- dispatch ----------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs this rank's local op, counted then
        out = func(*args, **kwargs)
        if not self._paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        self._track(outs, ins)
        work = self._work.get(packet)
        if work is not None:
            nbytes, flops = work(*args, **kwargs)
            self._flop(str(packet), flops)
            self.traffic += nbytes
            return
        space, _, name = packet._qualified_op_name.partition("::")
        if space == "_c10d_functional" and name in _COLLECTIVE_OF:
            n = _group_size(func, args, kwargs)
            for t in outs:
                self.collectives.add(_COLLECTIVE_OF[name], _nbytes(t), n)
        elif space == "c10d" and name in _C10D_COLLECTIVE_OF:
            # (tensors, process group, ...): the tensors are written in place
            n = torch.distributed.ProcessGroup.unbox(args[1]).size()
            for t in _tensors(args[0]):
                self.collectives.add(_C10D_COLLECTIVE_OF[name], _nbytes(t), n)
        if packet in _FLOP_OPS:
            from torch.utils.flop_counter import flop_registry

            self._flop(str(packet), flop_registry[packet](*args, **kwargs, out_val=out))
        if packet in _FREE_OPS or func.is_view:
            return
        if packet in _UPDATE_OPS:
            i = _UPDATE_OPS[packet]
            upd = args[i] if i < len(args) else None
            self.traffic += 2 * _nbytes(upd) if isinstance(upd, torch.Tensor) else 0
            return
        if packet in _GATHER_OPS:
            self.traffic += 2 * sum(_nbytes(t) for t in outs)
            return
        ids = {id(t) for t in ins}
        written = sum(_nbytes(t) for t in outs if id(t) not in ids)
        self.traffic += written + sum(_nbytes(t) for t in ins)

    def _flop(self, name: str, flops: float) -> None:
        self.flops += flops
        self.flops_by_op[name] = self.flops_by_op.get(name, 0.0) + flops

    def _track(self, outs, ins) -> None:
        """Add each new storage among ``outs`` (not one of ``ins``'s: a view
        or an in-place result) to the live bytes until it is freed."""
        held = [_storage(t) for t in ins]
        for t in outs:
            st = _storage(t)
            if st is None or st in self._seen or any(st is h for h in held):
                continue
            self._seen.add(st)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    # -- read-outs (HloModule's) ---------------------------------------------------
    def total_flops(self) -> float:
        return self.flops

    def total_traffic_bytes(self) -> float:
        return self.traffic

    def collective_stats(self) -> CollectiveStats:
        return self.collectives

    def peak_bytes(self) -> int:
        """The largest sum of live bytes allocated while counting."""
        return self.peak
