"""Roofline terms from a counted run of a cell's step.

The port of ``repro/launch/hlo_analysis.py``, under its name so a reader
finds it.  The reference reads XLA's ``cost_analysis()`` (flops, bytes
accessed) and parses the partitioned HLO for collective bytes.  The port
has no HLO: it runs the step under a :class:`Counter`, a
``TorchDispatchMode`` that sees every ATen op, usually on the ``meta``
device (shapes, no data, no card), and counts

- flops: ``torch.utils.flop_counter``'s formula where an op has one (the
  products: ``mm``, ``bmm``, ``addmm``, convolutions, attention), else one
  per output element of a pointwise op, one per input element of a
  reducing op and one per source element of a scatter (the combines XLA's
  cost analysis counts for elementwise, reduce and scatter work);
- bytes: each op's input bytes plus its output bytes, a broadcast input at
  the bytes it holds; views move nothing and count nothing;
- the hand-written kernels (``kernels/*``): each wrapper's tap
  (``kernels/_tap``, which a :class:`Counter` registers with) adds its
  kernel's own operations and bytes, the formulas of the bound column of
  PERF.md's kernel table, whatever the device (a real launch, the plain
  version on the CPU, shapes on meta), and the plain version's own ops are
  not counted.  K2's bytes are its dense form (every store row read and
  written, the whole adjacency read): how many rows a call really touches
  depends on the data, which meta tensors do not have;
- collective bytes: the result bytes of each ``launch/mesh`` collective
  (``all_gather``, ``psum``, ``pmax``, ``por``; the ``dlse`` decode
  attentions reduce through them), whose own ops count nothing else.

How these differ from XLA's counts: XLA counts the program it compiled,
after fusion (a fused chain of elementwise ops reads and writes HBM once,
here every op counts its operands) and per device after partitioning;
the port counts the ops it runs, and one process runs every device's work,
so :func:`analyse` divides by the number of devices it is told the work
splits over (an even split: XLA's count also holds the work it replicates).
XLA counts a loop body once; the port counts every iteration it runs.

Hardware model (NVIDIA H100 SXM): 989 TFLOP/s dense bf16 on the tensor
cores (products of bf16 or fp16 operands), 67 TFLOP/s float32 outside them
(every other flop), 3.35 TB/s HBM, 450 GB/s NVLink each way.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry as _FLOP_FORMULAS

from repro_torch.kernels import _tap

PEAK_FLOPS = 989e12  # dense bf16 on the tensor cores
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s each way

_SCATTERS = ("scatter_reduce", "scatter_add", "index_add")  # the source is argument 3


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes ``t`` holds: a broadcast (stride 0) axis counts once."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0) if t.dim() else 1
    return n * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class Counter(TorchDispatchMode):
    """Counts the flops, bytes, collectives and kernel calls of the ops run
    under it (``with Counter() as c: fn(*args)``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0  # every flop
        self.tc_flops = 0.0  # of which at the tensor cores' rate
        self.product_flops = 0.0  # of which by flop_counter's formulas (the products)
        self.bytes = 0.0
        self.coll_bytes = 0.0
        self.ops: dict[str, int] = {}
        self.kernels: dict[str, int] = {}
        self.collectives: dict[str, int] = {}

    def __enter__(self):
        _tap.ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _tap.ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = _kind(func)
        if _tap.PAUSED[0] or kind is None:
            return out
        name = func._overloadpacket.__name__
        self.ops[name] = self.ops.get(name, 0) + 1
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        self.bytes += sum(tensor_bytes(t) for t in ins) + sum(tensor_bytes(t) for t in outs)
        if kind == "product":
            f = float(_FLOP_FORMULAS[func._overloadpacket](*args, **kwargs, out_val=out))
            self.flops += f
            self.product_flops += f
            if ins and ins[0].dtype in (torch.bfloat16, torch.float16):
                self.tc_flops += f
        elif kind == "pointwise" and outs:
            self.flops += outs[0].numel()
        elif kind == "reduction" and ins:
            self.flops += ins[0].numel()
        elif kind == "scatter" and len(args) > 3:
            self.flops += args[3].numel()
        return out


_KINDS: dict = {}


def _kind(func) -> str | None:
    """How an op counts (cached a ``func``): ``None`` (a view or an
    allocation: nothing), ``product``, ``pointwise``, ``reduction``,
    ``scatter`` or ``other`` (bytes only)."""
    k = _KINDS.get(func, False)
    if k is not False:
        return k
    packet = func._overloadpacket
    if func.is_view or packet.__name__.startswith("empty"):
        k = None
    elif packet in _FLOP_FORMULAS:
        k = "product"
    elif torch.Tag.pointwise in func.tags:
        k = "pointwise"
    elif torch.Tag.reduction in func.tags:
        k = "reduction"
    elif packet.__name__.rstrip("_") in _SCATTERS:
        k = "scatter"
    else:
        k = "other"
    _KINDS[func] = k
    return k


@dataclasses.dataclass
class Roofline:
    """Roofline terms of one device's share of a cell, in seconds at the
    H100's rates (the reference's fields)."""

    name: str
    num_chips: int
    hlo_flops: float  # per device
    hlo_bytes: float  # per device
    coll_bytes: float  # per device
    model_flops: float  # GLOBAL useful flops (6·N·D style)
    per_device_hbm_bytes: float | None = None
    tc_flops: float = 0.0  # per device, of hlo_flops: at the tensor cores' rate

    @property
    def t_compute(self) -> float:
        return self.tc_flops / PEAK_FLOPS + (self.hlo_flops - self.tc_flops) / PEAK_F32_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory, "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flop_ratio(self) -> float:
        if not self.hlo_flops:
            return 0.0
        return self.model_flops / (self.hlo_flops * self.num_chips)

    @property
    def roofline_fraction(self) -> float:
        """model-FLOPs time / achievable step time (max of the 3 terms)."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        if t <= 0 or not self.model_flops:
            return 0.0
        return (self.model_flops / (self.num_chips * PEAK_FLOPS)) / t

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "num_chips": self.num_chips,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flop_ratio": self.useful_flop_ratio,
            "roofline_fraction": self.roofline_fraction,
            "per_device_hbm_bytes": self.per_device_hbm_bytes,
            "tc_flops": self.tc_flops,
        }


def analyse(name: str, counter: Counter, num_chips: int, model_flops: float, *,
            per_device_hbm_bytes: float | None = None, split: int = 1) -> Roofline:
    """The roofline of a counted run: its counts divided by ``split``, the
    number of devices the counted work spreads over (1 where it is already
    one device's)."""
    return Roofline(
        name=name,
        num_chips=num_chips,
        hlo_flops=counter.flops / split,
        hlo_bytes=counter.bytes / split,
        coll_bytes=counter.coll_bytes / split,
        model_flops=model_flops,
        per_device_hbm_bytes=per_device_hbm_bytes,
        tc_flops=counter.tc_flops / split,
    )
