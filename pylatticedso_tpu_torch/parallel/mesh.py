"""The device mesh of the port, and its collectives (PyTorch).

JAX runs its sharded paths on a ``jax.sharding.Mesh`` of ``n_dp x
n_shard`` devices (``parallel/sharding.py:33-39``) and lets GSPMD insert
the collectives.  The port keeps JAX's single controller: one Python
process drives every shard, with no ``torch.distributed`` and no NCCL.
``Mesh`` is the record (axis sizes and an ``n_dp x n_shard`` grid of
``torch.device``); a device may appear more than once, which makes a
virtual mesh (``["cpu"] * 8`` in the tests, ``["cuda:0"] * 4`` on one
card), where every shard is still its own tensor and every collective
still copies.

A value held by the shards of one mesh row is a ``Sharded``: a field cut
into slabs along one dimension, or a replicated value (every shard the
same bits).  Its arithmetic and the elementwise torch functions act shard
by shard on each shard's own device; anything that would combine shards
is one of the collectives here, written on lists of per-shard tensors:

* ``all_reduce_sum``: every partial copied to each destination, then
  added in rank order 0 ... n-1 there, so every shard gets the same bits
  and every repeat the same bits (no atomics, a fixed summation order);
* ``halo_exchange``: each slab's boundary planes copied into its
  neighbours' ghost layers; the two ends of the domain keep the zeros of
  the one-device ghost padding;
* ``scatter`` / ``gather`` / ``slices`` / ``broadcast`` of a field;
* ``dot`` / ``norm`` / ``vector_norm`` of a sharded field: per-shard
  partials, then ``all_reduce_sum`` (a replicated field's are local).

Copies use ``Tensor.to(device, copy=True)`` and ``Tensor.copy_``, which
PyTorch orders on both devices' current streams.  Over one shard every
collective is the identity, so a one-shard mesh reproduces the one-device
bits.
"""

from __future__ import annotations

import operator
from types import SimpleNamespace
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["Mesh", "make_mesh", "check_device", "Sharded", "all_reduce_sum",
           "halo_exchange", "scatter", "gather", "slices", "broadcast",
           "dot", "norm", "vector_norm", "OPS"]


def check_device(device) -> torch.device:
    """The port runs on the card unless the caller asks for the CPU; a CUDA
    request with no card fails here instead of falling back.  A bare
    ``"cuda"`` becomes the current card's index."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain torch operator")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh(NamedTuple):
    """``shape``: {"dp": n_dp, "shard": n_shard}; ``devices``: n_dp rows of
    n_shard ``torch.device`` (repeats allowed: a virtual mesh)."""
    shape: dict
    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def device(self) -> torch.device:
        """Row 0, shard 0: where replicated and gathered work runs."""
        return self.devices[0][0]


def make_mesh(n_shard: Optional[int] = None, n_dp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """The ``n_dp x n_shard`` mesh over ``devices`` (JAX's signature and
    rule: ``n_shard`` defaults to ``len(devices) // n_dp``, the first
    ``n_dp * n_shard`` devices in row-major order).  ``devices`` defaults
    to every CUDA device, ``cuda:0 ... cuda:{device_count() - 1}``; with no
    card and no ``devices`` this raises (never the CPU).  Raises where
    ``n_dp * n_shard`` exceeds the devices given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no devices given and torch.cuda.is_available() "
                "is False; pass devices=['cpu', ...] to build a CPU mesh")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [check_device(d) for d in devices]
    if n_shard is None:
        n_shard = len(devices) // n_dp
    if n_dp < 1 or n_shard < 1 or n_dp * n_shard > len(devices):
        raise ValueError(f"make_mesh: a {n_dp} x {n_shard} mesh needs "
                         f"{n_dp * n_shard} devices; {len(devices)} given")
    grid = tuple(tuple(devices[i * n_shard:(i + 1) * n_shard])
                 for i in range(n_dp))
    return Mesh(shape={"dp": n_dp, "shard": n_shard}, devices=grid)


# ------------------------------------------------------------ collectives
def _copy(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device``, also when it is there."""
    return t.to(device, copy=True).contiguous()


def all_reduce_sum(parts: Sequence[torch.Tensor],
                   devices: Optional[Sequence] = None) -> List[torch.Tensor]:
    """The sum of ``parts`` on each destination (default: each part's own
    device): every part copied there, then added in rank order 0 ... n-1.
    Every destination gets the same bits.  One part is its own sum."""
    devices = [p.device for p in parts] if devices is None else devices
    out = []
    for j, dev in enumerate(devices):
        s = None
        for k, p in enumerate(parts):
            q = p if k == j and p.device == dev else _copy(p, dev)
            s = q if s is None else s + q
        out.append(s)
    return out


def broadcast(t: torch.Tensor, devices: Sequence) -> "Sharded":
    """A replicated value: a copy of ``t`` on every device."""
    return Sharded([_copy(t, d) for d in devices])


def scatter(field: torch.Tensor, devices: Sequence, dim: int) -> "Sharded":
    """``field`` cut into ``len(devices)`` equal slabs along ``dim``, slab k
    copied to ``devices[k]``."""
    n = len(devices)
    size = field.shape[dim]
    if size % n:
        raise ValueError(f"scatter: {size} planes along dim {dim} do not "
                         f"divide into {n} slabs")
    s = size // n
    return Sharded([_copy(field.narrow(dim, k * s, s), d)
                    for k, d in enumerate(devices)], dim)


def slices(field: torch.Tensor, devices: Sequence, dim: int,
           halo: int = 1) -> "Sharded":
    """Slab k of a ghost-padded ``field`` (``halo`` ghost planes each side
    along ``dim``) with its halo: planes ``[k S, k S + S + 2 halo)``, which
    hold the neighbours' boundary planes, copied to ``devices[k]``."""
    n = len(devices)
    size = field.shape[dim] - 2 * halo
    if size % n:
        raise ValueError(f"slices: {size} interior planes along dim {dim} "
                         f"do not divide into {n} slabs")
    s = size // n
    return Sharded([_copy(field.narrow(dim, k * s, s + 2 * halo), d)
                    for k, d in enumerate(devices)], dim)


def gather(x: "Sharded", device) -> torch.Tensor:
    """The whole field on ``device``: the slabs in rank order (a replicated
    value: shard 0's copy)."""
    if x.dim is None:
        return _copy(x.parts[0], device)
    return torch.cat([_copy(p, device) for p in x.parts], dim=x.dim)


def halo_exchange(x: "Sharded", width: int = 1) -> "Sharded":
    """In place on ghost-padded slabs (``width`` ghost planes each side
    along ``x.dim``): slab k's lower ghost layer takes slab k-1's last
    ``width`` interior planes and its upper one slab k+1's first, whole
    planes (their ghosts along the other axes, zeros, included).  The
    lower layer of slab 0 and the upper of the last slab are left as they
    are: the zeros of the one-device ghost padding.  Returns ``x``."""
    p, d, w = x.parts, x.dim, width
    for k in range(len(p)):
        s = p[k].shape[d] - 2 * w
        if k > 0:
            sp = p[k - 1].shape[d] - 2 * w
            p[k].narrow(d, 0, w).copy_(p[k - 1].narrow(d, sp, w))
        if k < len(p) - 1:
            p[k].narrow(d, w + s, w).copy_(p[k + 1].narrow(d, w, w))
    return x


def dot(a: "Sharded", b: "Sharded") -> "Sharded":
    """<a, b>, replicated: each shard's partial dot, then
    ``all_reduce_sum`` (a replicated field's dot is each shard's own)."""
    parts = [torch.dot(x.reshape(-1), y.reshape(-1))
             for x, y in zip(a.parts, b.parts)]
    return Sharded(parts if a.dim is None else all_reduce_sum(parts))


def norm(a: "Sharded") -> "Sharded":
    """sqrt(<a, a>), as ``fem.solve._norm`` takes it."""
    return Sharded([torch.sqrt(p) for p in dot(a, a).parts])


def vector_norm(a: "Sharded") -> "Sharded":
    """The 2-norm as ``torch.linalg.vector_norm`` takes it: each shard's
    norm, then on every shard the norm of the partial norms stacked in
    rank order.  One shard: its own norm (the norm of one value is the
    value), so a one-shard mesh keeps the one-device bits."""
    parts = [torch.linalg.vector_norm(p.reshape(-1)) for p in a.parts]
    if a.dim is None or len(parts) == 1:
        return Sharded(parts)
    out = []
    for j, p in enumerate(parts):
        row = [q if k == j else _copy(q, p.device)
               for k, q in enumerate(parts)]
        out.append(torch.linalg.vector_norm(torch.stack(row)))
    return Sharded(out)


# the reductions ``fem.solve.pcg`` and the power iteration take for a
# sharded field
OPS = SimpleNamespace(dot=dot, norm=norm, vector_norm=vector_norm)


# -------------------------------------------------------------- Sharded
# the torch functions that act shard by shard: elementwise, creation-like
# and layout functions; a reduction raises (it is a collective above)
_SHARDWISE = {torch.zeros_like, torch.ones_like, torch.where,
              torch.clamp_min, F.pad}


def _part(v, k: int):
    if isinstance(v, Sharded):
        return v.parts[k]
    if isinstance(v, (list, tuple)):
        return type(v)(_part(x, k) for x in v)
    if isinstance(v, torch.Tensor):
        raise TypeError("a plain tensor in an operation on a sharded value: "
                        "broadcast or scatter it over the mesh first")
    return v


def _first(values) -> Optional["Sharded"]:
    for v in values:
        if isinstance(v, Sharded):
            return v
        if isinstance(v, (list, tuple)):
            s = _first(v)
            if s is not None:
                return s
    return None


class Sharded:
    """One value held by the shards of a mesh row, a tensor a shard:
    ``parts[k]`` on the row's k-th device.  ``dim`` is the dimension the
    field is cut along (slabs), or None for a replicated value (every
    shard the same bits).  Arithmetic with another ``Sharded`` of the
    same row or with a Python number, and the functions of ``_SHARDWISE``
    (any torch function on a replicated value, each shard holding all of
    it), act shard by shard on each shard's device; ``bool``/``float``
    read shard 0 (a replicated scalar's shards agree bit for bit)."""

    __slots__ = ("parts", "dim")
    __hash__ = None

    def __init__(self, parts: Sequence[torch.Tensor],
                 dim: Optional[int] = None):
        self.parts = list(parts)
        self.dim = dim

    def map(self, fn, *others) -> "Sharded":
        """``fn`` on every shard: ``fn(part, *other parts)``."""
        for o in others:
            if isinstance(o, Sharded) and len(o.parts) != len(self.parts):
                raise ValueError(f"sharded values of {len(self.parts)} and "
                                 f"{len(o.parts)} shards")
        dim = self.dim
        for o in others:
            if dim is None and isinstance(o, Sharded):
                dim = o.dim
        return Sharded([fn(*[_part(v, k) for v in (self,) + others])
                        for k in range(len(self.parts))], dim)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ref = _first(list(args) + list(kwargs.values()))
        if func not in _SHARDWISE and ref.dim is not None:
            raise TypeError(f"{getattr(func, '__name__', func)} on a field "
                            f"in slabs: only elementwise and layout "
                            f"functions act slab by slab (reductions are "
                            f"the collectives of parallel.mesh)")
        out = [func(*_part(args, k), **{n: _part(v, k)
                                        for n, v in kwargs.items()})
               for k in range(len(ref.parts))]
        return Sharded(out, ref.dim)

    # elementwise arithmetic, shard by shard
    def _bin(op):
        return lambda self, other: self.map(op, other)

    def _rbin(op):
        return lambda self, other: self.map(lambda a, b: op(b, a), other)

    __add__, __radd__ = _bin(operator.add), _rbin(operator.add)
    __sub__, __rsub__ = _bin(operator.sub), _rbin(operator.sub)
    __mul__, __rmul__ = _bin(operator.mul), _rbin(operator.mul)
    __truediv__, __rtruediv__ = _bin(operator.truediv), _rbin(operator.truediv)
    __le__, __lt__ = _bin(operator.le), _bin(operator.lt)
    __ge__, __gt__ = _bin(operator.ge), _bin(operator.gt)
    __eq__, __ne__ = _bin(operator.eq), _bin(operator.ne)
    __or__, __and__ = _bin(operator.or_), _bin(operator.and_)
    del _bin, _rbin

    def __neg__(self) -> "Sharded":
        return self.map(operator.neg)

    def __getitem__(self, index) -> "Sharded":
        return self.map(lambda p: p[index])

    def to(self, *args, **kwargs) -> "Sharded":
        return self.map(lambda p: p.to(*args, **kwargs))

    def __bool__(self) -> bool:
        return bool(self.parts[0])

    def __float__(self) -> float:
        return float(self.parts[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    @property
    def devices(self) -> List[torch.device]:
        return [p.device for p in self.parts]

    def gather(self, device=None) -> torch.Tensor:
        """The whole field on ``device`` (default: shard 0's)."""
        return gather(self, self.parts[0].device if device is None
                      else device)

    def __repr__(self) -> str:
        return (f"Sharded({len(self.parts)} parts, dim={self.dim}, "
                f"{self.dtype}, {[tuple(p.shape) for p in self.parts]})")
