"""Reservoir-axis sharding over ranks: one engine's R reservoirs spread
over several devices.

The port of the JAX package's ``parallel/sharded.py``.  A **rank** is a
torch device, as in :mod:`.merge`, and a card may be named more than once
(as the JAX package's tests run an 8-device mesh on one host).  Rank ``i``
of an ``n``-rank :class:`Mesh` holds rows ``[i R/n, (i+1) R/n)`` of every
state leaf, the placement ``P(axis)`` gives in the reference:

- an update is collective-free: each rank's row block goes through the
  mode's kernel wrapper on its own device (:func:`sharded_update`), one
  launch a rank, the counterpart of ``shard_map`` over the Pallas kernel;
  on CPU ranks the wrappers run the plain versions;
- a result is gathered onto every rank (:func:`sharded_result`) by the
  hand-written all-gather of :mod:`~reservoir_tpu_torch.ops.merge_cuda`,
  one launch a card, the counterpart of the ``all_gather`` XLA inserts;
  each rank then reduces the gathered counts itself, so the total needs no
  other collective.

Every helper is mode-generic: the three states carry the reservoir
dimension first in every leaf.  A sharded engine is bit-identical to the
unsharded one with the same key: sharding decides placement, never
semantics.

The reference's ``shard_map`` is not ported: it is a seam between jax
versions (``jax.shard_map`` against ``jax.experimental.shard_map``), and a
torch rank runs its block through the wrapper directly.

A mesh spans this process's devices only.  In a process group of more than
one process (:mod:`.multihost`), :func:`make_mesh` raises: the reference's
mesh would span the other processes' chips, and a mesh of this process's
devices would quietly make every process sample all R rows.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import resolve_device
from ..ops import algorithm_l as _algl
from ..ops import algorithm_l_cuda as _akernel
from ..ops import distinct as _dist
from ..ops import distinct_cuda as _dkernel
from ..ops import u64e
from ..ops import weighted as _wtd
from ..ops import weighted_cuda as _wkernel
from ..ops.merge_cuda import RingCommunicator, gather_parts

__all__ = [
    "Mesh",
    "RowBlock",
    "RowSharding",
    "make_mesh",
    "reservoir_sharding",
    "state_shardings",
    "shard_state",
    "sharded_update",
    "sharded_result",
]


class Mesh:
    """A 1-D mesh: an ordered tuple of torch devices, one a rank (repeats
    allowed), all CPU or all CUDA, and the name of its one axis.
    ``mesh.shape[axis]`` is the number of ranks, as the reference's
    ``mesh.shape[config.mesh_axis]`` reads."""

    def __init__(self, devices: Sequence[Any], axis_names: Sequence[str] = ("res",)) -> None:
        ranks = tuple(resolve_device(d) for d in devices)
        if not ranks:
            raise ValueError("a mesh needs at least one device")
        if len({r.type for r in ranks}) != 1:
            raise ValueError(f"a mesh's ranks must be all CPU or all CUDA devices, got {list(ranks)}")
        names = tuple(axis_names)
        if len(names) != 1:
            raise ValueError(f"the port's mesh has one axis, got {names}")
        self.devices: Tuple[torch.device, ...] = ranks
        self.axis_names: Tuple[str, ...] = names

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh(devices={[str(d) for d in self.devices]}, axis_names={self.axis_names})"


def _not_ported(world: int) -> NotImplementedError:
    return NotImplementedError(
        "a mesh that spans processes is not ported yet (ROADMAP.md, 'Left out of the first "
        f"slice', L4): this process is one of a group of {world}, and a mesh of its own devices "
        "would make every process sample all R rows; run one engine a process without "
        "mesh_axis, or one process"
    )


def make_mesh(num_devices: Optional[int] = None, axis: str = "res", devices=None) -> Mesh:
    """A 1-D mesh over the reservoir axis.

    ``devices`` defaults to every visible card; without a card that raises
    (pass ``devices=["cpu"] * n`` for the plain versions on the CPU).
    ``num_devices`` takes the first that many, and more than there are
    raises the reference's ``ValueError``."""
    from . import multihost

    world = multihost.group_size()
    if world > 1:
        raise _not_ported(world)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available for a default mesh; pass devices=[...], for "
                "example devices=['cpu'] * 8 to run the plain torch version on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if num_devices is not None:
        if len(devices) < num_devices:
            raise ValueError(
                f"requested a {num_devices}-device mesh but only "
                f"{len(devices)} devices are available"
            )
        devices = devices[:num_devices]
    return Mesh(devices, (axis,))


class RowBlock(NamedTuple):
    """A rank's rows ``[start, stop)`` on its ``device``."""

    device: torch.device
    start: int
    stop: int


class RowSharding:
    """The port's counterpart of ``NamedSharding(mesh, P(axis, ...))``: the
    leading (reservoir) dimension split evenly over the mesh's ranks in
    their order, every other dimension whole."""

    def __init__(self, mesh: Mesh, axis: str = "res") -> None:
        if axis not in mesh.shape:
            raise ValueError(f"axis {axis!r} is not an axis of {mesh}")
        self.mesh = mesh
        self.axis = axis

    def blocks(self, num_rows: int) -> List[RowBlock]:
        """Each rank's row range for ``num_rows`` rows; they must divide
        evenly over the ranks."""
        n = self.mesh.shape[self.axis]
        if num_rows % n:
            raise ValueError(
                f"num_reservoirs={num_rows} must divide evenly over the {n}-device "
                f"{self.axis!r} mesh axis"
            )
        per = num_rows // n
        return [RowBlock(d, i * per, (i + 1) * per) for i, d in enumerate(self.mesh.devices)]

    def __repr__(self) -> str:
        return f"RowSharding({self.mesh!r}, axis={self.axis!r})"


def reservoir_sharding(mesh: Mesh, axis: str = "res") -> RowSharding:
    """Shard the leading (reservoir) dimension over ``axis``."""
    return RowSharding(mesh, axis)


def state_shardings(state, mesh: Mesh, axis: str = "res"):
    """The sharding of each field of any mode's state (None where the
    field is absent): the leading dimension over ``axis``."""
    sh = RowSharding(mesh, axis)
    return type(state)(*(None if t is None else sh for t in state))


def split_rows(x: Any, mesh: Mesh, axis: str = "res") -> List[Any]:
    """``x`` (a tensor on any device, a numpy array, or a ``(hi, lo)`` pair
    of either) as one contiguous row block a rank, each on its rank's
    device."""
    if isinstance(x, tuple):
        return list(zip(*(split_rows(p, mesh, axis) for p in x)))
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    blocks = RowSharding(mesh, axis).blocks(int(x.shape[0]))
    return [x[b.start:b.stop].to(b.device).contiguous() for b in blocks]


def shard_state(state, mesh: Mesh, axis: str = "res") -> list:
    """Any mode's state as one state a rank, each field's row block copied
    onto the rank's device (WIDE ``[R, 2]`` counters and ``[R, 2]`` keys
    included): ``shards[i]`` holds rows ``[i R/n, (i+1) R/n)``.  The
    copies are the shards' own, since the kernels update them in place."""
    blocks = RowSharding(mesh, axis).blocks(int(state[0].shape[0]))
    return [
        type(state)(*(None if t is None else t[b.start:b.stop].to(b.device, copy=True) for t in state))
        for b in blocks
    ]


def gather_state(shards: Sequence, device: Any):
    """The whole state of ``shards`` (as :func:`shard_state` gave them) on
    ``device``, rows in rank order."""
    out = []
    for leaves in zip(*shards):
        if leaves[0] is None:
            out.append(None)
            continue
        like = leaves[0]
        words = [(t.view(torch.int32) if t.dtype == torch.uint32 else t).to(device) for t in leaves]
        out.append(torch.cat(words).view(like.dtype))
    return type(shards[0])(*out)


def rank_update(ops=_algl, steady: bool = False):
    """The mode's kernel wrapper a rank's block goes through:
    ``fn(state, batch, *extra, map_fn=..., [hash_fn=...])`` with ``extra``
    the weights tile (weighted) and ``valid``.  On a CUDA block it launches
    the kernel; on a CPU block it runs the plain version."""
    if ops is _algl:
        return _akernel.update_steady_cuda if steady else _akernel.update_cuda
    if ops is _wtd:
        return _wkernel.update_cuda
    if ops is _dist:
        return _dkernel.update_cuda
    raise ValueError(f"ops must be the port's algorithm_l, weighted or distinct module, got {ops!r}")


def sharded_update(mesh: Mesh, axis: str = "res", steady: bool = False, ops=_algl):
    """Tile update over the ranks, any mode.

    Returns ``fn(shards, batch, *extra) -> shards``: ``shards`` as
    :func:`shard_state` gave them; ``batch`` a whole ``[R, B]`` tile (a
    tensor on any device or a numpy array) and each ``extra`` (the weighted
    mode's weights tile, a ``valid`` vector) with leading dimension R, split
    by rank.  Each rank's block goes through :func:`rank_update`'s
    wrapper on its own device: one kernel launch a rank on the card,
    nothing exchanged between ranks.  ``steady`` takes the uniform mode's
    steady kernel (the fill-free update)."""
    fn = rank_update(ops, steady)

    def call(shards, batch, *extra):
        if len(shards) != mesh.size:
            raise ValueError(f"expected {mesh.size} shards, got {len(shards)}")
        parts = [split_rows(batch, mesh, axis)] + [split_rows(e, mesh, axis) for e in extra]
        return [fn(st, *args) for st, *args in zip(shards, *parts)]

    return call


def _words(t: torch.Tensor) -> torch.Tensor:
    """A leaf as 4-byte words, rows kept: an 8-byte ``[n, ...]`` leaf as an
    int32 ``[n, 2 * ...]`` view (the all-gather moves 4-byte leaves)."""
    t = t.contiguous()
    if t.dtype.itemsize == 8:
        return t.view(torch.int32).view(t.shape[0], -1)
    return t


def _unwords(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_words` for a gathered leaf of ``like``'s
    dtype and trailing shape."""
    if like.dtype.itemsize == 8:
        return w.view(like.dtype).view((w.shape[0],) + tuple(like.shape[1:]))
    return w


def _total(count: torch.Tensor) -> torch.Tensor:
    """The reference's ``total`` over the gathered counts: the int32 sum,
    wrapping as ``jnp.sum`` of int32 does, or for WIDE ``[R, 2]`` counts
    the float32 sum of their values (a stat, not sampling state)."""
    if count.ndim == 2:
        return u64e.to_f32(count).sum()
    s = count.to(torch.int64).sum()
    return (torch.remainder(s + 2**31, 2**32) - 2**31).to(torch.int32)


def sharded_result(mesh: Mesh, axis: str = "res", ops=_algl):
    """``result`` gathered onto every rank, any mode.

    Returns ``fn(shards) -> (samples, sizes, total)``, each a list with one
    entry a rank on that rank's device: the ``[R, k]`` samples and ``[R]``
    sizes of the mode's ``result`` in row order, and the total count.  One
    call of the all-gather kernel (one launch a card) moves every rank's
    samples, sizes and counts to every rank; 8-byte leaves travel as int32
    word pairs.  CPU ranks run the plain gather.

    ``total`` has the reference's dtype: the int32 sum of int32 counts,
    wrapped as ``jnp.sum`` wraps it; with WIDE counts the float32 sum of
    ``u64e.to_f32`` of each count, whose value depends on the order of the
    float32 additions (torch's reduction is not XLA's), so it equals the
    reference's only to float32 rounding."""
    comm = RingCommunicator(mesh.devices)

    def call(shards):
        if len(shards) != mesh.size:
            raise ValueError(f"expected {mesh.size} shards, got {len(shards)}")
        leaves = [(*ops.result(st), st.count) for st in shards]
        gathered = gather_parts([tuple(_words(t) for t in part) for part in leaves], comm)
        like = leaves[0]
        samples, sizes, totals = [], [], []
        for got in gathered:
            s, z, c = (_unwords(w, t) for w, t in zip(got, like))
            samples.append(s)
            sizes.append(z)
            totals.append(_total(c))
        return samples, sizes, totals

    return call
