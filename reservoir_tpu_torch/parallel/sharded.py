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

A mesh may span the processes of a ``torch.distributed`` group
(:mod:`.multihost`), as the reference's mesh spans every process's chips
after ``multihost.initialize()``: :func:`make_mesh` in a group of W
processes, each passing its own devices, builds one mesh over every
process's ranks in process order, and records which process owns each
rank.  A process then holds only its own rank blocks (:func:`shard_state`),
updates only them from the global tile every process passes
(:func:`sharded_update`), and :func:`sharded_result` gathers within the
process through the all-gather kernel and across the processes through
``torch.distributed`` (gloo for CPU tensors; the group's backend, gloo or
NCCL, for card tensors), so every process gets the whole result.  Every
call that gathers across processes is a collective: every process of the
group makes it, in the same order.
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
    ``mesh.shape[config.mesh_axis]`` reads.

    ``owners`` gives the process (its rank in the ``torch.distributed``
    group) that holds each rank, and ``process`` this process's; both
    default to 0, a mesh of one process's devices.  A rank another process
    owns is only named here: this process never places anything on it."""

    def __init__(self, devices: Sequence[Any], axis_names: Sequence[str] = ("res",),
                 owners: Optional[Sequence[int]] = None, process: int = 0) -> None:
        devices = list(devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        owners = tuple(int(p) for p in owners) if owners is not None else (int(process),) * len(devices)
        if len(owners) != len(devices):
            raise ValueError(f"a mesh needs one owner a rank, got {len(owners)} for {len(devices)} ranks")
        if int(process) not in owners:
            raise ValueError(f"process {process} owns no rank of the mesh (owners {list(owners)})")
        ranks = tuple(resolve_device(d) if p == process else torch.device(d) for d, p in zip(devices, owners))
        if len({r.type for r in ranks}) != 1:
            raise ValueError(f"a mesh's ranks must be all CPU or all CUDA devices, got {list(ranks)}")
        names = tuple(axis_names)
        if len(names) != 1:
            raise ValueError(f"the port's mesh has one axis, got {names}")
        self.devices: Tuple[torch.device, ...] = ranks
        self.axis_names: Tuple[str, ...] = names
        self.owners: Tuple[int, ...] = owners
        self.process = int(process)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local_ranks(self) -> Tuple[int, ...]:
        """The indices of the ranks this process owns, in order."""
        return tuple(i for i, p in enumerate(self.owners) if p == self.process)

    @property
    def local_devices(self) -> Tuple[torch.device, ...]:
        """The devices of the ranks this process owns, in order."""
        return tuple(self.devices[i] for i in self.local_ranks)

    @property
    def multiprocess(self) -> bool:
        """Whether the ranks belong to more than one process."""
        return len(set(self.owners)) > 1

    def __repr__(self) -> str:
        owners = f", owners={list(self.owners)}, process={self.process}" if self.multiprocess else ""
        return f"Mesh(devices={[str(d) for d in self.devices]}, axis_names={self.axis_names}{owners})"


def not_ported(what: str) -> NotImplementedError:
    """The error of a path that a mesh over several processes does not
    take yet (ROADMAP.md, 'Left out of the first slice', L4)."""
    return NotImplementedError(
        f"{what} of a mesh that spans processes is not ported yet (ROADMAP.md, 'Left out of the first "
        "slice', L4): every process reads every row back with result(), state or sharded_result(); "
        "for this, use a mesh of one process's ranks"
    )


def make_mesh(num_devices: Optional[int] = None, axis: str = "res", devices=None) -> Mesh:
    """A 1-D mesh over the reservoir axis.

    ``devices`` defaults to every visible card; without a card that raises
    (pass ``devices=["cpu"] * n`` for the plain versions on the CPU).
    ``num_devices`` takes the first that many, and more than there are
    raises the reference's ``ValueError``.

    In a ``torch.distributed`` group of W processes this is a collective:
    each process passes its own devices, and the mesh holds every
    process's ranks in process order (the global device list the
    reference's mesh spans after a join), ``num_devices`` counted over
    them.  Every process must own at least one rank."""
    from . import multihost

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available for a default mesh; pass devices=[...], for "
                "example devices=['cpu'] * 8 to run the plain torch version on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [str(resolve_device(d)) for d in devices]
    owners, process, world = [0] * len(devices), 0, multihost.group_size()
    if world > 1:
        import torch.distributed as dist

        process = dist.get_rank()
        named: List[Any] = [None] * world
        dist.all_gather_object(named, devices)
        devices = [d for names in named for d in names]
        owners = [p for p, names in enumerate(named) for _ in names]
    if num_devices is not None:
        if len(devices) < num_devices:
            raise ValueError(
                f"requested a {num_devices}-device mesh but only "
                f"{len(devices)} devices are available"
            )
        devices, owners = devices[:num_devices], owners[:num_devices]
        missing = sorted(set(range(world)) - set(owners))
        if missing:
            raise ValueError(f"a {num_devices}-device mesh leaves process(es) {missing} without a rank; "
                             "every process of the group must own at least one")
    return Mesh(devices, (axis,), owners, process)


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

    def local_blocks(self, num_rows: int) -> List[RowBlock]:
        """:meth:`blocks` of the ranks this process owns (all of them for a
        mesh of one process)."""
        blocks = self.blocks(num_rows)
        return [blocks[i] for i in self.mesh.local_ranks]

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
    of either) as one contiguous row block a rank this process owns, each
    on its rank's device."""
    if isinstance(x, tuple):
        return list(zip(*(split_rows(p, mesh, axis) for p in x)))
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    blocks = RowSharding(mesh, axis).local_blocks(int(x.shape[0]))
    return [x[b.start:b.stop].to(b.device).contiguous() for b in blocks]


def shard_state(state, mesh: Mesh, axis: str = "res") -> list:
    """Any mode's state as one state a rank this process owns, each field's
    row block copied onto the rank's device (WIDE ``[R, 2]`` counters and
    ``[R, 2]`` keys included): the shard of rank ``i`` of ``n`` holds rows
    ``[i R/n, (i+1) R/n)``.  The copies are the shards' own, since the
    kernels update them in place.  Over several processes each process
    places only its own ranks' blocks."""
    blocks = RowSharding(mesh, axis).local_blocks(int(state[0].shape[0]))
    return [
        type(state)(*(None if t is None else t[b.start:b.stop].to(b.device, copy=True) for t in state))
        for b in blocks
    ]


def gather_state(shards: Sequence, device: Any, mesh: Optional[Mesh] = None):
    """The whole state of ``shards`` (as :func:`shard_state` gave them, or
    any tuples of row blocks, one a rank this process owns) on ``device``,
    rows in rank order.  Over a ``mesh`` that spans processes the rows then
    cross the group (:func:`_across_processes`, a collective): every
    process gets every row."""
    out = []
    for leaves in zip(*shards):
        out.append(None if leaves[0] is None else torch.cat([_words(t).to(device) for t in leaves]))
    if mesh is not None and mesh.multiprocess:
        crossed = iter(_across_processes(mesh, [t for t in out if t is not None]))
        out = [None if t is None else next(crossed) for t in out]
    like = shards[0]
    whole = [None if t is None else _unwords(t, l) for t, l in zip(out, like)]
    return type(like)(*whole) if hasattr(like, "_fields") else tuple(whole)


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
    steady kernel (the fill-free update).  Over several processes every
    process passes the same global tile and updates its own ranks'
    blocks only, copying only their rows."""
    fn = rank_update(ops, steady)
    n_local = len(mesh.local_ranks)

    def call(shards, batch, *extra):
        if len(shards) != n_local:
            raise ValueError(f"expected {n_local} shards, got {len(shards)}")
        parts = [split_rows(batch, mesh, axis)] + [split_rows(e, mesh, axis) for e in extra]
        return [fn(st, *args) for st, *args in zip(shards, *parts)]

    return call


def _words(t: torch.Tensor) -> torch.Tensor:
    """A leaf as 4-byte signed words, rows kept: an 8-byte ``[n, ...]``
    leaf as an int32 ``[n, 2 * ...]`` view, a uint32 leaf as its int32 view
    (the all-gather moves 4-byte leaves; torch's CPU ``cat`` takes no
    uint32)."""
    t = t.contiguous()
    if t.dtype.itemsize == 8:
        return t.view(torch.int32).view(t.shape[0], -1)
    if t.dtype == torch.uint32:
        return t.view(torch.int32)
    return t


def _unwords(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_words` for a gathered leaf of ``like``'s
    dtype and trailing shape."""
    if like.dtype.itemsize == 8:
        return w.view(like.dtype).view((w.shape[0],) + tuple(like.shape[1:]))
    return w.view(like.dtype)


def _across_processes(mesh: Mesh, leaves: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """This process's ranks' rows of each 4-byte leaf (``[n_local * b,
    ...]``, rank order, on one device) as every rank's rows, gathered over
    the group in one ``all_gather`` of the leaves packed into one int32
    buffer a process (padded to the largest process's).  The group's
    backend moves the buffer: gloo takes CPU and card tensors, NCCL card
    tensors."""
    import torch.distributed as dist

    world = dist.get_world_size()
    held = [mesh.owners.count(p) for p in range(world)]
    n_local = held[mesh.process]
    b = int(leaves[0].shape[0]) // n_local
    rows = [int(np.prod(t.shape[1:], dtype=np.int64)) for t in leaves]  # words a row, each leaf
    flat = torch.cat([t.reshape(-1).view(torch.int32) for t in leaves])
    width = b * sum(rows)  # words a rank
    buf = flat
    if max(held) * width != flat.numel():  # processes that hold fewer ranks pad
        buf = torch.zeros(max(held) * width, dtype=torch.int32, device=flat.device)
        buf[:flat.numel()] = flat
    parts = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(parts, buf)
    # each process's buffer holds its ranks' rows leaf by leaf
    blocks = []  # blocks[p][i]: leaf i of process p, [held[p] * b, ...]
    for p, part in enumerate(parts):
        sizes = [held[p] * b * r for r in rows]
        pieces = part[:sum(sizes)].split(sizes)
        blocks.append([x.view((held[p] * b,) + tuple(t.shape[1:])) for x, t in zip(pieces, leaves)])
    out = []
    for i, t in enumerate(leaves):
        seen = [0] * world
        chunks = []
        for p in mesh.owners:  # global rank order
            chunks.append(blocks[p][i][seen[p] * b:(seen[p] + 1) * b])
            seen[p] += 1
        out.append(torch.cat(chunks).view(t.dtype))
    return tuple(out)


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
    entry a rank this process owns, on that rank's device: the ``[R, k]``
    samples and ``[R]`` sizes of the mode's ``result`` in row order, and
    the total count.  One call of the all-gather kernel (one launch a card)
    moves every local rank's samples, sizes and counts to every local
    rank; 8-byte leaves travel as int32 word pairs.  CPU ranks run the
    plain gather.  Over several processes the first local rank's gather
    then crosses the group in one ``all_gather`` (a collective: every
    process calls it), and every local rank takes its own copy of the
    whole result, as the reference's replicated output gives every
    process the whole matrix.

    ``total`` has the reference's dtype: the int32 sum of int32 counts,
    wrapped as ``jnp.sum`` wraps it; with WIDE counts the float32 sum of
    ``u64e.to_f32`` of each count, whose value depends on the order of the
    float32 additions (torch's reduction is not XLA's), so it equals the
    reference's only to float32 rounding."""
    local = mesh.local_devices
    comm = RingCommunicator(local)

    def call(shards):
        if len(shards) != len(local):
            raise ValueError(f"expected {len(local)} shards, got {len(shards)}")
        leaves = [(*ops.result(st), st.count) for st in shards]
        gathered = gather_parts([tuple(_words(t) for t in part) for part in leaves], comm)
        if mesh.multiprocess:
            whole = _across_processes(mesh, gathered[0])
            gathered = [whole] + [tuple(t.to(d, copy=True) for t in whole) for d in local[1:]]
        like = leaves[0]
        samples, sizes, totals = [], [], []
        for got in gathered:
            s, z, c = (_unwords(w, t) for w, t in zip(got, like))
            samples.append(s)
            sizes.append(z)
            totals.append(_total(c))
        return samples, sizes, totals

    return call
