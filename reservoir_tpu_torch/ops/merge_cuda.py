"""The all-gather of the reservoir merge as a hand-written CUDA kernel.

Replaces the JAX package's Pallas TPU kernel
(``reservoir_tpu/ops/merge_pallas.py:_ring_kernel``, entry points
``ring_all_gather`` and ``gather_parts``).  The kernel source is
``csrc/merge_ring.cu``: every card reads each rank's blocks once and
stores them into the output of each of its ranks, the blocks on its own
card through the bulk copy engine (a tile at a time into shared memory,
one bulk store a rank), another card's through peer pointers, 16 bytes a
thread; the ranks synchronise by epoch-counting flags in device memory.
Its note says what bounds it on an H100.

A **rank** is a torch device.  The ranks of a :class:`RingCommunicator` may
name one card more than once (as XLA's virtual host devices let the JAX
package's CPU tests run a d-device merge on one host): the kernel takes
peer pointers and does not care on which card a pointer lives, so d ranks
on one H100 and d H100s over NVLink run the same code, one launch a card.

:func:`gather_parts` takes, for each rank, the tuple of its state leaves
``[b, ...]`` (4-byte dtypes) and returns, for each rank, the leaves
gathered over all ranks ``[d * b, ...]`` in rank-major part order.
:func:`ring_all_gather` is the one-leaf form on ``[b, W]`` blocks, giving
``[d, b, W]``.  Nothing is packed: one launch walks every leaf in place.

- on CUDA tensors they launch the kernel or raise (a failed build, a
  refused launch); a wait that timed out inside the kernel raises from
  :meth:`RingCommunicator.check`, which callers run when they next
  synchronise;
- on CPU tensors they run the plain versions
  (:func:`gather_parts_plain`, :func:`ring_all_gather_plain`).

:data:`launches` counts kernel launches (one a card and call), and nothing
else.  :func:`launcher` makes every argument of a call beforehand, so that
the kernel's own time can be taken apart from the wrapper's host work.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

__all__ = [
    "launches",
    "MAX_RANKS",
    "MAX_LEAVES",
    "RingCommunicator",
    "ring_all_gather",
    "gather_parts",
    "ring_all_gather_plain",
    "gather_parts_plain",
    "launcher",
    "kernel_info",
]

#: kernel launches so far (set it to 0 to count a run)
launches = 0

#: the kernel's limits (``csrc/merge_ring.cu``: kMaxRanks, kMaxLeaves, kThreads)
MAX_RANKS = 16
MAX_LEAVES = 8
_THREADS = 256
#: 16-byte words a thread moves before the grid grows no further
_VECTORS_PER_THREAD = 4
#: leaf layouts a communicator keeps the launch arguments of
_LAYOUTS_KEPT = 64

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_lib = None

_STATUS = {
    1: "a peer rank never entered the call",
    2: "the peer ranks never finished reading",
    3: "a bulk copy of a tile never completed",
}


def _library(path: Optional[str] = None):
    """The kernel's library: the checkout's build, or with ``path`` another
    build of the same C entry points (``kernel_ab.py``)."""
    global _lib
    if _lib is None or path is not None:
        if path is None:
            from .._build import load

            lib = load("merge_ring")
        else:
            lib = ctypes.CDLL(path)
        lib.merge_ring_gather.argtypes = [_VP] * 5 + [_INT] * 3 + [ctypes.c_uint, _INT, _INT, _VP]
        lib.merge_ring_gather.restype = _INT
        lib.merge_ring_max_blocks.argtypes = [_INT, ctypes.POINTER(_INT)]
        lib.merge_ring_max_blocks.restype = _INT
        lib.merge_ring_enable_peers.argtypes = [_VP, _INT]
        lib.merge_ring_enable_peers.restype = _INT
        lib.merge_ring_error_string.argtypes = [_INT]
        lib.merge_ring_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def kernel_info() -> dict:
    """:func:`~._cuda_common.build_info` of the gather kernel (needs a
    card)."""
    from ._cuda_common import build_info

    return build_info(_library().merge_ring_kernel_info)


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        msg = _library().merge_ring_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


class _Layout(NamedTuple):
    """A communicator's launch arguments for one layout of leaves."""

    cards: list  # (card, local ranks as a ctypes array, their count, blocks_y) a card
    n: object  # ctypes array: the words of one block of each leaf
    flags: object  # ctypes array: each rank's flag words
    pieces: list  # the int32 words a rank's output allocation splits into
    leaves: list  # each gathered leaf's piece, and its dtype and shape where they are not the piece's


class RingCommunicator:
    """The ranks of an all-gather and, for CUDA ranks, their flag words.

    Args:
      devices: one torch device a rank, all CPU or all CUDA; a card may be
        named more than once.

    A communicator is used by one stream a card at a time.  After a timeout
    inside the kernel (:meth:`check` raises) it is not to be used again.
    """

    def __init__(self, devices: Sequence[object]) -> None:
        ranks = [torch.device(d) for d in devices]
        if not 1 <= len(ranks) <= MAX_RANKS:
            raise ValueError(f"an all-gather takes 1 to {MAX_RANKS} ranks, got {len(ranks)}")
        kinds = {r.type for r in ranks}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(f"ranks must be all CPU or all CUDA devices, got {ranks}")
        self.on_cuda = kinds == {"cuda"}
        if self.on_cuda:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device is available; pass CPU ranks to run the plain "
                    "torch version on the CPU"
                )
            ranks = [r if r.index is not None else torch.device("cuda", torch.cuda.current_device())
                     for r in ranks]
        self.ranks: List[torch.device] = ranks
        self.epoch = 0
        self._flags: Optional[List[torch.Tensor]] = None
        self._max_blocks: Dict[int, int] = {}
        #: per leaf layout (each leaf's dtype and shape): each card's
        #: launch arguments but the pointers and the stream
        self._layouts: Dict[tuple, _Layout] = {}

    @property
    def size(self) -> int:
        return len(self.ranks)

    def flags(self) -> List[torch.Tensor]:
        """One int32 ``[4]`` tensor a rank on its card: entered, done, status,
        arrivals.  Made at first use, which also opens peer access between
        the cards and asks each for its resident-block limit."""
        if self._flags is None:
            lib = _library()
            cards = sorted({r.index for r in self.ranks})
            if len(cards) > 1:
                arr = (_INT * len(cards))(*cards)
                _raise_on(lib.merge_ring_enable_peers(arr, len(cards)), "enabling peer access")
            for card in cards:
                out = _INT(0)
                _raise_on(lib.merge_ring_max_blocks(card, ctypes.byref(out)), "the occupancy query")
                self._max_blocks[card] = out.value
            self._flags = [torch.zeros(4, dtype=torch.int32, device=r) for r in self.ranks]
        return self._flags

    def _layout(self, like: Tuple[Tuple[torch.dtype, torch.Size], ...]) -> "_Layout":
        """What a call over leaves of ``like`` (each leaf's dtype and
        shape) launches with, but the pointers and the stream, and its
        outputs' shapes; made once a layout."""
        layout = self._layouts.get(like)
        if layout is None:
            flags = self.flags()
            d = self.size
            words = [shape.numel() for _, shape in like]
            by_card: Dict[int, List[int]] = {}
            for r, rank in enumerate(self.ranks):
                by_card.setdefault(rank.index, []).append(r)
            # a card's blocks share the reads of all d source blocks
            want = -(-(d * sum(words) // 4) // (_THREADS * _VECTORS_PER_THREAD))
            layout = _Layout(
                cards=[(card, (_INT * len(local))(*local), len(local),
                        max(1, min(-(-want // len(local)), self._max_blocks[card] // len(local))))
                       for card, local in by_card.items()],
                n=(ctypes.c_longlong * len(words))(*words),
                flags=(_VP * d)(*(f.data_ptr() for f in flags)),
                pieces=[],
                leaves=[],
            )
            # a rank's outputs: one allocation, each leaf's words from a
            # 16-byte boundary (a piece of padding after a leaf that ends
            # off it)
            for (dtype, shape), w in zip(like, words):
                layout.leaves.append((len(layout.pieces), dtype if dtype != torch.int32 else None,
                                      (d * shape[0],) + tuple(shape[1:]) if len(shape) > 1 else None))
                layout.pieces.append(d * w)
                if d * w % 4:
                    layout.pieces.append(4 - d * w % 4)
            if len(self._layouts) >= _LAYOUTS_KEPT:
                self._layouts.clear()
            self._layouts[like] = layout
        return layout

    def check(self) -> None:
        """Raise if a rank's wait timed out in any call so far.  Reads the
        status words, so it waits for the ranks' streams."""
        if self._flags is None:
            return
        for r, f in enumerate(self._flags):
            status = int(f[2].item())
            if status:
                raise RuntimeError(
                    f"all-gather rank {r} on {self.ranks[r]} timed out: "
                    f"{_STATUS.get(status, f'status {status}')}"
                )


Leaves = Sequence[torch.Tensor]


def _check_leaves(rank_leaves: Sequence[Leaves], comm: RingCommunicator) -> tuple:
    """What the wrapper checks before any pointer crosses to CUDA: one tuple
    of leaves a rank, each leaf on its rank's device, contiguous, of a 4-byte
    dtype, and of one shape and dtype over the ranks.  Returns the leaves'
    ``(dtype, shape)``."""
    if len(rank_leaves) != comm.size:
        raise ValueError(f"expected leaves for {comm.size} ranks, got {len(rank_leaves)}")
    first = rank_leaves[0]
    if not 1 <= len(first) <= MAX_LEAVES:
        raise ValueError(f"a part has 1 to {MAX_LEAVES} leaves, got {len(first)}")
    like = tuple((leaf.dtype, leaf.shape) for leaf in first)
    for dtype, shape in like:
        if dtype.itemsize != 4:
            raise ValueError(f"gather_parts moves 4-byte leaves only, got {dtype}")
        if len(shape) < 1:
            raise ValueError("gather_parts moves leaves of at least one dimension, got a scalar")
    for r, (leaves, rank) in enumerate(zip(rank_leaves, comm.ranks)):
        if len(leaves) != len(first):
            raise ValueError(f"rank {r} has {len(leaves)} leaves, rank 0 has {len(first)}")
        for i, (leaf, (dtype, shape)) in enumerate(zip(leaves, like)):
            if leaf.dtype != dtype or leaf.shape != shape:
                raise ValueError(
                    f"leaf {i} of rank {r} is {leaf.dtype} {tuple(leaf.shape)}, "
                    f"rank 0's is {dtype} {tuple(shape)}"
                )
            dev = leaf.device
            if dev != rank and (dev.type != rank.type or dev.type == "cuda"):
                raise ValueError(f"leaf {i} of rank {r} is on {dev}, the rank on {rank}")
            if not leaf.is_contiguous():
                raise ValueError(f"leaf {i} of rank {r} must be contiguous")
    return like


def gather_parts_plain(rank_leaves: Sequence[Leaves], comm: RingCommunicator) -> List[Tuple[torch.Tensor, ...]]:
    """The plain torch version of :func:`gather_parts`: for each rank, each
    leaf's blocks moved to the rank and concatenated in rank order."""
    _check_leaves(rank_leaves, comm)
    return [
        tuple(torch.cat([leaves[i].to(rank) for leaves in rank_leaves], 0)
              for i in range(len(rank_leaves[0])))
        for rank in comm.ranks
    ]


def ring_all_gather_plain(blocks: Sequence[torch.Tensor], comm: RingCommunicator) -> List[torch.Tensor]:
    """The plain torch version of :func:`ring_all_gather`: ``torch.stack`` of
    the blocks on each rank."""
    _check_leaves([(b,) for b in blocks], comm)
    return [torch.stack([b.to(rank) for b in blocks]) for rank in comm.ranks]


def _like(rank_leaves: Sequence[Leaves]) -> tuple:
    return tuple((leaf.dtype, leaf.shape) for leaf in rank_leaves[0])


def launcher(rank_leaves: Sequence[Leaves], outs: Sequence[Leaves], comm: RingCommunicator, like=None):
    """A call that launches the kernel once a card (a new epoch each call),
    from ``rank_leaves`` into ``outs`` (each rank's ``[d * b, ...]`` leaves,
    as :func:`gather_parts` returns them), with every argument but the
    stream made beforehand: the bare launch, for timing it apart from the
    wrapper.  The leaves are not checked here (:func:`gather_parts` does)."""
    lib = _library()
    d, n_leaves = comm.size, len(rank_leaves[0])
    layout = comm._layout(like or _like(rank_leaves))
    src = (_VP * (n_leaves * d))(*(rank_leaves[q][i].data_ptr() for i in range(n_leaves) for q in range(d)))
    dst = (_VP * (n_leaves * d))(*(outs[r][i].data_ptr() for i in range(n_leaves) for r in range(d)))

    def launch() -> None:
        global launches
        comm.epoch += 1
        for card, local, n_local, blocks_y in layout.cards:
            code = lib.merge_ring_gather(
                src, dst, layout.n, layout.flags, local, n_local, d, n_leaves, comm.epoch & 0xFFFFFFFF, card,
                blocks_y, torch.cuda.current_stream(card).cuda_stream,
            )
            _raise_on(code, f"merge_ring_gather launch on cuda:{card}")
            launches += 1

    return launch


def _outputs(rank_leaves: Sequence[Leaves], comm: RingCommunicator, like=None) -> List[Tuple[torch.Tensor, ...]]:
    """Each rank's ``[d * b, ...]`` output leaves, views of one allocation
    a rank: one ``torch.empty`` and one split a rank cost the host less
    than one ``torch.empty`` a leaf."""
    layout = comm._layout(like or _like(rank_leaves))
    outs = []
    for rank in comm.ranks:
        pieces = torch.empty(sum(layout.pieces), dtype=torch.int32, device=rank).split_with_sizes(layout.pieces)
        leaves = []
        for i, dtype, shape in layout.leaves:
            out = pieces[i] if dtype is None else pieces[i].view(dtype)
            leaves.append(out if shape is None else out.view(shape))
        outs.append(tuple(leaves))
    return outs


def gather_parts(
    rank_leaves: Sequence[Leaves], comm: Optional[RingCommunicator] = None
) -> List[Tuple[torch.Tensor, ...]]:
    """All-gather every state leaf over the ranks in one launch a card.

    ``rank_leaves[r]`` is rank r's tuple of leaves ``[b, ...]`` on its
    device.  Returns, for each rank, the tuple of gathered leaves
    ``[d * b, ...]`` on that rank's device, rank-major (rank q's rows are
    ``q * b .. (q + 1) * b - 1``).  Without ``comm``, the ranks are the
    devices the leaves lie on."""
    if comm is None:
        comm = RingCommunicator([leaves[0].device for leaves in rank_leaves])
    if not comm.on_cuda:
        return gather_parts_plain(rank_leaves, comm)
    like = _check_leaves(rank_leaves, comm)
    outs = _outputs(rank_leaves, comm, like)
    launcher(rank_leaves, outs, comm, like)()
    return outs


def ring_all_gather(
    blocks: Sequence[torch.Tensor], comm: Optional[RingCommunicator] = None
) -> List[torch.Tensor]:
    """All-gather one ``[b, W]`` block of 4-byte words a rank: returns, for
    each rank, ``[d, b, W]`` on its device with slot ``q`` holding rank q's
    block."""
    for b in blocks:
        if b.ndim != 2:
            raise ValueError(f"ring_all_gather takes [b, W] blocks, got {tuple(b.shape)}")
    gathered = gather_parts([(b,) for b in blocks], comm)
    d = len(blocks)
    return [g[0].view((d,) + tuple(blocks[0].shape)) for g in gathered]
