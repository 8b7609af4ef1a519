"""Stream-axis parallelism: one logical stream sharded across ranks.

The port of the JAX package's ``parallel/merge.py``.  Several shards sample
parts of one logical stream independently (nothing is exchanged in the hot
loop); their reservoirs are then combined into one exact sample:

- uniform (Algorithm L): the hypergeometric pairwise merge
  (:func:`~reservoir_tpu_torch.ops.algorithm_l.merge_samples`);
- weighted: the top-k union of the log keys
  (:func:`~reservoir_tpu_torch.ops.weighted.merge_parts`);
- distinct: the bottom-k union of the hashes, shards sharing salts
  (:func:`~reservoir_tpu_torch.ops.distinct.merge`).

The parts are combined by a deterministic log-depth tree of pairwise
merges: items pair up left to right, an odd item is carried up unmerged,
and the uniform merge of the n-th pair (counted from 1 over the whole tree)
draws from ``fold_in(key, n)``.  For a fixed key and part order the result
is the JAX package's, bit for bit.  The pairs of one level are independent,
so a level runs as **one** batched pairwise call, each row under the key
its own pair's call would have given it.

Between ranks the part state moves by the all-gather kernel of
:mod:`~reservoir_tpu_torch.ops.merge_cuda` and by nothing else.  A rank is
a torch device, and a card may be named more than once; the tree then runs
once, on the first rank's gathered copy (every rank holds the same words).
There is no demotion: a build, launch or barrier failure raises.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..convert import resolve_device
from ..ops import algorithm_l as _algl
from ..ops import distinct as _distinct
from ..ops import weighted as _weighted
from ..ops.merge_cuda import RingCommunicator, gather_parts
from ..ops.rng import key_from_seed, split_keys
from ..ops.threefry import fold_in_words

__all__ = [
    "uniform_stream_merger",
    "distinct_stream_merger",
    "weighted_stream_merger",
    "merge_samples_host",
    "merge_samples_device",
]

_MODES = ("uniform", "weighted", "distinct")
_IMPLS = ("auto", "cuda", "host")
#: leaves of one part in each mode
_N_LEAVES = {"uniform": 2, "weighted": 3, "distinct": 6}

Leaves = Tuple[torch.Tensor, ...]
#: ``pairwise(a, b, first_node, pairs)``: the merge of ``pairs`` stacked pairs
Pairwise = Callable[[Leaves, Leaves, int, int], Leaves]


def _key_words(key, device) -> torch.Tensor:
    """An int seed (the words of ``jr.key(seed)``) or ``[2]`` uint32 key
    words as an int64 ``[2]`` tensor on ``device``."""
    if key is None:
        raise ValueError("uniform mode requires a merge key")
    if isinstance(key, int):
        return key_from_seed(key, device=device)
    if isinstance(key, torch.Tensor):
        words = key.to(torch.int64)
    else:
        words = torch.from_numpy(np.asarray(key, np.uint32).astype(np.int64))
    if words.shape != (2,):
        raise ValueError(f"key words must have shape (2,), got {tuple(words.shape)}")
    return words.to(device)


def _uniform_pairwise(key_words: torch.Tensor) -> Pairwise:
    """The uniform pairwise merge of a level, over the leaves ``(samples,
    count, signed)``: ``signed`` (bool) marks a count that the merge reads
    as int32, as the JAX package's tree passes an input's int32 count (past
    2^31 - 1 it is negative); a merged count is uint32.  WIDE ``[.., 2]``
    counts are unsigned 64-bit words, whose merged counts stay WIDE."""

    def pairwise(a: Leaves, b: Leaves, first_node: int, pairs: int) -> Leaves:
        rows = a[0].shape[0] // pairs
        nodes = torch.arange(first_node, first_node + pairs, dtype=torch.int32, device=key_words.device)
        f1, f2 = fold_in_words(key_words[0], key_words[1], nodes)
        row_keys = split_keys(torch.stack([f1, f2], dim=1), rows).reshape(pairs * rows, 2)
        signed = None if a[1].ndim == 2 else a[2].to(torch.uint8) | (b[2].to(torch.uint8) << 1)
        samples, count = _algl.merge_samples_keyed(a[0], a[1], b[0], b[1], row_keys, signed)
        # the tree carries the uint32 count as its int32 bits
        return samples, count.view(torch.int32), torch.zeros_like(a[2])

    return pairwise


def _weighted_pairwise(a: Leaves, b: Leaves, first_node: int, pairs: int) -> Leaves:
    return _weighted.merge_parts(*a, *b)


def _distinct_pairwise(a: Leaves, b: Leaves, first_node: int, pairs: int) -> Leaves:
    # leaves (values, hash_hi, hash_lo, size, count, salts): salts are
    # shared (one init key), A's are carried
    m = _distinct.merge(_distinct.DistinctState(*a), _distinct.DistinctState(*b))
    return m.values, m.hash_hi, m.hash_lo, m.size, m.count, m.salts


def _merge_tree(items: Leaves, pairwise: Pairwise) -> Leaves:
    """The node-numbered log-depth tree over ``n`` items of ``R`` rows each
    (leaves ``[n, R, ...]``), a level as one batched pairwise call; returns
    the root's leaves ``[R, ...]``."""
    n, rows = items[0].shape[:2]
    node = 0
    while n > 1:
        pairs = n // 2
        a = tuple(x[0 : 2 * pairs : 2].flatten(0, 1) for x in items)
        b = tuple(x[1 : 2 * pairs : 2].flatten(0, 1) for x in items)
        merged = tuple(m.unflatten(0, (pairs, rows)) for m in pairwise(a, b, node + 1, pairs))
        node += pairs
        if n % 2:  # an odd item is carried up unmerged
            merged = tuple(torch.cat([m, x[-1:]]) for m, x in zip(merged, items))
        items = merged
        n = pairs + n % 2
    return tuple(x[0] for x in items)


def _tree_for(mode: str, items: Leaves, key_words: Optional[torch.Tensor]) -> Leaves:
    """The merge tree of ``mode`` over stacked items.  Inside the tree every
    uint32 leaf (samples, the uniform count) rides as its int32 bits."""
    dtypes = [x.dtype for x in items]
    items = tuple(x.view(torch.int32) if x.dtype == torch.uint32 else x for x in items)
    if mode == "uniform":
        signed = torch.full(items[1].shape[:2], dtypes[1] == torch.int32, device=items[1].device)
        out = _merge_tree(items + (signed,), _uniform_pairwise(key_words))[:2]
        dtypes[1] = torch.uint32  # the merged count cannot wrap below 2^32
    else:
        out = _merge_tree(items, _weighted_pairwise if mode == "weighted" else _distinct_pairwise)
    return tuple(x.view(dt) if dt == torch.uint32 else x for x, dt in zip(out, dtypes))


# ------------------------------------------------------- parts from the host


def _uniform_leaves(parts, k: int) -> Tuple[np.ndarray, np.ndarray]:
    dtype = np.asarray(parts[0][0]).dtype
    if dtype not in (np.int32, np.float32, np.uint32):
        raise ValueError(f"samples must be int32, float32 or uint32 words, got {dtype}")
    rows = np.zeros((len(parts), k), dtype)
    counts = np.zeros((len(parts),), np.uint32)
    for p, (sample, count) in enumerate(parts):
        s = np.atleast_1d(np.asarray(sample, dtype))[:k]
        rows[p, : s.shape[0]] = s
        if not 0 <= int(count) < 2**32:
            # the reference lifts each count to uint32 and overflows there
            raise OverflowError(
                f"part {p}: count {int(count)} does not fit the host merge's uint32 counts; "
                "merge WIDE [D, R, 2] counts with uniform_stream_merger"
            )
        counts[p] = int(count)
    return rows, counts


def _stack_state_rows(parts, k: int, mode: str) -> Tuple[np.ndarray, ...]:
    """Stack per-part state-row tuples into ``[P, ...]`` leaf arrays."""
    n_leaves = _N_LEAVES[mode]
    cols: List[list] = [[] for _ in range(n_leaves)]
    for p, part in enumerate(parts):
        if len(part) != n_leaves:
            raise ValueError(
                f"{mode} parts take {n_leaves}-tuples, got {len(part)} fields in part {p}"
            )
        for i, field in enumerate(part):
            arr = np.asarray(field)
            if arr.ndim == 1 and arr.shape[0] not in (k, 4):
                raise ValueError(
                    f"part {p} field {i} must be [{k}]-wide state rows, got shape {arr.shape}"
                )
            cols[i].append(arr)
    return tuple(np.stack(col) for col in cols)


def _to_torch(leaf: np.ndarray, mode: str, index: int) -> torch.Tensor:
    """A stacked numpy leaf as the tensor the port's merges take: 4-byte
    words throughout; a distinct state's hash planes and salts (uint32 in
    the JAX package) as int32 bit patterns."""
    if leaf.dtype.itemsize != 4:
        leaf = leaf.astype(np.int32 if leaf.dtype.kind in "iu" else np.float32)
    if mode == "distinct" and index in (1, 2, 5):
        leaf = leaf.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(leaf))


def _host_result(mode: str, out: Leaves, k: int):
    """The root's leaves as the host values :func:`merge_samples_device`
    returns."""
    out = [x.cpu().numpy() for x in out]
    if mode == "uniform":
        total = int(out[1][0])
        return out[0][0, : min(total, k)], total
    if mode == "weighted":
        return out[0][0], out[1][0], int(out[2][0])
    return (out[0][0], out[1][0].view(np.uint32), out[2][0].view(np.uint32),
            int(out[3][0]), int(out[4][0]))


def _resolve_ranks(devices: Optional[Sequence[object]], n_parts: int) -> List[torch.device]:
    """The ranks of a merge of ``n_parts`` parts: ``devices`` (default:
    every visible card), cut to ``min(len(devices), n_parts)``."""
    if devices is None:
        resolve_device(None)  # raises without a card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    ranks = [resolve_device(d) for d in devices]
    if not ranks:
        raise ValueError("devices must name at least one rank")
    return ranks[: min(len(ranks), n_parts)]


def merge_samples_host(
    parts: Sequence[Tuple[np.ndarray, int]],
    key,
    *,
    max_sample_size: int,
) -> Tuple[np.ndarray, int]:
    """Host-side log-depth tree merge of per-shard uniform samples.

    Args:
      parts: ``(sample, count)`` pairs: each sample a 1-D array already cut
        to its fill, each count that shard's total stream length.
      key: an int seed or ``[2]`` uint32 key words for the merge draws.
      max_sample_size: the configurations' ``k``.

    Returns ``(merged_sample, total_count)``, the merged sample cut to its
    size ``min(total_count, k)``.  Runs on the CPU; bit-identical to
    :func:`merge_samples_device` on any ranks."""
    if not parts:
        raise ValueError("merge_samples_host needs at least one part")
    return merge_samples_device(parts, key, max_sample_size=max_sample_size, impl="host")


def merge_samples_device(
    parts,
    key=None,
    *,
    max_sample_size: int,
    mode: str = "uniform",
    impl: str = "auto",
    devices: Optional[Sequence[object]] = None,
):
    """The merge tree over parts that are spread over ranks: the parts are
    dealt to the ranks in contiguous blocks (padded to a multiple of the
    number of ranks), all-gathered by the kernel, and merged on the first
    rank.

    Args:
      parts: per mode,

        - ``"uniform"``: ``(sample, count)`` pairs as
          :func:`merge_samples_host` takes;
        - ``"weighted"``: ``(samples [k], lkeys [k], count)`` rows of a
          ``WeightedState`` (empty slots at ``-inf``);
        - ``"distinct"``: ``(values [k], hash_hi [k], hash_lo [k], size,
          count, salts [4])`` rows of a narrow ``DistinctState``; all parts
          share salts.
      key: an int seed or ``[2]`` uint32 key words (uniform mode only).
      max_sample_size: the configurations' ``k``.
      mode: ``"uniform"`` | ``"weighted"`` | ``"distinct"``.
      impl: ``"auto"`` (the kernel on CUDA ranks, the plain gather on CPU
        ranks), ``"cuda"`` (CUDA ranks or an error), ``"host"`` (the tree on
        the CPU, no ranks).  A single part has nothing to gather and takes
        the host tree, once its ranks are resolved (so without a card and
        without ``devices`` it raises as any other call does).
      devices: the ranks, one torch device each, repeats allowed; default
        every visible card.  ``min(len(devices), len(parts))`` are used.

    Returns host values: uniform ``(merged_sample, total)``; weighted
    ``(samples [k], lkeys [k], total)``; distinct ``(values [k], hash_hi
    [k], hash_lo [k], size, total)``."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    parts = list(parts)
    if not parts:
        raise ValueError("merge_samples_device needs at least one part")
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of 'auto'|'cuda'|'host', got {impl!r}")
    k = int(max_sample_size)
    if mode == "uniform":
        if key is None:
            raise ValueError("uniform mode requires a merge key")
        host = _uniform_leaves(parts, k)
    else:
        host = _stack_state_rows(parts, k, mode)
    n_parts = len(parts)
    if impl != "host":  # a single part too names its ranks: no card, no silent CPU run
        ranks = _resolve_ranks(devices, n_parts)
        comm = RingCommunicator(ranks)
        if impl == "cuda" and not comm.on_cuda:
            raise ValueError(f"impl='cuda' needs CUDA ranks, got {ranks}")
    if impl == "host" or n_parts == 1:
        items = tuple(_to_torch(leaf, mode, i).unsqueeze(1) for i, leaf in enumerate(host))
        words = _key_words(key, "cpu") if mode == "uniform" else None
        return _host_result(mode, _tree_for(mode, items, words), k)

    d = comm.size
    block = -(-n_parts // d)  # parts a rank
    pad = block * d - n_parts
    if pad:  # rows past n_parts are layout padding
        host = tuple(np.pad(leaf, ((0, pad),) + ((0, 0),) * (leaf.ndim - 1)) for leaf in host)
    leaves = tuple(_to_torch(leaf, mode, i) for i, leaf in enumerate(host))
    rank_leaves = [
        tuple(x[r * block : (r + 1) * block].to(rank) for x in leaves) for r, rank in enumerate(ranks)
    ]
    gathered = gather_parts(rank_leaves, comm)[0]
    items = tuple(g[:n_parts].unsqueeze(1) for g in gathered)
    words = _key_words(key, ranks[0]) if mode == "uniform" else None
    out = _host_result(mode, _tree_for(mode, items, words), k)
    comm.check()
    return out


# ------------------------------------------------------------ stream mergers

Stacked = Union[torch.Tensor, Sequence[torch.Tensor]]


def _rank_leaves(stacked: Sequence[Stacked]) -> List[Leaves]:
    """Per-rank leaf tuples from stacked leaves: each leaf a ``[D, R, ...]``
    tensor (rank r holds ``leaf[r]``, all on the tensor's device) or a
    sequence of D ``[R, ...]`` tensors, each on its rank's device."""
    sizes = {len(leaf) for leaf in stacked}
    if len(sizes) != 1:
        raise ValueError(f"every leaf must stack the same number of shards, got {sorted(sizes)}")
    (n_shards,) = sizes
    if n_shards < 1:
        raise ValueError("a stream merger needs at least one shard")
    return [tuple(leaf[r].contiguous() for leaf in stacked) for r in range(n_shards)]


def _stream_merge(mode: str, stacked: Sequence[Stacked], key=None) -> Leaves:
    rank_leaves = _rank_leaves(stacked)
    n_shards = len(rank_leaves)
    comm = RingCommunicator([leaves[0].device for leaves in rank_leaves])
    gathered = gather_parts(rank_leaves, comm)[0]
    items = tuple(g.unflatten(0, (n_shards, g.shape[0] // n_shards)) for g in gathered)
    words = _key_words(key, comm.ranks[0]) if mode == "uniform" else None
    out = _tree_for(mode, items, words)
    comm.check()
    return out


def uniform_stream_merger(samples: Stacked, count: Stacked, key) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard Algorithm-L results ``(samples [D, R, k], count
    [D, R])`` into one logical sample ``(samples [R, k], count [R]
    uint32)`` on the first shard's device; WIDE counts ``[D, R, 2]`` merge
    exactly at any magnitude into WIDE ``[R, 2]`` totals.  Each argument is
    one stacked tensor (the D shards are ranks on its device) or a sequence
    of D per-shard tensors, each on its own rank's device; ``key`` is an
    int seed or ``[2]`` uint32 key words."""
    return _stream_merge("uniform", (samples, count), key)


def weighted_stream_merger(samples: Stacked, lkeys: Stacked, count: Stacked) -> Leaves:
    """Merge stacked per-shard weighted results ``(samples, lkeys, count)``:
    the top k of the union, on the first shard's device."""
    return _stream_merge("weighted", (samples, lkeys, count))


def distinct_stream_merger(
    values: Stacked, hash_hi: Stacked, hash_lo: Stacked, size: Stacked, count: Stacked, salts: Stacked
) -> Leaves:
    """Merge stacked per-shard narrow ``DistinctState`` leaves ``(values,
    hash_hi, hash_lo, size, count, salts)`` (salts shared across shards):
    returns the merged leaves, the first shard's salts carried."""
    return _stream_merge("distinct", (values, hash_hi, hash_lo, size, count, salts))
