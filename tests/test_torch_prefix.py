"""The port's blocked prefix sum against the JAX package's, bit for bit:
``reservoir_tpu_torch.ops.prefix`` against ``reservoir_tpu.ops.prefix`` on
float sums that are not exact (lognormal weights), across ragged and whole
128-lane blocks, with and without a carry, and on denormal inputs (which
XLA CPU reads as zero)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reservoir_tpu.ops import prefix as JP
from reservoir_tpu_torch.ops import prefix as TP

_J_CUMSUM = jax.jit(JP.lane_cumsum)
_J_CARRY = jax.jit(JP.lane_cumsum_carry)


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


def _weights(rng, shape):
    return rng.lognormal(0.0, 1.5, shape).astype(np.float32)


def test_the_association_block_is_the_reference_one():
    assert TP.CUMSUM_BLOCK == JP.CUMSUM_BLOCK == 128


@pytest.mark.parametrize("width", [1, 2, 127, 128, 200, 1024])
def test_lane_cumsum_equals_the_reference(width):
    x = _weights(np.random.default_rng(width), (16, width))
    want = _J_CUMSUM(jnp.asarray(x))
    got = TP.lane_cumsum(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))
    if width > 2:
        # the float sums are not exact: the association is what is pinned
        sequential = np.cumsum(x, axis=1, dtype=np.float32)
        assert not np.array_equal(_bits(got.numpy()), _bits(sequential))


@pytest.mark.parametrize("width", [1, 127, 128, 200, 256, 1024])
def test_lane_cumsum_carry_equals_the_reference(width):
    rng = np.random.default_rng(100 + width)
    x = _weights(rng, (8, width))
    carry = _weights(rng, (8, 1)) * 50.0
    want, want_c = _J_CARRY(jnp.asarray(x), jnp.asarray(carry))
    got, got_c = TP.lane_cumsum_carry(torch.from_numpy(x), torch.from_numpy(carry))
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))
    np.testing.assert_array_equal(_bits(want_c), _bits(got_c.numpy()))


def test_chunks_of_whole_blocks_continue_the_scan_exactly():
    # a scan cut into 128-multiple chunks, each continuing from the last
    # one's carry, is the whole scan bit for bit (the first chunk adds no
    # carry, as the whole scan's first block does not)
    x = torch.from_numpy(_weights(np.random.default_rng(7), (4, 512)))
    whole = TP.lane_cumsum(x)
    first, carry = TP.lane_cumsum_carry(x[:, :128], None)
    second, carry = TP.lane_cumsum_carry(x[:, 128:384], carry)
    third, _ = TP.lane_cumsum_carry(x[:, 384:], carry)
    pieces = torch.cat([first, second, third], dim=1)
    assert torch.equal(whole.view(torch.int32), pieces.view(torch.int32))


def test_denormal_inputs_read_as_zero_as_in_xla():
    rng = np.random.default_rng(9)
    x = _weights(rng, (8, 200))
    x[rng.random(x.shape) < 0.2] = np.float32(1e-40)
    x[:, 5] = np.float32(1.4e-45)
    x[0, :] = np.float32(3e-39)  # a row of nothing but denormals sums to 0
    want = _J_CUMSUM(jnp.asarray(x))
    got = TP.lane_cumsum(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))
    assert (got[0] == 0).all()
