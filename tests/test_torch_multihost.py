"""The port's process-group join (``parallel/multihost.py``) over
``torch.distributed``, with the JAX package's rules: a no-op without a
cluster, explicit or detected joins that fail in seconds, an idempotent
one-process join, and a real two-process gloo group over loopback that
all-reduces and runs the reservoir update on each process's rows, where
``make_mesh`` raises the L4 ``NotImplementedError``.

A process group is process-global, so every case runs in child processes,
each bounded by :data:`TIMEOUT` seconds."""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import pytest
import torch

from reservoir_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a child process may take
TIMEOUT = 60
#: what would make a no-argument join detect a cluster
_CLUSTER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK", "SLURM_JOB_ID",
                 "SLURM_PROCID", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
                 "TPU_WORKER_HOSTNAMES", "CLOUD_TPU_TASK_ID", "MEGASCALE_COORDINATOR_ADDRESS")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in _CLUSTER_VARS}
    env["PYTHONPATH"] = REPO
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _run(code: str, *args, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code, *map(str, args)], env=env or _env(), cwd=REPO,
                          capture_output=True, text=True, timeout=TIMEOUT)


_NOOP = """
import warnings
from reservoir_tpu_torch.parallel import make_mesh, multihost
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    assert multihost.initialize() is False
assert any(issubclass(w.category, RuntimeWarning) for w in caught), caught
assert not multihost.is_initialized() and multihost.group_size() == 1
assert make_mesh(devices=["cpu"] * 8).shape == {"res": 8}
print("OK")
"""


def test_initialize_is_a_no_op_without_a_cluster():
    proc = _run(_NOOP)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "OK" in proc.stdout


_BAD = """
import sys, time
from reservoir_tpu_torch.parallel import multihost
case, port = sys.argv[1], sys.argv[2]
t0 = time.perf_counter()
try:
    if case == "partial":
        multihost.initialize(num_processes=2)
    elif case == "no_peer":
        multihost.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=0, backend="gloo",
                             timeout=3)
    elif case == "nccl_without_card":
        multihost.initialize(f"127.0.0.1:{port}", num_processes=1, process_id=0)
    else:  # a detected environment whose rendezvous cannot complete
        multihost.initialize(backend="gloo", timeout=3)
except (RuntimeError, ValueError) as e:
    print("RAISED", type(e).__name__, round(time.perf_counter() - t0, 1))
else:
    print("JOINED")
assert not multihost.is_initialized()
"""


@pytest.mark.parametrize("case", ["partial", "no_peer", "nccl_without_card", "detected_env"])
def test_explicit_or_detected_joins_that_cannot_complete_raise_in_seconds(case):
    if case == "nccl_without_card" and torch.cuda.is_available():
        pytest.skip("this host has a card: nccl may join")
    port = _free_port()
    env = _env(RANK=1, WORLD_SIZE=2, MASTER_ADDR="127.0.0.1", MASTER_PORT=port) \
        if case == "detected_env" else _env()
    proc = _run(_BAD, case, port, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    words = proc.stdout.split()
    assert words[0] == "RAISED", proc.stdout
    assert float(words[2]) < 30


_ONE = """
import sys
import torch
import torch.distributed as dist
from reservoir_tpu_torch.parallel import make_mesh, multihost
port = sys.argv[1]
assert multihost.initialize(f"127.0.0.1:{port}", num_processes=1, process_id=0, backend="gloo",
                            timeout=30)
assert multihost.is_initialized() and multihost.group_size() == 1
assert multihost.initialize() is True                       # idempotent
assert multihost.initialize("127.0.0.1:1", 5, 3) is True    # never joins twice
x = torch.tensor([2.0])
dist.all_reduce(x)
assert float(x) == 2.0
assert make_mesh(devices=["cpu"] * 8).shape == {"res": 8}  # a group of one spans no other process
dist.destroy_process_group()
print("OK")
"""


def test_a_one_process_gloo_join_is_idempotent():
    proc = _run(_ONE, _free_port())
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "OK" in proc.stdout


# Each worker joins the 2-process group, all-reduces across it, and runs
# the reservoir update on its half of the rows; the halves, gathered over
# the group, must equal one full update run locally (the same
# deterministic init and tile everywhere).  A mesh would have to span both
# processes, which the port leaves out: make_mesh raises naming L4.
_TWO = """
import sys
import torch
import torch.distributed as dist
from reservoir_tpu_torch.ops import algorithm_l as al
from reservoir_tpu_torch.ops.rng import key_from_seed
from reservoir_tpu_torch.parallel import make_mesh, multihost
pid, port = int(sys.argv[1]), sys.argv[2]
assert multihost.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=pid, backend="gloo",
                            timeout=30)
assert multihost.group_size() == 2
x = torch.tensor([float(pid + 1)])
dist.all_reduce(x)
assert float(x) == 3.0, float(x)
for make in (lambda: make_mesh(), lambda: make_mesh(devices=["cpu"] * 2)):
    try:
        make()
    except NotImplementedError as e:
        assert "L4" in str(e) and "ROADMAP.md" in str(e), e
    else:
        raise AssertionError("make_mesh in a group of two did not raise")
R, k, B = 8, 4, 16
full = al.init(key_from_seed(0), R, k)
batch = (100 + torch.arange(R * B, dtype=torch.int32)).reshape(R, B)
ref = al.update(full, batch)
lo, hi = pid * (R // 2), (pid + 1) * (R // 2)
mine = al.update(type(full)(*(t[lo:hi].clone() for t in full)), batch[lo:hi].contiguous())
for name in ("samples", "count", "nxt", "log_w"):
    local = getattr(mine, name)
    parts = [torch.empty_like(local) for _ in range(2)]
    dist.all_gather(parts, local)
    assert torch.equal(torch.cat(parts), getattr(ref, name)), name
dist.destroy_process_group()
print("OK", pid)
"""


def test_two_process_gloo_group_all_reduces_and_updates_its_rows():
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _TWO, str(i), str(port)], env=_env(), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=TIMEOUT))
    finally:
        for proc in procs:
            proc.kill()
    for i, (proc, (out, err)) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"worker {i}: {err[-2000:]}"
        assert f"OK {i}" in out


def test_spread_devices_deals_the_cards_or_raises_without_one():
    with pytest.raises(ValueError, match="n must be >= 1"):
        multihost.spread_devices(0)
    if torch.cuda.is_available():
        count = torch.cuda.device_count()
        assert multihost.spread_devices(5) == [torch.device("cuda", i % count) for i in range(5)]
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.spread_devices(2)
