"""The port's mesh over several processes (L4): two gloo processes over
loopback, four CPU ranks each (``make_mesh(devices=["cpu"] * 4)`` in each),
make one 8-rank mesh; a meshed engine over it, fed the same global tiles
in every process, equals the JAX package's meshed engine on its 8 virtual
CPU devices and the port's unmeshed engine, on every process, in uniform,
WIDE, weighted and distinct int64 mode; ``sharded_result`` gives every
process every row; the uniform update's rows equal those of the JAX
package's two-process group (``tests/test_multihost.py``, whose worker
holds its rows against a single-process replay); and what the slice leaves
out raises ``NotImplementedError`` naming L4.

The children run once for the module, each bounded by :data:`TIMEOUT`
seconds, and write what they read back to ``.npz`` files."""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from reservoir_tpu.config import SamplerConfig as JConfig
from reservoir_tpu.engine import ReservoirEngine as JEngine
from reservoir_tpu.ops import algorithm_l as JA
from reservoir_tpu_torch import ReservoirEngine, SamplerConfig, convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a child process may take
TIMEOUT = 120
R, K, B, TILES = 16, 8, 32, 4
MODES = {
    "uniform": {},
    "wide": {"count_dtype": "wide"},
    "weighted": {"weighted": True},
    "distinct_int64": {"distinct": True, "element_dtype": "int64"},
}
#: rows of the export check (both processes' ranks, one repeated)
EXPORT_ROWS = [0, 15, 7, 8, 3, 8]
_CLUSTER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK", "SLURM_JOB_ID",
                 "SLURM_PROCID", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK")


def _feed(mode: str):
    """The mode's tiles (and weights), from numpy seed 3: the same in every
    process and here."""
    rng = np.random.default_rng(3)
    out = []
    for _ in range(TILES):
        if mode.startswith("distinct"):
            tile = rng.integers(-(1 << 40), 1 << 40, (R, B)).astype(np.int64)
        else:
            tile = rng.integers(0, 1 << 30, (R, B)).astype(np.int32)
        w = None
        if mode == "weighted":
            w = rng.uniform(0.1, 2.0, (R, B)).astype(np.float32)
            w[:, ::5] = 0.0
        out.append((tile, w))
    return out


_WORKER = """
import os, sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
from test_torch_multiproc_mesh import EXPORT_ROWS, K, MODES, R, B, _feed
from reservoir_tpu_torch import DeviceStreamBridge, ReservoirEngine, SamplerConfig, convert
from reservoir_tpu_torch.ops import algorithm_l as al
from reservoir_tpu_torch.ops.rng import key_from_seed
from reservoir_tpu_torch.parallel import Mesh, make_mesh, multihost, shard_state, sharded_result, sharded_update
pid, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
assert multihost.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=pid, backend="gloo", timeout=60)
mesh = make_mesh(devices=["cpu"] * 4)
save = {"shape": np.array(mesh.shape["res"]), "owners": np.array(mesh.owners),
        "local": np.array(mesh.local_ranks)}
for mode, kw in MODES.items():
    cfg = SamplerConfig(max_sample_size=K, num_reservoirs=R, tile_size=B, mesh_axis="res", **kw)
    eng = ReservoirEngine(cfg, key=11, reusable=True, mesh=mesh)
    assert len(eng._shards) == 4
    for tile, w in _feed(mode):
        eng.sample(tile, weights=w)
    samples, sizes = eng.peek_arrays()
    save[f"{mode}/samples"], save[f"{mode}/sizes"] = samples, sizes
    for name, v in convert.state_to_numpy(eng.state).items():
        if v is not None:
            save[f"{mode}/state/{name}"] = v
    for name, v in convert.state_to_numpy(eng.export_rows(EXPORT_ROWS)).items():
        if v is not None:
            save[f"{mode}/export/{name}"] = v
    got_s, got_z, got_t = sharded_result(mesh, ops=eng._ops)(eng._shards)
    assert len(got_s) == 4
    for r in range(4):  # every local rank holds every row
        assert torch.equal(got_s[r].view(torch.int32), got_s[0].view(torch.int32))
    save[f"{mode}/gathered"] = got_s[0].view(torch.int32).numpy()
    save[f"{mode}/gathered_sizes"] = got_z[0].numpy()
    save[f"{mode}/total"] = np.array(float(got_t[0]))
    res = eng.result()
    assert len(res) == R
# processes may hold unequal numbers of ranks: 2 and 6 (the gather pads)
uneven = make_mesh(devices=["cpu"] * (2 if pid == 0 else 6))
eng = ReservoirEngine(SamplerConfig(max_sample_size=K, num_reservoirs=R, tile_size=B, mesh_axis="res"), key=11,
                      reusable=True, mesh=uneven)
for tile, w in _feed("uniform"):
    eng.sample(tile)
save["uneven/owners"] = np.array(uneven.owners)
save["uneven/samples"], save["uneven/sizes"] = eng.peek_arrays()
# the JAX two-process worker's update: R 8, k 4, B 16, key 0, one tile,
# over a 4-rank mesh of 2 ranks a process
mesh4 = make_mesh(devices=["cpu"] * 2)
full = al.init(key_from_seed(0), 8, 4)
batch = (100 + np.arange(8 * 16, dtype=np.int32)).reshape(8, 16)
shards = sharded_update(mesh4)(shard_state(full, mesh4), batch)
for name in ("samples", "count", "nxt", "log_w"):
    save[f"two/{name}"] = torch.cat([getattr(s, name) for s in shards]).numpy()
# what the slice leaves out raises naming L4
cfg = SamplerConfig(max_sample_size=K, num_reservoirs=R, tile_size=B, mesh_axis="res")
eng = ReservoirEngine(cfg, key=0, mesh=mesh)
# a checkpoint of this process's own 2-rank mesh, to restore onto both
path = os.path.join(out_dir, f"ck{pid}.npz")
ReservoirEngine(cfg, key=0, mesh=Mesh(["cpu"] * 2)).save(path)
ckdir = os.path.join(out_dir, f"bridge{pid}")
DeviceStreamBridge(cfg, key=0, mesh=Mesh(["cpu"] * 2), checkpoint_dir=ckdir)
raised = []
for what, call in (("save", lambda: eng.save(os.path.join(out_dir, f"no{pid}.npz"))),
                   ("bridge", lambda: DeviceStreamBridge(cfg, key=0, mesh=mesh)),
                   ("restore", lambda: ReservoirEngine.restore(path, mesh=mesh)),
                   ("recover", lambda: DeviceStreamBridge.recover(ckdir, mesh=mesh))):
    try:
        call()
    except NotImplementedError as e:
        if "L4" in str(e) and "ROADMAP.md" in str(e):
            raised.append(what)
    except Exception as e:
        raised.append(f"{what}: {type(e).__name__}: {e}")
dist.barrier()
save["raised"] = np.array(raised)
np.savez(os.path.join(out_dir, f"proc{pid}.npz"), **save)
dist.destroy_process_group()
print("OK", pid)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """Run the two processes once; each one's ``.npz`` as a dict."""
    out = tmp_path_factory.mktemp("mesh2")
    env = {k: v for k, v in os.environ.items() if k not in _CLUSTER_VARS}
    env["PYTHONPATH"] = REPO
    port = _free_port()
    children = [subprocess.Popen([sys.executable, "-c", _WORKER, str(i), str(port), str(out)], env=env, cwd=REPO,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for i in range(2)]
    outs = []
    try:
        for child in children:
            outs.append(child.communicate(timeout=TIMEOUT))
    finally:
        for child in children:
            child.kill()
    for i, (child, (stdout, err)) in enumerate(zip(children, outs)):
        assert child.returncode == 0, f"process {i}: {err[-3000:]}"
        assert f"OK {i}" in stdout
    loaded = []
    for i in range(2):
        with np.load(out / f"proc{i}.npz") as f:
            loaded.append({name: f[name] for name in f.files})
    return loaded


@pytest.fixture(scope="module")
def references():
    """By mode: the JAX package's meshed engine on its 8 virtual devices
    and the port's unmeshed engine, fed the same tiles."""
    out = {}
    for mode, kw in MODES.items():
        jeng = JEngine(JConfig(max_sample_size=K, num_reservoirs=R, tile_size=B, mesh_axis="res", **kw), key=11,
                       reusable=True)
        teng = ReservoirEngine(SamplerConfig(max_sample_size=K, num_reservoirs=R, tile_size=B, **kw), key=11,
                               reusable=True, device="cpu")
        for tile, w in _feed(mode):
            jeng.sample(tile, weights=w) if w is not None else jeng.sample(tile)
            teng.sample(tile, weights=w)
        out[mode] = (jeng, teng)
    return out


def _jax_state(state) -> dict:
    out = {}
    for name, value in zip(type(state)._fields, state):
        if value is not None and jnp.issubdtype(value.dtype, jr.key(0).dtype):
            value = jr.key_data(value)
        if value is not None:
            out[name] = np.asarray(value)
    return out


def _same_bytes(a: np.ndarray, b: np.ndarray, what: str) -> None:
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(np.ascontiguousarray(a).view(np.uint8), np.ascontiguousarray(b).view(np.uint8),
                                  err_msg=what)


def test_make_mesh_spans_both_processes_in_process_order(procs):
    for pid, got in enumerate(procs):
        assert int(got["shape"]) == 8
        assert got["owners"].tolist() == [0] * 4 + [1] * 4
        assert got["local"].tolist() == list(range(4 * pid, 4 * pid + 4))


@pytest.mark.parametrize("mode", list(MODES))
def test_each_process_reads_the_jax_meshed_engines_result(procs, references, mode):
    jeng, _ = references[mode]
    want_samples, want_sizes = jeng.peek_arrays()
    want_state = _jax_state(jeng.state)
    for pid, got in enumerate(procs):
        _same_bytes(got[f"{mode}/samples"], np.asarray(want_samples), f"process {pid} samples")
        _same_bytes(got[f"{mode}/sizes"], np.asarray(want_sizes), f"process {pid} sizes")
        for name, want in want_state.items():
            _same_bytes(got[f"{mode}/state/{name}"], want, f"process {pid} {name}")


@pytest.mark.parametrize("mode", list(MODES))
def test_each_process_reads_the_unmeshed_engines_rows(procs, references, mode):
    _, teng = references[mode]
    want_samples, want_sizes = teng.peek_arrays()
    want_state = {k: v for k, v in convert.state_to_numpy(teng.state).items() if v is not None}
    want_export = {k: v for k, v in convert.state_to_numpy(teng.export_rows(EXPORT_ROWS)).items() if v is not None}
    for pid, got in enumerate(procs):
        _same_bytes(got[f"{mode}/samples"], want_samples, f"process {pid} samples")
        _same_bytes(got[f"{mode}/sizes"], want_sizes, f"process {pid} sizes")
        for name, want in want_state.items():
            _same_bytes(got[f"{mode}/state/{name}"], want, f"process {pid} {name}")
        for name, want in want_export.items():
            _same_bytes(got[f"{mode}/export/{name}"], want, f"process {pid} export {name}")


@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_result_gives_every_process_every_row(procs, references, mode):
    _, teng = references[mode]
    samples, sizes = teng._ops.result(teng.state)
    count = teng.state.count.numpy()
    for pid, got in enumerate(procs):
        _same_bytes(got[f"{mode}/gathered"], samples.view(torch.int32).numpy(), f"process {pid}")
        _same_bytes(got[f"{mode}/gathered_sizes"], sizes.numpy(), f"process {pid} sizes")
        if mode == "wide":
            from reservoir_tpu_torch.ops import u64e
            want_total = float(u64e.to_f32(teng.state.count).sum())
        else:
            want_total = float(count.astype(np.int64).sum())
        assert float(got[f"{mode}/total"]) == want_total


def test_the_uniform_update_equals_the_jax_two_process_groups_rows(procs):
    """The JAX package's two-process worker (``tests/test_multihost.py``)
    holds each process's rows of ``al.update(al.init(jr.key(0), 8, 4),
    100 + iota)`` against this single-process replay; each process's rows
    over the port's 2 x 2-rank mesh equal it."""
    batch = (100 + np.arange(8 * 16, dtype=np.int32)).reshape(8, 16)
    ref = JA.update(JA.init(jr.key(0), 8, 4), batch)
    for pid, got in enumerate(procs):
        lo, hi = pid * 4, (pid + 1) * 4
        for name in ("samples", "count", "nxt", "log_w"):
            _same_bytes(got[f"two/{name}"], np.asarray(getattr(ref, name))[lo:hi], f"process {pid} {name}")


def test_processes_may_hold_unequal_numbers_of_ranks(procs, references):
    want = references["uniform"][1].peek_arrays()
    for pid, got in enumerate(procs):
        assert got["uneven/owners"].tolist() == [0] * 2 + [1] * 6
        _same_bytes(got["uneven/samples"], want[0], f"process {pid} samples")
        _same_bytes(got["uneven/sizes"], want[1], f"process {pid} sizes")


def test_what_the_slice_leaves_out_raises_naming_l4(procs):
    for got in procs:
        assert sorted(got["raised"].tolist()) == ["bridge", "recover", "restore", "save"]
