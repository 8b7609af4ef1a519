"""The port's public surface against the JAX package's.

For every module of the reference's public surface
(``tools/gen_api_manifest.PUBLIC_MODULES``) but its four Pallas kernel
modules, each public name has a counterpart of the same name in the port's
module of the same path, each parameter of a public function or method
one of the same name, and a parameter whose default is a plain value (a
number, a string, a bool or ``None``) the same default.  What the port
leaves out on purpose is a row of :data:`DIFFERENCES` with its reason; a
row that no longer differs fails the test, so the table cannot outlive its
cause.
"""

from __future__ import annotations

import importlib
import inspect

import pytest

from tools.gen_api_manifest import PUBLIC_MODULES

#: (port module, name or ``Class.method``, parameter or None) -> the reason
#: the port differs.  Parameters the port names otherwise keep the
#: reference's meaning under the port's name.
DIFFERENCES = {
    ("reservoir_tpu_torch", "ReservoirEngine.pallas_used", None):
        "the port has no Pallas/XLA dispatch to introspect: every tile launches its CUDA kernel, "
        "which the wrappers' launch counts show",
    ("reservoir_tpu_torch", "ReservoirEngine.xla_used", None): "as pallas_used",
    ("reservoir_tpu_torch.engine", "ReservoirEngine.pallas_used", None): "as pallas_used",
    ("reservoir_tpu_torch.engine", "ReservoirEngine.xla_used", None): "as pallas_used",
    ("reservoir_tpu_torch.ops.algorithm_l", "init", "key"):
        "a jax key has no torch counterpart: the port takes its [2] key words, named key_words",
    ("reservoir_tpu_torch.ops.algorithm_l", "merge", "key"): "as init's key",
    ("reservoir_tpu_torch.ops.distinct", "init", "key"): "as algorithm_l.init's key",
    ("reservoir_tpu_torch.ops.weighted", "init", "key"): "as algorithm_l.init's key",
    ("reservoir_tpu_torch.ops.distinct", "init", "count_dtype"):
        "distinct counters are int32, the one dtype the reference's engine builds for this mode",
    ("reservoir_tpu_torch.ops.weighted", "init", "count_dtype"): "as distinct.init's count_dtype",
    ("reservoir_tpu_torch.ops.rng", "accept_draws", None):
        "it draws from a jax key; the port's accept_draws_words takes the key words (k1, k2)",
    ("reservoir_tpu_torch.ops.rng", "key_words", None):
        "it unwraps a jax key; the port holds key words from the start (key_from_seed, split_keys)",
    ("reservoir_tpu_torch.ops.rng", "uniforms", "key"):
        "the port's uniforms(k1, k2, idx, n) takes key words and absolute indices",
    ("reservoir_tpu_torch.ops.rng", "uniforms", "shape"): "as uniforms' key",
    ("reservoir_tpu_torch.ops.rng", "uniforms", "offset"): "as uniforms' key",
    ("reservoir_tpu_torch.parallel.merge", "uniform_stream_merger", "mesh"):
        "the port's ranks are torch devices, given as devices=, not a jax mesh and its axis",
    ("reservoir_tpu_torch.parallel.merge", "uniform_stream_merger", "axis"): "as mesh",
    ("reservoir_tpu_torch.parallel.merge", "weighted_stream_merger", "mesh"): "as uniform_stream_merger",
    ("reservoir_tpu_torch.parallel.merge", "weighted_stream_merger", "axis"): "as uniform_stream_merger",
    ("reservoir_tpu_torch.parallel.merge", "distinct_stream_merger", "mesh"): "as uniform_stream_merger",
    ("reservoir_tpu_torch.parallel.merge", "distinct_stream_merger", "axis"): "as uniform_stream_merger",
    ("reservoir_tpu_torch.parallel.merge", "host_pairwise_trace_count", None):
        "it counts jax traces of the host merge; the port traces nothing",
    ("reservoir_tpu_torch.parallel.sharded", "shard_map", None):
        "jax's shard_map re-exported; the port's meshed engine launches one kernel a rank instead "
        "(not ported, on purpose: ROADMAP)",
    ("reservoir_tpu_torch.utils.selftest", "device_selftest_subprocess", "platform"):
        "a jax platform name; the port's child runs on the card, or with device='cpu' on the CPU",
    ("reservoir_tpu_torch.utils.tracing", "profile_capture", "host_tracer_level"):
        "an option of jax's profiler; torch.profiler takes none such",
}

_PLAIN = (bool, int, float, str, type(None))


def _exports(mod):
    names = getattr(mod, "__all__", None)
    return sorted(names) if names is not None else sorted(n for n in vars(mod) if not n.startswith("_"))


def _members(cls):
    """A class's public methods and properties (and ``__init__``,
    ``__call__``), as the manifest lists them."""
    return [name for name, member in sorted(vars(cls).items())
            if not (name.startswith("_") and name not in ("__init__", "__call__"))
            and (callable(member) or isinstance(member, (property, staticmethod, classmethod)))]


def _signature(obj):
    if isinstance(obj, (staticmethod, classmethod)):
        obj = obj.__func__
    if isinstance(obj, property):
        return None
    try:
        return inspect.signature(obj)
    except (TypeError, ValueError):
        return None


def _differences():
    """Every (port module, name, parameter) the port lacks or defaults
    otherwise, against the reference."""
    found = {}
    for ref_name in PUBLIC_MODULES:
        if ref_name.endswith("_pallas"):
            continue
        port_name = ref_name.replace("reservoir_tpu", "reservoir_tpu_torch", 1)
        ref, port = importlib.import_module(ref_name), importlib.import_module(port_name)
        for name in _exports(ref):
            r = getattr(ref, name)
            p = getattr(port, name, None)
            if p is None:
                found[(port_name, name, None)] = "missing"
                continue
            pairs = [(name, r, p)]
            if inspect.isclass(r):
                pairs = []
                for m in _members(r):
                    if not hasattr(p, m):
                        found[(port_name, f"{name}.{m}", None)] = "missing"
                    else:
                        pairs.append((f"{name}.{m}", inspect.getattr_static(r, m),
                                      inspect.getattr_static(p, m)))
            for label, a, b in pairs:
                sa, sb = _signature(a), _signature(b)
                if sa is None or sb is None:
                    continue
                for q, param in sa.parameters.items():
                    if q not in sb.parameters:
                        found[(port_name, label, q)] = "missing"
                    elif isinstance(param.default, _PLAIN) and param.default is not inspect.Parameter.empty \
                            and sb.parameters[q].default != param.default:
                        found[(port_name, label, q)] = (f"default {sb.parameters[q].default!r}, "
                                                        f"the reference's {param.default!r}")
    return found


@pytest.fixture(scope="module")
def differences():
    return _differences()


def test_every_public_name_and_parameter_has_a_counterpart(differences):
    unexplained = {k: v for k, v in differences.items() if k not in DIFFERENCES}
    assert not unexplained, "\n".join(f"{k}: {v}" for k, v in sorted(unexplained.items(), key=str))


def test_every_row_of_the_table_still_differs(differences):
    stale = sorted(set(DIFFERENCES) - set(differences), key=str)
    assert not stale, f"no longer different, take out of DIFFERENCES: {stale}"
    assert all(reason.strip() for reason in DIFFERENCES.values())


@pytest.mark.parametrize("module, label, param, want", [
    # C.8: the engine's fault plane, as the reference's
    ("reservoir_tpu_torch.engine", "ReservoirEngine.__init__", "faults", None),
    # C.7: the attribution root, as the reference's
    ("reservoir_tpu_torch.obs.trace", "attribution", "root", "serve.ingest"),
    ("reservoir_tpu_torch.ops.autotune", "lookup", "kernel", "algl"),
])
def test_closed_differences(module, label, param, want):
    obj = importlib.import_module(module)
    for part in label.split("."):
        obj = getattr(obj, part)
    assert inspect.signature(obj).parameters[param].default == want
