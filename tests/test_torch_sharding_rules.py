"""The port's sharding rules against the reference's, on shape-only meshes.

The rule functions read only axis names and sizes, so both packages run
them on abstract meshes (``jax.sharding.AbstractMesh``, the port's
``parallel.sharding.AbstractMesh``) at the test meshes and the production
shapes (16 x 16, 2 x 16 x 16) without a device.  Specs and shapes come
from the models' definitions (JAX ``defs()``, the port's ``meta`` modules):
nothing is initialised and no JAX computation runs.  Checked over the full
parameter trees of the eight suite models and the ten assigned LMs:
``spec_for`` / ``logical_to_sharding`` leaf by leaf and ``shard_report``
under every profile and ``SERVE_TP_RULES``; ``batch_sharding_for``;
``cache_shardings`` in both layouts; the divisibility fallback's counter
and warn-once; ``parse_mesh``.
"""

from __future__ import annotations

import functools
import warnings

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh

import repro.configs.suite  # noqa: F401  (registers the suite configs)
import repro_torch.configs.suite  # noqa: F401
from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as j_get_config
from repro.launch import mesh as j_mesh
from repro.launch import steps as j_steps
from repro.models.transformer import TransformerLM as JTransformerLM
from repro.nn.module import ParamDef as JParamDef
from repro.parallel import sharding as jsh
from repro.workload import workload_for as j_workload_for
from repro_torch.configs import get_config
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import steps as t_steps
from repro_torch.models.transformer import TransformerLM
from repro_torch.nn import param_defs, specs_of
from repro_torch.parallel import sharding as tsh
from repro_torch.workload import workload_for

SUITE = ["stable-diffusion", "make-a-video", "imagen", "prod-image", "muse", "phenaki",
         "llama2-7b", "parti"]
ARCHS = SUITE + list(ASSIGNED_ARCHS)
MESHES = {"2x2": ((2, 2), ("data", "model")), "4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RULES = {"2d": "DEFAULT_RULES", "fsdp": "FSDP_RULES", "serve": "SERVE_RULES",
         "serve_tp": "SERVE_TP_RULES"}


def _meshes(name):
    sizes, names = MESHES[name]
    return JAbstractMesh(sizes, names), tsh.AbstractMesh(sizes, names)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(reference defs {key: ParamDef}, reference specs tree, port meta module)."""
    jm = j_workload_for(j_get_config(arch)).model
    tm = workload_for(get_config(arch)).model
    return _flat(jm.defs()), jm.specs(), tm


def _spec(p) -> tuple:
    return tuple(p)


def _both(jfn, tfn):
    """(reference spec, port spec) of a sharding call, or ("refused",) in
    each package that refuses it (a mesh axis on two dims)."""
    try:
        want = jfn()
        want = _spec(want.spec) if hasattr(want, "spec") else want
    except Exception as e:  # noqa: BLE001 -- jax's DuplicateSpecError only
        if "DuplicateSpec" not in type(e).__name__:
            raise
        want = ("refused",)
    try:
        got = tfn()
        got = got.spec if hasattr(got, "spec") else got
    except ValueError:
        got = ("refused",)
    return want, got


@pytest.fixture(autouse=True)
def _profile_2d():
    yield
    jsh.set_profile("2d")
    tsh.set_profile("2d")


def test_port_specs_are_the_references():
    """Every leaf of every model declares the reference's logical axes."""
    for arch in ARCHS:
        jdefs, _, tm = _models(arch)
        assert specs_of(tm) == {k: tuple(d.axes) for k, d in jdefs.items()}, arch
        assert {k: d.shape for k, d in param_defs(tm).items()} == {
            k: tuple(d.shape) for k, d in jdefs.items()}, arch


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_shardings_and_reports_match(arch, mesh_name):
    jm, tm_mesh = _meshes(mesh_name)
    jdefs, jspecs, tm = _models(arch)
    shapes = {k: jax.ShapeDtypeStruct(d.shape, d.dtype) for k, d in jdefs.items()}
    jshapes_tree = jax.tree.map(lambda d: jax.ShapeDtypeStruct(d.shape, d.dtype),
                                j_workload_for(j_get_config(arch)).model.defs(),
                                is_leaf=lambda x: isinstance(x, JParamDef))
    tspecs = specs_of(tm)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for rname, attr in RULES.items():
            jr, tr = getattr(jsh, attr), getattr(tsh, attr)
            jshard = _flat(jsh.logical_to_sharding(jspecs, jshapes_tree, jm, jr))
            tshard = tsh.logical_to_sharding(tspecs, tm, tm_mesh, tr)
            assert {k: _spec(s.spec) for k, s in jshard.items()} == {
                k: s.spec for k, s in tshard.items()}, (arch, rname)
            for k in list(shapes)[:4]:
                assert _spec(jsh.spec_for(tuple(jdefs[k].axes), jdefs[k].shape, jm, jr)) == \
                    tsh.spec_for(tspecs[k], tuple(param_defs(tm)[k].shape), tm_mesh, tr)
            assert jsh.shard_report(jshapes_tree, jspecs, jm, jr) == tsh.shard_report(
                tm, tspecs, tm_mesh, tr), (arch, rname)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("profile", ["2d", "fsdp", "serve"])
def test_batch_sharding_and_axes_match(profile, mesh_name):
    jm, tm_mesh = _meshes(mesh_name)
    jsh.set_profile(profile)
    tsh.set_profile(profile)
    assert jsh.batch_axes(jm) == tsh.batch_axes(tm_mesh)
    for batch in (1, 2, 3, 4, 8, 16, 32, 64, 256, 512, 1024):
        for ndim, trailing in ((1, ()), (2, ()), (3, ()), (3, (None, "model")), (4, (None,))):
            want, got = _both(lambda: jsh.batch_sharding_for(jm, batch, ndim, trailing),
                              lambda: tsh.batch_sharding_for(tm_mesh, batch, ndim, trailing))
            assert want == got, (batch, ndim, trailing)
    assert _spec(jsh.data_sharding(jm, None).spec) == tsh.data_sharding(tm_mesh, None).spec
    assert tuple(jsh.replicated(jm).spec) == tsh.replicated(tm_mesh).spec


@functools.lru_cache(maxsize=None)
def _caches(arch, batch, max_len):
    jc = j_steps.abstract_cache(JTransformerLM(j_get_config(arch)), batch, max_len)
    tc = t_steps.abstract_cache(TransformerLM(get_config(arch)), batch, max_len)
    return jc, tc


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(ASSIGNED_ARCHS))
def test_cache_shardings_match_in_both_layouts(arch, mesh_name):
    jm, tm_mesh = _meshes(mesh_name)
    for profile in ("2d", "fsdp"):
        jsh.set_profile(profile)
        tsh.set_profile(profile)
        for batch, max_len in ((32, 4096), (3, 128), (1, 64)):
            jc, tc = _caches(arch, batch, max_len)
            assert [tuple(a.shape) for a in jax.tree.leaves(jc)] == [
                tuple(a.shape) for g in tc for st in g.values() for a in st], arch
            for layout in ("decode", "prefill"):
                want, got = _both(
                    lambda: [_spec(s.spec) for s in jax.tree.leaves(
                        j_steps.cache_shardings(jc, jm, batch, layout),
                        is_leaf=lambda x: hasattr(x, "spec"))],
                    lambda: [s.spec for g in t_steps.cache_shardings(tc, tm_mesh, batch, layout)
                             for st in g.values() for s in st])
                assert want == got, (arch, profile, layout, batch)


def test_param_shardings_follow_the_profile():
    """``param_shardings`` is ``logical_to_sharding`` of the model under the
    active profile, as the reference's (whose shapes come from eval_shape)."""
    jm, tm_mesh = _meshes("16x16")
    jlm = JTransformerLM(j_get_config("olmo-1b"))
    tlm = TransformerLM(get_config("olmo-1b"))
    for profile in ("2d", "fsdp"):
        jsh.set_profile(profile)
        tsh.set_profile(profile)
        want = _flat(j_steps.param_shardings(jlm, jm))
        got = t_steps.param_shardings(tlm, tm_mesh)
        assert {k: _spec(s.spec) for k, s in want.items()} == {
            k: s.spec for k, s in got.items()}


def test_replication_fallback_counts_and_warns_once_as_the_reference():
    """kv_heads=8 on a model axis of 16 replicates: both packages count each
    fallback and warn once per (name, dim, axis, size)."""
    jm, tm_mesh = _meshes("16x16")
    jsh._warned_fallbacks.clear()
    tsh._warned_fallbacks.clear()
    calls = [(("embed", "kv_heads"), (4096, 8 * 128)), (("embed", "kv_heads"), (4096, 1000)),
             (("embed", "kv_heads"), (4096, 1000)), (("vocab", "embed"), (32001, 4096)),
             (("experts", "embed", "mlp"), (60, 2048, 1408))]
    for pkg, mesh in ((jsh, jm), (tsh, tm_mesh)):
        before = pkg.REPLICATION_FALLBACKS.value
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            for axes, shape in calls:
                pkg.spec_for(axes, shape, mesh, pkg.DEFAULT_RULES)
        pkg._counted = (pkg.REPLICATION_FALLBACKS.value - before,
                        sorted(str(x.message) for x in w))
    assert jsh._counted == tsh._counted
    assert tsh._counted[0] == 4 and len(tsh._counted[1]) == 3


def test_parse_mesh_matches():
    for spec in ("4x2", "1x1", " 16 X 16 ", "2x16"):
        assert j_mesh.parse_mesh(spec) == t_mesh.parse_mesh(spec)
    for bad in ("4", "0x2", "4x2x2", "ax2", ""):
        with pytest.raises(ValueError) as je:
            j_mesh.parse_mesh(bad)
        with pytest.raises(ValueError) as te:
            t_mesh.parse_mesh(bad)
        assert str(je.value) == str(te.value)


def test_specs_map_to_dtensor_placements_major_to_minor():
    """A tuple of mesh axes on one dim becomes a Shard of that dim on each,
    in mesh order (JAX's major-to-minor); another order is refused."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = tsh.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert tsh.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert tsh.placements((None, ("data", "model")), mesh) == (Replicate(), Shard(1), Shard(1))
    assert tsh.placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        tsh.placements((("model", "data"),), mesh)
    assert np.prod(mesh.axis_sizes) == t_mesh.mesh_chips(mesh) == 512


_SLICES_ORACLE = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh
import repro.configs.suite
from repro.configs import get_config
from repro.parallel.mesh_exec import stage_mesh_slices
from repro.workload import workload_for
out = {}
for arch in json.loads(sys.argv[1]):
    stages = workload_for(get_config(arch)).cost_descriptor().stages
    for d, m in ((1, 1), (2, 1), (2, 2), (4, 2), (8, 1), (1, 8)):
        mesh = Mesh(np.array(jax.devices()[:d * m]).reshape(d, m), ("data", "model"))
        out[f"{arch}/{d}x{m}"] = [
            [[int(x.id) for x in s.devices.reshape(-1)], list(s.devices.shape), s is mesh]
            for s in stage_mesh_slices(stages, mesh)]
print(json.dumps(out))
"""


def test_stage_mesh_slices_match_the_reference_host_mesh():
    """The cascade's per-stage rank slices, against the reference's device
    slices of an 8-device host mesh (one JAX subprocess, as the reference's
    own host-mesh lane runs it)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.parallel.mesh_exec import stage_slice_plan
    from repro_torch.pipeline.stage import mean_demand

    archs = ["stable-diffusion", "imagen", "make-a-video", "llama2-7b", "parti", "muse"]
    src = Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(src)}
    res = subprocess.run([sys.executable, "-c", _SLICES_ORACLE, json.dumps(archs)],
                         capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    for key, slices in want.items():
        arch, dm = key.split("/")
        d, m = map(int, dm.split("x"))
        stages = workload_for(get_config(arch)).cost_descriptor().stages
        plan = stage_slice_plan([mean_demand(s) for s in stages], d * m)
        got = [[list(range(d * m)), [d, m], True] if e is None
               else [list(range(e[0], e[0] + e[1])), list(e[2]), False] for e in plan]
        assert got == slices, key
