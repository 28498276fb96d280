"""The port's partition rules (`repro_torch.launch.sharding`, `shapes`,
`train.state`) against the JAX package's, on the production mesh shapes
of 256 and 512 devices: the JAX side on `jax.sharding.AbstractMesh`, the
port's on `repro_torch.launch.mesh.AbstractMesh`, neither with a device or
a process group. The port's model trees keep their layers in lists; its
specs are re-keyed to the JAX package's stacked names (the lead axes of a
group of layers are unsharded)."""
import jax
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import flatten_state as jflatten
from repro.configs.base import get_config as jget, list_configs
from repro.launch import mesh as jmesh
from repro.launch import sharding as JS
from repro.launch import shapes as jshapes
from repro.models import model as JM
from repro.train.state import train_state_shardings as j_state_shardings
from repro_torch.ckpt.checkpoint import Stacked
from repro_torch.ckpt.checkpoint import flatten_state as tflatten
from repro_torch.configs.base import get_config as tget
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as TS
from repro_torch.launch import shapes as tshapes
from repro_torch.models import model as TM
from repro_torch.train.state import train_state_shardings as t_state_shardings

ARCHS = list_configs()
MESHES = {"single_pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(which):
    shape, axes = MESHES[which]
    return (jax.sharding.AbstractMesh(shape, axes),
            tmesh.AbstractMesh(shape, axes))


def _spec(s):
    return tuple(getattr(s, "spec", s))


def _jax_specs(tree) -> dict:
    return {k: _spec(v) for k, v in jflatten(tree).items()}


def _port_specs(tree) -> dict:
    """The port's spec (or sharding) tree under the JAX names: a group of
    layers gives one spec, its layers' (all equal) behind None lead
    entries."""
    out = {}
    for k, v in tflatten(tree).items():
        if isinstance(v, Stacked):
            specs = {_spec(p) for p in v.parts}
            assert len(specs) == 1, (k, specs)
            out[k] = (None,) * len(v.lead) + specs.pop()
        else:
            out[k] = _spec(v)
    return out


@pytest.mark.parametrize("which", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_opt_and_cache_specs_match_the_reference(arch, which):
    jm, tm = _meshes(which)
    jcfg, tcfg = jget(arch), tget(arch)
    jshapes_ = JM.param_shapes(jcfg)
    tshapes_ = TM.param_shapes(tcfg)
    want = _jax_specs(JS.param_pspec_tree(jcfg, jm, jshapes_))
    got = _port_specs(TS.param_pspec_tree(tcfg, tm, tshapes_))
    assert got == want
    assert any(any(e is not None for e in s) for s in got.values())
    want = _jax_specs(JS.opt_sharding_tree(jcfg, jm, jshapes_))
    got = _port_specs(TS.opt_sharding_tree(tcfg, tm, tshapes_))
    assert got == want
    if which == "multi_pod":
        assert any("pod" in str(s) for s in got.values())
    jc = JM.make_decode_cache_spec(jcfg, 128, 1024)
    tc = TM.make_decode_cache_spec(tcfg, 128, 1024)
    assert _port_specs(TS.cache_pspec_tree(tcfg, tm, tc)) == \
        _jax_specs(JS.cache_pspec_tree(jcfg, jm, jc))


@pytest.mark.parametrize("tp", [1, 2, 4, 16])
def test_attn_layouts_match_the_reference(tp):
    for arch in ARCHS:
        assert TS.attn_layouts(tget(arch), tp) == \
            JS.attn_layouts(jget(arch), tp), arch
        assert TS.attn_layout(tget(arch), tp) == \
            JS.attn_layout(jget(arch), tp), arch
    assert TS.attn_layout(tget("smollm-360m"), 16) == "head_dim"
    assert TS.attn_layout(tget("qwen1.5-0.5b"), 16) == "heads"


def test_smollm_head_dim_layout_on_a_2x2_mesh():
    """The mesh phase's layout: 15 heads do not divide 2, head_dim does."""
    m = tmesh.AbstractMesh((2, 2), ("data", "model"))
    cfg = tget("smollm-360m")
    assert TS.attn_layout(cfg, 2) == "head_dim"
    specs = TS.param_pspec_tree(cfg, m, TM.param_shapes(cfg))
    layer = specs["stack"]["layers"][0]
    assert tuple(layer["attn"]["wq"]["w"]) == ("data", None, "model")
    assert tuple(layer["attn"]["wo"]["w"]) == (None, "model", "data")
    assert tuple(specs["embed"]["table"]) == ("model", "data")
    assert tuple(layer["attn_norm"]["scale"]) == (None,)


@pytest.mark.parametrize("which", sorted(MESHES))
def test_train_state_shardings_widen_the_moments_over_pod(which):
    jm, tm = _meshes(which)
    for arch in ("qwen3-4b", "smollm-360m", "zamba2-2.7b"):
        want = _jax_specs(j_state_shardings(jget(arch), jm))
        got = _port_specs(t_state_shardings(tget(arch), tm))
        assert got == want, arch
    sh = t_state_shardings(tget("qwen3-4b"), tm)
    m_spec = sh["opt"]["m"]["stack"]["layers"][0]["ffn"]["gate"]["w"].spec
    p_spec = sh["params"]["stack"]["layers"][0]["ffn"]["gate"]["w"].spec
    flat_m = [a for e in m_spec if e for a in
              (e if isinstance(e, tuple) else (e,))]
    flat_p = [a for e in p_spec if e for a in
              (e if isinstance(e, tuple) else (e,))]
    assert "pod" not in flat_p
    assert ("pod" in flat_m) == (which == "multi_pod")
    assert sh["step"].spec == TS.P()


def test_batch_sharding_for_matches_the_reference():
    for which in MESHES:
        jm, tm = _meshes(which)
        for shape in [(256, 4096), (32, 32768), (1, 1), (128, 1, 64), (6, 2)]:
            sds = jax.ShapeDtypeStruct(shape, np.int32)
            meta = torch.empty(shape, device="meta")
            for axes in (("pod", "data"), ("data",)):
                assert _spec(TS.batch_sharding_for(tm, meta,
                                                   batch_axes=axes)) == \
                    _spec(JS.batch_sharding_for(jm, sds, batch_axes=axes))
            assert _spec(TS.batch_spec(tm, len(shape))) == \
                _spec(JS.batch_spec(jm, len(shape)))
        assert _spec(TS.replicated(tm)) == _spec(JS.replicated(jm)) == ()


def test_pad_entries_rejects_a_rule_longer_than_the_rank():
    msg = "sharding rule for a/w names 3 axes"
    with pytest.raises(RuntimeError, match=msg) as te:
        TS._pad_entries(("a", "w"), (4, 4), ("data", None, "model"))
    with pytest.raises(RuntimeError, match=msg) as je:
        JS._pad_entries(("a", "w"), (4, 4), ("data", None, "model"))
    assert str(te.value) == str(je.value)
    assert TS._pad_entries(("w",), (2, 3, 4), ("data",)) == \
        JS._pad_entries(("w",), (2, 3, 4), ("data",)) == (None, None, "data")


def test_spec_entries_normalise_as_partition_spec_does():
    from jax.sharding import PartitionSpec
    for entries in [(("data",), None), ((), "model"), (["pod", "data"],),
                    ("data", ("pod", "model"))]:
        assert tuple(TS.P(*entries)) == tuple(PartitionSpec(*entries))


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def _args(tree) -> dict:
    out = {}
    for k, v in tflatten(tree).items():
        out[k] = (tuple(v.shape), _dtype(v.parts[0].dtype if
                                         isinstance(v, Stacked) else v.dtype))
    return out


@pytest.mark.parametrize("which", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch, which):
    jm, tm = _meshes(which)
    jcfg, tcfg = jget(arch), tget(arch)
    for name, case in tshapes.SHAPE_TABLE.items():
        assert case == tshapes.ShapeCase(**vars(jshapes.SHAPE_TABLE[name]))
        ok, why = tshapes.applicable(tcfg, name)
        assert (ok, why) == jshapes.applicable(jcfg, name)
        if not ok:
            with pytest.raises(ValueError, match="skipped: pure"):
                tshapes.input_specs(tcfg, name, tm)
            continue
        j = jshapes.input_specs(jcfg, name, jm)
        t = tshapes.input_specs(tcfg, name, tm)
        assert (t["kind"], t["donate_argnums"]) == \
            (j["kind"], j["donate_argnums"])
        assert t["case"].name == j["case"].name
        assert len(t["args"]) == len(j["args"])
        for ta, ja, tsh, jsh in zip(t["args"], j["args"], t["in_shardings"],
                                    j["in_shardings"]):
            want = {k: (tuple(v.shape), str(v.dtype))
                    for k, v in jflatten(ja).items()}
            assert _args(ta) == want
            assert all(p.device.type == "meta" for x in
                       tflatten(ta).values() for p in
                       (x.parts if isinstance(x, Stacked) else [x]))
            assert _port_specs(tsh) == _jax_specs(jsh)


def test_debug_mesh_messages_and_mesh_summary():
    with pytest.raises(ValueError, match="even device count, got 3") as te:
        tmesh.make_debug_mesh(n_devices=3, device_type="cpu")
    with pytest.raises(ValueError) as je:
        jmesh.make_debug_mesh(devices=[object()] * 3)
    assert str(te.value) == str(je.value)
    for n in (6, 4):
        with pytest.raises(ValueError, match=">= 8") as te:
            tmesh.make_debug_mesh(multi_pod=True, n_devices=n,
                                  device_type="cpu")
        with pytest.raises(ValueError) as je:
            jmesh.make_debug_mesh(multi_pod=True, devices=[object()] * n)
        assert str(te.value) == str(je.value)
    for which in MESHES:
        jm, tm = _meshes(which)
        assert tmesh.mesh_summary(tm) == jmesh.mesh_summary(jm)
    assert tmesh.mesh_summary(tmesh.AbstractMesh((2, 16, 16), (
        "pod", "data", "model"))) == {"axis_names": ["pod", "data", "model"],
                                      "shape": [2, 16, 16], "n_devices": 512}


def test_a_multi_device_mesh_needs_a_process_group():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize"):
        tmesh.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="initialize"):
        tmesh.make_mesh((2, 2), ("data", "model"), device_type="cpu")
