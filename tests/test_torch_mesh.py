"""The port's mesh layer on `torch.distributed` (`repro_torch.meshctx`,
`launch.mesh`, `launch.sharding.to_placements`, `launch.distributed`)
in a world of 4 gloo ranks on the CPU: one module-scoped `RankPool` whose
ranks share a `FileStore` in a temp dir. The boxes DTensor gives each rank
are held against the boxes JAX gives the same device for the same spec,
from a subprocess with 4 host devices. No JAX in this process: the rank
processes import this module."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import meshctx
from repro_torch.launch import distributed as D
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as S

REPO = pathlib.Path(__file__).resolve().parents[1]
AXES = ("data", "model")
#: (name, global shape, spec): sharded on both axes; a tuple entry over
#: both; replicated over `data`; a dim of 3 the guard leaves whole; rank 3
CASES = [("both", (8, 8), ("data", "model")),
         ("tuple", (8, 4), (("data", "model"), None)),
         ("replicated_axis", (6, 8), (None, "model")),
         ("guarded", (3, 8), ("data", "model")),
         ("rank3", (4, 6, 2), ("model", None, "data"))]


def _guarded(shape, spec):
    return S._guard(spec, shape, tmesh.AbstractMesh((2, 2), AXES))


# ------------------------------------------------------------- rank tasks
def _rank_boxes():
    """Each case's DTensor on this rank: its local offset and shape, and
    whether its values are the global slice there."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.ckpt.checkpoint import _local_box
    mesh = tmesh.make_mesh((2, 2), AXES, device_type="cpu")
    out = {}
    for name, shape, spec in CASES:
        full = torch.arange(int(np.prod(shape)),
                            dtype=torch.float32).reshape(shape)
        p = S.to_placements(_guarded(shape, spec), mesh)
        x = distribute_tensor(full, mesh, p)
        off = _local_box(x)
        loc = x.to_local()
        sl = tuple(slice(o, o + e) for o, e in zip(off, loc.shape))
        out[name] = {"offset": list(off), "extent": list(loc.shape),
                     "values_ok": bool(torch.equal(loc, full[sl])),
                     "coordinate": list(mesh.get_coordinate())}
    return dist.get_rank(), out


def _rank_shard_hint():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = tmesh.make_mesh((2, 2), AXES, device_type="cpu")
    full = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    x = distribute_tensor(full, mesh, [Replicate(), Replicate()])
    plain = torch.ones(3)
    res = {"off_mesh": meshctx.shard_hint(x, "data") is x,
           "off_mesh_size": meshctx.axis_size("model")}
    with meshctx.use_mesh(mesh):
        res["sizes"] = [meshctx.axis_size(a) for a in
                        ("data", "model", "pod")]
        res["plain"] = meshctx.shard_hint(plain, "data") is plain
        # "pod" is absent from the mesh: dropped, as in the reference
        y = meshctx.shard_hint(x, ("pod", "data"), ("model", "pod"))
        res["placements"] = [str(p) for p in y.placements]
        res["equal"] = bool(torch.equal(y.full_tensor(), full))
        z = meshctx.shard_hint(y, None, "data")
        res["back"] = [p == q for p, q in
                       zip(z.placements, [Shard(1), Replicate()])]
        res["local_shape"] = list(z.to_local().shape)
        with meshctx.use_mesh(None):
            res["nested_off"] = meshctx.current_mesh() is None
        res["restored"] = meshctx.current_mesh() is mesh
    return res


def _rank_meshes():
    mesh = tmesh.make_debug_mesh(device_type="cpu")
    out = {"debug": tmesh.mesh_summary(mesh),
           "names": list(mesh.mesh_dim_names)}
    try:
        tmesh.make_production_mesh(device_type="cpu")
        out["production"] = "built"
    except ValueError as e:
        out["production"] = str(e)
    return out


def _rank_initialize_again(world):
    info = D.initialize(None, world, dist.get_rank(), device="cpu")
    t = torch.tensor([dist.get_rank() + 1.0])
    dist.all_reduce(t)
    try:
        D.initialize(None, world + 1, dist.get_rank(), device="cpu")
        mismatch = "accepted"
    except RuntimeError as e:
        mismatch = str(e)
    return {**info, "sum": float(t), "world": dist.get_world_size(),
            "mismatch": mismatch}


# ------------------------------------------------------------------ tests
@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with D.RankPool(4, tmp_path_factory.mktemp("store"), timeout=120) as p:
        yield p


_JAX_BOXES = """
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
out = {}
for name, shape, spec in json.loads(%r):
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    m = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
    out[name] = {d.id: [[s.start or 0, (s.stop if s.stop is not None
                          else n) - (s.start or 0)]
                        for s, n in zip(idx, shape)]
                 for d, idx in m.items()}
print(json.dumps(out))
"""


def _jax_boxes(cases) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    code = _JAX_BOXES % json.dumps(cases)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120,
                       cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_to_placements_gives_each_rank_the_box_jax_gives_its_device(pool):
    guarded = [(n, s, list(_guarded(s, spec))) for n, s, spec in CASES]
    assert guarded[3][2] == [None, "model"]        # 3 rows do not split
    want = _jax_boxes(guarded)
    got = dict(pool.run(_rank_boxes))
    assert sorted(got) == [0, 1, 2, 3]
    abstract = tmesh.AbstractMesh((2, 2), AXES)
    for name, shape, spec in guarded:
        for rank, boxes in got.items():
            b = boxes[name]
            assert b["values_ok"], (name, rank)
            # rank r sits at the mesh coordinate JAX's device r has
            assert b["coordinate"] == [rank // 2, rank % 2]
            jbox = want[name][str(rank)]
            assert [[o, e] for o, e in zip(b["offset"], b["extent"])] == \
                jbox, (name, rank)
            off, ext = S.shard_box(S.P(*spec), abstract, shape,
                                   b["coordinate"])
            assert [list(off), list(ext)] == [b["offset"], b["extent"]]


def test_to_placements_maps_entries_to_mesh_dims():
    from torch.distributed.tensor import Replicate, Shard
    m3 = tmesh.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    assert S.to_placements(S.P(("pod", "data"), None, "model"), m3) == \
        [Shard(0), Shard(0), Shard(2)]
    assert S.to_placements(S.P(), m3) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        S.to_placements(S.P(("data", "pod")), m3)
    with pytest.raises(ValueError, match="twice"):
        S.to_placements(S.P("data", "data"), m3)
    with pytest.raises(ValueError, match="lacks"):
        S.to_placements(S.P("expert"), m3)


def test_shard_hint_redistributes_dtensors_and_drops_absent_axes(pool):
    x = torch.ones(4)
    assert meshctx.shard_hint(x, "data") is x
    assert meshctx.current_mesh() is None and meshctx.axis_size("data") == 1
    for res in pool.run(_rank_shard_hint):
        assert res["off_mesh"] and res["off_mesh_size"] == 1
        assert res["sizes"] == [2, 2, 1]
        assert res["plain"]
        assert res["placements"] == ["S(0)", "S(1)"]
        assert res["equal"]
        assert res["back"] == [True, True]
        assert res["local_shape"] == [8, 2]
        assert res["nested_off"] and res["restored"]


def test_debug_and_production_meshes_over_the_world(pool):
    for res in pool.run(_rank_meshes):
        assert res["debug"] == {"axis_names": ["data", "model"],
                                "shape": [2, 2], "n_devices": 4}
        assert res["production"] == ("a (16, 16) mesh needs 256 ranks, "
                                     "the process group has 4")


def test_initialize_in_world_1_brings_up_no_group(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    want = {"process_id": 0, "num_processes": 1, "local_devices": 1,
            "global_devices": 1}
    assert D.initialize(device="cpu") == want
    assert D.initialize(device="cpu") == want          # idempotent
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert D.initialize(device="cpu") == want


def test_make_mesh_brings_up_a_one_rank_group_itself():
    assert not dist.is_initialized()
    try:
        mesh = tmesh.make_mesh((1, 1), AXES, device_type="cpu")
        assert dist.get_world_size() == 1
        assert tmesh.mesh_summary(mesh) == {"axis_names": list(AXES),
                                            "shape": [1, 1], "n_devices": 1}
        # a second mesh reuses the group
        again = tmesh.make_mesh((1,), ("data",), device_type="cpu")
        assert again.mesh_dim_names == ("data",)
        with pytest.raises(ValueError, match="needs 4 ranks"):
            tmesh.make_mesh((2, 2), AXES, device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_initialize_in_world_2_is_idempotent(tmp_path):
    """Then a rank's error comes home with its traceback."""
    with D.RankPool(2, tmp_path, timeout=120) as two:
        res = two.run(_rank_initialize_again, 2)
        with pytest.raises(RuntimeError, match="ZeroDivisionError"):
            two.run(_rank_fails)
    for rank, r in enumerate(res):
        assert {k: r[k] for k in ("process_id", "num_processes",
                                  "local_devices", "global_devices")} == \
            {"process_id": rank, "num_processes": 2, "local_devices": 1,
             "global_devices": 2}
        assert r["world"] == 2 and r["sum"] == 3.0
        assert "already up" in r["mismatch"]


def _rank_fails():
    if dist.get_rank() == 1:
        return 1 / 0
    return 0
