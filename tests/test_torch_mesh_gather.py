"""The port's repair of the functional all-gather for gloo ranks whose
tensors lie on a card (`launch.distributed.repair_gloo_cuda_gather` and
its body `gloo_all_gather`), on the CPU: 4 gloo ranks in one
module-scoped `RankPool` call the body on CPU tensors and hold it, bit
for bit, to torch's functional all-gather (`funcol.all_gather_tensor`)
of the same inputs; installing the repair leaves the op's CPU kernel as
torch registers it and gives it a CUDA one; a group whose backend is not
gloo is refused, at install and by the body at every call. The body on
CUDA tensors, and a (2, 2) forward whose ranks launch flash on the card,
are in `tests/test_torch_cuda.py`.
No JAX here: the ranks import this file."""
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import distributed as D

OP = "_c10d_functional::all_gather_into_tensor"


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


def _kernels(table: str) -> dict:
    """Dispatch key -> its line of `_dispatch_dump_table`, for CPU and
    CUDA."""
    return {ln.split(":", 1)[0]: ln for ln in table.splitlines()
            if ln.split(":", 1)[0] in ("CPU", "CUDA")}


def _rank_gathers(dtype_name: str, rows: int, cols: int):
    """This rank's rows of a seeded [rows, cols] tensor split over the 4
    ranks as DTensor splits it (padded to the largest shard): the body's
    gather of them against funcol's, byte for byte; and the unpadded
    gather against the whole tensor."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    dtype = getattr(torch, dtype_name)
    world, rank = dist.get_world_size(), dist.get_rank()
    whole = (torch.randn(rows, cols, generator=torch.Generator()
                         .manual_seed(rows * cols)) * 8).to(dtype)
    mesh = init_device_mesh("cpu", (world,))
    local = distribute_tensor(whole, mesh, [Shard(0)]).to_local()
    per = -(-rows // world)
    padded = torch.cat([local, local.new_zeros(per - local.shape[0], cols)])
    group = dist.group.WORLD
    got = D.gloo_all_gather(padded, world, group.group_name)
    want = funcol.wait_tensor(funcol.all_gather_tensor(padded, 0, group))
    unpadded = torch.cat([got[r * per:(r + 1) * per][
        :max(0, min(per, rows - r * per))] for r in range(world)])
    return {"rank": rank, "shape": list(got.shape), "dtype": str(got.dtype),
            "bit_equal": got.dtype == want.dtype
            and got.shape == want.shape
            and torch.equal(got.view(torch.uint8), want.view(torch.uint8)),
            "whole": torch.equal(unpadded, whole)}


# a dim that 4 divides, and ones DTensor pads (10 and 7 rows over 4)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,cols", [(8, 3), (10, 3), (7, 5)])
def test_the_repaired_gather_is_bit_equal_to_funcol(pool, dtype, rows, cols):
    res = pool.run(_rank_gathers, dtype, rows, cols)
    per = -(-rows // 4)
    for r in res:
        assert r["bit_equal"] and r["whole"], r
        assert r["shape"] == [4 * per, cols]
        assert r["dtype"] == f"torch.{dtype}"


def _rank_install():
    """Install the repair in this rank (a gloo group): the op's CPU kernel
    line before and after, its CUDA line after, whether a second install
    returns the same registration, and funcol's CPU gather after it
    against the body."""
    import torch.distributed._functional_collectives as funcol
    before = _kernels(torch._C._dispatch_dump_table(OP))
    lib = D.repair_gloo_cuda_gather()
    again = D.repair_gloo_cuda_gather()
    after = _kernels(torch._C._dispatch_dump_table(OP))
    x = torch.arange(6, dtype=torch.float32) + 10 * dist.get_rank()
    group = dist.group.WORLD
    via_op = funcol.wait_tensor(funcol.all_gather_tensor(x, 0, group))
    body = D.gloo_all_gather(x, dist.get_world_size(), group.group_name)
    return {"cpu_before": before["CPU"], "cpu_after": after["CPU"],
            "cuda_before": before.get("CUDA"), "cuda_after": after["CUDA"],
            "same": lib is again,
            "cuda_kernel": torch._C._dispatch_has_kernel_for_dispatch_key(
                OP, "CUDA"),
            "cpu_gather_equal": torch.equal(via_op, body)}


def test_install_leaves_the_cpu_kernel_and_registers_a_cuda_one(pool):
    for r in pool.run(_rank_install):
        assert r["cpu_after"] == r["cpu_before"]
        assert r["cuda_after"] != r["cuda_before"]
        assert r["cuda_kernel"] and r["same"]
        assert r["cpu_gather_equal"]


@pytest.mark.parametrize("backend", ["fake", "nccl"])
def test_a_group_that_is_not_gloo_is_refused(backend, monkeypatch):
    """The `fake` backend's group (the dry-run's) and an nccl one (named
    so: this host's torch has no nccl): the repair raises and registers
    nothing."""
    from repro_torch.launch import dryrun as DR
    before = _kernels(torch._C._dispatch_dump_table(OP))
    with DR.fake_world(4):
        if backend == "nccl":
            monkeypatch.setattr(dist, "get_backend", lambda group=None:
                                "nccl")
        with pytest.raises(ValueError, match=backend):
            D.repair_gloo_cuda_gather()
    assert D._GATHER_REPAIR is None
    assert _kernels(torch._C._dispatch_dump_table(OP)) == before


@pytest.mark.parametrize("backend", ["fake", "nccl"])
def test_the_body_refuses_a_group_that_is_not_gloo(backend, monkeypatch):
    """The kernel serves the op in every group of a process, so its body
    checks the group it is handed: on a `fake` group (the dry-run's) and
    one named nccl it raises before it gathers."""
    from repro_torch.launch import dryrun as DR
    with DR.fake_world(4):
        if backend == "nccl":
            monkeypatch.setattr(dist, "get_backend", lambda group=None:
                                "nccl")
        name = dist.group.WORLD.group_name
        with pytest.raises(RuntimeError, match=backend):
            D.gloo_all_gather(torch.ones(2, 3), 4, name)
