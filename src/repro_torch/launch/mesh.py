"""Device meshes (port of ``repro.launch.mesh``).

Functions, not module constants, so importing never touches the process
group. Single pod: 16×16 = 256 ranks, axes (data, model). Multi-pod:
2×16×16 = 512 ranks, axes (pod, data, model) — 'pod' joins the DP axes.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group; its device type is explicit: ``"cuda"`` unless the caller
asks for ``"cpu"`` (the tests and the dry run, whose fake process group
holds no card).
"""
from __future__ import annotations

import contextlib
import math

FAKE_GROUP_HINT = (
    "the dry run makes a fake group of that size before it builds the "
    "mesh: torch.distributed.init_process_group('fake', "
    "store=torch.testing._internal.distributed.fake_pg.FakeStore(), "
    "rank=0, world_size=512) — see repro_torch.launch.dryrun")


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (16, 16) ``(data, model)`` mesh, or (2, 16, 16) ``(pod, data,
    model)`` with ``multi_pod``, over the default process group, which must
    hold that many ranks."""
    import torch.distributed as dist

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise RuntimeError(
            f"need a process group of {n} ranks for the production mesh, "
            f"found {have} — {FAKE_GROUP_HINT}")
    return _mesh(shape, axes, device_type)


def make_host_mesh(shape: tuple[int, ...] = (1, 1),
                   axes: tuple[str, ...] = ("data", "model"), *,
                   device: str = "cuda"):
    """A mesh over the ranks that exist — on the card one NCCL rank (the
    one-rank group of ``dist.topology.Topology``, joined here when no group
    exists yet), on the CPU one gloo rank."""
    import torch

    from repro_torch.dist.topology import Topology

    dev = torch.device(device)
    Topology(num_processes=1).initialize(dev)
    return _mesh(shape, axes, dev.type)


def mesh_context(mesh):
    """Activate ``mesh`` for the enclosed calls: the policy entry ``mesh``
    that a shard-local block's collectives over named axes read. ``None``
    gives a null context."""
    if mesh is None:
        return contextlib.nullcontext()
    from repro_torch.dist import policy
    return policy.use(mesh=mesh)
