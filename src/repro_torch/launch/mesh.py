"""Meshes for the port: the production, host and serving meshes of
``repro.launch.mesh``, as a small description plus, where one is needed,
a ``torch.distributed`` ``DeviceMesh``.

A ``Mesh`` carries ``.shape`` (axis -> size, in mesh order),
``.axis_names`` and ``.size``: that is all the sharding rules read
(``launch.sharding``), so a plan is built without any process group. A
``DeviceMesh`` is attached by ``device_mesh(mesh, backend)``:

* ``"fake"``: a fake process group of ``mesh.size`` ranks in this
  process (``torch.testing._internal.distributed.fake_pg``), which runs
  no collective. With fake tensors it stands in for JAX's 512
  placeholder host devices: the dry-run and the roofline run the model
  on rank 0's shards of every tensor without allocating them.
* ``"gloo"`` (CPU) or ``"nccl"`` (CUDA): a real group, one process a
  rank (``torchrun``; a group of one is made in this process when none
  exists). It serves ``launch.train --mesh`` and the serving mesh.

JAX's ``axis_type_kwargs`` and ``use_abstract_mesh`` are version shims
of jax; their counterpart is ``models.shard_hints.use_mesh``, the
context that sets the ambient mesh.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass, field

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """Axis sizes in mesh order, and the ``DeviceMesh`` when the mesh
    runs (None for a plan only)."""
    shape: dict
    device_mesh: object = field(default=None, compare=False)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips when multi_pod."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


def batch_axes(mesh) -> tuple[str, ...]:
    """Axes the global batch is sharded over."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def make_host_mesh() -> Mesh:
    """A one-device mesh with the production axis names."""
    return Mesh({"data": 1, "model": 1})


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_group(backend: str) -> None:
    """Join the default process group: from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``) when it is set, else a
    group of one on a free localhost port. A group already made is
    kept."""
    if dist.is_initialized():
        return
    if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        dist.init_process_group(backend)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}",
            world_size=1, rank=0)


def device_mesh(mesh: Mesh, backend: str) -> Mesh:
    """``mesh`` with a ``DeviceMesh`` of its shape. ``backend`` "fake"
    makes a fake group of ``mesh.size`` ranks (this process is rank 0);
    "gloo" and "nccl" use the default group (``init_group``), whose
    size must be the mesh's, as ``jax.make_mesh`` requires the device
    count to match."""
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        if not dist.is_initialized():
            dist.init_process_group("fake", store=FakeStore(),
                                    world_size=mesh.size, rank=0)
        device_type = "cpu"
    else:
        init_group(backend)
        device_type = "cuda" if backend == "nccl" else "cpu"
    world = dist.get_world_size()
    if world != mesh.size:
        raise ValueError(f"mesh {dict(mesh.shape)} needs {mesh.size} "
                         f"devices; the process group has {world}")
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(device_type, tuple(mesh.shape.values()),
                          mesh_dim_names=mesh.axis_names)
    return Mesh(dict(mesh.shape), dm)


def make_serving_mesh(device: str | torch.device = "cuda") -> Mesh:
    """Data-parallel mesh over every rank of the default group (a group
    of one, on this process's device, when none exists): ``(ranks, 1)``
    on ``("data", "model")``. The serving engine splits the local
    forward's rows over ``data`` and keeps the parameters replicated; on
    one device (the H100 machine) the mesh is ``(1, 1)`` and the sharded
    forward computes what the unsharded one does."""
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    init_group(backend)
    return device_mesh(Mesh({"data": dist.get_world_size(), "model": 1}),
                       backend)


def destroy() -> None:
    """Tear the default process group down (the dry-run's fake group at
    its end)."""
    if dist.is_initialized():
        dist.destroy_process_group()
