"""Device meshes over the ranks of a ``torch.distributed`` process group
(port of ``sir_gcn_tpu/parallel/mesh.py``).

The JAX package is single-controller: one process builds a ``Mesh`` over
``jax.devices()`` and ``shard_map`` runs a program on each. The port is
multi-controller: one process a rank, one card a rank (``cuda:<local
rank>``; gloo ranks on the CPU), so a mesh names the ranks of the process
group, and each rank computes its own shard. Call
``multihost.initialize_multihost`` (or spawn the ranks with
``multihost.spawn_ranks``) first.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch.distributed as dist


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data",),
              device_type: str = "cpu"):
    """A ``DeviceMesh`` over the process group's ranks:
    ``make_mesh()`` -> one ``data`` axis over every rank;
    ``make_mesh((2, 4), ("data", "graph"))`` -> 2 x 4. ``device_type`` is
    "cuda" for NCCL ranks, "cpu" for gloo ones. ``mesh.get_group(name)``
    is an axis's process group."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group")
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = (world,)
    size = 1
    for a in axis_sizes:
        size *= int(a)
    if size != world:
        raise ValueError(f"mesh {tuple(axis_sizes)} != {world} ranks")
    return init_device_mesh(device_type, tuple(int(a) for a in axis_sizes),
                            mesh_dim_names=tuple(axis_names))
