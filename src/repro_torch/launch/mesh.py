"""Device meshes (port of ``repro.launch.mesh``): a ``DeviceMesh`` with
the JAX package's axis names over a ``torch.distributed`` process group.

Functions, not module constants: importing touches no process group.
``make_mesh`` starts the group when none is running — the world that
``torchrun``'s environment describes (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``), else a world of one on a free
localhost port — with NCCL for the card and gloo for the CPU.

The production meshes follow the card's layout, not a TPU torus: the
'model' (tensor-parallel) axis stays inside one 8-GPU NVLink domain,
where its per-layer collectives run at NVLink rate, and 'data' (and
'pod') span the hosts.  ``(32, 8)`` is 256 H100s; ``(2, 32, 8)`` is 512.
"""

from __future__ import annotations

import os
import socket

import torch

PRODUCTION_SHAPE = (32, 8)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 32, 8)
MULTI_POD_AXES = ("pod", "data", "model")

# the record names of the two meshes (``dryrun`` writes them, ``roofline``
# keys its device counts by them)
MESH_NAMES = {PRODUCTION_SHAPE: "32x8", MULTI_POD_SHAPE: "2x32x8"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ensure_process_group(device="cuda") -> None:
    """Start the default process group for ``device`` unless one runs."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
        return
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{_free_port()}",
        rank=0, world_size=1)


def world_size() -> int:
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def make_mesh(shape, axes, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group (started here when none runs); the group's world must
    hold exactly ``prod(shape)`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = torch.device(device)
    ensure_process_group(dev)
    n = 1
    for s in shape:
        n *= s
    if world_size() != n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks; the process "
                         f"group has {world_size()}")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """256 H100s as (data 32, model 8); 512 as (pod 2, data 32, model 8)."""
    if multi_pod:
        return make_mesh(MULTI_POD_SHAPE, MULTI_POD_AXES, device)
    return make_mesh(PRODUCTION_SHAPE, PRODUCTION_AXES, device)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, device="cpu"):
    """A small (data, model) mesh for tests (needs n_data*n_model ranks)."""
    return make_mesh((n_data, n_model), ("data", "model"), device)


# H100 roofline constants — the single source of truth is the port's
# MachineFacts schema (profiler/facts.py), which a measured profile may
# override; these names re-export its analytic defaults
from repro_torch.profiler.facts import HBM_BW  # noqa: E402,F401  bytes/s
from repro_torch.profiler.facts import ICI_BW  # noqa: E402,F401  NVLink
from repro_torch.profiler.facts import \
    PEAK_FLOPS_BF16  # noqa: E402,F401  per GPU
