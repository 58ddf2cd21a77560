"""Device meshes and scene replication (``raytpu/dist/mesh.py``).

The reference's only parallelism is a shared-memory scanline pool with an
atomic dispenser (RayTracer.cs:48-52, :81-120).  The JAX package's
counterpart is data parallelism over the ray dimension of a device mesh,
with the scene replicated on every device; this module is the port's.

The mesh is single-controller, as the JAX package's is: one process holds
every device of the mesh and drives them in turn, and a collective is a
loop over the mesh's devices with ``.to()`` for the traffic.  A device may
appear more than once: a mesh of four entries of ``cuda:0`` runs every
sharded entry point at four shards on one card, as the JAX tests run
theirs on eight virtual CPU devices of one host.  Meshes that span
processes (``torch.distributed``) are not built.

``pvary_tree`` (raytpu/dist/mesh.py:29-36) is a ``shard_map`` type
annotation and has no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from raytpu_torch.device import resolve


class Mesh:
    """Devices in a grid with named axes, like ``jax.sharding.Mesh``.

    ``devices``: a NumPy object array of ``torch.device`` of the mesh's
    shape; ``axis_names``; ``shape``: axis name -> size; ``size``: the
    device count; ``device_list``: the devices in row-major order (shard
    ``i`` of a sharded entry point lives on ``device_list[i]``)."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> list:
        return list(self.devices.flat)


def _canonical(device) -> torch.device:
    """``device`` resolved (a CUDA device without a card raises), with the
    index of the current CUDA device where it names none, so that equal
    devices compare equal."""
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices: Optional[Sequence] = None,
              axes: Tuple[str, ...] = ("rays",),
              shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """A mesh over ``devices`` (default: every CUDA device of this process;
    none raises).  CPU entries are named explicitly, and an entry may
    repeat.

    1-D ``("rays",)`` for ray data parallelism; 2-D ``("hosts", "chips")``
    for the hierarchical reduction, ``shape=(hosts, chips_per_host)``
    (default: one host, as one process sees one)."""
    if devices is None:
        _canonical("cuda")  # raises where torch finds no card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_canonical(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if shape is None:
        if len(axes) == 1:
            shape = (len(devices),)
        elif len(axes) == 2:
            shape = (1, len(devices))
        else:
            raise ValueError("give an explicit shape for >2 mesh axes")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), axes)


def _leaves(trees, key):
    return [t if key is None else t[key] for t in trees]


def _sum_to(xs, dev):
    total = xs[0].to(dev)
    for x in xs[1:]:
        total = total + x.to(dev)
    return total


def hierarchical_pmean(trees: Sequence, mesh: Mesh):
    """The mean over the mesh of per-shard tensors or dicts of tensors
    (``trees[i]`` from shard ``i``, row-major), on the mesh's first device.

    1-D mesh: the flat mean.  2-D ``("hosts", "chips")``: the hierarchical
    all-reduce of the JAX package (raytpu/dist/mesh.py:61-100): a
    reduce-scatter over the chips of each host (chip c sums slice c of dim
    0 of its host's shards), the sum of each slice over the hosts (the
    cross-host step carries 1/chips of the bytes), then the slices gathered
    back.  Leaves whose dim 0 does not tile over the chips take the flat
    sum, as there."""
    if len(trees) != mesh.size:
        raise ValueError(f"{len(trees)} shards for a mesh of {mesh.size}")
    devs = mesh.devices
    dev0 = mesh.device_list[0]
    total = mesh.size
    keys = list(trees[0]) if isinstance(trees[0], dict) else [None]
    out = {}
    for key in keys:
        xs = _leaves(trees, key)
        if len(mesh.axis_names) == 1:
            out[key] = _sum_to(xs, dev0) / total
            continue
        hosts, chips = devs.shape
        x0 = xs[0]
        if x0.ndim >= 1 and x0.shape[0] >= chips and x0.shape[0] % chips == 0:
            part = [[x.chunk(chips, dim=0) for x in
                     xs[h * chips:(h + 1) * chips]] for h in range(hosts)]
            # Reduce-scatter over chips: chip c of host h sums slice c.
            scat = [[_sum_to([p[c] for p in part[h]], devs[h, c])
                     for c in range(chips)] for h in range(hosts)]
            # Sum each slice over the hosts, then gather the slices.
            red = [_sum_to([scat[h][c] for h in range(hosts)], devs[0, c])
                   for c in range(chips)]
            out[key] = torch.cat([r.to(dev0) for r in red]) / total
        else:
            out[key] = _sum_to(xs, dev0) / total
    return out[None] if keys == [None] else out


def ray_axis(mesh: Mesh):
    """The (flattened) axis name rays are sharded over."""
    return (mesh.axis_names[-1] if len(mesh.axis_names) == 1
            else mesh.axis_names)


def replicate_scene(scene, mesh: Mesh) -> list:
    """One copy of ``scene`` per entry of the mesh (``device_list``
    order); entries naming the same device share one copy, and the scene
    itself serves its own device.  The scene is uploaded once, not per
    frame (the "shared scene" of RayTracer's thread pool)."""
    copies = {}
    out = []
    for dev in mesh.device_list:
        if dev not in copies:
            copies[dev] = scene if scene.device == dev else scene.to(dev)
        out.append(copies[dev])
    return out
