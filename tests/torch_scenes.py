"""Shared helpers of the ``test_torch_*`` parity tests: the same small scenes
built with both packages, the bridge from the JAX bake, seeded rays."""

from __future__ import annotations

import numpy as np
import torch

from raytpu.scene import lights as jlights
from raytpu.scene import procedural as jproc
from raytpu.scene import types as jtypes
from raytpu_torch.bridge import (META, TABLES, flat_scene_from_numpy,
                                 instanced_scene_from_numpy)
from raytpu_torch.scene import lights as tlights
from raytpu_torch.scene import procedural as tproc
from raytpu_torch.scene import types as ttypes
from tests.scenes import checker_texture

PACKAGES = {
    "jax": (jtypes, jproc, jlights),
    "torch": (ttypes, tproc, tlights),
}


def sphere_and_plane(pkg: str, reflect=0.3, textured=False, light="spot",
                     transparent=False, plane_reflect=0.0):
    """tests/scenes.py::sphere_and_plane_scene, built with ``pkg``'s types
    (``plane_reflect``: the ground's reflectiveness)."""
    types, proc, lights = PACKAGES[pkg]
    mat_s = types.Material(
        reflectiveness=reflect, transparent=transparent,
        refraction_index=1.32, use_texture=False,
        diffuse_color=(0.9, 0.2, 0.2, 0.65 if transparent else 1.0))
    mat_p = types.Material(reflectiveness=plane_reflect,
                           diffuse_color=(0.4, 0.45, 0.5, 1.0))
    if textured:
        mat_p.use_texture = True
        mat_p.texture = checker_texture()
    spot = lights.SpotLight(position=(0, 5, 20),
                            direction=(0.0, -0.2425356, -0.9701425))
    lts = {
        "spot": [spot],
        "directional": [lights.DirectionalLight(direction=(0.0, -1.0, 0.0))],
        "both": [spot, lights.DirectionalLight(direction=(0.3, -0.9, 0.1))],
    }[light]
    return types.Scene(
        objects=[
            types.SceneObject(
                meshes=[proc.uv_sphere(radius=4.0, stacks=8, slices=12,
                                       material=mat_s)],
                position=(0.0, 4.0, 0.0)),
            types.SceneObject(meshes=[proc.plane(size=(40.0, 40.0),
                                                 material=mat_p)]),
        ],
        lights=lts)


def flagship(pkg: str):
    """__graft_entry__.py::_flagship_scene, built with ``pkg``'s types: a
    glass sphere (reflective and transparent: a dual-branch material), a
    textured crate and a reflective ground, a spot and a directional
    light."""
    types, proc, lights = PACKAGES[pkg]
    yy, xx = np.mgrid[0:32, 0:32]
    checker = np.where((((yy // 4) + (xx // 4)) % 2 == 0)[..., None], 255, 40)
    checker = np.broadcast_to(checker, (32, 32, 3)).astype(np.uint8)
    glass = types.Material(reflectiveness=0.7, transparent=True,
                           refraction_index=1.32,
                           diffuse_color=(0.9, 0.9, 1.0, 0.55))
    crate = types.Material(reflectiveness=0.2, use_texture=True,
                           texture=checker)
    ground = types.Material(reflectiveness=0.1,
                            diffuse_color=(0.4, 0.45, 0.5, 1.0))
    return types.Scene(
        objects=[
            types.SceneObject(
                meshes=[proc.uv_sphere(radius=4.0, stacks=10, slices=16,
                                       material=glass, convex=True)],
                position=(-5.0, 4.0, 0.0)),
            types.SceneObject(meshes=[proc.box(size=(6.0, 6.0, 6.0),
                                               material=crate)],
                              position=(5.0, 3.0, 0.0),
                              rotation=(0.0, 0.6, 0.0)),
            types.SceneObject(meshes=[proc.plane(size=(60.0, 60.0),
                                                 material=ground)]),
        ],
        lights=[lights.SpotLight(position=(0, 5, 20),
                                 direction=(0.0, -0.2425356, -0.9701425)),
                lights.DirectionalLight(direction=(0.3, -0.9, 0.1))])


def terrain(pkg: str, divisions: int = 24):
    """bench.py's height-field terrain and spot light at a small size."""
    types, proc, lights = PACKAGES[pkg]
    mat = types.Material(reflectiveness=0.0,
                         diffuse_color=(0.7, 0.6, 0.5, 1.0))
    mesh = proc.subdivided_plane(
        size=(40.0, 40.0), divisions=divisions, material=mat,
        height_fn=lambda x, z: 2.0 * np.sin(x * 0.7) * np.cos(z * 0.7)
        + 0.5 * np.sin(x * 3.1) * np.sin(z * 2.3))
    return types.Scene(
        objects=[types.SceneObject(meshes=[mesh])],
        lights=[lights.SpotLight(position=(0.0, 30.0, 25.0),
                                 direction=(0.0, -0.7682213, -0.6401844))])


def instanced_scene(pkg: str, reflect=0.4, transparent=False):
    """tests/test_instanced_render.py::_scene, built with ``pkg``'s types:
    two instances of ONE sphere mesh (moved, scaled, rotated) over a
    textured ground plane, one spot light."""
    types, proc, lights = PACKAGES[pkg]
    mat = types.Material(
        reflectiveness=reflect, transparent=transparent,
        refraction_index=1.32,
        diffuse_color=(0.8, 0.2, 0.2, 0.6 if transparent else 1.0))
    sphere = proc.uv_sphere(radius=2.0, stacks=8, slices=12, material=mat)
    ground = types.Material(use_texture=True, texture=checker_texture(),
                            reflectiveness=0.0)
    return types.Scene(
        objects=[
            types.SceneObject(meshes=[sphere], position=(-3.0, 2.0, 0.0)),
            types.SceneObject(meshes=[sphere], position=(3.5, 3.0, -2.0),
                              scale=(1.5, 1.5, 1.5), rotation=(0.0, 0.8, 0.0)),
            types.SceneObject(meshes=[proc.plane(size=(40.0, 40.0),
                                                 material=ground)]),
        ],
        lights=[lights.SpotLight(position=(0.0, 5.0, 20.0),
                                 direction=(0.0, -0.2425356, -0.9701425))])


def jax_bake(scene, cluster_size):
    return scene.flatten(build_octree=False, cluster_size=cluster_size)


def jax_arrays(jflat):
    """A JAX FlatScene as the bridge's ``(arrays, meta)``; the cluster
    arrays are writable copies."""
    arrays = {k: np.asarray(getattr(jflat, k)) for k in TABLES}
    arrays["lights"] = {k: np.asarray(v) for k, v in jflat.lights.items()}
    arrays["clusters"] = {k: np.array(v) for k, v in jflat.clusters.items()}
    arrays["octree"] = (None if jflat.octree is None else
                        {k: np.array(v) for k, v in jflat.octree.items()})
    return arrays, {k: getattr(jflat, k) for k in META}


def to_port(jflat):
    """The port's FlatScene of a JAX FlatScene, through the bridge."""
    return flat_scene_from_numpy(*jax_arrays(jflat), device="cpu")


def jax_instanced_arrays(jisc):
    """A JAX InstancedScene as the instanced bridge's arguments."""
    return ([jax_arrays(b) for b in jisc.bakes],
            [(i.mesh_index, i.world, i.inv_world) for i in jisc.instances],
            {k: np.asarray(v) for k, v in jisc.lights.items()},
            jisc.num_lights)


def to_port_instanced(jisc):
    """The port's InstancedScene of a JAX one, through the bridge."""
    return instanced_scene_from_numpy(*jax_instanced_arrays(jisc),
                                      device="cpu")


def random_rays(seed: int, n: int):
    """The TestFusedKernel recipe (tests/test_accel.py): origins above the
    plane, unit directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-20, 20, size=(n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 0.5
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def t(a):
    """A numpy array as a CPU tensor (copied, so it is writable)."""
    return torch.from_numpy(np.array(a))


def reference_screen_rays(camera, width, height, sx, sy):
    """The JAX package's rays through the screen points ``sx``, ``sy`` (the
    port's tensors) for the port's ``camera``, as tensors on their device.

    The two packages invert the camera with different LAPACK routines
    (~4e-6 apart on unit directions, test_torch_core.py); patched in for
    the port's own rays, it makes both packages trace the same rays."""
    import dataclasses

    import jax

    from raytpu.core.camera import Camera as JaxCamera
    from raytpu.core.camera import rays_through_screen

    jcam = JaxCamera(**dataclasses.asdict(camera))
    fn = _REFERENCE_RAYS.setdefault(
        "fn", jax.jit(rays_through_screen, static_argnums=(0, 1, 2)))
    o, d = fn(jcam, width, height, sx.cpu().numpy(), sy.cpu().numpy())
    return t(o).to(sx.device), t(d).to(sx.device)


def reference_camera_rays(camera, width, height, device="cuda"):
    """``camera_rays`` with the JAX package's rays (reference_screen_rays)."""
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32),
                            torch.arange(width, dtype=torch.float32),
                            indexing="ij")
    o, d = reference_screen_rays(camera, width, height, xs.reshape(-1),
                                 ys.reshape(-1))
    return o.to(device), d.to(device)


_REFERENCE_RAYS = {}
