"""Inverse rendering: fit scene parameters to target images
(``raytpu/diff/fit.py``).

BASELINE config 4 ("differentiable vertex+texture optimization").  The loss
is the pixel MSE between a differentiable render (``cfg.differentiable``,
``quantize=NONE``: render/wavefront.py) and a target image; the parameters
are any group of scene fields (diff/params.py).

The reference's optax optimizers become ``torch.optim`` ones: ``Adam`` with
optax's defaults (betas 0.9/0.999, eps 1e-8) by default, ``SGD`` for
``optax.sgd``.  They hold their state and update the parameter tensors in
place, so a step takes the parameters and returns the loss.

The walk reads the bake's cluster tables, not the current parameters:
between re-bakes the detached hit search lags the geometry (the recompute
of u, v and t always uses the current values).  ``fit(rebuild_every=N)``
re-bakes every N steps (``rebuild_accel``).

With a device mesh (dist/mesh.py) the step is the JAX package's sharded
step (raytpu/diff/fit.py:117-140): the rays are cut into equal shards,
each entry runs its forward and backward on its replica of the scene and
of the parameters, the gradients' mean over the mesh
(``hierarchical_pmean``) becomes the parameters' ``.grad``, the loss is the
mean over the shards, and the optimizer steps once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from raytpu_torch.config import Quantize, RenderConfig
from raytpu_torch.core.camera import Camera, camera_rays
from raytpu_torch.diff.params import (GEOMETRY, SHADE_COLUMNS,
                                      SHADE_CONST_FIELDS, TEXTURE,
                                      apply_params, extract_params)
from raytpu_torch.render.wavefront import render_rays
from raytpu_torch.scene.types import FlatScene

Optimizer = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]


def _diff_cfg(cfg: RenderConfig) -> RenderConfig:
    return dataclasses.replace(cfg, differentiable=True,
                               quantize=Quantize.NONE)


def render_loss(scene: FlatScene, cfg: RenderConfig,
                params: Dict[str, torch.Tensor], origin, direction, target,
                valid=None) -> torch.Tensor:
    """Mean-squared pixel error of the differentiable render.

    ``valid`` (optional (R,) bool): rows left out of the loss; their color
    is zeroed against a zero target, so they add exactly zero error and
    zero gradient, and the mean is diluted by n_valid / n."""
    colors = render_rays(apply_params(scene, params), _diff_cfg(cfg), origin,
                         direction)
    if valid is not None:
        colors = torch.where(valid[:, None], colors, 0.0)
    return torch.mean((colors - target) ** 2)


def make_fit_step(scene: FlatScene, cfg: RenderConfig,
                  optimizer: torch.optim.Optimizer, mesh=None,
                  fields: Optional[Sequence[str]] = None) -> Callable:
    """Build ``step(params, origin, direction, target) -> loss``: one
    forward, backward and ``optimizer`` update of ``params`` (the tensors
    the optimizer holds, updated in place); the loss comes back detached.

    ``step.set_scene(s)`` swaps in a re-baked scene (``rebuild_accel``),
    ``step.set_valid(v)`` a loss mask (``render_loss``).  ``fields`` picks
    the gather's gradient channels: only geometry channels when no trained
    field flows through the others (config.py ``grad_channels``).

    ``mesh``: the sharded step (module docstring); the rays, the target and
    a loss mask come in equal shards (``fit`` pads them), and the scene is
    replicated once per ``set_scene``."""
    cfg = _diff_cfg(cfg)
    # has_dual_branch is a bake-time flag (reflection XOR refraction per
    # material).  A fit of mat_reflect can make a transparent material
    # reflective too; the merged single-child levels would then drop the
    # refraction branch, so the dual-branch levels are forced.
    force_dual = ("mat_reflect" in (fields or ())
                  and scene.has_transparent and not scene.has_dual_branch)

    def dual(s):
        if force_dual and s.has_transparent and not s.has_dual_branch:
            return dataclasses.replace(s, has_dual_branch=True)
        return s

    if fields is not None:
        cfg = dataclasses.replace(
            cfg, grad_channels=("all" if set(fields) & SHADE_CONST_FIELDS
                                else "geometry"))
    box = {"scene": dual(scene), "valid": None, "replicas": None}

    def set_scene(s):
        box["scene"] = dual(s)
        if mesh is not None:
            from raytpu_torch.dist.mesh import replicate_scene

            box["replicas"] = replicate_scene(box["scene"], mesh)

    set_scene(scene)

    def step(params, origin, direction, target):
        optimizer.zero_grad(set_to_none=True)
        if mesh is not None:
            loss = _sharded_backward(box["replicas"], cfg, params, origin,
                                     direction, target, box["valid"], mesh)
        else:
            loss = render_loss(box["scene"], cfg, params, origin, direction,
                               target, box["valid"])
            loss.backward()
        optimizer.step()
        return loss.detach()

    step.set_scene = set_scene
    step.set_valid = lambda v: box.__setitem__("valid", v)
    return step


def _sharded_backward(replicas, cfg, params, origin, direction, target,
                      valid, mesh):
    """The sharded forward and backward: shard ``i`` of the rays on entry
    ``i`` against its own copy of the parameters; the gradients' mean over
    the mesh goes into the parameters' ``.grad``.  Returns the loss, the
    mean of the shards' (their global mean: the shards are equal)."""
    from raytpu_torch.dist.mesh import hierarchical_pmean

    n = origin.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rays do not cut into {mesh.size} equal "
                         "shards: pad them (fit does, with a loss mask)")
    chunk = n // mesh.size
    names = sorted(params)
    losses, grads = [], []
    for i, (rep, dev) in enumerate(zip(replicas, mesh.device_list)):
        s = slice(i * chunk, (i + 1) * chunk)
        local = {k: params[k].detach().to(dev).requires_grad_()
                 for k in names}
        loss = render_loss(rep, cfg, local, origin[s].to(dev),
                           direction[s].to(dev), target[s].to(dev),
                           None if valid is None else valid[s].to(dev))
        g = torch.autograd.grad(loss, [local[k] for k in names],
                                allow_unused=True)
        grads.append({k: torch.zeros_like(local[k]) if x is None else x
                      for k, x in zip(names, g)})
        losses.append(loss.detach())
    mean = hierarchical_pmean(grads, mesh)
    for k in names:
        params[k].grad = mean[k].to(params[k].device)
    return hierarchical_pmean(losses, mesh)


def rebuild_accel(scene: FlatScene, params: Dict[str, torch.Tensor],
                  pad_clusters_to: Optional[int] = None) -> FlatScene:
    """Re-bake the cluster tables from the current fitted geometry.

    Host-side (accel/clusters.py), at the bake's leaf size: a subcluster
    bake (cluster size 64 or 32) packs several leaves per 128-lane block,
    and its re-bake does again (raytpu/diff/fit.py:180-188).
    ``pad_clusters_to``, a count of leaves, keeps every table's shape
    across re-bakes.  Rows whose mesh id is -1 (padding rows of a bridged
    bake) are left out, as the reference leaves out its invalid
    triangles.  The bake's optional tables are mirrored: a bake with
    ``gblock`` keeps it (raytpu/diff/fit.py:189-195).  The octree, if any,
    is not rebuilt, as in the JAX package (use the cluster backends while
    fitting)."""
    from raytpu_torch.accel.clusters import build_clusters, leaf_size

    with torch.no_grad():
        shade = apply_params(scene, params).tri_shade.cpu().numpy()
    col = lambda f: shade[:, slice(*SHADE_COLUMNS[f])]  # noqa: E731
    v1, e1, e2 = col("tri_v1"), col("tri_e1"), col("tri_e2")
    mesh = shade[:, 31].view(np.int32)
    verts = np.stack([v1, v1 + e1, v1 + e2], axis=1)
    ct = build_clusters(verts, cluster_size=leaf_size(scene.clusters),
                        valid=mesh >= 0, pad_clusters_to=pad_clusters_to)
    tables = ct.as_device_arrays(v1, e1, e2, mesh, col("tri_snormal"),
                                 build_gblock="gblock" in scene.clusters)
    return dataclasses.replace(scene, clusters={
        k: torch.from_numpy(a).to(scene.device) for k, a in tables.items()})


def _adam(learning_rate: float) -> Optimizer:
    return lambda ps: torch.optim.Adam(ps, lr=learning_rate)


def fit(scene: FlatScene, cfg: RenderConfig, camera: Camera, target_image,
        fields: Sequence[str] = GEOMETRY + TEXTURE,
        steps: int = 100, learning_rate: float = 1e-2,
        optimizer: Optional[Optimizer] = None,
        mesh=None,
        callback: Optional[Callable[[int, float], None]] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        rebuild_every: int = 0,
        ) -> Tuple[FlatScene, Dict, list]:
    """Optimize ``fields`` of ``scene`` so its render matches
    ``target_image`` ((H, W, 3) or (H*W, 3)).

    Returns (fitted scene, fitted params, per-step loss history).
    ``optimizer``: a function of the parameter tensors returning a
    ``torch.optim`` optimizer (default ``Adam(learning_rate)``).  With
    ``checkpoint_dir`` set, the params and optimizer state are saved every
    ``checkpoint_every`` steps and the fit resumes from the latest save if
    one exists (io/checkpoint.py).  ``rebuild_every``: re-bake the cluster
    tables from the current geometry every N steps, padded to a fixed
    cluster count (``rebuild_accel``); the walk's hit search lags the
    geometry by at most N steps.  ``mesh``: the sharded step
    (``make_fit_step``), the rays padded to equal shards with rays that the
    loss leaves out (zero error, zero gradient).
    """
    params = extract_params(scene, fields)
    # The optimizer holds the tensors in the order of their names, so a
    # saved state restores whatever order ``fields`` came in.
    opt = (optimizer or _adam(learning_rate))(
        [params[k] for k in sorted(params)])
    dev = scene.device
    o, d = camera_rays(camera, cfg.width, cfg.height, device=dev)
    target = torch.as_tensor(target_image, dtype=torch.float32,
                             device=dev).reshape(-1, 3)
    start_step = 0
    valid = None
    if mesh is not None:
        n = o.shape[0]
        pad = (-n) % mesh.size
        if pad:
            o = torch.cat([o, o.new_zeros((pad, 3))])
            d = torch.cat([d, d.new_ones((pad, 3))])
            target = torch.cat([target, target.new_zeros((pad, 3))])
            valid = torch.arange(o.shape[0], device=dev) < n

    ckpt = None
    if checkpoint_dir is not None:
        from raytpu_torch.io.checkpoint import FitCheckpointer

        ckpt = FitCheckpointer(checkpoint_dir)
        restored = ckpt.restore_latest()
        if restored is not None:
            start_step, (saved, opt_state) = restored
            with torch.no_grad():
                for k, x in params.items():
                    x.copy_(saved[k])
            opt.load_state_dict(opt_state)

    pad_to = None
    if rebuild_every:
        # After the restore: a resumed fit re-bakes from the restored
        # geometry.  Slack for the leaf count's drift across re-bakes.
        from raytpu_torch.accel.clusters import leaves_per_block

        nc0 = scene.clusters["block"].shape[0] * leaves_per_block(
            scene.clusters)
        pad_to = nc0 + max(8, nc0 // 8)
        scene = rebuild_accel(scene, params, pad_to)

    step_fn = make_fit_step(scene, cfg, opt, mesh=mesh, fields=fields)
    if valid is not None:
        step_fn.set_valid(valid)
    history = []
    for i in range(start_step, steps):
        if (pad_to is not None and i > start_step
                and (i - start_step) % rebuild_every == 0):
            try:
                scene = rebuild_accel(scene, params, pad_to)
            except ValueError:
                # The cluster count outgrew the pad: grow it rather than
                # abort a partly done fit.
                pad_to = int(pad_to * 1.5) + 8
                scene = rebuild_accel(scene, params, pad_to)
            step_fn.set_scene(scene)
        loss = float(step_fn(params, o, d, target))
        history.append(loss)
        if callback is not None:
            callback(i, loss)
        if ckpt is not None and checkpoint_every and (
                (i + 1) % checkpoint_every == 0):
            ckpt.save(i + 1, ({k: x.detach() for k, x in params.items()},
                              opt.state_dict()))
    with torch.no_grad():
        fitted = apply_params(scene, params)
    return fitted, params, history
