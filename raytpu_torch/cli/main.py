"""raytpu_torch CLI — render / animate / view / fit (the port of
``raytpu/cli/main.py``).

The reference's interactive shell (Game1.cs:20-431) drives the tracer with a
keyboard: Enter renders a frame, a commented-out driver renders a turntable
animation to per-frame PNGs and stitches them into an AVI
(Game1.cs:143-210), and material/scene parameters are code + content-build
settings.  This CLI is the batch equivalent:

    python -m raytpu_torch render  --scene demo --out out.png
    python -m raytpu_torch animate --scene demo --frames 60 --out turn.avi
    python -m raytpu_torch view    --scene assets/demo.toml
    python -m raytpu_torch fit     --scene crate --steps 200 --out fit/

Scenes are either builtin procedural names (``demo`` — the reference's
four-sphere scene, Game1.cs:98-109 — ``crate``, ``spheres``), a .toml scene
file, or a path to an .obj / .fbx file (ingested like TracerModelProcessor
did at build time).

The command line runs on the card; ``main(argv, device=...)`` lets a caller
in Python name another device.  ``--devices N|all`` renders (and fits)
over a mesh of the first N CUDA devices (dist/render.py; on the CPU, N
shards of the CPU), and ``--ring`` also ring-shards the scene tables
(dist/bigscene.py), as the JAX package's CLI does
(raytpu/cli/main.py:176-249).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys

import numpy as np
import torch


def _build_scene(name: str, reflect: float, transparent: bool):
    from raytpu_torch.scene.lights import SpotLight
    from raytpu_torch.scene.procedural import (box, checker_texture, plane,
                                               uv_sphere)
    from raytpu_torch.scene.types import Material, Scene, SceneObject

    checker = checker_texture()
    ground_mat = Material(use_texture=True, texture=checker,
                          reflectiveness=0.0)
    light = SpotLight(position=(0.0, 5.0, 20.0),
                      direction=(0.0, -0.2425356, -0.9701425),
                      spot_angle=math.pi / 2)

    if name == "demo":
        # The reference's demo: 2x2 sphere grid over a ground plane with one
        # spotlight (Game1.cs:98-138).
        mat = Material(reflectiveness=reflect, transparent=transparent,
                       refraction_index=1.32,
                       diffuse_color=(0.8, 0.2, 0.2, 0.6 if transparent else 1.0))
        objs = [
            SceneObject(meshes=[uv_sphere(radius=2.0, material=mat,
                                          convex=True)],
                        position=(x, 2.0, z))
            for x in (-4.0, 4.0) for z in (-4.0, 4.0)
        ]
        objs.append(SceneObject(meshes=[plane(size=(40.0, 40.0),
                                              material=ground_mat)]))
        return Scene(objects=objs, lights=[light])
    if name == "spheres":
        mat = Material(reflectiveness=reflect,
                       diffuse_color=(0.8, 0.2, 0.2, 1.0))
        return Scene(
            objects=[
                SceneObject(meshes=[uv_sphere(radius=4.0, material=mat,
                                              convex=True)],
                            position=(0.0, 4.0, 0.0)),
                SceneObject(meshes=[plane(size=(40.0, 40.0),
                                          material=ground_mat)]),
            ],
            lights=[light],
        )
    if name == "crate":
        mat = Material(use_texture=True, texture=checker,
                       reflectiveness=reflect)
        return Scene(
            objects=[
                SceneObject(meshes=[box(size=(6.0, 6.0, 6.0), material=mat)],
                            position=(0.0, 3.0, 0.0)),
                SceneObject(meshes=[plane(size=(40.0, 40.0),
                                          material=ground_mat)]),
            ],
            lights=[light],
        )
    raise SystemExit(f"unknown builtin scene {name!r}")


def _load_scene(args):
    """Resolve ``--scene`` → (Scene, file Camera or None).

    Accepts a builtin name (demo|spheres|crate), a bare .obj/.fbx mesh
    path, or a .toml scene file — the per-asset material-params format
    (scene/sceneformat.py, the ``.contentproj`` processor-parameters
    analog)."""
    from raytpu_torch.scene.lights import SpotLight
    from raytpu_torch.scene.types import Material, Scene, SceneObject

    path = args.scene
    if os.path.exists(path):
        ext = os.path.splitext(path)[1].lower()
        if ext == ".toml":
            from raytpu_torch.scene.sceneformat import load_scene_toml

            return load_scene_toml(path)
        mat = Material(reflectiveness=args.reflect,
                       diffuse_color=(0.8, 0.7, 0.6, 1.0))
        if ext == ".obj":
            from raytpu_torch.scene.obj_loader import load_obj

            meshes = [load_obj(path, material=mat)]
        elif ext == ".fbx":
            from raytpu_torch.scene.fbx_loader import load_fbx

            meshes = load_fbx(path, material=mat)
        else:
            raise SystemExit(f"unsupported scene file {path!r}")
        s = args.obj_scale
        obj = SceneObject(meshes=meshes, scale=(s, s, s))
        light = SpotLight(position=(0.0, 5.0, 20.0),
                          direction=(0.0, -0.2425356, -0.9701425),
                          spot_angle=math.pi / 2)
        return Scene(objects=[obj], lights=[light]), None
    return _build_scene(path, args.reflect, args.transparent), None


def _camera(args, aspect: float, scene_cam=None):
    """CLI camera: scene-file camera as the base, CLI flags override."""
    from raytpu_torch.core.camera import Camera

    base = scene_cam or Camera()
    return dataclasses.replace(
        base,
        position=tuple(args.camera) if args.camera is not None else base.position,
        target=tuple(args.target) if args.target is not None else base.target,
        fov=args.fov if args.fov is not None else base.fov,
        aspect=aspect,
    )


def _config(args):
    from raytpu_torch.config import Intersector, RenderConfig, RenderMode

    return RenderConfig(
        width=args.width,
        height=args.height,
        max_reflections=args.max_reflections,
        use_multisampling=args.multisample > 0,
        multisample_quality=max(args.multisample, 1),
        intersector={
            "auto": Intersector.AUTO,
            "octree": Intersector.OCTREE,
            "brute": Intersector.BRUTE,
            "tiled": Intersector.TILED,
            "pallas": Intersector.PALLAS,
        }[args.intersector],
        render_mode={
            "shaded": RenderMode.SHADED,
            "normals": RenderMode.NORMALS,
            "convex": RenderMode.CONVEXFLAG,
        }[getattr(args, "render_mode", "shaded")],
    )


def _flatten_kwargs(args) -> dict:
    """The bake's keywords: the octree only for the queries that take it
    (the cluster tables are always baked), on the command's device."""
    return dict(build_octree=args.intersector in ("auto", "octree"),
                device=args.device)


def _flatten(scene, args):
    return scene.flatten(**_flatten_kwargs(args))


def _dump_config(cfg, out_path: str) -> None:
    """Serialize the run config alongside the output (SURVEY.md §5)."""
    base = os.path.splitext(out_path)[0]
    with open(base + ".config.json", "w") as f:
        f.write(cfg.to_json())


def _mesh(args):
    """The device mesh of ``--devices`` (a count, or 'all'; None: one
    device): the first N CUDA devices, more than there are exiting as the
    JAX CLI does; on a CPU ``device``, N entries of the CPU ('all': one)."""
    spec = getattr(args, "devices", "1")
    if spec in (None, "1", 1):
        return None
    from raytpu_torch.dist.mesh import make_mesh

    dev = torch.device(args.device)
    if dev.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        n = len(devs) if spec == "all" else int(spec)
        if n > len(devs):
            raise SystemExit(
                f"--devices {spec}: only {len(devs)} devices available")
    else:
        n = 1 if spec == "all" else int(spec)
        devs = [dev] * n
    if n <= 1:
        return None
    return make_mesh(devices=devs[:n])


def _make_frame_renderer(flat, cfg, mesh, ring: bool):
    """The frame renderer of the execution mode: ``render_image`` on the
    scene's device; with a mesh the ray-sharded render (dist/render.py),
    and with ``ring`` the ring-sharded one (dist/bigscene.py).  The scene
    is replicated or sharded once, here, not per frame."""
    if ring and mesh is None:
        raise SystemExit("--ring needs --devices > 1 (ring sharding "
                         "splits tables across a device mesh)")
    if ring:
        from raytpu_torch.dist.bigscene import (render_image_ring,
                                                shard_scene_clusters,
                                                shard_scene_shade,
                                                shard_scene_textures)

        shards = shard_scene_clusters(flat, mesh)
        shade = shard_scene_shade(flat, mesh)
        tex = shard_scene_textures(flat, mesh)  # None without an atlas
        return lambda cam, **_: render_image_ring(
            flat, cfg, cam, mesh, shards=shards, shade=shade, texshards=tex)
    if mesh is not None:
        from raytpu_torch.dist.mesh import replicate_scene
        from raytpu_torch.dist.render import render_image_sharded

        rep = replicate_scene(flat, mesh)
        return lambda cam, **_: render_image_sharded(rep, cfg, cam, mesh)
    from raytpu_torch.render import wavefront

    return lambda cam, progress=None, watch_path=None: wavefront.render_image(
        flat, cfg, cam, progress=progress, watch_path=watch_path)


def cmd_render(args) -> int:
    from raytpu_torch.io.image import write_image

    scene, scene_cam = _load_scene(args)
    flat = _flatten(scene, args)
    cfg = _config(args)
    cam = _camera(args, args.width / args.height, scene_cam)
    mesh = _mesh(args)
    render = _make_frame_renderer(flat, cfg, mesh, args.ring)
    progress = None
    if args.progress and mesh is None:
        # The reference's on-screen "N.NN %" overlay (Game1.cs:331-344).
        progress = lambda done, total: print(  # noqa: E731
            f"\r{100.0 * done / total:6.2f} %", end="", flush=True)
    elif args.progress:
        print("(--progress is per-tile host dispatch; ignored with "
              "--devices > 1)")
    img = render(cam, progress=progress,
                 watch_path=args.out if args.watch and mesh is None
                 else None)
    if args.progress:
        print()
    write_image(args.out, img)
    _dump_config(cfg, args.out)
    print(f"wrote {args.out} ({args.width}x{args.height}, "
          f"mean {float(img.mean()):.4f})")
    return 0


def cmd_animate(args) -> int:
    """Turntable render -> per-frame PNGs -> AVI (Game1.cs:143-210)."""
    from raytpu_torch.core.camera import Camera
    from raytpu_torch.io.avi import open_avi
    from raytpu_torch.io.image import read_image, to_uint8, write_image

    scene, scene_cam = _load_scene(args)
    flat = _flatten(scene, args)
    cfg = _config(args)
    base_cam = _camera(args, args.width / args.height, scene_cam)
    render = _make_frame_renderer(flat, cfg, _mesh(args), args.ring)

    frame_dir = args.frame_dir or os.path.splitext(args.out)[0] + "_frames"
    os.makedirs(frame_dir, exist_ok=True)
    _dump_config(cfg, args.out)

    cx, cy, cz = base_cam.position
    radius = math.hypot(cx, cz)
    base = math.atan2(cx, cz)

    # Per-frame PNGs double as crash checkpoints: with --resume, frames
    # already on disk are reused and only the missing ones re-render — the
    # reference's analog is re-stitching saved frame PNGs via compileVideo
    # after a crashed animation (Game1.cs:156-161, :192-210).
    with open_avi(args.out, args.width, args.height, fps=args.fps,
                  codec=args.codec) as w:
        for i in range(args.frames):
            fp = os.path.join(frame_dir, f"frame_{i:04d}.png")
            if args.resume and os.path.exists(fp):
                w.add_frame(read_image(fp))
                print(f"frame {i + 1}/{args.frames} (resumed)", flush=True)
                continue
            # Orbit the camera through 2*pi like the reference advanced the
            # object rotation per completed frame (Game1.cs:163-190).
            ang = base + 2.0 * math.pi * i / args.frames
            cam = Camera(
                position=(radius * math.sin(ang), cy, radius * math.cos(ang)),
                target=base_cam.target, fov=base_cam.fov,
                aspect=args.width / args.height,
            )
            frame = to_uint8(render(cam))
            write_image(fp, frame)
            w.add_frame(frame)
            print(f"frame {i + 1}/{args.frames}", flush=True)
    print(f"wrote {args.out} ({args.frames} frames @ {args.fps} fps, "
          f"{type(w).__name__})")
    return 0


def cmd_view(args) -> int:
    """Interactive terminal viewer (cli/interactive.py)."""
    from raytpu_torch.cli.interactive import run_interactive

    scene, _scene_cam = _load_scene(args)
    flat = _flatten(scene, args)
    run_interactive(flat, _config(args), host_scene=scene,
                    flatten_kwargs=_flatten_kwargs(args))
    return 0


def _perturbed(flat, fields, scale: float = 0.02, seed: int = 0):
    """The scene with ``scale`` times a standard normal draw (NumPy's
    generator, ``seed``) added to each of ``fields``, in their order."""
    from raytpu_torch.diff.params import apply_params, extract_params

    rng = np.random.default_rng(seed)
    params = extract_params(flat, fields)
    with torch.no_grad():
        noisy = {f: a.detach() + scale * torch.from_numpy(
            rng.standard_normal(tuple(a.shape), dtype=np.float32)).to(a.device)
            for f, a in params.items()}
        return apply_params(flat, noisy)


def cmd_fit(args) -> int:
    """Inverse rendering: recover geometry/texture from a target image.

    Without ``--target-image`` the unperturbed render is the target and the
    fit starts from a perturbed copy of the trained fields, as in the JAX
    package; the perturbation is drawn with NumPy's generator (seed 0), not
    JAX's."""
    from raytpu_torch.diff.fit import fit
    from raytpu_torch.diff.params import GEOMETRY, TEXTURE
    from raytpu_torch.io.image import read_image, write_image
    from raytpu_torch.render.wavefront import render_image

    if args.ring:
        raise SystemExit("--ring is not supported for fit (the command "
                         "fits a replicated scene; the library's ring fit "
                         "is dist/bigscene.py::make_ring_fit_step)")
    scene, scene_cam = _load_scene(args)
    flat = _flatten(scene, args)
    cfg = _config(args)
    cam = _camera(args, args.width / args.height, scene_cam)

    fields = ()
    if "geometry" in args.optimize:
        fields += GEOMETRY
    if "texture" in args.optimize:
        fields += TEXTURE

    if args.target_image:
        target = torch.from_numpy(
            read_image(args.target_image).astype(np.float32) / 255.0).to(
                flat.device)
    else:
        target = render_image(flat, cfg, cam)
        flat = _perturbed(flat, fields)

    os.makedirs(args.out, exist_ok=True)
    fitted, _params, losses = fit(
        flat, cfg, cam, target, fields=fields, steps=args.steps,
        learning_rate=args.lr, checkpoint_dir=args.out,
        checkpoint_every=max(args.steps // 4, 1), mesh=_mesh(args),
    )
    with torch.no_grad():
        final = render_image(fitted, cfg, cam)
    write_image(os.path.join(args.out, "final.png"), final)
    write_image(os.path.join(args.out, "target.png"), target)
    print(f"fit done: loss {losses[0]:.6f} -> {losses[-1]:.6f} "
          f"({len(losses)} steps); outputs in {args.out}/")
    return 0


def _add_common(p):
    p.add_argument("--scene", default="demo",
                   help="builtin name (demo|spheres|crate), a .toml scene "
                        "file or an .obj/.fbx path")
    p.add_argument("--out", default="out.png")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--max-reflections", type=int, default=8,
                   help="reference default 8 (Game1.cs:126)")
    p.add_argument("--multisample", type=int, default=0,
                   help="adaptive supersampling quality (0 = off)")
    p.add_argument("--intersector", default="auto",
                   choices=("auto", "octree", "brute", "tiled", "pallas"))
    p.add_argument("--camera", type=float, nargs=3, default=None,
                   help="default (0, 16, 32), the reference's (Game1.cs:111);"
                        " a .toml scene's camera is used unless overridden")
    p.add_argument("--look-at", dest="target", type=float, nargs=3,
                   default=None)
    p.add_argument("--fov", type=float, default=None)
    p.add_argument("--reflect", type=float, default=0.5)
    p.add_argument("--transparent", action="store_true")
    p.add_argument("--obj-scale", type=float, default=1.0)
    p.add_argument("--progress", action="store_true",
                   help="print percent progress (Game1.cs:331-344 overlay); "
                        "ignored, with a warning, with --multisample, and "
                        "with --devices > 1")
    p.add_argument("--devices", default="1",
                   help="device parallelism: a count, or 'all' — shards "
                        "rays over a 1-D mesh of the first N CUDA devices "
                        "(dist/render.py; the scanline-pool analog, "
                        "RayTracer.cs:48-120)")
    p.add_argument("--ring", action="store_true",
                   help="with --devices > 1: ring-shard the geometry, shade "
                        "and texture tables across the devices, for scenes "
                        "larger than one device's memory "
                        "(dist/bigscene.py)")
    p.add_argument("--render-mode", default="shaded",
                   choices=("shaded", "normals", "convex"),
                   help="diagnostic channels (RayTracer.cs:563-566 "
                        "DEBUG_NORMALS / DEBUG_CONVEXFLAG)")


def main(argv=None, device="cuda") -> int:
    """Run one command of ``argv`` (default: the command line) on
    ``device``: the card unless a caller in Python names another."""
    ap = argparse.ArgumentParser(prog="raytpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render one frame to PNG")
    _add_common(pr)
    pr.add_argument("--watch", action="store_true",
                    help="write the PNG progressively as tiles finish "
                         "(watch the frame fill in; Game1.cs:389-416); "
                         "ignored, with a warning, with --multisample")

    pa = sub.add_parser("animate", help="turntable animation -> AVI")
    _add_common(pa)
    pa.add_argument("--frames", type=int, default=60)
    pa.add_argument("--fps", type=float, default=30.0,
                    help="reference default (Game1.cs:194)")
    pa.add_argument("--codec", default="MJPG", choices=("MJPG", "DIB "))
    pa.add_argument("--frame-dir", default=None)
    pa.add_argument("--resume", action="store_true",
                    help="reuse frame PNGs already in --frame-dir")
    pa.set_defaults(out="turntable.avi")

    pv = sub.add_parser("view", help="interactive terminal viewer "
                                     "(WASD camera, Enter traces — the "
                                     "Game1 keyboard shell analog)")
    _add_common(pv)

    pf = sub.add_parser("fit", help="inverse-rendering optimization")
    _add_common(pf)
    pf.add_argument("--steps", type=int, default=100)
    pf.add_argument("--lr", type=float, default=1e-2)
    pf.add_argument("--optimize", default="geometry,texture",
                    help="comma list: geometry,texture")
    pf.set_defaults(out="fit_out")
    pf.add_argument("--target-image", default=None,
                    help="target PNG (default: self-target recovery demo)")

    args = ap.parse_args(argv)
    args.device = device
    if args.cmd == "render":
        return cmd_render(args)
    if args.cmd == "animate":
        return cmd_animate(args)
    if args.cmd == "view":
        return cmd_view(args)
    if args.cmd == "fit":
        return cmd_fit(args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
