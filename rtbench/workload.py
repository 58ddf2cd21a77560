"""One run of one cell: a configuration (configs/<name>.json) under a
traffic mix (traffic/<name>.json), driven through the program.

The traffic generator is general; a mix is data:

- ``"kind": "orbit"``: a closed loop of one client asking for frames of a
  turntable orbit (``poses_per_turn`` poses about the y axis through
  ``camera``, looking at ``target``), each frame the program's image as
  uint8 bytes on the host (``cli/main.py::cmd_animate``'s frames, turned
  into bytes on the device: ``to_bytes``); the
  seed picks the first pose, so every seed renders the same poses in
  another order.  ``checked_frames`` frames of the window, drawn from the
  seed, are compared with the plain reference.
- ``"kind": "fit"``: geometry fit steps back to back (``diff/fit.py``'s
  ``make_fit_step`` with Adam, each loss read to the host as ``fit`` reads
  it), against the program's own frame of the unperturbed scene from
  pose ``pose`` of the orbit, starting from the fitted fields plus
  ``perturb_scale`` times a standard normal draw (NumPy's generator from
  the seed, as the CLI's fit perturbs).  The pose is fixed: it sets how
  long a step's walks take, so that every seed gets the same work.  The first ``checked_steps``
  steps run in set-up, are compared with the plain reference, and the same
  step and state go on into the window.

The program is ``raytpu_torch`` alone; the reference (reference.py) gets
the same scene arrays and nothing the program made.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from rtbench import reference, scene, trace

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def load(kind: str, name: str) -> dict:
    """``rtbench/<kind>/<name>.json``."""
    return json.loads((HERE / kind / f"{name}.json").read_text())


@dataclasses.dataclass
class Run:
    """What the metric readers (metrics/<name>.py) read."""

    cell: str
    kind: str
    seed: int
    traffic: dict
    setup_s: float = 0.0
    item_s: list = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    launches: Optional[int] = None
    summary: Optional[trace.Summary] = None
    mix: object = None

    @property
    def items(self) -> int:
        return len(self.item_s)


def launch_count() -> int:
    from raytpu_torch.kernels import fused

    return sum(fused.LAUNCHES.values())


def program_scene(arrays: scene.SceneArrays, config: dict, device):
    """The program's bake of the scene arrays: ``flatten`` or, for a
    configuration with instances, ``flatten_instanced`` (one bake of the
    mesh, shared by the placements)."""
    from raytpu_torch.render.instanced import flatten_instanced
    from raytpu_torch.scene.lights import SpotLight
    from raytpu_torch.scene.types import Material, Mesh, Scene, SceneObject

    mat = Material(reflectiveness=arrays.reflectiveness,
                   diffuse_color=arrays.color)
    mesh = Mesh(vertices=arrays.vertices, normals=arrays.normals,
                uvs=arrays.uvs, material=mat)
    lt = arrays.light
    light = SpotLight(position=tuple(lt["position"]),
                      direction=tuple(lt["direction"]))
    bake = config["bake"]
    if arrays.instances:
        meshes = [mesh]
        objects = [SceneObject(meshes=meshes, position=(x, 0.0, z),
                               rotation=(0.0, k * math.pi / 2, 0.0))
                   for x, z, k in arrays.instances]
        return flatten_instanced(Scene(objects=objects, lights=[light]),
                                 cluster_size=bake["cluster_size"],
                                 build_octree=bake["build_octree"],
                                 device=device)
    return Scene(objects=[SceneObject(meshes=[mesh])],
                 lights=[light]).flatten(cluster_size=bake["cluster_size"],
                                         build_octree=bake["build_octree"],
                                         device=device)


def render_config(traffic: dict):
    """The mix's render settings; ``intersector`` (default ``AUTO``, the
    walk on the card) names another of the program's queries."""
    from raytpu_torch import Intersector, RenderConfig

    return RenderConfig(width=traffic["width"], height=traffic["height"],
                        max_reflections=traffic["max_reflections"],
                        tile_pixels=traffic["tile_pixels"],
                        intersector=Intersector[traffic.get("intersector",
                                                            "AUTO")])


def camera_at(traffic: dict, k: int):
    from raytpu_torch.core.camera import Camera

    return Camera(position=scene.orbit_pose(traffic["camera"],
                                            traffic["poses_per_turn"], k),
                  target=tuple(traffic["target"]),
                  aspect=traffic["width"] / traffic["height"])


def to_bytes(image):
    """An (H, W, 3) float image in [0, 1] as uint8 bytes on its device: the
    bytes ``raytpu_torch/io/image.py::to_uint8`` makes on the host
    (``clip * 255 + 0.5``, truncated), without its NumPy passes."""
    return (image.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


class Frames:
    """The orbit: ``item()`` renders the next pose into bytes on the host."""

    def __init__(self, arrays, config, traffic, seed, device):
        from raytpu_torch.render.instanced import render_image_instanced
        from raytpu_torch.render.wavefront import render_image

        self.traffic = traffic
        self.cfg = render_config(traffic)
        self.scene = program_scene(arrays, config, device)
        self.instanced = bool(arrays.instances)
        draw = render_image_instanced if self.instanced else render_image
        # The frame's bytes land in one pinned host buffer; a checked
        # frame is copied out of it.
        self.host = torch.empty((traffic["height"], traffic["width"], 3),
                                dtype=torch.uint8,
                                pin_memory=torch.device(device).type == "cuda")

        def render(k):
            with torch.profiler.record_function("rtbench.render"):
                img = draw(self.scene, self.cfg, camera_at(traffic, k))
            with torch.profiler.record_function("rtbench.to_bytes"):
                return self.host.copy_(to_bytes(img)).numpy()

        self.render = render
        self.reseed(seed)

    def reseed(self, seed):
        """The seed's first pose and sample of checked frames, afresh."""
        rng = np.random.default_rng(seed)
        self.first = int(rng.integers(self.traffic["poses_per_turn"]))
        self.pick = np.random.default_rng([seed, 1])
        self.keep = []     # (window index, pose, bytes): a seeded sample
        self.count = 0

    def warm_up(self):
        for i in range(self.traffic["warmup_frames"]):
            self.render(self.first + self.traffic["poses_per_turn"] // 2 + i)

    def item(self):
        k = self.first + self.count
        frame = self.render(k)
        n, want = self.count, self.traffic["checked_frames"]
        if n < want:
            self.keep.append((n, k, frame.copy()))
        else:
            j = int(self.pick.integers(n + 1))
            if j < want:
                self.keep[j] = (n, k, frame.copy())
        self.count += 1

    def release(self):
        self.scene = None
        self.render = None

    def reference_frames(self, ref, dtype=reference.F32):
        """The reference's bytes of the checked frames' poses."""
        t = self.traffic
        return [reference.render_frame(
            ref, scene.orbit_pose(t["camera"], t["poses_per_turn"], k),
            t["target"], t["width"], t["height"], t["max_reflections"],
            dtype=dtype)
            for _, k, _ in self.keep]

    def check(self, arrays, device):
        ref = reference.RefScene(arrays, device, scene.world_matrix)
        got = [torch.as_tensor(np.ascontiguousarray(f), device=device)
               for _, _, f in self.keep]
        return compare_frames(got, self.reference_frames(ref))


def compare_frames(got, want) -> dict:
    """The worst frame's share of pixels, per million, whose bytes differ
    from the reference's by more than 2 in some channel."""
    worst = 0.0
    for g, w in zip(got, want):
        gap = (g.to(torch.int16) - w.to(torch.int16)).abs().amax(-1)
        worst = max(worst, int((gap > 2).sum()) / gap.numel() * 1e6)
    return {"bad_px_ppm": worst}


class Fit:
    """The fit: set-up runs the checked steps; ``item()`` is one more."""

    def __init__(self, arrays, config, traffic, seed, device, flat=None):
        from raytpu_torch.core.camera import camera_rays
        from raytpu_torch.diff.fit import make_fit_step
        from raytpu_torch.diff.params import extract_params
        from raytpu_torch.render.wavefront import render_image

        self.traffic = traffic
        rng = np.random.default_rng(seed)
        self.pose = traffic["pose"]
        cfg = render_config(traffic)
        self.flat = flat = flat or program_scene(arrays, config, device)
        cam = camera_at(traffic, self.pose)
        target = render_image(flat, cfg, cam).reshape(-1, 3)
        self.start = start_fields(arrays, traffic, rng, device)
        params = extract_params(flat, tuple(self.start))
        with torch.no_grad():
            for k, x in params.items():
                x.copy_(self.start[k])
        opt = torch.optim.Adam([params[k] for k in sorted(params)],
                               lr=traffic["learning_rate"])
        step = make_fit_step(flat, cfg, opt, fields=tuple(self.start))
        o, d = camera_rays(cam, cfg.width, cfg.height, device=device)
        self.state = (params, opt, step, o, d, target)
        self.record = None

    def warm_up(self):
        """The checked steps: each loss, the gradient norms as Adam holds
        them after the first, the fields' change after the last."""
        params, opt, step, o, d, target = self.state
        losses, grads = [], {}
        beta1 = opt.param_groups[0]["betas"][0]
        for i in range(self.traffic["checked_steps"]):
            losses.append(float(step(params, o, d, target)))
            if i == 0:
                # Adam's first moment after one step is (1 - beta1) g; an
                # optimizer that kept no state got no gradient.
                grads = {k: float(opt.state[p]["exp_avg"].double().norm())
                         / (1.0 - beta1) if "exp_avg" in opt.state[p]
                         else 0.0 for k, p in params.items()}
        change = {k: float((p.detach().double()
                            - self.start[k].double()).norm())
                  for k, p in params.items()}
        self.record = {"losses": losses, "grad_norms": grads,
                       "change_norms": change}

    def item(self):
        params, opt, step, o, d, target = self.state
        with torch.profiler.record_function("rtbench.step"):
            loss = step(params, o, d, target)
        with torch.profiler.record_function("rtbench.read_loss"):
            float(loss)

    def release(self):
        self.state = None
        self.flat = None

    def reference_steps(self, ref, dtype=reference.F32, half_batch=False):
        """The reference's record of the checked steps from the same start."""
        t = self.traffic
        return reference.fit_steps(
            ref, self.start, scene.orbit_pose(t["camera"],
                                              t["poses_per_turn"], self.pose),
            t["target"], t["width"], t["height"], t["learning_rate"],
            t["checked_steps"], dtype=dtype, half_batch=half_batch)

    def check(self, arrays, device):
        ref = reference.RefScene(arrays, device, scene.world_matrix)
        return compare_fit(self.record, self.reference_steps(ref))


def compare_fit(got: dict, want: dict) -> dict:
    """Relative gaps to the reference: each checked step's loss, and by
    the worst field the first gradient's norm and the change's norm,
    against the larger of that field's and the median field's."""

    def leaf_gap(key):
        ref = want[key]
        floor = statistics.median(ref.values())
        return max(abs(got[key][k] - ref[k]) / max(ref[k], floor, 1e-30)
                   for k in ref)

    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(got["losses"], want["losses"]))
    return {"loss_gap": loss, "grad_gap": leaf_gap("grad_norms"),
            "change_gap": leaf_gap("change_norms")}


def start_fields(arrays, traffic, rng, device) -> dict:
    """The fit's first values: each field of the scene's own triangles
    (v1, v2 - v1, v3 - v1, in float32 as the bake computes them) plus
    ``perturb_scale`` times a standard normal draw, in field order."""
    v = arrays.vertices
    base = {"tri_v1": v[:, 0], "tri_e1": v[:, 1] - v[:, 0],
            "tri_e2": v[:, 2] - v[:, 0]}
    out = {}
    for f in traffic["fields"]:
        a = torch.as_tensor(np.ascontiguousarray(base[f]), device=device)
        noise = rng.standard_normal(a.shape, dtype=np.float32)
        out[f] = a + traffic["perturb_scale"] * torch.from_numpy(noise).to(
            device)
    return out


KINDS = {"orbit": Frames, "fit": Fit}


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# A traced run profiles the window's first seconds only: reducing a
# profile takes ~12 s a second of 1080p frames, and a run has 360 s.
TRACE_SECONDS = 5.0


def measure(run: Run, mix, seconds: float, traced: bool, device):
    """The window: items back to back until ``seconds`` have passed; when
    ``traced``, its first ``TRACE_SECONDS`` under torch.profiler (the items
    it holds are whole)."""
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    before = launch_count()
    start = time.perf_counter()
    end = start
    tracing = prof is not None
    try:
        while end - start < seconds:
            t0 = time.perf_counter()
            with torch.profiler.record_function(trace.ITEM):
                mix.item()
            end = time.perf_counter()
            run.item_s.append(end - t0)
            if tracing and end - start >= TRACE_SECONDS:
                tracing = stop(prof, device)
    finally:
        if tracing:
            stop(prof, device)
    run.window_s = end - start
    run.launches = launch_count() - before
    if prof is not None:
        run.summary = trace.summarize(prof)


def stop(prof, device) -> bool:
    sync(device)
    prof.__exit__(None, None, None)
    return False


def limits(cell: str) -> dict:
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())


def run_cell(spec: dict, cell_name: str, seed: int, seconds: float,
             traced: bool, device, t0: float, config=None, traffic=None):
    """Set up, measure and check one cell: (Run, checks, memory peak).

    ``config``/``traffic``: the cell's dicts (default: its files)."""
    cell = next(w for w in spec["workloads"] if w["name"] == cell_name)
    config = config or load("configs", cell["config"])
    traffic = traffic or load("traffic", cell["traffic"])
    run = Run(cell=cell_name, kind=traffic["kind"], seed=seed,
              traffic=traffic)
    arrays = scene.build(config)
    mix = KINDS[traffic["kind"]](arrays, config, traffic, seed, device)
    mix.warm_up()
    sync(device)
    run.setup_s = time.perf_counter() - t0
    run.mix = mix
    measure(run, mix, seconds, traced, device)
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    return run, arrays, peak


def check(run: Run, arrays, device, cell_limits: dict) -> dict:
    """The mix's state freed, the reference compared: {name: (value,
    limit)}."""
    mix = run.mix
    mix.release()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    values = mix.check(arrays, device)
    return {k: (v, cell_limits[k]["limit"]) for k, v in values.items()}
