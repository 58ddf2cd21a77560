"""The port's scene loaders, image and AVI output, CLI and interactive
viewer (raytpu_torch/scene/{obj,fbx}_loader.py, sceneformat.py,
io/image.py, io/avi.py, cli/) against the JAX package's, on the CPU.

Loaders, images and AVI containers: equal arrays, pixels and bytes.  The
CLI's images: the JAX CLI's run on the same arguments, with the port's
camera rays patched to the JAX camera's (tests/torch_scenes.py::
reference_camera_rays); a pixel may differ by one byte step, in at most 2%
of the pixels: the rounding flips that test_torch_supersample.py traces
(XLA contracts FMAs and divides by 255 as a multiplication; the port does
neither).  The demo renders at 32x32 with two reflections (eight in the
card's run, chip_smoke.py), so that the CPU run stays short.  Fit losses:
the printed six decimals to rtol 1e-3 against the JAX package's ``fit``
from the same perturbed scene.
"""

import dataclasses
import importlib
import os
import struct
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from raytpu.cli import interactive as jinteractive
from raytpu.io import avi as javi
from raytpu.io import image as jimage
from raytpu.scene import fbx_loader as jfbx
from raytpu.scene import obj_loader as jobj
from raytpu.scene import sceneformat as jsceneformat
from raytpu_torch.cli import interactive as tinteractive
from raytpu_torch.cli import main as tcli
from raytpu_torch.io import avi as tavi
from raytpu_torch.io import image as timage
from raytpu_torch.render import supersample, wavefront
from raytpu_torch.scene import fbx_loader as tfbx
from raytpu_torch.scene import obj_loader as tobj
from raytpu_torch.scene import sceneformat as tsceneformat
from tests.test_loaders import ASCII_QUAD
from tests.torch_scenes import reference_camera_rays, reference_screen_rays

# raytpu/cli/__init__.py binds the name ``main`` to the function.
jcli = importlib.import_module("raytpu.cli.main")
torch.set_num_threads(1)
ASSETS = Path(__file__).resolve().parents[1] / "assets"


def _same_mesh(got, want):
    for f in ("vertices", "uvs", "normals", "colors"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, f)
    assert got.convex == want.convex
    _same_fields(got.material, want.material)


def _same_fields(got, want):
    """Equal dataclass fields (arrays element for element)."""
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, f.name)
        elif f.name == "meshes":
            assert len(a) == len(b)
            for x, y in zip(a, b):
                _same_mesh(x, y)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("name", ["crate.obj", "sphere.obj"])
def test_load_obj_matches_reference(name):
    _same_mesh(tobj.load_obj(str(ASSETS / name), convex=True),
               jobj.load_obj(str(ASSETS / name), convex=True))


def _fbx_binary_quad() -> bytes:
    """ASCII_QUAD's quad as a binary FBX 7400 (the 7.x object model:
    Geometry and Model linked by numeric-id connections), its vertices
    compressed with zlib, with a rotation and a scaling besides the
    translation."""

    def prop(v):
        if isinstance(v, str):
            b = v.encode()
            return b"S" + struct.pack("<I", len(b)) + b
        if isinstance(v, int):
            return b"L" + struct.pack("<q", v)
        if isinstance(v, float):
            return b"D" + struct.pack("<d", v)
        code, vals, packed = v
        raw = np.asarray(vals, "<f8" if code == "d" else "<i4").tobytes()
        data = zlib.compress(raw) if packed else raw
        return (code.encode() + struct.pack("<III", len(vals), int(packed),
                                            len(data)) + data)

    def node(name, props, children, at):
        pb = b"".join(prop(p) for p in props)
        body = b""
        for c in children:
            body += node(*c, at + 13 + len(name) + len(pb) + len(body))
        if children:
            body += b"\x00" * 13
        end = at + 13 + len(name) + len(pb) + len(body)
        return (struct.pack("<IIIB", end, len(props), len(pb), len(name))
                + name.encode() + pb + body)

    def p70(key, *xyz):
        return ("P", [key, key, "", "A", *map(float, xyz)], [])

    geometry = ("Geometry", [100, "quad\x00\x01Geometry", "Mesh"], [
        ("Vertices", [("d", [-1, -1, 0, 1, -1, 0, 1, 1, 0, -1, 1, 0], True)],
         []),
        ("PolygonVertexIndex", [("i", [0, 1, 2, -4], False)], []),
        ("LayerElementNormal", [0], [
            ("MappingInformationType", ["ByVertice"], []),
            ("ReferenceInformationType", ["Direct"], []),
            ("Normals", [("d", [0, 0, 1] * 4, False)], [])]),
        ("LayerElementUV", [0], [
            ("MappingInformationType", ["ByPolygonVertex"], []),
            ("ReferenceInformationType", ["IndexToDirect"], []),
            ("UV", [("d", [0, 0, 1, 0, 1, 1, 0, 1], False)], []),
            ("UVIndex", [("i", [0, 1, 2, 3], False)], [])]),
    ])
    model = ("Model", [200, "quad\x00\x01Model", "Mesh"], [
        ("Properties70", [], [p70("Lcl Translation", 1, 0, 2),
                              p70("Lcl Rotation", 0, 0, 90),
                              p70("Lcl Scaling", 2, 2, 2)])])
    top = [("FBXHeaderExtension", [], [("FBXVersion", [7400], [])]),
           ("Objects", [], [geometry, model]),
           ("Connections", [], [("C", ["OO", 100, 200], []),
                                ("C", ["OO", 200, 0], [])])]
    out = b"Kaydara FBX Binary  \x00\x1a\x00" + struct.pack("<I", 7400)
    for n in top:
        out += node(*n, len(out))
    return out + b"\x00" * 13


@pytest.mark.parametrize("kind", ["ascii", "binary"])
def test_load_fbx_matches_reference(kind, tmp_path):
    path = tmp_path / "quad.fbx"
    if kind == "ascii":
        path.write_text(ASCII_QUAD)
    else:
        path.write_bytes(_fbx_binary_quad())
    got, want = tfbx.load_fbx(str(path)), jfbx.load_fbx(str(path))
    assert len(got) == len(want) == 1
    _same_mesh(got[0], want[0])
    m = got[0]
    # Winding flipped to the reference's cross(e2, e1) facing the authored
    # +z normals (rotated about z and so still +z), v flipped.
    e1 = m.vertices[:, 1] - m.vertices[:, 0]
    e2 = m.vertices[:, 2] - m.vertices[:, 0]
    assert (np.cross(e2, e1)[:, 2] > 0).all()
    np.testing.assert_allclose(m.normals[..., 2], 1.0, atol=1e-6)
    assert m.uvs[0, 0, 1] == 1.0  # corner (0, 0) reads v = 1 - 0
    if kind == "ascii":
        np.testing.assert_allclose(m.vertices[..., 2], 2.0)
    else:
        # (x, y) -> rotated 90° about z, scaled by 2, moved by (1, 0, 2).
        np.testing.assert_allclose(m.vertices[0, 0], (3.0, -2.0, 2.0),
                                   atol=1e-6)


@pytest.mark.parametrize("name", ["demo.toml", "crate.toml"])
def test_load_scene_toml_matches_reference(name):
    (scene, cam) = tsceneformat.load_scene_toml(str(ASSETS / name))
    (jscene, jcam) = jsceneformat.load_scene_toml(str(ASSETS / name))
    assert len(scene.objects) == len(jscene.objects) > 1
    for got, want in zip(scene.objects, jscene.objects):
        _same_fields(got, want)
    assert len(scene.lights) == len(jscene.lights) == 1
    for got, want in zip(scene.lights, jscene.lights):
        _same_fields(got, want)
    _same_fields(cam, jcam)


TOML_ERRORS = (
    ('[[objects]]\nmesh = "box"\n  [objects.material]\n  use_texture = true\n',
     "use_texture"),
    ('[[lights]]\ntype = "area"\nposition = [0, 1, 0]\n', "light type"),
    ('[[objects]]\nmesh = "teapot.stl"\n', "mesh spec"),
)


def test_scene_toml_errors_match_reference(tmp_path):
    """A textured material without a texture, an unknown light type and an
    unknown mesh raise the JAX package's errors."""
    path = tmp_path / "bad.toml"
    for body, match in TOML_ERRORS:
        path.write_text(body)
        with pytest.raises(ValueError, match=match) as got:
            tsceneformat.load_scene_toml(str(path))
        with pytest.raises(ValueError) as want:
            jsceneformat.load_scene_toml(str(path))
        assert str(got.value) == str(want.value)


def test_png_round_trip_matches_reference(tmp_path):
    """Float and byte images, as tensors and arrays: the port's PNG decodes
    (with PIL) to the JAX package's pixels, and reads back."""
    rng = np.random.default_rng(0)
    img = rng.uniform(-0.1, 1.1, size=(9, 13, 3)).astype(np.float32)
    img[0, 0] = (0.5 / 255, 1.5 / 255, 254.5 / 255)  # rounding boundaries
    for i, src in enumerate((img, (img.clip(0, 1) * 255).astype(np.uint8))):
        timage.write_image(str(tmp_path / f"t{i}.png"), torch.from_numpy(src))
        jimage.write_image(str(tmp_path / f"j{i}.png"), src)
        got = np.asarray(Image.open(tmp_path / f"t{i}.png"))
        np.testing.assert_array_equal(
            got, np.asarray(Image.open(tmp_path / f"j{i}.png")))
        np.testing.assert_array_equal(
            timage.read_image(str(tmp_path / f"t{i}.png")), got)


@pytest.mark.parametrize("codec", ["DIB ", "MJPG"])
def test_avi_matches_reference(codec, tmp_path):
    """The Python writer writes the JAX package's bytes; the native muxer,
    built from native/avimux.cc into build/, the Python writer's."""
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, size=(17, 23, 3), dtype=np.uint8)
              for _ in range(3)]
    paths = {k: str(tmp_path / f"{k}.avi") for k in ("jax", "py", "native")}
    with javi.AviWriter(paths["jax"], fps=30, codec=codec) as w:
        for f in frames:
            w.add_frame(f)
    with tavi.AviWriter(paths["py"], fps=30, codec=codec) as w:
        for f in frames:
            w.add_frame(torch.from_numpy(f))
    with tavi.NativeAviWriter(paths["native"], 23, 17, fps=30,
                              codec=codec) as w:
        for f in frames:
            w.add_frame(f)
    data = {k: Path(p).read_bytes() for k, p in paths.items()}
    assert data["py"] == data["jax"]
    assert data["native"] == data["py"]
    assert str(tavi.BUILD_DIR) in tavi._native_lib()._name


@pytest.fixture
def same_rays(monkeypatch):
    """The port's camera and screen rays are the JAX camera's."""
    monkeypatch.setattr(wavefront, "camera_rays", reference_camera_rays)
    monkeypatch.setattr(supersample, "rays_through_screen",
                        reference_screen_rays)


def _close_images(got, want):
    """At most 2% of the pixels differ, each by at most one byte step."""
    got, want = np.asarray(got).astype(int), np.asarray(want).astype(int)
    assert got.shape == want.shape and want.max() > 0
    diff = np.abs(got - want).max(-1)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.02


def _both(argv, tmp_path, *extra):
    """The same command through both CLIs, each writing under its own
    directory; returns the two directories."""
    out = {}
    for pkg, main in (("jax", jcli.main),
                      ("torch", lambda a: tcli.main(a, device="cpu"))):
        d = tmp_path / pkg
        d.mkdir()
        args = [a.replace("{out}", str(d)) for a in argv + list(extra)]
        assert main(args) == 0
        out[pkg] = d
    return out["jax"], out["torch"]


@pytest.mark.parametrize("extra", [["--multisample", "1"],
                                   ["--render-mode", "normals"]])
def test_cli_render_matches_reference(extra, tmp_path, same_rays):
    argv = ["render", "--scene", str(ASSETS / "demo.toml"), "--width", "32",
            "--height", "32", "--max-reflections", "2", "--out",
            "{out}/demo.png"]
    jd, td = _both(argv, tmp_path, *extra)
    _close_images(Image.open(td / "demo.png"), Image.open(jd / "demo.png"))
    assert ((td / "demo.config.json").read_text()
            == (jd / "demo.config.json").read_text())


def test_cli_animate_and_resume(tmp_path, same_rays, capsys):
    """Three turntable frames of the crate scene: frames close to the JAX
    CLI's, an AVI of the JAX package's bytes for the same frames; then
    ``--resume`` with one frame deleted renders that frame alone and
    writes the same AVI."""
    argv = ["animate", "--scene", "crate", "--width", "16", "--height", "16",
            "--max-reflections", "1", "--frames", "3", "--codec", "DIB ",
            "--out", "{out}/turn.avi"]
    jd, td = _both(argv, tmp_path)
    frames = [timage.read_image(str(td / "turn_frames" / f"frame_{i:04d}.png"))
              for i in range(3)]
    for i, f in enumerate(frames):
        _close_images(f, jimage.read_image(
            str(jd / "turn_frames" / f"frame_{i:04d}.png")))
    with javi.AviWriter(str(tmp_path / "ref.avi"), fps=30.0,
                        codec="DIB ") as w:
        for f in frames:
            w.add_frame(f)
    avi = (td / "turn.avi").read_bytes()
    assert avi == (tmp_path / "ref.avi").read_bytes()
    (td / "turn_frames" / "frame_0001.png").unlink()
    capsys.readouterr()
    resume = [a.replace("{out}", str(td)) for a in argv] + ["--resume"]
    assert tcli.main(resume, device="cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[:3] == ["frame 1/3 (resumed)", "frame 2/3",
                         "frame 3/3 (resumed)"]
    assert lines[3].endswith("fps, NativeAviWriter)")
    assert (td / "turn.avi").read_bytes() == avi


def test_cli_fit_matches_reference(tmp_path, same_rays, monkeypatch, capsys):
    """``fit --steps 2`` on the crate scene: the target render close to the
    JAX package's, and the losses and the fitted render those of the JAX
    package's ``fit`` started from the port's perturbation of the scene
    (NumPy's generator, seed 0: the JAX CLI draws its own with JAX's)."""
    import argparse

    from raytpu.core.camera import Camera as JaxCamera
    from raytpu.diff.fit import fit as jax_fit
    from raytpu.diff.params import GEOMETRY, TEXTURE
    from raytpu.render.wavefront import render_image as jax_render_image
    from raytpu_torch.diff import fit as tfit

    monkeypatch.setattr(tfit, "camera_rays", reference_camera_rays)
    out = tmp_path / "fit"
    assert tcli.main(["fit", "--scene", "crate", "--width", "16", "--height",
                      "16", "--max-reflections", "1", "--steps", "2",
                      "--lr", "1e-3", "--out", str(out)], device="cpu") == 0
    printed = capsys.readouterr().out.split("loss ")[1].split(" (")[0]
    first, last = (float(x) for x in printed.split(" -> "))

    args = argparse.Namespace(width=16, height=16, max_reflections=1,
                              multisample=0, intersector="auto",
                              render_mode="shaded")
    cfg, cam = jcli._config(args), JaxCamera(aspect=1.0)
    flat = jcli._build_scene("crate", 0.5, False).flatten(build_octree=False)
    render = jax.jit(lambda s: jax_render_image(s, cfg, cam))
    target = np.asarray(render(flat))
    _close_images(timage.read_image(str(out / "target.png")),
                  timage.to_uint8(target))
    rng = np.random.default_rng(0)
    noisy = flat.replace(**{
        f: getattr(flat, f) + 0.02 * rng.standard_normal(
            getattr(flat, f).shape, dtype=np.float32)
        for f in GEOMETRY + TEXTURE})
    fitted, _, losses = jax_fit(noisy, cfg, cam, target,
                                fields=GEOMETRY + TEXTURE, steps=2,
                                learning_rate=1e-3)
    np.testing.assert_allclose([first, last], [losses[0], losses[-1]],
                               rtol=1e-3, atol=2e-6)
    _close_images(timage.read_image(str(out / "final.png")),
                  timage.to_uint8(np.asarray(render(fitted))))


def test_cli_refuses_what_it_cannot_run(tmp_path):
    """``--ring`` without a mesh of more than one device exits, as the JAX
    CLI does (raytpu/cli/main.py:206-208), and so does ``fit --ring``
    (the command fits a replicated scene); 'all' devices on the CPU is
    one; the command line runs on the card, so without one ``python -m
    raytpu_torch`` fails instead of rendering on the CPU."""
    import subprocess
    import sys

    base = ["render", "--scene", "crate", "--width", "8", "--height", "8",
            "--max-reflections", "0", "--out", str(tmp_path / "r.png")]
    for extra in (["--ring"], ["--ring", "--devices", "1"]):
        with pytest.raises(SystemExit, match="--ring needs --devices > 1"):
            tcli.main(base + extra, device="cpu")
    fit = ["fit", "--scene", "crate", "--ring", "--devices", "2", "--out",
           str(tmp_path / "fit")]
    with pytest.raises(SystemExit, match="--ring is not supported for fit"):
        tcli.main(fit, device="cpu")
    assert not (tmp_path / "r.png").exists()
    assert tcli.main(base + ["--devices", "all"], device="cpu") == 0
    assert (tmp_path / "r.png").exists()
    (tmp_path / "r.png").unlink()
    proc = subprocess.run([sys.executable, "-m", "raytpu_torch", *base],
                          cwd=ASSETS.parent, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert not (tmp_path / "r.png").exists()


def test_interactive_session_matches_reference(same_rays):
    """Key decoding through a pipe, the ANSI frame, and a scripted session
    (preview, an orbit, Enter, an object spin that re-bakes, the normals
    channel) against the JAX package's session on the same keys."""
    r, w = os.pipe()
    os.write(w, b"\x1b[Ax\x1b[Z\x1b[D" * 2)
    with os.fdopen(r, "r") as f:
        got = [tinteractive._read_key(f) for _ in range(4)]
        want = [jinteractive._read_key(f) for _ in range(4)]
    os.close(w)
    assert got == want == ["r", "x", "", "a"]
    img = np.random.default_rng(0).uniform(size=(7, 9, 3)).astype(np.float32)
    assert (tinteractive.ansi_image(torch.from_numpy(img), max_cols=5)
            == jinteractive.ansi_image(img, max_cols=5))

    from raytpu.config import Intersector as JI
    from raytpu.config import RenderConfig as JCfg
    from raytpu_torch.config import Intersector, RenderConfig
    from tests.torch_scenes import sphere_and_plane

    sessions = []
    for pkg, cfg, kw in (
            ("jax", JCfg(width=12, height=12, max_reflections=1,
                         intersector=JI.BRUTE, tile_pixels=144),
             dict(build_octree=False)),
            ("torch", RenderConfig(width=12, height=12, max_reflections=1,
                                   intersector=Intersector.BRUTE,
                                   tile_pixels=144),
             dict(build_octree=False, device="cpu"))):
        host = sphere_and_plane(pkg)
        mod = jinteractive if pkg == "jax" else tinteractive
        sessions.append(mod.InteractiveSession(
            host.flatten(**kw), cfg, preview_res=8, host_scene=host,
            flatten_kwargs=kw))
    for keys in ("", "d", "\r", "j", "n"):
        acts = [s.handle_key(k) for s in sessions for k in keys]
        assert acts[:len(keys)] == acts[len(keys):]
        if keys == "\r":
            imgs = [s.render_full() for s in sessions]
        else:
            imgs = [s.current_image() for s in sessions]
        _close_images(timage.to_uint8(imgs[1]), timage.to_uint8(imgs[0]))
    assert sessions[1].host_scene.objects[0].rotation[1] > 0
