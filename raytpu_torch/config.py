"""Run/render configuration: the port's own copy of ``raytpu/config.py``.

The same enums and the same ``RenderConfig`` fields, defaults and JSON form
as the JAX package's, so a configuration written by one package reads in
the other (``to_json``/``from_json``).  The walk controls' comments describe
the reference's measurements on its own hardware; the port's numbers are in
PERF.md.
"""

from __future__ import annotations

import dataclasses
import enum
import json


class TextureFiltering(enum.IntEnum):
    """Texture filtering modes (reference: Material.cs:12-16)."""

    POINT = 0
    BILINEAR = 1


class UVAddressMode(enum.IntEnum):
    """UV addressing modes (reference: Material.cs:18-23)."""

    CLAMP = 0
    WRAP = 1
    MIRROR = 2


class Quantize(enum.IntEnum):
    """Where to replicate XNA's byte quantization of colors.

    The reference stores every intermediate bounce color in a byte-packed
    ``Color`` (RayTracer.cs:552/:696 return ``Color`` from recursion), so
    intermediate colors are rounded to 1/255 steps.  ``BOUNCE`` replicates
    that exactly; ``FINAL`` only quantizes the framebuffer write; ``NONE``
    keeps full fp32 precision (HDR mode).
    """

    NONE = 0
    FINAL = 1
    BOUNCE = 2


class RenderMode(enum.IntEnum):
    """Shaded render or a diagnostic channel (RayTracer.cs:563-566).

    The reference compiles these in with ``#if DEBUG_NORMALS`` /
    ``DEBUG_CONVEXFLAG``; here they are a runtime switch.  ``NORMALS``
    renders the fragment normal as color exactly like XNA's
    ``new Color(fragmentNormal)`` (components clamped to [0, 1], so
    negative-facing axes render black); ``CONVEXFLAG`` renders green for
    convex-flagged meshes, red otherwise."""

    SHADED = 0
    NORMALS = 1
    CONVEXFLAG = 2


class Intersector(enum.IntEnum):
    """Which nearest-hit backend the renderer uses."""

    AUTO = 0
    BRUTE = 1  # dense ray-tile x triangle-block sweep (small scenes)
    OCTREE = 2  # stackless flattened-octree traversal (pure JAX while_loop)
    PALLAS = 3  # Pallas fused cull+intersection kernels
    TILED = 4  # tiled cluster cull + front-to-back dense chunks (XLA)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Renderer configuration.

    Mirrors the tracer properties of the reference engine
    (``RayTracer.cs:19-41``): ``MaxReflections``, ``TextureFiltering``,
    ``AddressMode``, ``UseMultisampling``, ``MultisampleQuality`` — plus
    batching knobs that replace the scanline dispenser
    (``RayTracer.cs:48-52``).
    """

    width: int = 512
    height: int = 512
    max_reflections: int = 8
    filtering: TextureFiltering = TextureFiltering.POINT
    address_mode: UVAddressMode = UVAddressMode.WRAP
    use_multisampling: bool = False
    multisample_quality: int = 1
    # Adaptive supersampling subdivision threshold (RayTracer.cs:340).
    multisample_threshold: float = 0.5
    # Replicate the reference bug where the lower-right subdivision result is
    # written into urColor (RayTracer.cs:305); fixed by default.
    replicate_lr_bug: bool = False
    quantize: Quantize = Quantize.FINAL
    intersector: Intersector = Intersector.AUTO
    # Diagnostic render channels (RenderMode docstring).
    render_mode: RenderMode = RenderMode.SHADED
    # Rays per wavefront tile; the image is rendered tile-by-tile so that
    # refraction doubling (2^depth slots) stays within device memory.
    tile_pixels: int = 16384
    # Triangle block size for the brute-force intersector sweep.
    tri_block: int = 2048
    # Intersector switches to cluster culling above this triangle count
    # when intersector == AUTO.
    brute_force_max_tris: int = 4096
    # Rays per cull tile (16x16-pixel blocks) and clusters per walk trip.
    cull_tile: int = 256
    cull_chunk: int = 1
    # Fused-kernel walk controls (kernels/fused.py).  ``cull_pretest``: a
    # per-ray lane-major slab test skips a picked cluster's whole
    # Möller–Trumbore pass when no unresolved ray can improve on it
    # (exact).  ``cull_recull``: every N walk trips the entry grid is
    # rebuilt from the unresolved beam only (0 = never).  ``cull_phase1``:
    # two-phase compaction — phase 1 walks every tile on this trip budget,
    # unresolved rays are compacted into fresh narrow tiles and finished by
    # an unbudgeted phase 2 (0 = single phase).  All three are exact; they
    # only change how much conservative overtesting the lockstep tile pays.
    # OFF by default for the baked render, as in the JAX package;
    # ``accel/traverse.py::nearest_hit`` itself defaults to pretest on and
    # a re-cull every 6 trips, which the instanced render takes.  Their
    # cost on the card is measured in PERF.md.
    cull_pretest: bool = False
    cull_recull: int = 0
    cull_phase1: int = 0
    # Pick-then-walk kernel (kernels/fused.py::_prepick_kernel): > 0 = max
    # front-to-back picks per tile, extracted into SMEM before a lean
    # DMA-pipelined test loop (``cull_nbuf`` buffers deep).  Exact: tiles
    # whose feasible-cluster count overflows the pick budget fall back to
    # a classic-walk rescue pass under lax.cond.  0 = classic interleaved
    # walk.
    cull_prepick: int = 0
    cull_nbuf: int = 4
    # Dual-branch transparent scenes (a material both reflective AND
    # transparent) give each ray two child slots, [reflection |
    # refraction], doubling the wavefront per level.  With compaction a
    # level carries only its live children (in slot order; one read of
    # their count to the host a level) and the descent stops at the first
    # level with none; dead slots are dropped, not traced.  Without it
    # every level carries all R * 2^l slots, the static shapes of the JAX
    # package.  Per-ray results, and so the frame, are identical.  Scenes
    # with no dual-branch material never double at all (single live child
    # per parent — see FlatScene.has_dual_branch) and ignore this flag.
    compact_wavefront: bool = True
    # Cast occlusion (shadow) rays FROM the light toward the fragment for
    # positionable lights in opaque scenes: all rays of the query then
    # share ONE origin, so ray-tile beams are thin cones and the cull
    # prunes far more clusters (render/wavefront.py::_light_result).
    # Semantically the same segment test with mirrored backface culling
    # (core/intersect.py cull="reverse"); only FP rounding at edge-grazing
    # occluders and zero-measure endpoint coincidences can differ.
    shadow_from_light: bool = True
    # Per-block shadow clearance (accel/shadowcull.py): precompute, per
    # frame and light, the nearest distance at which geometry OUTSIDE a
    # fragment's own block can occlude it; reversed spot queries then
    # start at light + t_min*dir (directional queries cap t_max at the
    # own-block exit when nothing lies beyond).  Exact — every possible
    # occluder is provably inside the searched segment.  Default off.
    shadow_clearance: bool = False
    # Differentiable mode: the discrete nearest-hit result is
    # stop-gradiented and (u, v, t) are recomputed from the hit triangle so
    # pixel gradients flow to geometry/normals/UVs/materials/texels through
    # any intersector backend (requires quantize == NONE for nonzero grads).
    differentiable: bool = False
    # Which tri_shade channels carry gradients in differentiable mode.
    # "all" (default): exact for ANY trainable FlatScene field.
    # "geometry": the per-ray shade-row gather backpropagates only the
    # v1/e1/e2 (cols 0:9) and snormal (24:27) channels — its VJP scatter-
    # add then runs on a (T, 12) table instead of (T, 32).  Exact when the
    # trainable fields are a subset of diff/params.GEOMETRY (plus
    # textures/material tables, which do not flow through tri_shade);
    # diff/fit.py sets this automatically from the requested fields.
    grad_channels: str = "all"

    def __post_init__(self):
        if self.grad_channels not in ("all", "geometry"):
            raise ValueError(
                f"grad_channels must be 'all' or 'geometry', got "
                f"{self.grad_channels!r}")
    # Edge softness for straight-through visibility gradients: 0 keeps hard
    # visibility (zero gradient across silhouettes); > 0 keeps the forward
    # image exact but backpropagates through a sigmoid of the barycentric
    # edge distance with this temperature (raytpu.diff).
    soft_tau: float = 0.0
    dtype: str = "float32"

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, enum.IntEnum):
                d[k] = v.name
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "RenderConfig":
        d = json.loads(s)
        d["filtering"] = TextureFiltering[d["filtering"]]
        d["address_mode"] = UVAddressMode[d["address_mode"]]
        d["quantize"] = Quantize[d["quantize"]]
        d["intersector"] = Intersector[d["intersector"]]
        if "render_mode" in d:
            d["render_mode"] = RenderMode[d["render_mode"]]
        return RenderConfig(**d)
