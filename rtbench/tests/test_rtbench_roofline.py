"""The roofline's pair count against the program's plain walk: on a small
scene, with one ray a tile, every block the count says a ray needs is one
the walk tests for it, so the walk's counter (``ray_tests``: tested
blocks' unresolved rays) is never below it."""

import pytest
import torch

from rtbench import roofline, scene, workload


@pytest.mark.parametrize("any_hit", [False, True])
def test_needed_blocks_are_among_the_walks_tests(tiny, any_hit):
    from raytpu_torch.core.camera import camera_rays
    from raytpu_torch.kernels.fused import assemble_hit, pack_query, walk_plain

    c, t = tiny("terrain1m", "orbit1080", triangles=32768)
    flat = workload.program_scene(scene.build(c), c, "cpu")
    o, d = camera_rays(workload.camera_at(t, 3), 24, 16, device="cpu")
    tmax = torch.full((o.shape[0],), 40.0) if any_hit else None
    q = pack_query(o, d, t_max=tmax, tile_size=1)
    out = walk_plain(flat.clusters, flat.tri_shade, q, cull=True,
                     any_hit=any_hit)
    hit, _ = assemble_hit(out, o.shape[0], any_hit)
    call = {"clusters": flat.clusters, "origin": o, "direction": d,
            "t_max": tmax, "cull": True, "any_hit": any_hit, "tile": 1,
            "hit": hit.hit, "t": hit.t, "rows": False}
    ray, _ = roofline.needed_blocks(call)
    need = torch.bincount(ray, minlength=o.shape[0])
    tested = out.ray_tests[:o.shape[0]].long()
    assert int(need.sum()) > 0
    assert bool((need <= tested).all()), (need - tested).max()
    ops, nbytes = roofline.call_bound(call, torch.Generator().manual_seed(0))
    lanes = flat.clusters["block"].shape[2]
    assert roofline.OPS_DET * int(need.sum()) * lanes <= ops
    assert ops <= roofline.OPS_PAIR[any_hit] * int(need.sum()) * lanes
    assert nbytes > 0
