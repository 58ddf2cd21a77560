"""Distribution over a single-controller device mesh (dist/mesh.py): the
ray-sharded render (dist/render.py), the ring-sharded scene for tables
larger than one device (dist/bigscene.py) and elastic re-dispatch
(dist/elastic.py)."""

from raytpu_torch.dist.bigscene import (  # noqa: F401
    nearest_hit_ring,
    shard_scene_clusters,
)
from raytpu_torch.dist.mesh import (  # noqa: F401
    hierarchical_pmean,
    make_mesh,
    replicate_scene,
)
from raytpu_torch.dist.render import (  # noqa: F401
    render_image_multisampled_sharded,
    render_image_sharded,
    render_rays_sharded,
)
