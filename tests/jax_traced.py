"""Running the JAX package's sharded programs under ``jax.jit`` in tests."""

import jax


def traced(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` traced once under ``jax.jit``.

    For the JAX package's ring programs: their code is unchanged, only the
    dispatch differs.  Called eagerly, the ``shard_map`` body dispatches
    one operation at a time, and every ring hop and bounce level compiles
    its operations again.  Every argument is closed over, not passed in:
    scenes, shards and meshes stay concrete, so host-side reads
    (``np.asarray`` of a scene table in ``shard_scene_clusters``) and the
    shard dicts' integer fields keep working."""
    return jax.jit(lambda: fn(*args, **kwargs))()
