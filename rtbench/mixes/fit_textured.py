"""A geometry and texture fit: workload.py's ``Fit`` with the atlas
(``textures``) among the fitted fields.

The atlas starts as the scene's own plus ``texel_perturb_scale`` times a
standard normal draw, on the scale the program holds it (raw byte values
in float32), drawn after the geometry fields' from the same generator;
the reference is reference_textured.py's fit.
"""

from __future__ import annotations

import numpy as np
import torch

from rtbench import reference_textured, scene, workload


class Mix(workload.Fit):
    faults = {**workload.Fit.faults,
              "no_texel_grad": {"drop_grads": ("textures",)}}

    def start_fields(self, arrays, traffic, rng, device) -> dict:
        geometry = [f for f in traffic["fields"] if f != "textures"]
        out = workload.start_fields(arrays, dict(traffic, fields=geometry),
                                    rng, device)
        atlas = torch.as_tensor(arrays.texture[None].astype(np.float32),
                                device=device)
        noise = rng.standard_normal(atlas.shape, dtype=np.float32)
        out["textures"] = atlas + traffic["texel_perturb_scale"] * \
            torch.from_numpy(noise).to(device)
        return out

    def reference_steps(self, ref, dtype=reference_textured.F32,
                        half_batch=False, drop_grads=()):
        t = self.traffic
        return reference_textured.fit_steps(
            ref, self.start, scene.orbit_pose(t["camera"],
                                              t["poses_per_turn"], self.pose),
            t["target"], t["width"], t["height"], t["learning_rate"],
            t["checked_steps"], dtype=dtype, half_batch=half_batch,
            drop_grads=drop_grads)
