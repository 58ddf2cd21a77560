"""A turntable that every seed renders alike: workload.py's orbit, whose
window starts at pose ``first_pose`` for every seed, so that a run's frames
and their order are the same whatever the seed; the seed draws only the
frames that are checked.  The reference is reference_whitted.py's.
"""

from __future__ import annotations

import numpy as np

from rtbench import reference_whitted, scene, workload


class Mix(workload.Frames):
    # The faults the calibration plants in the reference put in the
    # program's place, by name: keyword arguments of reference_frames.
    faults = {"no_refraction": {"refraction": False},
              "one_bounce_fewer": {"bounces": -1},
              "no_texture": {"texture": False},
              "opaque_occluders": {"transparent_shadows": False}}

    def reseed(self, seed):
        """The fixed first pose; the seed's sample of checked frames."""
        self.first = int(self.traffic["first_pose"])
        self.pick = np.random.default_rng([seed, 1])
        self.keep = []
        self.count = 0

    def reference_frames(self, ref, dtype=reference_whitted.F32, **fault):
        t = self.traffic
        return [reference_whitted.render_frame(
            ref, scene.orbit_pose(t["camera"], t["poses_per_turn"], k),
            t["target"], t["width"], t["height"], t["max_reflections"],
            dtype=dtype, **fault)
            for _, k, _ in self.keep]
