"""Render statistics — the headless analog of the reference's ImGui stats
window (`src/raytracer/ui.odin:491-571`): ms/frame + FPS with a rolling
120-sample window, accumulated-frame counter, triangle/object/material
counts, plus ray-throughput counters (Mrays/s) the reference
only implicitly displays as FPS.
"""

from __future__ import annotations

import collections
import time
from typing import Optional


class RenderStats:
    WINDOW = 120  # ui.odin keeps a 120-sample frame-time plot

    def __init__(self):
        self.frame_times = collections.deque(maxlen=self.WINDOW)
        self.rays_per_frame = collections.deque(maxlen=self.WINDOW)
        self.accumulated_frames = 0
        self.triangles = 0
        self.objects = 0
        self.materials = 0
        self.lights = 0
        self._t_last: Optional[float] = None

    def frame_begin(self):
        self._t_last = time.perf_counter()

    def frame_end(self, rays: Optional[int] = None):
        if self._t_last is not None:
            self.frame_times.append(time.perf_counter() - self._t_last)
        if rays is not None:
            self.rays_per_frame.append(rays)
        self.accumulated_frames += 1

    def set_scene_counts(self, scene):
        self.triangles = scene.num_triangles
        self.objects = len(scene.objects)
        self.materials = len(scene.materials)
        self.lights = sum(
            1 for o in scene.objects
            if scene.materials[o.material_index].emission_power > 0
        )

    @property
    def ms_per_frame(self) -> float:
        if not self.frame_times:
            return 0.0
        return 1e3 * sum(self.frame_times) / len(self.frame_times)

    @property
    def fps(self) -> float:
        ms = self.ms_per_frame
        return 1e3 / ms if ms > 0 else 0.0

    @property
    def mrays_per_sec(self) -> float:
        if not self.frame_times or not self.rays_per_frame:
            return 0.0
        n = min(len(self.frame_times), len(self.rays_per_frame))
        rays = sum(list(self.rays_per_frame)[-n:])
        secs = sum(list(self.frame_times)[-n:])
        return rays / secs / 1e6 if secs > 0 else 0.0

    def format_table(self) -> str:
        rows = [
            ("ms/frame", f"{self.ms_per_frame:.2f}"),
            ("FPS (spp/s)", f"{self.fps:.2f}"),
            ("Mrays/s", f"{self.mrays_per_sec:.1f}"),
            ("accumulated frames", str(self.accumulated_frames)),
            ("triangles", str(self.triangles)),
            ("objects", str(self.objects)),
            ("materials", str(self.materials)),
            ("lights", str(self.lights)),
        ]
        width = max(len(k) for k, _ in rows)
        return "\n".join(f"{k.ljust(width)}  {v}" for k, v in rows)
