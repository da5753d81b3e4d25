"""Public API: one-shot `render()` and the interactive ProgressiveRenderer.

ProgressiveRenderer is the analog of Raytracing_Renderer
(`src/raytracer/raytracing_renderer.odin`):
  - owns the baked device scene, camera, accumulation buffer and frame
    counter (raytracing_renderer.odin:22-23,56-61)
  - `begin_frame()` replays the scene change journal into device updates and
    resets accumulation (raytracing_renderer.odin:128-188); a dirty camera
    also resets accumulation (:196-199)
  - `step()` runs one progressive sample unless the accumulation limit is
    reached (:204-205,347-350)
  - checkpoint/resume: the accumulation buffer + frame counter IS the render
    state; save/load make long renders resumable (the reference has no
    checkpointing — SURVEY.md §5).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from raytracer_tpu.integrator.wavefront import render_frame
from raytracer_tpu.ops.camera import Camera
from raytracer_tpu.scene.device_scene import (
    SceneOnDevice,
    bake_scene,
    update_materials,
)
from raytracer_tpu.scene.model import Scene, SceneChangeType
from raytracer_tpu.utils.config import RenderConfig


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(2,))
def _render_frame_jit(scene, camera_ubo, accum, frame_number, cfg):
    return render_frame(scene, camera_ubo, accum, frame_number, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(2, 3))
def _render_frame_restir_jit(scene, camera_ubo, accum, reservoir,
                             frame_number, cfg):
    from raytracer_tpu.integrator.restir import render_frame_restir

    return render_frame_restir(
        scene, camera_ubo, accum, reservoir, frame_number, cfg
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def _preview_radiance_jit(scene, camera_ubo, frame_number, cfg):
    """One raw radiance sample (no accumulation) — the preview-scale path."""
    from raytracer_tpu.integrator.wavefront import render_wavefront

    return render_wavefront(scene, camera_ubo, frame_number, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(2,))
def _render_frame_adaptive_jit(scene, camera_ubo, state, cfg):
    from raytracer_tpu.integrator.adaptive import render_frame_adaptive

    return render_frame_adaptive(scene, camera_ubo, state, cfg)


class ProgressiveRenderer:
    """Single-chip or multi-chip progressive renderer.

    `mesh` (a 1-D jax.sharding.Mesh) turns on pixel-tile data parallelism:
    the accumulation buffer and ReSTIR reservoir are sharded over the mesh's
    devices, the scene is replicated, and frames run through shard_map
    (parallel/sharding.py) — bit-identical to the single-chip path because
    seeds/camera rays use global pixel indices. There is ONE placement/reset
    path for both modes: reset_accumulation() and load_checkpoint() re-place
    accum *and* reservoir on the mesh (round-1/2 kept a wrapper class whose
    camera-dirty reset silently replicated the rebuilt reservoir)."""

    def __init__(self, scene: Scene, camera: Optional[Camera] = None,
                 config: Optional[RenderConfig] = None,
                 mesh=None):
        self.scene = scene
        self.mesh = mesh
        self.config = (config or RenderConfig()).resolve_accel()
        self.camera = camera or Camera.create(
            position=(0.0, 0.0, -3.0),
            aspect=self.config.width / self.config.height,
        )
        self.device_scene, self._host_bvh = bake_scene(
            scene, **self._bake_kwargs()
        )
        # The bake consumed the scene's current state: construction-time
        # journal entries are already reflected and must not trigger a
        # replay/reset on the first begin_frame.
        scene.drain_changes()
        if self.mesh is not None:
            self._init_mesh()
        self.accum = self._place_accum(
            jnp.zeros((self.config.num_pixels, 3), jnp.float32)
        )
        self.frame = 0
        self._camera_ubo_dev = None
        self._gbuffer = None  # denoiser G-buffer cache (camera/scene-keyed)
        self._preview_gbuffers = {}  # per-preview-resolution G-buffer cache
        self._prebake = None  # in-flight background bake (prebake_async)
        self.reservoir = None
        if self.config.use_restir:
            from raytracer_tpu.integrator.restir import Reservoir

            self.reservoir = self._place_reservoir(
                Reservoir.empty(self.config.num_pixels)
            )
        self.adaptive = None
        if self.config.adaptive_tol > 0:
            if self.config.use_restir:
                raise ValueError(
                    "adaptive_tol and use_restir are mutually exclusive "
                    "(ReSTIR carries its own temporal state)"
                )
            from raytracer_tpu.integrator.adaptive import AdaptiveState

            self.adaptive = self._place_adaptive(
                AdaptiveState.empty(self.config.num_pixels)
            )

    # -- multi-chip placement (one path for init/reset/load) -------------
    def _init_mesh(self):
        import logging

        from raytracer_tpu.parallel.sharding import replicate

        cfg = self.config
        if cfg.num_pixels % self.mesh.size != 0:
            raise ValueError(
                f"{cfg.width}x{cfg.height} pixels do not tile over "
                f"{self.mesh.size} devices; adjust the height"
            )
        if cfg.use_restir:
            halo_needed = (int(cfg.restir_spatial_radius) + 1) * cfg.width
            n_local = cfg.num_pixels // self.mesh.size
            if n_local < halo_needed:
                # Spatial taps beyond the (clamped) halo are dropped, so
                # coverage silently differs from single-chip on such meshes.
                logging.getLogger(__name__).warning(
                    "ReSTIR tile height %d rows < spatial halo %d rows: "
                    "cross-tile spatial taps will be clipped (render is no "
                    "longer bit-identical to single-chip)",
                    n_local // cfg.width,
                    halo_needed // cfg.width,
                )
        self.device_scene = replicate(self.device_scene, self.mesh)

    def _place_accum(self, accum):
        if self.mesh is None:
            return accum
        from raytracer_tpu.parallel.sharding import shard_accum

        return shard_accum(accum, self.mesh)

    def _place_reservoir(self, reservoir):
        if self.mesh is None or reservoir is None:
            return reservoir
        from raytracer_tpu.parallel.sharding import shard_reservoir

        return shard_reservoir(reservoir, self.mesh)

    def _place_adaptive(self, state):
        if self.mesh is None or state is None:
            return state
        from raytracer_tpu.parallel.sharding import shard_adaptive

        return shard_adaptive(state, self.mesh)

    def _bake_kwargs(self):
        """One bake parameterization for init / journal replay / material
        fallback, so every re-bake of this renderer produces the same array
        shapes (stable_bake keeps topology edits inside one jit signature)."""
        return dict(
            leaf_size=self.config.bvh_leaf_size,
            stable_shapes=self.config.stable_bake,
        )

    # -- scene/camera plumbing ------------------------------------------
    def set_camera(self, camera: Camera):
        self.camera = camera
        self.camera.dirty = True

    def prebake_async(self):
        """Start re-baking the scene's CURRENT state (pending journal
        included) on a background thread, moving a topology edit's
        bake+upload off the edit-to-frame critical path: while the bake
        runs, the in-flight device frame / the editor's previous preview
        keeps displaying, and the next begin_frame() swaps the prebaked
        scene in instead of baking synchronously (the reference rebuilds
        its AS synchronously on add/remove, gpu_scene.odin:430-455).

        Safe under further edits: the prebake is keyed on the journal
        length at launch; any edit that lands after it invalidates the
        result and the replay falls back to the synchronous bake."""
        import threading

        key = len(self.scene.changes)
        holder = {}
        kwargs = self._bake_kwargs()

        def work():
            try:
                holder["result"] = bake_scene(self.scene, **kwargs)
            except Exception as e:  # noqa: BLE001 — surfaced at take time
                holder["error"] = e

        t = threading.Thread(target=work, daemon=True,
                             name="raytracer-prebake")
        t.start()
        self._prebake = (key, t, holder)

    def _take_prebake(self):
        """Join and return a valid prebaked (device_scene, host_bvh), or
        None (no prebake / stale / failed — failures fall back to the
        synchronous bake and are logged, not raised)."""
        pb, self._prebake = self._prebake, None
        if pb is None:
            return None
        key, t, holder = pb
        if key != len(self.scene.changes):
            return None  # edits landed after the prebake: stale
        t.join()
        if "error" in holder:
            import logging

            logging.getLogger(__name__).warning(
                "background prebake failed (%s); re-baking synchronously",
                holder["error"],
            )
            return None
        return holder["result"]

    def _replay_changes(self):
        """raytracing_renderer.odin:141-187: drain the journal, map each
        change to the cheapest device update, reset accumulation."""
        if not self.scene.changes:
            self._prebake = None  # nothing pending: any prebake is a no-op
            return False
        prebaked = self._take_prebake()
        changes = self.scene.drain_changes()
        types = {c.type for c in changes}
        if prebaked is not None:
            # The background bake consumed exactly this journal state.
            self.device_scene, self._host_bvh = prebaked
        elif types == {SceneChangeType.MATERIAL_CHANGED}:
            self.device_scene = update_materials(
                self.device_scene, self.scene, **self._bake_kwargs()
            )
        elif types <= {
            SceneChangeType.OBJECT_TRANSFORM_CHANGED,
            SceneChangeType.MATERIAL_CHANGED,
        }:
            # Transform edits keep the triangle count: refit the existing
            # tree topology (TLAS UPDATE mode, gpu_scene.odin:457-482)
            # instead of a full SAH rebuild.
            self.device_scene, self._host_bvh = bake_scene(
                self.scene, reuse_bvh=self._host_bvh, **self._bake_kwargs()
            )
        else:
            # Topology changed: full re-bake into the SAME array shapes
            # whenever the new counts stay inside the capacity buckets
            # (stable_bake) — the step() jit then cache-hits, so the
            # reference's add/remove editor path (gpu_scene.odin:430-455)
            # costs bake+upload, not an XLA re-compile.
            self.device_scene, self._host_bvh = bake_scene(
                self.scene, **self._bake_kwargs()
            )
        if self.mesh is not None:
            from raytracer_tpu.parallel.sharding import replicate

            self.device_scene = replicate(self.device_scene, self.mesh)
        return True

    def begin_frame(self):
        scene_changed = self._replay_changes()
        if scene_changed or self.camera.dirty:
            self.reset_accumulation()
        if scene_changed:
            # Edits can move geometry / change albedo.
            self._gbuffer = None
            self._preview_gbuffers = {}
        if self.camera.dirty or self._camera_ubo_dev is None:
            self._refresh_camera_ubo()
            self.camera.clear_dirty()
            self._gbuffer = None
            self._preview_gbuffers = {}

    def reset_accumulation(self):
        self.accum = self._place_accum(
            jnp.zeros((self.config.num_pixels, 3), jnp.float32)
        )
        self.frame = 0
        if self.config.use_restir:
            from raytracer_tpu.integrator.restir import Reservoir

            # Temporal reuse is only valid while accumulation is: camera or
            # scene changes invalidate both. Placement (mesh sharding) is
            # part of this one reset path — see class docstring.
            self.reservoir = self._place_reservoir(
                Reservoir.empty(self.config.num_pixels)
            )
        if self.adaptive is not None:
            from raytracer_tpu.integrator.adaptive import AdaptiveState

            self.adaptive = self._place_adaptive(
                AdaptiveState.empty(self.config.num_pixels)
            )

    # -- the hot loop ---------------------------------------------------
    def step(self) -> bool:
        """One progressive step — cfg.spp_batch samples (default 1) in one
        launch. Returns False when the accumulation limit has been reached
        (frame skipped, like raytracing_renderer.odin:204). `self.frame`
        always counts SAMPLES accumulated, not launches."""
        self.begin_frame()
        limit = self.config.accumulation_limit
        if limit is not None and self.frame >= limit:
            return False
        if self.adaptive is not None:
            if self.mesh is not None:
                from raytracer_tpu.parallel.sharding import (
                    render_frame_adaptive_sharded,
                    replicate,
                )

                self.adaptive = render_frame_adaptive_sharded(
                    self.device_scene,
                    replicate(self._camera_ubo_dev, self.mesh),
                    self.adaptive, self.config, self.mesh,
                )
            else:
                self.adaptive = _render_frame_adaptive_jit(
                    self.device_scene, self._camera_ubo_dev,
                    self.adaptive, self.config,
                )
            # Keep self.accum mirroring the image (checkpoint compat,
            # denoiser input, anything reading .accum directly).
            self.accum = self.adaptive.mean
        elif self.mesh is not None:
            self._step_sharded()
        elif self.config.use_restir:
            self.accum, self.reservoir = _render_frame_restir_jit(
                self.device_scene,
                self._camera_ubo_dev,
                self.accum,
                self.reservoir,
                jnp.uint32(self.frame),
                self.config,
            )
        else:
            self.accum = _render_frame_jit(
                self.device_scene,
                self._camera_ubo_dev,
                self.accum,
                jnp.uint32(self.frame),
                self.config,
            )
        self.frame += self.config.spp_batch
        return True

    def _step_sharded(self):
        from raytracer_tpu.parallel.sharding import (
            render_frame_restir_sharded,
            render_frame_sharded,
            replicate,
        )

        ubo = replicate(self._camera_ubo_dev, self.mesh)
        if self.config.use_restir:
            self.accum, self.reservoir = render_frame_restir_sharded(
                self.device_scene, ubo, self.accum, self.reservoir,
                jnp.uint32(self.frame), self.config, self.mesh,
            )
        else:
            self.accum = render_frame_sharded(
                self.device_scene, ubo, self.accum,
                jnp.uint32(self.frame), self.config, self.mesh,
            )

    def adaptive_converged_fraction(self) -> float:
        """Fraction of pixels that have stopped sampling (0.0 when adaptive
        sampling is off). One device readback."""
        if self.adaptive is None:
            return 0.0
        from raytracer_tpu.integrator.adaptive import active_mask

        return float(1.0 - jnp.mean(
            active_mask(self.adaptive, self.config).astype(jnp.float32)
        ))

    def render(self, num_frames: int) -> np.ndarray:
        """Accumulate `num_frames` more SAMPLES (launch count divides by
        cfg.spp_batch) and return the image."""
        target = self.frame + num_frames
        while self.frame < target:
            if not self.step():
                break
        return self.image()

    def image(self, denoise: Optional[bool] = None) -> np.ndarray:
        """Accumulated linear radiance f32[H,W,3] on host (the reference's
        blit-to-swapchain becomes a device->host transfer).

        `denoise` (default cfg.denoise_preview) runs the edge-aware
        a-trous preview filter (integrator/denoise.py) on the way out;
        the accumulation buffer itself is never modified."""
        use = self.config.denoise_preview if denoise is None else denoise
        if not use:
            arr = np.asarray(self.accum)
        else:
            from raytracer_tpu.integrator.denoise import (
                atrous_denoise, gbuffer_pass,
            )

            self._ensure_camera_ubo()
            if self._gbuffer is None:
                self._gbuffer = gbuffer_pass(
                    self.device_scene, self._camera_ubo_dev, self.config
                )
            nrm, depth, albedo = self._gbuffer
            # Feed the device-resident accumulation straight into the
            # filter: only the filtered result crosses to host (a raw
            # readback + re-upload would cost an extra full-image round
            # trip per preview frame).
            arr = np.asarray(atrous_denoise(
                jnp.asarray(self.accum), nrm, depth, albedo,
                self.config.height, self.config.width,
                iterations=self.config.denoise_iterations,
            ))
        return arr.reshape(self.config.height, self.config.width, 3)

    def aovs(self) -> dict:
        """Arbitrary-output-variable images for compositing / external
        denoisers: {"normal": f32[H,W,3], "depth": f32[H,W],
        "albedo": f32[H,W,3]} from one coherent primary trace (the
        denoiser's G-buffer, integrator/denoise.py — cached until the
        camera or scene changes; miss pixels: normal 0, depth
        denoise.MISS_DEPTH, albedo 1). The reference has no AOV path; its
        ReSTIR scaffolding sketches the same buffers
        (shaders/restir.rgen:17-92)."""
        from raytracer_tpu.integrator.denoise import gbuffer_pass

        self.begin_frame()
        ubo = self._ensure_camera_ubo()
        if self._gbuffer is None:
            if self.mesh is not None:
                from raytracer_tpu.parallel.sharding import (
                    gbuffer_sharded, replicate,
                )

                self._gbuffer = gbuffer_sharded(
                    self.device_scene, replicate(ubo, self.mesh),
                    self.config, self.mesh,
                )
            else:
                self._gbuffer = gbuffer_pass(
                    self.device_scene, ubo, self.config
                )
        nrm, depth, albedo = self._gbuffer
        h, w = self.config.height, self.config.width
        return {
            "normal": np.asarray(nrm).reshape(h, w, 3),
            "depth": np.asarray(depth).reshape(h, w),
            "albedo": np.asarray(albedo).reshape(h, w, 3),
        }

    def _refresh_camera_ubo(self):
        """The ONE place the device camera UBO is built from the camera."""
        mats = self.camera.matrices()
        self._camera_ubo_dev = {
            "inverse_view": jnp.asarray(mats["inverse_view"]),
            "inverse_proj": jnp.asarray(mats["inverse_proj"]),
        }
        return self._camera_ubo_dev

    def _ensure_camera_ubo(self):
        if self._camera_ubo_dev is None:
            self._refresh_camera_ubo()
        return self._camera_ubo_dev

    def preview_image(self, scale: int = 4,
                      denoise: Optional[bool] = None,
                      upscale: bool = True) -> np.ndarray:
        """Low-latency preview frame f32[H,W,3]: trace ONE fresh sample at
        1/scale resolution with the current camera/scene, optionally run the
        edge-aware a-trous filter at that resolution, and bilinearly upscale
        to the full (height, width).

        `upscale=False` returns the preview at its native 1/scale resolution
        f32[H//scale, W//scale, 3] instead: at 1080p the full-resolution f32
        readback is ~25 MB per frame through the device link, which
        dominates the preview cadence — an editor that scales the small
        image up for display itself (every UI toolkit does) gets a
        scale^2-times smaller transfer.

        Pending scene edits and camera changes are applied first (the same
        begin_frame journal replay a step() would run — so the preview
        always shows the CURRENT scene/camera, and a dirty camera resets
        accumulation exactly as the invalidation contract demands). Beyond
        that the render is a side channel: the accumulation buffer, frame
        counter, and ReSTIR/adaptive state are untouched (the reference
        shows its raw accumulating viewport, ui.odin:491-571; here a 1080p
        preview at scale 4 traces 1/16 of the rays, which is what makes a
        denoised 1080p edit loop interactive on one device). The sample uses
        the CURRENT frame index's RNG streams: repeated calls between
        steps are deterministic, successive frames decorrelate."""
        self.begin_frame()
        use_denoise = (self.config.denoise_preview if denoise is None
                       else denoise)
        s = max(int(scale), 1)
        pw = max(self.config.width // s, 1)
        ph = max(self.config.height // s, 1)
        # Plain wavefront at preview resolution: ReSTIR/adaptive are
        # accumulation-state features, meaningless for a throwaway sample.
        cfg_p = self.config.replace(
            width=pw, height=ph, use_restir=False, adaptive_tol=0.0,
        ).resolve_accel()
        ubo = self._ensure_camera_ubo()
        frame = jnp.uint32(self.frame)
        if self.mesh is not None:
            from raytracer_tpu.parallel.sharding import (
                render_radiance_sharded,
                replicate,
            )

            if cfg_p.num_pixels % self.mesh.size != 0:
                raise ValueError(
                    f"preview {pw}x{ph} does not tile over "
                    f"{self.mesh.size} devices; pick a scale whose "
                    "preview height divides the mesh"
                )
            ubo = replicate(ubo, self.mesh)
            rad = render_radiance_sharded(
                self.device_scene, ubo, frame, cfg_p, self.mesh
            )
        else:
            rad = _preview_radiance_jit(
                self.device_scene, ubo, frame, cfg_p
            )
        if use_denoise:
            from raytracer_tpu.integrator.denoise import (
                atrous_denoise, gbuffer_pass,
            )

            gb = self._preview_gbuffers.get((pw, ph))
            if gb is None:
                if self.mesh is not None:
                    from raytracer_tpu.parallel.sharding import (
                        gbuffer_sharded,
                    )

                    gb = gbuffer_sharded(
                        self.device_scene, ubo, cfg_p, self.mesh
                    )
                    # The a-trous filter couples neighboring rows: cache
                    # the G-buffer GATHERED onto one device, so repeat
                    # previews pay zero extra transfers for it.
                    gb = tuple(jnp.asarray(np.asarray(a)) for a in gb)
                else:
                    gb = gbuffer_pass(self.device_scene, ubo, cfg_p)
                self._preview_gbuffers[(pw, ph)] = gb
            nrm, depth, albedo = gb
            if self.mesh is not None:
                rad = jnp.asarray(np.asarray(rad))
            rad = atrous_denoise(
                rad, nrm, depth, albedo, ph, pw,
                iterations=self.config.denoise_iterations,
            )
        elif self.mesh is not None:
            rad = jnp.asarray(np.asarray(rad))
        if not upscale:
            return np.asarray(rad).reshape(ph, pw, 3)
        if (pw, ph) != (self.config.width, self.config.height):
            from raytracer_tpu.integrator.denoise import upscale_bilinear

            rad = upscale_bilinear(
                rad, ph, pw, self.config.height, self.config.width
            )
        return np.asarray(rad).reshape(
            self.config.height, self.config.width, 3
        )

    # -- checkpoint / resume ---------------------------------------------
    def save_checkpoint(self, path: str):
        extra = {}
        if self.reservoir is not None:
            # ReSTIR temporal history is part of the render state: dropping
            # it on resume silently restarts temporal reuse from scratch.
            extra = {
                f"reservoir_{k}": np.asarray(v)
                for k, v in self.reservoir._asdict().items()
            }
        if self.adaptive is not None:
            # Per-pixel Welford state. The mean IS the accum buffer (saved
            # above) — only m2/count are extra, and they resume the
            # convergence decisions exactly.
            extra.update({
                "adaptive_m2": np.asarray(self.adaptive.m2),
                "adaptive_count": np.asarray(self.adaptive.count),
            })
        np.savez_compressed(
            path, accum=np.asarray(self.accum), frame=self.frame,
            width=self.config.width, height=self.config.height,
            **extra,
        )

    def load_checkpoint(self, path: str):
        data = np.load(path)
        assert int(data["width"]) == self.config.width
        assert int(data["height"]) == self.config.height
        self.accum = self._place_accum(jnp.asarray(data["accum"]))
        self.frame = int(data["frame"])
        if self.config.use_restir:
            from raytracer_tpu.integrator.restir import Reservoir

            if "reservoir_weight_sum" in data:
                self.reservoir = self._place_reservoir(Reservoir(**{
                    k: jnp.asarray(data[f"reservoir_{k}"])
                    for k in Reservoir._fields
                }))
            else:
                # Pre-round-2 checkpoint without reservoir state: resume the
                # accumulation but restart temporal reuse.
                self.reservoir = self._place_reservoir(
                    Reservoir.empty(self.config.num_pixels)
                )
        if self.adaptive is not None:
            from raytracer_tpu.integrator.adaptive import AdaptiveState

            if "adaptive_m2" in data:
                self.adaptive = self._place_adaptive(AdaptiveState(
                    mean=jnp.asarray(data["accum"]),
                    m2=jnp.asarray(data["adaptive_m2"]),
                    count=jnp.asarray(data["adaptive_count"]),
                ))
            else:
                # Plain checkpoint into an adaptive renderer: the
                # accumulation resumes (uniform per-pixel count) but there
                # is NO variance history — m2=0 would declare every pixel
                # converged instantly and freeze the render, so seed
                # m2=+inf: pixels keep sampling (adaptive never retires
                # anything for this resumed render) and the image keeps
                # improving like a plain one.
                import logging

                logging.getLogger(__name__).warning(
                    "resuming a non-adaptive checkpoint with adaptive "
                    "sampling: no variance history, convergence detection "
                    "disabled for this render"
                )
                self.adaptive = self._place_adaptive(AdaptiveState(
                    mean=jnp.asarray(data["accum"]),
                    m2=jnp.full((self.config.num_pixels,), jnp.inf,
                                jnp.float32),
                    count=jnp.full((self.config.num_pixels,),
                                   int(data["frame"]), jnp.uint32),
                ))
        # Materialize the camera UBO now and clear the dirty flag so the
        # next begin_frame() doesn't wipe the restored accumulation (the
        # caller asserts the camera/scene match the checkpointed render).
        self._refresh_camera_ubo()
        self.camera.clear_dirty()


def render(scene: Scene, camera: Optional[Camera] = None,
           config: Optional[RenderConfig] = None,
           num_frames: int = 1) -> np.ndarray:
    """One-shot render: `num_frames` progressive samples, returns
    f32[H,W,3] linear radiance."""
    r = ProgressiveRenderer(scene, camera, config)
    return r.render(num_frames)
