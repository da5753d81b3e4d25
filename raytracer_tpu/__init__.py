"""raytracer_tpu — a wavefront path tracer in JAX.

A from-scratch rebuild of the capabilities of ARTurleite6/RayTracer (an
Odin + Vulkan-KHR-ray-tracing interactive progressive path tracer) built on
SoA ray wavefronts, host-built BVHs flattened for stackless
vectorized traversal, vmapped GGX/NEE/MIS shading, pjit/shard_map pixel-tile
data parallelism over a device mesh, and progressive accumulation as the
render/checkpoint state.

Layer map (mirrors SURVEY.md §7):
  scene/       Scene model, change journal, glTF/GLB + JSON loaders,
               procedural meshes, device-side baked scene (SceneOnDevice)
  accel/       LBVH / binned-SAH BVH build (numpy + native C++), flattening
  ops/         rng (TEA-16 + LCG), math3d, brdf (GGX), camera, intersect,
               traverse — the device-algorithm layer (reference shaders/)
  integrator/  wavefront bounce loop, NEE/MIS, accumulation, ReSTIR DI,
               adaptive sampling, preview denoiser
  parallel/    device-mesh sharding of pixel tiles (shard_map)
  utils/       images (PNG/SSIM), stats, checkpointing
  api.py       render()/ProgressiveRenderer — the public API
  cli.py       command-line renderer (reference src/main.odin)
"""

__version__ = "0.1.0"

from raytracer_tpu.utils.config import RenderConfig  # noqa: F401


def __getattr__(name):
    # Lazy re-exports: importing the package stays light (no jax tracing).
    if name in ("render", "ProgressiveRenderer"):
        import raytracer_tpu.api as api

        return getattr(api, name)
    if name == "Camera":
        from raytracer_tpu.ops.camera import Camera

        return Camera
    if name == "load_scene":
        from raytracer_tpu.scene.loaders import load_scene

        return load_scene
    raise AttributeError(name)
