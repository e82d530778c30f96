"""wgpu_path_tracing_tpu_torch — the path tracer in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of ``wgpu_path_tracing_tpu`` (JAX on a TPU), which stays beside it as
the reference. The render runs end to end, textured or not, in the three
rng modes: scene packing (with the fat texture canvas), camera rays, the
closest hit (kernel K1, ``csrc/dense_hit.cu``, the dense hit for scenes of
up to 4,096 triangles; kernel K3, ``csrc/walk.cu``, the wide-BVH walk
above; kernels K4-K6, the dispatch intersectors, for trees too deep for the
walk or when forced), the bounce shading stage (kernel K2,
``csrc/bounce.cu``, untextured or sampling the texture atlas per slot or
from the fat canvas, with rng="stratified"'s bounce-0 override, and
with an environment map that lights the misses), accumulation, the AGX
display transform, PNG, HDR and EXR output, checkpoints, glTF files in and
out (``load_model``, ``scene_to_glb``; PNG and baseline JPEG textures), the
pass profiler and the frame meter, the fly-camera ``Controller``, the HTTP
live viewer (``viewer.py``) and the command line (``cli.py``). Scene
preparation (the SAH build, the wide collapse, the glTF flatten, the atlas
packing) runs in a C++ library that ``accel/native.py`` builds with g++,
bit-identical to the NumPy paths it stands in for. The ``Renderer`` runs
on the card unless it is given ``device="cpu"``, where each kernel's plain
PyTorch version runs instead.

    from wgpu_path_tracing_tpu_torch import (
        Renderer, RenderConfig, cornell_box, gallery_atrium, scene_to_glb,
        textured_cornell)
    r = Renderer(RenderConfig(width=512, height=512))   # on the card
    r.load_scene(cornell_box())                  # 36 triangles: K1
    img = r.render(spp=64)
    r.load_scene(textured_cornell())             # 32x32 atlas, fat canvas
    img = r.render(spp=64)
    r.load_scene(cornell_box(tessellation=55))   # 102,852 triangles: K3
    img = r.render(spp=8)
    open("atrium.glb", "wb").write(scene_to_glb(gallery_atrium()))
    r.load_model("atrium.glb")                   # about 116k triangles: K3
    img = r.render(spp=8)
    r.set_environment(sky_rgb, intensity=1.0)    # (H, W, 3) equirect map
    print(r.stats()["passes"], r.stats()["frames"])
    c = Controller(r)                            # the fly camera
    c.key_down("w"); c.update(1 / 60); c.key_up("w")

    python -m wgpu_path_tracing_tpu_torch.cli render cornell --spp 64 -o a.png
    python -m wgpu_path_tracing_tpu_torch.cli view cornell --port 8080

The package imports neither JAX nor Pillow, so that it runs where only
PyTorch, numpy and the CUDA toolkit are installed.
"""

from wgpu_path_tracing_tpu_torch.models.export import scene_to_glb
from wgpu_path_tracing_tpu_torch.models.gallery import gallery_atrium
from wgpu_path_tracing_tpu_torch.models.gltf import load_model
from wgpu_path_tracing_tpu_torch.models.procedural import (
    cornell_box,
    material_test_box,
    random_triangles,
    single_triangle,
    textured_cornell,
)
from wgpu_path_tracing_tpu_torch.models.replica import cornell_replica
from wgpu_path_tracing_tpu_torch.models.types import load_jax_scene
from wgpu_path_tracing_tpu_torch.render.camera import Camera
from wgpu_path_tracing_tpu_torch.render.config import RenderConfig
from wgpu_path_tracing_tpu_torch.render.controller import Controller
from wgpu_path_tracing_tpu_torch.render.renderer import Renderer

__version__ = "0.1.0"

__all__ = [
    "Renderer", "RenderConfig", "Camera", "Controller", "cornell_box", "material_test_box",
    "random_triangles", "single_triangle", "textured_cornell",
    "gallery_atrium", "cornell_replica", "load_model", "scene_to_glb",
    "load_jax_scene", "__version__",
]
