"""torrey — a progressive path tracer in JAX, for the GPU.

A JAX/XLA/Pallas framework with the capabilities of the CUDA
reference ``jayHuggie/PathTracer_CUDA_Interactive`` (see SURVEY.md):
Mitsuba-XML scenes, OBJ/PLY/serialized meshes, BVH-accelerated sphere +
triangle path tracing with diffuse/mirror/plastic/Phong BSDFs, progressive
accumulation with interactive camera, multi-device tile sharding over a
``jax.sharding.Mesh``, and — beyond the reference — differentiable
rendering with validated pixel gradients.
"""

__version__ = "0.1.0"

from .models.scenepack import ScenePack, load_scene, pack_scene  # noqa: F401
from .io.xml_scene import parse_scene  # noqa: F401
