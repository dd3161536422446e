"""micro_raytracer_tpu_torch: the PyTorch + CUDA port of micro_raytracer_tpu.

Same scene grammar, CLI and HTTP service as the JAX package beside it,
rendering on an explicit ``torch`` device. On a CUDA device the trace runs
hand-written kernels (``csrc/``, built with nvcc at first use); on the CPU
it runs their plain PyTorch versions. Imports no JAX.
"""

from .models.schema import RenderConfig, SceneConfig, FrameConfig  # noqa: F401
from .models.compiler import compile_scene, compile_camera  # noqa: F401
from .models.render import Renderer, render_image  # noqa: F401
from .models.tracer import trace_radiance, trace_radiance_u  # noqa: F401

__version__ = "0.1.0"
