"""PyTorch + CUDA port of the vehicle counting pipeline, for one NVIDIA H100.

The JAX package `vehicle_counting_tpu` is the reference this port is held
against. Modules mirror its paths (`ops/letterbox.py`, `models/yolo.py`,
`tracking/tracker.py`, ...). The port imports `torch` and never `jax`,
and nothing of the JAX package: it keeps its own copies of the host
modules it needs (configs, counting, video I/O, colors).

Hand-written CUDA kernels live in `csrc/` and are built with `nvcc` at
first use (`_build.py`); every kernel wrapper runs its plain PyTorch
version for CPU tensors and launches the kernel for CUDA tensors.

    python -m vehicle_counting_tpu_torch.run --input_path <video> --output_path <dir>

Public surface, as the JAX package's:

    from vehicle_counting_tpu_torch import Config, CountingPipeline
"""

from vehicle_counting_tpu_torch._lazy import lazy_exports
from vehicle_counting_tpu_torch.configs import Config, config_from_dict
from vehicle_counting_tpu_torch.version import __version__

# CountingPipeline is imported on first use, so that `import
# vehicle_counting_tpu_torch` pulls in neither cv2 nor the pipeline.
_, __getattr__ = lazy_exports(__name__, {"pipeline": ("CountingPipeline",)})
__all__ = ["__version__", "Config", "config_from_dict"]
