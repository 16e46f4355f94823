"""Serving artifacts: export a step of the port, load it back and run it.

Port of `vehicle_counting_tpu/serving/`. See artifact.py for the format and
for what it gives beside the JAX package's StableHLO artifacts (it needs
the same port source revision that exported it); cli.py for `python -m
vehicle_counting_tpu_torch.serving.cli` export / smoke / verify.
"""

from vehicle_counting_tpu_torch.serving.artifact import (  # noqa: F401
    FORMAT_VERSION,
    ServingArtifact,
    export_detect_step,
    export_framedp_step,
    export_multicam_step,
    export_pipeline_step,
    load_weights_bundle,
    save_artifact,
    save_weights_bundle,
    serving_frames_shape,
)

__all__ = [
    "FORMAT_VERSION",
    "ServingArtifact",
    "export_detect_step",
    "export_framedp_step",
    "export_multicam_step",
    "export_pipeline_step",
    "load_weights_bundle",
    "save_artifact",
    "save_weights_bundle",
    "serving_frames_shape",
]
