"""YOLOv5 and the detector of the port; the names the JAX package's
`models` re-exports, each read from its module on first use."""

from vehicle_counting_tpu_torch._lazy import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    "yolo": ("YoloConfig", "init_yolov5", "yolov5_forward", "decode_predictions", "VARIANTS"),
    "detector": ("Detector", "detect_step", "COCO_VEHICLE_MAPPING", "VEHICLE_CLASS_NAMES"),
})
