"""Tensor ops of the port. The names the JAX package's `ops` re-exports
are read from their modules on first use (`_lazy.py`): every op module
imports `true_div` from here."""

import torch

from vehicle_counting_tpu_torch._lazy import lazy_exports


def true_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """x / divisor with IEEE division on every device.

    PyTorch's CUDA division by a Python scalar multiplies by the scalar's
    reciprocal, which can differ from the quotient in the last bit; a
    0-dim tensor divisor on x's device keeps true division, so CPU and
    card agree with each other and with the JAX reference.
    """
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


__all__, __getattr__ = lazy_exports(__name__, {
    "boxes": ("xyxy_to_tlwh", "tlwh_to_xyxy", "xyxy_to_cxcywh", "cxcywh_to_xyxy", "tlwh_to_xyah", "xyah_to_tlwh",
              "clip_boxes", "iou_matrix", "sort_overlap_matrix"),
    "letterbox": ("letterbox_params", "letterbox", "restore_boxes"),
    "nms": ("greedy_suppress", "batched_nms", "sort_nms_mask"),
    "crops": ("gather_crops", "crop_boxes_to_bounds", "CROP_SIZE"),
})
__all__.append("true_div")
