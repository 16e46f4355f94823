"""Per-class DeepSORT of the port; the names the JAX package's `tracking`
re-exports, each read from its module on first use."""

from vehicle_counting_tpu_torch._lazy import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    "tracker": ("TrackerParams", "TrackerState", "TrackerOutputs", "init_state", "tracker_step"),
    "deepsort": ("DeepSortParams", "init_states", "deepsort_frame"),
    "assignment": ("solve_assignment",),
})
