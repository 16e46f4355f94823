"""Host utilities of the port; the names the JAX package's `utils`
re-exports, each read from its module on first use."""

from vehicle_counting_tpu_torch._lazy import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    "colors": ("color_list", "color_for_track"),
    "seed": ("seed_everything",),
    "device": ("get_devices_info",),
    "download": ("download_pretrained_weights", "get_model_weights"),
    "registry": ("get_instance", "register"),
})
