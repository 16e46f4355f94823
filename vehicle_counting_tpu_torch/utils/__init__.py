"""Host utilities of the port; the names the JAX package's `utils`
re-exports, each read from its module on first use. The JAX package's
download helpers have no counterpart: the port downloads nothing."""

from vehicle_counting_tpu_torch._lazy import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    "colors": ("color_list", "color_for_track"),
    "seed": ("seed_everything",),
    "device": ("get_devices_info",),
    "registry": ("get_instance", "register"),
})
