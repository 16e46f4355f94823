import torch


def true_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """x / divisor with IEEE division on every device.

    PyTorch's CUDA division by a Python scalar multiplies by the scalar's
    reciprocal, which can differ from the quotient in the last bit; a
    0-dim tensor divisor on x's device keeps true division, so CPU and
    card agree with each other and with the JAX reference.
    """
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)
