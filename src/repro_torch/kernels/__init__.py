"""Hand-written Hopper kernels of the port (one package per TPU kernel)."""
import torch


def require_plain(name: str, *tensors) -> None:
    """Kernels take plain tensors only: a tensor subclass such as a
    DTensor (whose data is spread over a mesh) raises, so no kernel or
    its plain version ever computes on something else."""
    for t in tensors:
        if isinstance(t, torch.Tensor) \
                and type(t) not in (torch.Tensor, torch.nn.Parameter):
            raise TypeError(f"{name} takes plain tensors, got a "
                            f"{type(t).__name__}: pass its local tensor")
