"""Where the port's entry points run."""
import torch


def resolve_device(device):
    """The device of an entry point: CUDA unless the caller asks for another.
    Raises when CUDA is asked for (or defaulted to) and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the env runs on the GPU by default; pass "
            "device='cpu' to run it on the CPU"
        )
    return device
