"""Runnable headless examples (reference: metadrive/examples/*).

Each module is a ``python -m metadrive_ped_torch.examples.<name>`` entry
point whose ``main(argv=None)`` drives the port. They run on the GPU; pass
``--cpu`` to run on the CPU. Without ``--cpu`` and without a GPU they raise.
"""
import numpy as np

from metadrive_ped_torch.core.device import resolve_device


def force_cpu_flag(parser):
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")


def example_device(args):
    """The device an example runs on: the CPU with --cpu, else CUDA, which
    raises when there is no GPU."""
    return resolve_device("cpu" if getattr(args, "cpu", False) else None)


def save_image(frame, path):
    """Write an RGB uint8 frame as an image with PIL; where PIL is missing,
    as ``path + ".npy"``. Returns the path written."""
    try:
        from PIL import Image
    except ImportError:
        np.save(path + ".npy", frame)
        return path + ".npy"
    Image.fromarray(frame).save(path)
    return path
