"""Device selection for the port's entry points."""

import torch


def resolve_device(device="cuda"):
    """``torch.device`` for an entry point's ``device=`` argument.

    The default is the card.  A CUDA device with no card visible raises
    instead of carrying on on the CPU: a CPU run of a GPU program
    measures the wrong machine, so it has to be asked for by name."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is "
            "visible; pass device='cpu' explicitly to run on the CPU"
        )
    return dev
