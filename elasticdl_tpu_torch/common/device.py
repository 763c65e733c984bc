"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. A
request for ``cuda`` on a machine without a card raises: the port never
falls back to the CPU on its own, so a run that was meant for the card
cannot silently measure the host instead.
"""

import torch


def resolve_device(name="cuda"):
    """``torch.device`` for ``name`` ("cuda", "cuda:N", "cpu" or a
    ``torch.device``)."""
    try:
        device = torch.device(name or "cuda")
    except RuntimeError:  # a string torch does not parse as a device
        device = None
    if device is None or device.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r (cuda or cpu)" % (name,))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r requested but torch.cuda.is_available() is False; "
            "pass --device cpu to run on the host" % (name,)
        )
    return device
