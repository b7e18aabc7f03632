"""The reference steps op by op on every device: it captures no graph."""


def capture_backend(device):
    """None: no capture, so `step` and `rollout` run eagerly."""
    return None
