"""The check that a run loaded nothing of the JAX side: no module whose
top-level name (the part before the first dot) is one of BLOCKED, compared
whole, so that ``metadrive_ped_torch`` and ``benchmarks`` pass."""
import sys

BLOCKED = ("jax", "jaxlib", "flax", "metadrive_ped_tpu", "bench")


def blocked_modules(names=None):
    """The sorted names among ``names`` (default: `sys.modules`) whose
    top-level name is blocked."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in BLOCKED)
