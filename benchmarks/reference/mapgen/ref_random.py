"""Reference-exact RNG construction.

The reference seeds every np.random.RandomState through gym 0.17's
hash-seed scheme (metadrive/utils/random_utils.py:14-36: sha512 the decimal
seed string, take 8 bytes as a little-endian bigint, split into uint32
limbs, RandomState.seed(limbs)). Replicating that scheme bit-for-bit is
what makes per-seed map structure comparable against the reference:
BIG's block-type/socket/seed draws (BIG.py:97-118) and every block's
parameter draws (base_runnable.py:81-93) come from these states.
"""
import hashlib

import numpy as np


def _uint32_limbs(bigint):
    if bigint == 0:
        return [0]
    limbs = []
    while bigint > 0:
        bigint, lo = divmod(bigint, 2 ** 32)
        limbs.append(lo)
    return limbs


def _hash_seed(seed):
    digest = hashlib.sha512(str(seed).encode("utf8")).digest()[:8]
    return int.from_bytes(digest, "little")


def ref_rng(seed):
    """RandomState seeded exactly like the reference's get_np_random(seed)."""
    seed = int(seed) % 2 ** 64
    rng = np.random.RandomState()
    rng.seed(_uint32_limbs(_hash_seed(seed)))
    return rng


def parameter_u(space_seed):
    """The single uniform draw behind a reference parameter-space sample.

    ParameterSpace.seed(s) seeds EVERY member space with the same s
    (pg_space.py Dict.seed), and each member's Box.sample consumes exactly
    one random_sample as its first draw — so all parameters of one
    sampling event derive from this one u.
    """
    return float(ref_rng(space_seed).random_sample())
