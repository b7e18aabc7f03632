"""Helpers shared by the tests that hold metadrive_ped_torch against the JAX
package: data goes between the two as numpy arrays."""
import dataclasses
import logging

import numpy as np
import torch

from metadrive_ped_torch.core.logger import get_logger as torch_logger
from metadrive_ped_tpu.core.logger import get_logger as jax_logger

jax_logger().setLevel(logging.WARNING)
torch_logger().setLevel(logging.WARNING)


def np_tree(x):
    """A JAX pytree dataclass (SimState, Scene, ...) as nested dicts of numpy
    arrays, keyed by field name."""
    if dataclasses.is_dataclass(x):
        return {f.name: np_tree(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


def jax_tree(cls, tree):
    """Inverse of `np_tree`: a JAX pytree dataclass of class ``cls`` from
    nested dicts of numpy arrays (int64 PRNG words become uint32)."""
    import typing

    import jax.numpy as jnp
    hints = typing.get_type_hints(cls)
    fields = {}
    for f in dataclasses.fields(cls):
        v = tree[f.name]
        if dataclasses.is_dataclass(hints.get(f.name)):
            fields[f.name] = jax_tree(hints[f.name], v)
        else:
            v = np.asarray(v)
            fields[f.name] = jnp.asarray(v.astype(np.uint32) if f.name == "rng" else v)
    return cls(**fields)


def to_np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def t(a):
    """numpy (or JAX) array -> CPU tensor of the same dtype."""
    return torch.as_tensor(np.array(np.asarray(a)))


def assert_trees_close(jax_tree, torch_tree, atol, path=""):
    """Every leaf of two nested-dict trees: integers and bools exact, floats
    within atol (uint32 keys compare as int64)."""
    for k, a in jax_tree.items():
        b = torch_tree[k]
        name = f"{path}.{k}" if path else k
        if isinstance(a, dict):
            assert_trees_close(a, b, atol, name)
            continue
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)


def yaw_column(cfg_vehicle, random_agent_model=False):
    """Index of the yaw-rate feature in the state observation."""
    side = cfg_vehicle.get("side_detector", {}).get("num_lasers", 0)
    col = (2 if side == 0 else side) + 5
    return col + (2 if random_agent_model else 0)


def obs_gap(obs_jax, obs_torch, yaw_col, lat_cols=()):
    """Max abs obs difference, with the yaw-rate feature compared through
    cos(0.1 * f): the JAX package computes it as arccos(<h_t, h_t-1>) / 0.1,
    where a 1-ulp difference of the dot product near 1 moves the feature by
    up to 3.5e-3; cos(0.1 * f) is that dot product (clipped), compared at
    the same tolerance as every other feature.

    ``lat_cols`` are features clip01((lat / w + 1) / 2) of a lateral offset
    computed as sqrt(|rel|^2 - long^2) (ops/polyline.py::local_coordinates,
    in both packages), which cancels near lat = 0: there a 1-ulp difference
    of |rel|^2 moves lat by up to 5e-4 m. They are compared through the
    signed square x|x| of x = 2f - 1 = lat / w, which carries that
    difference of the squares and nothing more."""
    a = np.asarray(obs_jax, np.float64)
    b = to_np(obs_torch).astype(np.float64)
    d = np.abs(a - b)
    d[:, yaw_col] = np.abs(np.cos(0.1 * a[:, yaw_col]) - np.cos(0.1 * b[:, yaw_col]))
    for c in lat_cols:
        x, y = 2 * a[:, c] - 1, 2 * b[:, c] - 1
        d[:, c] = np.abs(x * np.abs(x) - y * np.abs(y))
    return float(d.max())
