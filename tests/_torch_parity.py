"""Helpers shared by the tests that hold metadrive_ped_torch against the JAX
package: data goes between the two as numpy arrays."""
import dataclasses
import logging

import numpy as np
import torch

from metadrive_ped_torch.core.convert import state_to_numpy
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


def surface_rows(env):
    """Row index of each element of the env's [E, ...] / [E, A, ...]
    surface arrays (the RL columns only, for TinyInter)."""
    E = env.config["num_envs"]
    A = getattr(env, "agents_per_env", None)
    if A is None:
        return np.arange(E)
    return np.arange(E * A).reshape(E, A)[:, :getattr(env, "num_RL_agents", A)]


# flags and sums a frozen corpse's exact contact decides (see check_run)
CONTACT_KEYS = {"crash_vehicle", "crash_object", "crash_building", "crash_human", "crash_sidewalk",
                "crash", "cost", "total_cost", "episode_reward", "reward"}
EPISODE_SUMS = {"total_cost", "episode_reward"}
CONTACT_STATE = ("crash_vehicle", "crash_object", "crash_building", "crash_human", "crash_sidewalk")


def run_pair(jenv, tenv, actions, seed=0):
    """Reset both envs with ``seed`` and step them with the same actions
    (numpy, one array per step). Returns dict(reset=(jax, torch),
    steps=[(jax_out, torch_out, jax_pre_state, torch_pre_state)],
    final=(jax_tree, torch_tree)); the pre-step states are the JAX state as
    numpy trees and the port's as its state object."""
    out = dict(reset=(jenv.reset(seed=seed), tenv.reset(seed=seed)), steps=[])
    for a in actions:
        pre = (np_tree(jenv._state), tenv._state)
        out["steps"].append((jenv.step(a), tenv.step(a)) + pre)
    out["final"] = (np_tree(jenv._state), state_to_numpy(tenv._state))
    return out


def _corners(p, h, length, width):
    d = np.array([np.cos(h), np.sin(h)])
    n = np.array([-d[1], d[0]])
    return np.array([p + a * length / 2 * d + b * width / 2 * n for a, b in
                     ((-1, -1), (1, -1), (1, 1), (-1, 1))])


def _box_gap(P, Q):
    """Separation of two convex quads in float64: > 0 apart, < 0 overlap."""
    gap = -np.inf
    for R in (P, Q):
        for i in range(4):
            e = R[(i + 1) % 4] - R[i]
            axis = np.array([-e[1], e[0]]) / max(np.hypot(*e), 1e-12)
            p, q = P @ axis, Q @ axis
            gap = max(gap, p.min() - q.max(), q.min() - p.max())
    return gap


def contact_separation(tenv, state, row):
    """Smallest |separation| in metres, in float64, between the ego of
    ``row`` and any active body of its targets (OBBs; cylinders as circles)
    at ``state``."""
    (pos, heading, length, width, active), radius = tenv._lidar_targets(state)
    ego = state.ego
    f = lambda x: to_np(x).astype(np.float64)
    box = _corners(f(ego.pos[row]), f(ego.heading[row]), f(ego.params.length[row]),
                   f(ego.params.width[row]))
    best = np.inf
    for j in np.nonzero(to_np(active[row]))[0]:
        r = 0.0 if radius is None else float(radius[row, j])
        if r > 0:
            # circle: distance from the centre to the box, less the radius
            c = f(pos[row, j])
            d = c - box.mean(0)
            u = (box[1] - box[0]) / np.hypot(*(box[1] - box[0]))
            v = np.array([-u[1], u[0]])
            half = np.array([np.hypot(*(box[1] - box[0])), np.hypot(*(box[3] - box[0]))]) / 2
            q = np.abs([d @ u, d @ v]) - half
            gap = np.hypot(*np.maximum(q, 0)) + min(q.max(), 0) - r
        else:
            gap = _box_gap(box, _corners(f(pos[row, j]), f(heading[row, j]), f(length[row, j]),
                                         f(width[row, j])))
        best = min(best, abs(gap))
    return best


def check_run(run, tenv, yaw_col, atol=1e-4, contact_tol=1e-5):
    """Every step of `run_pair`: obs (`obs_gap`), reward and every float info
    key within atol (episode sums also within 1e-6 relative), terminated,
    truncated, __all__ and every int/bool info key equal, and the final
    state trees (`assert_trees_close`: ints and bools exact, floats within
    atol).

    One difference is allowed, and each instance is checked: a frozen
    corpse (dead_timer > 0 before the step in both packages) whose body
    touches another body to within ``contact_tol`` m in float64. The
    contact push leaves two bodies exactly touching, and a corpse keeps
    that pose, so its contact flags (and the reward and cost they set) are
    decided by float32 rounding, in either package (ROADMAP.md queue 3).
    Such a row may differ in CONTACT_KEYS that step and in its episode
    sums until it spawns again. Returns the number of such row-steps."""
    rows_of = surface_rows(tenv)
    tainted = np.zeros(tenv.num_envs, bool)
    contacts = 0
    steps = run["steps"]
    for i, (jout, tout, jpre, tpre) in enumerate(steps):
        oj, rj, tj, trj, ij = jout
        ot, rt, tt, trt, it = tout
        D = np.asarray(oj).shape[-1]
        assert obs_gap(np.asarray(oj).reshape(-1, D), to_np(ot).reshape(-1, D), yaw_col) <= atol
        for a, b in ((tj, tt), (trj, trt)):
            np.testing.assert_array_equal(to_np(b), np.asarray(a))
        assert set(it) == set(ij)
        if "__all__" in ij:
            np.testing.assert_array_equal(to_np(it["__all__"]), np.asarray(ij["__all__"]))
        differ = {}
        for k, a, b in [("reward", rj, rt)] + [(k, ij[k], it[k]) for k in ij if k != "__all__"]:
            a, b = np.asarray(a), to_np(b)
            if a.dtype.kind in "biu":
                bad = a != b
            else:
                bad = np.abs(a - b) > atol + (1e-6 * np.abs(a) if k in EPISODE_SUMS else 0)
            if bad.shape == rows_of.shape:
                for r in rows_of[bad]:
                    differ.setdefault(int(r), set()).add(k)
            else:
                assert not bad.any(), k
        for r, keys in differ.items():
            corpse = jpre["dead_timer"][r] > 0 and int(tpre.dead_timer[r]) > 0
            if corpse and keys <= CONTACT_KEYS and contact_separation(tenv, tpre, r) < contact_tol:
                tainted[r] = True
                contacts += 1
            else:
                assert tainted[r] and keys <= EPISODE_SUMS, (r, keys)
        # a row that spawns again starts its episode sums afresh
        post = (to_np(steps[i + 1][3].step_count) if i + 1 < len(steps)
                else run["final"][1]["step_count"])
        tainted &= post != 0
    jfinal, tfinal = run["final"]
    patch = np.nonzero(tainted)[0]
    for k in CONTACT_STATE:
        tfinal["ego"][k][patch] = jfinal["ego"][k][patch]
    for k in ("episode_reward", "episode_cost"):
        tfinal[k][patch] = jfinal[k][patch]
    assert_trees_close(jfinal, tfinal, atol=atol)
    return contacts


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
