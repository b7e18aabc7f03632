"""The port's multi-agent envs against the JAX package's, step for step: the
base `MultiAgentMetaDrive`, the roundabout and the intersection, from the
same seed and the same random actions, through crashes between agents,
delay-done corpses, respawns and auto-resets; and the MARL pieces of the
ops (IDM against extra bodies with no ego, the navigation checkpoints, the
respawn claim) held alone. Tolerances and the one allowed difference (a
frozen corpse in exact contact) are those of
tests/_torch_parity.py::check_run."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    check_run, jax_tree, np_tree, obs_gap, run_pair, surface_rows, t, to_np, yaw_column,
)

import metadrive_ped_torch as T
from metadrive_ped_torch.core.convert import state_from_numpy, state_to_numpy
from metadrive_ped_torch.ops import idm as t_idm
from metadrive_ped_torch.ops import localization as t_loc
from metadrive_ped_tpu.core.structs import SimState as JaxSimState
from metadrive_ped_tpu.envs import marl_envs as J
from metadrive_ped_tpu.ops import idm as j_idm
from metadrive_ped_tpu.ops import localization as j_loc

ATOL = 1e-4


def random_actions(shape, steps, seed=0, mean=(0.0, 0.7), std=(0.3, 0.4)):
    rng = np.random.RandomState(seed)
    return list(np.clip(rng.normal(mean, std, (steps,) + shape + (2,)), -1, 1).astype(np.float32))


def full_throttle(shape, steps):
    return [np.tile(np.float32([0.0, 1.0]), shape + (1,))] * steps


# name -> (class name, config, steps, actions(surface shape, steps))
CASES = {
    "base": ("MultiAgentMetaDrive", dict(num_envs=2, num_agents=4), 60, random_actions),
    # corpses freeze for delay_done steps, then respawn on free slots
    "roundabout_respawn": ("MultiAgentRoundaboutEnv", dict(num_envs=2, num_agents=8, delay_done=5),
                           90, full_throttle),
    # agents from four arms at full throttle crash into each other
    "intersection_crash": ("MultiAgentIntersectionEnv",
                           dict(num_envs=2, num_agents=8, delay_done=5), 80, full_throttle),
    # no respawn: an env resets when all its agents are done
    "intersection_all_done": ("MultiAgentIntersectionEnv",
                              dict(num_envs=2, num_agents=4, allow_respawn=False, delay_done=2,
                                   horizon=40), 70, random_actions),
    # background IDM traffic stepped once per env against all agents
    "roundabout_traffic": ("MultiAgentRoundaboutEnv",
                           dict(num_envs=2, num_agents=4, traffic_density=0.3,
                                traffic_mode="respawn"), 40, random_actions),
    "discrete": ("MultiAgentRoundaboutEnv",
                 dict(num_envs=1, num_agents=4, discrete_action=True,
                      discrete_steering_dim=3, discrete_throttle_dim=3), 20, None),
}
_RUNS = {}


def get_run(name):
    if name not in _RUNS:
        cls, cfg, steps, acts = CASES[name]
        je, te = getattr(J, cls)(cfg), getattr(T, cls)(cfg, device="cpu")
        shape = surface_rows(te).shape
        if acts is None:
            actions = list(np.random.RandomState(0).randint(0, 9, (steps,) + shape).astype(np.int32))
        else:
            actions = acts(shape, steps)
        _RUNS[name] = (je, te, run_pair(je, te, actions))
    return _RUNS[name]


@pytest.mark.parametrize("name", sorted(CASES))
def test_env_matches_jax(name):
    je, te, run = get_run(name)
    (oj, ij), (ot, it) = run["reset"]
    assert tuple(ot.shape) == tuple(np.asarray(oj).shape) == surface_rows(te).shape + (
        te.observation_dim,)
    D = te.observation_dim
    assert obs_gap(np.asarray(oj).reshape(-1, D), to_np(ot).reshape(-1, D),
                   yaw_column(te.config["vehicle_config"])) <= ATOL
    np.testing.assert_array_equal(to_np(it["env_seed"]), np.asarray(ij["env_seed"]))
    check_run(run, te, yaw_column(te.config["vehicle_config"]), atol=ATOL)


def _per_step(run, key):
    """[steps, rows] of a state field after each step (port side)."""
    states = [s[3] for s in run["steps"][1:]]
    last = run["final"][1]
    return np.stack([to_np(getattr(s, key)) for s in states] + [last[key]])


def test_crash_between_agents():
    je, te, run = get_run("intersection_crash")
    dead_before = np.stack([s[2]["dead_timer"] for s in run["steps"]]) > 0
    crash = np.stack([np.asarray(s[0][4]["crash_vehicle"]).reshape(-1) for s in run["steps"]])
    assert (crash & ~dead_before).any(), "live agents must hit each other"
    assert te.scene.npc_valid.sum() == 0, "no traffic: every vehicle hit is an agent"


def test_corpse_frozen_then_respawned():
    je, te, run = get_run("roundabout_respawn")
    delay = te.config["delay_done"]
    dead = _per_step(run, "dead_timer")
    count = _per_step(run, "step_count")
    pos = np.stack([to_np(s[3].ego.pos) for s in run["steps"][1:]] + [run["final"][1]["ego"]["pos"]])
    seen = 0
    for r in range(dead.shape[1]):
        starts = np.nonzero(dead[1:, r] == delay)[0] + 1
        for s0 in starts:
            if s0 + delay >= dead.shape[0]:
                continue
            # frozen in place while dead, then back at a spawn slot with a
            # fresh episode
            assert np.abs(pos[s0:s0 + delay, r] - pos[s0, r]).max() == 0
            assert dead[s0 + delay - 1, r] == 1 and dead[s0 + delay, r] == 0
            assert count[s0 + delay, r] == 0
            seen += 1
    assert seen > 0, "a corpse must sit out delay_done steps and respawn"


def test_all_done_auto_reset_without_respawn():
    je, te, run = get_run("intersection_all_done")
    alls = np.stack([to_np(s[1][4]["__all__"]) for s in run["steps"]])
    assert alls.any(), "an env must finish with all its agents done"
    i = int(np.nonzero(alls.any(1))[0][0])
    e = int(np.nonzero(alls[i])[0][0])
    after = run["steps"][i + 1][3] if i + 1 < len(run["steps"]) else None
    assert after is not None
    A = te.agents_per_env
    assert (to_np(after.step_count).reshape(-1, A)[e] == 0).all()
    assert (to_np(after.ego.speed).reshape(-1, A)[e] == 0).all()


def test_auto_reset_reuses_slots_as_jax_does():
    """The base step's auto-reset draws each agent row's spawn slot on its
    own (JAX package, envs/base.py:1178-1181 and :604-614), unlike the
    distinct slots of the first reset: after the all-done reset at step 4,
    env 1 holds slot 53 twice. The port does the same (ROADMAP.md queue
    3)."""
    cfg = dict(num_envs=2, num_agents=8, allow_respawn=False, delay_done=0, horizon=4)
    je, te = J.MultiAgentIntersectionEnv(cfg), T.MultiAgentIntersectionEnv(cfg, device="cpu")
    je.reset(seed=0)
    te.reset(seed=0)
    first = to_np(te._state.ego.slot).reshape(2, 8)
    assert all(len(set(row)) == 8 for row in first)
    zeros = np.zeros((2, 8, 2), np.float32)
    for _ in range(6):
        je.step(zeros)
        te.step(zeros)
        np.testing.assert_array_equal(to_np(te._state.ego.slot), np.asarray(je._state.ego.slot))
        np.testing.assert_array_equal(to_np(te._state.sidx), np.asarray(je._state.sidx))
    slots = to_np(te._state.ego.slot).reshape(2, 8)
    assert list(slots[1]) == [17, 53, 52, 30, 1, 31, 53, 44]


def test_same_step_respawns_claim_distinct_slots():
    """Every agent respawns on one step with all slots free: the claims run
    agent by agent, so the six slots differ, and they are JAX's."""
    cfg = dict(num_envs=2, num_agents=6)
    je, te = J.MultiAgentRoundaboutEnv(cfg), T.MultiAgentRoundaboutEnv(cfg, device="cpu")
    te.reset(seed=2)
    tree = state_to_numpy(te._state)
    tree["ego"]["pos"] = tree["ego"]["pos"] + 500.0  # every slot free
    mask = np.ones(12, bool)
    mask[7] = False  # one row of env 1 stays out of the claim
    ours = te._respawn(state_from_numpy(tree, "cpu"), torch.as_tensor(mask))
    ref = je._respawn(jax_tree(JaxSimState, tree), jnp.asarray(mask))
    slots = to_np(ours.ego.slot).reshape(2, 6)
    assert len(set(slots[0])) == 6 and len(set(np.delete(slots[1], 1))) == 5
    np.testing.assert_array_equal(to_np(ours.ego.slot), np.asarray(ref.ego.slot))
    np.testing.assert_allclose(to_np(ours.ego.pos), np.asarray(ref.ego.pos), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(to_np(ours.rng), np.asarray(ref.rng).astype(np.int64))


def test_respawn_needs_a_free_region():
    """With every agent parked on a spawn slot's 8 x 3 m region, a row
    that respawns finds no free slot and stays."""
    cfg = dict(num_envs=1, num_agents=4)
    je, te = J.MultiAgentRoundaboutEnv(cfg), T.MultiAgentRoundaboutEnv(cfg, device="cpu")
    te.reset(seed=0)
    tree = state_to_numpy(te._state)
    mask = np.array([True, False, False, False])
    ours = te._respawn(state_from_numpy(tree, "cpu"), torch.as_tensor(mask))
    ref = je._respawn(jax_tree(JaxSimState, tree), jnp.asarray(mask))
    for k in ("slot", "pos"):
        np.testing.assert_allclose(to_np(getattr(ours.ego, k)), np.asarray(getattr(ref.ego, k)),
                                   rtol=0, atol=1e-5)
    np.testing.assert_array_equal(to_np(ours.step_count), np.asarray(ref.step_count))


def test_traffic_rows_stay_identical():
    je, te, run = get_run("roundabout_traffic")
    N = te.scene.npc_lane.shape[1]
    pos = run["final"][1]["npc"]["pos"].reshape(2, 4, N, 2)
    active = run["final"][1]["npc"]["active"].reshape(2, 4, N)
    for a in range(1, 4):
        np.testing.assert_array_equal(pos[:, a], pos[:, 0])
    assert active[:, 0].any()


# ------------------------------------------------------------------- ops
@pytest.mark.parametrize("respawn", [False, True])
def test_step_npcs_with_extra_bodies_and_no_ego(respawn):
    """IDM stepped per env against the agents of the env (ego=None)."""
    je, te, run = get_run("roundabout_traffic")
    st = run["steps"][20][3]
    tree = state_to_numpy(st)
    rows = lambda x: np.asarray(x).reshape((2, 4) + np.asarray(x).shape[1:])
    npc = {k: (rows(v)[:, 0] if not isinstance(v, dict) else {kk: rows(vv)[:, 0]
                                                              for kk, vv in v.items()})
           for k, v in tree["npc"].items()}
    npc["released"] = np.ones_like(npc["released"])
    sidx = rows(tree["sidx"])[:, 0]
    extra = (rows(tree["ego"]["pos"]), rows(tree["ego"]["speed"]),
             rows(tree["ego"]["params"]["length"]), np.ones((2, 4), bool))
    from metadrive_ped_torch.core.structs import NpcState as TNpc
    from metadrive_ped_tpu.core.structs import NpcState as JNpc
    ours = t_idm.step_npcs(te.scene, t(sidx), state_from_numpy(npc, "cpu", cls=TNpc), None,
                           respawn_mode=respawn, extra_bodies=tuple(t(x) for x in extra))
    ref = jax.jit(j_idm.step_npcs, static_argnames="respawn_mode")(
        je.scene, jnp.asarray(sidx), jax_tree(JNpc, npc), None, respawn_mode=respawn,
        extra_bodies=tuple(jnp.asarray(x) for x in extra))
    ref = np_tree(ref)
    ours = state_to_numpy(ours)
    assert (np.abs(ref["pos"] - npc["pos"]).max()) > 0.01, "the NPCs should move"
    for k in ref:
        if isinstance(ref[k], dict):
            continue
        if ref[k].dtype.kind in "biu":
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
        else:
            np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=2e-5, err_msg=k)


def test_checkpoint_positions():
    je, te, run = get_run("intersection_crash")
    for i in (0, 30, 60):
        st = run["steps"][i][3]
        args = (st.sidx, st.ego.slot, st.ego.route_idx)
        ours = t_loc.checkpoint_positions(te.scene, *args)
        ref = jax.jit(j_loc.checkpoint_positions)(je.scene, *(jnp.asarray(to_np(a)) for a in args))
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=0, atol=2e-5)  # metres
