"""Expert-driven NPC traffic against the JAX package: `MixedTrafficEnv` and
a multi-agent roundabout with rl_agent_ratio = 0.5 step for step, and the
pieces alone on a stepped state: `mixed_traffic.expert_npc_actions` (the
275-dim observation of every NPC slot, its per-NPC lidar and the expert
MLP), the per-NPC lidar's plain version (ops/npc_lidar.py) and
`idm.step_npcs` with expert actions and mask.

Tolerances: the env runs those of tests/_torch_parity.py::check_run
(obs, reward and float info 1e-4, flags and ints exact); the expert's
actions 1e-4 (its observation carries ray-box hit fractions whose float32
rounding differs between the packages by ~1e-7 and the MLP sums in another
order); the NPC state after `step_npcs` 1e-5 and exact lanes and flags."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import check_run, jax_tree, np_tree, run_pair, t, to_np, yaw_column

import metadrive_ped_torch as T
from metadrive_ped_torch.core.convert import state_from_numpy, state_to_numpy
from metadrive_ped_torch.ops import idm as t_idm
from metadrive_ped_torch.ops import mixed_traffic as t_mixed
from metadrive_ped_torch.ops import npc_lidar as t_npc_lidar
from metadrive_ped_torch.ops import raycast as t_raycast
from metadrive_ped_tpu.core.structs import SimState as JaxSimState
from metadrive_ped_tpu.envs.marl_envs import MultiAgentRoundaboutEnv as JaxRoundabout
from metadrive_ped_tpu.envs.mixed_traffic_env import MixedTrafficEnv as JaxMixed
from metadrive_ped_tpu.ops import idm as j_idm
from metadrive_ped_tpu.ops import mixed_traffic as j_mixed
from metadrive_ped_tpu.ops import raycast as j_raycast

ATOL = 1e-4
MIXED = dict(num_envs=4, map="SCS", num_scenarios=2, traffic_density=0.4, rl_agent_ratio=0.5,
             traffic_mode="respawn", horizon=10000)
MARL = dict(num_envs=2, num_agents=4, traffic_density=0.3, rl_agent_ratio=0.5,
            traffic_mode="respawn", vehicle_config=dict(lidar=dict(num_lasers=240)))
STEPS = 30


def _actions(shape, steps, seed=0):
    rng = np.random.RandomState(seed)
    return list(np.clip(rng.normal([0.0, 0.6], [0.2, 0.3], (steps,) + shape + (2,)), -1, 1)
                .astype(np.float32))


@pytest.fixture(scope="module")
def mixed():
    je, te = JaxMixed(MIXED), T.MixedTrafficEnv(MIXED, device="cpu")
    return je, te, run_pair(je, te, _actions((MIXED["num_envs"],), STEPS))


def test_mixed_traffic_env_against_jax(mixed):
    je, te, run = mixed
    assert check_run(run, te, yaw_column({})) == 0


def test_expert_slots_drive(mixed):
    je, te, run = mixed
    em = te._pack["npc_expert"]
    assert em.any() and not em.all(), "a share of the NPC slots is expert-driven"
    final = run["final"][1]
    sel = em[final["sidx"]] & final["npc"]["active"]
    assert sel.any() and final["npc"]["speed"][sel].mean() > 2.0, "the expert slots move"


@pytest.fixture(scope="module")
def stepped(mixed):
    """The JAX state after the run, as (numpy tree, JAX state, port state)."""
    je, te, run = mixed
    tree = run["final"][0]
    return tree, jax_tree(JaxSimState, tree), state_from_numpy(tree, "cpu")


def test_expert_npc_actions_against_jax(mixed, stepped):
    je, te, _ = mixed
    _, js, ts = stepped
    ref = jax.jit(j_mixed.expert_npc_actions)(je.scene, js.sidx, js.npc, js.ego,
                                               je._npc_expert_params)
    ours = t_mixed.expert_npc_actions(te.scene, ts.sidx, ts.npc, ts.ego, te._npc_expert_params)
    assert ours.shape == ref.shape == ts.npc.lane.shape + (2,)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    # the per-NPC lidar sees bodies: the ray fans are not all free
    cloud = t_mixed.npc_lidar(ts.npc, t_mixed.vehicle_candidates(ts.npc, ts.ego), 240, 50.0)
    assert float(cloud.min()) < 0.5


def test_npc_lidar_plain_version_on_the_stepped_state(mixed, stepped, monkeypatch):
    """On CPU tensors `mixed_traffic.npc_lidar` goes through
    ops/npc_lidar.py's plain version. On the stepped state at 240 rays that
    gives bit for bit what the `raycast.lidar_cloud` chain over the
    repeated candidates gives, and the JAX package's per-NPC lidar
    (metadrive_ped_tpu/ops/mixed_traffic.py, the same chain in jnp) within
    ATOL."""
    _, _, ts = stepped
    npc, ego = ts.npc, ts.ego
    E, N = npc.lane.shape
    C = N + 1
    cand = t_mixed.vehicle_candidates(npc, ego)
    calls = []
    plain = t_npc_lidar.npc_lidar_plain
    monkeypatch.setattr(t_npc_lidar, "npc_lidar_plain",
                        lambda *a: calls.append(len(a)) or plain(*a))
    ours = t_mixed.npc_lidar(npc, cand, 240, 50.0)
    assert calls == [8] and ours.shape == (E, N, 240)

    c_pos, c_heading, c_len, c_wid, c_active = cand[:5]
    rep = lambda a: a.repeat_interleave(N, dim=0)
    not_self = ~torch.eye(N, C, dtype=torch.bool)
    chain = t_raycast.lidar_cloud(
        npc.pos.reshape(E * N, 2), npc.heading.reshape(E * N), 240, 50.0,
        rep(c_pos), rep(c_heading), rep(c_len), rep(c_wid), rep(c_active) & not_self.repeat(E, 1),
    ).reshape(E, N, 240)
    assert torch.equal(ours, chain)

    j = [jnp.asarray(to_np(a)) for a in cand[:5]]
    jrep = lambda a: jnp.repeat(a, N, axis=0)
    ref = jax.jit(j_raycast.lidar_cloud, static_argnums=(2, 3))(
        jnp.asarray(to_np(npc.pos)).reshape(E * N, 2),
        jnp.asarray(to_np(npc.heading)).reshape(E * N), 240, 50.0, *map(jrep, j[:4]),
        jrep(j[4]) & jnp.tile(~jnp.eye(N, C, dtype=bool), (E, 1)))
    np.testing.assert_allclose(ours.reshape(E * N, 240).numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    assert float(ours.min()) < 0.5


@pytest.mark.parametrize("respawn", [False, True])
def test_step_npcs_with_experts_against_jax(mixed, stepped, respawn):
    """Random expert actions on the expert slots: they take the expert's
    steering and throttle, make no IDM lane change, and their lane follows
    the body."""
    je, te, _ = mixed
    tree, js, ts = stepped
    E, N = tree["npc"]["lane"].shape
    rng = np.random.RandomState(3)
    acts = rng.uniform(-1, 1, (E, N, 2)).astype(np.float32)
    mask = rng.uniform(size=(E, N)) < 0.5
    ref = jax.jit(j_idm.step_npcs, static_argnames="respawn_mode")(
        je.scene, js.sidx, js.npc, js.ego, respawn_mode=respawn,
        expert_actions=jnp.asarray(acts), expert_mask=jnp.asarray(mask))
    ours = t_idm.step_npcs(te.scene, ts.sidx, ts.npc, ts.ego, respawn_mode=respawn,
                           expert_actions=t(acts), expert_mask=t(mask))
    ref, ours = np_tree(ref), state_to_numpy(ours)
    for k, a in ref.items():
        if isinstance(a, dict):
            continue
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(ours[k], a, err_msg=k)
        else:
            np.testing.assert_allclose(ours[k], a, rtol=0, atol=1e-5, err_msg=k)


def test_marl_roundabout_with_expert_traffic_against_jax():
    """Agent 0 of each env is the expert slots' "ego"; every agent blocks
    the IDM gap search."""
    je, te = JaxRoundabout(MARL), T.MultiAgentRoundaboutEnv(MARL, device="cpu")
    assert te._pack["npc_expert"].any()
    run = run_pair(je, te, _actions((MARL["num_envs"], MARL["num_agents"]), STEPS))
    check_run(run, te, yaw_column(MARL["vehicle_config"]))
    moved = np.abs(run["final"][1]["npc"]["pos"] - to_np(run["steps"][0][3].npc.pos)).max()
    assert moved > 1.0, "the traffic should move"


def test_expert_traffic_needs_the_expert_lidar():
    with pytest.raises(ValueError, match="240"):
        T.MultiAgentRoundaboutEnv(dict(num_envs=1, num_agents=2, traffic_density=0.3,
                                       rl_agent_ratio=0.5), device="cpu")
