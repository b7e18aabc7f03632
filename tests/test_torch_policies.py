"""The port's agent policies against the JAX package: lidar noise, manual
control, the lane-change policy, the PPO expert, the AI protector and the
curriculum.

Tolerances: observations, rewards and float info 1e-4 (the yaw-rate
feature through cos(0.1 f), tests/_torch_parity.py::obs_gap), flags and
integer state exact; the expert MLP 1e-5 (three float32 products summed in
another order). The AI protector's expert reads the previous observation,
whose yaw-rate feature the two packages compute differently (ROADMAP.md
queue 3, item 1): fed back through the expert, that moves the actions by
up to 4e-4 in a free run. So its runs hand the JAX state and observation
to the port before every step, which holds the protector, the expert and
the step to the tolerances above on the same inputs;
`test_ai_protector_free_run_departs_only_through_yaw` checks that the
free run's departure starts at that feature and nowhere else."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_trees_close, jax_tree, np_tree, obs_gap, to_np, yaw_column

from metadrive_ped_torch import CurriculumWrapper as TorchCurriculum
from metadrive_ped_torch import MetaDriveEnv as TorchEnv
from metadrive_ped_torch.core.convert import state_from_numpy, state_to_numpy
from metadrive_ped_torch.policies import expert as t_expert
from metadrive_ped_torch.policies import manual as t_manual
from metadrive_ped_tpu import MetaDriveEnv as JaxEnv
from metadrive_ped_tpu.core.structs import SimState as JaxState
from metadrive_ped_tpu.envs.curriculum import CurriculumWrapper as JaxCurriculum
from metadrive_ped_tpu.policies import expert as j_expert
from metadrive_ped_tpu.policies import manual as j_manual

ATOL = 1e-4
EXPERT_TOL = 1e-5
STEPS = 20
EXPERT_VC = dict(lidar=dict(num_lasers=240, distance=50.0, num_others=4))


def _check_step(jax_out, torch_out, yaw):
    oj, rj, tj, trj, ij = jax_out
    ot, rt, tt, trt, it = torch_out
    assert obs_gap(oj, ot, yaw) <= ATOL
    np.testing.assert_allclose(to_np(rt), np.asarray(rj), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(to_np(tt), np.asarray(tj))
    np.testing.assert_array_equal(to_np(trt), np.asarray(trj))
    assert set(it) == set(ij)
    for k in ij:
        a, b = np.asarray(ij[k]), to_np(it[k])
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=ATOL, err_msg=k)


# ---- the PPO expert ---------------------------------------------------------

def test_port_asset_has_the_jax_bytes():
    with open(t_expert.VENDORED_WEIGHTS, "rb") as a, open(j_expert._VENDORED, "rb") as b:
        assert a.read() == b.read()


@pytest.fixture(scope="module")
def params():
    return j_expert.load_expert_params(), t_expert.load_expert_params(device="cpu")


def test_params_from_the_checkpoint(params):
    jp, tp = params
    assert set(jp) == set(tp)
    for k in jp:
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


def test_obs_correction_against_jax():
    obs = np.random.RandomState(0).uniform(0, 1, (64, 275)).astype(np.float32)
    x = torch.as_tensor(obs)
    ours = t_expert.obs_correction(x)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(j_expert.obs_correction(jnp.asarray(obs))))
    np.testing.assert_array_equal(x.numpy(), obs)  # the input is not changed


@pytest.mark.parametrize("deterministic", [True, False])
def test_expert_action_against_jax(params, deterministic):
    jp, tp = params
    obs = np.random.RandomState(1).uniform(0, 1, (512, 275)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = j_expert.expert_action(jp, jnp.asarray(obs), rng=key, deterministic=deterministic)
    ours = t_expert.expert_action(tp, torch.as_tensor(obs), rng=torch.as_tensor(
        np.asarray(key).astype(np.int64)), deterministic=deterministic)
    assert ours.shape == (512, 2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=EXPERT_TOL)


def test_make_expert_policy_against_jax():
    """The rollout policy of the vendored checkpoint: the expert's mean."""
    obs = np.random.RandomState(2).uniform(0, 1, (32, 275)).astype(np.float32)
    ref = j_expert.make_expert_policy()(jnp.asarray(obs), None)
    ours = t_expert.make_expert_policy(device="cpu")(torch.as_tensor(obs), None)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=EXPERT_TOL)


def test_torch_expert_weights_against_jax():
    from metadrive_ped_torch.policies.expert_torch import load_torch_expert_weights as ours
    from metadrive_ped_tpu.policies.expert_torch import load_torch_expert_weights as ref
    a, b = ref(), ours(device="cpu")
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(b[k].numpy(), a[k].numpy(), err_msg=k)


@pytest.mark.parametrize("deterministic", [True, False])
def test_torch_expert_action_against_jax(deterministic):
    """Both packages' torch entry point to the expert on the same obs. The
    stochastic case draws from torch's global generator in both, seeded
    alike before each call."""
    from metadrive_ped_torch.policies.expert_torch import torch_expert_action as ours
    from metadrive_ped_tpu.policies.expert_torch import torch_expert_action as ref
    obs = np.random.RandomState(3).uniform(0, 1, (64, 275)).astype(np.float32)
    torch.manual_seed(7)
    a = ref(obs, deterministic=deterministic)
    torch.manual_seed(7)
    b = ours(obs, deterministic=deterministic, device="cpu")
    assert b.shape == (64, 2)
    np.testing.assert_allclose(b, a, rtol=0, atol=EXPERT_TOL)


def test_missing_checkpoint(tmp_path):
    missing = str(tmp_path / "none.npz")
    with pytest.raises(FileNotFoundError):
        t_expert.load_expert_params(missing, device="cpu")
    zero = t_expert.load_expert_params(missing, allow_zero_init=True, device="cpu")
    obs = torch.rand(3, 275)
    assert float(zero["w1"].abs().sum()) == 0
    assert float(t_expert.expert_action(zero, obs).abs().max()) == 0


# ---- lidar noise and manual control ------------------------------------------

# the first 12 steps drive row 0 by the script; the policy's actions after
SCRIPT = [np.array([0.3 - 0.05 * i, 1.0], np.float32) for i in range(12)]
NOISE = dict(num_envs=6, map="SC", num_scenarios=2, traffic_density=0.2,
             vehicle_config=dict(lidar=dict(gaussian_noise=0.05, dropout_prob=0.1)),
             manual_control=True, controller=SCRIPT)


def _actions(seed, steps, E):
    rng = np.random.RandomState(seed)
    return np.clip(rng.normal([0.0, 0.6], [0.3, 0.4], (steps, E, 2)), -1, 1).astype(np.float32)


@pytest.fixture(scope="module")
def noise_run():
    je, te = JaxEnv(NOISE), TorchEnv(NOISE, device="cpu")
    je.reset(seed=0)
    te.reset(seed=0)
    out = dict(steps=[], states=[], envs=(je, te))
    for a in _actions(0, STEPS, NOISE["num_envs"]):
        out["steps"].append((je.step(a), te.step(a)))
        out["states"].append(np_tree(je._state))
    return out


def test_noise_and_manual_run_against_jax(noise_run):
    yaw = yaw_column(NOISE["vehicle_config"])
    for jax_out, torch_out in noise_run["steps"]:
        _check_step(jax_out, torch_out, yaw)
    cloud = to_np(noise_run["steps"][-1][1][0])[:, -240:]
    assert 0.05 < (cloud == 0).mean() < 0.15, "dropout_prob=0.1 zeroes about a tenth of the rays"


@pytest.mark.parametrize("noise", [dict(gaussian_noise=0.05, dropout_prob=0.0),
                                   dict(gaussian_noise=0.0, dropout_prob=0.1)],
                         ids=["gaussian", "dropout"])
def test_noise_alone_against_jax(noise_run, noise):
    """The observation of each of the run's states with one of the two noise
    passes on: both packages draw from fold_in(PRNGKey(0), sum(step_count))."""
    je, te = noise_run["envs"]
    lidar = (je.config["vehicle_config"]["lidar"], te.config["vehicle_config"]["lidar"])
    saved = [{k: d[k] for k in noise} for d in lidar]

    def configure(values):
        for d, v in zip(lidar, values):
            for k in noise:
                d[k] = v[k]
    try:
        configure([noise, noise])
        observe = jax.jit(je._observe)
        E = NOISE["num_envs"]
        yaw = yaw_column(NOISE["vehicle_config"])
        clouds = []
        for tree in noise_run["states"]:
            oj = observe(jax_tree(JaxState, tree), jnp.zeros(E), jnp.zeros(E))
            ot = te._observe(state_from_numpy(tree, "cpu"), torch.zeros(E), torch.zeros(E))
            assert obs_gap(oj, ot, yaw) <= ATOL
            clouds.append(to_np(ot)[:, -240:])
        clouds = np.stack(clouds)
        if noise["gaussian_noise"] > 0:
            # a free ray (1.0) stays at 1.0 only when its noise is >= 0
            assert 0.3 < (clouds == 1.0).mean() < 0.6, "the noise moves the free rays"
        else:
            assert 0.05 < (clouds == 0.0).mean() < 0.15, "dropout zeroes about a tenth"
    finally:
        configure(saved)


def test_manual_controller_drives_row_0(noise_run):
    """The scripted controller's action replaces row 0's in both packages
    while the script lasts; then the policy's action stands."""
    acts = _actions(0, STEPS, NOISE["num_envs"])
    for i, (_, torch_out) in enumerate(noise_run["steps"]):
        row0 = to_np(torch_out[4]["steering"])[0], to_np(torch_out[4]["acceleration"])[0]
        want = SCRIPT[i] if i < len(SCRIPT) else acts[i, 0]
        np.testing.assert_allclose(row0, want, atol=1e-7)
        np.testing.assert_allclose(to_np(torch_out[4]["steering"])[1:], acts[i, 1:, 0], atol=1e-7)


def test_keyboard_controller_raises_without_pygame(monkeypatch):
    """A deliberate difference (ROADMAP.md queue 3): the JAX package quietly
    drives nothing where pygame or a display is missing; the port raises."""
    monkeypatch.setitem(sys.modules, "pygame", None)
    with pytest.raises(RuntimeError, match="pygame"):
        t_manual.make_controller("keyboard")
    assert j_manual.make_controller("keyboard").process_input() is None
    with pytest.raises(ValueError):
        t_manual.make_controller("wheel")


# ---- the lane-change policy ----------------------------------------------

LANE = dict(num_envs=4, map="SS", num_scenarios=1, traffic_density=0.0,
            agent_policy="lane_change", discrete_action=True, use_multi_discrete=True)


def _lane_idx(env, state):
    return env._pack["lane_idx_in_road"][state["sidx"], state["ego"]["lane"]]


def test_lane_change_against_jax():
    """Keep the lane, then right, then left (steering bins 1, 0, 2), as
    tests/test_agent_policies.py drives the JAX package."""
    je, te = JaxEnv(LANE), TorchEnv(LANE, device="cpu")
    assert te.config["discrete_steering_dim"] == 3
    je.reset(seed=0)
    te.reset(seed=0)
    lanes = [_lane_idx(te, state_to_numpy(te._state))]
    for steer, n in ((1, 5), (0, 30), (2, 30)):
        for _ in range(n):
            a = np.tile([steer, 3], (4, 1))
            _check_step(je.step(a), te.step(a), yaw_column({}))
        lanes.append(_lane_idx(te, state_to_numpy(te._state)))
    keep, right, left = lanes[1:]
    assert (keep == lanes[0]).all() and (right > keep).all() and (left < right).all()
    assert_trees_close(np_tree(je._state), state_to_numpy(te._state), atol=ATOL)


def test_lane_change_requires_discrete_action():
    cfg = dict(num_envs=1, map="S", traffic_density=0.0, agent_policy="lane_change")
    with pytest.raises(AssertionError, match="discrete_action"):
        JaxEnv(cfg)
    with pytest.raises(AssertionError, match="discrete_action"):
        TorchEnv(cfg, device="cpu")


# ---- the AI protector ------------------------------------------------------

PROTECT = dict(num_envs=4, map="CC", num_scenarios=1, start_seed=2, traffic_density=0.1,
               use_AI_protector=True, vehicle_config=EXPERT_VC)
TAKEOVER_KEYS = ("takeover", "takeover_start", "takeover_end")


def _protect_actions(steps):
    """Rows 0-1 steer hard left at full throttle; rows 2-3 drive randomly."""
    acts = _actions(2, steps, 4)
    acts[:, :2] = (1.0, 1.0)
    return acts


@pytest.fixture(scope="module")
def protect_envs():
    """(JAX env, port env) of PROTECT at a save level, built once each."""
    built = {}

    def get(save_level):
        if save_level not in built:
            cfg = dict(PROTECT, save_level=save_level)
            built[save_level] = JaxEnv(cfg), TorchEnv(cfg, device="cpu")
        return built[save_level]
    return get


@pytest.mark.parametrize("save_level", [0.95, 0.5, 0.0])
def test_ai_protector_through_step(protect_envs, save_level):
    je, te = protect_envs(save_level)
    je.reset(seed=0)
    te.reset(seed=0)
    yaw = yaw_column(EXPERT_VC)
    counts = dict.fromkeys(TAKEOVER_KEYS, 0)
    for a in _protect_actions(STEPS):
        # the JAX state and previous observation, handed over
        te._state = state_from_numpy(np_tree(je._state), "cpu")
        te._last_obs = torch.as_tensor(np.array(je._last_obs))
        jout, tout = je.step(a), te.step(a)
        _check_step(jout, tout, yaw)
        for k in TAKEOVER_KEYS:
            counts[k] += int(np.asarray(jout[4][k]).sum())
        np.testing.assert_array_equal(to_np(te._state.policy_state[:, 3]),
                                      np.asarray(je._state.policy_state[:, 3]))
    if save_level > 0:
        assert counts["takeover"] > 0 and counts["takeover_start"] > 0
    else:
        assert sum(counts.values()) == 0


def test_ai_protector_free_run_departs_only_through_yaw(params, protect_envs):
    """Without the hand-over, the two packages' previous observations first
    differ beyond 1e-4 only in the yaw-rate column (ROADMAP.md queue 3,
    item 1), and the expert on the same observation agrees to 1e-5: the
    departure comes from that feature, not from the protector."""
    jp, tp = params
    je, te = protect_envs(0.95)
    je.reset(seed=0)
    te.reset(seed=0)
    yaw = yaw_column(EXPERT_VC)
    cols = np.arange(te.observation_dim) != yaw
    departed = False
    for a in _protect_actions(STEPS):
        pj, pt = np.asarray(je._last_obs), to_np(te._last_obs)
        gap = np.abs(pj - pt)
        if gap.max() > ATOL:
            departed = True
            assert gap[:, cols].max() <= ATOL, "the first departure is in the yaw-rate column"
            break
        np.testing.assert_allclose(
            t_expert.expert_action(tp, torch.as_tensor(pj.copy())).numpy(),
            np.asarray(j_expert.expert_action(jp, jnp.asarray(pj))), rtol=0, atol=EXPERT_TOL)
        je.step(a)
        te.step(a)
    assert departed, "the yaw-rate difference should reach the expert in this run"


# ---- the curriculum ----------------------------------------------------------

class _State:
    def __init__(self, scenario_cap):
        self.scenario_cap = scenario_cap

    def replace(self, scenario_cap):
        return _State(scenario_cap)


class _OutcomeEnv:
    """Stands in for a vector env: each step returns the next of the given
    (terminated, arrive_dest) outcomes, as numpy (JAX side) or tensors."""

    def __init__(self, outcomes, total, as_array, full):
        self.num_scenarios = total
        self._outcomes = iter(outcomes)
        self._as_array = as_array
        self._state = _State(full(total))
        self._reset_impl = lambda rng: None

    def reset(self, seed=0):
        return None, {}

    def step(self, actions):
        term, arrive = (self._as_array(x) for x in next(self._outcomes))
        return None, None, term, term & False, dict(arrive_dest=arrive)


def test_curriculum_against_jax():
    """The same episode outcomes on both sides: the same levels, bands, live
    scenario caps and success rates after every step."""
    rng = np.random.RandomState(0)
    E, total, steps = 8, 16, 60
    outcomes = [(rng.uniform(size=E) < 0.3, rng.uniform(size=E) < 0.9) for _ in range(steps)]
    jw = JaxCurriculum(_OutcomeEnv(outcomes, total, jnp.asarray,
                                   lambda c: jnp.full((E,), c, jnp.int32)), curriculum_level=4)
    tw = TorchCurriculum(_OutcomeEnv(outcomes, total, torch.as_tensor,
                                     lambda c: torch.full((E,), c, dtype=torch.int32)),
                         curriculum_level=4)
    jw.reset(seed=0)
    tw.reset(seed=0)
    assert tw.env.num_scenarios == jw.env.num_scenarios == 4
    levels = set()
    for _ in range(steps):
        jw.step(None)
        tw.step(None)
        assert tw.level == jw.level
        assert tw.env.num_scenarios == jw.env.num_scenarios
        np.testing.assert_array_equal(tw.env._state.scenario_cap.numpy(),
                                      np.asarray(jw.env._state.scenario_cap))
        assert tw.current_success_rate == jw.current_success_rate
        levels.add(tw.level)
    assert levels == {0, 1, 2, 3}, "the outcomes should climb every level"


def test_curriculum_narrows_the_port_env():
    """Reset samples from the narrowed band, and a level-up widens the live
    state's cap, which the auto-reset reads."""
    env = TorchCurriculum(TorchEnv(dict(num_envs=16, map="S", num_scenarios=4, traffic_density=0.0),
                                   device="cpu"), curriculum_level=2)
    _, info = env.reset(seed=0)
    assert env.env.num_scenarios == 2 and int(info["env_seed"].max()) < 2
    env.level_up()
    assert env.env.num_scenarios == 4
    assert (env.env._state.scenario_cap == 4).all()
    _, info = env.reset(seed=1)
    assert int(info["env_seed"].max()) >= 2
