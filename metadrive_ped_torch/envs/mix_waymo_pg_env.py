"""MixWaymoPGEnv: alternate real-scenario and PG episodes in one env.

Reference: metadrive/envs/legacy_envs/mix_waymo_pg_env.py:63-199, a
ScenarioEnv whose reset() flips between the scenario managers (Waymo replay)
and the PG managers with probability ``real_data_ratio`` =
num_scenarios / (num_scenarios + num_scenarios) = 0.5 (change_suite,
:120-134), giving the PG episodes a random initial speed randint(10) m/s
(:168). The reference class is dead code (its class body raises
DeprecationWarning on import), so this implements the documented semantics.

Both families keep their own scene and state (their state structs differ),
so the switch happens per reset() call: all rows run the same family for
one reset cycle, as the reference swaps manager sets for the whole engine.
Both children live on the one ``device`` passed in. The suite flips and the
initial speeds come from ``np.random.RandomState(0)`` on the host, as in the
JAX package, so both packages visit the same suite sequence.
"""
import numpy as np
import torch

from metadrive_ped_torch.core.device import resolve_device
from metadrive_ped_torch.envs.metadrive_env import MetaDriveEnv
from metadrive_ped_torch.envs.scenario_env import ScenarioEnv


class MixWaymoPGEnv:
    PG_KEYS = (
        "traffic_density", "traffic_mode", "map", "map_config", "start_seed",
        "accident_prob",
    )
    SCENARIO_KEYS = (
        "scenario_data", "data_directory", "start_scenario_index",
        "reactive_traffic", "no_traffic", "sequential_seed",
    )

    def __init__(self, config=None, device=None):
        self.device = resolve_device(device)
        cfg = dict(config or {})
        num_envs = cfg.pop("num_envs", 16)
        num_scenarios = cfg.pop("num_scenarios", None)
        block_num = cfg.pop("block_num", 1)  # PG map size (reference :42)
        shared = {k: v for k, v in cfg.items() if k not in self.PG_KEYS + self.SCENARIO_KEYS}
        sc_cfg = dict(shared, num_envs=num_envs,
                      **{k: cfg[k] for k in self.SCENARIO_KEYS if k in cfg})
        pg_cfg = dict(shared, num_envs=num_envs, **{k: cfg[k] for k in self.PG_KEYS if k in cfg})
        # PG defaults of the reference config (mix_waymo_pg_env.py:33-47)
        pg_cfg.setdefault("traffic_density", 0.2)
        pg_cfg.setdefault("traffic_mode", "hybrid")
        pg_cfg.setdefault("map", block_num)
        self.scenario_env = ScenarioEnv(sc_cfg, device=self.device)
        self.pg_env = MetaDriveEnv(pg_cfg, device=self.device)
        if num_scenarios is None:
            num_scenarios = self.scenario_env.num_scenarios
        # real : PG = num_scenarios : num_scenarios (reference :92-94)
        self.total_environment = 2 * num_scenarios
        self.real_data_ratio = num_scenarios / self.total_environment
        self.is_current_real_data = True
        self._rng = np.random.RandomState(0)
        self._active = self.scenario_env

    # ---- suite switching (change_suite, reference :120-134) ---------------
    def _change_suite(self):
        if self._rng.rand() < self.real_data_ratio:
            self._active = self.scenario_env
            self.is_current_real_data = True
        else:
            self._active = self.pg_env
            self.is_current_real_data = False

    def reset(self, seed=0):
        self._change_suite()
        obs, info = self._active.reset(seed)
        if not self.is_current_real_data:
            # PG episodes start with a random initial speed in [0, 10) m/s
            # (reference reset tail, :166-168)
            st = self.pg_env._state
            speed = self._rng.randint(0, 10, size=tuple(st.ego.speed.shape)).astype(np.float32)
            self.pg_env._state = st.replace(
                ego=st.ego.replace(speed=torch.from_numpy(speed).to(self.device)))
        return obs, info

    def step(self, actions):
        return self._active.step(actions)

    @property
    def observation_dim(self):
        return self._active.observation_dim

    @property
    def num_envs(self):
        return self._active.num_envs

    def close(self):
        self.scenario_env.close()
        self.pg_env.close()

    def __getattr__(self, name):
        return getattr(self._active, name)
