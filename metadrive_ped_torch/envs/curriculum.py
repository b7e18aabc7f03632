"""Curriculum over scenario difficulty levels.

Port of ScenarioCurriculumManager (manager/scenario_curriculum_manager.py:
38-84): the scenario set splits into `curriculum_level` contiguous bands;
episodes sample only from the bands up to the current level; when the
recent success rate over an evaluation window reaches target_success_rate,
the level goes up.

Episode outcomes arrive in batches from the env's info dicts, so the
wrapper reads the terminated / arrive masks on the host after each `step`
(one host sync a step, the wrapper's own) and narrows the env's scenario
band: `reset` samples from ``env.num_scenarios``, and the auto-reset inside
the step from the live state's ``scenario_cap``.
"""
from collections import deque

import torch

from metadrive_ped_torch.core.logger import get_logger


class CurriculumWrapper:
    """Wraps a vector env (ScenarioEnv or MetaDriveEnv).

        env = CurriculumWrapper(MetaDriveEnv(cfg, device="cuda"), curriculum_level=4)
        obs, info = env.reset(seed=0)
        obs, r, term, trunc, info = env.step(actions)   # levels up on its own
    """

    def __init__(self, env, curriculum_level=2, target_success_rate=0.8,
                 episodes_to_evaluate=None):
        if curriculum_level < 1:
            raise ValueError("curriculum_level must be at least 1")
        self.env = env
        self.num_levels = curriculum_level
        self.target_success_rate = target_success_rate
        total = env.num_scenarios
        if total % curriculum_level:
            raise ValueError("Each level should have the same number of scenarios")
        self.band = total // curriculum_level
        self._episodes_to_eval = episodes_to_evaluate or self.band
        self.level = 0
        self._recent = deque(maxlen=self._episodes_to_eval)

    def _apply_level(self):
        """Restrict scenario sampling to [0, (level + 1) * band)."""
        self.env.num_scenarios = self.band * (self.level + 1)

    @property
    def current_success_rate(self):
        if not self._recent:
            return 0.0
        return float(sum(self._recent)) / self._episodes_to_eval

    def reset(self, seed=0):
        self._apply_level()
        return self.env.reset(seed)

    def step(self, actions):
        obs, r, term, trunc, info = self.env.step(actions)
        done = term | trunc
        if bool(done.any()):
            self._recent.extend(info["arrive_dest"][done].tolist())
            if (self.current_success_rate >= self.target_success_rate - 1e-3
                    and self.level < self.num_levels - 1):
                self.level_up()
        return obs, r, term, trunc, info

    def level_up(self):
        """Widen the sampling band: a swap of ``scenario_cap`` on the live
        state, which the auto-reset reads."""
        self.level += 1
        get_logger().info("curriculum level %d/%d: scenario band -> %d",
                          self.level, self.num_levels, self.band * (self.level + 1))
        self._recent = deque(maxlen=self._episodes_to_eval)
        self._apply_level()
        state = getattr(self.env, "_state", None)
        if state is not None:
            cap = torch.full_like(state.scenario_cap, self.band * (self.level + 1))
            self.env._state = state.replace(scenario_cap=cap)

    def __getattr__(self, name):
        return getattr(self.env, name)
