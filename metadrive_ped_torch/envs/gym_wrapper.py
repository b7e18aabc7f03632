"""Legacy-gym adapter (reference: metadrive/envs/gym_wrapper.py:36-143).

Wraps a gymnasium-style vector env class into the old gym API: reset()
returns the obs only, and step() returns (obs, reward, done, info) with
done = terminated | truncated (bool tensors on the env's device).
"""


def createGymWrapper(inner_class):
    class GymEnvWrapper:
        @classmethod
        def default_config(cls):
            return inner_class.default_config()

        def __init__(self, config=None, device=None):
            self._inner = inner_class(config, device=device)

        def reset(self, seed=None, options=None):
            obs, _info = self._inner.reset(seed=0 if seed is None else seed)
            return obs

        def step(self, actions):
            obs, reward, terminated, truncated, info = self._inner.step(actions)
            return obs, reward, terminated | truncated, info

        def close(self):
            return self._inner.close()

        def __getattr__(self, name):
            return getattr(self._inner, name)

    GymEnvWrapper.__name__ = f"Gym{inner_class.__name__}"
    return GymEnvWrapper
