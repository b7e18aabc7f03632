"""Host-side manual control (reference: policy/manual_control_policy.py +
engine/core/manual_controller.py).

The reference polls a keyboard, steering wheel or gamepad through Panda3D
or pygame and routes the input to the tracked agent. Here a controller is
a small host object whose ``process_input()`` returns a (steering,
throttle) pair or None (the policy's action stands); the env applies it to
row 0 of the action batch in `step`, on the host, before the step.
``ScriptedController`` gives the same interface for tests and scripted
takeover.

Keyboard control needs pygame and a display. Where either is missing,
``make_controller("keyboard")`` raises; the JAX package quietly returns a
controller that never acts instead (ROADMAP.md queue 3).
"""
import numpy as np


class BaseController:
    def process_input(self):
        """Return [steering, throttle] in [-1, 1] or None."""
        raise NotImplementedError


class ScriptedController(BaseController):
    """Deterministic controller for tests and scripted takeover: feed it a
    callable or a sequence of actions."""

    def __init__(self, source):
        self._source = source
        self._i = 0

    def process_input(self):
        if callable(self._source):
            return self._source()
        if self._i >= len(self._source):
            return None
        a = self._source[self._i]
        self._i += 1
        return a


class KeyboardController(BaseController):
    """pygame arrow-key control (engine/core/manual_controller.py:99-171:
    incremental steering and throttle with decay). Needs a display."""

    STEERING_INCREMENT = 0.04
    STEERING_DECAY = 0.25
    THROTTLE_INCREMENT = 0.1
    THROTTLE_DECAY = 0.2

    def __init__(self):
        import pygame
        pygame.init()
        pygame.display.set_mode((200, 100))
        self._pygame = pygame
        self.steering = 0.0
        self.throttle = 0.0

    def process_input(self):
        pygame = self._pygame
        pygame.event.pump()
        keys = pygame.key.get_pressed()
        if keys[pygame.K_LEFT]:
            self.steering = min(self.steering + self.STEERING_INCREMENT, 1.0)
        elif keys[pygame.K_RIGHT]:
            self.steering = max(self.steering - self.STEERING_INCREMENT, -1.0)
        else:
            self.steering *= 1 - self.STEERING_DECAY
        if keys[pygame.K_UP]:
            self.throttle = min(self.throttle + self.THROTTLE_INCREMENT, 1.0)
        elif keys[pygame.K_DOWN]:
            self.throttle = max(self.throttle - self.THROTTLE_INCREMENT, -1.0)
        else:
            self.throttle *= 1 - self.THROTTLE_DECAY
        return np.array([self.steering, self.throttle], np.float32)


def make_controller(kind):
    """Controller factory (manual_control_policy.py:30-43): a controller, a
    callable or a sequence of actions (scripted), or "keyboard"."""
    if isinstance(kind, BaseController):
        return kind
    if callable(kind) or isinstance(kind, (list, tuple)):
        return ScriptedController(kind)
    if kind == "keyboard":
        try:
            return KeyboardController()
        except ImportError as e:
            raise RuntimeError("keyboard control needs pygame; pass a scripted controller "
                               "(a callable or a list of actions) instead") from e
    raise ValueError(f"No such a controller type: {kind}")
