"""Device, in a Gymnasium-style loop: the share of the measured window in
which the env's `step` had no work on the card, 100 x (1 - the device
spans of the `step` calls / the window's device span), all from CUDA events
of that window: one at each end, one just before and one just after each
`step` call (its action copy, the replay and the output clones). What lies
outside the spans is the actor, the host read and the loop's own host
time; a gap inside a call counts as busy. Nothing where the loop timed no
`step` calls."""


def read(trace, env):
    m = trace.measured or {}
    if not m.get("step_device_s"):
        return None
    return 100.0 * (1.0 - m["step_device_s"] / m["window_device_s"])
