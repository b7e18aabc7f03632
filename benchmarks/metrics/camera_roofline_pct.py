"""Camera: the frame's share of its least time on the card, 100 x the
bound of the work a frame must do (benchmarks/camera_work.py, from the
env's state and scene) / the median `camera` span of a replayed step
(camera_replay_ms)."""
from benchmarks import camera_work, program_trace


def read(trace, env):
    ms = program_trace.replay_ms(trace, env, "camera")
    if not ms:
        return None
    return 100.0 * camera_work.frame_bound(env)[0] / ms
