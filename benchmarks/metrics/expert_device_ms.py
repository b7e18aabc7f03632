"""Expert traffic: device ms of one eager `_expert_traffic` (the expert's
observation of every NPC slot, its per-NPC lidar and the MLP) on the
cell's state; nothing where no NPC slot is the expert's."""
from benchmarks import yardstick


def read(trace, env):
    expert = getattr(env, "_expert_traffic", None)
    if expert is None or not env.config.get("rl_agent_ratio"):
        return None
    st = env._state
    return yardstick.device_ms(lambda: expert(st.sidx, st.npc, st.ego), 3)
