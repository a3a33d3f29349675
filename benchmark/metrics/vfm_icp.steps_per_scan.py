"""VFM-ICP's steps per scan over the window: phase 1's steps of the lane
loop plus phase 2's kernel B2 step calls, as the program counts them
(`VFMLanes.loop`: `vfm_steps`, `step_calls`)."""


def read(ctx):
    c = ctx["counters"]
    if "vfm_steps" not in c or not ctx["attempted"]:
        return None
    return (c["vfm_steps"] + c.get("step_calls", 0)) / ctx["attempted"]
