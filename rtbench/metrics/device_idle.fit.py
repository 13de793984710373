"""``device_idle.fit``: the share of the traced stretch of train steps in
which nothing ran on the device (kernels, copies, fills), 100 × (1 −
busy / length).  Moves ``fit_steps_per_s``."""


def read(ctx):
    p = ctx.profile
    if not p.busy_s or not p.window_s:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
