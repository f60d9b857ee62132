"""Percent of a traced run's window in which the card ran nothing: one
minus the union of device intervals over the traced window."""


def read(ctx):
    s = ctx["trace"]
    return None if s is None else 100.0 * (1.0 - s["busy_s"] / s["window_s"])
