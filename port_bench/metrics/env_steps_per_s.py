"""Env-steps of every epoch the window completed over the window's wall
time (from its start to the synchronized end of its last epoch). Host
clock."""


def read(rec):
    n = rec.work_per_unit.get("env_steps")
    return None if n is None else rec.units * n / rec.window_s
