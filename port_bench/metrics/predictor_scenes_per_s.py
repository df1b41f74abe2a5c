"""Scenes of every train step the window completed over the window's wall
time (from its start to the synchronized end of its last step). Host
clock."""


def read(rec):
    n = rec.work_per_unit.get("scenes")
    return None if n is None else rec.units * n / rec.window_s
