"""Seconds an epoch in LocoVal's collection (`LocoValTrainer._collect`): the mean of the
benchmark's synchronized spans around the call over the window's epochs."""


def read(rec):
    d = rec.spans.durations("collect")
    return sum(d) / len(d) if d else None
