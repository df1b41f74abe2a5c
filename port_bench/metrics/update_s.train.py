"""Seconds an epoch in the trainer's update (`AMPAgent.update`): the mean of the
benchmark's synchronized spans around the call over the window's epochs."""


def read(rec):
    d = rec.spans.durations("update")
    return sum(d) / len(d) if d else None
