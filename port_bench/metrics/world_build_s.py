"""The world and the agent built through the entry (`cli.run._agent`:
`_build_world`, agent init): the benchmark's span around the call."""


def read(rec):
    d = rec.spans.durations("world_build")
    return d[0] if d else None
