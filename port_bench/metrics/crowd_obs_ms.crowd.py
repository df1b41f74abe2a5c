"""Host ms per control step in the crowd observation: the program's
`env.group_obs` and `env.velocity_map` spans (neither holds another span)
in the profiled epoch, over its `env.step` spans, rescaled by the
profiler's stretch as `optimizer_ms.train` is. The epoch's first
observation, before its first step, is counted too (33 observations for
32 steps). None where the program has no such span."""
from port_bench import program_spans

SPANS = ("env.group_obs", "env.velocity_map")


def read(rec):
    recs = program_spans._joinable(rec)
    if recs is None or not any(program_spans.count(recs, n) for n in SPANS):
        return None
    return sum(program_spans.span_ms(rec, n, "env.step") or 0.0
               for n in SPANS)
