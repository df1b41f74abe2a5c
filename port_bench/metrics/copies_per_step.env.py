"""Host-device copies per control step: the profiled epoch's device
operations named `Memcpy HtoD` or `Memcpy DtoH` that start inside a
program `env.step` span, over the `env.step` spans. A count, not
rescaled."""
from port_bench import program_spans


def read(rec):
    return program_spans.copies_per_step(rec)
