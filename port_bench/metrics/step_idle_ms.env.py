"""Device-idle ms per control step while the host's innermost program span
is one of the step's layers (`policy.*`, `env.*`, `physics.*`) in the
profiled epoch, over its `env.step` spans: the time those spans are
innermost on the host (`program_spans.by_span`), rescaled by the
profiler's stretch, less the device's busy time then
(`program_spans.unprofiled_idle`)."""
from port_bench import program_spans


def read(rec):
    return program_spans.step_idle_ms(rec)
