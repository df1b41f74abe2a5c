"""Device-idle ms per minibatch while the host is in the agent's optimizer
step (the program's `trainer.optimizer` span) in the profiled epoch: the
span's host time rescaled by the profiler's stretch, less the device's
busy time in it (`program_spans.unprofiled_idle`)."""
from port_bench import program_spans


def read(rec):
    return program_spans.idle_ms(rec, "trainer.optimizer",
                                 "trainer.optimizer")
