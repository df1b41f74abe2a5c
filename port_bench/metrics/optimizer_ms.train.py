"""Host ms per minibatch in the agent's optimizer step (the program's
`trainer.optimizer` span, `AMPAgent._apply_grads`) in the profiled epoch,
rescaled by the profiler's stretch."""
from port_bench import program_spans


def read(rec):
    return program_spans.span_ms(rec, "trainer.optimizer",
                                 "trainer.optimizer")
