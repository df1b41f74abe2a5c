"""Host ms per train step in the predictor's optimizer step (the program's
`predictor.optimizer` span: the all-reduce and `tx.update`) over the
profiled steps' `predictor.step` spans, rescaled by the profiler's
stretch."""
from port_bench import program_spans


def read(rec):
    return program_spans.span_ms(rec, "predictor.optimizer",
                                 "predictor.step")
