"""Share of the profiled epoch's minibatch loss-and-gradient calls that
replayed a captured CUDA graph: 100 x the program's `trainer.loss_graph_replay`
spans over its `trainer.loss_and_grads` spans (`AMPAgent._loss_and_grads`),
a count. 0 in a program whose calls all run eagerly; None where the program
recorded no `trainer.loss_and_grads` span."""
from port_bench import program_spans


def read(rec):
    recs = program_spans.records(rec)
    if recs is None:
        return None
    calls = program_spans.count(recs, "trainer.loss_and_grads")
    if not calls:
        return None
    return 100.0 * program_spans.count(
        recs, "trainer.loss_graph_replay") / calls
