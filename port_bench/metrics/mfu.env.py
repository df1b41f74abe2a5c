"""The whole epoch's share of the card's float32 peak: the flops that the
window's epochs need (`Driver.flops_per_unit`: the networks' GEMMs forward
and backward, the LHS Gram, the factor and the resolves;
`counts.networks`, `counts.arrow`) over the window's seconds at 67
TFLOP/s."""
from port_bench.counts import peaks


def read(rec):
    if "env_steps" not in rec.work_per_unit or not rec.units:
        return None
    return (100.0 * rec.flops_per_unit * rec.units
            / (rec.window_s * peaks.F32_FLOP_S))
