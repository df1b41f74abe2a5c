"""Device ms per minibatch in the conv encoder's convolutions: the
profiled epoch's device operations inside the benchmark's `update` span
(synchronized at both ends by the spans around it, so they are the
update's) whose names are cuDNN's convolution kernels (`KERNELS`: the
forward's `xmma_fprop_implicit_gemm…cudnn` and `convolve_common_engine…`,
`cudnn::detail::dgrad_engine`, `wgrad_alg0_engine…`, and cuDNN's own
layout changes and scalings around them, as the H100's cuDNN names them
under torch 2.11), over the epoch's minibatches."""
import re

KERNELS = re.compile(r"cudnn|convolve|fprop|dgrad|wgrad")


def read(rec):
    p, n = rec.profile, rec.counts.get("minibatches")
    if p is None or not n:
        return None
    upd = [(s, e) for name, s, e in p.spans if name == "update"]
    hits = [d for name, t, d in p.ops if KERNELS.search(name)
            and any(s <= t < e for s, e in upd)]
    return sum(hits) * 1e-6 / n if hits else None
