"""A pure function of tensors captured once as a CUDA graph and replayed.

`Captured(fn, leaves, spec)` follows PyTorch's whole-network capture
recipe. It copies the inputs (`leaves`, the flattened tree `spec`
describes) into static buffers of the same dtypes, shapes and strides,
runs `fn` on them `WARMUPS` times on a side stream (the lazy set-up of
cuBLAS, cuDNN and the autograd engine happens there), then captures one
call with `torch.cuda.graph` in a private memory pool. Calling it copies
new inputs of the same dtypes, shapes and strides into the static buffers
(one `torch._foreach_copy_`), replays the graph on the current stream and
returns clones of the outputs, so no later replay overwrites what a caller
keeps.

`fn` must be a pure function of its tensor inputs on one CUDA device: no
host sync, no copy from pageable host memory, no random draw (a replay
repeats the captured one) and no Python side effect a caller relies on,
since a replay runs only the device's work. The exception is the host
counters in `counters`, dicts of ints that `fn` advances: the warm-up and
the capture count nothing, and each call adds what one call counted
during the capture.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

WARMUPS = 3


class Captured:
    """`fn(*args)` as one CUDA graph on the inputs' dtypes, shapes and
    strides (see the module's head)."""

    def __init__(self, fn, leaves: list, spec, counters: tuple = ()):
        dev = leaves[0].device
        with torch.no_grad():
            self._inputs = [torch.empty_like(x) for x in leaves]
            torch._foreach_copy_(self._inputs, leaves)
        args = tree_unflatten(self._inputs, spec)
        self._counters = counters
        before = [dict(c) for c in counters]
        with torch.cuda.device(dev):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUPS):
                    fn(*args)
            torch.cuda.current_stream().wait_stream(side)
            start = [dict(c) for c in counters]
            self._graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self._graph):
                out = fn(*args)
        self._outputs, self._out_spec = tree_flatten(out)
        self._counts = [{k: c[k] - s[k] for k in c}
                        for c, s in zip(counters, start)]
        for c, b in zip(counters, before):
            c.update(b)

    def __call__(self, leaves: list):
        with torch.no_grad():
            torch._foreach_copy_(self._inputs, leaves)
        self._graph.replay()
        for c, n in zip(self._counters, self._counts):
            for k, v in n.items():
                c[k] += v
        return tree_unflatten([x.clone() for x in self._outputs],
                              self._out_spec)
