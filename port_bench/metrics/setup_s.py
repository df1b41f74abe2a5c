"""Set-up: from the process's start to the window's (imports, CUDA, the
kernels' library from the checkout's cache, the world or the scene bank,
the weights, the first steps). Host clock."""


def read(rec):
    return rec.setup_s
