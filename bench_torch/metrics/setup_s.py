"""Seconds from the process's start to the first timed work: imports, the
CUDA context, the kernel library's load (its build, in a checkout's first
run), the weights, the traffic and the warm-up of every shape."""


def read(w):
    return w.setup_s
