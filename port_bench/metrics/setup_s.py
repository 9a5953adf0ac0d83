"""Set-up: from the start of the process to the start of the window
(imports, the CUDA context, the kernel library, built at a checkout's
first run, the pool drawn from the seed, the warm-up call)."""


def read(ctx):
    return ctx.setup_s
