"""Seconds from the process's start to the window: imports, CUDA init, the graph, ingest, warm-up."""


def read(ctx):
    return ctx.setup_s
