"""setup_s: process start (the first statement of ``run.py``) to the first
timed batch: kernels, index restore (or build), traffic, warm-up."""


def read(ctx):
    return ctx["setup_s"]
