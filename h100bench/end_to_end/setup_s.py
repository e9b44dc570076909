"""Seconds from the start of the process to the start of the window:
imports, building (and on a first run compiling) the kernels, weights and
data from the seed, the graph or Trainer, and the warm-up."""


def read(run):
    return run.setup_s
