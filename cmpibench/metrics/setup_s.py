"""Seconds from the start of the run to the first timed operation:
building the program, starting the ranks, weights, warm-up."""


def read(run):
    return run["setup_s"]
