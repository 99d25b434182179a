"""ms of one replay of the cached step program (loop.TrainStep) at the
cell's batch, timed by CUDA events after the window."""


def read(run):
    return run.counters.get("step_ms")
