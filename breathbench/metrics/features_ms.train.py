"""ms the feature graph takes for one batch at the fused step's geometry:
the batch's chunks through the chunk graph (extract_features_compiled),
timed by CUDA events after the window on the cell's own clips."""


def read(run):
    return run.counters.get("features_ms")
