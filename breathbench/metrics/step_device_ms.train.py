"""Median device ms of one of fit's steps in the traced part (device span
fit.step.device: CUDA events around the step's launch, read after the
epoch's wait); a fused step includes its features."""
from breathbench import records


def read(run):
    return records.device_ms(run, "fit.step.device")
