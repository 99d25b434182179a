"""Median host ms of one pass's data/wav.load_wav_batch (the harness's
span around it)."""
import statistics


def read(run):
    xs = run.spans.get("decode")
    return statistics.median(xs) * 1e3 if xs else None
