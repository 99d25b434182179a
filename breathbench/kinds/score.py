"""Bulk scoring from files: `predict --from-wav` over a test set written
as PCM16 wav files, pass after pass: data/wav.load_wav_batch (the port's
threaded C++ decoder) then ensemble.Server.

Parameters: clips (files a pass), micro_batch (the Server's clips a
replay), sample (answers the check compares), trace_passes.

Set-up writes the files under TMPDIR (removed at the end) and runs one
whole pass, so the page cache is warm, the decoder built and every host
buffer of the pass's size held. The window runs passes back to back until
--seconds have passed; the rate is every clip scored over the time to the
end of the last pass."""
from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np

from breathbench import check, data, harness, program


def run(run: harness.Run) -> harness.Outcome:
    from tpu_breath_torch import ensemble
    from tpu_breath_torch.data import wav as wav_io

    dev, config = run.device, run.cell.config
    spec = program.feature_spec(config)
    n, micro = run.size("clips"), run.size("micro_batch")
    wavs = data.clips(run.seed, data.labels(run.seed, n, dev)).cpu().numpy()
    tmp = tempfile.mkdtemp(prefix="breathbench-")
    try:
        paths = data.write_wavs(wavs, tmp)
        weights = program.weights(run.seed, config, dev, calibrate=True)
        models = program.models(config, weights, dev)
        for m in models:
            m.eval()
        server = ensemble.Server(models,
                                 [w for _, w in program.members(config)],
                                 spec, dev)
        server(wav_io.load_wav_batch(paths, spec.expected_len), micro)
        harness.sync(dev)

        outs = []
        tracer = run.tracer
        if tracer is not None:  # the profiler is up when the window opens
            tracer.start()
        t0 = time.perf_counter()
        run.counters["setup_s"] = t0 - run.process_start
        failed = 0
        while True:
            try:
                with run.span("decode"):
                    w = wav_io.load_wav_batch(paths, spec.expected_len)
                with run.span("server"):
                    p = server(w, micro)
            except Exception as e:  # a failed pass fails its clips
                run.log(f"[score] pass raised {e!r}")
                p = np.full(n, np.nan)
            outs.append(p)
            if tracer is not None and tracer.prof is not None \
                    and len(outs) >= run.size("trace_passes"):
                tracer.stop()
            end = time.perf_counter()
            if end - t0 >= run.seconds:
                break
        if tracer is not None:
            tracer.stop()
        peak = harness.memory_peak(dev)
        del server, models
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    served = np.stack(outs)
    failed = int((~np.isfinite(served)).sum())
    values = {"score_clips_per_s": served.size / (end - t0),
              "setup_s": run.counters["setup_s"]}
    run.log(f"[score] {len(outs)} passes of {n} clips in {end - t0:.3f} s")

    # a seeded sample of the window's answers, pass and clip
    flat = data.order(run.seed + 2, served.size)[:run.size("sample")]
    passes, clips = np.divmod(flat, n)
    f, s = check.features(config, wavs[clips], dev,
                           run.sizes.get("oracle_workers"))
    ref = check.probs(config, weights, f, s)
    readings = {}
    if run.sizes.get("readings"):  # the control and a planted fault
        readings = {"control_fp8": check.prob_gaps(
            check.probs(config, weights, f, s, "fp8"), ref),
            "answer_flipped": check.prob_gaps(1.0 - served[passes, clips], ref)}
    return harness.Outcome(
        attempted=served.size, failed=failed, values=values,
        numbers=check.prob_gaps(served[passes, clips], ref),
        memory_peak_bytes=peak, readings=readings)
