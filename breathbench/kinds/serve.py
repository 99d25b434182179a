"""Serving traffic: an open loop of single-clip requests, as from many
stethoscopes each sending one-second clips, served by one worker through
ensemble.Server, as `predict --from-wav` serves.

Parameters: rate_per_s (requests a second, fixed), burst (requests an
arrival brings at once; 1 is Poisson), pool_clips (distinct clips the
requests draw from), micro_batch (the Server's clips a replay),
warm_batches (request counts warmed in set-up: the host's pinned buffers
of each size), sample (requests the check compares), trace_seconds. The
process keeps torch's default intra-op threads, as `predict` does.

Arrivals: the gaps between arrivals are one fixed set of exponential draws
(mean burst / rate), put in a seeded order, so every seed offers the same
work in another order; requests arrive in [0, --seconds). The worker takes
every request due when it comes free and serves them in one Server call;
when none is due it sleeps until the next. A request's latency runs from
its due time to its probability on the host. Requests still queued at the
close are served after it (a late answer is late, not wrong), for at most
LATE_S more seconds; one never answered, one whose call raised and one
with a non-finite probability count as failed."""
from __future__ import annotations

import bisect
import math
import time

import numpy as np
import torch

from breathbench import check, data, harness, program

LATE_S = 60.0
SCHEDULE_SEED = 0  # the one set of gaps every seed reorders


def arrivals(seed: int, rate: float, seconds: float, burst: int
             ) -> np.ndarray:
    """Due times in [0, seconds) of the requests, sorted."""
    n_events = math.ceil(rate / burst * seconds * 1.5) + 16
    gaps = np.random.default_rng(SCHEDULE_SEED).exponential(burst / rate,
                                                            n_events)
    t = np.cumsum(gaps[data.order(seed, n_events)])
    t = t[t < seconds]
    return np.repeat(t, burst)


def _wait_until(t0: float, due: float) -> float:
    """Sleep, then spin, until perf_counter() - t0 >= due; returns how late
    the worker woke."""
    while True:
        left = due - (time.perf_counter() - t0)
        if left <= 0:
            return -left
        if left > 2e-3:
            time.sleep(left - 1e-3)


def _witnesses(run, config, weights, spec, wavs, served, ref) -> dict:
    """For the look at the widest gap of a run: that clip's served
    probability, the reference's, and the port's own on it by two other
    paths: eagerly on the card, and on the host's CPU; and where the two
    paths' features of the clip differ most (each channel's and scalar's
    largest gap over its largest magnitude on the CPU)."""
    from tpu_breath_torch import ensemble, graphs
    from tpu_breath_torch.features import extract_features

    i = int(np.argmax(np.abs(served - ref)))
    out = {"sample_index": i, "served": float(served[i]),
           "reference": float(ref[i])}
    blend = [w for _, w in program.members(config)]
    feats = {}
    for name, dev in (("eager", run.device), ("cpu", torch.device("cpu"))):
        models = program.models(config, weights, dev)
        for m in models:
            m.eval()
        y = torch.from_numpy(np.ascontiguousarray(wavs[i:i + 1])).to(dev)
        with graphs.eager(), torch.no_grad():
            out[name] = float(ensemble.Server(models, blend, spec, dev)(
                wavs[i:i + 1], 1)[0])
            feats[name] = [t.double().cpu()[0]
                           for t in extract_features(y, spec)]
    (fc, sc), (fg, sg) = feats["cpu"], feats["eager"]
    chan = ((fg - fc).abs().amax(dim=(1, 2))
            / fc.abs().amax(dim=(1, 2)).clamp(min=1e-30))
    scal = (sg - sc).abs() / sc.abs().clamp(min=1e-30)
    out["channel_gaps"] = dict(zip(spec.npz_keys, chan.tolist()))
    out["scalar_gaps"] = [[int(j), float(scal[j]), float(sc[j]), float(sg[j])]
                          for j in scal.argsort(descending=True)[:4]]
    return out


def run(run: harness.Run) -> harness.Outcome:
    if run.sizes.get("body") != "float32":
        return _serve(run, run.cell.config)
    config = run.cell.config  # the look: --f32's numerics, TF32 off
    with harness.full_f32():
        return _serve(run, dict(config, precision=dict(config["precision"],
                                                       body="float32")))


def _serve(run: harness.Run, config: dict) -> harness.Outcome:
    from tpu_breath_torch import ensemble

    dev = run.device
    spec = program.feature_spec(config)
    n_pool, micro = run.size("pool_clips"), run.size("micro_batch")
    pool = data.clips(run.seed, data.labels(run.seed, n_pool, dev)
                      ).cpu().numpy()
    weights = program.weights(run.seed, config, dev, calibrate=True)
    models = program.models(config, weights, dev)
    for m in models:
        m.eval()
    server = ensemble.Server(models, [w for _, w in program.members(config)],
                             spec, dev)
    due = arrivals(run.seed, run.size("rate_per_s"), run.seconds,
                   run.size("burst"))
    clip_of = data.order(run.seed + 1, len(due)) % n_pool
    for nb in run.size("warm_batches"):
        server(pool[:nb], micro)
    harness.sync(dev)

    n = len(due)
    lat = np.full(n, np.nan)
    served = np.full(n, np.nan)
    failed, late, sizes = 0, [], []
    tracer = run.tracer
    if tracer is not None:  # the profiler is up when the window opens
        tracer.start()
    t0 = time.perf_counter()
    run.counters["setup_s"] = t0 - run.process_start
    i = 0
    while i < n:
        now = time.perf_counter() - t0
        if tracer is not None and tracer.prof is not None \
                and now >= run.size("trace_seconds"):
            # the calls the per-layer metrics read: the stop's own stall
            # leaves a backlog behind it
            run.counters["traced_calls"] = len(run.spans.get("server_call",
                                                             []))
            tracer.stop()
            continue
        if now > run.seconds + LATE_S:
            break
        if due[i] > now:
            late.append(_wait_until(t0, due[i]))
            continue
        j = bisect.bisect_right(due, now, lo=i + 1)
        try:
            with run.span("server_call"):
                p = server(pool[clip_of[i:j]], micro)
        except Exception as e:  # a failed call fails its requests
            run.log(f"[serve] call of {j - i} requests raised {e!r}")
            p = np.full(j - i, np.nan)
        lat[i:j] = time.perf_counter() - t0 - due[i:j]
        served[i:j] = p
        sizes.append(j - i)
        i = j
    if tracer is not None and tracer.prof is not None:
        run.counters["traced_calls"] = len(run.spans.get("server_call", []))
        tracer.stop()
    peak = harness.memory_peak(dev)
    ok = np.isfinite(served)
    failed = int(n - ok.sum())
    done = lat[ok]
    calls = run.spans.get("server_call", [])
    run.log(f"[serve] {n} requests at {run.size('rate_per_s')}/s in "
            f"{len(calls)} calls ({n / max(len(calls), 1):.2f} a call), "
            f"{failed} failed; requests a call p50 "
            f"{harness.quantile(sizes, 0.5) if sizes else 0:.0f} p95 "
            f"{harness.quantile(sizes, 0.95) if sizes else 0:.0f}, call ms "
            f"p50 {harness.quantile(calls, 0.5) * 1e3 if calls else 0:.3f} "
            f"p95 {harness.quantile(calls, 0.95) * 1e3 if calls else 0:.3f}"
            f"; worker woke late by p50 "
            f"{harness.quantile(late, 0.5) * 1e3 if late else 0:.3f} ms, "
            f"max {max(late, default=0) * 1e3:.3f} ms (arrivals are due "
            f"times the worker reads from the clock, so the generator "
            f"itself is never late)")
    values = {"setup_s": run.counters["setup_s"]}
    if len(done):
        values["serve_p50_ms"] = harness.quantile(done, 0.5) * 1e3
        run.log(f"[serve] latency p95 "
                f"{harness.quantile(done, 0.95) * 1e3:.3f} ms")
    del server, models
    from tpu_breath_torch import graphs
    graphs.release(dev)
    q = max(len(done) // 4, 1)
    sweep = {"lat_first_quarter_ms": float(np.mean(lat[:q])) * 1e3,
             "lat_last_quarter_ms": float(np.mean(lat[-q:])) * 1e3,
             "drain_s": float(np.nanmax(due + lat)) - run.seconds,
             "calls": len(calls),
             "lat_by_second_ms": [
                 float(np.mean(lat[(due >= t) & (due < t + 1)])) * 1e3
                 for t in range(int(run.seconds))]}
    if run.size("sample") == 0:  # a sweep: no check
        return harness.Outcome(attempted=n, failed=failed, values=values,
                               numbers={}, memory_peak_bytes=peak,
                               readings=sweep)

    pick = np.flatnonzero(ok)[data.order(run.seed + 2, int(ok.sum()))[
        :run.size("sample")]]
    f, s = check.features(config, pool[clip_of[pick]], dev,
                           run.sizes.get("oracle_workers"))
    ref = check.probs(config, weights, f, s)
    readings = {}
    if run.sizes.get("readings") is not None:
        readings["widest"] = _witnesses(run, config, weights, spec,
                                        pool[clip_of[pick]], served[pick],
                                        ref)
    if run.sizes.get("readings"):  # the control and a planted fault
        readings.update({"control_fp8": check.prob_gaps(
            check.probs(config, weights, f, s, "fp8"), ref),
            "answer_flipped": check.prob_gaps(1.0 - served[pick], ref)})
    return harness.Outcome(
        attempted=n, failed=failed, values=values,
        numbers=check.prob_gaps(served[pick], ref),
        memory_peak_bytes=peak, readings=readings)
