"""The port's recorder (utils/profiling.py): spans, device spans and
counters, and where the program puts them: fit's epochs, Server's calls,
the decoder, a graph's capture. On the CPU, and the device spans on the
card (marked `cuda`, skipped without a CUDA device, decided in a fixture).

    python -m pytest --noconftest tests/test_torch_spans.py -m cuda -p no:cacheprovider
"""
import threading
import wave

import numpy as np
import pytest
import torch
from torch import nn

from tpu_breath_torch import ensemble
from tpu_breath_torch.config import TrainCfg
from tpu_breath_torch.data import wav as wav_io
from tpu_breath_torch.models import registry
from tpu_breath_torch.train import loop
from tpu_breath_torch.utils import profiling

EPOCH_PARTS = ["fit.upload", "train_step", "train_step", "train_step",
               "fit.evaluate", "fit.wait", "fit.metrics", "fit.log"]
CALL_PARTS = ["server.stage", "server.issue", "server.wait",
              "server.unstage"]


@pytest.fixture(autouse=True)
def no_records():
    """Each test starts and ends with no records, whatever ran before it in
    this process."""
    profiling.records()
    yield
    profiling.records()


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(9 + 36, 1)

    def forward(self, f, s):
        return self.dense(torch.cat([f.mean(dim=(2, 3)), s], -1))[:, 0]


def _fit(epochs=2):
    """loop.fit on the CPU: 20 rows, batch 6 (3 steps an epoch)."""
    rng = np.random.default_rng(9)
    f = rng.standard_normal((20, 9, 4, 4)).astype(np.float32)
    s = rng.standard_normal((20, 36)).astype(np.float32)
    y = (np.arange(20) % 2).astype(np.float32)
    cfg = TrainCfg(num_epochs=epochs, batch_size=6, eval_batch_size=20,
                   patience=99, seed=4)
    return loop.fit(_Tiny(), (f, s), (f, s), y, y, cfg,
                    log_fn=lambda *_: None, device="cpu")


def _server():
    torch.manual_seed(0)
    model = registry.build("cnn8", 36, seed=1).eval()
    return ensemble.Server([model], [1.0], device="cpu")


def _children(spans, parent):
    return [s.name for s in sorted(spans, key=lambda s: s.t0_ns)
            if s.parent == parent]


def test_a_span_with_recording_off_is_the_shared_null_context(monkeypatch):
    made = []
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: made.append(a) or None)
    a, b = profiling.span("a", x=1), profiling.span("b")
    assert a is b
    with a, b:
        profiling.count("c")
    assert profiling.device_span("d", torch.device("cuda", 0)) is a
    assert made == []
    assert profiling.records() == {"spans": [], "device": [], "counts": []}


def test_nested_spans_carry_their_parents_id_and_records_clears():
    with profiling.recording():
        with profiling.span("call", clips=3):
            with profiling.span("part"):
                with profiling.span("inner"):
                    profiling.count("n", 2)
            with profiling.span("part"):
                pass
    assert profiling.span("after") is profiling.span("off")
    rec = profiling.records()
    by = {s.name: s for s in rec["spans"]}
    call = by["call"]
    assert call.parent is None and call.attrs == {"clips": 3}
    parts = [s for s in rec["spans"] if s.name == "part"]
    assert len(parts) == 2 and all(s.parent == call.id for s in parts)
    assert by["inner"].parent == parts[0].id
    assert len({s.id for s in rec["spans"]}) == 4
    for s in rec["spans"]:
        assert s.t0_ns <= s.t1_ns
    assert call.t0_ns <= parts[0].t0_ns and parts[1].t1_ns <= call.t1_ns
    assert [(c.name, c.n) for c in rec["counts"]] == [("n", 2)]
    assert profiling.records() == {"spans": [], "device": [], "counts": []}


def test_a_threads_spans_have_their_own_parents():
    seen = []
    with profiling.recording():
        with profiling.span("main"):
            t = threading.Thread(target=lambda: seen.append(
                profiling.span("other").__enter__().parent))
            t.start()
            t.join(timeout=30)
    assert not t.is_alive() and seen == [None]


def test_a_profiler_sees_the_spans_and_leaves_recording_off():
    """Under torch.profiler a span is also a record_function range of its
    name and is recorded; once the profiler stops, spans are the null
    context again and the program records nothing."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.span("traced"):
            torch.ones(3).sum()
    assert not profiling._REC.on
    assert profiling.span("after") is profiling._NULL
    with profiling.span("after"):
        profiling.count("after")
    _fit(epochs=1)
    names = {e.name for e in prof.events()}
    assert "traced" in names
    rec = profiling.records()
    assert [s.name for s in rec["spans"]] == ["traced"]
    assert rec["counts"] == []


def test_fit_spans_each_epoch_and_its_parts_in_order():
    with profiling.recording():
        res = _fit(epochs=2)
    spans = profiling.records()["spans"]
    epochs = sorted((s for s in spans if s.name == "fit.epoch"),
                    key=lambda s: s.t0_ns)
    assert [e.attrs for e in epochs] == [{"epoch": 1}, {"epoch": 2}]
    for e in epochs:
        parts = _children(spans, e.id)
        assert parts[:len(EPOCH_PARTS)] == EPOCH_PARTS
        assert set(parts[len(EPOCH_PARTS):]) <= {"fit.snapshot"}
        assert all(e.t0_ns <= s.t0_ns and s.t1_ns <= e.t1_ns
                   for s in spans if s.parent == e.id)
    # an epoch's seconds are its span's clock, not the wall clock
    for row, e in zip(res.history, epochs):
        assert 0 < row["sec"] <= (e.t1_ns - e.t0_ns) / 1e9


def test_server_call_spans_its_staging_issue_wait_and_unstaging():
    server = _server()
    wavs = (0.05 * np.random.default_rng(1).standard_normal((3, 16000))
            ).astype(np.float32)
    with profiling.recording():
        p = server(wavs, micro_batch=2)
    spans = profiling.records()["spans"]
    calls = [s for s in spans if s.name == "server.call"]
    assert len(calls) == 1 and p.shape == (3,)
    assert calls[0].attrs == {"clips": 3, "micro_batches": 2}
    assert _children(spans, calls[0].id) == CALL_PARTS


def _write(path, y):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((y * 32767).astype("<i2").tobytes())


def test_a_corrupt_file_takes_the_numpy_pass(tmp_path):
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"x{i}.wav"))
        _write(paths[-1], np.full(800, 0.1 * i))
    (tmp_path / "bad.wav").write_bytes(b"not a wav")
    paths.append(str(tmp_path / "bad.wav"))
    errors = []
    with profiling.recording():
        good = wav_io.load_wav_batch(paths[:3])
        out = wav_io.load_wav_batch(paths, errors=errors)
    rec = profiling.records()
    names = [s.name for s in sorted(rec["spans"], key=lambda s: s.t0_ns)]
    assert names == ["wav.decode", "wav.decode", "wav.fallback"]
    assert rec["spans"][0].attrs == {"files": 3}
    assert len(errors) == 1 and np.array_equal(out[:3], good)


def test_no_cuda_event_without_a_card_or_with_recording_off(monkeypatch):
    """fit and Server create no CUDA event with recording off; on a host
    without CUDA none while recording either (their device spans are
    skipped, not faked), and collect() reads nothing."""
    made = []

    def event(*a, **k):
        made.append(k)
        raise AssertionError("a CUDA event was made")

    monkeypatch.setattr(torch.cuda, "Event", event)
    wavs = np.zeros((2, 16000), np.float32)
    _fit(epochs=1)
    _server()(wavs, micro_batch=2)
    with profiling.recording():
        _fit(epochs=1)
        _server()(wavs, micro_batch=2)
        assert profiling.device_span("d", "cpu") is profiling._NULL
        profiling.collect()
    assert made == []
    assert profiling.records()["device"] == []


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device spans are CUDA events")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def card_data(card):
    """16 seeded clips and their features (precompute's path, chunks of
    8), alternating labels."""
    from tpu_breath_torch.features import extract_features_batched

    g = torch.Generator(device=card).manual_seed(6)
    wavs = (0.05 * torch.randn(16, 16000, generator=g, device=card)
            ).cpu().numpy()
    f, s = extract_features_batched(wavs, chunk=8, device=card)
    return wavs, f, s, (np.arange(16) % 2).astype(np.float32)


def _card_fit(card_data, fused: bool, epochs: int = 3, log_fn=None):
    """fit on the card: 16 clips (batch 8, 2 steps an epoch), 10
    validation rows, cached or fused."""
    from tpu_breath_torch.config import DEFAULT_FEATURES as SPEC

    wavs, f, s, y = card_data
    cfg = TrainCfg(num_epochs=epochs, batch_size=8, eval_batch_size=8,
                   warmup_epochs=1, patience=9)
    store, spec = ((wavs, None), SPEC) if fused else ((f, s), None)
    return loop.fit(registry.build("cnn8", 36, seed=3), store,
                    (f[:10], s[:10]), y, y[:10], cfg,
                    log_fn=log_fn or (lambda *_: None), fused_spec=spec)


@pytest.mark.cuda
def test_recording_off_makes_no_event_on_the_card(card, card_data,
                                                   monkeypatch):
    """With recording off, also after a profiled Server call, a graphed
    fused fit and a Server call make no CUDA event, so their captured
    graphs hold no event node."""
    made = []
    event = torch.cuda.Event

    def counting(*a, **k):
        made.append(k)
        return event(*a, **k)

    server = ensemble.Server([registry.build("cnn8", 36, seed=1).to(card)
                              .eval()], [1.0], device=card)
    clips = np.zeros((3, 16000), np.float32)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        server(clips, micro_batch=2)
    profiling.records()
    monkeypatch.setattr(torch.cuda, "Event", counting)
    _card_fit(card_data, fused=True, epochs=2)
    server(clips, micro_batch=2)
    assert made == []
    assert profiling.records() == {"spans": [], "device": [], "counts": []}


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_device_spans_of_a_recorded_fit_on_the_card(card_data, fused):
    """Recorded on the card, 3 epochs of 2 steps: one fit.step.device a
    step, each inside its train_step, and no other device span; two
    captures (the step and the evaluation), named; fused, the warm call's
    fused_features inside the step's capture span."""
    with profiling.recording():
        _card_fit(card_data, fused)
    rec = profiling.records()
    steps = {s.id for s in rec["spans"] if s.name == "train_step"}
    assert [d.name for d in rec["device"]] == ["fit.step.device"] * 6
    assert {d.parent for d in rec["device"]} == steps
    assert all(d.ms > 0 for d in rec["device"])
    feats = [s for s in rec["spans"] if s.name == "fused_features"]
    if fused:
        cap = next(s for s in rec["spans"] if s.name == "graph.capture")
        assert cap.parent in steps
        assert cap.id in {s.parent for s in feats}
    else:
        assert feats == []
    assert sum(c.n for c in rec["counts"] if c.name == "graph.captures") == 2
    caps = [s.attrs["fn"] for s in rec["spans"] if s.name == "graph.capture"]
    assert caps == ["TrainStep.body", "Predictor.forward"]


@pytest.mark.cuda
def test_a_recorded_graphed_epoch_still_waits_on_the_host_once(
        card_data, monkeypatch):
    """Recording adds no host wait: from the end of the first epoch to
    each epoch's one wait, torch's sync debug mode raises on any."""
    from tpu_breath_torch import graphs

    waits, lines = [], []
    wait = graphs.wait

    def final_wait(device):
        torch.cuda.set_sync_debug_mode("default")
        waits.append(len(lines))
        wait(device)

    def log_fn(msg):
        lines.append(msg)
        torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(graphs, "wait", final_wait)
    try:
        with profiling.recording():
            _card_fit(card_data, fused=True, log_fn=log_fn)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert waits == [0, 1, 2] and len(lines) == 3
    assert len(profiling.records()["device"]) == 6
