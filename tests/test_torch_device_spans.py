"""Device spans and the train step's phases, on the CPU.

``observability.span(name, device=...)`` publishes ``device/<name>``: on
the CPU the host's duration, at once; on CUDA the distance of two timing
events, resolved later.  CUDA's events and streams are stood in for here
by fakes, so the event pool, the polling, :func:`flush_device_spans` and
the pending bound run as they do on a card.  A traced step of the
multi-node optimizer splits into ``train_step/forward``, ``/backward``,
``/grad_sync``, ``/update`` (and ``/state_mean``), each piece of the
step's work inside its phase; the fused CE opens ``fused_ce`` in its
forward and backward inside a traced step only; the prefetch iterator's
consumer waits for a batch under ``data_wait``.
"""

import collections
import contextlib
import time

import pytest
import torch

from chainermn_tpu_torch import (create_communicator,
                                 create_multi_node_optimizer)
from chainermn_tpu_torch import observability as obs
from chainermn_tpu_torch import optimizers
from chainermn_tpu_torch.communicators.overlap import BackwardOverlap
from chainermn_tpu_torch.iterators import create_prefetch_iterator
from chainermn_tpu_torch.observability import spans
from chainermn_tpu_torch.ops.fused_ce import fused_cross_entropy

STEPS = 3
PHASES = {
    "plain": ["forward", "backward", "grad_sync", "update"],
    "overlap": ["forward", "backward", "grad_sync", "update"],
    "accum": ["forward", "backward", "forward", "backward", "grad_sync",
              "update"],
    "zero3_accum": ["forward", "backward", "grad_sync", "forward",
                    "backward", "grad_sync", "grad_sync", "update"],
    "with_state": ["forward", "backward", "grad_sync", "update",
                   "state_mean"],
}


@pytest.fixture
def opened(monkeypatch):
    """Every span entered, as ``(depth, name)`` in order, and the stack
    of those open now."""
    log, stack = [], []
    real = spans.span

    @contextlib.contextmanager
    def logged(name, device=None):
        log.append((len(stack), name))
        stack.append(name)
        try:
            with real(name, device=device):
                yield
        finally:
            stack.pop()

    monkeypatch.setattr(spans, "span", logged)
    return log, stack


def _where(monkeypatch, stack, seen, obj, attr, label):
    """Wrap ``obj.attr`` to note in ``seen[label]`` the span open at each
    call."""
    real = getattr(obj, attr)

    def noted(*a, **k):
        seen[label].append(stack[-1] if stack else None)
        return real(*a, **k)

    monkeypatch.setattr(obj, attr, noted)


def _build(case, monkeypatch, stack, seen):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4),
                                torch.nn.BatchNorm1d(4),
                                torch.nn.Linear(4, 1))
    comm = create_communicator(
        "naive", device="cpu",
        comm_dtype="int8" if case == "overlap" else None)
    mno = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), comm,
        zero_stage=3 if case == "zero3_accum" else 0)
    mno.init()

    def loss_fn(x):
        seen["loss_fn"].append(stack[-1])
        out = model(x)
        out.register_hook(lambda g: seen["grad"].append(stack[-1]))
        return out.pow(2).mean()

    if case == "with_state":
        step = mno.make_train_step_with_state(loss_fn, model)
        _where(monkeypatch, stack, seen, mno, "_mean_over_ranks", "sync")
    else:
        step = mno.make_train_step(
            loss_fn, n_accum=2 if "accum" in case else 1)
    if case == "overlap":
        assert mno._overlap is not None
        _where(monkeypatch, stack, seen, BackwardOverlap, "finish", "sync")
    elif case == "zero3_accum":
        _where(monkeypatch, stack, seen, mno, "_scatter_grads", "sync")
    elif case in ("plain", "accum"):
        _where(monkeypatch, stack, seen, comm, "allreduce_grad", "sync")
    _where(monkeypatch, stack, seen, mno, "_update", "update")
    return step


@pytest.mark.parametrize("case", list(PHASES))
def test_phases_partition_a_traced_step(case, opened, monkeypatch, tmp_path):
    """Each traced step is ``train_step`` whose children are the phases in
    order; the loss function runs in ``forward``, its gradients in
    ``backward``, the exchange (or the BatchNorm mean) in its phase, the
    update in ``update``; every span also publishes its device time (on
    the CPU the host's) and the phases' sum stays within the step's."""
    log, stack = opened
    seen = collections.defaultdict(list)
    step = _build(case, monkeypatch, stack, seen)
    rep = obs.Reporter()
    with obs.scope(rep), obs.StepRecorder(str(tmp_path / "s.jsonl"),
                                          mem_every=0) as rec:
        for _ in range(STEPS):
            step(torch.randn(8, 3))
            rec.step()
    assert spans._step_device is None
    children = [name for depth, name in log if depth == 1]
    assert [name for depth, name in log if depth == 0] == \
        ["train_step"] * STEPS
    assert children == [f"train_step/{p}" for p in PHASES[case]] * STEPS
    micro = PHASES[case].count("forward")
    assert seen["loss_fn"] == ["train_step/forward"] * micro * STEPS
    assert set(seen["grad"]) == {"train_step/backward"}
    assert seen["update"] == ["train_step/update"] * STEPS
    sync = "train_step/state_mean" if case == "with_state" else \
        "train_step/grad_sync"
    assert set(seen["sync"]) == {sync}
    s = rep.summary()["scalars"]
    for name in {"train_step"} | {f"train_step/{p}" for p in PHASES[case]}:
        n = (PHASES[case].count(name.split("/")[-1]) * STEPS
             if "/" in name else STEPS)
        assert s[f"span/{name}"]["count"] == s[f"device/{name}"]["count"] \
            == n
        assert s[f"device/{name}"]["sum"] == s[f"span/{name}"]["sum"]
    phases = sum(s[f"device/train_step/{p}"]["sum"]
                 for p in set(PHASES[case]))
    assert 0 < phases <= s["device/train_step"]["sum"]
    rows = [r for r in obs.read_records(str(tmp_path / "s.jsonl"))
            if r["event"] == "step"]
    assert [sorted(r["device_spans"]) for r in rows] == \
        [[str(i)] for i in range(STEPS)]
    assert set(rows[0]["device_spans"]["0"]) == \
        {"train_step"} | {f"train_step/{p}" for p in PHASES[case]}


def test_untraced_step_and_evaluation_enter_no_span(monkeypatch):
    """With no telemetry a step with the fused CE in it enters no span;
    with a Reporter installed, the CE called outside a step (evaluation)
    enters none either, and a step that raises leaves no step traced."""
    torch.manual_seed(0)
    emb = torch.nn.Parameter(torch.randn(11, 8))
    h = torch.nn.Parameter(torch.randn(6, 8))
    labels = torch.randint(0, 11, (6,))
    mno = create_multi_node_optimizer(
        torch.optim.SGD([emb, h], lr=0.1),
        create_communicator("naive", device="cpu"))
    mno.init()
    step = mno.make_train_step(
        lambda x: fused_cross_entropy(h * x.mean(), emb, labels))

    def no_span(name, device=None):
        raise AssertionError(f"span {name!r} entered")

    real = spans.span
    monkeypatch.setattr(spans, "span", no_span)
    step(torch.ones(4, 1))
    rep = obs.Reporter()
    with obs.scope(rep):
        fused_cross_entropy(h, emb, labels).backward()
    monkeypatch.setattr(spans, "span", real)

    def boom(x):
        raise RuntimeError("boom")

    bad = mno.make_train_step(boom)
    with obs.scope(rep):
        with pytest.raises(RuntimeError, match="boom"):
            bad(torch.ones(4, 1))
    assert spans._step_device is None
    assert rep.summary()["counters"]["span/train_step/errors"] == 1


def test_fused_ce_spans_in_forward_and_backward(opened):
    """In a traced step the CE's forward scan runs in ``fused_ce`` under
    ``train_step/forward`` and its backward scan in ``fused_ce`` under
    ``train_step/backward``; each is a device span."""
    log, _ = opened
    torch.manual_seed(0)
    emb = torch.nn.Parameter(torch.randn(11, 8))
    h = torch.nn.Parameter(torch.randn(6, 8))
    labels = torch.randint(0, 11, (6,))
    mno = create_multi_node_optimizer(
        torch.optim.SGD([emb, h], lr=0.1),
        create_communicator("naive", device="cpu"))
    mno.init()
    step = mno.make_train_step(
        lambda x: fused_cross_entropy(h * x.mean(), emb, labels, chunk=4))
    rep = obs.Reporter()
    with obs.scope(rep):
        for _ in range(2):
            step(torch.ones(4, 1))
    parents = [log[i - 1][1] for i, (depth, name) in enumerate(log)
               if name == "fused_ce"]
    assert all(d == 2 for d, name in log if name == "fused_ce")
    assert parents == ["train_step/forward", "train_step/backward"] * 2
    s = rep.summary()["scalars"]
    assert s["device/fused_ce"]["count"] == 4
    assert s["device/fused_ce"]["sum"] <= (
        s["device/train_step/forward"]["sum"]
        + s["device/train_step/backward"]["sum"])


# -- CUDA's lazy resolution, with fake events -------------------------------

class _FakeEvent:
    """A timing event whose completion the test decides; each record
    advances a clock by 1 ms."""
    clock = 0.0
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.t, self.done = None, False

    def record(self, stream=None):
        assert stream == "stream"
        type(self).clock += 1.0
        self.t, self.done = type(self).clock, False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        assert end.done             # the start precedes it on the stream
        return end.t - self.t


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda i: "stream")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(spans, "_pending", collections.deque())
    monkeypatch.setattr(spans, "_free", {})
    monkeypatch.setattr(_FakeEvent, "made", 0)
    return spans._pending


def _complete(pair):
    pair.start.done = pair.end.done = True


def test_device_pairs_resolve_lazily_and_flush_resolves_all(fake_cuda,
                                                            tmp_path):
    """A CUDA span publishes nothing at exit; the next device span to open
    resolves the pairs that completed (oldest first, none still running);
    ``flush_device_spans`` resolves the rest; events are reused; the
    step log gets each pair under the step its host span belonged to."""
    pending = fake_cuda
    rep = obs.Reporter()
    path = str(tmp_path / "s.jsonl")
    with obs.scope(rep), obs.StepRecorder(path, mem_every=0) as rec:
        with spans.span("a", device="cuda:0"):
            with spans.span("inner", device="cuda:0"):
                pass
        assert [p.name for p in pending] == ["inner", "a"]
        assert not any(k.startswith("device/")
                       for k in rep.summary()["scalars"])
        rec.step()
        _complete(pending[0])               # "inner" done, "a" running
        with spans.span("b", device="cuda:0"):
            pass
        s = rep.summary()["scalars"]
        assert s["device/inner"]["count"] == 1
        assert s["device/inner"]["sum"] == pytest.approx(1e-3)
        assert "device/a" not in s
        assert [p.name for p in pending] == ["a", "b"]
        made = _FakeEvent.made
        assert spans.flush_device_spans() == 2
        assert not pending
        s = rep.summary()["scalars"]
        assert s["device/a"]["sum"] == pytest.approx(3e-3)
        assert s["device/b"]["sum"] == pytest.approx(1e-3)
        with spans.span("c", device="cuda"):
            pass
        assert _FakeEvent.made == made      # two events from the pool
        assert spans.flush_device_spans() == 1
        rec.step()
    rows = obs.read_records(path)
    assert "device_spans" not in rows[0]     # nothing had resolved
    assert set(rows[1]["device_spans"]) == {"0", "1"}
    assert rows[1]["device_spans"]["0"] == {
        "inner": pytest.approx(1e-3), "a": pytest.approx(3e-3)}
    assert set(rows[1]["device_spans"]["1"]) == {"b", "c"}


def test_pending_bound_drops_the_oldest(fake_cuda, monkeypatch):
    monkeypatch.setattr(spans, "PENDING_LIMIT", 3)
    rep = obs.Reporter()
    with obs.scope(rep):
        for i in range(5):
            with spans.span(f"s{i}", device="cuda:0"):
                pass
    assert [p.name for p in fake_cuda] == ["s2", "s3", "s4"]
    assert rep.summary()["counters"]["device_span/dropped"] == 2
    assert spans.flush_device_spans() == 3
    assert rep.summary()["scalars"]["device/s4"]["count"] == 1
    assert "device/s0" not in rep.summary()["scalars"]


def test_device_span_without_sinks_keeps_nothing(fake_cuda):
    with spans.span("quiet", device="cuda:0"):
        pass
    assert not fake_cuda
    assert sum(len(v) for v in spans._free.values()) == 2


# -- the input pipeline -------------------------------------------------------

def _slow(n, delay):
    for i in range(n):
        time.sleep(delay)
        yield torch.full((2,), float(i))


def test_prefetch_consumer_waits_under_data_wait(monkeypatch):
    """A producer slower than its consumer shows up in ``span/data_wait``
    (one wait per batch and one for the end); with telemetry off the
    consumer enters no span."""
    n, delay = 4, 0.05
    rep = obs.Reporter()
    with obs.scope(rep):
        got = [int(b[0]) for b in create_prefetch_iterator(
            _slow(n, delay), size=1, device="cpu")]
    assert got == list(range(n))
    s = rep.summary()["scalars"]["span/data_wait"]
    assert s["count"] == n + 1
    assert s["sum"] >= 0.5 * n * delay

    def no_span(name, device=None):
        raise AssertionError(f"span {name!r} entered")

    monkeypatch.setattr(spans, "span", no_span)
    assert len(list(create_prefetch_iterator(_slow(2, 0.0), device="cpu"))) \
        == 2


def test_instrument_step_names_the_device():
    """The step is traced on its parameters' device."""
    w = torch.nn.Parameter(torch.ones(2))
    mno = create_multi_node_optimizer(
        torch.optim.SGD([w], lr=0.1),
        create_communicator("naive", device="cpu"))
    assert mno._device() == torch.device("cpu")
    seen = []

    def body():
        seen.append(spans._step_device)

    optimizers._instrument_step(body, torch.device("cpu"))()
    rep = obs.Reporter()
    with obs.scope(rep):
        optimizers._instrument_step(body, torch.device("cpu"))()
    assert seen == [None, torch.device("cpu")]


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_traced_step_on_the_card(cuda):
    """CUDA events: a traced step's spans stay pending until they complete
    (no synchronisation in the step); after a synchronise one flush
    resolves the rest, the CE's backward span (opened on autograd's
    thread) included; the phases fit in the step's device time and the
    pool is reused from the second step on."""
    torch.manual_seed(0)
    emb = torch.nn.Parameter(torch.randn(50257, 512, device=cuda) * 0.02)
    lin = torch.nn.Linear(512, 512, device=cuda)
    labels = torch.randint(0, 50257, (4096,), device=cuda)
    x = torch.randn(4096, 512, device=cuda)
    mno = create_multi_node_optimizer(
        torch.optim.AdamW([emb, *lin.parameters()], lr=1e-3),
        create_communicator("naive", device=cuda))
    mno.init()
    step = mno.make_train_step(
        lambda b: fused_cross_entropy(lin(b), emb, labels))
    rep = obs.Reporter()
    with obs.scope(rep):
        step(x)
        torch.cuda.synchronize()
        spans.flush_device_spans()
        pooled = sum(len(v) for v in spans._free.values())
        for _ in range(3):
            step(x)
        assert sum(len(v) for v in spans._free.values()) <= pooled
        torch.cuda.synchronize()
        spans.flush_device_spans()
    assert not spans._pending
    s = rep.summary()["scalars"]
    assert s["device/fused_ce"]["count"] == 8
    assert s["device/train_step"]["count"] == 4
    phases = sum(s[f"device/train_step/{p}"]["sum"]
                 for p in ("forward", "backward", "grad_sync", "update"))
    assert 0 < s["device/fused_ce"]["sum"] < phases
    assert phases <= s["device/train_step"]["sum"] * 1.001
