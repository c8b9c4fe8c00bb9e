"""Deterministic heavy-tailed traffic: the load half of the resilience
loop.

Port of ``chainermn_tpu/serving/workload.py`` (numpy, seeded, copied as
it is: the same spec and seed give the reference's arrivals).

Real serving load is nothing like a uniform arrival sweep: arrivals
come in bursts (users pile on after a deploy, a post goes viral),
prompts share popular prefixes (system prompts, few-shot templates),
lengths are bimodal (chat turns vs. document dumps), and some clients
ignore backpressure entirely.  :func:`generate` produces exactly that
traffic — *deterministically*, from one seed — so a goodput/p99 curve
is reproducible run-to-run and an autoscaler soak can be replayed
against a bit-exact oracle:

* **MMPP arrivals** — a two-state Markov-modulated Poisson process:
  calm at ``rate`` req/s, bursts at ``rate·burst``, switching with
  per-arrival probabilities ``p_burst``/``p_calm``.  The burst state is
  what trips queue watermarks; a plain Poisson stream at the same mean
  rarely does.
* **Zipf shared prefixes** — each arrival extends one of
  ``templates`` fixed prefix templates, template popularity
  Zipf-distributed with exponent ``zipf_s``: a handful of templates
  dominate, which is precisely the regime the prefix cache (and
  the router's prefix-affinity scoring) is built for.
* **Length buckets** — prompt and output lengths drawn from weighted
  (lo, hi) buckets: mostly short chat turns, a tail of long documents
  that stress page pools and admission watermarks.
* **Priority classes** — each arrival carries a shed class (0 = most
  important) drawn from ``class_weights``; under overload the frontend
  sheds the cheapest class first and the curves report it per class.
* **Abusive clients** — a fraction of arrivals that ignore
  ``retry_after_s`` hints and hammer the queue until a small retry cap
  — the synchronized-retry-storm antagonist the jittered hints defend
  against.

:func:`replay` drives the arrivals against any ``submit`` callable in
wall-clock time (scaled by ``speedup``), honoring the jittered retry
hints for polite clients, then waits for every admitted stream to
finish, timestamping completions.  :func:`summarize` folds a replay
into the goodput / latency-percentile / per-class-shed numbers the
bench curves plot.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .frontend import QueueFull

#: (lo, hi, weight) length buckets — inclusive token ranges.
Buckets = Tuple[Tuple[int, int, float], ...]


def _parse_buckets(text: str) -> Buckets:
    """``"4-8:0.6|10-20:0.4"`` → ((4, 8, 0.6), (10, 20, 0.4))."""
    out = []
    for part in text.split("|"):
        span, _, w = part.partition(":")
        lo, _, hi = span.partition("-")
        out.append((int(lo), int(hi), float(w) if w else 1.0))
    return tuple(out)


def _fmt_buckets(b: Buckets) -> str:
    return "|".join(f"{lo}-{hi}:{w:g}" for lo, hi, w in b)


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """One traffic scenario, fully determined by its field values
    (same spec → same arrivals, token for token)."""

    seed: int = 0
    requests: int = 64
    #: calm-state arrival rate, requests/second.
    rate: float = 50.0
    #: burst-state rate multiplier (> 1).
    burst: float = 4.0
    #: per-arrival switch probabilities calm→burst / burst→calm.
    p_burst: float = 0.1
    p_calm: float = 0.3
    #: template popularity exponent (larger → heavier head).
    zipf_s: float = 1.2
    templates: int = 8
    #: shared template prefix length (tokens).
    prefix_len: int = 12
    prompt_buckets: Buckets = ((4, 8, 0.55), (10, 20, 0.3),
                               (24, 40, 0.15))
    output_buckets: Buckets = ((4, 8, 0.6), (10, 16, 0.3),
                               (20, 32, 0.1))
    #: weight per priority class, index = class (0 most important).
    class_weights: Tuple[float, ...] = (0.2, 0.5, 0.3)
    #: fraction of arrivals from hint-ignoring clients (lowest class).
    abusive_frac: float = 0.0
    vocab: int = 32
    #: long-context dimension (off by default — the arrival stream is
    #: byte-identical to pre-long specs when these stay at their
    #: defaults).  A ``long_frac`` share of arrivals becomes a
    #: *document dump*: its prompt is a prefix of one of
    #: ``doc_templates`` fixed shared documents (Zipf-popular, same
    #: exponent as the chat templates), with the prefix length drawn
    #: from the heavy-tail ``long_buckets`` — the workload the
    #: streaming prefix registration + chunked/sharded prefill path is
    #: built for: concurrent requests over the same giant document.
    long_frac: float = 0.0
    doc_templates: int = 4
    long_buckets: Buckets = ()
    #: multi-tenant dimension (off by default — with ``tenants=0`` the
    #: arrival stream is byte-identical to pre-tenant specs).  Each
    #: arrival carries a tenant id ``"t<k>"`` drawn Zipf-popular with
    #: exponent ``tenant_zipf`` from a CHILD generator, so a handful of
    #: tenants dominate token flow and page residency — the regime the
    #: per-tenant accounting (``tenant/<id>/*`` counters, KV
    #: page-seconds) is built to attribute.
    tenants: int = 0
    tenant_zipf: float = 1.1
    #: diurnal dimension (off by default — with ``diurnal=0`` the
    #: arrival stream is byte-identical to pre-diurnal specs).  A
    #: seeded day-curve envelope multiplies the MMPP intensity: one
    #: fundamental over ``diurnal_period_s`` plus a second harmonic,
    #: phases drawn from a CHILD generator, depth ``diurnal`` in
    #: (0, 1).  Peaks trip the serving watermarks, troughs idle the
    #: fleet — the signal the fabric arbiter trades chips on.
    diurnal: float = 0.0
    diurnal_period_s: float = 60.0
    diurnal_phase: float = 0.0

    _INT = ("seed", "requests", "templates", "prefix_len", "vocab",
            "doc_templates", "tenants")
    _FLOAT = ("rate", "burst", "p_burst", "p_calm", "zipf_s",
              "abusive_frac", "long_frac", "tenant_zipf",
              "diurnal", "diurnal_period_s", "diurnal_phase")

    @classmethod
    def parse(cls, text: str) -> "TrafficSpec":
        """Build a spec from a compact CLI string::

            rate=80,requests=48,burst=6,abusive_frac=0.2
            prompt_buckets=4-8:0.6|10-20:0.4,class_weights=0.3/0.7

        Unknown keys raise — a typo'd knob must not silently run the
        default scenario."""
        kw: dict = {}
        for item in (text or "").split(","):
            item = item.strip()
            if not item or item == "default":
                continue
            if "=" not in item:
                raise ValueError(
                    f"traffic: expected key=value, got {item!r}"
                )
            k, v = item.split("=", 1)
            k = k.strip()
            if k in cls._INT:
                kw[k] = int(v)
            elif k in cls._FLOAT:
                kw[k] = float(v)
            elif k in ("prompt_buckets", "output_buckets",
                       "long_buckets"):
                kw[k] = _parse_buckets(v) if v else ()
            elif k == "class_weights":
                kw[k] = tuple(float(x) for x in v.split("/"))
            else:
                raise ValueError(f"traffic: unknown key {k!r}")
        return cls(**kw)

    def format(self) -> str:
        out = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name in ("prompt_buckets", "output_buckets",
                          "long_buckets"):
                out.append(f"{f.name}={_fmt_buckets(v)}")
            elif f.name == "class_weights":
                out.append(
                    f"{f.name}={'/'.join(f'{x:g}' for x in v)}"
                )
            elif isinstance(v, float):
                out.append(f"{f.name}={v:g}")
            else:
                out.append(f"{f.name}={v}")
        return ",".join(out)

    def scaled(self, load_mult: float) -> "TrafficSpec":
        """The same scenario at ``load_mult``× the offered load (the
        x-axis of a goodput-vs-load curve): arrival rate scales, the
        arrival *pattern* (seed, templates, lengths) does not."""
        return dataclasses.replace(self, rate=self.rate * load_mult)

    def diurnal_phases(self) -> Tuple[float, float]:
        """Seeded phases (fundamental, second harmonic) of the day
        curve — a child generator, so enabling the dimension never
        perturbs the base arrival stream."""
        drng = np.random.default_rng((self.seed, 0xD1E))
        ph = drng.uniform(0.0, 1.0, size=2)
        return (float(ph[0]), float(ph[1]))

    def diurnal_envelope(self, t: float,
                         phases: Optional[Tuple[float, float]] = None
                         ) -> float:
        """Intensity multiplier at ``t`` seconds into the trace
        (identically 1.0 with the dimension off).  Clamped strictly
        positive so troughs thin arrivals rather than stopping time."""
        if self.diurnal <= 0:
            return 1.0
        if phases is None:
            phases = self.diurnal_phases()
        x = (t / max(self.diurnal_period_s, 1e-9)
             + self.diurnal_phase)
        wave = (0.75 * np.sin(2.0 * np.pi * (x + phases[0]))
                + 0.25 * np.sin(4.0 * np.pi * (x + phases[1])))
        return float(max(1.0 + self.diurnal * wave, 0.05))

    def tenant_weights(self) -> dict:
        """The Zipf tenant shares as an id→weight map (empty when the
        tenant dimension is off) — the weights deficit-round-robin
        admission (``scheduler.set_tenant_weights``) divides service
        by."""
        if self.tenants <= 0:
            return {}
        w = [1.0 / (k + 1) ** self.tenant_zipf
             for k in range(self.tenants)]
        s = sum(w)
        return {f"t{k}": w[k] / s for k in range(self.tenants)}


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One generated request: submit at ``t`` seconds after start."""

    index: int
    t: float
    prompt: Tuple[int, ...]
    max_new_tokens: int
    priority: int
    abusive: bool
    template: int
    #: document-dump arrival: prompt is a prefix of a shared long
    #: document (``template`` then indexes past ``spec.templates`` into
    #: the document id space).
    long: bool = False
    #: accounting identity ("t<k>"), or None when the tenant dimension
    #: is off.
    tenant: Optional[str] = None


def generate(spec: TrafficSpec) -> List[Arrival]:
    """The spec's arrival sequence — pure function of the spec."""
    rng = np.random.default_rng(spec.seed)
    prefixes = [
        tuple(int(x) for x in rng.integers(0, spec.vocab,
                                           size=spec.prefix_len))
        for _ in range(spec.templates)
    ]
    zipf_w = np.array(
        [1.0 / (k + 1) ** spec.zipf_s for k in range(spec.templates)]
    )
    zipf_w /= zipf_w.sum()
    pw = np.array([w for _, _, w in spec.prompt_buckets], float)
    pw /= pw.sum()
    ow = np.array([w for _, _, w in spec.output_buckets], float)
    ow /= ow.sum()
    cw = np.array(spec.class_weights, float)
    cw /= cw.sum()
    # Long-context dimension: shared documents + heavy-tail lengths.
    # Everything here is drawn from a CHILD generator so that enabling
    # (or resizing) the dimension never perturbs the base arrival
    # stream above — curves stay comparable across the toggle.
    long_on = bool(spec.long_frac > 0 and spec.long_buckets
                   and spec.doc_templates > 0)
    docs: List[Tuple[int, ...]] = []
    doc_w = None
    lw = None
    lrng = np.random.default_rng((spec.seed, 0x10C))
    if long_on:
        max_doc = max(hi for _, hi, _ in spec.long_buckets)
        docs = [
            tuple(int(x) for x in lrng.integers(0, spec.vocab,
                                                size=max_doc))
            for _ in range(spec.doc_templates)
        ]
        doc_w = np.array([1.0 / (k + 1) ** spec.zipf_s
                          for k in range(spec.doc_templates)])
        doc_w /= doc_w.sum()
        lw = np.array([w for _, _, w in spec.long_buckets], float)
        lw /= lw.sum()
    # Tenant dimension: its own child generator for the same reason —
    # toggling tenancy (or resizing the tenant pool) never perturbs the
    # base arrival stream.
    trng = np.random.default_rng((spec.seed, 0x7E7))
    tenant_w = None
    if spec.tenants > 0:
        tenant_w = np.array([1.0 / (k + 1) ** spec.tenant_zipf
                             for k in range(spec.tenants)])
        tenant_w /= tenant_w.sum()

    # Diurnal envelope phases, resolved once (child generator).
    diurnal_on = spec.diurnal > 0
    dphases = spec.diurnal_phases() if diurnal_on else None

    arrivals: List[Arrival] = []
    t, burst = 0.0, False
    for i in range(spec.requests):
        rate = spec.rate * (spec.burst if burst else 1.0)
        if diurnal_on:
            rate *= spec.diurnal_envelope(t, dphases)
        t += float(rng.exponential(1.0 / max(rate, 1e-9)))
        if burst:
            burst = rng.random() >= spec.p_calm
        else:
            burst = rng.random() < spec.p_burst
        tmpl = int(rng.choice(spec.templates, p=zipf_w))
        lo, hi, _ = spec.prompt_buckets[int(rng.choice(len(pw), p=pw))]
        plen = int(rng.integers(lo, hi + 1))
        prefix = prefixes[tmpl]
        if plen <= len(prefix):
            prompt = prefix[:plen]
        else:
            tail = rng.integers(0, spec.vocab, size=plen - len(prefix))
            prompt = prefix + tuple(int(x) for x in tail)
        long = bool(long_on and lrng.random() < spec.long_frac)
        if long:
            # Document dump: a prefix of a shared document (pure
            # prefix, no unique tail — that is exactly the workload
            # streaming prefix registration de-duplicates).
            d = int(lrng.choice(spec.doc_templates, p=doc_w))
            lo, hi, _ = spec.long_buckets[int(lrng.choice(len(lw), p=lw))]
            plen = int(lrng.integers(lo, hi + 1))
            prompt = docs[d][:plen]
            tmpl = spec.templates + d
        lo, hi, _ = spec.output_buckets[int(rng.choice(len(ow), p=ow))]
        out_len = int(rng.integers(lo, hi + 1))
        abusive = bool(rng.random() < spec.abusive_frac)
        prio = len(cw) - 1 if abusive else int(rng.choice(len(cw), p=cw))
        tenant = None
        if tenant_w is not None:
            tenant = f"t{int(trng.choice(spec.tenants, p=tenant_w))}"
        arrivals.append(Arrival(
            index=i, t=t, prompt=prompt, max_new_tokens=out_len,
            priority=prio, abusive=abusive, template=tmpl, long=long,
            tenant=tenant,
        ))
    return arrivals


@dataclasses.dataclass
class Outcome:
    """What happened to one arrival."""

    arrival: Arrival
    handle: Optional[object] = None
    attempts: int = 0
    rejected: bool = False
    submit_t: Optional[float] = None
    finish_t: Optional[float] = None

    @property
    def finished(self) -> bool:
        return (
            self.handle is not None
            and getattr(self.handle, "status", None) == "finished"
        )

    @property
    def shed(self) -> bool:
        err = getattr(self.handle, "error", None) if self.handle else None
        return bool(err) and err.startswith("shed")


@dataclasses.dataclass
class ReplayReport:
    outcomes: List[Outcome]
    wall_s: float


def replay(arrivals: Sequence[Arrival],
           submit: Callable[[Arrival], object],
           *,
           clock: Callable[[], float] = time.monotonic,
           sleep: Callable[[float], None] = time.sleep,
           pump: Optional[Callable[[], None]] = None,
           speedup: float = 1.0,
           max_retries: int = 8,
           abusive_retries: int = 3,
           default_retry_s: float = 0.01,
           drain_timeout_s: float = 300.0) -> ReplayReport:
    """Play ``arrivals`` against ``submit`` in (scaled) real time.

    ``submit(arrival)`` returns a handle (anything with ``done`` /
    ``status``) or raises :class:`QueueFull`.  Polite clients honor the
    exception's jittered ``retry_after_s`` before retrying (up to
    ``max_retries``); abusive ones retry immediately, up to
    ``abusive_retries`` — backpressure is their only brake.  ``pump``
    runs between waits (router policy work, autoscaler steps, chaos
    firing).  After the last arrival, waits until every admitted
    stream completes, stamping ``finish_t`` the moment each is first
    seen done.  Raises RuntimeError if streams fail to drain within
    ``drain_timeout_s``."""

    def _pump() -> None:
        if pump is not None:
            pump()

    t0 = clock()
    outcomes: List[Outcome] = []
    for a in arrivals:
        due = t0 + a.t / speedup
        while clock() < due:
            _pump()
            sleep(min(0.002, max(0.0, due - clock())))
        o = Outcome(arrival=a)
        outcomes.append(o)
        while True:
            o.attempts += 1
            try:
                o.handle = submit(a)
                o.submit_t = clock()
                break
            except QueueFull as e:
                limit = abusive_retries if a.abusive else max_retries
                if o.attempts > limit:
                    o.rejected = True
                    break
                if a.abusive:
                    _pump()  # no wait: slam the queue again
                    continue
                hint = e.retry_after_s
                retry_at = clock() + (
                    default_retry_s if hint is None else hint
                )
                while clock() < retry_at:
                    _pump()
                    sleep(min(0.002, max(0.0, retry_at - clock())))
    deadline = clock() + drain_timeout_s
    live = [o for o in outcomes if o.handle is not None]
    while True:
        now = clock()
        for o in live:
            if o.finish_t is None and o.handle.done:
                o.finish_t = now
        if all(o.finish_t is not None for o in live):
            break
        if now > deadline:
            raise RuntimeError(
                f"replay: streams did not drain within {drain_timeout_s}s"
            )
        _pump()
        sleep(0.002)
    return ReplayReport(outcomes=outcomes, wall_s=clock() - t0)


def summarize(report: ReplayReport) -> dict:
    """Fold a replay into curve points: goodput (tokens of *finished*
    streams per second — shed/rejected/failed work earns nothing),
    latency percentiles over finished streams, and per-class
    admit/shed/reject counts."""
    outs = report.outcomes
    fin = [o for o in outs if o.finished]
    lats = sorted(
        o.finish_t - o.submit_t for o in fin
        if o.finish_t is not None and o.submit_t is not None
    )

    def pct(p: float) -> Optional[float]:
        if not lats:
            return None
        return lats[min(len(lats) - 1, int(p * len(lats)))]

    classes = sorted({o.arrival.priority for o in outs})
    per_class = {}
    for c in classes:
        of_c = [o for o in outs if o.arrival.priority == c]
        per_class[str(c)] = {
            "offered": len(of_c),
            "finished": sum(1 for o in of_c if o.finished),
            "shed": sum(1 for o in of_c if o.shed),
            "rejected": sum(1 for o in of_c if o.rejected),
        }
    # Per-tenant curves (only when the tenant dimension is on): offered
    # / finished / shed / rejected counts, finished-stream tokens, and
    # the tenant's own p99 — the report half of the per-tenant
    # accounting plane.
    tenants = sorted({o.arrival.tenant for o in outs
                      if o.arrival.tenant is not None})
    per_tenant = {}
    for ten in tenants:
        of_t = [o for o in outs if o.arrival.tenant == ten]
        fin_t = [o for o in of_t if o.finished]
        lats_t = sorted(
            o.finish_t - o.submit_t for o in fin_t
            if o.finish_t is not None and o.submit_t is not None
        )
        per_tenant[ten] = {
            "offered": len(of_t),
            "finished": len(fin_t),
            "shed": sum(1 for o in of_t if o.shed),
            "rejected": sum(1 for o in of_t if o.rejected),
            "tokens": sum(len(o.handle.tokens) for o in fin_t),
            "latency_p99_s": (
                lats_t[min(len(lats_t) - 1, int(0.99 * len(lats_t)))]
                if lats_t else None
            ),
        }
    goodput_tokens = sum(len(o.handle.tokens) for o in fin)
    out = {
        "offered": len(outs),
        "finished": len(fin),
        "rejected": sum(1 for o in outs if o.rejected),
        "shed": sum(1 for o in outs if o.shed),
        "goodput_tokens": goodput_tokens,
        "goodput_tps": goodput_tokens / max(report.wall_s, 1e-9),
        "wall_s": report.wall_s,
        "latency_p50_s": pct(0.50),
        "latency_p95_s": pct(0.95),
        "latency_p99_s": pct(0.99),
        "per_class": per_class,
        "retries": sum(max(0, o.attempts - 1) for o in outs),
    }
    if per_tenant:
        out["per_tenant"] = per_tenant
    return out
