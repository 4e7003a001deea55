"""Audit-trace schema, churn synthesizer, and flight-ring importer.

The trace is the workload plane's interchange format: a header line,
a body store, and an event stream, all newline-delimited JSON so traces
diff/grep/append cleanly and stream without loading the world.

    {"t":"hdr","schema_version":1,"meta":{...}}
    {"t":"body","d":"<digest>","body":{...}}
    {"t":"ev","op":"CREATE","ts":0.0132,"ns":"team-0","kind":"Pod",
     "name":"app-0-1","d":"<digest>"}

Bodies are content-addressed by digest and stored once — a realistic
cluster re-submits the same pod template thousands of times, and the
repeated-body distribution is exactly what the admission result cache
and flatten-row memos exploit, so the trace must preserve it rather
than synthesize distinct bodies per event. ``ts`` is seconds from trace
start; the replay driver multiplies it by 1/speed (or ignores it at max
speed). ``op`` is CREATE/UPDATE/DELETE for resources and POLICY for
interleaved policy churn (the body is then a ClusterPolicy doc).
"""

from __future__ import annotations

import hashlib
import json
import random
from dataclasses import dataclass, field

TRACE_SCHEMA_VERSION = 1

OPS = ("CREATE", "UPDATE", "DELETE", "POLICY")


def body_digest(body: dict) -> str:
    """Content address of one resource body: sha256 over the canonical
    (sorted-key, compact) JSON serialization, truncated to 16 hex chars
    — collision-safe at trace scale and short enough to not dominate
    event lines."""
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


@dataclass
class TraceEvent:
    op: str                     # CREATE | UPDATE | DELETE | POLICY
    ts: float                   # seconds from trace start
    namespace: str
    kind: str
    name: str
    digest: str                 # body-store key

    def to_line(self) -> dict:
        return {"t": "ev", "op": self.op, "ts": round(self.ts, 6),
                "ns": self.namespace, "kind": self.kind,
                "name": self.name, "d": self.digest}


@dataclass
class WorkloadTrace:
    """In-memory trace: metadata, the deduplicated body store, and the
    event stream in arrival order."""

    meta: dict = field(default_factory=dict)
    bodies: dict = field(default_factory=dict)   # digest -> body
    events: list = field(default_factory=list)   # list[TraceEvent]

    def append(self, op: str, ts: float, body: dict,
               kind: str | None = None) -> TraceEvent:
        if op not in OPS:
            raise ValueError(f"unknown trace op {op!r}")
        d = body_digest(body)
        self.bodies.setdefault(d, body)
        meta = body.get("metadata") or {}
        ev = TraceEvent(op=op, ts=float(ts),
                        namespace=meta.get("namespace", ""),
                        kind=kind or body.get("kind", ""),
                        name=meta.get("name", ""), digest=d)
        self.events.append(ev)
        return ev

    def body_of(self, ev: TraceEvent) -> dict:
        return self.bodies[ev.digest]

    # ------------------------------------------------------------ summary

    def stats(self) -> dict:
        by_op: dict[str, int] = {}
        by_ns: dict[str, int] = {}
        for ev in self.events:
            by_op[ev.op] = by_op.get(ev.op, 0) + 1
            if ev.op != "POLICY":
                by_ns[ev.namespace] = by_ns.get(ev.namespace, 0) + 1
        return {
            "events": len(self.events),
            "distinct_bodies": len(self.bodies),
            "namespaces": len(by_ns),
            "by_op": by_op,
            "by_namespace": by_ns,
            "duration_s": round(self.events[-1].ts, 6) if self.events
            else 0.0,
        }

    def content_digest(self) -> str:
        """Stable identity of the whole trace (for run manifests): the
        event stream hashes in order, the body store by sorted digest —
        byte-identical traces replayed in different sessions diff as
        equal."""
        h = hashlib.sha256()
        for d in sorted(self.bodies):
            h.update(d.encode())
        for ev in self.events:
            h.update(json.dumps(ev.to_line(), sort_keys=True,
                                separators=(",", ":")).encode())
        return h.hexdigest()[:16]

    # -------------------------------------------------------------- JSONL

    def write_jsonl(self, path: str) -> None:
        """Stream the trace to ``path``. Each body is written once,
        immediately before its first referencing event, so a reader can
        process the file in one pass with only the body store resident."""
        written: set[str] = set()
        with open(path, "w") as f:
            f.write(json.dumps({"t": "hdr",
                                "schema_version": TRACE_SCHEMA_VERSION,
                                "meta": self.meta}) + "\n")
            for ev in self.events:
                if ev.digest not in written:
                    written.add(ev.digest)
                    f.write(json.dumps({"t": "body", "d": ev.digest,
                                        "body": self.bodies[ev.digest]},
                                       separators=(",", ":")) + "\n")
                f.write(json.dumps(ev.to_line(),
                                   separators=(",", ":")) + "\n")

    @classmethod
    def read_jsonl(cls, path: str) -> "WorkloadTrace":
        tr = cls()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                t = rec.get("t")
                if t == "hdr":
                    ver = rec.get("schema_version")
                    if ver != TRACE_SCHEMA_VERSION:
                        raise ValueError(
                            f"trace schema_version {ver} != "
                            f"{TRACE_SCHEMA_VERSION}")
                    tr.meta = rec.get("meta") or {}
                elif t == "body":
                    tr.bodies[rec["d"]] = rec["body"]
                elif t == "ev":
                    tr.events.append(TraceEvent(
                        op=rec["op"], ts=float(rec["ts"]),
                        namespace=rec.get("ns", ""),
                        kind=rec.get("kind", ""),
                        name=rec.get("name", ""), digest=rec["d"]))
        return tr


# -------------------------------------------------------------- synthesis


def _default_body(namespace: str, name: str, variant: int) -> dict:
    """One synthetic Pod; ``variant`` selects the template from the
    repeated-body pool (the trace's distinct-body dimension). Every
    fourth template ships a ``:latest`` image so standard disallow-tag
    policies produce a mixed verdict stream — an all-PASS trace would
    make cross-leg parity checks vacuous."""
    tag = "latest" if variant % 4 == 3 else f"v{variant % 7}"
    return {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": name, "namespace": namespace,
                     "labels": {"app": f"app-{variant}",
                                "team": namespace}},
        "spec": {"containers": [{
            "name": "main",
            "image": f"registry.local/app-{variant}:{tag}",
        }]},
    }


def synthesize(events: int = 1000, namespaces: int = 8,
               zipf_s: float = 1.1, distinct_bodies: int = 32,
               update_fraction: float = 0.25,
               delete_fraction: float = 0.05,
               base_rate: float = 200.0, storm_factor: float = 8.0,
               storm_period: int = 400, storm_duty: float = 0.25,
               policy_docs: list | None = None,
               policy_churn_every: int = 0, name_pool: int = 0,
               seed: int = 0, make_body=None) -> WorkloadTrace:
    """Parameterized churn generator.

    Arrival times follow a Poisson clock at ``base_rate`` events/s,
    multiplied by ``storm_factor`` during the first ``storm_duty``
    fraction of every ``storm_period``-event window — create/update
    storms with quiet tails, the shape that stresses open-loop queueing.
    Namespace choice is Zipf(``zipf_s``) over rank, so a handful of hot
    namespaces dominate (per-namespace caches and attribution see skew,
    not uniformity). Bodies draw from a pool of ``distinct_bodies``
    templates whose popularity is also Zipf — most events re-submit a
    hot template, exercising digest dedup end to end. ``policy_docs``
    interleave as POLICY events every ``policy_churn_every`` resource
    events (0 = no churn). ``name_pool`` > 0 draws create names from a
    bounded pool — controller-recreated pods with stable names, which
    makes whole *bodies* repeat (the distribution the body store and
    the admission result cache dedup); 0 keeps every created name
    unique. Deterministic for a given ``seed``.
    """
    rng = random.Random(seed)
    tr = WorkloadTrace(meta={
        "generator": "synthesize", "seed": seed, "events": events,
        "namespaces": namespaces, "zipf_s": zipf_s,
        "distinct_bodies": distinct_bodies,
        "update_fraction": update_fraction,
        "delete_fraction": delete_fraction, "base_rate": base_rate,
        "storm_factor": storm_factor, "storm_period": storm_period,
        "storm_duty": storm_duty,
        "policy_churn_every": policy_churn_every,
        "name_pool": name_pool,
    })
    make_body = make_body or _default_body

    ns_names = [f"team-{i}" for i in range(namespaces)]
    ns_weights = [1.0 / (rank + 1) ** zipf_s for rank in range(namespaces)]
    body_weights = [1.0 / (rank + 1) ** zipf_s
                    for rank in range(max(1, distinct_bodies))]

    live: dict[str, list[str]] = {ns: [] for ns in ns_names}
    t = 0.0
    serial = 0
    policy_cursor = 0
    for i in range(events):
        in_storm = (storm_period > 0
                    and (i % storm_period) < storm_duty * storm_period)
        rate = base_rate * (storm_factor if in_storm else 1.0)
        t += rng.expovariate(rate)

        if (policy_churn_every and policy_docs
                and i and i % policy_churn_every == 0):
            doc = policy_docs[policy_cursor % len(policy_docs)]
            policy_cursor += 1
            tr.append("POLICY", t, doc, kind="ClusterPolicy")

        ns = rng.choices(ns_names, weights=ns_weights)[0]
        roll = rng.random()
        if roll < delete_fraction and live[ns]:
            name = live[ns].pop(rng.randrange(len(live[ns])))
            variant = rng.choices(range(max(1, distinct_bodies)),
                                  weights=body_weights)[0]
            tr.append("DELETE", t, make_body(ns, name, variant))
        elif roll < delete_fraction + update_fraction and live[ns]:
            name = live[ns][rng.randrange(len(live[ns]))]
            variant = rng.choices(range(max(1, distinct_bodies)),
                                  weights=body_weights)[0]
            tr.append("UPDATE", t, make_body(ns, name, variant))
        else:
            if name_pool:
                name = f"app-{rng.randrange(name_pool)}"
                if name not in live[ns]:
                    live[ns].append(name)
            else:
                name = f"app-{serial}"
                serial += 1
                live[ns].append(name)
            variant = rng.choices(range(max(1, distinct_bodies)),
                                  weights=body_weights)[0]
            tr.append("CREATE", t, make_body(ns, name, variant))
    return tr


# ---------------------------------------------------------------- import


def import_flight_ring(traces=None) -> WorkloadTrace:
    """Convert recorded admission traffic (the span recorder's flight ring) into a
    WorkloadTrace.

    The ring keeps labels (kind/namespace/operation/uid), wall start and
    duration — not request bodies — so imported events carry a skeleton
    body reconstructed from the labels (marked ``reconstructed`` in the
    trace meta; replaying one exercises arrival shape and routing, not
    byte-exact validation). Ring order is preserved; timestamps rebase
    to seconds from the first admission's wall start.
    """
    if traces is None:
        from ..runtime import tracing

        traces = tracing.recorder().traces(0)
    admissions = [t for t in traces
                  if t.kind in ("admission", "stream_admission")]
    admissions.sort(key=lambda t: t.t_wall)
    tr = WorkloadTrace(meta={"generator": "flight_ring",
                             "reconstructed": True,
                             "ring_traces": len(admissions)})
    if not admissions:
        return tr
    t0 = admissions[0].t_wall
    for t in admissions:
        labels = t.labels or {}
        op = str(labels.get("operation", "CREATE")).upper()
        if op not in ("CREATE", "UPDATE", "DELETE"):
            op = "CREATE"
        kind = str(labels.get("kind", "Pod")) or "Pod"
        ns = str(labels.get("namespace", ""))
        uid = str(labels.get("uid", t.trace_id))
        body = {
            "apiVersion": "v1", "kind": kind,
            "metadata": {"name": uid[:24] or "imported",
                         "namespace": ns, "uid": uid},
        }
        tr.append(op, max(0.0, t.t_wall - t0), body, kind=kind)
    return tr
