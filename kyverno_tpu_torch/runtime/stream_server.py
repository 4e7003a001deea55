"""Streaming admission plane: bidirectional frames, continuous batching.

The webhook plane pays an HTTP request/response + JSON walk per
admission. This module is the columnar front door: a client holds ONE
bidirectional stream open and pipelines admission frames down it;
responses come back tagged with the request id, in completion order.
Arriving admissions join the currently-forming padded batch (the
batcher's ``continuous=True`` late-join graft), so a pipelined burst
coalesces into far fewer device dispatches than the same burst over
HTTP keep-alive.

Two transports share one payload codec, selected at startup:

* **gRPC** (``grpcio`` importable; a machine may lack it, and then
  ``auto`` takes the socket): a
  generic ``/ktpu.StreamAdmission/Admit`` stream-stream method with
  identity (de)serializers — each message IS a payload, no protobuf
  schema compilation step.
* **framed socket**: the same payload behind a ``u32`` little-endian
  length prefix on a plain TCP socket, for environments without grpc.

``KTPU_STREAM_TRANSPORT=grpc|socket|auto`` overrides the selection.

Payload layout (both transports, little-endian)::

    u8 ftype | u64 req_id | body

    ftype may carry F_TRACE_BIT (0x40) on admission frames, in which
    case body is prefixed with u16 tplen|traceparent (cross-process
    trace context; see runtime/tracing.py). Frames without the bit
    decode exactly as before.

    F_ADMIT_JSON  body = AdmissionReview JSON (utf-8)
    F_ADMIT_ROW   body = u16 klen|kind|u16 nslen|ns|encode_packed_row
    F_ADMIT_BLOCK body = u16 klen|kind|u16 nslen|ns|encode_packed_block
    F_VERDICT     body = response JSON (utf-8)
    F_ERROR       body = error message (utf-8)

The three admission kinds trade generality for copies:

* JSON frames delegate to ``WebhookServer.handle`` — verdicts AND
  messages are exact-parity with the webhook by construction (same
  code path, minus HTTP).
* ROW frames carry a client-tokenized ``PackedRow``; the server
  splices it into the forming batch without re-parsing (it pays one
  (bytes, len)-keyed re-intern at the splice).
* BLOCK frames carry a whole client-tokenized ``PackedBatch`` that is
  already the device transfer format: zero per-row re-intern, zero row
  rebuild, dispatched with input-buffer donation.
"""

from __future__ import annotations

import json
import queue
import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from ..models import Verdict
from . import featureplane, tracing
from .batch import CLEAN
from .policycache import PolicyType
from .webhook import VALIDATING_WEBHOOK_PATH

F_ADMIT_JSON = 0x01
F_ADMIT_ROW = 0x02
F_ADMIT_BLOCK = 0x03
F_VERDICT = 0x81
F_ERROR = 0x7F

# Fleet verdict-fabric frames (fleet/fabric.py) share this codec: the
# request types live below 0x40 and the reply types above 0x80 so
# neither collides with F_TRACE_BIT masking (only _TRACEABLE admission
# types honor the bit) or with F_ERROR's numeric bit pattern. Bodies
# are tier/key/value encodings owned by fleet/fabric.py.
F_CACHE_GET = 0x10
F_CACHE_PUT = 0x11
F_CACHE_INVALIDATE = 0x12
F_CACHE_OK = 0x82
F_CACHE_MISS = 0x83

# Optional trace-context carriage: admission frames may set this bit on
# ftype, in which case the body is prefixed with ``u16 tplen|traceparent``
# (runtime/tracing.py W3C-style rendering). The bit is only honored when
# the masked type is an admission frame, so F_ERROR (0x7F, which has the
# bit set numerically) and foreign frame types decode unchanged; servers
# that predate the bit reject flagged frames as unknown types rather than
# mis-parsing them.
F_TRACE_BIT = 0x40
_TRACEABLE = (F_ADMIT_JSON, F_ADMIT_ROW, F_ADMIT_BLOCK)

_PAYLOAD_HDR = struct.Struct("<BQ")
_LEN_PREFIX = struct.Struct("<I")
_U16 = struct.Struct("<H")

GRPC_METHOD = "/ktpu.StreamAdmission/Admit"

MAX_FRAME_BYTES = 64 * 1024 * 1024  # defensive bound on one frame


def transport_preference() -> str:
    """grpc | socket | auto (the startup selection knob)."""
    return featureplane.raw("KTPU_STREAM_TRANSPORT")


# ------------------------------------------------------------------ codec


def encode_payload(ftype: int, req_id: int, body: bytes,
                   traceparent: str | None = None) -> bytes:
    if traceparent and ftype in _TRACEABLE:
        tp = traceparent.encode("ascii")
        return b"".join((_PAYLOAD_HDR.pack(ftype | F_TRACE_BIT, req_id),
                         _U16.pack(len(tp)), tp, body))
    return _PAYLOAD_HDR.pack(ftype, req_id) + body


def decode_payload_ex(payload: bytes) -> tuple[int, int, bytes, str | None]:
    """(ftype, req_id, body, traceparent-or-None). Raises ValueError on a
    short payload. A flagged frame whose trace prefix is truncated keeps
    its raw (flagged) ftype and body — the caller's unknown-type path
    then rejects it with the req_id intact instead of losing the frame
    to a parse exception."""
    if len(payload) < _PAYLOAD_HDR.size:
        raise ValueError(f"short payload: {len(payload)} bytes")
    ftype, req_id = _PAYLOAD_HDR.unpack_from(payload, 0)
    off = _PAYLOAD_HDR.size
    tp = None
    if ftype & F_TRACE_BIT and (ftype & ~F_TRACE_BIT) in _TRACEABLE:
        if len(payload) >= off + _U16.size:
            (tplen,) = _U16.unpack_from(payload, off)
            if len(payload) >= off + _U16.size + tplen:
                ftype &= ~F_TRACE_BIT
                off += _U16.size
                tp = bytes(payload[off:off + tplen]).decode(
                    "ascii", "replace")
                off += tplen
    return ftype, req_id, payload[off:], tp


def decode_payload(payload: bytes) -> tuple[int, int, bytes]:
    """(ftype, req_id, body). Raises ValueError on a short payload."""
    ftype, req_id, body, _ = decode_payload_ex(payload)
    return ftype, req_id, body


def _encode_scoped(kind: str, namespace: str, blob: bytes) -> bytes:
    k = kind.encode("utf-8")
    ns = namespace.encode("utf-8")
    return b"".join((_U16.pack(len(k)), k, _U16.pack(len(ns)), ns, blob))


def _decode_scoped(body: bytes) -> tuple[str, str, bytes, int]:
    """(kind, namespace, rest, rest_offset_into_body)."""
    (klen,) = _U16.unpack_from(body, 0)
    off = _U16.size
    kind = bytes(body[off:off + klen]).decode("utf-8")
    off += klen
    (nslen,) = _U16.unpack_from(body, off)
    off += _U16.size
    namespace = bytes(body[off:off + nslen]).decode("utf-8")
    off += nslen
    return kind, namespace, body, off


def encode_row_frame(req_id: int, kind: str, namespace: str, row,
                     traceparent: str | None = None) -> bytes:
    from ..models.flatten import encode_packed_row

    return encode_payload(F_ADMIT_ROW, req_id,
                          _encode_scoped(kind, namespace,
                                         encode_packed_row(row)),
                          traceparent=traceparent)


def encode_block_frame(req_id: int, kind: str, namespace: str,
                       block, traceparent: str | None = None) -> bytes:
    from ..models.flatten import encode_packed_block

    return encode_payload(F_ADMIT_BLOCK, req_id,
                          _encode_scoped(kind, namespace,
                                         encode_packed_block(block)),
                          traceparent=traceparent)


def encode_json_frame(req_id: int, review: dict,
                      traceparent: str | None = None) -> bytes:
    return encode_payload(F_ADMIT_JSON, req_id,
                          json.dumps(review).encode("utf-8"),
                          traceparent=traceparent)


def decode_verdict_frame(payload: bytes) -> tuple[int, dict]:
    """(req_id, decoded response) for one server reply frame. F_ERROR
    raises RuntimeError with the server's message; any other frame type
    raises ValueError. In-process consumers (tests, a replay of
    recorded traffic) share this instead of re-implementing the unwrap."""
    ftype, req_id, body, _ = decode_payload_ex(payload)
    if ftype == F_VERDICT:
        return req_id, json.loads(body)
    if ftype == F_ERROR:
        raise RuntimeError(body.decode("utf-8", "replace"))
    raise ValueError(f"unexpected reply frame type {ftype:#x}")


# ------------------------------------------------------- client-side prep


def flatten_rows_for_wire(cps, resources: list[dict]):
    """Client-side tokenization for ROW frames: flatten against the
    compiled set's schema and split into per-resource PackedRows (each
    with a private rebased string table, ready to re-intern anywhere)."""
    from ..models.flatten import split_packed_rows

    return split_packed_rows(cps.flatten_packed(resources))


def flatten_block_for_wire(cps, resources: list[dict]):
    """Client-side tokenization for a BLOCK frame: one PackedBatch that
    is already the server's device transfer format."""
    return cps.flatten_packed(resources)


# ------------------------------------------------------------------ plane


class StreamAdmissionPlane:
    """Transport-independent frame handler.

    One instance serves every connection/stream of a server; it owns no
    sockets — transports call :meth:`handle_payload` from their worker
    pools and write back whatever it returns.
    """

    def __init__(self, webhook, batcher, policy_cache,
                 ptype: PolicyType = PolicyType.VALIDATE_ENFORCE):
        self.webhook = webhook
        self.batcher = batcher
        self.policy_cache = policy_cache
        self.ptype = ptype
        self.stats: dict = {}
        self._lock = threading.Lock()

    # -- helpers

    def _note(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.stats[key] = self.stats.get(key, 0) + n

    @staticmethod
    def _row_response(status: str, vrow) -> dict:
        escalate = (status != CLEAN and not vrow) or any(
            t[2] in (Verdict.HOST, Verdict.ERROR) for t in vrow)
        denied = any(t[2] is Verdict.FAIL for t in vrow)
        return {
            "status": status,
            "allowed": not escalate and not denied,
            "escalate": escalate,
            "verdicts": [[pn, rn, int(v), msg] for pn, rn, v, msg in vrow],
        }

    def handle_payload(self, payload: bytes, transport: str) -> bytes:
        """Decode one admission frame, run it, return the response
        payload. Never raises — errors come back as F_ERROR frames."""
        t_in = time.perf_counter()
        req_id = 0
        rec = tracing.recorder()
        trace = rec.start("stream_admission", transport=transport)
        tok = tracing.bind(trace)
        ftype_name = "unknown"
        rows = 1
        error = False
        try:
            ftype, req_id, body, tp = decode_payload_ex(payload)
            if tp:
                tracing.adopt_remote_id(trace,
                                        tracing.parse_traceparent(tp))
            rec.add_span(trace, "stream_ingest", t_in, time.perf_counter(),
                         bytes=len(payload), transport=transport)
            if ftype == F_ADMIT_JSON:
                ftype_name = "json"
                review = json.loads(body)
                out = self.webhook.handle(VALIDATING_WEBHOOK_PATH, review)
                self._note("json_frames")
                return encode_payload(F_VERDICT, req_id,
                                      json.dumps(out).encode("utf-8"))
            if ftype == F_ADMIT_ROW:
                ftype_name = "row"
                from ..models.flatten import decode_packed_row

                kind, namespace, buf, off = _decode_scoped(body)
                row, _ = decode_packed_row(buf, off)
                if trace is not None:
                    trace.labels.update(kind=kind, namespace=namespace)
                status, vrow = self.batcher.screen_row(
                    self.ptype, kind, namespace, row)
                self._note("row_frames")
                return encode_payload(
                    F_VERDICT, req_id,
                    json.dumps(self._row_response(status, vrow))
                    .encode("utf-8"))
            if ftype == F_ADMIT_BLOCK:
                ftype_name = "block"
                from ..models.flatten import decode_packed_block

                kind, namespace, buf, off = _decode_scoped(body)
                block, _ = decode_packed_block(buf, off)
                if trace is not None:
                    trace.labels.update(kind=kind, namespace=namespace)
                results = self.batcher.evaluate_block(
                    self.ptype, kind, namespace, block)
                if results is None:
                    error = True
                    self._note("block_errors")
                    return encode_payload(F_ERROR, req_id,
                                          b"block evaluation failed")
                rows = max(1, len(results))
                self._note("block_frames")
                self._note("block_rows", len(results))
                out = {"rows": [self._row_response(st, vr)
                                for st, vr in results]}
                return encode_payload(F_VERDICT, req_id,
                                      json.dumps(out).encode("utf-8"))
            error = True
            return encode_payload(F_ERROR, req_id,
                                  f"unknown frame type {ftype:#x}"
                                  .encode("utf-8"))
        except Exception as exc:  # codec/handler failure — never raise
            error = True
            self._note("frame_errors")
            return encode_payload(F_ERROR, req_id,
                                  f"{type(exc).__name__}: {exc}"
                                  .encode("utf-8"))
        finally:
            tracing.unbind(tok)
            rec.finish(trace)
            if ftype_name in ("row", "block") and not error:
                # JSON frames route through webhook._handle, which
                # already feeds the watchdog; row/block frames are the
                # only admissions that bypass it
                try:
                    from .slo import watchdog

                    watchdog().observe(time.perf_counter() - t_in)
                except Exception:
                    pass
            try:
                from . import metrics as metrics_mod

                reg = metrics_mod.registry()
                metrics_mod.record_stream_frame(
                    reg, ftype_name, transport,
                    seconds=time.perf_counter() - t_in, rows=rows,
                    error=error)
                if ftype_name == "row" and not error:
                    metrics_mod.record_stream_zero_copy(reg, wire_rows=1)
                elif ftype_name == "block" and not error:
                    metrics_mod.record_stream_zero_copy(reg,
                                                        block_rows=rows,
                                                        donated=1)
            except Exception:
                pass


# ------------------------------------------------------------- transports


def _read_exact(sock: socket.socket, n: int) -> bytes | None:
    """Read exactly n bytes or None on EOF."""
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            return None
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _set_open_streams(delta: int, counter=[0],
                      lock=threading.Lock()) -> None:
    try:
        from . import metrics as metrics_mod

        with lock:
            counter[0] += delta
            n = counter[0]
        metrics_mod.record_stream_gauges(metrics_mod.registry(),
                                         open_streams=n)
    except Exception:
        pass


class _SocketTransport:
    """Length-prefixed frames over TCP; one reader thread per
    connection, responses written in completion order under a per-
    connection write lock (frames interleave safely — req_id pairs
    them back up client-side)."""

    name = "socket"

    def __init__(self, plane: StreamAdmissionPlane, host: str, port: int,
                 workers: int = 16):
        self._plane = plane
        self._srv = socket.create_server((host, port))
        self._port = self._srv.getsockname()[1]
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="ktpu-stream")
        self._accept_thread: threading.Thread | None = None
        self._stopped = threading.Event()

    @property
    def port(self) -> int:
        return self._port

    def start(self) -> None:
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True,
                                               name="ktpu-stream-accept")
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        wlock = threading.Lock()
        _set_open_streams(+1)

        def _respond(payload: bytes) -> None:
            try:
                resp = self._plane.handle_payload(payload, "socket")
                with wlock:
                    conn.sendall(_LEN_PREFIX.pack(len(resp)) + resp)
            except OSError:
                pass

        try:
            while not self._stopped.is_set():
                hdr = _read_exact(conn, _LEN_PREFIX.size)
                if hdr is None:
                    return
                (ln,) = _LEN_PREFIX.unpack(hdr)
                if ln > MAX_FRAME_BYTES:
                    return
                payload = _read_exact(conn, ln)
                if payload is None:
                    return
                # hand off immediately: the reader keeps draining so a
                # pipelined burst is concurrently in flight — that
                # concurrency is what the continuous batcher coalesces
                self._pool.submit(_respond, payload)
        except OSError:
            pass
        finally:
            _set_open_streams(-1)
            try:
                conn.close()
            except OSError:
                pass

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._srv.close()
        except OSError:
            pass
        self._pool.shutdown(wait=False)


class _GrpcTransport:
    """Bidirectional stream-stream RPC with identity serializers: each
    gRPC message is one payload (no length prefix — HTTP/2 frames it).
    Requests fan out to a worker pool so pipelined messages on one
    stream process concurrently; responses yield in completion order."""

    name = "grpc"

    def __init__(self, plane: StreamAdmissionPlane, host: str, port: int,
                 workers: int = 16):
        import grpc

        self._plane = plane
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="ktpu-grpc")
        self._server = grpc.server(
            ThreadPoolExecutor(max_workers=workers))
        service = GRPC_METHOD.rsplit("/", 2)[1]
        method = GRPC_METHOD.rsplit("/", 1)[1]
        handler = grpc.method_handlers_generic_handler(service, {
            method: grpc.stream_stream_rpc_method_handler(
                self._admit,
                request_deserializer=None,
                response_serializer=None),
        })
        self._server.add_generic_rpc_handlers((handler,))
        self._port = self._server.add_insecure_port(f"{host}:{port}")

    @property
    def port(self) -> int:
        return self._port

    def start(self) -> None:
        self._server.start()

    def _admit(self, request_iterator, context):
        out_q: queue.Queue = queue.Queue()
        sentinel = object()
        _set_open_streams(+1)

        def _one(payload: bytes) -> None:
            try:
                out_q.put(self._plane.handle_payload(payload, "grpc"))
            except Exception as exc:
                out_q.put(encode_payload(
                    F_ERROR, 0, f"{type(exc).__name__}: {exc}"
                    .encode("utf-8")))

        def _pump() -> None:
            futs = []
            try:
                for payload in request_iterator:
                    futs.append(self._pool.submit(_one, payload))
            except Exception:
                pass
            for f in futs:
                try:
                    f.result()
                except Exception:
                    pass
            out_q.put(sentinel)

        threading.Thread(target=_pump, daemon=True,
                         name="ktpu-grpc-pump").start()
        try:
            while True:
                item = out_q.get()
                if item is sentinel:
                    return
                yield item
        finally:
            _set_open_streams(-1)

    def stop(self) -> None:
        self._server.stop(grace=0.5)
        self._pool.shutdown(wait=False)


class StreamServer:
    """Transport-selecting front door for the streaming plane.

    ``transport`` = "grpc" | "socket" | "auto" (default: the
    ``KTPU_STREAM_TRANSPORT`` env knob, itself defaulting to auto —
    grpc when importable, else the framed socket)."""

    def __init__(self, webhook, batcher, policy_cache,
                 host: str = "127.0.0.1", port: int = 0,
                 transport: str | None = None,
                 ptype: PolicyType = PolicyType.VALIDATE_ENFORCE,
                 workers: int = 16):
        self.plane = StreamAdmissionPlane(webhook, batcher, policy_cache,
                                          ptype=ptype)
        choice = transport or transport_preference()
        self._transport = None
        if choice in ("auto", "grpc"):
            try:
                self._transport = _GrpcTransport(self.plane, host, port,
                                                 workers=workers)
            except Exception:
                if choice == "grpc":
                    raise
        if self._transport is None:
            self._transport = _SocketTransport(self.plane, host, port,
                                               workers=workers)

    @property
    def transport_name(self) -> str:
        return self._transport.name

    @property
    def port(self) -> int:
        return self._transport.port

    def start(self) -> "StreamServer":
        self._transport.start()
        return self

    def stop(self) -> None:
        self._transport.stop()


# ------------------------------------------------------------------ client


class StreamClient:
    """Pipelining client for both transports.

    ``submit_*`` returns a req_id immediately; :meth:`result` blocks for
    that response. ``admit_*`` are the submit+wait conveniences. Thread-
    safe; a single instance can keep hundreds of admissions in flight —
    that open-loop pipelining is what the stream plane batches."""

    def __init__(self, port: int, host: str = "127.0.0.1",
                 transport: str = "socket"):
        self.transport = transport
        self._lock = threading.Lock()
        self._next_id = 1
        self._waiters: dict[int, queue.Queue] = {}
        # req_id -> (caller's trace, t_submit, t_sent): client-side span
        # bookkeeping so result() can split queue wait from service time
        self._traces: dict[int, tuple] = {}
        if transport == "grpc":
            import grpc

            self._channel = grpc.insecure_channel(f"{host}:{port}")
            self._call = self._channel.stream_stream(
                GRPC_METHOD, request_serializer=None,
                response_deserializer=None)
            self._sendq: queue.Queue = queue.Queue()

            def _feed():
                while True:
                    item = self._sendq.get()
                    if item is None:
                        return
                    yield item

            self._responses = self._call(_feed())
        else:
            self._sock = socket.create_connection((host, port))
            self._sock.setsockopt(socket.IPPROTO_TCP,
                                  socket.TCP_NODELAY, 1)
            self._wlock = threading.Lock()
        self._reader = threading.Thread(target=self._read_loop,
                                        daemon=True,
                                        name="ktpu-stream-client")
        self._reader.start()

    # -- low-level

    def _register(self) -> tuple[int, queue.Queue]:
        with self._lock:
            req_id = self._next_id
            self._next_id += 1
            q: queue.Queue = queue.Queue(maxsize=1)
            self._waiters[req_id] = q
        return req_id, q

    def _send(self, payload: bytes) -> None:
        if self.transport == "grpc":
            self._sendq.put(payload)
        else:
            with self._wlock:
                self._sock.sendall(_LEN_PREFIX.pack(len(payload))
                                   + payload)

    def _read_loop(self) -> None:
        try:
            if self.transport == "grpc":
                for payload in self._responses:
                    self._dispatch(bytes(payload))
            else:
                while True:
                    hdr = _read_exact(self._sock, _LEN_PREFIX.size)
                    if hdr is None:
                        return
                    (ln,) = _LEN_PREFIX.unpack(hdr)
                    payload = _read_exact(self._sock, ln)
                    if payload is None:
                        return
                    self._dispatch(payload)
        except Exception:
            # connection torn down — wake every waiter with an error
            with self._lock:
                waiters = list(self._waiters.values())
                self._waiters.clear()
            for q in waiters:
                q.put((F_ERROR, b"connection closed"))

    def _dispatch(self, payload: bytes) -> None:
        ftype, req_id, body = decode_payload(payload)
        with self._lock:
            q = self._waiters.get(req_id)
        if q is not None:
            q.put((ftype, bytes(body)))

    def _track(self, req_id: int, t_submit: float) -> None:
        trace = tracing.current()
        if trace is not None:
            with self._lock:
                self._traces[req_id] = (trace, t_submit,
                                        time.perf_counter())

    # -- public API

    def submit_json(self, review: dict) -> int:
        req_id, _ = self._register()
        t0 = time.perf_counter()
        self._send(encode_json_frame(
            req_id, review,
            traceparent=tracing.make_traceparent(tracing.current())))
        self._track(req_id, t0)
        return req_id

    def submit_row(self, kind: str, namespace: str, row) -> int:
        req_id, _ = self._register()
        t0 = time.perf_counter()
        self._send(encode_row_frame(
            req_id, kind, namespace, row,
            traceparent=tracing.make_traceparent(tracing.current())))
        self._track(req_id, t0)
        return req_id

    def submit_block(self, kind: str, namespace: str, block) -> int:
        req_id, _ = self._register()
        t0 = time.perf_counter()
        self._send(encode_block_frame(
            req_id, kind, namespace, block,
            traceparent=tracing.make_traceparent(tracing.current())))
        self._track(req_id, t0)
        return req_id

    def result(self, req_id: int, timeout: float = 30.0) -> dict:
        """Blocking response fetch; raises RuntimeError on an F_ERROR
        frame or timeout."""
        with self._lock:
            q = self._waiters.get(req_id)
        if q is None:
            # response may already have been dispatched and consumed, or
            # the id was never issued
            raise RuntimeError(f"unknown or already-consumed req_id "
                               f"{req_id}")
        try:
            ftype, body = q.get(timeout=timeout)
        except queue.Empty:
            raise RuntimeError(f"stream response timeout (req {req_id})")
        finally:
            with self._lock:
                self._waiters.pop(req_id, None)
                tracked = self._traces.pop(req_id, None)
            if tracked is not None:
                trace, t_submit, t_sent = tracked
                rec = tracing.recorder()
                rec.add_span(trace, "client_enqueue", t_submit, t_sent,
                             req_id=str(req_id),
                             transport=self.transport)
                rec.add_span(trace, "client_service", t_sent,
                             time.perf_counter(), req_id=str(req_id),
                             transport=self.transport)
        if ftype == F_ERROR:
            raise RuntimeError(body.decode("utf-8", "replace"))
        return json.loads(body)

    def admit_json(self, review: dict, timeout: float = 30.0) -> dict:
        return self.result(self.submit_json(review), timeout=timeout)

    def admit_row(self, kind: str, namespace: str, row,
                  timeout: float = 30.0) -> dict:
        return self.result(self.submit_row(kind, namespace, row),
                           timeout=timeout)

    def admit_block(self, kind: str, namespace: str, block,
                    timeout: float = 30.0) -> dict:
        return self.result(self.submit_block(kind, namespace, block),
                           timeout=timeout)

    def close(self) -> None:
        if self.transport == "grpc":
            try:
                self._sendq.put(None)
                self._call = None
                self._channel.close()
            except Exception:
                pass
        else:
            try:
                self._sock.close()
            except OSError:
                pass
