"""Minimal ECDSA P-256 (secp256r1) for cosign signature envelopes.

The reference links the cosign/sigstore crypto stack
(kyverno/pkg/cosign/cosign.go); the deployable subset it actually
exercises for key-based verification is "ECDSA-P256-SHA256 over a payload
blob, DER-encoded signature, SPKI PEM public key". That fits in one
dependency-free module: point arithmetic on P-256, SHA-256 via hashlib,
DER/PEM codecs. Signing exists for tests and the CLI's local trust store;
verification is the production path. Performance is irrelevant here —
admission verifies a handful of signatures per request, each ~1ms.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import secrets

# ------------------------------------------------------------ curve P-256

P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
A = P - 3
B = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B
N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
GX = 0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296
GY = 0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5


def _inv(x: int, m: int) -> int:
    return pow(x, -1, m)


def _add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and (y1 + y2) % P == 0:
        return None
    if p1 == p2:
        lam = (3 * x1 * x1 + A) * _inv(2 * y1, P) % P
    else:
        lam = (y2 - y1) * _inv((x2 - x1) % P, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return x3, (lam * (x1 - x3) - y1) % P


def _mul(k: int, point):
    out = None
    addend = point
    while k:
        if k & 1:
            out = _add(out, addend)
        addend = _add(addend, addend)
        k >>= 1
    return out


def on_curve(point) -> bool:
    if point is None:
        return False
    x, y = point
    return (y * y - (x * x * x + A * x + B)) % P == 0


# ---------------------------------------------------------------- DER/PEM


def _der_len(buf: bytes, i: int) -> tuple[int, int]:
    first = buf[i]
    i += 1
    if first < 0x80:
        return first, i
    n = first & 0x7F
    return int.from_bytes(buf[i:i + n], "big"), i + n


def der_decode_signature(sig: bytes) -> tuple[int, int]:
    """SEQUENCE { INTEGER r, INTEGER s } -> (r, s)."""
    if not sig or sig[0] != 0x30:
        raise ValueError("bad DER signature")
    _, i = _der_len(sig, 1)
    out = []
    for _ in range(2):
        if sig[i] != 0x02:
            raise ValueError("bad DER integer")
        ln, i = _der_len(sig, i + 1)
        out.append(int.from_bytes(sig[i:i + ln], "big"))
        i += ln
    return out[0], out[1]


def der_encode_signature(r: int, s: int) -> bytes:
    def integer(v: int) -> bytes:
        body = v.to_bytes((v.bit_length() + 7) // 8 or 1, "big")
        if body[0] & 0x80:
            body = b"\x00" + body
        return b"\x02" + bytes([len(body)]) + body

    body = integer(r) + integer(s)
    return b"\x30" + bytes([len(body)]) + body


_SPKI_EC_P256 = bytes.fromhex(
    # SEQUENCE { SEQUENCE { OID ecPublicKey, OID prime256v1 }, BIT STRING
    "3059301306072a8648ce3d020106082a8648ce3d030107034200"
)


def load_public_key_pem(pem: str) -> tuple[int, int]:
    """SPKI PEM -> curve point. Only uncompressed P-256 keys (what
    ``cosign generate-key-pair`` emits)."""
    body = "".join(
        line for line in pem.strip().splitlines()
        if not line.startswith("-----"))
    der = base64.b64decode(body)
    if not der.startswith(_SPKI_EC_P256) or len(der) < len(_SPKI_EC_P256) + 65:
        raise ValueError("unsupported public key (want SPKI ECDSA P-256)")
    raw = der[len(_SPKI_EC_P256):]
    if raw[0] != 0x04:
        raise ValueError("unsupported EC point encoding")
    point = (int.from_bytes(raw[1:33], "big"),
             int.from_bytes(raw[33:65], "big"))
    if not on_curve(point):
        raise ValueError("public key not on curve")
    return point


def public_key_to_pem(point: tuple[int, int]) -> str:
    raw = b"\x04" + point[0].to_bytes(32, "big") + point[1].to_bytes(32, "big")
    der = _SPKI_EC_P256 + raw
    b64 = base64.b64encode(der).decode()
    lines = [b64[i:i + 64] for i in range(0, len(b64), 64)]
    return ("-----BEGIN PUBLIC KEY-----\n"
            + "\n".join(lines) + "\n-----END PUBLIC KEY-----\n")


# ------------------------------------------------------------------ ECDSA


def generate_keypair() -> tuple[int, tuple[int, int]]:
    d = secrets.randbelow(N - 1) + 1
    return d, _mul(d, (GX, GY))


def _rfc6979_k(priv: int, digest: bytes) -> int:
    """Deterministic nonce (RFC 6979) — keeps test fixtures stable."""
    holen = 32
    x = priv.to_bytes(32, "big")
    h1 = digest
    v = b"\x01" * holen
    k = b"\x00" * holen
    k = hmac.new(k, v + b"\x00" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def sign(priv: int, message: bytes) -> bytes:
    """DER-encoded ECDSA-SHA256 signature (test/CLI signing path)."""
    digest = hashlib.sha256(message).digest()
    z = int.from_bytes(digest, "big")
    while True:
        k = _rfc6979_k(priv, digest)
        x, _ = _mul(k, (GX, GY))
        r = x % N
        if r == 0:
            continue
        s = _inv(k, N) * (z + r * priv) % N
        if s == 0:
            continue
        return der_encode_signature(r, s)


def verify(pub: tuple[int, int], message: bytes, der_sig: bytes) -> bool:
    """ECDSA-SHA256 verify; False on any malformed input."""
    try:
        r, s = der_decode_signature(der_sig)
    except (ValueError, IndexError):
        return False
    if not (1 <= r < N and 1 <= s < N) or not on_curve(pub):
        return False
    z = int.from_bytes(hashlib.sha256(message).digest(), "big")
    w = _inv(s, N)
    u1 = z * w % N
    u2 = r * w % N
    point = _add(_mul(u1, (GX, GY)), _mul(u2, pub))
    if point is None:
        return False
    return point[0] % N == r
