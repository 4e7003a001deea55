"""Image verification engine (verifyImages rules).

Mirrors kyverno/pkg/engine/imageVerify.go:21-251
(VerifyAndPatchImages / verifySignature / patchDigest / attestImage /
checkAttestations): per matching rule, every container image matching the
rule's image pattern is either signature-verified — passing images get
their reference patched to digest form (makeAddDigestPatch,
imageVerify.go:209) — or checked against in-toto attestation predicates
with any/all conditions evaluated over the statement's predicate plus an
``image`` context object (imageVerify.go:217-251).

The reference's cosign/OCI-registry client (pkg/cosign/cosign.go) is a
network service client, not engine logic; here it is a pluggable
:class:`Verifier` seam. :class:`StaticVerifier` implements the same trust
decision (key -> signed digest, image -> attestation statements) from a
declared store — the CLI mock-store pattern (pkg/kyverno/store) applied to
signatures — and is also what tests and air-gapped deployments use.
"""

from __future__ import annotations

import copy
import re
import time
from dataclasses import dataclass, field

from .context import Context, image_string
from .policy_context import PolicyContext
from .response import (
    EngineResponse,
    PolicySpecSummary,
    ResourceSpec,
    RuleResponse,
    RuleStatus,
    RuleType,
)
from .json_context_loader import ContextLoadError, load_context
from .operators import evaluate_condition, evaluate_conditions
from .validation import _matches
from .variables import VariableResolutionError, substitute_all
from ..utils.wildcard import wildcard_match


class VerificationError(Exception):
    """Signature/attestation verification failure (cosign.Verify error)."""


class Verifier:
    """The seam the engine calls for the actual trust decision.

    ``verify_signature`` returns the verified digest or raises
    :class:`VerificationError` (cosign.VerifySignature,
    pkg/cosign/cosign.go:30); ``fetch_attestations`` returns in-toto
    statement dicts (cosign.FetchAttestations, cosign.go:103)."""

    def verify_signature(self, image: str, key: str = "", repository: str = "",
                         roots: str = "", subject: str = "") -> str:
        raise VerificationError("no image verifier configured")

    def fetch_attestations(self, image: str, key: str = "",
                           repository: str = "", roots: str = "",
                           subject: str = "") -> list[dict]:
        raise VerificationError("no image verifier configured")


@dataclass
class SignedImage:
    digest: str
    keys: list[str] = field(default_factory=list)   # public keys / key ids


@dataclass
class StaticVerifier(Verifier):
    """Trust store for tests, CLI runs and air-gapped clusters: a map of
    image reference -> (digest, accepted keys) and image -> statements."""

    signed: dict = field(default_factory=dict)        # image -> SignedImage
    statements: dict = field(default_factory=dict)    # image -> [statement]

    def sign(self, image: str, digest: str, key: str = "") -> None:
        entry = self.signed.setdefault(image, SignedImage(digest=digest))
        entry.digest = digest
        if key:
            entry.keys.append(key)

    def attest(self, image: str, statement: dict) -> None:
        self.statements.setdefault(image, []).append(statement)

    def verify_signature(self, image: str, key: str = "", repository: str = "",
                         roots: str = "", subject: str = "") -> str:
        entry = self.signed.get(image)
        if entry is None:
            raise VerificationError(f"no signature found for {image}")
        if key and entry.keys and key not in entry.keys:
            raise VerificationError(f"signature key mismatch for {image}")
        return entry.digest

    def fetch_attestations(self, image: str, key: str = "",
                           repository: str = "", roots: str = "",
                           subject: str = "") -> list[dict]:
        if image not in self.statements:
            raise VerificationError(f"no attestations found for {image}")
        return list(self.statements[image])


_POINTER_INDEX = re.compile(r"/(\d+)(?=/|$)")


def json_pointer_to_jmespath(pointer: str) -> str:
    """utils.JsonPointerToJMESPath: /spec/containers/0/image ->
    spec.containers[0].image."""
    s = _POINTER_INDEX.sub(r"[\1]", pointer)
    return s.strip("/").replace("/", ".")


def _rule_response(rule, msg: str, status: RuleStatus,
                   rtype: RuleType = RuleType.IMAGE_VERIFY) -> RuleResponse:
    return RuleResponse(name=rule.name, type=rtype, message=msg, status=status)


def verify_and_patch_images(policy_ctx: PolicyContext,
                            verifier: Verifier) -> EngineResponse:
    """imageVerify.go:21 VerifyAndPatchImages."""
    start = time.monotonic()
    resp = EngineResponse(patched_resource=policy_ctx.new_resource)
    resource = policy_ctx.new_resource or {}
    meta = resource.get("metadata") or {}
    resp.policy_response.policy = PolicySpecSummary(
        name=policy_ctx.policy.name if policy_ctx.policy else "",
        validation_failure_action=(
            policy_ctx.policy.spec.validation_failure_action
            if policy_ctx.policy else "audit"),
    )
    resp.policy_response.resource = ResourceSpec(
        kind=resource.get("kind", ""),
        api_version=resource.get("apiVersion", ""),
        namespace=meta.get("namespace", ""),
        name=meta.get("name", ""),
        uid=meta.get("uid", ""),
    )

    ctx = policy_ctx.json_context
    images = ctx.images if ctx is not None else None
    if not images:
        return resp

    ctx.checkpoint()
    try:
        for rule in policy_ctx.policy.spec.rules:
            if not rule.has_verify_images():
                continue
            if not _matches(rule, policy_ctx):
                continue
            ctx.restore()
            ctx.checkpoint()

            try:
                load_context(rule.context, policy_ctx, rule.name)
            except ContextLoadError as e:
                resp.policy_response.rules.append(_rule_response(
                    rule, f"failed to load context: {e}", RuleStatus.ERROR))
                continue

            for iv in rule.verify_images:
                # variables substitute in the spec fields but NOT in
                # attestations (imageVerify.go:90 substituteVariables)
                try:
                    spec = substitute_all(ctx, {
                        "image": iv.image, "key": iv.key, "roots": iv.roots,
                        "subject": iv.subject, "repository": iv.repository,
                    })
                except VariableResolutionError as e:
                    resp.policy_response.rules.append(_rule_response(
                        rule, f"failed to substitute variables: {e}",
                        RuleStatus.ERROR))
                    continue
                for bucket in ("containers", "initContainers"):
                    _verify_bucket(resp, policy_ctx, rule, spec,
                                   iv.attestations, verifier,
                                   images.get(bucket) or {})
    finally:
        ctx.restore()

    resp.policy_response.processing_time_s = time.monotonic() - start
    return resp


def _verify_bucket(resp, policy_ctx, rule, spec, attestations, verifier,
                   infos: dict) -> None:
    """imageVerifier.verify (imageVerify.go:117)."""
    ctx = policy_ctx.json_context
    for info in infos.values():
        image = image_string(info)

        # UPDATE requests skip unchanged images (imageVerify.go:124)
        pointer = info.get("jsonPath", "")
        if pointer:
            try:
                if not ctx.has_changed(json_pointer_to_jmespath(pointer)):
                    continue
            except Exception:
                pass  # HasChanged error -> proceed (err != nil branch)

        if not wildcard_match(spec["image"], image):
            continue

        if not attestations:
            rule_resp, digest = _verify_signature(rule, spec, image, verifier)
            if rule_resp.status == RuleStatus.PASS and not info.get("digest"):
                # makeAddDigestPatch (imageVerify.go:209)
                rule_resp.patches = [{
                    "op": "replace",
                    "path": pointer,
                    "value": image + "@" + digest,
                }]
        else:
            rule_resp = _attest_image(policy_ctx, rule, spec, info,
                                      attestations, verifier)
        resp.policy_response.rules.append(rule_resp)


def _verify_signature(rule, spec, image: str, verifier) -> tuple[RuleResponse, str]:
    """imageVerify.go:160 verifySignature. The reference tags these rule
    responses with the Validation type (not ImageVerify) — mirrored."""
    try:
        digest = verifier.verify_signature(
            image, key=spec["key"], repository=spec["repository"],
            roots=spec["roots"], subject=spec["subject"])
    except VerificationError as e:
        return _rule_response(
            rule, f"image signature verification failed for {image}: {e}",
            RuleStatus.FAIL, RuleType.VALIDATION), ""
    return _rule_response(rule, f"image {image} verified",
                          RuleStatus.PASS, RuleType.VALIDATION), digest


def _attest_image(policy_ctx, rule, spec, info, attestations,
                  verifier) -> RuleResponse:
    """imageVerify.go:217 attestImage + :251 checkAttestations."""
    image = image_string(info)
    try:
        statements = verifier.fetch_attestations(
            image, key=spec["key"], repository=spec["repository"],
            roots=spec["roots"], subject=spec["subject"])
    except VerificationError as e:
        return _rule_response(
            rule, f"failed to fetch attestations for {image}: {e}",
            RuleStatus.ERROR)

    for check in attestations:
        want_type = check.get("predicateType")
        for statement in statements:
            if statement.get("predicateType") != want_type:
                continue
            try:
                ok = _check_attestation(policy_ctx, check, statement, info)
            except Exception as e:
                return _rule_response(
                    rule, f"error while checking attestation: {e}",
                    RuleStatus.ERROR)
            if not ok:
                return _rule_response(
                    rule,
                    f"attestation checks failed for {image} and predicate "
                    f"{want_type}", RuleStatus.FAIL)
    return _rule_response(rule, f"attestation checks passed for {image}",
                          RuleStatus.PASS)


def _check_attestation(policy_ctx, check: dict, statement: dict, info) -> bool:
    """checkAttestations: conditions evaluate over the statement's
    predicate merged with an ``image`` object (imageVerify.go:251-299)."""
    conditions = check.get("conditions")
    if not conditions:
        return True

    ctx = policy_ctx.json_context
    predicate = statement.get("predicate")
    if not isinstance(predicate, dict):
        raise ValueError(f"failed to extract predicate from statement: "
                         f"{statement}")

    ctx.checkpoint()
    try:
        ctx.add_json(copy.deepcopy(predicate))
        ctx.add_json({"image": {
            "image": image_string(info),
            "registry": info.get("registry", ""),
            "path": info.get("path", ""),
            "name": info.get("name", ""),
            "tag": info.get("tag", ""),
            "digest": info.get("digest", ""),
        }})
        substituted = substitute_all(ctx, copy.deepcopy(conditions))
        # Attestation.Conditions is a []AnyAllConditions: every block must
        # pass (variables/evaluate.go:11 EvaluateAnyAllConditions)
        if isinstance(substituted, list) and substituted and all(
                isinstance(b, dict) and set(b) <= {"any", "all"}
                for b in substituted):
            return all(evaluate_conditions(b) for b in substituted)
        return evaluate_conditions(substituted)
    finally:
        ctx.restore()
