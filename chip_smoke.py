"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold every kernel to
its plain PyTorch version.

    python3 chip_smoke.py            # all phases (one card)
    python3 chip_smoke.py --quick    # build + kernel-vs-plain on small inputs,
                                     # flatten parity, evaluate() at 1,000,
                                     # [autogen] at 1,000, [actions] small,
                                     # [webhook] at one policy
    python3 chip_smoke.py --all-cards  # build + the mesh scan over every card
                                       # (two or more) against one card's
    python3 chip_smoke.py --admission 8  # build + the [admission] phase 8
                                         # times over; how many failed
    python3 chip_smoke.py --admission 8 --cold-flush on  # the same, each
                                         # timed burst begun on a cold shape
                                         # bucket (release on or off)
    python3 chip_smoke.py --admission 8 --heap keep  # the same on a heap
                                         # filled to a full run's size
                                         # (keep, or freeze it out of the
                                         # garbage collector)
    python3 chip_smoke.py --webhook      # build + the [webhook] phase alone
    python3 chip_smoke.py --controller   # build + the [controller] phase alone
    python3 chip_smoke.py --analysis     # build + the [analysis] phase alone
    python3 chip_smoke.py --fleet        # build + the [fleet] phase alone
    python3 chip_smoke.py --workload     # build + the [workload] phase alone
    python3 chip_smoke.py --chaos        # build + the [chaos] phase alone
                                         # (the three flags combine)
    python3 chip_smoke.py --admission 8 --pool-workers 4  # [admission]
                                         # with the oracle pool at 4 workers

Phases:
  1. build     nvcc builds every kernel of kyverno_tpu_torch/csrc into
               build/torch_kernels/ (one process per source, in parallel),
               and g++ the native flattener (csrc/ktpu_flatten.cpp, host
               code) beside them, at the same time
  2. kernels   K1 glob NFA, eval_rules (stages 2-6 in one launch), its
               scan form (FAIL / PASS / HOST bit masks instead of the
               verdicts), K5 (the counts from the masks) and its counts
               form (K7's: the verdicts and, as their epilogue, per-rule
               FAIL / PASS counts over every row of the first live rule
               columns, at live = R and R - 7) against
               their plain versions, on the card, with zero tolerance
               (the outputs are integers and booleans), and scan_blob
               (K1 -> scan form -> K5) against the counts of the
               verdict matrix: an anchor-heavy seeded corpus (gates,
               conditions, existence, anchorMap, anyPattern, aux rows),
               also cut into ten rule tiles; a deny-only set (no check
               rows); the 250-policy library x 10k mixed resources; the
               1000-policy library x 2,000, whose plan is larger than a
               block's shared memory and runs as several rule tiles; and
               a wide corpus of 301 paths x 16 elements a path, whose
               slots cut it into seven tiles and blocks of fewer than 8
               resources. K1 also over a seeded set of more glob
               patterns than one of its blocks takes, on the library's
               10k dictionary
  3. flatten   the native flattener's packed blob, from each of its
               entries (the dict walk, the FlatBatch entry behind
               cps.flatten, the chunked JSON entry over threads), equal
               byte for byte to the Python flattener's on the library x
               10k, the anchor corpus and the wide corpus, with no
               fallback counted; microseconds a resource for each
  4. main      CompiledPolicySet(library_250).evaluate_device(flatten(10k))
               and scan_counts over 1,000,000 mixed resources made 10,000
               at a time and flattened by flatten_packed_chunks, with the
               launch counters set to 0 just before: the pinned verdict
               histogram and sha256, evaluate_device_async equal, every
               kernel of both paths launched
  5. evaluate  cps.evaluate(10k), the whole path (native flatten -> K1 ->
               eval_rules -> the host lane: the CPU oracle for every HOST
               cell, through the verdict memo and fan-out), with the
               launch counters set to 0 just before: K1 and eval_rules
               launched, no HOST cell left, the pinned resolved
               histogram and sha256, every HOST cell a memo miss; a
               second evaluate() with every HOST cell a memo hit and the
               same sha256; the split (flatten, device, resolve with the
               memo emptied) timed; and the anchor corpus x 300 through
               evaluate() equal, cell for cell, to the port's oracle run
               over every rule, the resolved matrix holding PASS, FAIL,
               SKIP and ERROR
  6. pipelined cps.evaluate_pipelined(10k, chunk=1024), with the launch
               counters set to 0 just before: K1 and eval_rules once a
               chunk, the pinned sha256, no HOST cell; its wall time and
               the oracle seconds its prefetch hid in the device's
               shadow (overlap_s, from the chunks' traces); then again
               with KTPU_NATIVE=0 and the KTPU_HOST_* switches off
  7. admission the admission path at full width, shaped like bench.py's
               burst_library_250: the library in enforce mode in a
               PolicyCache on the card (incremental compile, rule
               buckets), an AdmissionBatcher with the JAX package's
               defaults and an OraclePool on the host lane (dormant below
               4 cores); 16 threads x 16 distinct pods with their
               request payloads, warmed as bench.py warms, then timed
               with the launch counters set to 0: every device answer
               equal to the port's oracle on its pod, K1 and eval_rules
               launched once a device flush, K6 dispatches on reused
               device blobs, pool cells; again with KTPU_DONATE=0; a
               lone request routed ORACLE; evaluate_device_async split
               by phase with K6 and without; a one-policy update's
               refresh (one segment recompiled) and the first warm flush
               after it; the library's 250 x 10k resolved matrix through
               the cache, incremental and with KTPU_INCREMENTAL=0, equal
               to the pinned sha256
 7b. webhook   the same path behind the port's WebhookServer over HTTP/1.1
               keep-alive on 127.0.0.1, shaped like bench.py's
               bench_config1: disallow-latest-tag in enforce mode, 200
               sequential POSTs of one body, then 16 threads x 32
               distinct bodies, every verdict as the image says; the
               library in enforce mode in a PolicyCache on the card with
               an AdmissionBatcher, warmed as bench.py warms, then 16
               threads x 16 distinct Pods with the launch counters set to
               0 and a traceparent a request: every answer equal to a
               second server without a batcher (the oracle lane) given
               the same review, a denial from the device row with each
               of its lines as the webhook writes it for the oracle
               lane's failing rule, device answers, K1 and eval_rules
               once a device flush, K6 dispatches on reused blobs;
               /metrics counting every
               request with the card's memory gauge (fed once from
               torch.cuda), /healthz, /debug/traces holding each traced
               admission under its caller's id with the flush's
               device_dispatch span and an admission with a screen span;
               the same Pods through /mutate (config 4's two policies)
               equal to the serial mutate() chain; a policy through
               /policyvalidate and /policymutate, whose autogen rules are
               the [autogen] steps'; p50, p99 and requests/s a lane
 7c. controller the controller process (kyverno_tpu_torch.server): the
               library (enforce) as ClusterPolicies and 250
               autogen_resource(i) in a FakeCluster, two Controller
               replicas on it. The leader registers the webhooks, runs
               the migrations and, kicked by the policy load, scans with
               the launch counters set to 0 just before: K1 and
               eval_rules launched, no scan error, the responses stating
               evaluate()'s resolved matrix of the same policies, the
               aggregated reports its per-policy totals. 16 threads x 16
               Pods over HTTP alternating the replicas, each answer equal
               to an oracle lane's (same_answer). A StreamServer (socket)
               beside the leader's webhook: 256 JSON frames equal to
               handle()'s answers, 256 ROW frames equal to the device
               matrix's rows (or escalated at the screen's deadline,
               counted), 16 BLOCK frames of 64 rows equal to
               evaluate_device's, HOST rows escalated; K6 dispatches and
               launches counted; a donated block's host buffer unchanged;
               no frame, block or shape error. /debug/profile?seconds=2
               on the leader during the frames: a torch.profiler trace
               holding K1's and eval_rules' kernels, the card's busy
               share in its window, device memory reported. Failover:
               the leader stops, the follower leads within two retry
               periods and scans; both stop with their report writers
               flushed and no non-daemon thread left
  8. mutate    BASELINE config 4 as bench.py runs it, with its two inline
               policies: add-default-labels over 50,000 Pods (a kind-only
               gate, which the lane router sends to the host), then
               annotate-bench-apps over 50,000 mixed resources (a
               label-selector gate, min_gate_batch=64), each through a
               BatchMutator whose gate set is on the card: mutations/s of
               two draws in the router's lane, with its launches; the
               first 1,000 patch lists equal to the serial mutate()
               chain's; the host lane and the device lane forced, equal
               document for document, the device lane launching
               eval_rules once a chunk of 8192 (7 at 50,000), K1 as often
               where the gate's plan has a glob pattern, and nothing else;
               the gate's K1 -> eval_rules a chunk between CUDA events,
               equal to the plain pipeline, and its share of the device
               lane's wall; no gate fallback (GATE_FALLBACKS) and no
               flattener fallback
 9. autogen   what the server does to a policy, then the screen on the
               card: the library through the port's policy webhook steps
               (apply_defaults -> mutate_policy_for_autogen ->
               validate_policy -> validate_policy_mutation), 670 rules and
               no error; the autogen'd policies in a PolicyCache on the
               card; 10,000 resources cycling Pod, Deployment,
               StatefulSet, DaemonSet, Job, CronJob and Service, each
               through its kind's population with the launch counters set
               to 0 just before: K1 and eval_rules launched, the resolved
               matrix by (policy, rule name) with no HOST cell and the
               JAX package's pinned histogram and sha256, again from the
               verdict memo; every kernel against its plain version on
               the 670-column plan (three rule tiles), eval_rules timed
               between CUDA events; a burst of 16 threads x 16 distinct
               Deployments and CronJobs through an AdmissionBatcher, every
               device answer equal to the port's oracle, K6 dispatches
10. actions   the host planes on the card's machine (no PyYAML assumed,
               no cryptography, no network): a RegistryVerifier against a
               registry on 127.0.0.1 with 1,000 Pods over 8 images (signed
               ones patched to their digests, a forged signature and an
               unsigned tag refused, repeats from the verifier's cache);
               generate() and apply_generate_rule over 1,000 Namespaces
               (a data rule and a clone rule) over threads and serially,
               equal, and equal to documents written out by hand; a CRD's
               schema through schemas_from_crd -> register_schema ->
               validate_resource, CrdSync and validate_policy_mutation
10b. analysis the analysis plane: the differential fuzz
               (kyverno_tpu_torch.analysis.difffuzz, the configuration the
               JAX package is gated on: 1,000 cases, batch 24, seed
               20260805, the pipeline and stream legs) on the card with
               the launch counters set to 0 just before: no divergence,
               device-decided cells, messages checked, stream rows, K1
               and eval_rules launched, K6 dispatches on the stream
               leg's set; certify_policies and analyze_policies over the
               library and its autogen'd 670 rules, no KT401 and the
               counts pinned to the JAX package's; the CLI as
               subprocesses (lint --self, lint --certify over the
               library, apply of the library to 8 Pods, its failures
               equal to evaluate()'s FAIL cells on the card); an
               IncrementalCompiler on the card over the 670 rules, its
               refresh certified (KTPU_CERTIFY) with no divergent rule,
               one-policy refreshes timed with the certifier on and off,
               and the policy cache's admission lint timed on and off
10c. fleet    the fleet plane at the library's width: the library
               (enforce) behind three replicas of
               workload.replay.build_fleet_stacks on the card sharing one
               fabric hub, a 512-event trace (8 namespaces, 64 body
               templates, 256 names, four of the library's policies
               landing again every 128 events) through run_fleet, each
               leg warmed, then with the launch counters set to 0: the
               kill switch (KTPU_FABRIC=0, one replica and three, the hub
               seeing only the sync handshakes), the fabric with no
               affinity (cross-replica hits), the churn (the hub's tiers
               purged fleet-wide, one and three replicas equal), the
               socket transport (the same decisions), manifests of two
               topologies incomparable. Every leg's decisions and digest
               equal to an oracle stack's (no batcher), K6 dispatches in
               every replica, K1 and eval_rules launched and no other
               kernel, no flush error, no HOST cell, no flattener
               fallback. Then three FleetScanCoordinators split 8 ranges
               of 1,000 mixed resources: merged range digests equal to an
               unpartitioned scan's, and again after a member stops and
               the survivors take its ranges over
10d. workload the workload plane: one stack of the library replays a
               churn trace through its webhook, stream_json, stream_row
               and background legs (the admission digests equal and the
               oracle webhook's, the background matrix flagging exactly
               the denied resources; ROW frames escalate every row with a
               HOST cell, so the ROW leg is held to the webhook over the
               library's device-decidable policies); a 13,000-event trace
               through the background leg builds a corpus of 10,000 or
               more; a known-tightening candidate dry-run on the card (K1
               -> eval_rules) newly fails exactly a plant computed
               without the engine, and the scanner's fingerprint, the
               matrix bytes and the batcher's result-cache fingerprint
               do not move; KTPU_DRYRUN=0 refuses (HTTP 403,
               DryRunDisabled) with a live answer unchanged; the CLI's
               dryrun on the trace file and with --url against the
               scanner's /debug/dryrun
10e. chaos    run_scenario("oracle_brownout", 24 events, 0.35 s) with the
               SLO actions on and off, on stacks on the card: every check
               of the JAX package's chaos gate
11. background the background scan path, each run with the launch
               counters set to 0 just before and read just after.
               [background]: BackgroundScanner over the library with a
               ReportGenerator through each lane: the incremental lane
               over 10,000 resources, its responses and verdict_matrix()
               stating the pinned resolved matrix; the single lane
               (KTPU_INCREMENTAL=0) and the 1D mesh of the card over the
               first 1,000 (their 10,000 are [evaluate]'s and [mesh]'s
               paths) and the 2D (4, 1) mesh over the first 1,000 (its
               10,000 are [mesh2d]'s), each matrix equal to the
               incremental lane's first rows; each lane's violations,
               rule results, responses and aggregate()'s per-policy
               totals equal to its matrix's; the launches each
               lane must make; then a one-policy update, 90 MODIFIED and
               10 DELETED watch events and delta_scan(), whose
               verdict_matrix() equals a fresh scanner's full scan.
               The mesh lanes' K7 programs (K1 -> the counts form) are
               checked as in [mesh2d] and [mesh].
               [mesh2d]: sharded_scan of a ShardedPolicySet of the
               library on the (4, 1) mesh over the same 10,000: K1 and
               the counts form once a shard and nothing else, matrix and
               counts equal to the 1D scan's. [mesh]: sharded_scan on the
               1D mesh over 131,072 resources (two chunks of 65,536
               through the worker pool): K1 and the counts form once a
               chunk and nothing else, every chunk's counts equal to
               rule_counts_plain over that launch's own verdicts and the
               K7 program's device time a chunk between CUDA events, no
               HOST cell, the counts equal to the matrix's column sums,
               the first 10,000 rows equal to the 2D scan's and the
               pinned sha256
12. scan      every chunk of the 1M scan equal to the plain pipeline's
               counts on the card, and its first chunk to the verdict
               matrix's
13. times     median of CUDA-event times over warm launches for every
               kernel and its plain version, beside the least time the
               card could take: the bytes the function must move over
               the memory rate (each kernel is bytes-bound); K1,
               eval_rules, its scan form, K5 and scan_blob also at
               B = 100,000, where scan_blob is held to launch exactly K1,
               the scan form and K5 and to allocate no [B, R] matrix;
               eval_rules at two smaller tile budgets; the counts form
               at the mesh scan's chunk (65,536 rows) and at 10,000,
               beside the matrix form alone on the same blob and the
               two-call torch expression that counts the same verdicts
               (the counts' yardstick; the port never calls it on the
               card)

It prints the card's name and power limit, one ``{"kernels": [...]}``
line, and last ``{"ok": true, "device": {...}}``. Any failure raises and
the exit code is not 0; with no CUDA device it exits 2 before any phase.
"""

import argparse
import base64
import faulthandler
import gc
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

# ---------------------------------------------------------------------
# The 250-policy library and the mixed resources of BASELINE config 3:
# a verbatim copy of bench.py's generators (make_pod .. _synth_policy_docs),
# so this script needs nothing of the JAX package or the bench.

def make_pod(i: int) -> dict:
    imgs = ["nginx:latest", "nginx:1.21", "redis:6", "registry.io/a/b:v2"]
    c = {
        "name": f"c{i % 3}",
        "image": imgs[i % 4],
    }
    if i % 3:
        c["resources"] = {
            "requests": {"memory": "64Mi", "cpu": "100m"},
            "limits": {"memory": "128Mi"},
        }
    if i % 5 == 0:
        c["securityContext"] = {"privileged": i % 2 == 0}
    pod = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": f"pod-{i}"},
        "spec": {"containers": [c]},
    }
    if i % 4 == 0:
        pod["metadata"]["labels"] = {
            "app.kubernetes.io/name": "bench",
            "app.kubernetes.io/component": "api",
        }
    if i % 7 == 0:
        pod["spec"]["volumes"] = [{"name": "v", "emptyDir": {}}]
    return pod


def make_deployment(i: int) -> dict:
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {"name": f"dep-{i}", "namespace": "default"},
        "spec": {
            "replicas": (i % 5) + 1,
            "selector": {"matchLabels": {"app": f"a{i % 9}"}},
            "template": {
                "metadata": {"labels": {"app": f"a{i % 9}"}},
                "spec": make_pod(i)["spec"],
            },
        },
    }


def make_service(i: int) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": f"svc-{i}"},
        "spec": {"ports": [{"port": 80 + (i % 1000)}],
                 "type": "ClusterIP" if i % 3 else "LoadBalancer"},
    }


def mixed_resource(i: int) -> dict:
    r = i % 10
    if r < 6:
        return make_pod(i)
    if r < 9:
        return make_deployment(i)
    return make_service(i)


# ---------------------------------------------------------------------
# The pod controllers that autogen'd rules match, each built around
# make_pod(i)["spec"] as make_deployment is, and the population of the
# [autogen] phase that cycles them with Pods and Services.

AUTOGEN_KINDS = ("Pod", "Deployment", "StatefulSet", "DaemonSet", "Job",
                 "CronJob", "Service")


def make_controller(i: int, kind: str) -> dict:
    """A ``kind`` pod controller whose pod template holds make_pod(i)'s
    spec: Deployment is make_deployment(i); CronJob nests the template
    under ``spec.jobTemplate.spec``."""
    if kind == "Deployment":
        return make_deployment(i)
    template = {"metadata": {"labels": {"app": f"a{i % 9}"}},
                "spec": make_pod(i)["spec"]}
    selector = {"matchLabels": {"app": f"a{i % 9}"}}
    api, spec = "apps/v1", {"selector": selector, "template": template}
    if kind == "StatefulSet":
        spec = {"replicas": (i % 3) + 1, "serviceName": f"svc-{i}", **spec}
    elif kind == "Job":
        api, spec = "batch/v1", {"backoffLimit": i % 4, "template": template}
    elif kind == "CronJob":
        api, spec = "batch/v1", {"schedule": f"{i % 60} * * * *",
                                 "jobTemplate": {"spec": {"template": template}}}
    elif kind != "DaemonSet":
        raise ValueError(f"not a pod controller: {kind}")
    return {"apiVersion": api, "kind": kind,
            "metadata": {"name": f"{kind.lower()}-{i}", "namespace": "default"},
            "spec": spec}


def autogen_resource(i: int) -> dict:
    kind = AUTOGEN_KINDS[i % len(AUTOGEN_KINDS)]
    if kind == "Pod":
        return make_pod(i)
    if kind == "Service":
        return make_service(i)
    return make_controller(i, kind)


def policy_steps():
    """The port's policy webhook steps and its loader, for
    :func:`autogen_policies`."""
    from types import SimpleNamespace

    from kyverno_tpu_torch.api.load import load_policy
    from kyverno_tpu_torch.policy import autogen, openapi, validation

    return SimpleNamespace(
        load_policy=load_policy, apply_defaults=autogen.apply_defaults,
        mutate_policy_for_autogen=autogen.mutate_policy_for_autogen,
        validate_policy=validation.validate_policy,
        validate_policy_mutation=openapi.validate_policy_mutation)


def autogen_policies(docs: list, steps) -> tuple[list, list]:
    """What the server does to each policy before its cache gets it: the
    policy webhook's steps (defaults, then autogen, then the structural
    checks and, where they pass, the mutate schema check), each a
    function of ``steps`` (:func:`policy_steps`). Returns the autogen'd
    policies and every error the checks gave, with its policy's name."""
    out, errors = [], []
    for d in docs:
        p = steps.mutate_policy_for_autogen(
            steps.load_policy(steps.apply_defaults(d)))
        errs = (steps.validate_policy(p)
                or steps.validate_policy_mutation(p))
        errors += [(p.name, e) for e in errs]
        out.append(p)
    return out, errors


def rule_columns(policies: list) -> dict:
    """(policy name, rule name) -> column, in policy order and, within a
    policy, rule order: the resolved matrix's columns in [autogen]."""
    cols = {}
    for p in policies:
        for r in p.spec.rules:
            cols[(p.name, r.name)] = len(cols)
    return cols


# --------------------------------------------------------------- libraries
# The in-repo synthesized library (the bench's fallback when the upstream
# policy corpus is absent), so this script runs in any checkout.


def _synth_policy_docs(n: int = 250) -> list:
    """Synthesized ~n-policy validate library with a production-shaped
    mix (all device/host routing classes are represented):

      - static-message deny material (disallow-latest, require-requests):
        device-lane patterns whose FAIL message needs no variable
        substitution, so an ATTENTION row denies straight from the row
      - variable-message denies ({{ request.object.* }}): device-lane
        patterns whose message substitutes from the admission request
      - all-pass hygiene rules (require-name, container-name): the CLEAN
        short-circuit material
      - Deployment/Service rules: exercise kind routing on mixed corpora
      - a small host-lane slice ({{variable}} inside the pattern): rules
        the device cannot score, resolved by the batched flush oracle
        (they are pool-safe: no context entries)
    """
    docs = []
    k = 0
    while len(docs) < n and k <= 40 * n:
        f = k % 25
        if f < 8:
            docs.append({
                "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
                "metadata": {"name": f"disallow-latest-tag-v{k}"},
                "spec": {"rules": [{
                    "name": "validate-image-tag",
                    "match": {"resources": {"kinds": ["Pod"]}},
                    "validate": {
                        "message": f"latest tag not allowed (check {k})",
                        "pattern": {"spec": {"containers": [
                            {"image": "!*:latest"}]}}},
                }]},
            })
        elif f < 13:
            docs.append({
                "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
                "metadata": {"name": f"require-requests-v{k}"},
                "spec": {"rules": [{
                    "name": "check-requests",
                    "match": {"resources": {"kinds": ["Pod"]}},
                    "validate": {
                        "message": f"memory requests required (check {k})",
                        "pattern": {"spec": {"containers": [
                            {"resources": {"requests": {
                                "memory": "?*"}}}]}}},
                }]},
            })
        elif f < 17:
            docs.append({
                "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
                "metadata": {"name": f"require-name-v{k}"},
                "spec": {"rules": [{
                    "name": "check-name",
                    "match": {"resources": {"kinds": ["Pod"]}},
                    "validate": {"message": f"name required ({k})",
                                 "pattern": {"metadata": {"name": "?*"}}},
                }]},
            })
        elif f < 19:
            docs.append({
                "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
                "metadata": {"name": f"deny-latest-named-v{k}"},
                "spec": {"rules": [{
                    "name": "named-latest",
                    "match": {"resources": {"kinds": ["Pod"]}},
                    "validate": {
                        "message": ("{{ request.object.metadata.name }}"
                                    f" must not use latest ({k})"),
                        "pattern": {"spec": {"containers": [
                            {"image": "!*:latest"}]}}},
                }]},
            })
        elif f < 21:
            docs.append({
                "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
                "metadata": {"name": f"deployment-selector-v{k}"},
                "spec": {"rules": [{
                    "name": "has-selector",
                    "match": {"resources": {"kinds": ["Deployment"]}},
                    "validate": {"message": f"selector required ({k})",
                                 "pattern": {"spec": {"selector": {
                                     "matchLabels": {"app": "?*"}}}}},
                }]},
            })
        elif f < 23:
            docs.append({
                "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
                "metadata": {"name": f"service-no-external-v{k}"},
                "spec": {"rules": [{
                    "name": "no-externalname",
                    "match": {"resources": {"kinds": ["Service"]}},
                    "validate": {"message": f"ExternalName banned ({k})",
                                 "pattern": {"spec": {
                                     "type": "!ExternalName"}}},
                }]},
            })
        elif f < 24:
            docs.append({
                "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
                "metadata": {"name": f"container-named-v{k}"},
                "spec": {"rules": [{
                    "name": "container-name",
                    "match": {"resources": {"kinds": ["Pod"]}},
                    "validate": {"message": f"container name required ({k})",
                                 "pattern": {"spec": {"containers": [
                                     {"name": "?*"}]}}},
                }]},
            })
        elif k % 150 == 24:
            # host-lane slice, kept small: each pod row carries one HOST
            # cell per such policy and every cell costs a CPU-oracle rule
            # evaluation to resolve
            docs.append({
                "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
                "metadata": {"name": f"host-echo-name-v{k}"},
                "spec": {"rules": [{
                    "name": "echo-name",
                    "match": {"resources": {"kinds": ["Pod"]}},
                    "validate": {
                        "message": f"name mismatch ({k})",
                        "pattern": {"metadata": {"name":
                                    "{{request.object.metadata.name}}"}}},
                }]},
            })
        k += 1
    return docs[:n]


# ---------------------------------------------------------------------
# Anchor-heavy seeded corpus, modelled on the cross-check corpora: every
# device construct the kernels implement (element gates, condition and
# global anchors, existence, equality and negation anchors, anyPattern,
# numeric ranges, match / exclude / precondition / deny aux rows).

def _rule(name, rule):
    rule = dict(rule)
    rule.setdefault("name", name)
    rule.setdefault("match", {"resources": {"kinds": ["Pod"]}})
    return {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
            "metadata": {"name": name}, "spec": {"rules": [rule]}}


def anchor_policy_docs(seed: int, n: int = 60) -> list:
    rng = np.random.default_rng(seed)

    def pick(xs):
        return xs[int(rng.integers(len(xs)))]

    def ns_key(k):
        return "{{ request.object.metadata.%s }}" % k

    templates = [
        lambda: {"validate": {"pattern": {"spec": {"containers": [
            {"(image)": pick(["*:latest", "nginx*", "redis*"]),
             "imagePullPolicy": pick(["Always", "IfNotPresent"])}]}}}},
        lambda: {"validate": {"pattern": {"spec": {"containers": [
            {"(name)": pick(["web", "app*", "?*"]),
             "resources": {"limits": {"memory": pick(["<=2Gi", "<1Gi", "?*"])}}}]}}}},
        lambda: {"validate": {"pattern": {
            "spec": {"(hostNetwork)": bool(rng.integers(2))},
            "metadata": {"labels": {"app.kubernetes.io/name": "?*"}}}}},
        lambda: {"validate": {"pattern": {"spec": {
            "<(hostPID)": False, "containers": [{"name": "?*"}]}}}},
        lambda: {"validate": {"pattern": {"spec": {
            "^(containers)": [{"image": pick(["nginx*", "redis*", "*:latest"])}]}}}},
        lambda: {"validate": {"pattern": {"spec": {
            "=(volumes)": [{"X(hostPath)": "null"}]}}}},
        lambda: {"validate": {"pattern": {"spec": {"containers": [
            {"=(securityContext)": {"=(privileged)": False}}]}}}},
        lambda: {"validate": {"anyPattern": [
            {"spec": {"containers": [{"image": pick(["nginx:*", "busybox*"])}]}},
            {"spec": {"containers": [{"image": pick(["redis*", "*:v2"])}]}}]}},
        lambda: {"validate": {"pattern": {"spec": {"containers": [
            {"ports": [{"containerPort": pick(["1024-65535", "<8080", "!80"])}]}]}}}},
        lambda: {"validate": {"pattern": {"metadata": {
            "=(annotations)": {"=(team)": pick(["alpha*", "beta", "?*"])}}}}},
        lambda: {"validate": {"deny": {"conditions": {pick(["any", "all"]): [
            {"key": ns_key("namespace"), "operator": pick(["In", "NotIn"]),
             "value": ["prod", "dev"]},
            {"key": ns_key("labels.tier"), "operator": pick(["Equals", "NotEquals"]),
             "value": pick(["web", "db"])}]}}}},
        lambda: {"preconditions": {"all": [
            {"key": ns_key("annotations.mem"),
             "operator": pick(["LessThan", "GreaterThanOrEquals"]),
             "value": pick(["1Gi", "1500Mi"])}]},
            "validate": {"pattern": {"metadata": {"name": "pod-*"}}}},
        lambda: {"validate": {"deny": {"conditions": {"any": [
            {"key": ns_key("annotations.timeout"),
             "operator": pick(["DurationGreaterThan", "DurationLessThanOrEquals"]),
             "value": pick(["45s", "2m", 120])}]}}}},
        lambda: {"match": {"any": [
            {"resources": {"kinds": ["Pod"], "names": ["pod-1*"]}},
            {"resources": {"kinds": ["Pod"], "namespaces": ["prod*"]}}]},
            "exclude": {"resources": {"selector": {"matchLabels": {"tier": "web"}}}},
            "validate": {"pattern": {"spec": {"containers": [{"image": "!*:latest"}]}}}},
        lambda: {"match": {"resources": {"kinds": ["Pod"], "selector": {
            "matchExpressions": [{"key": "env", "operator": "Exists"}]}}},
            "validate": {"pattern": {"spec": {"=(hostNetwork)": False}}}},
    ]
    # each template once, then seeded picks
    docs = [_rule(f"anchor-{i}", t()) for i, t in enumerate(templates)]
    while len(docs) < n:
        docs.append(_rule(f"anchor-{len(docs)}", pick(templates)()))
    return docs


def deny_only_docs() -> list:
    return [
        _rule("deny-ns", {"validate": {"deny": {"conditions": {"any": [
            {"key": "{{ request.object.metadata.namespace }}",
             "operator": "In", "value": ["prod", "dev"]}]}}}}),
        _rule("deny-replicas", {
            "match": {"resources": {"kinds": ["Deployment"]}},
            "validate": {"deny": {"conditions": {"all": [
                {"key": "{{ request.object.spec.replicas }}",
                 "operator": "GreaterThan", "value": 3}]}}}}),
    ]


def random_resource(rng) -> dict:
    def pick(xs):
        return xs[int(rng.integers(len(xs)))]

    containers = []
    for i in range(int(rng.integers(0, 4))):
        c = {"name": pick(["web", "app", "sidecar", f"c{i}"])}
        if rng.random() < 0.9:
            c["image"] = pick(["nginx:latest", "nginx:1.21", "redis",
                               "registry.io/a/b:v2", "busybox:stable"])
        if rng.random() < 0.5:
            c["imagePullPolicy"] = pick(["Always", "IfNotPresent"])
        if rng.random() < 0.4:
            c["securityContext"] = ({"privileged": bool(rng.integers(2))}
                                    if rng.random() < 0.7 else {})
        if rng.random() < 0.5:
            c["resources"] = {"limits": {"memory": pick(["128Mi", "2Gi", "3Gi"])}}
        if rng.random() < 0.3:
            c["ports"] = [{"containerPort": int(rng.integers(1, 65535))}
                          for _ in range(int(rng.integers(0, 3)))]
        containers.append(c)
    kind = pick(["Pod", "Pod", "Pod", "Deployment", "Service"])
    res = {"apiVersion": "apps/v1" if kind == "Deployment" else "v1",
           "kind": kind,
           "metadata": {"name": f"pod-{int(rng.integers(0, 999))}"},
           "spec": {}}
    if kind == "Deployment" and rng.random() < 0.7:
        res["spec"]["replicas"] = int(rng.integers(0, 10))
    if rng.random() < 0.7:
        res["metadata"]["namespace"] = pick(["default", "prod", "prod-eu", "dev"])
    if containers or rng.random() < 0.8:
        res["spec"]["containers"] = containers
    if rng.random() < 0.6:
        labels = {}
        if rng.random() < 0.7:
            labels["app.kubernetes.io/name"] = pick(["x", ""])
        if rng.random() < 0.6:
            labels["tier"] = pick(["web", "db", "cache"])
        if rng.random() < 0.4:
            labels["env"] = pick(["prod", "dev"])
        res["metadata"]["labels"] = labels
    if rng.random() < 0.5:
        res["metadata"]["annotations"] = {
            "team": pick(["alpha", "alpha-eu", "beta", ""]),
            "timeout": pick(["30s", "2m", "1h30m", "0", "soon", "90"]),
            "mem": pick(["512Mi", "2Gi", "100M", "lots"])}
    if rng.random() < 0.3:
        res["spec"]["hostNetwork"] = bool(rng.integers(2))
    if rng.random() < 0.2:
        res["spec"]["hostPID"] = bool(rng.integers(2))
    if rng.random() < 0.3:
        res["spec"]["volumes"] = [
            {"name": f"v{i}", **({"hostPath": {"path": "/var/run"}}
                                 if rng.random() < 0.5 else {"emptyDir": {}})}
            for i in range(int(rng.integers(0, 3)))]
    return res


# ---------------------------------------------------------------------
# A wide seeded corpus: rules over a few hundred distinct container keys
# (``k<j>``), read in pods of up to 16 containers, so that a rule tile's
# decoded slots (paths x 16 elements x resources) outgrow its plan section.
# Three keys a rule, most behind an equality anchor (checked where
# present), some rules behind a conditional anchor (a gate), and one rule
# over ``big`` keys at once, which takes a tile alone and fits a block
# only at fewer than 8 resources.

WIDE_VALUES = ["v*", "?*", ">=3", "!x*", "1-9", True]


def wide_policy_docs(n_keys: int = 300, big: int = 100) -> list:
    docs = []
    for r in range(n_keys // 3):
        body = {}
        for j in range(3 * r, 3 * r + 3):
            key = f"k{j}" if r % 4 == 0 and j % 3 == 0 else f"=(k{j})"
            body[key] = WIDE_VALUES[j % len(WIDE_VALUES)]
        if r % 5 == 1:
            body["(name)"] = "c1*"
        docs.append(_rule(f"wide-{r}", {"validate": {"pattern": {
            "spec": {"containers": [body]}}}}))
    docs.append(_rule("wide-big", {"validate": {"pattern": {"spec": {
        "containers": [{f"=(k{j})": WIDE_VALUES[j % len(WIDE_VALUES)]
                        for j in range(big)}]}}}}))
    return docs


def wide_resource(rng, n_keys: int = 300, containers: int = 0) -> dict:
    """A pod of ``containers`` containers (1-16 at random if 0), each
    holding about one key in twenty."""
    values = ["v1", "vx", "x1", 2, 5, 12, True, False, "", None]
    n = containers or int(rng.integers(1, 17))
    cs = []
    for i in range(n):
        c = {"name": f"c{int(rng.integers(0, 20))}"}
        for j in np.nonzero(rng.random(n_keys) < 0.05)[0]:
            c[f"k{j}"] = values[int(rng.integers(len(values)))]
        cs.append(c)
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": f"wide-{int(rng.integers(0, 999))}"},
            "spec": {"containers": cs}}


# ---------------------------------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
# the background scan of BASELINE config 5: 1M library resources
SCAN_RESOURCES = 1_000_000
EXPECTED_HIST = [1160000, 1066000, 262000, 0, 0, 12000]
EXPECTED_SHA = "82a85e14371fdb5944a2fa9d1f20be873a7984cf851eb49abfc43628d0f5c019"
# evaluate() of the same library on mixed_resource(0..n-1), HOST cells
# resolved: the JAX package's CompiledPolicySet.evaluate gives these on
# the CPU (JAX_PLATFORMS=cpu; policies from _synth_policy_docs(250) through
# kyverno_tpu.api.load.load_policy; np.bincount(v.ravel(), minlength=6) and
# sha256 of the C-contiguous int8 bytes), at n = 10,000 and at 1,000
EXPECTED_EVAL_HIST = [1160000, 1078000, 262000, 0, 0, 0]
EXPECTED_EVAL_SHA = "677f52e04e7e837d9776e263b5728eaa25367ced55285f754811ff63f6ae232a"
EXPECTED_EVAL_HIST_1K = [116000, 107800, 26200, 0, 0, 0]
EXPECTED_EVAL_SHA_1K = "be4ff425ca5e5835c24af4485f5d6a5f4cd64517b4ea505ec41c85574c0b9da5"
# the kernels of the evaluate() path
EVALUATE_KERNELS = ("glob_nfa", "eval_rules")
# the kernels of the main path (evaluate_device and the 1M scan)
MAIN_KERNELS = ("glob_nfa", "eval_rules", "eval_rules_scan", "scan_counts")
# the kernels of K7's program, the mesh scan's: each launched once a chunk
# and a data shard (a policy shard row, on a 2D mesh), and no other kernel
MESH_KERNELS = ("glob_nfa", "eval_rules_counts")
# the background scan of BASELINE config 5 on a mesh, cut to two full
# chunks of DEFAULT_CHUNK so that the worker pool runs (the oracle's cost
# of a fresh 1M snapshot is the limit)
MESH_RESOURCES = 131_072
# H100 SXM memory rate (data sheet). A kernel's bound is the larger of the
# bytes it must move (each input read once, each output written once) over
# this rate and, for eval_rules' forms, the integer operations its inputs
# need over INT32_OPS_PER_S (eval_rules_ops); K1 and K5 are held to bytes.
HBM_BYTES_PER_S = 3.35e12
# H100 SXM's INT32 rate: 132 SMs x 64 INT32 lanes (a Hopper SM has 64
# INT32 units beside its 128 FP32 ones) x the data sheet's 1.98 GHz boost
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# eval_rules' integer operations, counted from the plain version's steps
# (ops/eval.py eval_checks_plain, eval_verdict_plain): a check row on one
# slot (leaf and guard masks, the operator's value test, the element
# reduction), an aux row on slot 0 (presence, the test, the kind
# prefilter), a list entry of a rule's walk (pattern entry, aux group, aux
# row: the mask operations it feeds, a 32-resource word at a time), a
# rule's stage-6 composition (mask operations over its three planes, a
# word at a time), a verdict byte from its three planes, and the counts
# form's two population counts a rule and word
OPS_CHECK_SLOT, OPS_AUX_ROW, OPS_ENTRY, OPS_RULE, OPS_BYTE, OPS_COUNT = (
    30, 20, 4, 40, 3, 2)
KERNEL_SOURCES = {
    "glob_nfa": ("kyverno_tpu_torch/csrc/glob_nfa.cu",
                 "kyverno_tpu/ops/glob.py:31"),
    "eval_rules": ("kyverno_tpu_torch/csrc/eval_rules.cu",
                   "kyverno_tpu/ops/eval.py:205"),
    "eval_rules_scan": ("kyverno_tpu_torch/csrc/eval_rules.cu",
                        "kyverno_tpu/ops/eval.py:966"),
    "scan_counts": ("kyverno_tpu_torch/csrc/scan_counts.cu",
                    "kyverno_tpu/ops/eval.py:967"),
    "eval_rules_counts": ("kyverno_tpu_torch/csrc/eval_rules.cu",
                          "kyverno_tpu/parallel/mesh.py:173"),
}


# BASELINE config 4's two policies, as bench.py writes them inline when the
# reference tree is absent (bench.py:974-984 and :1018-1028)
ADD_DEFAULT_LABELS = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "add-default-labels"},
    "spec": {"rules": [{
        "name": "add-labels",
        "match": {"resources": {
            "kinds": ["Pod", "Service", "Namespace"]}},
        "mutate": {"patchStrategicMerge": {"metadata": {"labels": {
            "+(app.kubernetes.io/managed-by)": "kyverno"}}}},
    }]},
}
ANNOTATE_BENCH_APPS = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "annotate-bench-apps"},
    "spec": {"rules": [{
        "name": "annotate",
        "match": {"resources": {"kinds": ["Pod"], "selector": {
            "matchLabels": {"app.kubernetes.io/name": "bench"}}}},
        "mutate": {"patchStrategicMerge": {
            "metadata": {"annotations": {"+(bench/tier)": "gated"}}}},
    }]},
}
# config 4's documents, and the rows of one gate_verdicts chunk
MUTATE_DOCS = 50_000
GATE_CHUNK = 8192
# [autogen]: the library autogen'd as the server autogens it, its resolved
# matrix over autogen_resource(0..n-1), columns by (policy, rule) in
# rule_columns' order. The JAX package gives these on the CPU
# (JAX_PLATFORMS=cpu: kyverno_tpu.policy.autogen's apply_defaults and
# mutate_policy_for_autogen over _synth_policy_docs(250), then
# kyverno_tpu.models.CompiledPolicySet.evaluate, 2,000 resources at a time;
# np.bincount(m.ravel(), minlength=6) and sha256 of the C-contiguous int8
# bytes), at n = 10,000 and at 1,000:
# tests/test_torch_autogen.py::jax_autogen_pin(n) computes them
AUTOGEN_RESOURCES = 10_000
AUTOGEN_RULES = 670
EXPECTED_AUTOGEN_HIST = [4842740, 1182910, 660064, 0, 14286, 0]
EXPECTED_AUTOGEN_SHA = ("a9cffa4eb1b558ba3050f837fadef31ef8f78504d4da046c"
                        "62b1f0d0e17d919b")
EXPECTED_AUTOGEN_HIST_1K = [484120, 118330, 66120, 0, 1430, 0]
EXPECTED_AUTOGEN_SHA_1K = ("d9a555b9f5a7d445391b2d5853eae1763366cfc7851665"
                           "a4d5d9ec53960a379e")


def log(msg: str) -> None:
    print(msg, flush=True)


# the script's clock: seconds since the start at the end of each phase
T_START = time.perf_counter()
CLOCK: list = []


def mark(phase: str) -> None:
    CLOCK.append((phase, round(time.perf_counter() - T_START, 1)))
    log(f"[clock] {phase} ended {CLOCK[-1][1]} s after the script started")


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def same(name: str, a, b) -> int:
    """Exact equality of two tensors (or tuples of them); returns the
    number of elements compared and raises on any difference."""
    import torch

    if isinstance(a, (tuple, list)):
        return sum(same(f"{name}[{i}]", x, y) for i, (x, y) in enumerate(zip(a, b)))
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{name}: {a.dtype}{tuple(a.shape)} vs "
                             f"{b.dtype}{tuple(b.shape)}")
    diff = (a != b)
    if bool(diff.any()):
        idx = torch.nonzero(diff)[0].tolist()
        raise AssertionError(f"{name}: kernel and plain differ at {idx} "
                             f"({int(diff.sum())} elements)")
    return a.numel()


class Stages:
    """The kernel calls of one blob, each beside its plain version."""

    def __init__(self, cps, resources):
        import torch

        from kyverno_tpu_torch.ops import eval as ev

        self.ev = ev
        self.plan = cps.plan
        self.batch = cps.flatten(resources)
        self.blob, self.shape = cps.to_device(self.batch)
        self.B, self.P, self.E, self.V = self.shape
        _, _, dictv, str_bytes = ev.blob_parts(self.blob, *self.shape)
        self.str_bytes, self.str_len = str_bytes, dictv[:, 4]
        torch.cuda.synchronize()

    def k1(self, plain=False):
        from kyverno_tpu_torch.ops import glob

        p = self.plan
        args = (p.nfa_char, p.nfa_is_star, p.nfa_is_q, p.nfa_len,
                self.str_bytes, self.str_len)
        if plain:
            return glob.glob_match_matrix_plain(*args)
        return glob.glob_match_matrix(*args, p.glob)

    def rules(self, match_nv, plain=False, plan=None):
        f = self.ev.eval_rules_plain if plain else self.ev.eval_rules
        return f(plan or self.plan, self.blob, *self.shape, match_nv)

    def scan_form(self, match_nv, plan=None):
        return self.ev.eval_rules_scan(plan or self.plan, self.blob,
                                       *self.shape, match_nv)

    def scan_form_plain(self, match_nv, plan=None):
        plan = plan or self.plan
        return self.ev.scan_masks_plain(
            plan, self.rules(match_nv, plain=True, plan=plan))

    def k5(self, masks, plain=False):
        f = self.ev.scan_reduce_plain if plain else self.ev.scan_reduce
        return f(*masks, self.B)

    def scan(self, plan=None):
        return self.ev.scan_blob(plan or self.plan, self.blob, *self.shape)

    def compare(self, label: str, plan=None) -> dict:
        """Every kernel against its plain version on the same inputs."""
        import torch

        plan = plan or self.plan
        m_k, m_p = self.k1(), self.k1(plain=True)
        n1 = same(f"{label} K1", m_k, m_p)
        v_k = self.rules(m_k, plan=plan)
        v_p = self.rules(m_k, plain=True, plan=plan)
        n2 = same(f"{label} eval_rules", v_k, v_p)
        s_k = self.scan_form(m_k, plan=plan)
        n3 = same(f"{label} eval_rules scan form", s_k,
                  self.ev.scan_masks_plain(plan, v_k))
        n5 = same(f"{label} K5", self.k5(s_k), self.k5(s_k, plain=True))
        # the counts form: the verdicts, and K7's counts over every row of
        # all the rule columns and of the first R - 7
        n7 = 0
        for live in (plan.R, max(0, plan.R - 7)):
            c_v, c_f, c_p = self.ev.eval_rules_counts(
                plan, self.blob, *self.shape, m_k, live)
            n7 += same(f"{label} counts form's verdicts (live={live})", c_v,
                       v_p)
            n7 += same(f"{label} counts form's counts (live={live})",
                       (c_f, c_p), self.ev.rule_counts_plain(c_v[:, :live]))
        counts = self.ev.scan_counts_plain(v_k)
        same(f"{label} scan_blob", self.scan(plan), counts)
        # and the whole plain pipeline from the blob alone
        same(f"{label} plain pipeline", v_k,
             plain_pipeline(plan, self.blob, self.shape))
        # what the scan had to count: FAIL and PASS cells outside HOST
        # rows, and FAIL or PASS cells inside them that it had to drop
        f, p, h = counts
        in_host = v_k[h]
        seen = {"fails": int(f.sum()), "passes": int(p.sum()),
                "host_rows": int(h.sum()),
                "dropped": int(((in_host == 1) | (in_host == 2)).sum())}
        torch.cuda.synchronize()
        return {"glob_nfa": n1, "eval_rules": n2, "eval_rules_scan": n3,
                "scan_counts": n5, "eval_rules_counts": n7}, seen

    def launch(self, plan=None) -> tuple:
        """The geometry of the last eval_rules launch (any form): resources
        a group, shared memory a block, blocks in all, blocks an SM; after
        checking the bytes against the plan's own account of them."""
        plan = plan or self.plan
        geo = tuple(int(x) for x in self.ev.LAST_LAUNCH)
        gs, smem = geo[:2]
        want = plan.smem_bytes(self.E, gs)
        check(smem == want, f"eval_rules took {smem} bytes a block at {gs} "
              f"resources a group, the plan counts {want}")
        return geo


def geometry(geo) -> str:
    """eval_rules' launch geometry (``Stages.launch``) in words."""
    gs, smem, blocks, per_sm = geo
    return (f"{gs} resources a group, {smem} bytes a block, {blocks} "
            f"blocks in all, {per_sm} blocks an SM")


def plain_pipeline(plan, blob, shape):
    """K1 -> stages 2-6 by the plain versions alone."""
    from kyverno_tpu_torch.ops import eval as ev
    from kyverno_tpu_torch.ops import glob

    _, _, dictv, str_bytes = ev.blob_parts(blob, *shape)
    m = glob.glob_match_matrix_plain(plan.nfa_char, plan.nfa_is_star,
                                     plan.nfa_is_q, plan.nfa_len, str_bytes,
                                     dictv[:, 4])
    return ev.eval_rules_plain(plan, blob, *shape, m)


def glob_patterns(rng, strings, n: int) -> list:
    """``n`` seeded glob patterns, most cut from dictionary strings with
    '*' and '?' put in, so that many of them match."""
    pats = []
    while len(pats) < n:
        s = strings[int(rng.integers(len(strings)))][:40]
        chars = list(s) if s and rng.random() < 0.8 else list(
            "ab:-."[int(i)] for i in rng.integers(0, 5, int(rng.integers(0, 12))))
        for k in rng.integers(0, len(chars) + 1, int(rng.integers(0, 4))):
            chars.insert(int(k), "*" if rng.random() < 0.8 else "?")
        if chars and rng.random() < 0.3:
            chars[int(rng.integers(len(chars)))] = "?"
        pats.append("".join(chars))
    return pats


def cuda_ms(fn, n: int, warm: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``n`` launches, each between
    two CUDA events, after ``warm`` warm-up launches."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, n: int = 50) -> float:
    """Milliseconds per call of ``fn`` over ``n`` calls queued back to back
    behind a sleep kernel (about 10 ms), so that the host's time to
    enqueue them overlaps the sleep: the card's own time per call, launch
    gaps included. For calls that enqueue a few launches each, whose
    host time stays under the sleep's."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def oracle_matrix(cps, resources: list) -> np.ndarray:
    """The port's CPU oracle over every rule of every policy, built as
    tests/ops/test_cross_check.py::oracle_matrix builds the JAX package's:
    one ``validate`` per (resource, policy) on a context of the resource
    alone, NOT_APPLICABLE where a rule has no response."""
    from kyverno_tpu_torch.engine.context import Context
    from kyverno_tpu_torch.engine.policy_context import PolicyContext
    from kyverno_tpu_torch.engine.response import RuleStatus
    from kyverno_tpu_torch.engine.validation import validate

    code = {RuleStatus.PASS: 1, RuleStatus.FAIL: 2, RuleStatus.WARN: 1,
            RuleStatus.ERROR: 4, RuleStatus.SKIP: 3}
    out = np.zeros((len(resources), cps.tensors.n_rules), dtype=np.int8)
    for b, resource in enumerate(resources):
        for policy in cps.policies:
            jctx = Context()
            jctx.add_resource(resource)
            resp = validate(PolicyContext(policy=policy, new_resource=resource,
                                          json_context=jctx))
            statuses = {rr.name: rr.status for rr in resp.policy_response.rules}
            for ref in cps.rule_refs:
                if ref.policy is policy and ref.rule.name in statuses:
                    out[b, ref.rule_index] = code[statuses[ref.rule.name]]
    return out


def memo_delta(before: dict, after: dict) -> tuple[int, int]:
    return (after["hits"] - before["hits"], after["misses"] - before["misses"])


def flatten_phase(label: str, cps, resources: list) -> dict:
    """Phase 3: every native flattener entry's packed blob against the
    Python flattener's on ``resources``, byte for byte, with no fallback
    counted. Returns seconds per entry (the second, warm call of each)."""
    from kyverno_tpu_torch.models import native_flatten as nf
    from kyverno_tpu_torch.models.flatten import flatten_batch

    n = len(resources)
    nf.reset_fallbacks()
    t0 = time.perf_counter()
    want = flatten_batch(resources, cps.tensors).packed_blob()[0].tobytes()
    times = {"python": time.perf_counter() - t0}
    entries = {
        "dict walk": lambda: cps.flatten_packed(resources),
        "FlatBatch": lambda: cps.flatten(resources),
        "chunks": lambda: nf.flatten_packed_chunks(cps.tensors, resources),
    }
    for name, fn in entries.items():
        for _ in range(2):
            t0 = time.perf_counter()
            blob = fn().packed_blob()[0]
            times[name] = time.perf_counter() - t0
        check(blob.tobytes() == want, f"[flatten] {label}: the native {name} "
              "entry's blob differs from the Python flattener's")
    check(all(v == 0 for v in nf.FALLBACKS.values()),
          f"[flatten] {label}: fallbacks {nf.FALLBACKS}")
    log(f"[flatten] {label} x {n}: every native entry's blob equal to the "
        f"Python flattener's, byte for byte ({len(want)} bytes); us a "
        f"resource (blob included): " + ", ".join(
            f"{k} {v / n * 1e6:.3f}" for k, v in times.items())
        + f"; fallbacks {nf.FALLBACKS}")
    return times


def evaluate_phase(cps, n: int, anchor, device_v=None) -> dict:
    """Phase 5: ``cps.evaluate`` over mixed_resource(0..n-1) from an empty
    verdict memo, with the launch counters set to 0 just before and read
    just after; evaluate() again, every HOST cell from the memo; the same
    path step by step for its split, the memo emptied again; then the
    anchor corpus x 300 against the full oracle matrix. Returns the
    launches of the first evaluate() run."""
    from kyverno_tpu_torch.ops import _build
    from kyverno_tpu_torch.runtime import hostlane

    memo = hostlane.host_cache()
    resources = [mixed_resource(i) for i in range(n)]
    memo.clear()
    m0 = memo.stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    got = cps.evaluate(resources)
    evaluate_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    m1 = memo.stats()
    log(f"[evaluate] launches of evaluate() at {n}: {launches}")
    for name in EVALUATE_KERNELS:
        check(launches[name] >= 1, f"evaluate() did not launch {name}")
    check(got.shape == (n, cps.tensors.n_rules_live) and got.dtype == np.int8,
          f"evaluate() gave {got.dtype}{got.shape}")
    check(not (got == 5).any(), f"evaluate() left {int((got == 5).sum())} HOST cells")
    hist = np.bincount(got.ravel().astype(np.int64), minlength=6).tolist()
    sha = hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest()
    want_hist, want_sha = ((EXPECTED_EVAL_HIST, EXPECTED_EVAL_SHA) if n == 10_000
                           else (EXPECTED_EVAL_HIST_1K, EXPECTED_EVAL_SHA_1K))
    check(hist == want_hist, f"evaluate() histogram {hist} != {want_hist}")
    check(sha == want_sha, f"evaluate() sha256 {sha} != {want_sha}")
    # a second evaluate(): every HOST cell from the memo, same matrix
    t0 = time.perf_counter()
    again = cps.evaluate(resources)
    again_s = time.perf_counter() - t0
    m2 = memo.stats()
    again_sha = hashlib.sha256(np.ascontiguousarray(again).tobytes()).hexdigest()
    check(again_sha == want_sha, f"a second evaluate() gave sha256 {again_sha}")
    # the same path step by step, timed, from an empty memo; it must give
    # the same matrix
    memo.clear()
    m3 = memo.stats()
    t0 = time.perf_counter()
    batch = cps.flatten(resources)
    batch.packed_blob()
    flatten_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    device = cps.evaluate_device(batch)
    device_s = time.perf_counter() - t0
    if device_v is not None:
        check(np.array_equal(device, device_v),
              "evaluate_device differs from the main path's matrix")
    host = device == 5
    n_host = int(host.sum())
    t0 = time.perf_counter()
    split = cps.resolve_host_cells(resources, device.copy())
    resolve_s = time.perf_counter() - t0
    m4 = memo.stats()
    check(np.array_equal(split, got), "flatten -> evaluate_device -> "
          "resolve_host_cells differs from evaluate()")
    check(np.array_equal(got[~host], device[~host]),
          "evaluate() changed cells that were not HOST")
    # the serial loop on the same cells (the host lane's switches off),
    # for comparison in the same run
    saved = {k: os.environ.get(k) for k in OFF_SWITCHES if k != "KTPU_NATIVE"}
    os.environ.update({k: "0" for k in saved})
    try:
        t0 = time.perf_counter()
        serial = cps.resolve_host_cells(resources, device.copy())
        serial_s = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(np.array_equal(serial, got), "the serial loop's resolve differs")
    first, second, in_split = memo_delta(m0, m1), memo_delta(m1, m2), memo_delta(m3, m4)
    check(first == (0, n_host) and in_split == (0, n_host),
          f"evaluate() from an empty memo: (hits, misses) {first} and {in_split}, "
          f"{n_host} HOST cells")
    check(second == (n_host, 0), f"the second evaluate(): (hits, misses) {second}, "
          f"{n_host} HOST cells")
    resolved = np.bincount(got[host].astype(np.int64), minlength=6).tolist()
    threads = hostlane.resolver()._max_workers
    log(f"[evaluate] library 250 x {n}: evaluate() {evaluate_s:.3f} s (memo "
        f"{first[0]} hits, {first[1]} misses; no prefetch in evaluate(), as in "
        f"the JAX package), again {again_s:.3f} s (memo {second[0]} hits, "
        f"{second[1]} misses, same sha256); split: native flatten "
        f"{flatten_s:.3f} s ({flatten_s / n * 1e6:.2f} us a resource), "
        f"evaluate_device {device_s * 1e3:.3f} ms, resolve {resolve_s:.3f} s for "
        f"{n_host} HOST cells ({resolve_s / max(n_host, 1) * 1e6:.1f} us a cell; "
        f"memo {in_split[0]} hits, {in_split[1]} misses; prefetch 0 cells "
        f"applied; fan-out over {threads} threads); the serial loop (host lane "
        f"switched off) {serial_s:.3f} s ({serial_s / max(n_host, 1) * 1e6:.1f} us "
        f"a cell); resolved HOST cells "
        f"{resolved}; histogram {hist}; sha256 {sha}")

    # the anchor corpus: evaluate() on the card against the full oracle
    rng = np.random.default_rng(11)
    a_res = [random_resource(rng) for _ in range(300)]
    a_dev = anchor.evaluate_device(anchor.flatten(a_res))
    t0 = time.perf_counter()
    a_got = anchor.evaluate(a_res)
    a_eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    a_want = oracle_matrix(anchor, a_res)
    oracle_s = time.perf_counter() - t0
    diff = np.argwhere(a_got != a_want)
    check(diff.size == 0, f"anchor corpus: evaluate() differs from the oracle "
          f"matrix in {len(diff)} cells, first (b, r) {diff[:3].tolist()}")
    a_hist = np.bincount(a_got.ravel().astype(np.int64), minlength=6).tolist()
    a_res_hist = np.bincount(a_got[a_dev == 5].astype(np.int64),
                             minlength=6).tolist()
    log(f"[evaluate] anchor corpus x 300: {int((a_dev == 5).sum())} HOST cells "
        f"resolved to {a_res_hist}; evaluate() {a_eval_s:.3f} s, the oracle "
        f"over every rule {oracle_s:.3f} s; equal cell for cell; histogram "
        f"{a_hist}")
    check(int((a_dev == 5).sum()) > 0, "the anchor corpus left no HOST cell")
    check(all(a_hist[v] > 0 for v in (1, 2, 3, 4)),
          f"the anchor corpus's resolved matrix lacks PASS, FAIL, SKIP or "
          f"ERROR: {a_hist}")
    return launches


OFF_SWITCHES = {"KTPU_NATIVE": "0", "KTPU_HOST_PREFETCH": "0",
                "KTPU_HOST_MEMO": "0", "KTPU_HOST_FANOUT": "0"}


def pipelined_phase(cps, n: int, chunk: int = 1024) -> dict:
    """Phase 6: ``cps.evaluate_pipelined`` over mixed_resource(0..n-1)
    from an empty memo, with the launch counters set to 0 just before and
    read just after (K1 and eval_rules once a chunk); the pinned sha256
    and no HOST cell; the chunks' traces read for the flatten, dispatch,
    join and resolve seconds and the prefetch's overlap_s. Then again with
    the native flattener and the host lane switched off. Returns the
    launches of the first run."""
    from kyverno_tpu_torch.ops import _build
    from kyverno_tpu_torch.runtime import hostlane, tracing

    resources = [mixed_resource(i) for i in range(n)]
    n_chunks = -(-n // chunk)
    want_sha = EXPECTED_EVAL_SHA if n == 10_000 else EXPECTED_EVAL_SHA_1K
    rec = tracing.recorder()
    # room for a chunk's row spans (a prefetch and a resolve span a row)
    rec.max_spans = max(rec.max_spans, 8 * chunk)
    out = {}
    for mode, env in (("on", {}), ("off", OFF_SWITCHES)):
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            hostlane.host_cache().clear()
            rec.clear()
            s0 = dict(hostlane.resolver().stats)
            _build.reset_launches()
            t0 = time.perf_counter()
            got = cps.evaluate_pipelined(resources, chunk=chunk)
            wall = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        want = {"glob_nfa": n_chunks, "eval_rules": n_chunks,
                "eval_rules_scan": 0, "eval_rules_counts": 0,
                "scan_counts": 0}
        check(launches == want, f"evaluate_pipelined ({mode}) launched "
              f"{launches}, not {want}")
        check(not (got == 5).any(), f"evaluate_pipelined ({mode}) left "
              f"{int((got == 5).sum())} HOST cells")
        sha = hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest()
        check(sha == want_sha, f"evaluate_pipelined ({mode}) sha256 {sha}")
        traces = [t for t in rec.traces(4 * n_chunks) if t.kind == "scan_chunk"]
        check(len(traces) == n_chunks and not any(t.spans_dropped for t in traces),
              f"{len(traces)} chunk traces of {n_chunks}, spans dropped "
              f"{[t.spans_dropped for t in traces]}")
        spans = {}
        for t in traces:
            for sp in t.spans:
                tot = spans.setdefault(sp.name, [0, 0.0, 0, 0])
                tot[0] += 1
                tot[1] += sp.duration_s
                tot[2] += int(sp.labels.get("overlap_us", 0))
                tot[3] += int(sp.labels.get("applied", 0))
        st = {k: v - s0.get(k, 0) for k, v in hostlane.resolver().stats.items()}
        join = spans.get("host_join", [0, 0.0, 0, 0])
        overlap_s = join[2] / 1e6
        if mode == "on":
            check(join[0] == n_chunks and join[3] > 0,
                  f"evaluate_pipelined: {join[0]} prefetch joins, {join[3]} cells applied")
        log(f"[pipelined] evaluate_pipelined library 250 x {n}, chunk {chunk}, "
            f"switches {mode} ({'defaults' if not env else env}): wall "
            f"{wall:.3f} s; launches {launches}; no HOST cell; sha256 {sha}; "
            f"prefetch {st.get('prefetch_submitted', 0)} cells submitted, "
            f"{join[3]} applied, overlap_s {overlap_s:.3f}; span seconds summed "
            f"over chunks: " + ", ".join(
                f"{k} {v[1]:.3f} ({v[0]})" for k, v in sorted(spans.items())
                if k in ("flatten", "device_dispatch", "host_join", "host_resolve")))
        out[mode] = (got, launches)
    check(np.array_equal(out["on"][0], out["off"][0]),
          "evaluate_pipelined differs with the switches off")
    return out["on"][1]


# ------------------------------------------------------------- admission
# bench.py's burst_library_250: 16 threads x 16 distinct admissions
ADMISSION_THREADS, ADMISSION_PER_THREAD = 16, 16


def admission_request(i: int, salt: str) -> tuple[dict, dict]:
    """One distinct admission, as bench.py's _admission_body makes it
    (make_pod(i) under a salted name and uid: images, labels and
    resources vary with i), and the context payload the webhook's ctx_cb
    gives the flush for it."""
    pod = make_pod(i)
    pod["metadata"]["name"] = f"pod-{salt}{i}"
    request = {"uid": f"uid-{salt}{i}", "kind": {"kind": "Pod"},
               "namespace": "default", "operation": "CREATE", "object": pod}
    return pod, {"request": request, "namespace_labels": {}, "roles": [],
                 "cluster_roles": [], "exclude_group_role": []}


def percentiles(lats: list) -> tuple[float, float]:
    """(p50, p99), nearest rank, as bench.py reports them."""
    lats = sorted(lats)
    p99 = lats[min(len(lats) - 1, -(-99 * len(lats) // 100) - 1)]
    return statistics.median(lats), p99


def library_matrix(cache, library_docs: list, resources: list) -> np.ndarray:
    """The library's resolved matrix [B, 250] from a policy cache: each
    kind's enforce population (Pod, Deployment, Service) through
    ``evaluate()``, its columns placed at the library's rule order (a
    policy's verdicts do not depend on the other policies, and each
    library policy has one rule and one kind)."""
    from kyverno_tpu_torch.runtime.policycache import PolicyType

    col = {d["metadata"]["name"]: j for j, d in enumerate(library_docs)}
    out = np.zeros((len(resources), len(library_docs)), dtype=np.int8)
    filled = set()
    for kind in ("Pod", "Deployment", "Service"):
        c = cache.compiled(PolicyType.VALIDATE_ENFORCE, kind, "default")
        m = c.evaluate(resources)
        for ref in c.rule_refs:
            out[:, col[ref.policy.name]] = m[:, ref.rule_index]
            filled.add(ref.policy.name)
    check(filled == set(col), f"{len(col) - len(filled)} library policies "
          "in no population")
    return out


def span_summary(traces) -> str:
    """Spans of the given flush traces by name (and lane, for a row's
    host resolution): count, mean and largest milliseconds; then the
    flushes' own p50 and largest."""
    by = {}
    for tr in traces:
        for sp in tr.spans:
            key = sp.name if sp.name != "host_resolve_row" else \
                f"host_resolve_row[{sp.labels.get('lane')}]"
            by.setdefault(key, []).append(sp.duration_s * 1e3)
    durs = [tr.duration_s * 1e3 for tr in traces]
    return ("; ".join(f"{k} {len(v)} x {statistics.mean(v):.3f} (max "
                      f"{max(v):.3f})" for k, v in sorted(by.items()))
            + (f"; flush p50 {statistics.median(durs):.3f}, max "
               f"{max(durs):.3f}" if durs else ""))


def flush_split(flushes, calls) -> dict:
    """Where the given flush traces spent their time, each stage as (sum
    ms, largest ms of one flush): ``flush`` the whole flush, ``answered``
    (from its start to its last waiter's answer), ``flatten``,
    ``memo_store`` (the row memo's store), ``call`` (the dispatch's call
    into the runtime, from ``calls``: DispatchLog records of the same
    flushes), ``host_join`` (the wait on the host lane's prefetch),
    ``fanout`` (the host-lane pass after the join), ``scatter`` (the
    flush's counts in bulk and the answers handed to the waiters). ``cells`` counts the HOST cells the
    flushes' host lane resolved by lane (memo, pool, inline)."""
    stages = {k: [] for k in ("flush", "answered", "flatten", "memo_store",
                              "call", "host_join", "fanout", "scatter")}
    cells = {"memo": 0, "pool": 0, "inline": 0}
    for tr in flushes:
        per = {k: 0.0 for k in stages}
        per["flush"] = tr.duration_s * 1e3
        for sp in tr.spans:
            ms = sp.duration_s * 1e3
            if sp.name == "scatter":
                per["answered"] = max(per["answered"],
                                      (sp.t1 - tr.t_start) * 1e3)
            if sp.name in ("flatten", "memo_store", "host_join", "scatter"):
                per[sp.name] += ms
            elif sp.name == "scatter_counts":
                per["scatter"] += ms
            elif sp.name == "host_resolve":
                per["fanout"] += ms
            elif sp.name == "host_resolve_row":
                lab = sp.labels
                cells["memo"] += int(lab.get("memo_hits", 0))
                lane = lab.get("lane")
                if lane in ("pool", "inline"):
                    cells[lane] += int(lab.get("misses", 0))
        # the join runs inside the host_resolve span
        per["fanout"] = max(0.0, per["fanout"] - per["host_join"])
        for k, v in per.items():
            stages[k].append(v)
    for rec in calls:
        try:
            ph = rec["handle"].phases()
        except Exception:
            ph = None
        stages["call"].append(0.0 if not ph else ph["call"])
    out = {k: (round(sum(v), 3), round(max(v, default=0.0), 3))
           for k, v in stages.items()}
    out["cells"] = cells
    return out


def k6_split(cps, batch, n: int = 50) -> dict:
    """``evaluate_device_async(batch).get()`` split by phase, K6 (donate)
    and the plain route, medians of ``n`` calls each. ``wall`` is the
    call with its ``get()`` on the host clock, untimed inside. Then the
    same calls with ``engine.PHASE_TIMING`` on time their own steps
    (``engine._Phases.ms``): ``call`` (the one call into the runtime, on
    the host), ``replay`` (K6: the graph's H2D, K1, eval_rules and D2H)
    or ``launch`` and ``d2h`` (the plain route) between CUDA events on
    the card, ``read`` and ``dispatch`` (until the call returned its
    handle) on the host. ``timed`` is the host time of such a call with
    its ``get()`` (the events and clocks make it slower than ``wall``),
    and ``wrapper`` that time less the steps: packing the blob, the
    slot, the handle, the locks and the events."""
    from kyverno_tpu_torch.models import engine

    blob, shp = batch.packed_blob()
    host = np.ascontiguousarray(blob).view(np.int32)
    split = {}
    for key, donate in (("on", True), ("off", False)):
        for _ in range(3):
            cps.evaluate_device_async(batch, donate=donate).get()
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            cps.evaluate_device_async(batch, donate=donate).get()
            ts.append((time.perf_counter() - t0) * 1e3)
        engine.PHASE_TIMING = True
        runs = []
        try:
            for k in range(n + 3):
                t0 = time.perf_counter()
                h = cps.evaluate_device_async(batch, donate=donate)
                h.get()
                t1 = time.perf_counter()
                if k >= 3:
                    runs.append({**h.phases(), "timed": (t1 - t0) * 1e3})
        finally:
            engine.PHASE_TIMING = False
        for r in runs:
            # the steps are K6's (staging, replay, read) or the plain
            # route's (h2d, launches, d2h, read); dispatch spans them
            r["wrapper"] = r["timed"] - sum(
                v for k, v in r.items() if k not in ("dispatch", "timed"))
        d = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        d["wall"] = statistics.median(ts)
        split[key] = d
    # the least time K1 -> eval_rules could take on the card: the blob,
    # the plan and the NFA rows read once, the verdicts written once
    plan = cps.plan
    bound = (host.nbytes + plan.buf.numel() * 4 + shp[0] * plan.R
             + sum(t.numel() * t.element_size() for t in (
                 plan.nfa_char, plan.nfa_is_star, plan.nfa_is_q,
                 plan.nfa_len))) / HBM_BYTES_PER_S * 1e3
    return {**split, "shape": shp, "blob_bytes": host.nbytes,
            "bound_ms": bound}


# the phase split's steps, as the two routes name them (with the names
# of the steps before K6's one-call dispatch, for an older tree's split):
# host, then the card
SPLIT_STEPS = {"call": "the call into the runtime (host)",
               "staging": "host staging", "replay":
               "the graph's replay on the card (H2D, launches, D2H)",
               "launch": "H2D + launches on the card", "h2d": "H2D",
               "launches": "launches", "d2h": "D2H", "read": "read"}


def split_line(split: dict) -> str:
    return "; ".join(
        f"{'K6 (donate)' if k == 'on' else 'plain route'}: wall "
        f"{d['wall']:.4f}; timed inside, {d['timed']:.4f} = wrapper "
        f"{d['wrapper']:.4f} + " + " + ".join(
            f"{v} {d[s_]:.4f}" for s_, v in SPLIT_STEPS.items() if s_ in d)
        + f" (returned after {d['dispatch']:.4f})"
        for k, d in (("on", split["on"]), ("off", split["off"])))


def fit_shape(batch, shp):
    """``batch`` padded with dead rows, slots and strings (zero fill, as
    the flattener pads) to the shape bucket ``shp`` = (B, P, E, V), or
    None where it does not fit."""
    from kyverno_tpu_torch.models.flatten import PackedBatch

    B, P, E, V = shp
    b, p, e, _ = batch.cells.shape
    v = int(batch.dictv.shape[0])
    if b > B or p != P or e > E or v > V:
        return None
    return PackedBatch(
        n=B, e=E,
        cells=np.pad(batch.cells, [(0, B - b), (0, 0), (0, E - e), (0, 0)]),
        bmeta=np.pad(batch.bmeta, (0, B - b)),
        str_bytes=np.pad(batch.str_bytes, [(0, V - v), (0, 0)]),
        dictv=np.pad(batch.dictv, [(0, V - v), (0, 0)]))


def replay_against_direct(cps, label: str, salt: str, n: int = 32) -> dict:
    """Every K6 shape bucket of ``cps`` through ``n`` batches of different
    contents (1 to 16 resources, padded to the bucket): K6's replay of
    a slot's CUDA graph against the direct launches (K1 -> eval_rules on a
    device copy of the same blob), with zero tolerance. Each dispatch must
    be a replay (a reused slot), and each of the two routes must count one
    launch of K1 and one of eval_rules a batch. The group size and bytes
    that each slot's capture chose are held to the plan's account of
    them. Returns {shape: (batches, slots, eval_rules' launch geometry of
    the slots)}."""
    import torch
    from kyverno_tpu_torch.ops import _build
    from kyverno_tpu_torch.ops import eval as ev
    from kyverno_tpu_torch.runtime.batch import AdmissionBatcher

    live = cps.tensors.n_rules_live
    with cps._k6_lock:
        shapes = sorted(cps._k6)
    check(shapes, f"{label} no K6 bucket to check")
    out = {}
    # 1 to 16 resources a batch, drawn from three families in turn: salted
    # admission Pods (many strings), plain make_pod(i) (fewer; k copies of
    # one, which fit the smallest string tables) and mixed resources
    def candidates():
        for i in range(64 * n):
            k = 1 + i % 16
            family = i // 16 % 4
            if family == 0:
                yield [admission_request(i + j, salt)[0] for j in range(k)]
            elif family == 1:
                yield [make_pod(i + j) for j in range(k)]
            elif family == 2:
                yield [make_pod(i // 64)] * k
            else:
                yield [mixed_resource(i + j) for j in range(k)]

    for shp in shapes:
        batches, seen = [], set()
        for docs in candidates():
            b = fit_shape(AdmissionBatcher._pad_admission(
                cps.flatten_packed(docs), floor=1)[0], shp)
            if b is None:
                continue
            key = hashlib.sha256(np.ascontiguousarray(
                b.packed_blob()[0]).tobytes()).digest()
            if key not in seen:
                seen.add(key)
                batches.append(b)
                if len(batches) == n:
                    break
        check(len(batches) == n, f"{label} only {len(batches)} batches of "
              f"different contents fit the K6 bucket {shp}")
        d0 = dict(cps.donation_stats)
        l0 = dict(_build.LAUNCHES)
        for b in batches:
            got = cps.evaluate_device_async(b, donate=True).get()
            blob = torch.from_numpy(np.ascontiguousarray(
                b.packed_blob()[0]).view(np.int32)).to(cps.device)
            want = ev.evaluate_blob(cps.plan, blob, *shp)[:, :live]
            same(f"{label} K6 replay against the direct launches at {shp}",
                 torch.from_numpy(got), want.cpu())
        d = {k: cps.donation_stats[k] - d0[k] for k in d0}
        check(d == {"dispatches": n, "donated_buffers": n},
              f"{label} the bucket {shp}'s dispatches were not all replays "
              f"of a slot: {d}")
        moved = {k: _build.LAUNCHES[k] - l0[k] for k in l0}
        check(moved == {"glob_nfa": 2 * n, "eval_rules": 2 * n,
                        "eval_rules_scan": 0, "eval_rules_counts": 0,
                        "scan_counts": 0},
              f"{label} {n} replays and {n} direct calls at {shp} counted "
              f"{moved}")
        with cps._k6_lock:
            ring = list(cps._k6[shp])
        for slot in ring:
            tb, nbytes = (int(x) for x in slot.launch[:2])
            check(slot.kernels == EVALUATE_KERNELS, f"{label} a slot at {shp} "
                  f"captured {slot.kernels}")
            want = cps.plan.smem_bytes(shp[2], tb)
            check(nbytes == want,
                  f"{label} a slot's capture at {shp} chose {nbytes} bytes a "
                  f"block at {tb} resources a group, the plan counts {want}")
        out[shp] = (n, len(ring), sorted({tuple(int(x) for x in s_.launch)
                                          for s_ in ring}))
    log(f"{label} K6 replay against the direct launches (K1 -> eval_rules), "
        f"{n} batches of different contents a bucket, zero tolerance: every "
        f"verdict equal; bucket: (batches, slots, (resources a group, bytes "
        f"a block, blocks in all, blocks an SM) of their captures): "
        f"{out}")
    return out


# the first rows of the 10,000 that [background]'s 2D (4, 1) lane scans
# (cut from 2,000 for the time limit)
BACKGROUND_2D_ROWS = 1_000
# the single and 1D mesh lanes scan the first BACKGROUND_LANE_ROWS (cut
# from 10,000 to 2,000 to 1,000 for the time limit; the incremental
# lane scans all n)
BACKGROUND_LANE_ROWS = 1_000
# the objects the garbage collector tracks when a full run reaches
# [admission] (383,731 on an H100 machine): --heap fills an
# --admission run's heap to this size
FULL_RUN_HEAP = 383_731
# --cold-flush: None leaves the bursts as they are; True / False begins
# each timed burst on a cold shape bucket with the release on / off
COLD_FLUSH = None
# each timed burst's routing counters, in order
BURST_STATS: list = []
# --pool-workers: None sizes the oracle pool as the pool does (cores - 1)
POOL_WORKERS = None
# a scheduling-lag sample this late (ms) is a stall
STALL_MS = 10.0


def favored_inputs(batcher, est_batch: int, n_policies: int) -> dict:
    """What ``AdmissionBatcher._device_favored`` reads, read at once, with
    its answer for a batch of ``est_batch`` over ``n_policies``: the cost
    model that sends a burst to the device or to the oracle."""
    with batcher._lock:
        snap = {"est_batch": est_batch, "n_policies": n_policies,
                "burst_threshold": batcher.burst_threshold,
                "batch_size_ema": round(batcher._batch_size_ema, 3),
                "oracle_policy_cost_ms":
                    round(batcher._oracle_policy_cost * 1e3, 6),
                "savings_frac": batcher._savings_frac,
                "flush_cpu_cost_ms": round(batcher._flush_cpu_cost * 1e3, 6),
                "dispatch_cost_ms": round(batcher._dispatch_cost * 1e3, 6),
                # what _device_favored reads: the cost after its idle decay
                "dispatch_estimate_ms": round(batcher._dispatch_estimate(
                    time.monotonic()) * 1e3, 6),
                "pending_flushes": batcher._pending_flushes,
                "window_ms": round(batcher._window() * 1e3, 6),
                "circuit_open": time.monotonic() < batcher._circuit_open_until}
    feed = batcher.dispatch_cost_feeds[-1] if batcher.dispatch_cost_feeds \
        else None
    snap["cost_feed"] = None if feed is None else {
        "feed": feed[1], "sample_ms": round(feed[2] * 1e3, 3),
        "cost_ms": round(feed[3] * 1e3, 3),
        "s_ago": round(time.monotonic() - feed[0], 3)}
    snap["favored"] = batcher._device_favored(est_batch, n_policies)
    return snap


# a dispatch this slow (ms, from the call to its verdicts read) is logged
# with its phase split, the collector's pauses and the threads beside it
SLOW_DISPATCH_MS = 100.0
# every slow dispatch of an --admission run, for its summary
SLOW_DISPATCHES: list = []


class _TimedHandle:
    """An evaluate_device_async handle that notes when its verdicts were
    first read."""

    def __init__(self, handle, rec: dict):
        self._handle, self._rec = handle, rec

    def get(self):
        v = self._handle.get()
        self._rec.setdefault("t_got", time.perf_counter())
        return v

    def __getattr__(self, name):
        return getattr(self._handle, name)


class DispatchLog:
    """While entered, every ``evaluate_device_async`` call (the admission
    flushes', probes' and warm-ups') is noted: its route, thread, the
    interpreter's switch interval and the oracle threads alive as it
    began, when it returned its handle and when its verdicts were read;
    ``engine.PHASE_TIMING`` is on, so each call on the card also times
    its own steps. The collector's pauses are noted beside them.
    ``in_oracle`` counts the client threads inside the inline oracle."""

    def __init__(self):
        self.calls, self.pauses, self._gc = [], [], {}
        # K6's slot picks (t0, t1, thread, set, shape) and slot captures
        # (t0, t1, thread, set, shape, whether the ring's lock was held)
        self.picks, self.captures = [], []
        # K6 slots' finalizers (t0, t1)
        self.finals = []
        self.in_oracle = 0
        self._lock = threading.Lock()

    def oracle(self, delta: int) -> None:
        with self._lock:
            self.in_oracle += delta

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc[threading.get_ident()] = (time.perf_counter(),
                                               time.thread_time())
        else:
            t0 = self._gc.pop(threading.get_ident(), None)
            if t0 is not None:
                # the collecting thread's own CPU beside the wall: a
                # collection whose finalizers give up the interpreter lock
                # waits behind every other thread each time
                self.pauses.append((info["generation"], t0[0],
                                    time.perf_counter(),
                                    time.thread_time() - t0[1],
                                    info.get("collected", 0)))

    def __enter__(self):
        from kyverno_tpu_torch.models import engine

        self.engine = engine
        orig = self._orig = engine.CompiledPolicySet.evaluate_device_async
        calls = self.calls

        def timed(cps, batch, donate=False):
            rec = {"t0": time.perf_counter(),
                   "thread": threading.current_thread().name,
                   "route": ("k6" if donate and engine.donation_enabled()
                             else "plain"),
                   "switch_s": sys.getswitchinterval(),
                   "hostlane_threads": sum(
                       1 for t in threading.enumerate()
                       if t.name.startswith("ktpu-hostlane")),
                   "in_oracle": self.in_oracle,
                   "shape": batch.packed_blob()[1]}
            h = orig(cps, batch, donate=donate)
            rec["t_ret"] = time.perf_counter()
            rec["handle"] = h
            calls.append(rec)
            return _TimedHandle(h, rec)

        engine.CompiledPolicySet.evaluate_device_async = timed
        self._orig_pick = engine.CompiledPolicySet._k6_slot
        self._orig_capture = engine._Slot._capture
        picking = threading.local()
        picks, captures = self.picks, self.captures
        pick0, capture0 = self._orig_pick, self._orig_capture

        def pick(cps, shp, words):
            picking.cps = cps
            t0 = time.perf_counter()
            try:
                return pick0(cps, shp, words)
            finally:
                picks.append((t0, time.perf_counter(),
                              threading.get_ident(), id(cps), shp))
                picking.cps = None

        def capture(slot, plan, shp):
            cps = getattr(picking, "cps", None)
            locked = cps is not None and cps._k6_lock._is_owned()
            t0 = time.perf_counter()
            try:
                return capture0(slot, plan, shp)
            finally:
                captures.append((t0, time.perf_counter(),
                                 threading.get_ident(),
                                 None if cps is None else id(cps), shp,
                                 locked))

        self._orig_del = engine._Slot.__del__
        del0, finals = self._orig_del, self.finals

        def finalize(slot):
            t0 = time.perf_counter()
            try:
                del0(slot)
            finally:
                finals.append((t0, time.perf_counter()))

        engine.CompiledPolicySet._k6_slot = pick
        engine._Slot._capture = capture
        engine._Slot.__del__ = finalize
        engine.PHASE_TIMING = True
        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on_gc)
        self.engine.PHASE_TIMING = False
        self.engine.CompiledPolicySet.evaluate_device_async = self._orig
        self.engine.CompiledPolicySet._k6_slot = self._orig_pick
        self.engine._Slot._capture = self._orig_capture
        self.engine._Slot.__del__ = self._orig_del

    def gc2_report(self, since: float) -> list:
        """Each generation-2 collection since ``since``: wall ms, the
        collecting thread's CPU ms, objects collected, and the K6 slots
        finalized inside it with their ms."""
        out = []
        for g, p0, p1, cpu, collected in self.pauses:
            if g != 2 or p0 < since:
                continue
            inside = [f1 - f0 for f0, f1 in self.finals
                      if p0 <= f0 and f1 <= p1]
            out.append((round((p1 - p0) * 1e3, 3), round(cpu * 1e3, 3),
                        collected, len(inside),
                        round(sum(inside) * 1e3, 3)))
        return out

    def capture_report(self, since: float) -> dict:
        """K6's slot captures since ``since`` (perf_counter): how many,
        their ms, the ms of them spent holding the ring's lock, and the
        slot picks of other threads on the same set that began during a
        capture and returned only after it ended (flushes that waited on
        it, not having begun a capture of their own meanwhile (flushes
        that waited on it), with the ms they waited."""
        caps = [c for c in self.captures if c[0] >= since]
        waited, wait_ms = 0, 0.0
        for c0, c1, tid, cps, _, _ in caps:
            for p0, p1, ptid, pcps, _ in self.picks:
                if (ptid != tid and pcps == cps and c0 <= p0 < c1 <= p1
                        and not any(t == ptid and p0 <= a < c1
                                    for a, _, t, *_ in caps)):
                    waited += 1
                    wait_ms += (c1 - p0) * 1e3
        return {"captures": len(caps),
                "capture_ms": round(sum(c1 - c0 for c0, c1, *_ in caps)
                                    * 1e3, 3),
                "capture_max_ms": round(max((c1 - c0 for c0, c1, *_ in caps),
                                            default=0.0) * 1e3, 3),
                "locked_ms": round(sum(c[1] - c[0] for c in caps if c[5])
                                   * 1e3, 3),
                "waited": waited, "waited_ms": round(wait_ms, 3)}

    def report(self, label: str, traces: list, batcher, since: float) -> dict:
        """Log every call since ``since`` (perf_counter) slower than
        SLOW_DISPATCH_MS with its split and surroundings, and the
        dispatch-cost feeds of that window over the same mark; return the
        calls' counts and dispatch ms by route."""
        spans = [(sp, tr) for tr in traces for sp in tr.spans
                 if sp.name in ("device_dispatch", "cold_dispatch")]
        mono0 = time.monotonic() - (time.perf_counter() - since)
        by = {}
        for rec in [c for c in self.calls if c["t0"] >= since]:
            t1 = rec.get("t_got", rec["t_ret"])
            ms = (t1 - rec["t0"]) * 1e3
            by.setdefault(rec["route"], []).append(ms)
            if ms <= SLOW_DISPATCH_MS:
                continue
            try:
                split = rec["handle"].phases()
            except Exception as e:          # noted, not raised
                split = f"not read: {e!r}"
            gcs = {}
            for g, p0, p1, *_ in self.pauses:
                if p0 < t1 and rec["t0"] < p1:
                    n, tot = gcs.get(g, (0, 0.0))
                    gcs[g] = (n + 1, round(tot + (p1 - p0) * 1e3, 3))
            flush = next((tr for sp, tr in spans if sp.tid == rec["thread"]
                          and abs(sp.t0 - rec["t0"]) < 0.01), None)
            slow = {"burst": label, "route": rec["route"],
                    "thread": rec["thread"], "ms": round(ms, 3),
                    "until_handle_ms": round((rec["t_ret"] - rec["t0"])
                                             * 1e3, 3),
                    "after_handle_ms": round((t1 - rec["t_ret"]) * 1e3, 3),
                    "split": split, "gc": gcs, "switch_s": rec["switch_s"],
                    "hostlane_threads": rec["hostlane_threads"],
                    "in_oracle": rec["in_oracle"], "shape": rec["shape"],
                    "flush": (None if flush is None else {
                        "probe": flush.labels.get("probe"),
                        "batch": flush.labels.get("batch"),
                        "spans": span_summary([flush])})}
            SLOW_DISPATCHES.append(slow)
            log(f"[admission] slow dispatch ({SLOW_DISPATCH_MS} ms or more): "
                f"{slow}")
        feeds = [(round(t - mono0, 3), f, round(x * 1e3, 3), round(v * 1e3, 3))
                 for t, f, x, v in list(batcher.dispatch_cost_feeds)
                 if t >= mono0 and x * 1e3 > SLOW_DISPATCH_MS]
        if feeds:
            log(f"[admission] {label}: dispatch-cost feeds over "
                f"{SLOW_DISPATCH_MS} ms (s into the window, feed, sample ms, "
                f"cost after ms): {feeds}")
        return {k: (len(v), round(statistics.median(v), 3),
                    round(max(v), 3)) for k, v in by.items()}


def fill_heap(target: int) -> list:
    """Mixed resources, kept alive by the caller, until the garbage
    collector tracks ``target`` objects."""
    out = []
    gc.collect()
    while len(gc.get_objects()) < target:
        out.extend(mixed_resource(len(out) + i) for i in range(1000))
    return out


def admission_phase(library_docs: list, run: str = "") -> dict:
    """Phase 7: the admission path at full width, shaped like bench.py's
    burst_library_250. The 250-policy library in enforce mode goes into a
    PolicyCache on the card (incremental compile, rule buckets), an
    AdmissionBatcher with the JAX package's defaults screens 16 threads x
    16 distinct pods, each wrapped in ``admission_in_flight`` and passing
    its request payload as ``ctx_cb`` (as the webhook does), with an
    OraclePool attached to the host lane (ensured before each burst).
    Warm-up as bench.py's: one sequential pass, one concurrent round per
    warm pool, then the timed burst, with the launch counters set to 0
    just before it. Every device answer is held to the port's oracle on
    that pod; the burst again with KTPU_DONATE=0; a lone request must
    route ORACLE. Then K6's phase split, a one-policy update's refresh,
    and the library's 250 x 10k resolved matrix through the cache,
    incremental and with KTPU_INCREMENTAL=0, against the pinned sha256.
    ``run`` prefixes the bursts' salts, so that a repeat of the phase in
    one process screens pods that no memo has seen. Returns the timed
    burst's launches."""
    from kyverno_tpu_torch.api.load import load_policy
    from kyverno_tpu_torch.models import Verdict, engine
    from kyverno_tpu_torch.ops import _build
    from kyverno_tpu_torch.runtime import featureplane, hostlane, tracing
    from kyverno_tpu_torch.runtime.batch import (ATTENTION, CLEAN, ORACLE,
                                                 AdmissionBatcher)
    from kyverno_tpu_torch.runtime.oracle_pool import MIN_CORES, OraclePool
    from kyverno_tpu_torch.runtime.policycache import PolicyCache, PolicyType

    enf = PolicyType.VALIDATE_ENFORCE
    check(featureplane.enabled_strict("KTPU_INCREMENTAL"),
          "KTPU_INCREMENTAL is off")
    enforce = [dict(d, spec=dict(d["spec"], validationFailureAction="enforce"))
               for d in library_docs]
    from kyverno_tpu_torch.runtime import metrics

    mem0 = metrics.cuda_memory_stats(0)
    cache = PolicyCache()
    for d in enforce:
        cache.add(load_policy(d))
    t0 = time.perf_counter()
    cps = cache.compiled(enf, "Pod", "default")
    compile_s = time.perf_counter() - t0
    t = cps.tensors
    check(t.dict_base is not None and t.n_rules > t.n_rules_live,
          f"the Pod population is not a bucketed incremental set: "
          f"n_rules {t.n_rules}, live {t.n_rules_live}")
    log(f"[admission] library 250 in enforce mode, Pod population: "
        f"{len(cps.policies)} policies, n_rules {t.n_rules} (the rule "
        f"bucket) of which n_rules_live {t.n_rules_live}, "
        f"{int(t.rule_host_only[:t.n_rules_live].sum())} host-only; "
        f"incremental compile {compile_s:.3f} s (plan {cps.plan_s:.3f} s) "
        f"on {cps.device}")

    batcher = AdmissionBatcher(cache)
    pool = OraclePool(workers=POOL_WORKERS)
    resolver = hostlane.resolver()
    resolver.attach_pool(pool, cache)
    rec = tracing.recorder()
    cores = os.cpu_count()
    out = {}
    dlog = DispatchLog()
    try:
        t0 = time.perf_counter()
        pool.ensure(*cache.snapshot())
        if pool.enabled:
            while not pool.ready(cache.generation) \
                    and time.perf_counter() - t0 < 120:
                time.sleep(0.05)
            check(pool.ready(cache.generation), "the oracle pool did not "
                  "come up in 120 s")
            log(f"[admission] os.cpu_count() {cores}: oracle pool of "
                f"{pool.workers} spawned workers ready in "
                f"{time.perf_counter() - t0:.3f} s")
        else:
            log(f"[admission] os.cpu_count() {cores} < MIN_CORES "
                f"{MIN_CORES}: the oracle pool stays dormant (not a failure)")
        a0 = dict(engine.K6_ALLOC)
        rec.clear()
        t0 = time.perf_counter()
        batcher.warmup(enf, "Pod", "default", make_pod(1))
        cold = [sp.duration_s for tr in rec.traces(256) for sp in tr.spans
                if sp.name == "cold_dispatch"]
        log(f"[admission] warmup (the controller's, batch sizes 1 and 16, "
            f"one shape bucket) {time.perf_counter() - t0:.3f} s; its cold "
            f"flushes' first dispatch {[round(c * 1e3, 3) for c in cold]} ms")

        def one(pod, payload, answers):
            """One admission as the webhook handles it: in flight for the
            router, screened with its payload, and through the inline
            oracle over every enforce rule when the screen routes it
            there (ORACLE, or ATTENTION with no cells). Appends (pod,
            payload, status, row, screen ms, request ms)."""
            with batcher.admission_in_flight():
                t1 = time.perf_counter()
                status, row = batcher.screen(enf, "Pod", "default", pod,
                                             ctx_cb=lambda: payload)
                t2 = time.perf_counter()
                if status == ORACLE or (status == ATTENTION and not row):
                    cur = cache.compiled(enf, "Pod", "default")
                    dlog.oracle(1)
                    try:
                        cur._oracle_verdicts(
                            pod, list(range(cur.tensors.n_rules_live)),
                            context=payload)
                    finally:
                        dlog.oracle(-1)
                t3 = time.perf_counter()
            answers.append((pod, payload, status, row, (t2 - t1) * 1e3,
                            (t3 - t1) * 1e3))

        def concurrent_round(reqs, answers):
            per = -(-len(reqs) // ADMISSION_THREADS)
            start = threading.Barrier(ADMISSION_THREADS)

            def client(s):
                start.wait()
                for p, c in s:
                    one(p, c, answers)

            ws = [threading.Thread(target=client,
                                   args=(reqs[w * per:(w + 1) * per],))
                  for w in range(ADMISSION_THREADS)]
            t1 = time.perf_counter()
            for w in ws:
                w.start()
            for w in ws:
                w.join()
            return time.perf_counter() - t1

        n_req = ADMISSION_THREADS * ADMISSION_PER_THREAD

        def quiesce():
            """Wait for every submitted flush to end (a cold flush runs on
            after it released its waiters)."""
            end = time.perf_counter() + 60
            while time.perf_counter() < end:
                with batcher._lock:
                    if batcher._pending_flushes == 0:
                        return
                time.sleep(0.005)
            raise AssertionError("[admission] flushes still running after 60 s")

        def burst(salt):
            since = time.perf_counter()
            with dlog:
                return burst_logged(salt, since)

        def burst_logged(salt, since):
            pool.ensure(*cache.snapshot())
            warm_misses0 = pool.misses
            for p, c in [admission_request(i, f"{salt}s") for i in range(32)]:
                one(p, c, [])
            pre = dict(batcher.stats)
            for r in range(2):
                concurrent_round([admission_request(i, f"{salt}w{r}")
                                  for i in range(n_req)], [])
            if (batcher.stats.get("circuit_open", 0) > pre.get("circuit_open", 0)
                    or batcher.stats.get("screen_timeout", 0)
                    > pre.get("screen_timeout", 0)):
                time.sleep(batcher.circuit_cooldown_s + 0.2)
            reqs = [admission_request(i, salt) for i in range(n_req)]
            answers = []
            quiesce()
            warm_traces = rec.traces(256) + rec.slowest(32)
            rec.clear()
            if COLD_FLUSH is not None:
                # begin the timed burst on a cold shape bucket: forget the
                # buckets the warm-up saw; the release on or off
                with batcher._lock:
                    batcher._seen_shapes.clear()
                batcher.cold_flush_fallback = COLD_FLUSH
            s0, d0 = dict(batcher.stats), dict(engine.DONATION_STATS)
            k0 = dict(engine.K6_ALLOC)
            pc0 = resolver.stats["pool_cells"]
            hits0, misses0 = pool.hits, pool.misses
            # the pool's own breaker (consecutive misses) as the burst
            # begins: seconds it stays shut
            pool_shut_s = max(0.0, pool._disabled_until - time.monotonic())
            # the garbage collector's pauses inside the burst, by generation
            pauses, started, spans = [], {}, []

            def on_gc(phase, info):
                if phase == "start":
                    started["t"] = time.perf_counter()
                elif "t" in started:
                    t1 = started.pop("t")
                    now = time.perf_counter()
                    pauses.append((info["generation"], (now - t1) * 1e3))
                    spans.append((t1, now))

            # the main process's scheduling lag inside the burst: how late
            # a 1 ms sleep wakes up, which the GIL and the cores decide
            lag, lag_at, lag_stop = [], [], threading.Event()

            def lag_sampler():
                while not lag_stop.is_set():
                    t1 = time.perf_counter()
                    time.sleep(0.001)
                    t2 = time.perf_counter()
                    lag.append((t2 - t1) * 1e3 - 1.0)
                    lag_at.append((t1, t2))

            sampler = threading.Thread(target=lag_sampler, daemon=True)
            # the cost model's inputs as the timed burst begins
            favored = favored_inputs(
                batcher, ADMISSION_THREADS,
                len(cache.compiled(enf, "Pod", "default").policies))
            _build.reset_launches()
            gc.callbacks.append(on_gc)
            t_timed = time.perf_counter()
            sampler.start()
            try:
                burst_s = concurrent_round(reqs, answers)
            finally:
                lag_stop.set()
                sampler.join()
                gc.callbacks.remove(on_gc)
            quiesce()
            launches = dict(_build.LAUNCHES)
            flushes = [tr for tr in rec.traces(256) if tr.kind == "flush"
                       and {"device_dispatch", "cold_dispatch"}
                       & tr.stage_names()]
            stats = {k: v - s0.get(k, 0) for k, v in batcher.stats.items()
                     if isinstance(v, (int, float))}
            donated = {k: engine.DONATION_STATS[k] - d0[k] for k in d0}
            gc2 = [p for q, p in pauses if q == 2]
            # the sampler's stalls (a wake-up STALL_MS or more late), apart
            # by whether a collector's pause overlaps them
            stalls = {"gc": [], "other": []}
            for ms, (w0, w1) in zip(lag, lag_at):
                if ms >= STALL_MS:
                    stalls["gc" if any(w0 < g1 and g0 < w1 for g0, g1 in spans)
                           else "other"].append(ms)
            stall = {k: (len(v), round(sum(v), 1), round(max(v, default=0.0),
                                                         1))
                     for k, v in stalls.items()}
            # the timed burst's flushes' split, K6's slot captures in the
            # burst and its warm rounds, and where the HOST cells went
            split = flush_split(flushes, [c for c in dlog.calls
                                          if c["t0"] >= t_timed])
            split.update(dlog.capture_report(since))
            split["gc2_detail"] = dlog.gc2_report(since)
            split.update(run=salt, pool_cells=resolver.stats["pool_cells"] - pc0,
                         pool_misses=pool.misses - misses0,
                         warm_pool_misses=misses0 - warm_misses0,
                         pool_shut_s=round(pool_shut_s, 3),
                         gc2=(len(gc2), round(sum(gc2), 3),
                              round(max(gc2, default=0.0), 3)),
                         screen_timeout=stats.get("screen_timeout", 0))
            BURST_STATS.append(dict(stats, gc2_ms=sum(gc2),
                                    gc2_max_ms=max(gc2, default=0.0),
                                    stall_gc_ms=stall["gc"][1],
                                    stall_other_ms=stall["other"][1],
                                    split=split))
            # the device-answered requests (a device row: CLEAN, or
            # ATTENTION with its cells) apart from those the screen gave
            # up on (ATTENTION with no cells: a timeout, a cold release
            # or a failed flush) and those routed ORACLE
            by = {"device": [], "gave_up": [], "oracle": []}
            for _, _, status, row, a, b in answers:
                by["oracle" if status == ORACLE else "device" if row
                   else "gave_up"].append((a, b))
            dev = by["device"] or [(0.0, 0.0)]
            p50, p99 = percentiles([a for a, _ in dev])
            r50, r99 = percentiles([b for _, b in dev])
            gave_up = percentiles([a for a, _ in by["gave_up"]]) \
                if by["gave_up"] else (0.0, 0.0)
            every = percentiles([a for *_, a, _ in answers])
            live = [int(tr.labels.get("batch", 0)) for tr in flushes
                    if tr.labels.get("probe") != "probe"]
            dispatch = dlog.report(salt, warm_traces + rec.traces(256)
                                   + rec.slowest(32),
                                   batcher, since)
            return {"dispatch": dispatch, "answers": answers, "burst_s": burst_s,
                    "split": split,
                    "launches": launches, "flushes": len(flushes),
                    "spans": span_summary(flushes),
                    "gc": {g: (len([p for q, p in pauses if q == g]),
                               sum(p for q, p in pauses if q == g),
                               max([p for q, p in pauses if q == g],
                                   default=0.0))
                           for g in sorted({q for q, _ in pauses})},
                    "mean_batch": statistics.mean(live) if live else 0.0,
                    "stats": stats, "donated": donated, "p50": p50,
                    "p99": p99, "request_p50": r50, "request_p99": r99,
                    "n": {k: len(v) for k, v in by.items()},
                    "every_p50": every[0], "every_p99": every[1],
                    "k6_alloc": (engine.K6_ALLOC["slots"] - k0["slots"],
                                 (engine.K6_ALLOC["seconds"]
                                  - k0["seconds"]) * 1e3),
                    "gave_up_p50": gave_up[0], "gave_up_max": max(
                        [a for a, _ in by["gave_up"]], default=0.0),
                    "pool_cells": resolver.stats["pool_cells"] - pc0,
                    "pool_hits": pool.hits - hits0,
                    "pool_misses": pool.misses - misses0,
                    "lag": (percentiles(lag)[1] if lag else 0.0,
                            max(lag, default=0.0)),
                    "stall": stall, "favored": favored,
                    "rps": n_req / burst_s,
                    "device_rps": len(by["device"]) / burst_s}

        def hold_to_oracle(label, res):
            """Every device answer against the port's oracle on its pod."""
            cur = cache.compiled(enf, "Pod", "default")
            rules = list(range(cur.tensors.n_rules_live))
            idx = {(r.policy.name, r.rule.name): r.rule_index
                   for r in cur.rule_refs}
            kinds = {}
            t1 = time.perf_counter()
            for pod, payload, status, row, _, _ in res["answers"]:
                kinds[status] = kinds.get(status, 0) + 1
                if status == ORACLE or (status == ATTENTION and not row):
                    continue
                want = cur._oracle_verdicts(pod, rules, context=payload)
                cells = {idx[(p, r)]: (v, m) for p, r, v, m in row}
                for ri, (v, msg) in want.items():
                    got = cells.get(ri)
                    if got is None:
                        check(v == Verdict.NOT_APPLICABLE,
                              f"[admission] {label}: {pod['metadata']['name']} "
                              f"rule {ri} left out, the oracle says {v!r}")
                        continue
                    check(got[0] == v, f"[admission] {label}: "
                          f"{pod['metadata']['name']} rule {ri}: screen "
                          f"{got[0]!r}, oracle {v!r}")
                    check(not got[1] or got[1] == msg, f"[admission] {label}: "
                          f"{pod['metadata']['name']} rule {ri}: message "
                          f"{got[1]!r}, oracle {msg!r}")
                if status == CLEAN:
                    check(all(v not in (Verdict.FAIL, Verdict.ERROR)
                              for v, _ in want.values()),
                          f"[admission] {label}: CLEAN for "
                          f"{pod['metadata']['name']}, the oracle fails it")
            return kinds, time.perf_counter() - t1

        runs = {}
        # in turns: K6, the plain route, the plain route, K6
        for n_run, (label, env) in enumerate((
                ("donate on", {}), ("KTPU_DONATE=0", {"KTPU_DONATE": "0"}),
                ("KTPU_DONATE=0", {"KTPU_DONATE": "0"}), ("donate on", {}))):
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                res = burst(f"{run}r{n_run}")
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            log(f"[admission] burst {label}: the timed flushes' split, ms "
                f"(sum, largest of one flush), K6's slot captures in the "
                f"burst and its warm rounds (ms; ms with the ring's lock "
                f"held; picks that waited on one, and their ms), HOST cells "
                f"by lane, pool misses (timed, warm rounds), the pool's "
                f"breaker shut s at the start, generation-2 pauses (count, "
                f"ms, largest ms), screen timeouts: {res['split']}")
            kinds, check_s = hold_to_oracle(label, res)
            st = res["stats"]
            check(st.get("device", 0) > 0 and res["n"]["device"] > 0,
                  f"[admission] {label}: no request answered by the device "
                  f"lane: {st}, answers {res['n']}; flush spans, ms: "
                  f"{res['spans']}; pool cells {res['pool_cells']} in "
                  f"{res['pool_hits']} calls, {res['pool_misses']} pool "
                  f"misses (a timeout or a refusal); garbage-collector "
                  f"pauses {res['gc']}; scheduling lag p99, max "
                  f"{res['lag'][0]:.3f}, {res['lag'][1]:.3f} ms; "
                  f"evaluate_device_async calls by route {res['dispatch']}; "
                  f"stalls of "
                  f"{STALL_MS} ms or more (count, total ms, largest ms) "
                  f"during a collector's pause {res['stall']['gc']}, "
                  f"outside one {res['stall']['other']}; _device_favored's "
                  f"inputs as the burst began {res['favored']}; split "
                  f"{res['split']}")
            # every answer without a device row is accounted for: a flush
            # never fails, and each ATTENTION with no cells is a screen
            # timeout or a flush's release of its waiter (a cold bucket)
            check(batcher.stats.get("flush_error", 0) == 0,
                  f"[admission] {label}: {batcher.stats.get('flush_error')} "
                  "flushes failed")
            check(res["n"]["gave_up"] == st.get("screen_timeout", 0)
                  + st.get("flush_fallback", 0),
                  f"[admission] {label}: {res['n']['gave_up']} answers "
                  f"without cells, {st.get('screen_timeout', 0)} screen "
                  f"timeouts, {st.get('flush_fallback', 0)} released by "
                  "a flush")
            for k in EVALUATE_KERNELS:
                check(res["launches"][k] == res["flushes"],
                      f"[admission] {label}: {k} launched "
                      f"{res['launches'][k]} times for {res['flushes']} "
                      f"device flushes")
            if env:
                check(res["donated"] == {"dispatches": 0,
                                         "donated_buffers": 0},
                      f"[admission] KTPU_DONATE=0 dispatched through K6: "
                      f"{res['donated']}")
            else:
                check(res["donated"]["dispatches"] > 0
                      and res["donated"]["donated_buffers"] > 0,
                      f"[admission] K6 dispatches {res['donated']}")
            if pool.enabled:
                check(res["pool_cells"] > 0, f"[admission] {label}: the "
                      "pool resolved no cell")
            log(f"[admission] burst {label}, {ADMISSION_THREADS} threads x "
                f"{ADMISSION_PER_THREAD} distinct pods: {res['n']['device']} "
                f"answered by the device: screen p50 {res['p50']:.3f} ms, "
                f"p99 {res['p99']:.3f} ms, {res['device_rps']:.1f} a second; "
                f"{res['n']['gave_up']} given up on (screen timeout or a "
                f"flush's release) after p50 {res['gave_up_p50']:.3f} ms, max "
                f"{res['gave_up_max']:.3f} ms, then the inline oracle; "
                f"{res['n']['oracle']} routed ORACLE; every answer's screen "
                f"p50 {res['every_p50']:.3f} ms, p99 {res['every_p99']:.3f} "
                f"ms; the request (the "
                f"inline oracle after a screen without cells included) of the "
                f"device-answered p50 {res['request_p50']:.3f} ms, p99 "
                f"{res['request_p99']:.3f} ms; all {res['rps']:.1f} "
                f"requests/s ({res['burst_s']:.3f} s); "
                f"{res['flushes']} device flushes, mean batch "
                f"{res['mean_batch']:.2f}; launches {res['launches']}; "
                f"answers {kinds}, every device answer equal to the oracle "
                f"({check_s:.3f} s to check); routing " + ", ".join(
                    f"{k} {st.get(k, 0)}" for k in (
                        "oracle", "device", "clean", "attention", "cache",
                        "screen_timeout", "flush_fallback", "cold_release",
                        "flush_error", "circuit_open"))
                + f"; row memo hits {st.get('flatten_cache_hit_rows', 0)}, "
                f"misses {st.get('flatten_cache_miss_rows', 0)}; host cells "
                f"resolved {st.get('host_cells_resolved', 0)}, prefetched "
                f"{st.get('host_prefetch_cells', 0)}; pool_cells "
                f"{res['pool_cells']} ({res['pool_hits']} pool calls); K6 "
                f"{res['donated']}, slots allocated in the burst "
                f"{res['k6_alloc'][0]} ({res['k6_alloc'][1]:.3f} ms); "
                f"{nvidia_smi_line()}")
            log(f"[admission] burst {label}: flush spans, ms (count x mean): "
                f"{res['spans']}; garbage-collector pauses in the burst by "
                f"generation (count, total ms, largest ms): {res['gc']}; "
                f"pool misses {res['pool_misses']}; the main process's "
                f"scheduling lag p99 {res['lag'][0]:.3f} ms, max "
                f"{res['lag'][1]:.3f} ms; its stalls of {STALL_MS} ms or "
                f"more (count, total ms, largest ms) during a collector's "
                f"pause {res['stall']['gc']}, outside one "
                f"{res['stall']['other']}; _device_favored's inputs as the "
                f"burst began {res['favored']}; evaluate_device_async calls "
                f"in the burst and its warm rounds by route (count, median "
                f"ms, largest ms): {res['dispatch']}")
            runs.setdefault(label, []).append(res)
        out["burst"] = runs["donate on"][0]
        out["replay"] = replay_against_direct(
            cache.compiled(enf, "Pod", "default"), "[admission]",
            f"{run}rvd")
        log(f"[admission] K6 slots allocated {engine.K6_ALLOC['slots'] - a0['slots']} "
            f"in {engine.K6_ALLOC['seconds'] - a0['seconds']:.4f} s "
            f"(the cold cost of a shape bucket's K6 buffers)")

        # a lone request: below the burst threshold, straight to the oracle
        time.sleep(2 * batcher.rate_window_s)
        o0 = batcher.stats["oracle"]
        pod, _ = admission_request(0, "lone")
        status, row = batcher.screen(enf, "Pod", "default", pod)
        check(status == ORACLE and row == [] and batcher.stats["oracle"] == o0 + 1,
              f"[admission] a lone request routed {status}")
        log(f"[admission] a lone request routes {status}")

        # K6 split at the burst's flush shape, and at 10k (the shape of
        # the main path's evaluate_device)
        reqs = [admission_request(i, "split")[0] for i in range(16)]
        batch, _ = AdmissionBatcher._pad_admission(cps.flatten_packed(reqs))
        big = cps.flatten_packed([mixed_resource(i) for i in range(10_000)])
        out["split"] = {}
        for label, b in (("flush", batch), ("10k", big)):
            split = k6_split(cps, b)
            log(f"[admission] evaluate_device_async(batch).get() at the "
                f"{label} shape {split['shape']} ({split['blob_bytes']} blob "
                f"bytes), ms, medians: {split_line(split)}; bound of K1 -> "
                f"eval_rules on the card {split['bound_ms']:.5f} ms by "
                f"bytes; {nvidia_smi_line()}")
            out["split"][label] = split

        # a one-policy update: the refresh, then the first warm flush
        name = next(d["metadata"]["name"] for d in enforce
                    if d["spec"]["rules"][0]["match"]["resources"]["kinds"]
                    == ["Pod"])
        doc = next(d for d in enforce if d["metadata"]["name"] == name)
        t0 = time.perf_counter()
        cache.update(load_policy(doc))
        cps2 = cache.compiled(enf, "Pod", "default")
        refresh_s = time.perf_counter() - t0
        cs = cache.compile_stats
        check(cs["mode"] == "incremental" and cs["segments_recompiled"] == 1,
              f"[admission] a one-policy update compiled {cs}")
        deadline = time.perf_counter() + 60
        while batcher._rewarm_pending and time.perf_counter() < deadline:
            time.sleep(0.01)
        t0 = time.perf_counter()
        pool.ensure(*cache.snapshot())
        while (pool.enabled and not pool.ready(cache.generation)
               and time.perf_counter() < deadline):
            time.sleep(0.01)
        respawn_s = time.perf_counter() - t0
        first = None
        for r in range(3):
            rec.clear()
            concurrent_round([admission_request(i, f"upd{r}")
                              for i in range(4 * ADMISSION_THREADS)], [])
            warm = sorted((tr.t_start, tr.seq, tr) for tr in rec.traces(256)
                          if tr.kind == "flush"
                          and "device_dispatch" in tr.stage_names())
            if warm:
                first = warm[0][2]
                break
        check(first is not None, "[admission] no warm flush after the update")
        certified = cache._incremental[(int(enf), "Pod", "default")] \
            .last_refresh_certify
        check(certified and not certified.get("divergent"),
              f"[admission] the refresh certified {certified}")
        log(f"[admission] one-policy update ({name}): refresh "
            f"{refresh_s:.4f} s = host compile {cs['seconds'] - cps2.plan_s:.4f} "
            f"s (1 segment recompiled, {cs['segments_reused']} reused, its "
            f"rules certified: {certified}) + plan "
            f"and K1 tables {cps2.plan_s:.4f} s; the first warm flush after "
            f"it {first.duration_s * 1e3:.3f} ms ({first.labels.get('batch')} "
            f"rows; spans, ms: {span_summary([first])}); the pool's workers "
            f"for the new generation ready in {respawn_s:.3f} s")

        # the library's 250 x 10k resolved matrix through the cache
        resources = [mixed_resource(i) for i in range(10_000)]
        t0 = time.perf_counter()
        m = library_matrix(cache, library_docs, resources)
        inc_s = time.perf_counter() - t0
        sha = hashlib.sha256(np.ascontiguousarray(m).tobytes()).hexdigest()
        check(sha == EXPECTED_EVAL_SHA, f"[admission] the refreshed cache's "
              f"250 x 10k matrix sha256 {sha}")
        os.environ["KTPU_INCREMENTAL"] = "0"
        try:
            full = PolicyCache()
            for d in enforce:
                full.add(load_policy(d))
            t0 = time.perf_counter()
            m0 = library_matrix(full, library_docs, resources)
            full_s = time.perf_counter() - t0
            check(full.compile_stats["mode"] == "full",
                  f"KTPU_INCREMENTAL=0 compiled {full.compile_stats}")
        finally:
            os.environ.pop("KTPU_INCREMENTAL", None)
        sha0 = hashlib.sha256(np.ascontiguousarray(m0).tobytes()).hexdigest()
        check(sha0 == EXPECTED_EVAL_SHA, f"[admission] KTPU_INCREMENTAL=0: "
              f"250 x 10k matrix sha256 {sha0}")
        log(f"[admission] the library's 250 x 10k resolved matrix through the "
            f"policy cache (Pod, Deployment and Service populations, "
            f"evaluate()): sha256 {sha} after the update ({inc_s:.3f} s), and "
            f"{sha0} with KTPU_INCREMENTAL=0 ({full_s:.3f} s)")
    finally:
        batcher.stop()
        resolver.attach_pool(None, None)
        pool.stop()
    log(f"[admission] metrics.cuda_memory_stats(0) before the phase {mem0}, "
        f"after it {metrics.cuda_memory_stats(0)}; K6 slots allocated "
        f"{engine.K6_ALLOC['slots']} in this process")
    return out


# ------------------------------------------------------------- webhook
# bench.py's bench_config1 over the port's WebhookServer: a fixed body 200
# times on one keep-alive connection, then 16 threads x 32 distinct bodies
WEBHOOK_SEQUENTIAL = 200
WEBHOOK_THREADS, WEBHOOK_PER_THREAD = 16, 32


def webhook_body(i: int, salt: str = "", traceparent: bool = False) -> bytes:
    """One distinct AdmissionReview, as bench.py's _admission_body makes
    it: make_pod(i) under a salted name and uid."""
    pod = make_pod(i)
    pod["metadata"]["name"] = f"pod-{salt}{i}"
    return json.dumps({
        "apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
        "request": {"uid": f"uid-{salt}{i}", "kind": {"kind": "Pod"},
                    "namespace": "default", "operation": "CREATE",
                    "object": pod},
    }).encode()


def traceparent_for(uid: str) -> str:
    """A caller's W3C traceparent whose trace id is a digest of ``uid``."""
    return (f"00-{hashlib.blake2b(uid.encode(), digest_size=16).hexdigest()}"
            f"-00f067aa0ba902b7-01")


def webhook_client(port: int, bodies: list, path: str = "/validate",
                   traced: bool = False) -> list:
    """POST each body on one keep-alive connection; (ms, response, body,
    completion time) a request. ``traced`` sends each request with a
    traceparent of its own (:func:`traceparent_for` its uid)."""
    import http.client
    import socket

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.connect()
    conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    out = []
    try:
        for b in bodies:
            headers = {"Content-Type": "application/json"}
            if traced:
                headers["traceparent"] = traceparent_for(
                    json.loads(b)["request"]["uid"])
            t0 = time.perf_counter()
            conn.request("POST", path, b, headers)
            r = conn.getresponse()
            raw = r.read()
            t1 = time.perf_counter()
            check(r.status == 200, f"[webhook] POST {path}: HTTP {r.status} "
                  f"{raw[:200]!r}")
            out.append(((t1 - t0) * 1e3, json.loads(raw)["response"], b, t1))
    finally:
        conn.close()
    return out


def webhook_burst(port, bodies: list, threads: int,
                  path: str = "/validate", traced: bool = False
                  ) -> tuple[float, list]:
    """``threads`` clients, each on a keep-alive connection of its own
    with an equal slice of ``bodies``, started together; (wall seconds,
    answers). ``port`` may be a list: client ``w`` then talks to
    ``port[w % len(port)]``."""
    ports = port if isinstance(port, list) else [port]
    per = -(-len(bodies) // threads)
    start = threading.Barrier(threads)
    results: list = [None] * threads

    def client(w):
        start.wait()
        results[w] = webhook_client(ports[w % len(ports)],
                                    bodies[w * per:(w + 1) * per], path,
                                    traced)

    ws = [threading.Thread(target=client, args=(w,)) for w in range(threads)]
    t0 = time.perf_counter()
    for w in ws:
        w.start()
    for w in ws:
        w.join()
    wall = time.perf_counter() - t0
    check(all(r is not None for r in results), "[webhook] a client failed")
    return wall, [a for r in results for a in r]


def same_answer(got: dict, ref: dict, server, policies: dict,
                request: dict) -> str | None:
    """How the batcher lane's response ``got`` says what the oracle
    lane's ``ref`` says for ``request``: "exact" when the two are equal;
    "device" when they differ only in that the denial's lines of the
    policies the webhook denied from the device row come first, each line
    the one ``server._device_deny_messages`` writes for the oracle's
    failing rule (or the oracle's own line, for a cell the flush
    resolved on the host), and the oracle lane's other lines follow in
    its order; None otherwise."""
    from kyverno_tpu_torch.models import Verdict

    if got == ref:
        return "exact"
    if ({k: v for k, v in got.items() if k != "status"}
            != {k: v for k, v in ref.items() if k != "status"}
            or got["allowed"] or "status" not in got or "status" not in ref):
        return None
    # a line a (policy, rule); a message may span lines of its own
    head, *got_lines = re.split(r"\n(?=policy )", got["status"]["message"])
    ref_head, *ref_lines = re.split(r"\n(?=policy )",
                                    (ref.get("status") or {}).get("message",
                                                                  ""))
    if head != ref_head or set(got["status"]) != set(ref["status"]):
        return None

    def pair(line):
        if not line.startswith("policy ") or ": " not in line:
            return None
        p, _, r = line[len("policy "):].split(": ", 1)[0].partition("/")
        return p, r

    oracle_line = {pair(ln): ln for ln in ref_lines}
    for k in range(1, len(got_lines) + 1):
        prefix = got_lines[:k]
        pairs = [pair(ln) for ln in prefix]
        if None in pairs:
            return None
        denied = {p for p, _ in pairs}
        rest = [ln for ln in ref_lines if (pair(ln) or ("",))[0] not in denied]
        if got_lines[k:] != rest or sorted(pairs) != sorted(
                pr for pr in oracle_line if pr and pr[0] in denied):
            continue
        for (p, r), ln in zip(pairs, prefix):
            device = server._device_deny_messages(
                policies.get(p), [(r, Verdict.FAIL, "")], request=request,
                resource=request.get("object") or {})
            if ln != oracle_line[(p, r)] and ln not in (device or ()):
                return None
        return "device"
    return None


def lane_line(label: str, answers: list, wall: float) -> str:
    p50, p99 = percentiles([a[0] for a in answers])
    return (f"{label}: {len(answers)} requests, p50 {p50:.3f} ms, p99 "
            f"{p99:.3f} ms, {len(answers) / wall:.1f} requests/s "
            f"({wall:.3f} s)")


class WideRing:
    """While entered, the trace recorder keeps the last 8,192 traces: a
    burst's admission traces and its flush traces together outnumber the
    ring's 256."""

    def __enter__(self):
        from collections import deque

        from kyverno_tpu_torch.runtime import tracing

        self.rec = tracing.recorder()
        self.saved = self.rec._ring
        self.rec._ring = deque(self.saved, maxlen=8192)
        return self

    def __exit__(self, *exc):
        if hasattr(self, "saved"):
            self.rec._ring = self.saved


def routing(stats: dict, before: dict) -> dict:
    return {k: stats.get(k, 0) - before.get(k, 0) for k in (
        "oracle", "device", "clean", "attention", "cache", "device_decided",
        "device_deny", "screen_timeout", "flush_fallback", "cold_release",
        "flush_error", "circuit_open")}


def observe(port: int, sent: int, traced: list, label: str,
            expect_dispatch: bool = True) -> dict:
    """The observability routes of a webhook server that has answered
    ``sent`` admissions, ``traced`` of them with a traceparent of their
    own: /metrics counts every request and shows the card's memory (fed
    once from torch.cuda just before), /healthz answers, /debug/traces
    holds the traced admissions under their callers' ids with the
    flushes' device_dispatch spans, and an admission with a screen
    span."""
    import http.client

    from kyverno_tpu_torch.runtime import metrics

    metrics.record_device_memory(metrics.registry(),
                                 metrics.cuda_memory_stats(0), device="0")
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", "/metrics")
        r = conn.getresponse()
        text = r.read().decode()
        check(r.status == 200, f"[webhook] /metrics HTTP {r.status}")
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        health = json.loads(r.read())
        check(r.status == 200 and health.get("status") in ("ok", "degraded"),
              f"[webhook] /healthz HTTP {r.status}: {health}")
        conn.request("GET", "/debug/traces?n=8192")
        r = conn.getresponse()
        traces = json.loads(r.read())["traces"]
        check(r.status == 200, f"[webhook] /debug/traces HTTP {r.status}")
    finally:
        conn.close()
    requests = sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
                   if ln.startswith("kyverno_admission_requests_total{"))
    check(requests == sent, f"[webhook] {label}: /metrics counts {requests} "
          f"admission requests, {sent} were sent")
    memory = {ln.split("kind=\"", 1)[1].split("\"", 1)[0]:
              float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
              if ln.startswith("kyverno_device_memory_bytes{")}
    check(memory.get("bytes_in_use", 0) > 0, f"[webhook] {label}: device "
          f"memory gauges {memory}")
    admissions = [t for t in traces if t["kind"] == "admission"]
    by_id = {t["trace_id"]: t for t in admissions}
    want = {traceparent_for(u).split("-")[1] for u in traced}
    adopted = [by_id[i] for i in want if i in by_id]
    check(len(adopted) == len(want), f"[webhook] {label}: {len(adopted)} of "
          f"{len(want)} traced admissions exported under the caller's id")
    spans = [{s["name"] for s in t["spans"]} for t in admissions]
    dispatched = sum(1 for t in adopted
                     if {"device_dispatch", "cold_dispatch"}
                     & {s["name"] for s in t["spans"]})
    screened = sum(1 for s in spans if "screen" in s)
    check(dispatched > 0 or not expect_dispatch, f"[webhook] {label}: no "
          "traced admission holds a device_dispatch span")
    check(screened > 0, f"[webhook] {label}: no admission trace holds a "
          "screen span")
    log(f"[webhook] {label}: /metrics counts {int(requests)} admission "
        f"requests (all sent), device memory {memory}; /healthz "
        f"{health['status']}; /debug/traces: {len(admissions)} admission "
        f"traces, the {len(adopted)} traced ones under their callers' ids, "
        f"{dispatched} of them with the flush's device_dispatch, {screened} "
        f"admissions with a screen span")
    return {"requests": requests, "memory": memory, "dispatched": dispatched}


def webhook_phase(library_docs: list, quick: bool = False) -> dict:
    """[webhook]: the port's admission webhook over HTTP, shaped like
    bench.py's bench_config1. One policy: 200 sequential POSTs of one
    body on a keep-alive connection, then 16 threads x 32 distinct
    bodies. The library (``quick`` leaves it out): warmed as bench.py
    warms, then a timed burst of 16 x 16 distinct Pods with the launch
    counters set to 0 just before, each request with a traceparent of its
    own; every answer equal to a second server without a batcher (the
    oracle lane) given the same review, a denial from the device row
    line by line as the webhook writes it for the oracle's failing rules;
    device answers, K1 and eval_rules once a device flush, K6 dispatches;
    the observability routes. Then the same Pods through /mutate against
    the serial mutate() chain, and a policy through /policyvalidate and
    /policymutate against the [autogen] steps. Returns the burst's
    launches and lanes."""
    from kyverno_tpu_torch.api.load import load_policy
    from kyverno_tpu_torch.models import engine
    from kyverno_tpu_torch.ops import _build
    from kyverno_tpu_torch.runtime import hostlane, metrics, tracing
    from kyverno_tpu_torch.runtime.batch import AdmissionBatcher
    from kyverno_tpu_torch.runtime.client import FakeCluster
    from kyverno_tpu_torch.runtime.policycache import PolicyCache, PolicyType
    from kyverno_tpu_torch.runtime.webhook import WebhookServer

    enf = PolicyType.VALIDATE_ENFORCE
    smi = nvidia_smi_line()
    out = {}
    rec = tracing.recorder()
    metrics.registry().reset()

    # ---- one policy, as bench_config1
    one = dict(_synth_policy_docs(1)[0])
    one["spec"] = dict(one["spec"], validationFailureAction="enforce")
    cache = PolicyCache()
    cache.add(load_policy(one))
    batcher = AdmissionBatcher(cache)
    server = WebhookServer(policy_cache=cache, client=FakeCluster(),
                           admission_batcher=batcher)
    ring = WideRing()
    try:
        ring.__enter__()
        port = server.run(host="127.0.0.1", port=0).server_address[1]
        fixed = webhook_body(1, "bench")
        first = webhook_client(port, [fixed] * 11)
        check(first[0][1]["allowed"] is True, f"[webhook] the fixed body "
              f"(nginx:1.21) was denied: {first[0][1]}")
        s0 = dict(batcher.stats)
        seq = webhook_client(port, [fixed] * WEBHOOK_SEQUENTIAL)
        seq_stats = routing(batcher.stats, s0)
        bodies = [webhook_body(i, "s")
                  for i in range(WEBHOOK_THREADS * WEBHOOK_PER_THREAD)]
        s0 = dict(batcher.stats)
        rec.clear()
        burst_s, burst = webhook_burst(port, bodies, WEBHOOK_THREADS,
                                       traced=quick)
        burst_stats = routing(batcher.stats, s0)
        for _, resp, body, _ in burst:
            i = int(json.loads(body)["request"]["uid"].rsplit("s", 1)[1])
            check(resp["allowed"] is (i % 4 != 0), f"[webhook] one policy: "
                  f"{resp['uid']} allowed {resp['allowed']}")
        log(f"[webhook] one policy (disallow-latest-tag, enforce), over "
            f"HTTP/1.1 keep-alive: " + lane_line(
                f"{WEBHOOK_SEQUENTIAL} sequential POSTs of one body",
                seq, sum(a[0] for a in seq) / 1e3)
            + f", routing {seq_stats}; " + lane_line(
                f"{WEBHOOK_THREADS} threads x {WEBHOOK_PER_THREAD} distinct "
                "bodies", burst, burst_s)
            + f", routing {burst_stats}, every verdict as the image says; "
            f"{smi}")
        out["one_policy"] = {"sequential": percentiles([a[0] for a in seq]),
                             "burst": percentiles([a[0] for a in burst]),
                             "burst_rps": len(burst) / burst_s}
        if quick:
            sent = 11 + WEBHOOK_SEQUENTIAL + len(burst)
            # a repeat inside the result cache's second: a screen span
            webhook_client(port, [max(burst, key=lambda a: a[3])[2]])
            # one policy is cheap on the oracle: the router may send the
            # whole burst there, and then no admission dispatched
            out["observe"] = observe(
                port, sent + 1,
                [json.loads(b)["request"]["uid"] for b in bodies],
                "one policy", expect_dispatch=burst_stats["device"] > 0)
            return out
    finally:
        ring.__exit__()
        server.stop()
        batcher.stop()

    # ---- the library: the batcher's server against the oracle lane's
    enforce = [dict(d, spec=dict(d["spec"], validationFailureAction="enforce"))
               for d in library_docs]
    lib = PolicyCache()
    for d in enforce:
        lib.add(load_policy(d))
    t0 = time.perf_counter()
    cps = lib.compiled(enf, "Pod", "default")
    compile_s = time.perf_counter() - t0
    # the oracle lane's server first: a server attaches its pool to the
    # host lane, and the batcher's flushes are to use the batcher's
    oracle = WebhookServer(policy_cache=lib, client=FakeCluster(),
                           registry=metrics.MetricsRegistry())
    lib_batcher = AdmissionBatcher(lib)
    metrics.registry().reset()
    server = WebhookServer(policy_cache=lib, client=FakeCluster(),
                           admission_batcher=lib_batcher)
    mutator = None
    try:
        port = server.run(host="127.0.0.1", port=0).server_address[1]
        oracle_port = oracle.run(host="127.0.0.1", port=0).server_address[1]
        t0 = time.perf_counter()
        lib_batcher.warmup(enf, "Pod", "default", make_pod(1))
        warm_s = time.perf_counter() - t0
        n_req = ADMISSION_THREADS * ADMISSION_PER_THREAD
        warm = [[webhook_body(i, f"w{r}") for i in range(n_req)]
                for r in range(2)]
        sent = len(webhook_client(port, warm[0][:32]))
        pre = dict(lib_batcher.stats)
        for pool in warm:
            sent += len(webhook_burst(port, pool, ADMISSION_THREADS)[1])
        tripped = routing(lib_batcher.stats, pre)
        if tripped["circuit_open"] or tripped["screen_timeout"]:
            time.sleep(lib_batcher.circuit_cooldown_s + 0.2)
        end = time.perf_counter() + 60
        while lib_batcher._pending_flushes and time.perf_counter() < end:
            time.sleep(0.005)
        bodies = [webhook_body(i, "lib") for i in range(n_req)]
        with WideRing():
            rec.clear()
            s0, d0 = dict(lib_batcher.stats), dict(engine.DONATION_STATS)
            _build.reset_launches()
            burst_s, burst = webhook_burst(port, bodies, ADMISSION_THREADS,
                                           traced=True)
            end = time.perf_counter() + 60
            while lib_batcher._pending_flushes and time.perf_counter() < end:
                time.sleep(0.005)
            launches = dict(_build.LAUNCHES)
            stats = routing(lib_batcher.stats, s0)
            donated = {k: engine.DONATION_STATS[k] - d0[k] for k in d0}
            flushes = [tr for tr in rec.traces(8192) if tr.kind == "flush"
                       and {"device_dispatch", "cold_dispatch"}
                       & tr.stage_names()]
            sent += len(burst)
            # a repeat inside the result cache's second: a screen span
            webhook_client(port, [max(burst, key=lambda a: a[3])[2]])
            sent += 1
            out["observe"] = observe(
                port, sent, [json.loads(b)["request"]["uid"] for b in bodies],
                "library")
        check(stats["flush_error"] == 0, f"[webhook] flushes failed: {stats}")
        check(stats["device"] > 0 and stats["device_decided"] > 0,
              f"[webhook] no request answered by the device lane: {stats}")
        for k in EVALUATE_KERNELS:
            check(launches[k] == len(flushes) > 0, f"[webhook] {k} launched "
                  f"{launches[k]} times for {len(flushes)} device flushes")
        check(donated["dispatches"] > 0 and donated["donated_buffers"] > 0,
              f"[webhook] K6 dispatches {donated}")
        out["replay"] = replay_against_direct(
            lib.compiled(enf, "Pod", "default"), "[webhook]", "wrvd")
        # the oracle lane: the same reviews, its own latencies
        oracle_s, oracle_answers = webhook_burst(oracle_port, bodies,
                                                 ADMISSION_THREADS)
        want = {a[1]["uid"]: a[1] for a in oracle_answers}
        by_name = {p.name: p for p in lib.get_policies(enf, "Pod", "default")}
        same_text = 0
        for _, got, body, _ in burst:
            ref = want[got["uid"]]
            kind = same_answer(got, ref, server, by_name,
                               json.loads(body)["request"])
            check(kind is not None, f"[webhook] {got['uid']}: the batcher's "
                  f"server says {got}, the oracle lane {ref}")
            same_text += kind == "exact"
        denied = sum(1 for a in burst if not a[1]["allowed"])
        log(f"[webhook] the library ({len(enforce)} policies, enforce; Pod "
            f"population compiled in {compile_s:.3f} s on {cps.device}), warmup "
            f"{warm_s:.3f} s: " + lane_line(
                f"batcher lane, {ADMISSION_THREADS} threads x "
                f"{ADMISSION_PER_THREAD} distinct Pods", burst, burst_s)
            + f"; routing {stats}; {len(flushes)} device flushes, launches "
            f"{launches}, K6 {donated}; " + lane_line(
                "oracle lane (no batcher), the same reviews", oracle_answers,
                oracle_s)
            + f"; every answer equal to the oracle lane's ({denied} denied; "
            f"{same_text} of {len(burst)} the same text, the others denied "
            f"from the device row, whose lines name each rule without the "
            f"failing path, as in the JAX package, and equal to what the "
            f"webhook writes for the oracle lane's failing rules); {smi}")
        out.update(launches=launches, flushes=len(flushes), stats=stats,
                   donated=donated,
                   device=percentiles([a[0] for a in burst]),
                   device_rps=len(burst) / burst_s,
                   oracle=percentiles([a[0] for a in oracle_answers]),
                   oracle_rps=len(oracle_answers) / oracle_s)

        # ---- /mutate: BASELINE config 4's two policies, the same Pods
        mut = PolicyCache()
        mpols = [load_policy(d) for d in (ADD_DEFAULT_LABELS,
                                          ANNOTATE_BENCH_APPS)]
        for p in mpols:
            mut.add(p)
        mutator = WebhookServer(policy_cache=mut, client=FakeCluster(),
                                registry=metrics.MetricsRegistry())
        mport = mutator.run(host="127.0.0.1", port=0).server_address[1]
        t0 = time.perf_counter()
        mutated = webhook_client(mport, bodies, path="/mutate")
        mutate_s = time.perf_counter() - t0
        from kyverno_tpu_torch.engine.context import (
            Context, mutate_resource_with_image_info)

        n_patched = 0
        for _, resp, body, _ in mutated:
            doc = json.loads(body)["request"]["object"]
            doc, want_p = mutate_resource_with_image_info(doc, Context())
            want_p = list(want_p) + serial_chain(mpols, doc)
            got_p = (json.loads(base64.b64decode(resp["patch"]))
                     if "patch" in resp else [])
            check(resp["allowed"] and got_p == want_p, f"[webhook] /mutate "
                  f"{resp['uid']}: {got_p} against the serial chain's "
                  f"{want_p}")
            n_patched += bool(got_p)
        log(f"[webhook] /mutate, config 4's two policies: " + lane_line(
            "the same Pods, one keep-alive connection", mutated, mutate_s)
            + f"; {n_patched} patched, every patch equal to the serial "
            f"mutate() chain's")

        # ---- the policy webhook: one policy through both paths
        doc = library_docs[0]
        review = json.dumps({
            "apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": "policy", "kind": {"kind": "ClusterPolicy"},
                        "operation": "CREATE", "object": doc}}).encode()
        (_, valid, _, _), = webhook_client(mport, [review],
                                           path="/policyvalidate")
        (_, mpatch, _, _), = webhook_client(mport, [review],
                                            path="/policymutate")
        check(valid["allowed"] is True, f"[webhook] /policyvalidate {valid}")
        added = [p["value"] for p in json.loads(base64.b64decode(
            mpatch["patch"])) if p["path"].startswith("/spec/rules/")]
        (auto,), errors = autogen_policies([doc], policy_steps())
        check(not errors, f"[webhook] the [autogen] steps: {errors}")
        steps_rules = [(r.name, sorted(r.match_kinds()))
                       for r in auto.spec.rules[len(doc["spec"]["rules"]):]]
        got_rules = [(r["name"], sorted(r["match"]["resources"]["kinds"]))
                     for r in added]
        check(got_rules == steps_rules and got_rules, f"[webhook] "
              f"/policymutate added {got_rules}, the [autogen] steps "
              f"{steps_rules}")
        log(f"[webhook] /policyvalidate allowed {doc['metadata']['name']}; "
            f"/policymutate added the rules the [autogen] steps give: "
            f"{got_rules}")
    finally:
        server.stop()
        lib_batcher.stop()
        oracle.stop()
        if mutator is not None:
            mutator.stop()
        hostlane.resolver().attach_pool(None, None)
    return out


# cut from 10,000 to 2,000 to 1,000 to 250 for the script's time limit,
# the last cut to make room for [fleet], [workload] and [chaos]
CONTROLLER_RESOURCES = 250
STREAM_JSON, STREAM_ROWS = 256, 256
STREAM_BLOCKS, STREAM_BLOCK_ROWS = 16, 64
PROFILE_S = 2.0
SCAN_WAIT_S = 300.0
MIGRATION_GR = {
    "apiVersion": "kyverno.io/v1", "kind": "GenerateRequest",
    "metadata": {"name": "gr-before-labels", "namespace": "kyverno"},
    "spec": {"policy": "an-older-policy",
             "resource": {"apiVersion": "v1", "kind": "Namespace",
                          "name": "team-a", "namespace": ""}},
    "status": {"state": "Completed"}}


def stream_burst(fn, items: list, threads: int = 16) -> tuple:
    """``fn(item)`` for every item from ``threads`` threads sharing one
    stream client (so that ``threads`` frames are in flight on its one
    connection); (wall seconds, [(ms, answer)] in item order)."""
    out: list = [None] * len(items)
    nxt = iter(range(len(items)))
    lock = threading.Lock()
    errors: list = []

    def worker():
        while True:
            with lock:
                i = next(nxt, None)
            if i is None:
                return
            t0 = time.perf_counter()
            try:
                ans = fn(items[i])
            except Exception as e:           # raised below, on this thread
                errors.append(e)
                return
            out[i] = ((time.perf_counter() - t0) * 1e3, ans)

    ws = [threading.Thread(target=worker) for _ in range(threads)]
    t0 = time.perf_counter()
    for w in ws:
        w.start()
    for w in ws:
        w.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return wall, out


def device_rows(cps, m: np.ndarray) -> list:
    """The stream plane's verdict list of each row of a device matrix:
    [policy, rule, verdict, ""] for every applicable cell, rule order."""
    return [[[ref.policy.name, ref.rule.name, int(row[ref.rule_index]), ""]
             for ref in cps.rule_refs if row[ref.rule_index] != 0]
            for row in m]


def cold_bucket_rows(policy_cache, cps, wire_rows: list,
                     row_want: list) -> dict:
    """ROW frames through a fresh AdmissionBatcher over ``policy_cache``,
    cold release on as in the controller's: it has seen no shape bucket,
    so its first flush is cold, and every frame still gets its device row
    (one whose screen gave up at its deadline counts as a stream timeout).
    Returns the batcher's counters and the buckets it warmed."""
    from kyverno_tpu_torch.runtime.batch import AdmissionBatcher
    from kyverno_tpu_torch.runtime.policycache import PolicyType

    b = AdmissionBatcher(policy_cache, cold_flush_fallback=True)
    try:
        _, ans = stream_burst(lambda r: b.screen_row(
            PolicyType.VALIDATE_ENFORCE, "Pod", "default", r), wire_rows)
        gave_up = 0
        for i, (_, (status, vrow)) in enumerate(ans):
            if not vrow and row_want[i]:
                gave_up += 1
                continue
            got = [[p, r, int(v), m] for p, r, v, m in vrow]
            check(got == row_want[i], f"[controller] cold buckets: ROW "
                  f"frame {i}: {status} {got} against the device row "
                  f"{row_want[i]}")
        buckets = len(b._seen_shapes.get(cps, ()))
        stats = {k: b.stats.get(k, 0) for k in (
            "stream_rows", "stream_timeout", "cold_release", "oracle")}
        check(buckets >= 1 and gave_up == stats["stream_timeout"]
              and gave_up < len(wire_rows) and not stats["cold_release"],
              f"[controller] cold buckets: {gave_up} ROW frames without "
              f"verdicts, {buckets} buckets warmed, counters {stats}")
        return dict(stats, buckets=buckets)
    finally:
        b.stop()


def flush_traces(rec) -> list:
    return [tr for tr in rec.traces(8192) if tr.kind == "flush"
            and {"device_dispatch", "cold_dispatch"} & tr.stage_names()]


def frame_line(label: str, timed: list, wall: float) -> str:
    p50, p99 = percentiles([t[0] for t in timed])
    return (f"{label}: {len(timed)} frames, p50 {p50:.3f} ms, p99 "
            f"{p99:.3f} ms, {len(timed) / wall:.1f} frames/s ({wall:.3f} s)")


def controller_phase(n: int = CONTROLLER_RESOURCES) -> dict:
    """[controller]: the controller process on the card. A port
    FakeCluster holds the library (enforce) as ClusterPolicies, ``n``
    autogen_resource(i) and a GenerateRequest without its labels. Two
    Controller replicas (serve_port=0, no TLS) on it: the first leads,
    registers the webhooks, runs the migrations and scans, the policy
    load having kicked its scan loop; with the launch counters set to 0
    before it and read after, the scan launches K1 and eval_rules, ends
    with no scan error, its responses state evaluate()'s resolved matrix
    of the same policies over the same resources, and the reports it
    aggregates hold that matrix's per-policy totals. The second replica
    then starts and follows. HTTP: 16 threads x 16 distinct Pods, threads
    alternating between the replicas, every answer equal to an oracle
    lane's (same_answer). Stream: a StreamServer (socket) beside the
    leader's webhook and one StreamClient; 256 JSON frames, each answer
    equal to the webhook's own handle() and to the oracle lane's (under
    same_answer's rule); 256 ROW frames, each verdict row the device
    matrix's row (a frame whose flush missed the screen's deadline
    escalates with none, and is counted as a stream timeout), and 16 of
    them again through a fresh batcher whose first flushes are cold,
    each still the device matrix's row; 16 BLOCK
    frames of 64 rows tokenized with the leader's compiled set, each row
    evaluate_device's, a row with a HOST cell escalated; no frame, block or shape error; K6 dispatches and the
    launches counted; a donated block's host buffer unchanged. A
    /debug/profile capture of 2 s on the leader during the frames, its
    trace holding K1's and eval_rules' kernels, and the card's busy share
    in its window; device memory reported. Failover: the leader stops and
    releases its lease, the follower leads within two retry periods and
    scans; both stop, the report writers flushed, no non-daemon thread
    left. Returns the launches of the scan and the stream."""
    import urllib.request

    from kyverno_tpu_torch.api.load import load_policy
    from kyverno_tpu_torch.models import CompiledPolicySet, Verdict, engine
    from kyverno_tpu_torch.ops import _build
    from kyverno_tpu_torch.policy.autogen import mutate_policy_for_autogen
    from kyverno_tpu_torch.runtime import hostlane, metrics, profiling, tracing
    from kyverno_tpu_torch.runtime.client import FakeCluster
    from kyverno_tpu_torch.runtime.leaderelection import RETRY_PERIOD_S
    from kyverno_tpu_torch.runtime.policycache import PolicyCache, PolicyType
    from kyverno_tpu_torch.runtime.stream_server import (
        StreamClient, StreamServer, flatten_block_for_wire,
        flatten_rows_for_wire)
    from kyverno_tpu_torch.runtime.webhook import (VALIDATING_WEBHOOK_PATH,
                                                   WebhookServer)
    from kyverno_tpu_torch.server import Controller

    enf = PolicyType.VALIDATE_ENFORCE
    smi = nvidia_smi_line()
    out = {}
    rec = tracing.recorder()
    # the process-wide pools of earlier phases (the flattener's chunks,
    # the host lane's fan-out) outlive them by design
    threads_before = set(threading.enumerate())
    enforce = [dict(d, spec=dict(d["spec"], validationFailureAction="enforce"))
               for d in _synth_policy_docs(250)]
    resources = [autogen_resource(i) for i in range(n)]
    cluster = FakeCluster(json.loads(json.dumps(
        enforce + resources + [MIGRATION_GR])))
    # the oracle lane's server first: a server attaches its pool to the
    # host lane, and the replicas' flushes are to use theirs
    ocache = PolicyCache()
    for d in enforce:
        ocache.add(mutate_policy_for_autogen(load_policy(
            json.loads(json.dumps(d)))))
    oracle = WebhookServer(policy_cache=ocache, client=FakeCluster(),
                           registry=metrics.MetricsRegistry())
    leader = follower = ss = cl = None
    stopped: list = []
    scan_run: dict = {}
    try:
        oracle_port = oracle.run(host="127.0.0.1", port=0).server_address[1]
        metrics.registry().reset()
        leader = Controller(client=cluster, serve_port=0, enable_tls=False)
        check(leader.device.type == "cuda", f"[controller] on {leader.device}")
        scan = leader.run_background_scan

        def timed_scan():
            # the first scan's launches apart from the screen's warm-up
            if leader._warm_thread is not None:
                leader._warm_thread.join()
            l0 = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            try:
                return scan()
            finally:
                scan_run.setdefault("wall", time.perf_counter() - t0)
                scan_run.setdefault("launches", {
                    k: _build.LAUNCHES[k] - l0.get(k, 0)
                    for k in _build.LAUNCHES})

        leader.run_background_scan = timed_scan
        _build.reset_launches()
        t0 = time.perf_counter()
        leader.start(host="127.0.0.1")
        start_s = time.perf_counter() - t0
        check(leader.elector.is_leader(), "[controller] the first replica "
              "does not lead")
        check(leader.register.check(), "[controller] the leader did not "
              "register the webhooks")
        gr = cluster.get_resource("kyverno.io/v1", "GenerateRequest",
                                  "kyverno", "gr-before-labels")
        check((gr["metadata"].get("labels") or {}).get(
            "generate.kyverno.io/policy-name") == "an-older-policy",
            f"[controller] the migrations did not run: {gr['metadata']}")
        end = time.perf_counter() + SCAN_WAIT_S
        while (not (leader.last_scan is not None and "launches" in scan_run)
               and leader.last_scan_error is None
               and time.perf_counter() < end):
            time.sleep(0.02)
        check(leader.last_scan_error is None, f"[controller] the leader's "
              f"scan failed: {leader.last_scan_error!r}")
        if leader.last_scan is None:
            faulthandler.dump_traceback(all_threads=True)
        check(leader.last_scan is not None, f"[controller] no scan in "
              f"{SCAN_WAIT_S:g} s (every thread's stack above)")
        launches = scan_run["launches"]
        for k in EVALUATE_KERNELS:
            check(launches[k] >= 1, f"[controller] the scan did not launch "
                  f"{k}: {launches}")
        result = leader.last_scan
        policies = leader.policy_cache.all_policies()
        ref = CompiledPolicySet(policies)
        t0 = time.perf_counter()
        want = ref.evaluate(resources)
        ref_s = time.perf_counter() - t0
        check(not (want == Verdict.HOST).any(), "[controller] evaluate() "
              "left HOST cells")
        m = response_matrix(result, ref.rule_refs, resources)
        check(result.resources_scanned == n and np.array_equal(m, want),
              f"[controller] the scan's responses ({result.resources_scanned}"
              f" resources) differ from evaluate()'s resolved matrix in "
              f"{int((m != want).sum())} cells")
        reports = (cluster.list_resource("wgpolicyk8s.io/v1alpha2",
                                         "PolicyReport")
                   + cluster.list_resource("wgpolicyk8s.io/v1alpha2",
                                           "ClusterPolicyReport"))
        key = matrix_key(m, ref.rule_refs)
        check(report_totals(reports) == key[3] and result.violations == key[0],
              "[controller] the aggregated reports' per-policy totals "
              "differ from the scan's matrix")
        hist = np.bincount(m.ravel().astype(np.int64), minlength=6).tolist()
        log(f"[controller] leader started in {start_s:.3f} s (policy load "
            f"and autogen of {len(enforce)} policies: {len(ref.rule_refs)} "
            f"rules; webhooks registered; migrations ran); its first "
            f"background scan of {n} resources, kicked by the policy load: "
            f"{scan_run['wall']:.3f} s wall, launches {launches}, no scan "
            f"error; {result.violations} violations, "
            f"{len(result.responses)} responses, matrix {hist} equal to "
            f"evaluate()'s resolved matrix ({ref_s:.3f} s) of the same "
            f"{len(policies)} policies; {len(reports)} reports aggregated "
            f"with its per-policy totals; {smi}")
        out["scan"] = {"launches": launches, "wall": scan_run["wall"]}

        follower = Controller(client=cluster, serve_port=0, enable_tls=False)
        t0 = time.perf_counter()
        follower.start(host="127.0.0.1")
        check(not follower.elector.is_leader() and leader.elector.is_leader(),
              "[controller] not exactly one replica leads")
        log(f"[controller] follower started in {time.perf_counter() - t0:.3f}"
            f" s; exactly one replica leads")
        for c in (leader, follower):
            if c._warm_thread is not None:
                c._warm_thread.join()

        # ---- HTTP to both replicas (webhooks are active-active)
        ports = [c._httpd.server_address[1] for c in (leader, follower)]
        n_req = ADMISSION_THREADS * ADMISSION_PER_THREAD
        webhook_burst(ports, [webhook_body(i, "cw") for i in range(n_req)],
                      ADMISSION_THREADS)
        bodies = [webhook_body(i, "ctl") for i in range(n_req)]
        stats0 = [dict(c.admission_batcher.stats) for c in (leader, follower)]
        with WideRing():
            rec.clear()
            _build.reset_launches()
            d0 = dict(engine.DONATION_STATS)
            http_s, answers = webhook_burst(ports, bodies, ADMISSION_THREADS)
            flushes = flush_traces(rec)
            http_launches = dict(_build.LAUNCHES)
            http_k6 = {k: engine.DONATION_STATS[k] - d0[k] for k in d0}
        stats = [routing(c.admission_batcher.stats, s)
                 for c, s in zip((leader, follower), stats0)]
        oracle_s, oracle_answers = webhook_burst(oracle_port, bodies,
                                                 ADMISSION_THREADS)
        want_ans = {a[1]["uid"]: a[1] for a in oracle_answers}
        # the replicas hold the same policies: the leader's webhook writes
        # a device-row denial as the follower's does
        by_leader = {p.name: p for p in leader.policy_cache.get_policies(
            enf, "Pod", "default")}
        same_text = 0
        for _, got, body, _ in answers:
            kind = same_answer(got, want_ans[got["uid"]], leader.webhook,
                               by_leader, json.loads(body)["request"])
            check(kind is not None, f"[controller] {got['uid']} answered "
                  f"{got}, the oracle lane {want_ans[got['uid']]}")
            same_text += kind == "exact"
        for s in stats:
            check(s["flush_error"] == 0, f"[controller] failed flushes {s}")
        check(sum(s["device"] for s in stats) > 0, f"[controller] no device "
              f"answer over HTTP: {stats}")
        rows = sum(int(tr.labels.get("batch", 0)) for tr in flushes)
        log(f"[controller] HTTP, both replicas: " + lane_line(
            f"{ADMISSION_THREADS} threads x {ADMISSION_PER_THREAD} distinct "
            f"Pods, threads alternating replicas",
            answers, http_s)
            + f"; routing leader {stats[0]}, follower {stats[1]}; "
            f"{len(flushes)} device flushes, {rows / max(1, len(flushes)):.2f}"
            f" rows a flush; launches {http_launches}; K6 {http_k6}; every "
            f"answer equal to the oracle lane's ({same_text} of {n_req} the "
            f"same text); " + lane_line("oracle lane", oracle_answers,
                                        oracle_s) + f"; {smi}")
        out["http"] = {"p": percentiles([a[0] for a in answers]),
                       "rps": n_req / http_s, "flushes": len(flushes),
                       "rows": rows, "launches": http_launches}

        # ---- the stream plane beside the leader's webhook
        ss = StreamServer(leader.webhook, leader.admission_batcher,
                          leader.policy_cache, transport="socket").start()
        cl = StreamClient(ss.port, transport="socket")
        cps = leader.policy_cache.compiled(enf, "Pod", "default")
        b_stats = dict(leader.admission_batcher.stats)
        json_bodies = [webhook_body(i, "sj") for i in range(STREAM_JSON)]
        reviews = [json.loads(b) for b in json_bodies]
        json_s, json_ans = stream_burst(cl.admit_json, reviews)
        # the webhook's own handle() and the oracle lane, on the same
        # reviews, 16 at a time
        _, direct_ans = stream_burst(
            lambda r: leader.webhook.handle(VALIDATING_WEBHOOK_PATH, r),
            reviews)
        _, oracle_json = webhook_burst(oracle_port, json_bodies,
                                       ADMISSION_THREADS)
        oracle_by_uid = {a[1]["uid"]: a[1] for a in oracle_json}
        json_same = 0
        for r, (_, got), (_, direct) in zip(reviews, json_ans, direct_ans):
            ref_r = oracle_by_uid[r["request"]["uid"]]
            k1 = same_answer(got["response"], ref_r, leader.webhook,
                             by_leader, r["request"])
            k2 = same_answer(direct["response"], ref_r, leader.webhook,
                             by_leader, r["request"])
            check(k1 is not None and k2 is not None
                  and got["response"]["allowed"]
                  == direct["response"]["allowed"],
                  f"[controller] JSON frame {r['request']['uid']}: "
                  f"{got['response']} against handle()'s "
                  f"{direct['response']} and the oracle lane's {ref_r}")
            json_same += got["response"] == direct["response"]
        pods = [make_pod(i) for i in range(STREAM_ROWS)]
        for i, p in enumerate(pods):
            p["metadata"]["name"] = f"row-{i}"
        wire_rows = flatten_rows_for_wire(cps, pods)
        row_want = device_rows(cps, cps.evaluate_device(
            cps.flatten_packed(pods)))
        blocks = []
        for j in range(STREAM_BLOCKS):
            chunk = [make_pod(STREAM_ROWS + j * STREAM_BLOCK_ROWS + i)
                     for i in range(STREAM_BLOCK_ROWS)]
            blk = flatten_block_for_wire(cps, chunk)
            blocks.append((blk, cps.evaluate_device(blk)))
        row_stats = dict(leader.admission_batcher.stats)
        svc = profiling.capture_service()
        with WideRing():
            rec.clear()
            _build.reset_launches()
            d0 = dict(engine.DONATION_STATS)
            t_prof = time.perf_counter()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{ports[0]}/debug/profile?seconds="
                    f"{PROFILE_S}", timeout=30) as resp:
                started = json.loads(resp.read())
            check(started.get("status") == "capturing", f"[controller] "
                  f"/debug/profile answered {started}")
            # the profiler takes seconds to start: the frames go once its
            # window is open
            while (not svc.status()["window_open"]
                   and time.perf_counter() - t_prof < 120):
                time.sleep(0.01)
            check(svc.status()["window_open"], "[controller] the capture's "
                  "window did not open in 120 s")
            row_s, row_ans = stream_burst(
                lambda r: cl.admit_row("Pod", "default", r), wire_rows)
            block_s, block_ans = stream_burst(
                lambda b: cl.admit_block("Pod", "default", b[0]), blocks)
            extra = 0
            # more blocks while the window is open
            while svc.status()["window_open"]:
                blk, m_b = blocks[extra % len(blocks)]
                block_ans.append((0.0, cl.admit_block("Pod", "default", blk)))
                extra += 1
            stream_launches = dict(_build.LAUNCHES)
            stream_k6 = {k: engine.DONATION_STATS[k] - d0[k] for k in d0}
            s_flushes = flush_traces(rec)
        svc.drain()
        # a ROW frame whose flush missed the screen's deadline escalates
        # with no verdicts (the batcher counts it in stream_timeout); every
        # other frame's verdict row is the device matrix's
        gave_up = 0
        for b, (_, got) in enumerate(row_ans):
            if not got["verdicts"] and got["escalate"] and row_want[b]:
                gave_up += 1
                continue
            check(got["verdicts"] == row_want[b], f"[controller] ROW frame "
                  f"{b}: {got} against the device row {row_want[b]}")
        escalated = 0
        for j, (_, got) in enumerate(block_ans):
            _, m_b = blocks[j % len(blocks)]
            want_rows = device_rows(cps, m_b)
            check(len(got["rows"]) == len(want_rows), f"[controller] BLOCK "
                  f"frame {j}: {len(got['rows'])} rows")
            for b, row in enumerate(got["rows"]):
                host = bool((m_b[b] == Verdict.HOST).any())
                check(row["verdicts"] == want_rows[b]
                      and (row["escalate"] or not host),
                      f"[controller] BLOCK frame {j} row {b}: {row}")
                escalated += row["escalate"]
        b_now = leader.admission_batcher.stats
        timeouts = (b_now.get("stream_timeout", 0)
                    - b_stats.get("stream_timeout", 0))
        moved = {k: v - row_stats.get(k, 0) for k, v in b_now.items()
                 if isinstance(v, (int, float)) and v != row_stats.get(k, 0)}
        check(gave_up == timeouts and gave_up < STREAM_ROWS,
              f"[controller] {gave_up} ROW frames without verdicts, "
              f"{timeouts} stream timeouts; the batcher's counters over "
              f"the frames moved {moved}; the leader's compiled Pod set "
              f"{'is' if leader.policy_cache.compiled(enf, 'Pod', 'default') is cps else 'is not'}"
              f" the one the rows were tokenized against")
        cold_b = cold_bucket_rows(leader.policy_cache, cps, wire_rows[:16],
                                  row_want[:16])
        plane = ss.plane.stats
        check(not plane.get("frame_errors") and not plane.get("block_errors")
              and not b_now.get("stream_shape_reject"),
              f"[controller] stream errors: plane {plane}, batcher "
              f"{ {k: v for k, v in b_now.items() if k.startswith('stream')} }")
        for k in EVALUATE_KERNELS:
            check(stream_launches[k] >= 1, f"[controller] the frames did not "
                  f"launch {k}: {stream_launches}")
        check(stream_k6["dispatches"] > 0, f"[controller] K6 {stream_k6}")
        # a donated block, padded as evaluate_block pads it (its shape
        # bucket's slots are warm): the verdicts evaluate_device gives,
        # and the host buffer the block caches unchanged
        blk, m_b = blocks[0]
        padded, _ = leader.admission_batcher._pad_admission(blk)
        snap = np.asarray(padded.packed_blob()[0]).copy()
        d0 = dict(engine.DONATION_STATS)
        got_v = np.asarray(cps.evaluate_device_async(padded,
                                                     donate=True).get())
        donated = {k: engine.DONATION_STATS[k] - d0[k] for k in d0}
        kept = np.array_equal(np.asarray(padded.packed_blob()[0]), snap)
        check(np.array_equal(got_v[:len(m_b)], m_b) and kept
              and donated["dispatches"] == 1
              and donated["donated_buffers"] == 1,
              f"[controller] a donated block: K6 {donated}, verdicts equal "
              f"{np.array_equal(got_v[:len(m_b)], m_b)}, host buffer "
              f"unchanged {kept}")
        # the capture: K1's and eval_rules' kernels in its trace
        last = svc.status()["last"]
        check(last.get("error") is None and last.get("trace_file"),
              f"[controller] profile capture {last}")
        kev = profiling.kernel_events(last["trace_file"])
        names = sorted({e["name"] for e in kev})
        check(any("glob_nfa" in x for x in names)
              and any("rules_kernel" in x for x in names),
              f"[controller] the capture's kernels: {names}")
        busy_us = sum(e["dur"] for e in kev)
        busy = busy_us / (last["window_s"] * 1e6)
        with urllib.request.urlopen(f"http://127.0.0.1:{ports[0]}/debug/"
                                    f"profile", timeout=30) as resp:
            idle = json.loads(resp.read())
        mem = idle["device_memory"].get("0", {})
        check(mem.get("platform") == "cuda" and mem.get("bytes_in_use", 0) > 0,
              f"[controller] device memory {idle['device_memory']}")
        s_rows = sum(int(tr.labels.get("batch", 0)) for tr in s_flushes)
        cold_rf = [tr for tr in s_flushes
                   if "cold_dispatch" in tr.stage_names()]
        n_s = {k: b_now.get(k, 0) - b_stats.get(k, 0) for k in (
            "stream_rows", "stream_blocks", "stream_block_rows",
            "stream_timeout", "screen_timeout")}
        log(f"[controller] stream (socket), one client: " + frame_line(
            "JSON", json_ans, json_s) + f" ({json_same} equal to handle()'s "
            f"answer exactly, every one under same_answer's rule); "
            + frame_line("ROW", row_ans, row_s) + "; " + frame_line(
                "BLOCK (64 rows)", block_ans[:STREAM_BLOCKS], block_s)
            + f" and {extra} more inside the capture; every verdict row the "
            f"device matrix's ({gave_up} ROW frames gave up at the screen's "
            f"deadline and escalated), "
            f"{escalated} block rows escalated "
            f"(each with a HOST cell or more); batcher {n_s}; {len(s_flushes)} ROW "
            f"flushes, {s_rows / max(1, len(s_flushes)):.2f} rows a flush, "
            f"{len(cold_rf)} of them the first use of a shape bucket "
            f"({sum(int(tr.labels.get('batch', 0)) for tr in cold_rf)} rows,"
            f" answered by the card); a fresh batcher's first flushes, "
            f"each cold: 16 ROW screens, each its device row, {cold_b}; "
            f"launches {stream_launches}; K6 {stream_k6}; plane {plane}; a "
            f"donated block: K6 {donated}, host buffer unchanged; {smi}")
        log(f"[controller] /debug/profile?seconds={PROFILE_S:g}: "
            f"{last['seconds']:.3f} s in all (the profiler's start "
            f"{last['open_s']:.3f} s, its stop and the trace export "
            f"{last['close_s']:.3f} s), window {last['window_s']:.3f} s, "
            f"{len(kev)} kernel launches in it "
            f"({', '.join(names)}); the card busy {busy_us / 1e3:.3f} ms, "
            f"{100 * busy:.3f}% of the window; device memory {mem}; {smi}")
        out["stream"] = {"launches": stream_launches, "k6": stream_k6,
                         "json": percentiles([t[0] for t in json_ans]),
                         "row": percentiles([t[0] for t in row_ans]),
                         "block": percentiles(
                             [t[0] for t in block_ans[:STREAM_BLOCKS]]),
                         "busy": busy}
        cl.close()
        cl = None
        ss.stop()
        ss = None

        # ---- failover
        identity = leader.elector.identity
        t0 = time.perf_counter()
        leader.stop()
        stopped.append(leader)
        stop_s = time.perf_counter() - t0
        lease = cluster.get_resource("coordination.k8s.io/v1", "Lease",
                                     "kyverno", "kyverno")
        check(lease["spec"]["holderIdentity"] != identity,
              f"[controller] the stopped leader kept its lease {lease}")
        t1 = time.perf_counter()
        while (not follower.elector.is_leader()
               and time.perf_counter() - t1 < 4 * RETRY_PERIOD_S):
            time.sleep(0.01)
        took = time.perf_counter() - t1
        check(follower.elector.is_leader() and took <= 2 * RETRY_PERIOD_S,
              f"[controller] the follower led after {took:.3f} s")
        check(follower.register.check(), "[controller] the new leader's "
              "webhooks")
        end = time.perf_counter() + SCAN_WAIT_S
        while (follower.last_scan is None and follower.last_scan_error is None
               and time.perf_counter() < end):
            time.sleep(0.02)
        if follower.last_scan is None:
            faulthandler.dump_traceback(all_threads=True)
        check(follower.last_scan is not None
              and follower.last_scan_error is None,
              f"[controller] the new leader's scan: "
              f"{follower.last_scan_error!r}")
        check(follower.last_scan.violations == result.violations,
              "[controller] the new leader's scan differs")
        follower.stop()
        stopped.append(follower)
        for c in (leader, follower):
            rg = c.report_gen
            check(not rg._queue and not rg._writing
                  and (rg._writer is None or not rg._writer.is_alive()),
                  "[controller] a report writer did not flush and stop")
        log(f"[controller] failover: the leader stopped in {stop_s:.3f} s "
            f"and released its lease; the follower led {took:.3f} s later "
            f"(retry period {RETRY_PERIOD_S:g} s), registered the webhooks "
            f"and scanned ({follower.last_scan.violations} violations); "
            f"both stopped, report writers flushed")
    finally:
        if cl is not None:
            cl.close()
        if ss is not None:
            ss.stop()
        for c in (leader, follower):
            if c is not None and c not in stopped:
                c.stop()
        oracle.stop()
        hostlane.resolver().attach_pool(None, None)
        profiling.capture_service().drain()
    left = [t.name for t in threading.enumerate()
            if not t.daemon and t not in threads_before]
    check(not left, f"[controller] non-daemon threads left: {left}")
    return out


def matrix_sha(m: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(m).tobytes()).hexdigest()


def scan_spans(lane: str, n: int) -> dict:
    """Seconds of each span of the last ``n`` scan_chunk traces of
    ``lane``, summed over the chunks."""
    from kyverno_tpu_torch.runtime import tracing

    traces = [t for t in tracing.recorder().traces(n=64)
              if t.kind == "scan_chunk" and t.labels.get("lane") == lane][:n]
    check(len(traces) == n, f"{len(traces)} {lane} chunk traces, not {n}")
    out = {}
    for tr in traces:
        check(tr.spans_dropped == 0, f"a {lane} chunk trace dropped "
              f"{tr.spans_dropped} spans")
        for sp in tr.spans:
            out[sp.name] = out.get(sp.name, 0.0) + sp.duration_s
    return out


class AllSpans:
    """While entered, a new trace keeps every span: the host lane adds
    two a row, and a chunk of the mesh scan has 65,536 rows."""

    def __enter__(self):
        from kyverno_tpu_torch.runtime import tracing

        self.rec = tracing.recorder()
        self.saved = self.rec.max_spans
        self.rec.max_spans = 1 << 20
        return self

    def __exit__(self, *exc):
        self.rec.max_spans = self.saved


class CheckedCounts:
    """While entered, every run of K7's program on a data shard (through
    ``ops.eval.evaluate_live_counts``, which parallel/mesh.py calls: K1,
    then the counts form) is timed between two CUDA events and its counts
    are held to ``rule_counts_plain`` over that launch's own verdicts,
    exactly. The plain version counts no launch. Runs take turns, each on
    a stream of its own that waits for the caller's (its blob's copy), so
    that the events hold that one program and no other thread's copy or
    launch. A sleep kernel holds the stream while the host enqueues the
    program: during a scan other threads hold the interpreter lock for
    milliseconds, and without the hold the events would time the host's
    enqueue. A run whose enqueue outlasted the hold is marked."""

    HOLD_CYCLES = 200_000_000      # about 0.1 s of the card's clock

    def __init__(self):
        from kyverno_tpu_torch.ops import eval as ev

        self.ev, self.real = ev, ev.evaluate_live_counts
        self.calls, self.cells, self.ms, self.held = 0, 0, [], []
        self._lock = threading.Lock()
        self._streams = {}

    def __call__(self, plan, blob, B, P, E, V, live):
        import torch

        with self._lock:
            main = torch.cuda.current_stream()
            side = self._streams.get(main.device)
            if side is None:
                side = self._streams[main.device] = torch.cuda.Stream(
                    main.device)
            side.wait_stream(main)
            h, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
            with torch.cuda.stream(side):
                t0 = time.perf_counter()
                h.record()
                torch.cuda._sleep(self.HOLD_CYCLES)
                a.record()
                v, f, p = self.real(plan, blob, B, P, E, V, live)
                b.record()
                enqueue_ms = (time.perf_counter() - t0) * 1e3
            b.synchronize()
            for t in (v, f, p):
                t.record_stream(main)
            main.wait_stream(side)
            n = same(f"K7's counts of a {tuple(v.shape)} mesh shard", (f, p),
                     self.ev.rule_counts_plain(v))
            self.calls += 1
            self.cells += n
            self.ms.append(a.elapsed_time(b))
            self.held.append(enqueue_ms < h.elapsed_time(a))
        return v, f, p

    def times(self) -> str:
        """The runs' device times; a run whose enqueue outlasted the hold
        is marked (its time holds part of the enqueue)."""
        return ", ".join(f"{ms:.4f}" + ("" if held else " (enqueue not held)")
                         for ms, held in zip(self.ms, self.held)) + " ms"

    def __enter__(self):
        self.ev.evaluate_live_counts = self
        return self

    def __exit__(self, *exc):
        self.ev.evaluate_live_counts = self.real


def check_mesh_launches(label: str, launches: dict, each: int,
                        checked: CheckedCounts) -> None:
    """K1 and the counts form launched ``each`` times, every other
    kernel never, and every counts form launch held to its plain
    version."""
    want = {k: each if k in MESH_KERNELS else 0 for k in launches}
    check(launches == want, f"{label}: launches {launches}, not {want}")
    check(checked.calls == each, f"{label}: {checked.calls} runs of K7's "
          f"program held to the plain counts, not {each}")


def mesh_phase(cps, mesh_1d, first: np.ndarray) -> dict:
    """[mesh]: ``sharded_scan`` of MESH_RESOURCES mixed resources on the
    1D one-card mesh, with the launch counters set to 0 just before and
    read just after: no HOST cell left, the first 10,000 rows equal to
    ``first`` (the 2D scan's matrix of them) and to the pinned sha256,
    the counts equal to the matrix's column sums, every chunk's counts
    equal to rule_counts_plain over its own verdicts, K1 and the counts
    form launched once a chunk and nothing else, and the K7 program's
    device time a chunk. Returns the launches."""
    from kyverno_tpu_torch.ops import _build
    from kyverno_tpu_torch.parallel import mesh as mesh_mod
    from kyverno_tpu_torch.runtime import hostlane

    t0 = time.perf_counter()
    resources = [mixed_resource(i) for i in range(MESH_RESOURCES)]
    make_s = time.perf_counter() - t0
    chunks = -(-MESH_RESOURCES // mesh_mod.DEFAULT_CHUNK)
    m0 = hostlane.host_cache().stats()
    _build.reset_launches()
    with CheckedCounts() as checked, AllSpans():
        t0 = time.perf_counter()
        v, fails, passes = mesh_mod.sharded_scan(
            cps, resources, mesh_1d, chunk_size=mesh_mod.DEFAULT_CHUNK)
        wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    hits, misses = memo_delta(m0, hostlane.host_cache().stats())
    spans = scan_spans("mesh", chunks)
    log(f"[mesh] launches of sharded_scan at {MESH_RESOURCES} in {chunks} "
        f"chunks on {mesh_1d}: {launches}")
    shards = mesh_mod.data_axis_size(mesh_1d)
    check_mesh_launches("[mesh] sharded_scan", launches, chunks * shards,
                        checked)
    check(v.shape == (MESH_RESOURCES, cps.tensors.n_rules_live)
          and v.dtype == np.int8, f"sharded_scan gave {v.dtype}{v.shape}")
    check(not (v == 5).any(), f"sharded_scan left {int((v == 5).sum())} "
          "HOST cells")
    check(fails.dtype == passes.dtype == np.int64, "counts are not int64")
    check(np.array_equal(fails, (v == 2).sum(axis=0))
          and np.array_equal(passes, (v == 1).sum(axis=0)),
          "sharded_scan's counts differ from the matrix's column sums")
    head = v[:first.shape[0]]
    check(matrix_sha(head) == EXPECTED_EVAL_SHA,
          f"sharded_scan's first {first.shape[0]} rows: sha256 "
          f"{matrix_sha(head)} != {EXPECTED_EVAL_SHA}")
    check(np.array_equal(head, first), "the 1D scan's first rows differ "
          "from the 2D scan's")
    log(f"[mesh] sharded_scan of {MESH_RESOURCES} resources: {wall:.3f} s "
        f"wall (making them {make_s:.3f} s apart); spans summed over the "
        f"chunks' worker threads: flatten {spans.get('flatten', 0):.3f} s, "
        f"device_dispatch {spans.get('device_dispatch', 0):.3f} s, "
        f"host_resolve {spans.get('host_resolve', 0):.3f} s (memo {hits} "
        f"hits, {misses} misses); no HOST cell; "
        f"first {first.shape[0]} rows sha256 {EXPECTED_EVAL_SHA[:8]}… and equal to "
        f"the 2D scan's; fails {int(fails.sum())}, passes "
        f"{int(passes.sum())} = the column sums; the counts form's counts "
        f"equal to the plain version's over its own verdicts in "
        f"{checked.calls} chunks ({checked.cells} counts); K7's program "
        f"(K1 -> counts form) on the card a chunk, between events: "
        f"{checked.times()}; {nvidia_smi_line()}")
    return {"launches": launches, "wall_s": wall, "spans": spans,
            "k7_ms": checked.ms}


def mesh2d_phase(cps, mesh_1d, n: int = 10_000) -> tuple[dict, np.ndarray]:
    """[mesh2d]: the library as a ShardedPolicySet on the 2D (4, 1) mesh
    of one card over mixed_resource(0..n-1), with the launch counters set
    to 0 just before and read just after: every shard's K1 and counts
    form launched once and nothing else, its counts equal to the plain
    version's over its own verdicts and its device time taken; the
    matrix and counts equal to the 1D scan's of the same resources, the
    matrix to the pinned sha256. Returns (launches, the matrix)."""
    import torch

    from kyverno_tpu_torch.models.engine import ShardedPolicySet
    from kyverno_tpu_torch.ops import _build
    from kyverno_tpu_torch.parallel import mesh as mesh_mod

    resources = [mixed_resource(i) for i in range(n)]
    t0 = time.perf_counter()
    v1, f1, p1 = mesh_mod.sharded_scan(cps, resources, mesh_1d)
    one_s = time.perf_counter() - t0
    mesh = mesh_mod.make_mesh([torch.device("cuda", 0)] * 4, shape=(4, 1))
    t0 = time.perf_counter()
    sps = ShardedPolicySet(4, device="cuda").refresh(cps.policies)
    shard_s = time.perf_counter() - t0
    _build.reset_launches()
    with CheckedCounts() as checked, AllSpans():
        t0 = time.perf_counter()
        v2, f2, p2 = mesh_mod.sharded_scan(sps, resources, mesh)
        wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    spans = scan_spans("mesh2d", 1)
    log(f"[mesh2d] launches of sharded_scan at {n} on {mesh}: {launches}")
    check(len(sps.shards) == 4, f"{len(sps.shards)} policy shards")
    check_mesh_launches("[mesh2d] the 2D scan", launches, 4, checked)
    check(not (v2 == 5).any(), "the 2D scan left HOST cells")
    check(v2.dtype == v1.dtype and np.array_equal(v2, v1),
          "the 2D scan's matrix differs from the 1D scan's")
    check(np.array_equal(f2, f1) and np.array_equal(p2, p1),
          "the 2D scan's counts differ from the 1D scan's")
    check(matrix_sha(v2) == EXPECTED_EVAL_SHA,
          f"the 2D scan's sha256 {matrix_sha(v2)} != {EXPECTED_EVAL_SHA}")
    log(f"[mesh2d] {sps.n_shards} policy shards built in {shard_s:.3f} s: "
        f"rules {sps.shard_rule_counts()}, tensor bytes "
        f"{sps.shard_tensor_bytes()}; 2D scan {wall:.3f} s (flatten "
        f"{spans.get('flatten', 0):.3f}, device_dispatch "
        f"{spans.get('device_dispatch', 0):.3f}, host_resolve "
        f"{spans.get('host_resolve', 0):.3f}); the 1D scan of the same "
        f"{n} {one_s:.3f} s; matrix and counts equal bit for bit, sha256 "
        f"{EXPECTED_EVAL_SHA[:8]}…; the counts form's counts equal to the "
        f"plain version's in each shard; K7's program (K1 -> counts form) "
        f"on the card a shard, between events: {checked.times()}")
    return launches, v2


def scan_split() -> dict:
    """Seconds of the newest scan trace's own spans: ``scan_evaluate``
    (the lane's verdicts, host lane included) and ``scan_responses``
    (the responses built from them)."""
    from kyverno_tpu_torch.runtime import tracing

    tr = next(t for t in tracing.recorder().traces(n=64) if t.kind == "scan")
    check(tr.spans_dropped == 0, f"the scan trace dropped {tr.spans_dropped} "
          "spans")
    out = {"scan_evaluate": 0.0, "scan_responses": 0.0}
    for sp in tr.spans:
        if sp.name in out:
            out[sp.name] += sp.duration_s
    return out


def response_matrix(result, rule_refs, resources) -> np.ndarray:
    """The verdict matrix [B, R] (rule order) that a scan's responses
    state: each response's rule statuses at its resource's row and its
    rule's column, NOT_APPLICABLE where no response names the cell."""
    code = {"pass": 1, "fail": 2, "skip": 3, "error": 4}
    row = {(r.get("kind", ""), (r.get("metadata") or {}).get("namespace", ""),
            (r.get("metadata") or {}).get("name", "")): b
           for b, r in enumerate(resources)}
    col = {(ref.policy.name, ref.rule.name): ref.rule_index
           for ref in rule_refs}
    out = np.zeros((len(resources), len(col)), dtype=np.int8)
    for resp in result.responses:
        pr = resp.policy_response
        b = row[(pr.resource.kind, pr.resource.namespace, pr.resource.name)]
        for rr in pr.rules:
            out[b, col[(pr.policy.name, rr.name)]] = code[rr.status.value]
    return out


def state_matrix(scanner) -> tuple[list, np.ndarray]:
    """The scanner's persisted verdict_matrix() with its columns in rule
    order (it keeps them sorted by (policy, rule))."""
    keys, ckeys, m = scanner.verdict_matrix()
    at = {c: j for j, c in enumerate(ckeys)}
    order = [at[(ref.policy.name, ref.rule.name)]
             for ref in scanner.cps.rule_refs]
    return keys, np.ascontiguousarray(m[:, order])


def matrix_key(m: np.ndarray, rule_refs) -> tuple:
    """What a scan's result and reports state for its response matrix
    ``m``: (violations, rule results, responses, per-policy pass and
    fail totals), as BackgroundScanner and ReportGenerator count them:
    a rule result each non-NOT_APPLICABLE cell, a response each
    resource and policy with one, a violation each FAIL."""
    pol = {}
    for ref in rule_refs:
        pol.setdefault(ref.policy.name, []).append(ref.rule_index)
    totals, responses = {}, 0
    for name, cols in pol.items():
        sub = m[:, cols]
        responses += int((sub != 0).any(axis=1).sum())
        t = [int((sub == 1).sum()), int((sub == 2).sum())]
        if (sub != 0).any():
            totals[name] = t
    return int((m == 2).sum()), int((m != 0).sum()), responses, totals


def report_totals(reports: list) -> dict:
    """Per-policy pass and fail totals of aggregate()'s reports."""
    out = {}
    for rep in reports:
        for r in rep["results"]:
            t = out.setdefault(r["policy"], [0, 0])
            if r["result"] == "pass":
                t[0] += 1
            elif r["result"] == "fail":
                t[1] += 1
    return out


def background_phase(library_docs: list, mesh_1d, n: int = 10_000) -> dict:
    """[background]: BackgroundScanner over the library with a
    ReportGenerator, n resources, through each lane of scan() with the
    launch counters set to 0 just before and read just after; then a
    one-policy update, 90 MODIFIED and 10 DELETED watch events and
    delta_scan(), against a fresh scanner's full scan of the same state.
    Returns each lane's launches."""
    import torch

    from kyverno_tpu_torch.api.load import load_policy
    from kyverno_tpu_torch.ops import _build
    from kyverno_tpu_torch.parallel import mesh as mesh_mod
    from kyverno_tpu_torch.runtime.background import BackgroundScanner
    from kyverno_tpu_torch.runtime.reports import ReportGenerator

    resources = [mixed_resource(i) for i in range(n)]
    mesh_2d = mesh_mod.make_mesh([torch.device("cuda", 0)] * 4, shape=(4, 1))
    # lane: (environment, mesh, expected launches of K1, eval_rules and
    # its counts form, rows); a mesh lane's counts forms are held to the
    # plain counts as in [mesh]. The incremental lane scans all n, held to
    # the pinned sha256; the single and 1D lanes scan the first
    # BACKGROUND_LANE_ROWS ([evaluate] and [mesh] hold those paths at
    # 10,000 and more), the 2D (4, 1) lane (the scanner's own
    # ShardedPolicySet) the first BACKGROUND_2D_ROWS, [mesh2d] having
    # scanned all 10,000 on that mesh: their matrices are held to the
    # incremental lane's first rows, and their counts to those matrices
    kernels = ("glob_nfa", "eval_rules", "eval_rules_counts")
    lanes = [("incremental", {}, None, (1, 1, 0), n),
             ("single", {"KTPU_INCREMENTAL": "0"}, None, (1, 1, 0),
              min(n, BACKGROUND_LANE_ROWS)),
             ("mesh 1D", {}, mesh_1d, (1, 0, 1),
              min(n, BACKGROUND_LANE_ROWS)),
             ("mesh 2D (4, 1)", {}, mesh_2d, (4, 0, 4),
              min(n, BACKGROUND_2D_ROWS))]
    out, m_inc = {}, None
    for name, env, mesh, want, rows in lanes:
        lane_res = resources[:rows]
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            reports = ReportGenerator()
            t0 = time.perf_counter()
            sc = BackgroundScanner([load_policy(d) for d in library_docs],
                                   report_gen=reports, mesh=mesh)
            compile_s = time.perf_counter() - t0
            _build.reset_launches()
            with CheckedCounts() as checked, AllSpans():
                t0 = time.perf_counter()
                result = sc.scan(lane_res)
                scan_s = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
            split = scan_split()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        got = tuple(launches[k] for k in kernels)
        check(got == want, f"[background] {name}: launches {launches}, "
              f"expected {dict(zip(kernels, want))}")
        if mesh is not None:
            check_mesh_launches(f"[background] {name}", launches, want[0],
                                checked)
        m = response_matrix(result, sc.cps.rule_refs, lane_res)
        if rows == n:
            check(matrix_sha(m) == EXPECTED_EVAL_SHA,
                  f"[background] {name}: the responses' matrix sha256 "
                  f"{matrix_sha(m)} != {EXPECTED_EVAL_SHA}")
        else:
            check(np.array_equal(m, m_inc[:rows]),
                  f"[background] {name}: the responses' matrix of the "
                  f"first {rows} rows differs from the incremental lane's")
        state = sc.verdict_matrix()
        check((state is not None) == (name == "incremental"),
              f"[background] {name}: verdict_matrix() {state is not None}")
        if state is not None:
            keys, sm = state_matrix(sc)
            check(keys == [sc._res_key(r) for r in resources]
                  and matrix_sha(sm) == EXPECTED_EVAL_SHA,
                  f"[background] {name}: verdict_matrix() sha256 "
                  f"{matrix_sha(sm)} != {EXPECTED_EVAL_SHA}")
        t0 = time.perf_counter()
        totals = report_totals(reports.aggregate())
        aggregate_s = time.perf_counter() - t0
        key = (result.violations, result.rules_evaluated,
               len(result.responses), totals)
        want_key = matrix_key(m, sc.cps.rule_refs)
        check(key == want_key, f"[background] {name}: violations, rules, "
              f"responses and report totals {key[:3]} differ from its "
              f"matrix's {want_key[:3]}"
              f"{'' if key[3] == want_key[3] else ' (report totals)'}")
        log(f"[background] {name}: {rows} resources, scan {scan_s:.3f} s "
            f"= evaluate "
            f"{split['scan_evaluate']:.3f} + responses "
            f"{split['scan_responses']:.3f} + report requests (the rest) "
            f"{scan_s - split['scan_evaluate'] - split['scan_responses']:.3f} "
            f"(compile {compile_s:.3f} s apart), aggregate() "
            f"{aggregate_s:.3f} s; "
            f"{result.violations} violations, {result.rules_evaluated} rule "
            f"results, {len(result.responses)} responses, report totals of "
            f"{len(totals)} policies as its matrix states; launches "
            f"{launches}; "
            + (f"sha256 {EXPECTED_EVAL_SHA[:8]}…" if rows == n else
               f"matrix equal to the incremental lane's first {rows} rows")
            + (f"; K7's program a shard, counts equal to the plain "
               f"version's, between events: {checked.times()}"
               if mesh is not None else ""))
        out[name] = {"launches": launches, "scan_s": scan_s}
        if name == "incremental":
            m_inc, inc = m, (sc, reports)
        del sc, reports, result
        gc.collect()

    # delta: a one-policy update and 100 watch events on the incremental
    # scanner
    sc, reports = inc
    docs = [dict(d) for d in library_docs]
    j = next(i for i, d in enumerate(docs)
             if "pattern" in d["spec"]["rules"][0]["validate"]
             and "Pod" in d["spec"]["rules"][0]["match"]["resources"]["kinds"])
    changed = json.loads(json.dumps(docs[j]))
    changed["spec"]["rules"][0]["validate"]["pattern"] = {
        "spec": {"containers": [{"image": "!*:1.21"}]}}
    policies = list(sc.policies)
    policies[j] = load_policy(changed)
    current = {sc._res_key(r): r for r in resources}
    modified = [i for i in range(n) if i % 10 < 9][:90]
    deleted = [i for i in range(n) if i % 10 < 9][90:100]
    for i in modified:
        body = json.loads(json.dumps(resources[i]))
        spec = body["spec"] if body["kind"] == "Pod" else \
            body["spec"]["template"]["spec"]
        spec["containers"][0]["image"] = f"registry.io/rebuilt/{i}:v9"
        sc.note_resource("MODIFIED", body)
        current[sc._res_key(body)] = body
    for i in deleted:
        sc.note_resource("DELETED", resources[i])
        current.pop(sc._res_key(resources[i]))
    _build.reset_launches()
    t0 = time.perf_counter()
    delta = sc.delta_scan(policies)
    delta_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    check(delta.delta and delta.cols_evaluated == 1
          and delta.rows_evaluated == len(modified),
          f"delta_scan evaluated {delta.cols_evaluated} columns and "
          f"{delta.rows_evaluated} rows")
    check(launches["glob_nfa"] == 2 and launches["eval_rules"] == 2,
          f"delta_scan launched {launches}")
    after = list(current.values())
    ref = BackgroundScanner(list(policies))
    t0 = time.perf_counter()
    ref.scan(after)
    ref_s = time.perf_counter() - t0
    k_a, m_a = state_matrix(sc)
    k_b, m_b = state_matrix(ref)
    check(k_a == k_b and np.array_equal(m_a, m_b),
          "delta_scan's verdict_matrix() differs from a fresh full scan's")
    check(not (m_a == 5).any() and m_a.shape == (n - len(deleted), len(docs)),
          f"delta matrix {m_a.shape}")
    totals = report_totals(reports.aggregate())
    log(f"[background] delta_scan after a one-policy update "
        f"({docs[j]['metadata']['name']}), {len(modified)} MODIFIED and "
        f"{len(deleted)} DELETED: {delta_s:.3f} s, cols_evaluated "
        f"{delta.cols_evaluated}, rows_evaluated {delta.rows_evaluated}, "
        f"{len(delta.responses)} responses, launches {launches}; its "
        f"verdict_matrix() equal to a fresh scanner's full scan "
        f"({ref_s:.3f} s) of the same state; reports now hold "
        f"{sum(sum(t) for t in totals.values())} pass and fail results")
    out["delta"] = {"launches": launches, "scan_s": delta_s}
    return out


def counts_times(cps, sizes=(65_536, 10_000)) -> dict:
    """[times] for K7's counts form: ``eval_rules_counts`` on the
    library's blob of the first mixed resources at each size (the mesh
    scan's chunk, then 10k), back to back and between events, held to
    its plain version (``eval_rules_plain`` then ``rule_counts_plain``);
    beside it, on the same blob and K1 matrix, the matrix form alone, the
    two-call torch expression that counts the same verdicts (the counts'
    yardstick; no single PyTorch call computes the verdicts), K7's whole
    program on a shard (K1 -> counts form), and the bytes bound: the
    matrix form's bytes and 8 bytes a live rule for the counts. Returns
    the row of the first size, with the others under ``at``."""
    import torch

    from kyverno_tpu_torch.ops import eval as ev

    smi = nvidia_smi_line()
    plan = cps.plan
    R, N = plan.R, int(plan.nfa_char.shape[0])
    plan_bytes = plan.buf.numel() * 4
    nfa_bytes = sum(t.numel() * t.element_size() for t in (
        plan.nfa_char, plan.nfa_is_star, plan.nfa_is_q, plan.nfa_len))
    row = None
    for B in sizes:
        batch = cps.flatten_packed([mixed_resource(i) for i in range(B)])
        blob, shp = cps.to_device(batch)
        _, P, E, V = shp
        live = cps.tensors.n_rules_live
        m = ev.match_matrix(plan, blob, *shp)
        torch.cuda.synchronize()

        def counts_form():
            return ev.eval_rules_counts(plan, blob, *shp, m, live)

        def plain():
            v_ = ev.eval_rules_plain(plan, blob, *shp, m)
            return (v_, *ev.rule_counts_plain(v_[:, :live]))

        got, want = counts_form(), plain()
        same(f"eval_rules_counts at ({B}, {live})", got, want)
        max_err = max(float((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                      for a, b in zip(got, want))
        vl = got[0][:, :live]
        ms = cuda_ms(counts_form, 50)
        back = device_ms(counts_form)
        alone_ms = cuda_ms(lambda: ev.eval_rules(plan, blob, *shp, m), 50)
        alone_back = device_ms(lambda: ev.eval_rules(plan, blob, *shp, m))
        yard_ms = cuda_ms(lambda: ev.rule_counts_plain(vl), 50)
        yard_back = device_ms(lambda: ev.rule_counts_plain(vl))
        k7_back = device_ms(
            lambda: ev.evaluate_live_counts(plan, blob, *shp, live))
        plain_ms = cuda_ms(plain, 5, warm=1)
        nbytes = (B * P * E * 8 + 4 * B + 20 * V + N * V + plan_bytes
                  + B * R + 8 * live)
        ops = eval_rules_ops(plan, B, E, "counts")
        bound, bound_by = rules_bound(nbytes, ops)
        # K7's whole program: K1's bytes (the NFA rows, the strings and
        # their lengths read, the match matrix written) and the counts
        # form's
        k1_bytes = nfa_bytes + V * 64 + V * 4 + N * V
        k7_bound = (k1_bytes + nbytes) / HBM_BYTES_PER_S * 1e3
        log(f"[times] eval_rules_counts at B={B} R={R} live={live}: {ms:.4f} "
            f"ms a call between events, {back:.4f} ms on the card back to "
            f"back; eval_rules (matrix form) alone on the same blob "
            f"{alone_ms:.4f} ms between events, {alone_back:.4f} ms back to "
            f"back; the two-call torch yardstick over the same verdicts "
            f"{yard_ms:.4f} ms between events, {yard_back:.4f} ms back to "
            f"back; K7's program (K1 -> counts form) {k7_back:.4f} ms back "
            f"to back, bound {k7_bound:.5f} ms by bytes; plain "
            f"{plain_ms:.4f} ms; bound {bound:.5f} ms by {bound_by} "
            f"({nbytes} bytes, {ops} integer operations); "
            f"{100 * bound / back:.2f}% of the bound back to back; {smi}")
        entry = {"ms": ms, "device_ms": back, "plain_ms": plain_ms,
                 "eval_rules_ms": alone_ms, "eval_rules_device_ms": alone_back,
                 "yardstick_ms": yard_ms, "yardstick_device_ms": yard_back,
                 "k7_device_ms": k7_back, "k7_bound_ms": k7_bound,
                 "bound_ms": bound, "bound_by": bound_by, "bytes": nbytes,
                 "operations": ops, "max_abs_err": max_err,
                 "shape": [B, live]}
        if row is None:
            row = {"name": "eval_rules_counts", "route": "cuda", **entry,
                   "library_ms": None, "at": {}}
        else:
            row["at"][str(B)] = entry
        del got, want, vl, m, blob, batch
    return row


def all_cards_phase(policies: list, n: int = 10_000) -> None:
    """[cards] ``--all-cards``: sharded_scan of the library over
    mixed_resource(0..n-1) on the 1D mesh of every card and on the 2D
    (2, cards / 2) mesh of them, each equal to the one-card scan and to
    the pinned sha256, with K1 and the counts form launched once a data
    shard (and shard row) and nothing else, and each counts form's counts
    equal to the plain version's over its own verdicts."""
    import torch

    from kyverno_tpu_torch.models import CompiledPolicySet
    from kyverno_tpu_torch.models.engine import ShardedPolicySet
    from kyverno_tpu_torch.ops import _build
    from kyverno_tpu_torch.parallel import mesh as mesh_mod

    cards = torch.cuda.device_count()
    check(cards > 1, f"--all-cards needs 2 or more cards, {cards} visible")
    cps = CompiledPolicySet(policies, device="cuda:0")
    resources = [mixed_resource(i) for i in range(n)]
    want = mesh_mod.sharded_scan(cps, resources, mesh_mod.make_mesh(
        [torch.device("cuda", 0)]))
    check(matrix_sha(want[0]) == EXPECTED_EVAL_SHA, "the one-card scan's "
          f"sha256 {matrix_sha(want[0])} != {EXPECTED_EVAL_SHA}")
    meshes = [("1D", cps, mesh_mod.make_mesh(shape=None), cards)]
    if cards % 2 == 0:
        meshes.append(("2D", ShardedPolicySet(2, device="cuda:0").refresh(
            policies), mesh_mod.make_mesh(shape=(2, cards // 2)), cards))
    for label, src, mesh, launches_each in meshes:
        _build.reset_launches()
        with CheckedCounts() as checked:
            t0 = time.perf_counter()
            got = mesh_mod.sharded_scan(src, resources, mesh)
            wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        check_mesh_launches(f"[cards] {label}", launches, launches_each,
                            checked)
        for name, a, b in zip(("matrix", "fails", "passes"), got, want):
            check(a.dtype == b.dtype and np.array_equal(a, b),
                  f"[cards] {label}: the {name} differ from the one-card scan's")
        log(f"[cards] {label} mesh {mesh}: sharded_scan of {n} {wall:.3f} s; "
            f"matrix, fails and passes equal to the one-card scan's, sha256 "
            f"{EXPECTED_EVAL_SHA[:8]}…; launches {launches}; the counts "
            f"form's counts equal to the plain version's on each card")


def same_mutations(name: str, got: list, want: list) -> None:
    """Two BatchMutator results: the same patch bytes (json.dumps) and the
    same patched resource for every document."""
    check(len(got) == len(want), f"{name}: {len(got)} vs {len(want)} results")
    for i, (g, w) in enumerate(zip(got, want)):
        if (json.dumps(g.patches) != json.dumps(w.patches)
                or g.patched_resource != w.patched_resource):
            raise AssertionError(f"{name}: document {i} differs: "
                                 f"{g.patches} vs {w.patches}")


def serial_chain(policies: list, doc: dict) -> list:
    """The serial engine's patches of one document: per policy, mutate();
    the patched resource feeds the next policy."""
    from kyverno_tpu_torch.engine.context import Context
    from kyverno_tpu_torch.engine.mutation import mutate
    from kyverno_tpu_torch.engine.policy_context import PolicyContext

    patches = []
    for policy in policies:
        jctx = Context()
        jctx.add_resource(doc)
        resp = mutate(PolicyContext(policy=policy, new_resource=doc,
                                    json_context=jctx))
        patches.extend(resp.patches)
        if resp.patched_resource is not None:
            doc = resp.patched_resource
    return patches


def gate_launches(bm, n: int) -> dict:
    """The launches gate_verdicts must make over ``n`` documents: one
    eval_rules a chunk of GATE_CHUNK, and K1 a chunk where the gate's plan
    has a glob pattern (match_matrix launches it for N > 0 patterns);
    nothing else."""
    from kyverno_tpu_torch.ops import _build

    chunks = -(-n // GATE_CHUNK)
    want = {name: 0 for name in _build.LAUNCHES}
    want["eval_rules"] = chunks
    want["glob_nfa"] = chunks if int(bm._gate_cps.plan.nfa_char.shape[0]) else 0
    return want


def mutate_half(label: str, bm, docs: list, warm: list, smi: str) -> dict:
    """One half of BASELINE config 4 through a BatchMutator on the card:
    two timed draws of apply() in the lane the router picks (launches
    counted from 0 just before them), the first 1,000 patch lists against
    the serial mutate() chain, then the host lane and the device lane
    forced, equal document for document, the device lane's launches
    counted from 0 just before it; then the gate's device time a chunk
    (K1 -> eval_rules between CUDA events) beside that lane's wall, and
    the gate's launches held to their plain versions on the chunk."""
    import torch

    from kyverno_tpu_torch.models.flatten import pad_to_buckets_packed
    from kyverno_tpu_torch.ops import _build
    from kyverno_tpu_torch.ops import eval as ev

    n = len(docs)
    t0 = time.perf_counter()
    bm.apply(warm)                    # warms; calibrates the router
    warm_s = time.perf_counter() - t0
    lane = "device" if bm._auto_gate(docs) else "host"
    if lane == "device":
        bm.gate_verdicts(docs)        # every chunk's shape bucket, as bench.py
    _build.reset_launches()
    draws = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = bm.apply(docs)
        draws.append(time.perf_counter() - t0)
    auto_launches = dict(_build.LAUNCHES)
    if lane == "device":
        want = {k: 2 * v for k, v in gate_launches(bm, n).items()}
    else:
        want = {k: 0 for k in auto_launches}
    check(auto_launches == want, f"[mutate] {label}: the {lane} lane "
          f"launched {auto_launches}, not {want}")
    bad = sum(json.dumps(g.patches) != json.dumps(serial_chain(bm.policies, d))
              for d, g in zip(docs[:1000], out[:1000]))
    check(bad == 0, f"[mutate] {label}: {bad} of 1,000 patch lists differ "
          "from the serial mutate() chain")
    patched = sum(1 for r in out if r.patches)
    log(f"[mutate] {label} x {n}: router lane {lane} (gate "
        f"{'kind-only' if bm._gate_trivial else 'with predicates'}, warm-up "
        f"{warm_s:.3f} s); {n / draws[0]:.1f}; {n / draws[1]:.1f} mutations/s "
        f"({draws[0]:.3f}; {draws[1]:.3f} s); {patched} patched; launches "
        f"{auto_launches}; the first 1,000 patch lists equal to the serial "
        f"mutate() chain's; {smi}")
    t0 = time.perf_counter()
    host = bm.apply(docs, use_device_gate=False)
    host_s = time.perf_counter() - t0
    same_mutations(f"[mutate] {label}: router lane vs host lane", out, host)
    _build.reset_launches()
    t0 = time.perf_counter()
    dev = bm.apply(docs, use_device_gate=True)
    dev_s = time.perf_counter() - t0
    dev_launches = dict(_build.LAUNCHES)
    want = gate_launches(bm, n)
    check(dev_launches == want, f"[mutate] {label}: the device lane "
          f"launched {dev_launches}, not {want}")
    same_mutations(f"[mutate] {label}: device lane vs host lane", dev, host)
    # the gate's program on the card, one chunk of each shape it ran
    cps = bm._gate_cps
    chunk_ms = {}
    for rows in (docs[:GATE_CHUNK], docs[(n - 1) // GATE_CHUNK * GATE_CHUNK:]):
        batch, _ = pad_to_buckets_packed(cps.flatten_packed(rows))
        blob, shp = cps.to_device(batch)
        same(f"[mutate] {label} gate at {shp}",
             ev.evaluate_blob(cps.plan, blob, *shp),
             plain_pipeline(cps.plan, blob, shp))
        chunk_ms[len(rows)] = (shp, cuda_ms(
            lambda: ev.evaluate_blob(cps.plan, blob, *shp), 50))
    torch.cuda.synchronize()
    full = n // GATE_CHUNK
    tail = n - full * GATE_CHUNK
    gate_ms = full * chunk_ms[GATE_CHUNK][1] + (chunk_ms[tail][1] if tail else 0.0)
    log(f"[mutate] {label}: host lane {host_s:.3f} s ({n / host_s:.1f} "
        f"mutations/s), device lane {dev_s:.3f} s ({n / dev_s:.1f} "
        f"mutations/s), equal document for document; device lane launches "
        f"{dev_launches}; the gate on the card (K1 -> eval_rules between "
        f"events): {chunk_ms[GATE_CHUNK][1]:.4f} ms a {GATE_CHUNK}-row chunk "
        f"{chunk_ms[GATE_CHUNK][0]}"
        + (f", {chunk_ms[tail][1]:.4f} ms the {tail}-row tail "
           f"{chunk_ms[tail][0]}" if tail else "")
        + f"; {gate_ms:.4f} ms for the {full + bool(tail)} chunks, "
        f"{100 * gate_ms / (dev_s * 1e3):.4f}% of the device lane's wall; "
        f"equal to the plain pipeline at both shapes; {smi}")
    return {"lane": lane, "mutations_per_s": [n / d for d in draws],
            "auto_launches": auto_launches, "device_launches": dev_launches,
            "host_s": host_s, "device_s": dev_s, "gate_ms": gate_ms,
            "chunk_ms": chunk_ms[GATE_CHUNK][1]}


def mutate_phase(n: int = MUTATE_DOCS) -> dict:
    """BASELINE config 4 as bench.py runs it (bench.py:953-1055), on the
    card: add-default-labels over ``n`` Pods (a kind-only gate, which the
    router sends to the host), then annotate-bench-apps over ``n`` mixed
    resources (a label-selector gate, min_gate_batch=64), each through
    :func:`mutate_half`; no gate fallback and no flattener fallback."""
    from kyverno_tpu_torch.api.load import load_policy
    from kyverno_tpu_torch.engine.mutate import batch as mutate_batch
    from kyverno_tpu_torch.models import native_flatten

    smi = nvidia_smi_line()
    mutate_batch.reset_gate_fallbacks()
    native_flatten.reset_fallbacks()
    pods = [make_pod(i) for i in range(n)]
    bm = mutate_batch.BatchMutator([load_policy(ADD_DEFAULT_LABELS)])
    labels = mutate_half("add-default-labels", bm, pods, pods[:64], smi)
    check(labels["lane"] == "host", "the kind-only gate was routed to the card")
    del pods
    mixed = [mixed_resource(i) for i in range(n)]
    bm2 = mutate_batch.BatchMutator([load_policy(ANNOTATE_BENCH_APPS)],
                                    min_gate_batch=64)
    check(not bm2._gate_trivial, "the selector gate compiled as kind-only")
    selector = mutate_half("selector-gated mixed", bm2, mixed, mixed[:256], smi)
    check(all(v == 0 for v in mutate_batch.GATE_FALLBACKS.values()),
          f"mutate gate fallbacks {mutate_batch.GATE_FALLBACKS}")
    check(all(v == 0 for v in native_flatten.FALLBACKS.values()),
          f"native flattener fallbacks in [mutate] {native_flatten.FALLBACKS}")
    log(f"[mutate] gate fallbacks {mutate_batch.GATE_FALLBACKS}; native "
        f"flattener fallbacks {native_flatten.FALLBACKS}")
    return {"add-default-labels": labels, "selector": selector}


AUTOGEN_THREADS, AUTOGEN_PER_THREAD = 16, 16


def controller_request(i: int, salt: str) -> tuple[dict, dict]:
    """One distinct admission of a pod controller (a Deployment for even
    ``i``, a CronJob for odd) under a salted name and uid, and the
    context payload the webhook's ctx_cb gives the flush for it."""
    kind = "Deployment" if i % 2 == 0 else "CronJob"
    res = make_controller(i, kind)
    res["metadata"]["name"] = f"{kind.lower()}-{salt}{i}"
    request = {"uid": f"uid-{salt}{i}", "kind": {"kind": kind},
               "namespace": "default", "operation": "CREATE", "object": res}
    return res, {"request": request, "namespace_labels": {}, "roles": [],
                 "cluster_roles": [], "exclude_group_role": []}


def eval_rules_ops(plan, B: int, E: int, form: str = "matrix") -> int:
    """The integer operations eval_rules' ``form`` ("matrix", "scan" or
    "counts") needs on a batch of B resources at E slots a path, counted
    from the plan as it is built: every distinct check row of a tile on
    each slot, its distinct aux rows, each gate's gate rows on each slot;
    per 32-resource word, every entry of the rules' walks and each rule's
    composition; per (resource, rule) the verdict byte, or per rule and
    word the counts (OPS_* above)."""
    from kyverno_tpu_torch.ops import plan as pl

    per_res = per_word = 0
    for row in plan.tile_table:
        off, n = int(row[pl.TT_OFF]), int(row[pl.TT_WORDS])
        sec = plan.buf_np[off:off + n]

        def arr(h, k):
            return sec[sec[h]:sec[h] + k]

        C, X, R = (int(sec[h]) for h in (pl.TS_C, pl.TS_X, pl.TS_R))
        ng = int(sec[pl.TS_NGATES])
        is_gate = arr(pl.TS_CHK, C * pl.CK_NCOLS).reshape(pl.CK_NCOLS, C)[
            pl.CK_IS_GATE]
        gate_grp = arr(pl.TS_GATE_GRP, int(arr(pl.TS_GATE_PTR, ng + 1)[-1]))
        grp_ptr = sec[sec[pl.TS_GRP_PTR]:sec[pl.TS_GRP_ROW]]
        grp_row = sec[sec[pl.TS_GRP_ROW]:]
        # each gate's rows, as gate_word walks them
        gate_rows = sum(int(is_gate[grp_row[grp_ptr[g]:grp_ptr[g + 1]]].sum())
                        for g in gate_grp)
        n_axg = int(sec[pl.TS_AXG_ROW] - sec[pl.TS_AXG_PTR]) - 1
        entries = (int(arr(pl.TS_PAT_PTR, R + 1)[-1])
                   + int(arr(pl.TS_AUXP_PTR, R + 1)[-1])
                   + int(arr(pl.TS_AXG_PTR, n_axg + 1)[-1]))
        per_res += ((C + gate_rows) * E * OPS_CHECK_SLOT + X * OPS_AUX_ROW)
        per_word += entries * OPS_ENTRY + R * (
            OPS_RULE + (OPS_COUNT if form == "counts" else 0))
    words = -(-B // 32)
    return (B * per_res + words * per_word
            + (0 if form == "scan" else B * plan.R * OPS_BYTE))


def rules_bound(nbytes: int, ops: int) -> tuple[float, str]:
    """(bound ms, "bytes" or "operations"): the larger of the two terms."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT32_OPS_PER_S * 1e3
    return (by_ops, "operations") if by_ops > by_bytes else (by_bytes, "bytes")


def eval_rules_bytes(st) -> int:
    """The bytes eval_rules' matrix form must move on a Stages blob: the
    cells, bmeta, the dictionary rows, the glob matrix and the plan read
    once, the verdicts written once."""
    plan = st.plan
    n_pat = int(plan.nfa_char.shape[0])
    return (st.B * st.P * st.E * 8 + 4 * st.B + 20 * st.V + n_pat * st.V
            + plan.buf.numel() * 4 + st.B * plan.R)


def autogen_phase(n: int = AUTOGEN_RESOURCES) -> dict:
    """[autogen]: what the server does to a policy, then the screen on the
    card. The 250-policy library goes through the port's policy webhook
    steps (apply_defaults -> mutate_policy_for_autogen -> validate_policy
    -> validate_policy_mutation): 670 rules, no error. The autogen'd
    policies go into a PolicyCache on the card; ``n`` resources cycling
    Pod, the five pod controllers and Service are each evaluated in their
    kind's population (the audit populations: the defaults make every
    policy audit) with the launch counters set to 0 just before, and the
    resolved matrix, built by (policy, rule name), must have no HOST cell
    and the JAX package's histogram and sha256; a second pass from the
    verdict memo must give the same. On the full 670-column plan every
    kernel is held to its plain version (zero tolerance) and eval_rules is
    timed between CUDA events; its device verdicts outside HOST cells
    equal the resolved matrix. Then a burst of Deployments and CronJobs
    (16 threads x 16 distinct) through an AdmissionBatcher over the cache,
    as the webhook screens audit policies: every device answer equal to
    the port's oracle on its resource, K6 dispatches, no failed flush."""
    import torch

    from kyverno_tpu_torch.models import CompiledPolicySet, Verdict, engine
    from kyverno_tpu_torch.ops import _build
    from kyverno_tpu_torch.runtime import hostlane
    from kyverno_tpu_torch.runtime.batch import (ATTENTION, CLEAN, ORACLE,
                                                 AdmissionBatcher)
    from kyverno_tpu_torch.runtime.policycache import PolicyCache, PolicyType

    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    policies, errors = autogen_policies(_synth_policy_docs(250), policy_steps())
    steps_s = time.perf_counter() - t0
    cols = rule_columns(policies)
    n_auto = sum(r.startswith("autogen-") for _, r in cols)
    check(errors == [], f"[autogen] policy errors: {errors[:5]}")
    check(len(cols) == AUTOGEN_RULES and n_auto == 420,
          f"[autogen] {len(cols)} rules, {n_auto} autogen'd")
    audit = PolicyType.VALIDATE_AUDIT
    check(all(p.spec.validation_failure_action == "audit" for p in policies),
          "[autogen] the defaults did not make every policy audit")
    cache = PolicyCache()
    for p in policies:
        cache.add(p)
    t0 = time.perf_counter()
    pops = {k: cache.compiled(audit, k, "default") for k in AUTOGEN_KINDS}
    compile_s = time.perf_counter() - t0
    for k, c in pops.items():
        check(c.device.type == "cuda", f"[autogen] {k} population on {c.device}")
    log(f"[autogen] library 250 through the policy webhook's steps in "
        f"{steps_s:.3f} s: {len(cols)} rules ({n_auto} autogen'd), 0 errors; "
        f"the policy cache's audit populations compiled on the card in "
        f"{compile_s:.3f} s: " + ", ".join(
            f"{k} {len(c.policies)} policies / {c.tensors.n_rules_live} rules "
            f"({int(c.tensors.rule_host_only[:c.tensors.n_rules_live].sum())} "
            f"host-only)" for k, c in pops.items()))

    resources = [autogen_resource(i) for i in range(n)]
    rows = {k: [b for b, r in enumerate(resources) if r["kind"] == k]
            for k in AUTOGEN_KINDS}

    def resolved() -> np.ndarray:
        out = np.zeros((n, len(cols)), dtype=np.int8)
        for k, c in pops.items():
            m = c.evaluate([resources[b] for b in rows[k]])
            check(not (m == Verdict.HOST).any(), f"[autogen] {k}: evaluate() "
                  f"left {int((m == Verdict.HOST).sum())} HOST cells")
            src = [ref.rule_index for ref in c.rule_refs]
            dst = [cols[(ref.policy.name, ref.rule.name)] for ref in c.rule_refs]
            out[np.ix_(rows[k], dst)] = m[:, src]
        return out

    memo = hostlane.host_cache()
    memo.clear()
    m0 = memo.stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    got = resolved()
    first_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    m1 = memo.stats()
    t0 = time.perf_counter()
    again = resolved()
    memo_s = time.perf_counter() - t0
    m2 = memo.stats()
    for k in EVALUATE_KERNELS:
        check(launches[k] >= 1, f"[autogen] evaluate() did not launch {k}")
    check(np.array_equal(got, again), "[autogen] the memo'd pass differs")
    hist = np.bincount(got.ravel().astype(np.int64), minlength=6).tolist()
    sha = matrix_sha(got)
    want_hist, want_sha = ((EXPECTED_AUTOGEN_HIST, EXPECTED_AUTOGEN_SHA)
                           if n == AUTOGEN_RESOURCES else
                           (EXPECTED_AUTOGEN_HIST_1K, EXPECTED_AUTOGEN_SHA_1K))
    check(hist == want_hist, f"[autogen] histogram {hist} != {want_hist}")
    check(sha == want_sha, f"[autogen] sha256 {sha} != {want_sha}")
    first, second = memo_delta(m0, m1), memo_delta(m1, m2)
    check(second[1] == 0, f"[autogen] the memo'd pass missed {second[1]} cells")
    log(f"[autogen] resolved matrix {n} x {len(cols)} through the cache's "
        f"populations (evaluate() by kind): first {first_s:.3f} s ({first[1]} "
        f"HOST cells resolved, {first[1] / n:.3f} a resource), from the memo "
        f"{memo_s:.3f} s ({second[0]} hits); launches {launches}; no HOST "
        f"cell; histogram {hist}; sha256 {sha}, the JAX package's; {smi}")

    # the 670-column plan: every kernel against its plain version
    full = CompiledPolicySet(policies)
    check([(r.policy.name, r.rule.name) for r in full.rule_refs] == list(cols),
          "[autogen] the full set's columns are not in rule_columns' order")
    st = Stages(full, resources)
    counts, seen = st.compare("autogen")
    m_k = st.k1()
    v = st.rules(m_k)
    geo = st.launch()
    device_v = v.cpu().numpy()[:, :full.tensors.n_rules_live]
    live = device_v != Verdict.HOST
    check(np.array_equal(device_v[live], got[live]),
          "[autogen] the full plan's device verdicts differ from the "
          "resolved matrix outside HOST cells")
    ms = cuda_ms(lambda: st.rules(m_k), 50)
    back_ms = device_ms(lambda: st.rules(m_k))
    plain_ms = cuda_ms(lambda: st.rules(m_k, plain=True), 10)
    nbytes = eval_rules_bytes(st)
    ops = eval_rules_ops(full.plan, st.B, st.E)
    bound_ms, bound_by = rules_bound(nbytes, ops)
    tiles = [tuple(int(x) for x in t) for t in full.plan.tiles]
    log(f"[autogen] the full plan: R={full.plan.R} in {full.plan.n_tiles} rule "
        f"tiles {tiles}, {full.plan.buf.numel() * 4} plan bytes; shapes "
        f"{st.shape}; eval_rules at {geometry(geo)}; "
        f"every kernel equal to its plain version {counts}; scan counts "
        f"{seen}; {int((~live).sum())} HOST cells on the card "
        f"({int((~live).sum()) / n:.3f} a resource)")
    log(f"[autogen] eval_rules at B={n} on this plan: {ms:.4f} ms a call "
        f"between CUDA events, {back_ms:.4f} ms on the card back to back "
        f"(plain {plain_ms:.4f} ms); bound {bound_ms:.5f} ms by {bound_by} "
        f"({nbytes} bytes, {ops} integer operations), "
        f"{100 * bound_ms / back_ms:.2f}% of it back to back; {smi}")
    del st, m_k, v
    torch.cuda.synchronize()

    # the admission burst: Deployments and CronJobs through the batcher,
    # screened as the webhook screens audit policies
    batcher = AdmissionBatcher(cache)
    try:
        for k in ("Deployment", "CronJob"):
            batcher.warmup(audit, k, "default", make_controller(1, k))

        def one(res, payload, answers):
            """One admission as the webhook handles an audit screen: in
            flight for the router, screened deadline-free with its
            payload, and through the inline oracle over every rule when
            the screen routes it there (ORACLE, or ATTENTION with no
            cells)."""
            with batcher.admission_in_flight():
                t1 = time.perf_counter()
                status, row = batcher.screen(
                    audit, res["kind"], "default", res, deadline_free=True,
                    timeout_s=60.0, ctx_cb=lambda: payload)
                lat = (time.perf_counter() - t1) * 1e3
                if status == ORACLE or (status == ATTENTION and not row):
                    cur = cache.compiled(audit, res["kind"], "default")
                    cur._oracle_verdicts(
                        res, list(range(cur.tensors.n_rules_live)),
                        context=payload)
            answers.append((res, payload, status, row, lat))

        def burst(salt):
            reqs = [controller_request(i, salt)
                    for i in range(AUTOGEN_THREADS * AUTOGEN_PER_THREAD)]
            start = threading.Barrier(AUTOGEN_THREADS)
            answers = []

            def client(part):
                start.wait()
                for res, payload in part:
                    one(res, payload, answers)

            ws = [threading.Thread(target=client, args=(
                reqs[w * AUTOGEN_PER_THREAD:(w + 1) * AUTOGEN_PER_THREAD],))
                for w in range(AUTOGEN_THREADS)]
            t1 = time.perf_counter()
            for w in ws:
                w.start()
            for w in ws:
                w.join()
            return answers, time.perf_counter() - t1

        burst("warm")
        s0, d0 = dict(batcher.stats), dict(engine.DONATION_STATS)
        _build.reset_launches()
        answers, burst_s = burst("timed")
        burst_launches = dict(_build.LAUNCHES)
        stats = {k: v - s0.get(k, 0) for k, v in batcher.stats.items()
                 if isinstance(v, (int, float))}
        donated = {k: engine.DONATION_STATS[k] - d0[k] for k in d0}
        kinds, device_lats = {}, []
        t1 = time.perf_counter()
        for res, payload, status, row, lat in answers:
            kinds[status] = kinds.get(status, 0) + 1
            if status == ORACLE or (status == ATTENTION and not row):
                continue
            device_lats.append(lat)
            cur = cache.compiled(audit, res["kind"], "default")
            want = cur._oracle_verdicts(
                res, list(range(cur.tensors.n_rules_live)), context=payload)
            idx = {(r.policy.name, r.rule.name): r.rule_index
                   for r in cur.rule_refs}
            cells = {idx[(p, r)]: (vv, msg) for p, r, vv, msg in row}
            name = res["metadata"]["name"]
            for ri, (vv, msg) in want.items():
                cell = cells.get(ri)
                if cell is None:
                    check(vv == Verdict.NOT_APPLICABLE, f"[autogen] burst: "
                          f"{name} rule {ri} left out, the oracle says {vv!r}")
                    continue
                check(cell[0] == vv, f"[autogen] burst: {name} rule {ri}: "
                      f"screen {cell[0]!r}, oracle {vv!r}")
                check(not cell[1] or cell[1] == msg, f"[autogen] burst: "
                      f"{name} rule {ri}: message {cell[1]!r}, oracle {msg!r}")
            if status == CLEAN:
                check(all(vv not in (Verdict.FAIL, Verdict.ERROR)
                          for vv, _ in want.values()),
                      f"[autogen] burst: CLEAN for {name}, the oracle fails it")
        check_s = time.perf_counter() - t1
        check(batcher.stats.get("flush_error", 0) == 0,
              f"[autogen] burst: {batcher.stats.get('flush_error')} flushes "
              "failed")
        check(device_lats, f"[autogen] burst: no device answer: {kinds}, {stats}")
        # every answer without cells is a screen timeout or a flush's
        # release of its waiter, never a swallowed failure
        empty = sum(1 for _, _, st_, row, _ in answers
                    if st_ == ATTENTION and not row)
        check(empty == stats.get("screen_timeout", 0)
              + stats.get("flush_fallback", 0),
              f"[autogen] burst: {empty} answers without cells, "
              f"{stats.get('screen_timeout', 0)} screen timeouts, "
              f"{stats.get('flush_fallback', 0)} released by a flush")
        check(donated["dispatches"] > 0, f"[autogen] burst: K6 {donated}")
        for k in EVALUATE_KERNELS:
            check(burst_launches[k] >= 1,
                  f"[autogen] burst: {k} not launched: {burst_launches}")
        p50, p99 = percentiles(device_lats)
        log(f"[autogen] burst of {len(answers)} distinct Deployments and "
            f"CronJobs ({AUTOGEN_THREADS} threads x {AUTOGEN_PER_THREAD}) in "
            f"{burst_s:.3f} s: answers {kinds}; {len(device_lats)} answered by "
            f"the device, screen p50 {p50:.3f} ms, p99 {p99:.3f} ms, every one "
            f"equal to the port's oracle ({check_s:.3f} s to check); launches "
            f"{burst_launches}; K6 {donated}; routing " + ", ".join(
                f"{k} {stats.get(k, 0)}" for k in (
                    "oracle", "device", "clean", "attention", "screen_timeout",
                    "flush_fallback", "flush_error"))
            + f"; {smi}")
    finally:
        batcher.stop()
    memo.clear()
    return {"launches": launches, "burst_launches": burst_launches,
            "eval_rules": {"ms": ms, "device_ms": back_ms,
                           "plain_ms": plain_ms, "bound_ms": bound_ms,
                           "bound_by": bound_by, "bytes": nbytes,
                           "operations": ops, "geometry": list(geo),
                           "tiles": full.plan.n_tiles},
            "first_s": first_s, "memo_s": memo_s, "compile_s": compile_s}


class LocalRegistry:
    """A registry on 127.0.0.1 that speaks the Docker Registry HTTP API v2
    (manifests and blobs, no auth), with cosign's signature objects under
    ``sha256-<hex>.sig``: a SimpleSigning payload blob whose layer carries
    an ECDSA-P256 signature, made with the port's ``utils.ecdsa``."""

    def __init__(self):
        self.manifests, self.blobs, self.requests = {}, {}, []
        self.httpd = None

    def put_blob(self, repo: str, data: bytes) -> str:
        digest = "sha256:" + hashlib.sha256(data).hexdigest()
        self.blobs[(repo, digest)] = data
        return digest

    def put_manifest(self, repo: str, ref: str, manifest: dict) -> str:
        body = json.dumps(manifest).encode()
        digest = "sha256:" + hashlib.sha256(body).hexdigest()
        self.manifests[(repo, ref)] = self.manifests[(repo, digest)] = body
        return digest

    def push_image(self, repo: str, tag: str) -> str:
        cfg = self.put_blob(repo, json.dumps({"repo": repo, "tag": tag}).encode())
        return self.put_manifest(repo, tag, {
            "schemaVersion": 2, "config": {"digest": cfg}, "layers": []})

    def cosign_sign(self, repo: str, digest: str, priv: int) -> None:
        import base64

        from kyverno_tpu_torch.engine.registry_verify import SIG_ANNOTATION
        from kyverno_tpu_torch.utils import ecdsa

        payload = json.dumps({"critical": {
            "identity": {"docker-reference": repo},
            "image": {"docker-manifest-digest": digest},
            "type": "cosign container image signature"},
            "optional": None}).encode()
        sig = base64.b64encode(ecdsa.sign(priv, payload)).decode()
        blob = self.put_blob(repo, payload)
        self.put_manifest(repo, digest.replace("sha256:", "sha256-") + ".sig", {
            "schemaVersion": 2, "layers": [{
                "digest": blob, "size": len(payload),
                "annotations": {SIG_ANNOTATION: sig}}]})

    def start(self) -> str:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        reg = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                reg.requests.append(self.path)
                parts = self.path.split("/")
                body, headers = None, []
                if len(parts) >= 5 and parts[1] == "v2":
                    what, ref, repo = parts[-2], parts[-1], "/".join(parts[2:-2])
                    body = (reg.manifests if what == "manifests"
                            else reg.blobs).get((repo, ref))
                    if body is not None and what == "manifests":
                        headers = [("Docker-Content-Digest", "sha256:"
                                    + hashlib.sha256(body).hexdigest())]
                code, body = (200, body) if body is not None else (404, b"{}")
                self.send_response(code)
                for k, v in headers:
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        return f"127.0.0.1:{self.httpd.server_address[1]}"

    def stop(self) -> None:
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()


class DictClient:
    """A cluster as a dict, (kind, namespace, name) -> document: what
    ``generate`` and ``CrdSync`` read, and where generated documents go."""

    def __init__(self, docs=()):
        self.store = {}
        self.lock = threading.Lock()
        for d in docs:
            self.create_resource(d)

    def get_resource(self, api_version, kind, namespace, name):
        import copy

        with self.lock:
            return copy.deepcopy(self.store.get((kind, namespace or "", name)))

    def list_resource(self, api_version, kind, namespace=""):
        import copy

        with self.lock:
            return [copy.deepcopy(v) for (k, ns, _), v in sorted(
                self.store.items()) if k == kind
                and (not namespace or ns == namespace)]

    def get_configmap(self, namespace, name):
        return self.get_resource("v1", "ConfigMap", namespace, name)

    def create_resource(self, doc):
        import copy

        meta = doc.get("metadata") or {}
        with self.lock:
            self.store[(doc.get("kind", ""), meta.get("namespace", ""),
                        meta.get("name", ""))] = copy.deepcopy(doc)
        return doc


REGCRED = {"apiVersion": "v1", "kind": "Secret",
           "metadata": {"name": "regcred", "namespace": "default",
                        "uid": "u-1", "resourceVersion": "7"},
           "type": "kubernetes.io/dockerconfigjson",
           "data": {".dockerconfigjson": "e30="}}
NAMESPACE_DEFAULTS = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "namespace-defaults"},
    "spec": {"rules": [{
        "name": "default-deny",
        "match": {"resources": {"kinds": ["Namespace"]}},
        "generate": {
            "apiVersion": "networking.k8s.io/v1", "kind": "NetworkPolicy",
            "name": "default-deny",
            "namespace": "{{request.object.metadata.name}}",
            "synchronize": True,
            "data": {"spec": {"podSelector": {},
                              "policyTypes": ["Ingress", "Egress"]}}},
    }, {
        "name": "clone-regcred",
        "match": {"resources": {"kinds": ["Namespace"]}},
        "generate": {
            "apiVersion": "v1", "kind": "Secret", "name": "regcred",
            "namespace": "{{request.object.metadata.name}}",
            "clone": {"namespace": "default", "name": "regcred"}},
    }]},
}


def generated_reference(ns: str) -> dict:
    """What NAMESPACE_DEFAULTS must generate for Namespace ``ns``, written
    out by hand: rule name -> document."""
    def labels(rule):
        return {"kyverno.io/generated-by-policy": "namespace-defaults",
                "kyverno.io/generated-by-rule": rule,
                "kyverno.io/generated-by-kind": "Namespace",
                "kyverno.io/generated-by-namespace": "",
                "kyverno.io/generated-by-name": ns}

    return {
        "default-deny": {
            "apiVersion": "networking.k8s.io/v1", "kind": "NetworkPolicy",
            "metadata": {"name": "default-deny", "namespace": ns,
                         "labels": labels("default-deny")},
            "spec": {"podSelector": {}, "policyTypes": ["Ingress", "Egress"]}},
        "clone-regcred": {
            "apiVersion": "v1", "kind": "Secret",
            "metadata": {"name": "regcred", "namespace": ns,
                         "labels": labels("clone-regcred")},
            "type": "kubernetes.io/dockerconfigjson",
            "data": {".dockerconfigjson": "e30="}},
    }


def generate_namespaces(policy, namespaces: list, client,
                        workers: int = 1) -> dict:
    """generate() then apply_generate_rule for each PASS row, over
    ``namespaces``, writing each document to ``client``; with ``workers``
    > 1 over a thread pool. Returns (namespace, rule) -> (mode, document)."""
    from concurrent.futures import ThreadPoolExecutor

    from kyverno_tpu_torch.engine.context import Context
    from kyverno_tpu_torch.engine.generation import apply_generate_rule, generate
    from kyverno_tpu_torch.engine.policy_context import PolicyContext

    rules = {r.name: r for r in policy.spec.rules}

    def one(ns):
        ctx = Context()
        ctx.add_resource(ns)
        pctx = PolicyContext(policy=policy, new_resource=ns, json_context=ctx,
                             client=client)
        out = {}
        for rr in generate(pctx).policy_response.rules:
            if rr.status.value != "pass":
                continue
            doc, mode = apply_generate_rule(rules[rr.name], pctx, ns, client)
            if doc is not None:
                client.create_resource(doc)
            out[(ns["metadata"]["name"], rr.name)] = (mode, doc)
        return out

    results = {}
    if workers > 1:
        with ThreadPoolExecutor(workers) as pool:
            for out in pool.map(one, namespaces):
                results.update(out)
    else:
        for ns in namespaces:
            results.update(one(ns))
    return results


SPROCKET_CRD = {
    "apiVersion": "apiextensions.k8s.io/v1", "kind": "CustomResourceDefinition",
    "metadata": {"name": "sprockets.acme.io"},
    "spec": {"group": "acme.io",
             "names": {"kind": "Sprocket", "plural": "sprockets"},
             "versions": [{"name": "v1", "served": True, "storage": True,
                           "schema": {"openAPIV3Schema": {
                               "type": "object", "properties": {
                                   "apiVersion": {"type": "string"},
                                   "kind": {"type": "string"},
                                   "metadata": {
                                       "type": "object",
                                       "x-kubernetes-preserve-unknown-fields":
                                           True},
                                   "spec": {"type": "object", "properties": {
                                       "teeth": {"type": "integer"},
                                       "finish": {"type": "string"},
                                       "port": {"x-kubernetes-int-or-string":
                                                True}}}}}}}]},
}


def actions_phase(n_pods: int = 1000, n_namespaces: int = 1000) -> dict:
    """[actions]: the host work of the verifyImages, generate and policy
    planes on the card's machine (its Python, no PyYAML assumed, no
    network, no cryptography). verifyImages: a RegistryVerifier against a
    LocalRegistry on 127.0.0.1 holding eight images (six signed with the
    port's ECDSA, one with a forged signature, one unsigned), and
    ``n_pods`` Pods over them through verify_and_patch_images: each signed
    image patched to its digest, the forged and the unsigned refused, and
    every repeat of a signed image taken by the verifier's cache (at most
    three registry requests an image). Generate: generate() and
    apply_generate_rule over ``n_namespaces`` Namespaces with a ``data``
    rule and a ``clone`` rule against a DictClient, over eight threads and
    serially, the two equal and equal to documents written out by hand.
    OpenAPI: schemas_from_crd on a CRD -> register_schema ->
    validate_resource on a valid and an invalid document, CrdSync over
    the DictClient, and a mutate policy for the kind schema-checked."""
    import importlib.util

    from kyverno_tpu_torch.api.load import load_policy
    from kyverno_tpu_torch.engine.context import Context
    from kyverno_tpu_torch.engine.image_verify import verify_and_patch_images
    from kyverno_tpu_torch.engine.policy_context import PolicyContext
    from kyverno_tpu_torch.engine.registry_verify import (RegistryClient,
                                                          RegistryVerifier)
    from kyverno_tpu_torch.policy import crd_sync, openapi
    from kyverno_tpu_torch.utils import ecdsa

    loaded0 = {m for m in ("yaml", "cryptography") if m in sys.modules}
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("yaml", "cryptography")}
    out = {}
    # ---- verifyImages against the local registry
    reg = LocalRegistry()
    host = reg.start()
    try:
        priv, pub = ecdsa.generate_keypair()
        forger, _ = ecdsa.generate_keypair()
        pem = ecdsa.public_key_to_pem(pub)
        digests = {}
        for j in range(8):
            repo = f"team/app{j}"
            digests[repo] = reg.push_image(repo, "v1")
            if j < 6:
                reg.cosign_sign(repo, digests[repo], priv)
            elif j == 6:
                reg.cosign_sign(repo, digests[repo], forger)
        policy = load_policy({
            "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
            "metadata": {"name": "verify-team-images"},
            "spec": {"validationFailureAction": "enforce", "rules": [{
                "name": "check-signature",
                "match": {"resources": {"kinds": ["Pod"]}},
                "verifyImages": [{"image": f"{host}/team/*", "key": pem}]}]}})
        verifier = RegistryVerifier(RegistryClient(plain_http=True),
                                    default_registry=host)
        seen = {}
        t0 = time.perf_counter()
        for i in range(n_pods):
            repo = f"team/app{i % 8}"
            image = f"{host}/{repo}:v1"
            pod = {"apiVersion": "v1", "kind": "Pod",
                   "metadata": {"name": f"signed-{i}", "namespace": "default"},
                   "spec": {"containers": [{"name": "c", "image": image}]}}
            ctx = Context()
            ctx.add_resource(pod)
            ctx.add_image_info(pod)
            resp = verify_and_patch_images(PolicyContext(
                policy=policy, new_resource=pod, json_context=ctx), verifier)
            [rr] = resp.policy_response.rules
            j = i % 8
            if j < 6:
                check(rr.status.value == "pass" and rr.patches == [{
                    "op": "replace", "path": "/spec/containers/0/image",
                    "value": f"{image}@{digests[repo]}"}],
                    f"[actions] {image}: {rr.status} {rr.message} {rr.patches}")
            else:
                want = "does not match key" if j == 6 else "no cosign object"
                check(rr.status.value == "fail" and want in rr.message
                      and not rr.patches and not resp.successful,
                      f"[actions] {image}: {rr.status} {rr.message}")
            seen[j] = seen.get(j, 0) + 1
        verify_s = time.perf_counter() - t0
        per_repo = {}
        for path in reg.requests:
            parts = path.split("/")
            if len(parts) >= 5 and parts[1] == "v2":
                r = "/".join(parts[2:-2])
                per_repo[r] = per_repo.get(r, 0) + 1
        for j in range(6):
            check(per_repo.get(f"team/app{j}", 0) <= 3,
                  f"[actions] team/app{j}: {per_repo.get(f'team/app{j}')} "
                  "registry requests for its repeats")
        log(f"[actions] verifyImages: {n_pods} Pods over 8 images of a local "
            f"registry ({host}) in {verify_s:.3f} s "
            f"({verify_s / n_pods * 1e3:.3f} ms a Pod): 6 signed images patched "
            f"to their digests, the forged signature and the unsigned tag "
            f"refused; registry requests by repository {per_repo} (a refusal "
            f"is not cached, as in the JAX package: each of its Pods asks "
            f"again)")
        out["verify_s"] = verify_s
        out["requests"] = per_repo
    finally:
        reg.stop()

    # ---- generate: data and clone rules over Namespaces
    gen_policy = load_policy(NAMESPACE_DEFAULTS)
    namespaces = [{"apiVersion": "v1", "kind": "Namespace",
                   "metadata": {"name": f"team-{i}",
                                "labels": {"tier": str(i % 3)}}}
                  for i in range(n_namespaces)]
    results = {}
    for label, workers in (("threads", 8), ("serial", 1)):
        client = DictClient([REGCRED])
        t0 = time.perf_counter()
        results[label] = (generate_namespaces(gen_policy, namespaces, client,
                                              workers),
                          time.perf_counter() - t0, client)
    got, threads_s, client = results["threads"]
    want, serial_s, serial_client = results["serial"]
    check(got == want and client.store == serial_client.store,
          "[actions] generate over threads differs from the serial path")
    check(len(got) == 2 * n_namespaces, f"[actions] {len(got)} generated")
    for (ns, rule), (mode, doc) in got.items():
        check(mode == "CREATE" and doc == generated_reference(ns)[rule],
              f"[actions] generate {ns}/{rule}: {mode} {doc}")
    again = generate_namespaces(gen_policy, namespaces[:50], client, 8)
    modes = sorted({m for m, _ in again.values()})
    check(modes == ["UPDATE"], f"[actions] a second pass gave modes {modes}")
    log(f"[actions] generate: {n_namespaces} Namespaces x 2 rules (data, "
        f"clone) in {threads_s:.3f} s over 8 threads, {serial_s:.3f} s "
        f"serially; the same {len(got)} documents, each equal to the one "
        f"written out by hand; a second pass over 50 updates them")
    out["generate_s"] = (threads_s, serial_s)

    # ---- OpenAPI: a CRD's schema checks documents and a mutate policy
    schemas = crd_sync.schemas_from_crd(SPROCKET_CRD)
    check(set(schemas) == {"Sprocket"}, f"[actions] CRD kinds {set(schemas)}")
    try:
        for kind, schema in schemas.items():
            openapi.register_schema(kind, schema)
        good = openapi.validate_resource({
            "apiVersion": "acme.io/v1", "kind": "Sprocket",
            "metadata": {"name": "s"},
            "spec": {"teeth": 12, "finish": "matte", "port": "http"}})
        bad = openapi.validate_resource({
            "apiVersion": "acme.io/v1", "kind": "Sprocket",
            "metadata": {"name": "s"}, "spec": {"teeth": "many", "colour": 1}})
        check(good == [] and any("teeth" in e for e in bad)
              and any("colour" in e for e in bad),
              f"[actions] schema checks: valid {good}, invalid {bad}")
        mut = load_policy({
            "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
            "metadata": {"name": "sprocket-teeth"},
            "spec": {"rules": [{
                "name": "set-teeth",
                "match": {"resources": {"kinds": ["Sprocket"]}},
                "mutate": {"patchStrategicMerge": {"spec": {
                    "teeth": "many"}}}}]}})
        mut_errs = openapi.validate_policy_mutation(mut)
        check(mut_errs and "teeth" in mut_errs[0],
              f"[actions] mutate schema check {mut_errs}")
        openapi.unregister_schema("Sprocket")
        sync = crd_sync.CrdSync(DictClient([SPROCKET_CRD]))
        check(sync.sync_once() == 1 and openapi.has_schema("Sprocket"),
              "[actions] CrdSync did not register the CRD's kind")
    finally:
        openapi.unregister_schema("Sprocket")
    log(f"[actions] OpenAPI: schemas_from_crd -> register_schema -> "
        f"validate_resource: the valid document passes, the invalid one "
        f"gives {bad}; a mutate policy writing a string into an integer "
        f"field is refused ({mut_errs[0]}); CrdSync registers the kind")
    loaded = {m for m in ("yaml", "cryptography") if m in sys.modules}
    check(loaded <= loaded0, f"[actions] the phase imported {loaded - loaded0}")
    log(f"[actions] installed here: {have}; loaded by the phase: none")
    return out


# ------------------------------------------------------------- analysis
# the JAX package's certify gate (deploy/certify_smoke.py:158-170): run_fuzz
# at its defaults (batch 24, seed 20260805, pipeline and stream legs)
ANALYSIS_FUZZ_CASES = 1000
# the JAX package's analysis plane on the CPU over the same policies
# (tests/test_torch_analysis.py holds these to it): certify_policies'
# statuses and analyze_policies' codes, for the library and its
# autogen'd form; the refresh's statuses are the autogen'd form's
EXPECTED_CERTIFY = {
    "library 250": {"incomplete": 168, "certified": 80, "host": 2},
    "autogen'd 670": {"incomplete": 504, "certified": 160, "host": 6}}
EXPECTED_LINT = {
    "library 250": {"KT101": 2, "KT102": 2, "KT110": 250},
    "autogen'd 670": {"KT101": 6, "KT102": 2, "KT110": 250}}
# the JAX CLI's exit code and summary lines on the same files
# (write_cli_inputs; tests/test_torch_cli.py holds these to it)
ANALYSIS_PODS = 8
EXPECTED_CLI = {
    "lint --self": (0, ["lint: 8 policies, 0 errors, 2 warnings, 9 info"]),
    "lint --certify": (0, [
        "lint: 250 policies, 0 errors, 22 warnings, 420 info",
        "certify: certified=80, escalation_cells=80, host=2, "
        "incomplete=168, states_checked=1400"]),
    "apply": (1, ["pass: 1314, fail: 366, warn: 0, error: 0, skip: 0"])}


def write_cli_inputs(tmp: str) -> dict:
    """The library (one file a policy) and ANALYSIS_PODS Pods written
    under ``tmp``; the argv of each EXPECTED_CLI entry over them."""
    lib_dir = os.path.join(tmp, "library")
    os.mkdir(lib_dir)
    for i, d in enumerate(_synth_policy_docs(250)):     # JSON is YAML
        with open(os.path.join(lib_dir, f"p{i:03d}.yaml"), "w") as f:
            json.dump(d, f)
    pods_file = os.path.join(tmp, "pods.yaml")
    with open(pods_file, "w") as f:
        f.write("".join(f"---\n{json.dumps(make_pod(i))}\n"
                        for i in range(ANALYSIS_PODS)))
    return {"lint --self": ["lint", "--self"],
            "lint --certify": ["lint", "--certify", lib_dir],
            "apply": ["apply", lib_dir, "-r", pods_file]}


def run_cli(argv: list) -> tuple:
    """``python -m kyverno_tpu_torch.cli *argv`` from the repo's root:
    (exit code, stdout lines, seconds, stderr)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "kyverno_tpu_torch.cli",
                          *argv], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    return out.returncode, out.stdout.splitlines(), \
        time.perf_counter() - t0, out.stderr


def analysis_phase(cases: int = ANALYSIS_FUZZ_CASES) -> dict:
    """Phase 10b: the analysis plane on the card (module docstring).
    Returns the fuzz's launches and K6 dispatches."""
    import importlib.util
    import tempfile

    from kyverno_tpu_torch.analysis import analyze_policies, certify_policies
    from kyverno_tpu_torch.analysis.difffuzz import run_fuzz
    from kyverno_tpu_torch.api.load import load_policy
    from kyverno_tpu_torch.models import CompiledPolicySet, Verdict
    from kyverno_tpu_torch.models.engine import IncrementalCompiler
    from kyverno_tpu_torch.ops import _build
    from kyverno_tpu_torch.runtime import hostlane, policycache
    from kyverno_tpu_torch.runtime.policycache import PolicyCache

    phase0 = time.perf_counter()
    # the verdict memo is process-wide: the fuzz's sets start from none
    hostlane.host_cache().clear()
    _build.reset_launches()
    t0 = time.perf_counter()
    report = run_fuzz(cases=cases, device="cuda")
    fuzz_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    for d in report.diagnostics()[:8]:
        log(f"[analysis] {d.format()[:2000]}")
    check(report.ok(), f"[analysis] the fuzz found {len(report.divergences)} "
          "divergence(s)")
    check(report.cases >= cases and report.device_cells > 0
          and report.messages_checked > 0 and report.stream_rows > 0,
          f"[analysis] fuzz report {report}")
    for k in EVALUATE_KERNELS:
        check(launches[k] > 0, f"[analysis] {k} was not launched by the fuzz")
    check(report.stream_dispatches > 0, "[analysis] the stream leg's set "
          "dispatched nothing through K6")
    check(report.stream_timeouts == 0 and report.stream_circuit_open == 0
          and report.stream_refused == 0, f"[analysis] the stream leg's "
          f"screens: {report.stream_timeouts} gave up at their deadline, the "
          f"breaker opened {report.stream_circuit_open} times and turned "
          f"{report.stream_refused} rows away")
    log(f"[analysis] difffuzz on the card: {report.cases} cases, "
        f"{report.device_cells} device-decided cells, "
        f"{report.escalated_cells} escalated, {report.messages_checked} "
        f"messages checked, {report.stream_rows} stream rows, no divergence "
        f"in {fuzz_s:.3f} s; launches {launches}; the stream leg's K6 "
        f"dispatches {report.stream_dispatches}, no screen timeout, no "
        f"breaker opening, no row turned away")

    # certify and lint over the library and the set the server serves
    docs = _synth_policy_docs(250)
    steps = policy_steps()
    autogen, errors = autogen_policies(docs, steps)
    check(not errors, f"[analysis] policy webhook errors {errors[:3]}")
    for label, pols in (("library 250", [load_policy(d) for d in docs]),
                        ("autogen'd 670", autogen)):
        t0 = time.perf_counter()
        cert = certify_policies(pols)
        cert_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        lint = analyze_policies(pols)
        lint_s = time.perf_counter() - t0
        codes = {}
        for d in lint.diagnostics:
            codes[d.code] = codes.get(d.code, 0) + 1
        check(not cert.divergences, f"[analysis] {label}: KT401 "
              f"{[d.format() for d in cert.divergences[:3]]}")
        check(cert.counts() == EXPECTED_CERTIFY[label],
              f"[analysis] {label}: certify {cert.counts()}")
        check(codes == EXPECTED_LINT[label], f"[analysis] {label}: lint "
              f"{codes}")
        log(f"[analysis] {label}: certify_policies {cert.counts()} "
            f"({cert.states_checked} states, no KT401) in {cert_s:.3f} s; "
            f"analyze_policies {len(lint.diagnostics)} diagnostics {codes} "
            f"in {lint_s:.3f} s")

    # the CLI, as a user runs it; its file loaders need PyYAML
    if importlib.util.find_spec("yaml") is None:
        log("[analysis] CLI: not run, PyYAML is absent on this machine "
            "(the CLI's loaders read YAML)")
    else:
        pods = [make_pod(i) for i in range(ANALYSIS_PODS)]
        with tempfile.TemporaryDirectory() as tmp:
            for label, argv in write_cli_inputs(tmp).items():
                rc, lines, secs, err = run_cli(argv)
                want_rc, want_lines = EXPECTED_CLI[label]
                check(rc == want_rc and all(w in lines for w in want_lines),
                      f"[analysis] {label}: exit {rc}, {lines[-3:]} {err[-500:]}")
                log(f"[analysis] python -m kyverno_tpu_torch.cli {label}: "
                    f"exit {rc}, {len(lines)} lines, {want_lines} "
                    f"({secs:.3f} s)")
        # apply's failures are the card's FAIL cells on the same Pods
        lib = CompiledPolicySet([load_policy(d) for d in docs])
        m = np.asarray(lib.evaluate(pods))
        fails = int((m == Verdict.FAIL).sum())
        check(f"fail: {fails}," in EXPECTED_CLI["apply"][1][0],
              f"[analysis] evaluate() on the card has {fails} FAIL cells")
        log(f"[analysis] evaluate() of the library on the card over the "
            f"{ANALYSIS_PODS} Pods: {fails} FAIL cells, apply's failures")

    # KTPU_CERTIFY on the card: an incremental refresh over the 670 rules,
    # then one-policy refreshes with the certifier on and off, in turns
    ic = IncrementalCompiler(device="cuda")
    t0 = time.perf_counter()
    cps = ic.refresh(autogen)
    first_s = time.perf_counter() - t0
    cert = ic.last_refresh_certify
    check(cps.device.type == "cuda" and not cert.get("divergent")
          and cert == EXPECTED_CERTIFY["autogen'd 670"],
          f"[analysis] refresh on {cps.device}: certified {cert}")
    log(f"[analysis] IncrementalCompiler on {cps.device}: the 670 rules' "
        f"first refresh {first_s:.3f} s (plan {cps.plan_s:.3f} s), "
        f"last_refresh_certify {cert}")
    times = {"on": [], "off": []}
    pols = list(autogen)
    for i, mode in enumerate(("on", "off", "off", "on", "on", "off")):
        pols[i] = autogen_policies([docs[i]], steps)[0][0]
        if mode == "off":
            os.environ["KTPU_CERTIFY"] = "0"
        try:
            t0 = time.perf_counter()
            ic.refresh(pols)
            times[mode].append(time.perf_counter() - t0)
        finally:
            os.environ.pop("KTPU_CERTIFY", None)
        check(ic.last_refresh["recompiled"] == 1,
              f"[analysis] a one-policy refresh {ic.last_refresh}")
        if mode == "on":
            check(not ic.last_refresh_certify.get("divergent")
                  and not ic.last_refresh_certify.get("unchecked"),
                  f"[analysis] certified {ic.last_refresh_certify}")
    log(f"[analysis] one-policy refreshes of the 670 rules on the card, s: "
        f"certifier on {[round(x, 4) for x in times['on']]}, off "
        f"{[round(x, 4) for x in times['off']]}")

    # the policy cache's admission lint, on and off
    lint_s = {}
    for on in (True, False, False, True):
        saved = policycache.LINT_ON_ADMISSION
        policycache.LINT_ON_ADMISSION = on
        try:
            cache = PolicyCache()
            t0 = time.perf_counter()
            for p in autogen:
                cache.add(p)
            lint_s.setdefault(on, []).append(time.perf_counter() - t0)
        finally:
            policycache.LINT_ON_ADMISSION = saved
        check(len(cache.lint_reports) == (len(autogen) if on else 0),
              f"[analysis] {len(cache.lint_reports)} lint reports")
    log(f"[analysis] PolicyCache.add of the {len(autogen)} autogen'd "
        f"policies, s: admission lint on {[round(x, 3) for x in lint_s[True]]}"
        f", off {[round(x, 3) for x in lint_s[False]]}")
    log(f"[analysis] phase wall {time.perf_counter() - phase0:.3f} s; "
        f"{nvidia_smi_line()}")
    return {"launches": launches, "k6": report.stream_dispatches,
            "fuzz_s": fuzz_s}


# ---------------------------------------------------------------------
# The fleet plane and the workload plane: [fleet], [workload], [chaos]

# cut from 1,024 events, then from 512, for the script's time limit: its
# host-bound phases run 15-40% slower on some H100 hosts (a whole run of
# 1,280.6 s), and each leg's wall is its events over 13-75 events a
# second
FLEET_EVENTS = 256
FLEET_REPLICAS = 3
FLEET_PARTITIONS = 8
FLEET_SEED = 20261018
WORKLOAD_EVENTS = 256
# the dry-run's corpus, cut from 13,000 events and 10,000 live resources
# for the same limit: its replay took 72.3-97.6 s
CORPUS_EVENTS = 6_500
CORPUS_MIN = 5_000
CHAOS_EVENTS = 24


def enforce_docs(docs: list) -> list:
    """The library's policies in enforce mode, as the admission phases
    serve them."""
    return [dict(d, spec=dict(d["spec"], validationFailureAction="enforce"))
            for d in docs]


def fleet_body(namespace: str, name: str, variant: int) -> dict:
    """The workload trace's synthetic Pod (``workload.trace``'s default
    body) with memory requests on two templates in three: the library's
    require-requests rules pass on those, so the stream mixes allowed and
    denied admissions. With the default body every Pod is denied and an
    allowed-bit digest would say nothing."""
    tag = "latest" if variant % 4 == 3 else f"v{variant % 7}"
    container = {"name": "main",
                 "image": f"registry.local/app-{variant}:{tag}"}
    if variant % 3:
        container["resources"] = {"requests": {
            "memory": f"{64 * (1 + variant % 4)}Mi"}}
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": namespace,
                         "labels": {"app": f"app-{variant}",
                                    "team": namespace}},
            "spec": {"containers": [container]}}


def churn_docs(library_docs: list) -> list:
    """Four of the library's policies, the first of each Pod family that
    denies (disallow-latest-tag, require-requests, deny-latest-named) and
    one that passes (require-name): a trace's POLICY events land them
    again, which bumps every replica's policy generation and purges the
    fabric's tiers without moving a verdict."""
    out = []
    for family in ("disallow-latest-tag", "require-requests",
                   "deny-latest-named", "require-name"):
        out.append(next(d for d in library_docs
                        if d["metadata"]["name"].rsplit("-v", 1)[0]
                        == family))
    return out


def fleet_trace(library_docs: list, events: int = FLEET_EVENTS,
                seed: int = FLEET_SEED):
    """The [fleet] trace: 8 Zipf-skewed namespaces, 64 body templates,
    256 pod names, and four of the library's policies landing again every
    quarter of the events."""
    from kyverno_tpu_torch.workload.trace import synthesize

    return synthesize(events=events, namespaces=8, distinct_bodies=64,
                      name_pool=256, policy_churn_every=max(8, events // 4),
                      policy_docs=churn_docs(library_docs), seed=seed,
                      make_body=fleet_body)


_VIOLATION = re.compile(r"policy [\w.-]+/[\w.-]+")


def decision_map(result: dict) -> str:
    """A replay leg's decisions, event by event: the allowed bit and the
    sorted (policy/rule) pairs the denial names. The denial's prose is
    the lane's: a device row names each rule without the failing path,
    the oracle adds it (ROADMAP, deny text), so the map leaves it out."""
    return json.dumps({str(seq): [v["allowed"], sorted(set(
        _VIOLATION.findall(v.get("detail") or "")))]
        for seq, v in result["verdicts"].items()}, sort_keys=True)


class SetLog:
    """The compiled sets a policy cache hands out (its batcher's flushes
    run on them), for their K6 dispatch counts (``donation_stats``)."""

    def __init__(self, cache):
        self.sets = {}
        orig = cache.compiled

        def compiled(*a, **k):
            cps = orig(*a, **k)
            if cps is not None:
                self.sets[id(cps)] = cps
            return cps

        cache.compiled = compiled

    def dispatches(self) -> int:
        return sum(c.donation_stats["dispatches"]
                   for c in list(self.sets.values()))


def oracle_fleet(policies: list, device) -> dict:
    """A one-replica fleet whose stack has no batcher: its webhook answers
    every frame from the CPU oracle. ``replay.run_fleet`` drives it as it
    drives the replicas, policy churn included, so its digest is the
    reference every fleet leg is held to."""
    from kyverno_tpu_torch.fleet.fabric import FabricHub
    from kyverno_tpu_torch.fleet.router import Replica, ReplicaRouter
    from kyverno_tpu_torch.runtime.client import FakeCluster
    from kyverno_tpu_torch.runtime.policycache import PolicyCache
    from kyverno_tpu_torch.runtime.stream_server import StreamAdmissionPlane
    from kyverno_tpu_torch.runtime.webhook import WebhookServer

    cache = PolicyCache(device=device)
    for p in policies:
        cache.add(p)
    webhook = WebhookServer(policy_cache=cache, client=FakeCluster(),
                            device=device)
    plane = StreamAdmissionPlane(webhook, None, cache)
    return {"hub": FabricHub(), "server": None, "clients": [], "replicas": 1,
            "stacks": [{"policy_cache": cache, "webhook": webhook}],
            "router": ReplicaRouter([Replica(
                "oracle", lambda p: plane.handle_payload(p, "fleet"))])}


def host_cells_left(stack: dict) -> int:
    """HOST cells in the decisions a replica's batcher holds (its result
    cache): every one should have been resolved by the host lane."""
    from kyverno_tpu_torch.models import Verdict

    batcher = stack["batcher"]
    with batcher._lock:
        entries = list(batcher._result_cache.values())
    return sum(1 for e in entries for t in e[2] if t[2] == Verdict.HOST)


def fleet_leg(label: str, policies: list, trace, replicas: int,
              affinity: bool, device, ref: dict) -> dict:
    """One fleet run: ``replicas`` stacks on ``device`` sharing one hub,
    each warmed on every namespace of the trace, then the trace through
    ``run_fleet`` with the launch counters set to 0 just before. Held to
    the oracle fleet's decisions (``ref``); every replica's batcher makes
    K6 dispatches, K1 and eval_rules launch and no other kernel, no flush
    fails and no HOST cell is left."""
    from kyverno_tpu_torch.models import native_flatten
    from kyverno_tpu_torch.ops import _build
    from kyverno_tpu_torch.runtime.policycache import PolicyType
    from kyverno_tpu_torch.workload import replay

    enf = PolicyType.VALIDATE_ENFORCE
    t0 = time.perf_counter()
    fleet = replay.build_fleet_stacks(policies, replicas=replicas,
                                      device=device)
    logs = [SetLog(s["policy_cache"]) for s in fleet["stacks"]]
    try:
        first = {}
        for ev in trace.events:
            if ev.op != "POLICY":
                first.setdefault(ev.namespace, trace.body_of(ev))
        for stack in fleet["stacks"]:
            for ns, body in sorted(first.items()):
                stack["batcher"].warmup(enf, "Pod", ns, body)
        warm_s = time.perf_counter() - t0
        k6_0 = [log_.dispatches() for log_ in logs]
        native_flatten.reset_fallbacks()
        _build.reset_launches()
        out = replay.run_fleet(trace, fleet, workers=8, affinity=affinity)
        launches = dict(_build.LAUNCHES)
        out["k6"] = [log_.dispatches() - k for log_, k in zip(logs, k6_0)]
        out["topology"] = replay.current_topology(fleet)
        out["launches"] = launches
        out["flush_error"] = sum(s["batcher"].stats.get("flush_error", 0)
                                 for s in fleet["stacks"])
        out["host_left"] = sum(host_cells_left(s) for s in fleet["stacks"])
        out["fallbacks"] = dict(native_flatten.FALLBACKS)
        out["fabric_stats"] = [s["batcher"].stats.get("fabric", 0)
                               for s in fleet["stacks"]]
    finally:
        replay.stop_fleet_stacks(fleet)
    out["warm_s"] = warm_s
    n_ev = sum(1 for e in trace.events if e.op != "POLICY")
    check(not out["errors"] and out["processed"] == n_ev,
          f"[fleet] {label}: {out['processed']} of {n_ev} events, errors "
          f"{out['errors']}")
    check(decision_map(out) == ref["map"]
          and out["verdict_digest"] == ref["verdict_digest"],
          f"[fleet] {label}: decisions differ from the oracle's (digest "
          f"{out['verdict_digest']}, the oracle's {ref['verdict_digest']})")
    check(all(k >= 1 for k in out["k6"]),
          f"[fleet] {label}: K6 dispatches by replica {out['k6']}")
    check(all(launches[k] > 0 for k in EVALUATE_KERNELS)
          and all(v == 0 for k, v in launches.items()
                  if k not in EVALUATE_KERNELS),
          f"[fleet] {label}: launches {launches}")
    check(out["flush_error"] == 0 and out["host_left"] == 0,
          f"[fleet] {label}: {out['flush_error']} flushes failed, "
          f"{out['host_left']} HOST cells left in the decisions")
    check(all(v == 0 for v in out["fallbacks"].values()),
          f"[fleet] {label}: native flattener fallbacks {out['fallbacks']}")
    hub = out["hub"]
    log(f"[fleet] {label}: {replicas} replica(s), "
        f"{'digest' if affinity else 'sequence'} routing, fabric "
        f"{out['topology']['fabric']} over {out['topology']['transport']}: "
        f"{out['processed']} events, p50 {out['latency_ms_p50']:.3f} ms, p99 "
        f"{out['latency_ms_p99']:.3f} ms, {out['achieved_per_s']} events/s; "
        f"{out['denied']} denied; fabric hits {out['fabric_hits']} (hit rate "
        f"{out['fabric_hit_rate']}), batchers' fabric answers "
        f"{out['fabric_stats']}; hub entries {hub['entries']}, epoch "
        f"{hub['epoch']}, gets {hub['gets']}, puts {hub['puts']}, "
        f"invalidations {hub['invalidations']}; K6 dispatches by replica "
        f"{out['k6']}; launches {launches}; router {out['router']['routed']} "
        f"routed, {out['router']['failovers']} failovers; built and warmed "
        f"in {warm_s:.3f} s; digest {out['verdict_digest']} equal to the "
        f"oracle's")
    return out


def partition_scan(policies: list, resources: list, device) -> dict:
    """Three FleetScanCoordinators over a FakeCluster split
    KTPU_SCAN_PARTITIONS ranges of ``resources`` by named leases; the
    merged range digests equal an unpartitioned scan's. Then a member
    that owns ranges stops (no release): once its leases expire the
    survivors take its ranges over, the full set is covered again and the
    digests still agree."""
    from kyverno_tpu_torch.fleet import scanparts
    from kyverno_tpu_torch.ops import _build
    from kyverno_tpu_torch.runtime import leaderelection as le
    from kyverno_tpu_torch.runtime import metrics
    from kyverno_tpu_torch.runtime.background import BackgroundScanner
    from kyverno_tpu_torch.runtime.client import FakeCluster

    n_parts = scanparts.scan_partition_count()
    check(n_parts == FLEET_PARTITIONS, f"[fleet] KTPU_SCAN_PARTITIONS read "
          f"as {n_parts}")
    _build.reset_launches()
    t0 = time.perf_counter()
    baseline = BackgroundScanner(policies, device=device)
    baseline.scan(resources)
    base_s = time.perf_counter() - t0
    base = scanparts.merge_range_digests(
        scanparts.matrix_range_digests(baseline, n_parts))
    launches = dict(_build.LAUNCHES)
    saved = (le.LEASE_DURATION_S, le.RENEW_DEADLINE_S)
    lease_s = le.LEASE_DURATION_S = 0.25
    le.RENEW_DEADLINE_S = 0.2
    coords = {}
    try:
        cluster = FakeCluster()
        coords = {name: scanparts.FleetScanCoordinator(cluster,
                                                       identity=name)
                  for name in ("r0", "r1", "r2")}
        scanners = {name: BackgroundScanner(policies, device=device)
                    for name in coords}
        for _ in range(3):      # the leader elects, publishes; members enroll
            for c in coords.values():
                c.tick()
        owned = {n: set(c.owned_partitions()) for n, c in coords.items()}
        check(set().union(*owned.values()) == set(range(n_parts))
              and sum(len(o) for o in owned.values()) == n_parts,
              f"[fleet] partitions owned {owned}")
        t0 = time.perf_counter()
        digests = [scanparts.scan_partitions(
            scanners[n], resources, c.owned_partitions(), n_parts)[1]
            for n, c in coords.items()]
        parts_s = time.perf_counter() - t0
        merged = scanparts.merge_range_digests(*digests)
        check(merged == base, f"[fleet] partitioned digest {merged}, "
              f"unpartitioned {base}")
        reg = metrics.registry()
        rows = {p: reg.gauge_value("kyverno_scan_partition_rows",
                                   {"range": str(p)}) for p in range(n_parts)}
        check(sum(v or 0 for v in rows.values()) == len(resources),
              f"[fleet] per-range row gauges {rows}")
        # a member that owns ranges and does not lead stops ticking right
        # after a round that renewed its leases: they must expire before
        # anyone takes over
        victim = next((n for n, c in coords.items()
                       if owned[n] and not c.elector.is_leader()),
                      next(n for n in coords if owned[n]))
        for c in coords.values():
            c.tick()
        dead = coords.pop(victim)
        t_kill = time.perf_counter()
        covered = False
        while time.perf_counter() - t_kill < 10.0 and not covered:
            time.sleep(0.05)
            for c in coords.values():
                c.tick()
            owned2 = {n: set(c.owned_partitions())
                      for n, c in coords.items()}
            covered = (set().union(*owned2.values()) == set(range(n_parts))
                       and sum(len(o) for o in owned2.values()) == n_parts)
        takeover_s = time.perf_counter() - t_kill
        check(covered, f"[fleet] after {victim} stopped the survivors own "
              f"{owned2}")
        digests2 = [scanparts.scan_partitions(
            scanners[n], resources, c.owned_partitions(), n_parts)[1]
            for n, c in coords.items()]
        merged2 = scanparts.merge_range_digests(*digests2)
        check(merged2 == base, f"[fleet] after the takeover the digest is "
              f"{merged2}, unpartitioned {base}")
        dead.stop()
    finally:
        for c in coords.values():
            c.stop()
        le.LEASE_DURATION_S, le.RENEW_DEADLINE_S = saved
    log(f"[fleet] partitioned scan over {len(resources)} mixed resources, "
        f"{n_parts} ranges, three coordinators: owned "
        f"{ {n: sorted(o) for n, o in owned.items()} }, rows by range "
        f"{ {p: int(v or 0) for p, v in rows.items()} }; merged digest "
        f"{merged} equal to the unpartitioned scan's ({base_s:.3f} s; the "
        f"three partitions {parts_s:.3f} s; its launches {launches}); "
        f"{victim} stopped, its ranges {sorted(owned[victim])} taken over in "
        f"{takeover_s:.3f} s (leases of {lease_s} s), owned "
        f"{ {n: sorted(o) for n, o in owned2.items()} }, digest {merged2} "
        f"equal")
    return {"takeover_s": takeover_s, "base_s": base_s, "parts_s": parts_s,
            "launches": launches}


def fleet_phase(library_docs: list, events: int = FLEET_EVENTS,
                scan_rows: int = BACKGROUND_LANE_ROWS,
                device: str = "cuda") -> dict:
    """[fleet]: the library (enforce) behind FLEET_REPLICAS replicas of
    ``workload.replay.build_fleet_stacks`` sharing one fabric hub, the
    legs of the fleet plane's contract (kill switch, fabric parity and
    sharing, churn invalidation, the socket transport, topology-aware
    manifests), each held to an oracle stack's decisions, then the
    partitioned scan and its takeover."""
    from kyverno_tpu_torch.api.load import load_policy
    from kyverno_tpu_torch.runtime import hostlane
    from kyverno_tpu_torch.runtime import metrics
    from kyverno_tpu_torch.runtime.obs_http import handle_obs_get
    from kyverno_tpu_torch.workload import replay
    from kyverno_tpu_torch.workload.chaos import env_overrides

    docs = enforce_docs(library_docs)
    policies = [load_policy(d) for d in docs]
    trace = fleet_trace(docs, events=events)
    st = trace.stats()
    log(f"[fleet] trace: {st['events']} events ({st['by_op']}), "
        f"{st['distinct_bodies']} distinct bodies, {st['namespaces']} "
        f"namespaces; {len(policies)} policies (enforce), churn "
        f"{[d['metadata']['name'] for d in churn_docs(docs)]}")
    out = {}
    reg = metrics.registry()
    with env_overrides({"KTPU_REPLAY": "1", "KTPU_FABRIC": "0",
                        "KTPU_FABRIC_TRANSPORT": "inproc",
                        "KTPU_SCAN_PARTITIONS": "0"}):
        # the reference: one stack with no batcher, the oracle answers
        t0 = time.perf_counter()
        ofleet = oracle_fleet(policies, device)
        try:
            ref = replay.run_fleet(trace, ofleet, workers=8)
        finally:
            ofleet["stacks"][0]["webhook"].stop()
            hostlane.resolver().attach_pool(None, None)
        ref["map"] = decision_map(ref)
        allowed = sum(1 for v in ref["verdicts"].values() if v["allowed"])
        check(ref["denied"] > 0 and allowed > 0 and not ref["errors"],
              f"[fleet] the oracle's stream: {ref['denied']} denied, "
              f"{allowed} allowed, errors {ref['errors']}")
        log(f"[fleet] oracle stack (no batcher): {ref['processed']} events, "
            f"{ref['denied']} denied, {allowed} allowed, p50 "
            f"{ref['latency_ms_p50']:.3f} ms, p99 {ref['latency_ms_p99']:.3f} "
            f"ms, {ref['achieved_per_s']} events/s "
            f"({time.perf_counter() - t0:.3f} s); digest "
            f"{ref['verdict_digest']}")
        out["oracle"] = ref
        # 1. kill switch: one replica and three, the hub left alone
        with env_overrides({"KTPU_FABRIC": "0"}):
            off1 = fleet_leg("kill switch", policies, trace, 1, True,
                             device, ref)
            off3 = fleet_leg("kill switch", policies, trace, FLEET_REPLICAS,
                             True, device, ref)
        for o, n in ((off1, 1), (off3, FLEET_REPLICAS)):
            check(o["hub"]["puts"] == 0 and o["hub"]["hits"] == 0
                  and o["hub"]["gets"] == n and o["fabric_hits"] == 0,
                  f"[fleet] kill switch: the hub saw {o['hub']}")
        # 2. the fabric on, repeats spread over the replicas
        with env_overrides({"KTPU_FABRIC": "1"}):
            on3 = fleet_leg("fabric, no affinity", policies, trace,
                            FLEET_REPLICAS, False, device, ref)
            check(on3["fabric_hits"] > 0 and on3["hub"]["puts"] > 0,
                  f"[fleet] fabric on: hits {on3['fabric_hits']}, hub "
                  f"{on3['hub']}")
            check((reg.counter_total("kyverno_fabric_frames_total") or 0) > 0
                  and (reg.counter_total("kyverno_fabric_hits_total")
                       or 0) > 0, "[fleet] kyverno_fabric_* counters")
            health = json.loads(handle_obs_get("/healthz")[1])
            check(health.get("fleet", {}).get("enabled") is True,
                  f"[fleet] /healthz fleet block {health.get('fleet')}")
            # 3. the churn purges the hub fleet-wide; one and three agree
            ch1 = fleet_leg("churn", policies, trace, 1, True, device, ref)
            ch3 = fleet_leg("churn", policies, trace, FLEET_REPLICAS, True,
                            device, ref)
            for o in (ch1, ch3, on3):
                check(o["hub"]["invalidations"] > 0 and o["hub"]["epoch"] > 0
                      and o["hub"]["purged"] > 0,
                      f"[fleet] churn: the hub {o['hub']}")
            check(ch1["verdict_digest"] == ch3["verdict_digest"],
                  "[fleet] churn: one and three replicas differ")
            # 4. the hub behind a framed loopback socket
            with env_overrides({"KTPU_FABRIC_TRANSPORT": "socket"}):
                sock3 = fleet_leg("socket transport", policies, trace,
                                  FLEET_REPLICAS, False, device, ref)
            check(decision_map(sock3) == decision_map(on3)
                  and sock3["hub"]["frames"] > FLEET_REPLICAS
                  and sock3["fabric_hits"] > 0,
                  f"[fleet] socket: frames {sock3['hub']['frames']}, hits "
                  f"{sock3['fabric_hits']}")
        # 5. manifests of different topologies diff as incomparable
        m1 = replay.run_manifest(trace, [off1], topology=off1["topology"])
        m3 = replay.run_manifest(trace, [on3], topology=on3["topology"])
        diff = replay.diff_manifests(m1, m3)
        leg = diff["legs"]["fleet_stream"]
        check(leg.get("verdict_parity") is True
              and leg.get("skipped") == "topology mismatch"
              and diff["topology"]["comparable"] is False,
              f"[fleet] manifest diff {leg}, {diff['topology']}")
        log(f"[fleet] manifests of one replica (fabric off) and three "
            f"(fabric on): verdict parity {leg['verdict_parity']}, numeric "
            f"deltas {leg['skipped']}, comparable "
            f"{diff['topology']['comparable']}")
        # 6. the partitioned scan and its takeover
        with env_overrides({"KTPU_SCAN_PARTITIONS": str(FLEET_PARTITIONS)}):
            out["scan"] = partition_scan(
                policies, [mixed_resource(i) for i in range(scan_rows)],
                device)
    hostlane.host_cache().attach_fabric(None)
    launches = {k: sum(o["launches"][k] for o in (off1, off3, on3, ch1, ch3,
                                                   sock3))
                for k in off1["launches"]}
    out.update(legs={"kill switch 1": off1, "kill switch 3": off3,
                     "fabric 3": on3, "churn 1": ch1, "churn 3": ch3,
                     "socket 3": sock3}, launches=launches)
    for o in out["legs"].values():
        o.pop("verdicts", None)
    return out


def planted_failures(resources) -> list:
    """The resources FREEZE_APP_3 fails, found without the engine: a Pod
    with a container image of the app-3 template."""
    return sorted(
        "/".join((r.get("kind", ""), (r.get("metadata") or {}).get(
            "namespace", ""), (r.get("metadata") or {}).get("name", "")))
        for r in resources
        if any(str(c.get("image", "")).startswith("registry.local/app-3:")
               for c in (r.get("spec") or {}).get("containers") or ()))


# a known-tightening candidate: its glob keeps K1 in the dry-run's path
FREEZE_APP_3 = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "freeze-app-3"},
    "spec": {"validationFailureAction": "enforce", "background": True,
             "rules": [{
                 "name": "freeze-app-3-r0",
                 "match": {"resources": {"kinds": ["Pod"]}},
                 "validate": {"message": "app-3 template frozen",
                              "pattern": {"spec": {"containers": [
                                  {"image": "!registry.local/app-3:*"}]}}}}]}}


def workload_phase(library_docs: list, events: int = WORKLOAD_EVENTS,
                   corpus_events: int = CORPUS_EVENTS,
                   corpus_min: int = CORPUS_MIN,
                   device: str = "cuda") -> dict:
    """[workload]: one stack of the library (enforce) replays a churn
    trace through its webhook, stream_json, stream_row and background
    legs, held to each other and to an oracle webhook; a corpus of at
    least ``corpus_min`` resources replayed through the background leg;
    a known-tightening candidate dry-run on the card against it, its
    blast radius equal to a plant computed without the engine and the
    live state unmoved; KTPU_DRYRUN=0 refused over HTTP and in process
    with a live answer unchanged; the CLI's ``dryrun`` on a trace file
    and against the phase's server."""
    import importlib.util
    import tempfile
    import urllib.error
    import urllib.request

    from kyverno_tpu_torch.api.load import load_policy
    from kyverno_tpu_torch.models import native_flatten
    from kyverno_tpu_torch.ops import _build
    from kyverno_tpu_torch.runtime import hostlane
    from kyverno_tpu_torch.runtime.client import FakeCluster
    from kyverno_tpu_torch.runtime.policycache import PolicyCache, PolicyType
    from kyverno_tpu_torch.runtime.webhook import (VALIDATING_WEBHOOK_PATH,
                                                   WebhookServer)
    from kyverno_tpu_torch.workload import replay
    from kyverno_tpu_torch.workload.chaos import env_overrides
    from kyverno_tpu_torch.workload.dryrun import (DryRunDisabled, dry_run,
                                                   set_scan_source)
    from kyverno_tpu_torch.workload.trace import synthesize

    docs = enforce_docs(library_docs)
    policies = [load_policy(d) for d in docs]
    out = {}
    tr = synthesize(events=events, namespaces=8, name_pool=64,
                    distinct_bodies=32, policy_docs=churn_docs(docs),
                    policy_churn_every=max(8, events // 4), seed=11,
                    make_body=fleet_body)
    with env_overrides({"KTPU_REPLAY": "1", "KTPU_DRYRUN": "1",
                        "KTPU_FABRIC": "0"}):
        # ---- cross-leg parity, and the webhook leg against the oracle
        ocache = PolicyCache(device=device)
        for p in policies:
            ocache.add(p)
        owebhook = WebhookServer(policy_cache=ocache, client=FakeCluster(),
                                 device=device)
        try:
            ref = replay.ReplayDriver(webhook=owebhook).run(tr, "webhook",
                                                            workers=8)
        finally:
            owebhook.stop()
            hostlane.resolver().attach_pool(None, None)
        stack = replay.build_stack(policies, device=device)
        drv = replay.ReplayDriver.from_stack(stack)
        bstack = None
        try:
            native_flatten.reset_fallbacks()
            legs, leg_launches = {}, {}
            for leg in ("webhook", "stream_json", "stream_row"):
                _build.reset_launches()
                legs[leg] = drv.run(tr, leg, workers=8)
                leg_launches[leg] = dict(_build.LAUNCHES)
            _build.reset_launches()
            bg = drv.run(tr, "background")
            leg_launches["background"] = dict(_build.LAUNCHES)
            # a ROW frame is pre-tokenized: the server has no body for the
            # oracle, so a row with a HOST cell escalates (both packages).
            # The library's host-only policies put HOST cells in every Pod
            # row: over the library the ROW leg escalates every event, and
            # over its device-decidable policies it answers as the webhook
            cps = stack["policy_cache"].compiled(
                PolicyType.VALIDATE_ENFORCE, "Pod", tr.events[0].namespace)
            host_only = sorted({r.policy.name for r in cps.rule_refs
                                if cps.tensors.rule_host_only[r.rule_index]})
            row = legs.pop("stream_row")
            check(bool(host_only) == (row["denied"] == row["events"]),
                  f"[workload] stream_row over the library: {row['denied']} "
                  f"of {row['events']} not allowed, host-only policies "
                  f"{host_only}")
            dstack = replay.build_stack([p for p in policies
                                         if p.name not in host_only],
                                        device=device)
            try:
                ddrv = replay.ReplayDriver.from_stack(dstack)
                dweb = ddrv.run(tr, "webhook", workers=8)
                _build.reset_launches()
                drow = ddrv.run(tr, "stream_row", workers=8)
                leg_launches["stream_row device-decidable"] = dict(
                    _build.LAUNCHES)
            finally:
                replay.stop_stack(dstack)
            check(drow["verdict_digest"] == dweb["verdict_digest"]
                  and 0 < drow["denied"] < drow["events"],
                  f"[workload] stream_row over the {len(policies) - len(host_only)} "
                  f"device-decidable policies: digest {drow['verdict_digest']}, "
                  f"the webhook's {dweb['verdict_digest']}")
            digests = {leg: r["verdict_digest"] for leg, r in legs.items()}
            check(len(set(digests.values())) == 1
                  and digests["webhook"] == ref["verdict_digest"],
                  f"[workload] digests {digests}, the oracle's "
                  f"{ref['verdict_digest']}")
            legs["stream_row"] = row
            legs["stream_row device-decidable"] = drow
            web = legs["webhook"]
            check(web["denied"] > 0 and web["denied"] < web["events"],
                  f"[workload] {web['denied']} of {web['events']} denied")
            check(all(not r["errors"] and r["processed"] == r["events"]
                      for r in legs.values()),
                  f"[workload] errors "
                  f"{ {k: r['errors'] for k, r in legs.items()} }")
            check(bg["failing_resources"] == web["failing_resources"]
                  == ref["failing_resources"] and bg["violations"] > 0,
                  f"[workload] the background leg flags "
                  f"{len(bg['failing_resources'])} resources, the stream "
                  f"denied {len(web['failing_resources'])}")
            for leg, la in leg_launches.items():
                check(all(la[k] > 0 for k in EVALUATE_KERNELS),
                      f"[workload] {leg} launches {la}")
            check(all(v == 0 for v in native_flatten.FALLBACKS.values()),
                  f"[workload] flattener fallbacks {native_flatten.FALLBACKS}")
            log(f"[workload] stream_row over the library: all {row['events']} "
                f"rows escalated (host-only policies {host_only}); over the "
                f"{len(policies) - len(host_only)} device-decidable policies "
                f"its digest {drow['verdict_digest']} is that stack's "
                f"webhook leg's")
            for leg, r in legs.items():
                log(f"[workload] {leg} leg: {r['processed']} events, p50 "
                    f"{r['latency_ms_p50']:.3f} ms, p99 "
                    f"{r['latency_ms_p99']:.3f} ms, {r['achieved_per_s']} "
                    f"events/s, queue depth max {r['queue_depth_max']}, "
                    f"{r['denied']} denied, {r['timeout_retries']} retries "
                    f"after a screen timeout; launches {leg_launches[leg]}; "
                    f"digest {r['verdict_digest']}")
            log(f"[workload] background leg: {bg['processed']} watch events, "
                f"{bg['delta_scans']} delta scans, {bg['rows_evaluated']} rows "
                f"and {bg['cols_evaluated']} columns evaluated, "
                f"{bg['violations']} violations, {bg['achieved_per_s']} "
                f"events/s ({bg['duration_s']} s); launches "
                f"{leg_launches['background']}; it flags the "
                f"{len(bg['failing_resources'])} resources the stream denied, "
                f"and the oracle webhook's digest {ref['verdict_digest']} is "
                f"every admission leg's")
            out["legs"] = {k: {kk: vv for kk, vv in r.items()
                               if kk != "verdicts"} for k, r in legs.items()}
            out["background"] = bg
            out["leg_launches"] = leg_launches
            # the live answer the kill switch must leave alone: an allowed
            # one, whose text no lane writes differently
            seq = min(s_ for s_, v in ref["verdicts"].items()
                      if v["allowed"])
            review = replay.admission_review(
                tr.events[seq], tr.body_of(tr.events[seq]), seq)

            # ---- the corpus: a long trace through the background leg
            big = synthesize(events=corpus_events, namespaces=6,
                             distinct_bodies=48, update_fraction=0.12,
                             delete_fraction=0.02, seed=3)
            bstack = replay.build_stack(policies, device=device)
            t0 = time.perf_counter()
            replay.ReplayDriver.from_stack(bstack).run(big, "background")
            corpus_s = time.perf_counter() - t0
            scanner, batcher = bstack["scanner"], bstack["batcher"]
            keys = list(scanner._state["keys"])
            corpus = len(keys)
            check(corpus >= corpus_min, f"[workload] corpus of {corpus} rows")
            planted = planted_failures(scanner._state["resources"][k]
                                       for k in keys)
            fp_scan = scanner.state_fingerprint()
            fp_cache = batcher.cache_fingerprint()
            keys_b, cols_b, mat_b = scanner.verdict_matrix()
            _build.reset_launches()
            t0 = time.perf_counter()
            report = dry_run(FREEZE_APP_3, scanner=scanner)
            dry_s = time.perf_counter() - t0
            dry_launches = dict(_build.LAUNCHES)
            check(sorted(report["newly_failing_resources"]) == planted
                  and report["newly_failing"] == len(planted) > 0
                  and report["resources_evaluated"] == corpus
                  and report["compile_lane"] == "incremental_isolated",
                  f"[workload] dry-run: {report['newly_failing']} newly "
                  f"failing of {report['resources_evaluated']}, planted "
                  f"{len(planted)}")
            check(all(dry_launches[k] > 0 for k in EVALUATE_KERNELS),
                  f"[workload] the dry-run's launches {dry_launches}")
            keys_a, cols_a, mat_a = scanner.verdict_matrix()
            check(scanner.state_fingerprint() == fp_scan
                  and batcher.cache_fingerprint() == fp_cache
                  and keys_a == keys_b and cols_a == cols_b
                  and mat_a.tobytes() == mat_b.tobytes(),
                  "[workload] the dry-run moved the live state")
            log(f"[workload] corpus: {corpus_events} events through the "
                f"background leg in {corpus_s:.3f} s, {corpus} live "
                f"resources; dry-run of {FREEZE_APP_3['metadata']['name']} "
                f"on {scanner.device}: {report['newly_failing']} newly "
                f"failing, equal to the plant, over "
                f"{report['resources_evaluated']} resources in {dry_s:.3f} s "
                f"(the report says {report['duration_s']} s), lane "
                f"{report['compile_lane']}, launches {dry_launches}; the "
                f"scanner's fingerprint, the matrix bytes and the batcher's "
                f"result-cache fingerprint unmoved")
            out.update(corpus=corpus, corpus_s=corpus_s, dry_s=dry_s,
                       dry_launches=dry_launches,
                       newly_failing=report["newly_failing"])

            # ---- the CLI: offline on a trace file, then --url
            obs = scanner.serve_observability(port=0)
            url = f"http://127.0.0.1:{obs.server_port}"
            if importlib.util.find_spec("yaml") is None:
                log("[workload] CLI: not run, PyYAML is absent on this "
                    "machine (the CLI's loaders read YAML)")
            else:
                with tempfile.TemporaryDirectory() as tmp:
                    cand = os.path.join(tmp, "candidate.yaml")
                    with open(cand, "w") as f:
                        json.dump(FREEZE_APP_3, f)       # JSON is YAML
                    trace_file = os.path.join(tmp, "trace.jsonl")
                    big.write_jsonl(trace_file)
                    for label, argv in (
                            ("--trace", ["dryrun", cand, "--trace",
                                         trace_file, "--json", "--device",
                                         device]),
                            ("--url", ["dryrun", cand, "--url", url,
                                       "--json"])):
                        rc, lines, secs, err = run_cli(argv)
                        got = json.loads("\n".join(lines)) if rc == 1 \
                            else {}
                        check(rc == 1 and sorted(got.get(
                            "newly_failing_resources", ())) == planted,
                              f"[workload] dryrun {label}: exit {rc}, "
                              f"{err[-500:]}")
                        log(f"[workload] python -m kyverno_tpu_torch.cli "
                            f"dryrun {label}: exit {rc}, "
                            f"{got['newly_failing']} newly failing over "
                            f"{got['resources_evaluated']} resources, lane "
                            f"{got['compile_lane']} ({secs:.3f} s)")

            # ---- KTPU_DRYRUN=0: refused, a live answer unchanged
            before = json.dumps(stack["webhook"].handle(
                VALIDATING_WEBHOOK_PATH, review), sort_keys=True)
            with env_overrides({"KTPU_DRYRUN": "0"}):
                try:
                    dry_run(FREEZE_APP_3, scanner=scanner)
                    refused = False
                except DryRunDisabled:
                    refused = True
                req = urllib.request.Request(
                    url + "/debug/dryrun", method="POST",
                    data=json.dumps({"policy": FREEZE_APP_3}).encode(),
                    headers={"Content-Type": "application/json"})
                try:
                    with urllib.request.urlopen(req, timeout=60) as resp:
                        status = resp.status
                except urllib.error.HTTPError as e:
                    status = e.code
            after = json.dumps(stack["webhook"].handle(
                VALIDATING_WEBHOOK_PATH, review), sort_keys=True)
            check(refused and status == 403 and before == after
                  and scanner.state_fingerprint() == fp_scan,
                  f"[workload] KTPU_DRYRUN=0: refused in process {refused}, "
                  f"HTTP {status}, live answer unchanged {before == after}")
            log(f"[workload] KTPU_DRYRUN=0: DryRunDisabled in process, HTTP "
                f"{status} on /debug/dryrun, the live admission answer byte "
                f"for byte the same across the refused attempt")
        finally:
            set_scan_source(None)
            if bstack is not None:
                bstack["scanner"].stop_observability()
                replay.stop_stack(bstack)
            replay.stop_stack(stack)
    return out


def chaos_phase(events: int = CHAOS_EVENTS, device: str = "cuda") -> dict:
    """[chaos]: ``run_scenario("oracle_brownout")`` with the SLO actions
    on and then off, on stacks on the card, held to every check of the
    JAX package's chaos gate."""
    from kyverno_tpu_torch.ops import _build
    from kyverno_tpu_torch.workload.chaos import run_scenario

    out = {}
    _build.reset_launches()
    t0 = time.perf_counter()
    rep = run_scenario("oracle_brownout", events=events, delay_s=0.35,
                       workers=6, actions="1", device=device)
    rep_s = time.perf_counter() - t0
    failures = [f"check {k}" for k, ok in rep["checks"].items() if not ok]
    if not rep["action_log"]:
        failures.append("no actions logged")
    failures += [f"malformed log {e}" for e in rep["action_log"]
                 if "t" not in e or e["event"] not in ("enter", "exit")]
    if not (rep["manifest"].get("slo") or {}).get("action_log"):
        failures.append("the manifest has no action log")
    t0 = time.perf_counter()
    par = run_scenario("oracle_brownout", events=events, delay_s=0.35,
                       workers=6, actions="0", device=device)
    par_s = time.perf_counter() - t0
    failures += [f"kill switch: check {k}" for k in (
        "no_actions_engaged", "episode_digest_matches",
        "recovery_digest_matches", "degraded_seen")
        if not par["checks"].get(k)]
    launches = dict(_build.LAUNCHES)
    degraded = [t for t in rep["transitions"] if t["state"] == "degraded"]
    recovery_s = [round(t["exit_t"] - t["enter_t"], 3) for t in degraded
                  if "exit_t" in t]
    check(not failures, f"[chaos] {failures}; brownout {rep['checks']}, "
          f"p99 episode {rep['episode_p99_ms']} ms (budget "
          f"{rep['p99_budget_ms']} ms), baseline {rep['baseline_p99_ms']} "
          f"ms, recovery {rep['recovery_p99_ms']} ms; kill switch "
          f"{par['checks']}")
    check(all(launches[k] > 0 for k in EVALUATE_KERNELS),
          f"[chaos] launches {launches}")
    log(f"[chaos] oracle_brownout, {events} events, actions on: every check "
        f"{sorted(rep['checks'])} held ({rep_s:.3f} s); p99 baseline "
        f"{rep['baseline_p99_ms']} ms, episode {rep['episode_p99_ms']} ms "
        f"(budget {rep['p99_budget_ms']} ms), recovery "
        f"{rep['recovery_p99_ms']} ms; actions "
        f"{sorted({e['action'] for e in rep['action_log']})}, shed "
        f"{rep['shed']}; degraded for {recovery_s} s before it recovered")
    log(f"[chaos] oracle_brownout, KTPU_SLO_ACTIONS=0: every check "
        f"{sorted(par['checks'])} held ({par_s:.3f} s); p99 baseline "
        f"{par['baseline_p99_ms']} ms, episode {par['episode_p99_ms']} ms; "
        f"launches over both {launches}")
    out.update(launches=launches, recovery_s=recovery_s,
               episode_p99_ms=rep["episode_p99_ms"],
               baseline_p99_ms=rep["baseline_p99_ms"])
    return out


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and hold the kernels to their plain versions "
                         "on small inputs, run evaluate() at 1,000, then stop")
    ap.add_argument("--admission", type=int, default=0, metavar="N",
                    help="build, then only the [admission] phase, N times "
                         "over in one process; report how many runs failed")
    ap.add_argument("--cold-flush", choices=("on", "off"), default=None,
                    help="with --admission: clear the batcher's seen shape "
                         "buckets before each timed burst, with the cold "
                         "release (cold_flush_fallback) on or off")
    ap.add_argument("--heap", choices=("keep", "freeze"), default=None,
                    help="with --admission: first fill the heap to the size "
                         "a full run has at [admission], then keep it in "
                         "the garbage collector's view or freeze it out")
    ap.add_argument("--webhook", action="store_true",
                    help="build, then only the [webhook] phase")
    ap.add_argument("--controller", action="store_true",
                    help="build, then only the [controller] phase")
    ap.add_argument("--pool-workers", type=int, default=None, metavar="N",
                    help="with --admission: size the oracle pool at N "
                         "workers (default: the pool's own, cores - 1)")
    ap.add_argument("--analysis", action="store_true",
                    help="build, then only the [analysis] phase")
    ap.add_argument("--fleet", action="store_true",
                    help="build, then only the [fleet] phase")
    ap.add_argument("--workload", action="store_true",
                    help="build, then only the [workload] phase")
    ap.add_argument("--chaos", action="store_true",
                    help="build, then only the [chaos] phase")
    ap.add_argument("--all-cards", action="store_true",
                    help="build, then only the mesh scan over every card of "
                         "the host against the one-card scan (needs 2 or more)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from kyverno_tpu_torch.api.load import load_policy
    from kyverno_tpu_torch.models import CompiledPolicySet
    from kyverno_tpu_torch.models import native_flatten
    from kyverno_tpu_torch.models.compiler import _compile_glob
    from kyverno_tpu_torch.ops import _build
    from kyverno_tpu_torch.ops import eval as ev
    from kyverno_tpu_torch.ops import glob
    from kyverno_tpu_torch.ops.plan import TT_GATE0, TT_NPATH, TT_SLOT0, Plan

    check(not any(m == "jax" or m.startswith("jax.") or m == "kyverno_tpu"
                  or m.startswith("kyverno_tpu.") for m in sys.modules),
          "the port loaded JAX or the JAX package")
    dev_name = torch.cuda.get_device_name(0)
    log(f"device: {dev_name}; torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 1. build: nvcc for the kernels and g++ for the native
    # flattener, at the same time
    native_err = []

    def build_native():
        try:
            native_flatten._load_lib()
        except Exception as e:          # raised below, on this thread
            native_err.append(e)

    t0 = time.perf_counter()
    builder = threading.Thread(target=build_native)
    builder.start()
    build_s = _build.build_all()
    builder.join()
    if native_err:
        raise native_err[0]
    built = native_flatten.BUILT
    log(f"[build] {len(_build.LIBRARIES)} libraries ({len(_build.KERNELS)} of "
        f"kernels, and the dispatch's) built in {build_s:.2f} s; the "
        f"native flattener from {native_flatten.CPP.relative_to(ROOT)} in "
        f"{built['seconds']:.2f} s ({'with' if built['dict_walk'] else 'without'} "
        f"its dict-walk entry): {os.path.relpath(built['path'], ROOT)}; both "
        f"in {time.perf_counter() - t0:.2f} s")
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    if args.admission:
        global COLD_FLUSH, POOL_WORKERS
        if args.cold_flush is not None:
            COLD_FLUSH = args.cold_flush == "on"
        POOL_WORKERS = args.pool_workers
        library_docs = _synth_policy_docs(250)
        ballast = fill_heap(FULL_RUN_HEAP) if args.heap else []
        gc.collect()
        tracked = len(gc.get_objects())
        if args.heap == "freeze":
            gc.freeze()
        log(f"[admission] heap: {tracked} tracked objects "
            f"({len(ballast)} mixed resources added), "
            + ("frozen out of the collector" if args.heap == "freeze"
               else "in the collector's view"))
        failed = []
        for i in range(args.admission):
            t0 = time.perf_counter()
            try:
                admission_phase(library_docs, run=f"a{i}")
            except AssertionError as e:
                failed.append(i + 1)
                log(f"[admission] run {i + 1} failed: {e}; the last timed "
                    f"burst's split "
                    f"{BURST_STATS[-1]['split'] if BURST_STATS else None}")
            log(f"[admission] run {i + 1} of {args.admission}: "
                f"{time.perf_counter() - t0:.3f} s")
        total = {k: sum(b.get(k, 0) for b in BURST_STATS) for k in (
            "circuit_open", "screen_timeout", "cold_release",
            "flush_fallback", "flush_error")}
        log(f"[admission] cold flush forced: {args.cold_flush or 'no'}; over "
            f"{len(BURST_STATS)} timed bursts: {total}; bursts with a breaker "
            f"opening {sum(1 for b in BURST_STATS if b.get('circuit_open'))}, "
            f"with a screen timeout "
            f"{sum(1 for b in BURST_STATS if b.get('screen_timeout'))}, with "
            f"a cold release "
            f"{sum(1 for b in BURST_STATS if b.get('cold_release'))}; "
            f"heap {args.heap or 'as it is'}: generation-2 pauses in the "
            f"bursts {sum(b['gc2_ms'] for b in BURST_STATS):.1f} ms, the "
            f"largest "
            f"{max((b['gc2_max_ms'] for b in BURST_STATS), default=0.0):.1f} "
            f"ms; oracle pool workers {args.pool_workers or 'default'}; "
            f"stalls of {STALL_MS} ms or more in the bursts, total ms: "
            f"during a collector's pause "
            f"{sum(b['stall_gc_ms'] for b in BURST_STATS):.1f}, outside one "
            f"{sum(b['stall_other_ms'] for b in BURST_STATS):.1f}; per burst "
            f"(outside, during): "
            f"{[(b['stall_other_ms'], b['stall_gc_ms']) for b in BURST_STATS]}")
        log("[admission] per timed burst (its salt): screen timeouts; "
            "flush ms sum/max; answered (flush start to its last answer) "
            "sum/max; memo store sum/max; dispatch call sum/max; "
            "host join sum/max; fan-out sum/max; K6 captures (n, ms, ms "
            "under the ring's lock, picks that waited, their ms); HOST "
            "cells memo/pool/inline; pool misses timed/warm; pool breaker "
            "shut s; gen-2 pauses (n, ms, max ms); every gen-2 collection "
            "of the burst and its warm rounds (wall ms, the collecting "
            "thread's CPU ms, objects collected, K6 slots finalized in it, "
            "their ms): " + "; ".join(
                f"({sp['run']}) {sp['screen_timeout']}; "
                f"{sp['flush'][0]}/{sp['flush'][1]}; "
                f"{sp['answered'][0]}/{sp['answered'][1]}; "
                f"{sp['memo_store'][0]}/{sp['memo_store'][1]}; "
                f"{sp['call'][0]}/{sp['call'][1]}; "
                f"{sp['host_join'][0]}/{sp['host_join'][1]}; "
                f"{sp['fanout'][0]}/{sp['fanout'][1]}; "
                f"({sp['captures']}, {sp['capture_ms']}, {sp['locked_ms']}, "
                f"{sp['waited']}, {sp['waited_ms']}); "
                f"{sp['cells']['memo']}/{sp['cells']['pool']}/"
                f"{sp['cells']['inline']}; {sp['pool_misses']}/"
                f"{sp['warm_pool_misses']}; {sp['pool_shut_s']}; {sp['gc2']}; "
                f"{sp['gc2_detail']}"
                for sp in (b["split"] for b in BURST_STATS)))
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        with open(os.path.join(ROOT, "build",
                               f"admission_bursts_{int(time.time())}.json"),
                  "w") as f:
            json.dump({"failed": failed, "bursts": BURST_STATS}, f,
                      default=str)
        by_route = {}
        for d in SLOW_DISPATCHES:
            by_route.setdefault(d["route"], []).append(d["ms"])
        log(f"[admission] dispatches of {SLOW_DISPATCH_MS} ms or more, by "
            f"route (count, largest ms): "
            f"{ {k: (len(v), max(v)) for k, v in by_route.items()} }")
        log(f"[admission] {len(failed)} of {args.admission} runs failed "
            f"{failed}; {nvidia_smi_line()}")
        if failed:
            return 1
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev_name,
            "count": torch.cuda.device_count()}}))
        return 0
    if args.webhook:
        webhook_phase(_synth_policy_docs(250))
        log(nvidia_smi_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev_name,
            "count": torch.cuda.device_count()}}))
        return 0
    if args.controller:
        controller_phase()
        log(nvidia_smi_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev_name,
            "count": torch.cuda.device_count()}}))
        return 0
    if args.analysis:
        analysis_phase()
        log(nvidia_smi_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev_name,
            "count": torch.cuda.device_count()}}))
        return 0
    if args.fleet or args.workload or args.chaos:
        for flag, phase in (("fleet", fleet_phase), ("workload", workload_phase),
                            ("chaos", chaos_phase)):
            if getattr(args, flag):
                t0 = time.perf_counter()
                if flag == "chaos":
                    phase()
                else:
                    phase(_synth_policy_docs(250))
                log(f"[{flag}] phase wall {time.perf_counter() - t0:.3f} s")
        log(nvidia_smi_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev_name,
            "count": torch.cuda.device_count()}}))
        return 0
    if args.all_cards:
        all_cards_phase([load_policy(d) for d in _synth_policy_docs(250)])
        log(nvidia_smi_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev_name,
            "count": torch.cuda.device_count()}}))
        return 0

    # ---- 2. kernels against their plain versions
    anchor = CompiledPolicySet([load_policy(d) for d in anchor_policy_docs(7)])
    t = anchor.tensors
    check(anchor.plan.n_gates > 0 and anchor.plan.NCOND > 0,
          "the anchor corpus compiled to no gate or condition rows")
    check(int((np.bincount(t.alt_rule, minlength=t.n_rules) > 1).sum()) > 0,
          "the anchor corpus compiled to no anyPattern rule")
    rng = np.random.default_rng(11)
    n_anchor = 500 if args.quick else 4000
    anchor_st = Stages(anchor, [random_resource(rng) for _ in range(n_anchor)])
    scan_seen = {}
    counts, scan_seen["anchor"] = anchor_st.compare("anchor")
    log(f"[kernels] anchor corpus: C={t.chk_op.size} X={t.ax_op.size} "
        f"gates={t.n_gates} cond={anchor.plan.NCOND} B={n_anchor}: equal {counts}")
    # the same corpus cut into tiles that split its gates and condition
    # slots, so that their tile-local ids differ from the global ones
    tiled = Plan(t, anchor.device, tile_words=600)
    check(tiled.n_tiles > 1 and len({r[TT_GATE0] for r in tiled.tile_table}) > 1
          and len({r[TT_SLOT0] for r in tiled.tile_table}) > 1,
          "the 600-word anchor plan does not split the gates and conditions")
    counts, scan_seen["anchor tiled"] = anchor_st.compare("anchor tiled", plan=tiled)
    log(f"[kernels] anchor corpus in {tiled.n_tiles} rule tiles (600 words): "
        f"equal {counts}")
    deny = CompiledPolicySet([load_policy(d) for d in deny_only_docs()])
    check(deny.plan.C == 0, "the deny-only set compiled to check rows")
    counts, scan_seen["deny-only"] = Stages(
        deny, [random_resource(rng) for _ in range(300)]).compare("deny-only")
    log(f"[kernels] deny-only set (C=0): equal {counts}")
    library_docs = _synth_policy_docs(250)
    lib_cps = CompiledPolicySet([load_policy(d) for d in library_docs])
    n_lib = 1000 if args.quick else 10_000
    lib_stages = Stages(lib_cps, [mixed_resource(i) for i in range(n_lib)])
    counts, scan_seen["library"] = lib_stages.compare("library")
    log(f"[kernels] library 250 x {n_lib}: {lib_cps.plan.n_tiles} rule tile(s), "
        f"{lib_cps.plan.buf.numel() * 4} plan bytes; equal {counts}")
    # K1 over more patterns than a block takes, so that grid.y > 1
    strings = [bytes(row[:int(n)]).decode("latin-1") for row, n in zip(
        lib_stages.str_bytes.cpu().numpy(),
        (lib_stages.str_len & glob.LEN_MASK).cpu().numpy())]
    grng = np.random.default_rng(5)
    rows = [r for r in (_compile_glob(p) for p in glob_patterns(grng, strings, 60))
            if r is not None][:40]
    nfa = [torch.from_numpy(np.stack([r[k] for r in rows])).cuda()
           for k in range(3)]
    nfa.append(torch.tensor([r[3] for r in rows], dtype=torch.int32).cuda())
    tables = glob.nfa_tables(*nfa, "cuda")
    g_k = glob.glob_match_matrix(*nfa, lib_stages.str_bytes, lib_stages.str_len,
                                 tables)
    n = same("K1 40 patterns", g_k, glob.glob_match_matrix_plain(
        *nfa, lib_stages.str_bytes, lib_stages.str_len))
    hits = int(g_k.sum())
    check(len(rows) > 2 * glob.KERNEL_PATTERNS and 0 < hits < n,
          f"K1 pattern set: {len(rows)} patterns, {hits} of {n} matches")
    log(f"[kernels] K1 over {len(rows)} seeded patterns x {lib_stages.V} "
        f"strings ({-(-len(rows) // glob.KERNEL_PATTERNS)} pattern groups): "
        f"equal on {n}, {hits} matches")
    big = CompiledPolicySet([load_policy(d) for d in _synth_policy_docs(1000)])
    check(big.plan.n_tiles > 1, "the 1000-policy plan is one rule tile")
    n_big = 500 if args.quick else 2000
    big_stages = Stages(big, [mixed_resource(i) for i in range(n_big)])
    counts, scan_seen["library-1000"] = big_stages.compare("library-1000")
    geo = big_stages.launch()
    log(f"[kernels] library 1000 x {n_big}: {big.plan.n_tiles} rule tiles "
        f"{big.plan.tiles}, {big.plan.buf.numel() * 4} plan bytes, "
        f"{geometry(geo)}; equal {counts}")
    wide = CompiledPolicySet([load_policy(d) for d in wide_policy_docs()])
    wrng = np.random.default_rng(3)
    n_wide = 200 if args.quick else 1000
    wide_st = Stages(wide, [wide_resource(wrng, containers=16 if i == 0 else 0)
                            for i in range(n_wide)])
    check(wide_st.E == 16 and wide_st.P > 300, f"wide batch {wide_st.shape}")
    counts, scan_seen["wide"] = wide_st.compare("wide")
    geo = wide_st.launch()
    check(geo[0] < 8, f"the wide corpus ran at {geo[0]} resources a group")
    log(f"[kernels] wide corpus x {n_wide}: P={wide_st.P} E={wide_st.E}, "
        f"{wide.plan.n_tiles} rule tiles {wide.plan.tiles}, at most "
        f"{int(wide.plan.tile_table[:, TT_NPATH].max())} paths a tile; "
        f"{geometry(geo)}; equal {counts}")
    # K5 and the scan form have each count to make and each HOST row to
    # drop on the card: some corpus has FAIL and PASS cells outside HOST
    # rows, and FAIL or PASS cells inside them
    log(f"[kernels] scan counts of the compared corpora: {scan_seen}")
    check(any(min(c.values()) > 0 for c in scan_seen.values()),
          "no compared corpus has FAIL and PASS cells both outside and "
          "inside HOST rows")
    # ---- 3. the native flattener against the Python one
    flatten_phase("library 250", lib_cps, [mixed_resource(i) for i in range(n_lib)])
    rng = np.random.default_rng(11)
    flatten_phase("anchor corpus", anchor, [random_resource(rng)
                                            for _ in range(n_anchor)])
    wrng = np.random.default_rng(3)
    flatten_phase("wide corpus", wide, [wide_resource(wrng, containers=16 if i == 0
                                                      else 0)
                                        for i in range(n_wide)])
    if args.quick:
        evaluate_phase(lib_cps, 1000, anchor)
        pipelined_phase(lib_cps, 1000, chunk=256)
        autogen_phase(1000)
        actions_phase(200, 200)
        analysis_phase(200)
        webhook_phase(_synth_policy_docs(250), quick=True)
        check(all(v == 0 for v in native_flatten.FALLBACKS.values()),
              f"native flattener fallbacks {native_flatten.FALLBACKS}")
        log(nvidia_smi_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev_name,
            "count": torch.cuda.device_count()}}))
        return 0

    # ---- 4. main path: compile -> flatten -> evaluate_device (+ async, scan)
    t0 = time.perf_counter()
    cps = CompiledPolicySet([load_policy(d) for d in library_docs])
    compile_s = time.perf_counter() - t0
    resources = [mixed_resource(i) for i in range(10_000)]
    scan_n, scan_chunk = SCAN_RESOURCES, 10_000
    native_flatten.reset_fallbacks()
    _build.reset_launches()
    t0 = time.perf_counter()
    batch = cps.flatten(resources)
    flatten_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    verdicts = cps.evaluate_device(batch)
    evaluate_s = time.perf_counter() - t0
    handle = cps.evaluate_device_async(batch)
    async_v = handle.get()
    scan_tot = None
    scan_host_rows = 0
    scan_batches, scan_counts = [], []
    gen_s = flat_s = count_s = 0.0
    t0 = time.perf_counter()
    for c in range(scan_n // scan_chunk):
        g0 = time.perf_counter()
        chunk = [mixed_resource(c * scan_chunk + j) for j in range(scan_chunk)]
        g1 = time.perf_counter()
        sb = native_flatten.flatten_packed_chunks(cps.tensors, chunk)
        g2 = time.perf_counter()
        f, p, h = cps.scan_counts(sb)
        g3 = time.perf_counter()
        gen_s, flat_s, count_s = gen_s + g1 - g0, flat_s + g2 - g1, count_s + g3 - g2
        scan_batches.append(sb)
        scan_counts.append((f, p, h))
        scan_host_rows += int(h.sum())
        scan_tot = (f.astype(np.int64), p.astype(np.int64)) if scan_tot is None \
            else (scan_tot[0] + f, scan_tot[1] + p)
    scan_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    log(f"[main] launches on the main path: {launches}")
    for name in MAIN_KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    check(all(v == 0 for v in native_flatten.FALLBACKS.values()),
          f"native flattener fallbacks on the main path {native_flatten.FALLBACKS}")

    check(verdicts.shape == (10_000, cps.tensors.n_rules_live)
          and verdicts.dtype == np.int8,
          f"verdicts {verdicts.dtype}{verdicts.shape}")
    hist = np.bincount(verdicts.ravel().astype(np.int64), minlength=6).tolist()
    sha = hashlib.sha256(np.ascontiguousarray(verdicts).tobytes()).hexdigest()
    log(f"[main] compile {compile_s:.3f} s, native flatten {flatten_s:.3f} s, "
        f"evaluate_device {evaluate_s * 1e3:.3f} ms; histogram {hist}; sha256 {sha}")
    if hist != EXPECTED_HIST:
        raise AssertionError(f"histogram {hist} != {EXPECTED_HIST}")
    if sha != EXPECTED_SHA:
        raise AssertionError(f"sha256 {sha} != {EXPECTED_SHA}")
    if not np.array_equal(async_v, verdicts):
        raise AssertionError("evaluate_device_async differs from evaluate_device")
    log(f"[main] scan of {scan_n} resources in {scan_n // scan_chunk} chunks of "
        f"{scan_chunk}: {scan_s:.3f} s wall (making the resources {gen_s:.3f} s, "
        f"flatten_packed_chunks over {native_flatten._chunk_workers()} threads "
        f"{flat_s:.3f} s = {flat_s / scan_n * 1e6:.3f} us a resource, "
        f"scan_counts with its copies {count_s:.3f} s); fails "
        f"{int(scan_tot[0].sum())}, passes {int(scan_tot[1].sum())}, host rows "
        f"{scan_host_rows}; {nvidia_smi_line()}")

    mark("main")
    # ---- 5. evaluate(): the device verdicts, then the host lane
    eval_launches = evaluate_phase(cps, 10_000, anchor, device_v=verdicts)

    # ---- 6. evaluate_pipelined(): chunks overlapped with the host lane
    mark("evaluate")
    pipe_launches = pipelined_phase(cps, 10_000, chunk=1024)
    mark("pipelined")
    check(all(v == 0 for v in native_flatten.FALLBACKS.values()),
          f"native flattener fallbacks {native_flatten.FALLBACKS}")

    # ---- 7. admission: the policy cache, the batcher, K6 and the pool
    admission = admission_phase(library_docs)
    mark("admission")

    # ---- 7b. webhook: the same path behind the port's WebhookServer
    t0 = time.perf_counter()
    webhook = webhook_phase(library_docs)
    log(f"[webhook] phase wall {time.perf_counter() - t0:.3f} s")
    mark("webhook")

    # ---- 7c. controller: two replicas of the controller process, their
    # webhooks over HTTP, the leader's scan, the stream plane, a profile
    # capture and the failover
    t0 = time.perf_counter()
    controller = controller_phase()
    log(f"[controller] phase wall {time.perf_counter() - t0:.3f} s")
    mark("controller")

    # ---- 8. mutate: BASELINE config 4 through the BatchMutator, its gate
    # (K1 -> eval_rules a chunk, then the host lane) on the card
    mutate = mutate_phase()
    mark("mutate")

    # ---- 9-10. autogen: the library as the server autogens it, screened
    # on the card; then the host planes of verifyImages, generate, OpenAPI
    t0 = time.perf_counter()
    autogen = autogen_phase()
    t1 = time.perf_counter()
    actions_phase()
    log(f"[autogen] phase wall {t1 - t0:.3f} s; [actions] phase wall "
        f"{time.perf_counter() - t1:.3f} s")
    mark("autogen and actions")

    # ---- 10b. analysis: the differential fuzz on the card (K1 ->
    # eval_rules, evaluate_pipelined, K6), the certifier and the lint over
    # the library, the CLI, and the certifier on an incremental refresh
    analysis = analysis_phase()
    mark("analysis")

    # ---- 10c. the fleet plane (three replicas of the library sharing one
    # fabric hub, the partitioned scan), the workload plane (replay legs,
    # the dry-run against a 10,000-resource corpus, the CLI's dryrun) and
    # the SLO loop under an oracle brownout; [chaos] last of the three, on
    # a machine whose earlier pools are stopped
    t0 = time.perf_counter()
    fleet = fleet_phase(library_docs)
    log(f"[fleet] phase wall {time.perf_counter() - t0:.3f} s")
    mark("fleet")
    t0 = time.perf_counter()
    workload = workload_phase(library_docs)
    log(f"[workload] phase wall {time.perf_counter() - t0:.3f} s")
    mark("workload")
    t0 = time.perf_counter()
    chaos = chaos_phase()
    log(f"[chaos] phase wall {time.perf_counter() - t0:.3f} s")
    mark("chaos")

    # ---- 11. the background scan path: the scanner's lanes with reports
    # and a delta pass; K7 on the 2D (4, 1) mesh of the card, then on the
    # 1D mesh at two chunks (the host memo holds the first 10,000 until
    # the 1D scan's fresh resources push them out)
    from kyverno_tpu_torch.parallel import make_mesh

    mesh_1d = make_mesh([torch.device("cuda", 0)])
    background = background_phase(library_docs, mesh_1d)
    mark("background")
    mesh2d_launches, mesh2d_matrix = mesh2d_phase(cps, mesh_1d)
    mesh = mesh_phase(cps, mesh_1d, mesh2d_matrix)
    mark("mesh2d and mesh")
    del mesh2d_matrix
    gc.collect()

    # ---- 12. scan: every chunk against the plain pipeline
    t0 = time.perf_counter()
    for c, (sb, (f, p, h)) in enumerate(zip(scan_batches, scan_counts)):
        blob, shp = cps.to_device(sb)
        v = plain_pipeline(cps.plan, blob, shp)
        rf, rp, rh = (x.cpu().numpy() for x in ev.scan_counts_plain(v))
        check(np.array_equal(f, rf) and np.array_equal(p, rp)
              and np.array_equal(h, rh),
              f"scan chunk {c}: counts differ from the plain pipeline")
    plain_s = time.perf_counter() - t0
    # the first scan chunk is the main path's batch: its counts are the
    # matrix's, read on the host
    live = ~(verdicts == 5).any(axis=1)
    f0, p0, _ = scan_counts[0]
    check(np.array_equal(f0, ((verdicts == 2) & live[:, None]).sum(axis=0))
          and np.array_equal(p0, ((verdicts == 1) & live[:, None]).sum(axis=0)),
          "scan counts of the first chunk differ from the verdict matrix's")
    log(f"[scan] {len(scan_batches)} x {scan_chunk} resources: every chunk's "
        f"counts equal to the plain pipeline's ({plain_s:.3f} s to check), the "
        f"first chunk's to the verdict matrix's")
    del scan_batches, scan_counts

    # ---- 13. times at the slice's shapes (library 250 x 10k, then 100k)
    st = Stages(cps, resources)
    B, P, E, V = st.shape
    plan = cps.plan
    N = int(plan.nfa_char.shape[0])
    C, X, NC, R, T = plan.C, plan.X, plan.NCOND, plan.R, plan.n_tiles
    plan_bytes = plan.buf.numel() * 4
    # K1's function reads the NFA rows; the shift-and tables the plan
    # builds from them are its kernel's own expansion, not in the bound
    nfa_bytes = sum(t.numel() * t.element_size() for t in (
        plan.nfa_char, plan.nfa_is_star, plan.nfa_is_q, plan.nfa_len))
    table_bytes = sum(t.numel() * t.element_size() for t in plan.glob)

    def bytes_for(s_):
        """The bytes each function must move: every input read once and
        every output written once. eval_rules (either form) reads the
        cells, bmeta, the dictionary rows, the glob matrix and the plan,
        and writes the verdicts or the masks; K5 reads the masks and
        writes the counts and host rows. scan_blob counts the blob, the
        glob matrix, the plan, the NFA rows and its outputs once each,
        so that no intermediate of its own can shrink its bound. K1 and
        scan_blob count the NFA rows, not the tables built from them."""
        b_, v_ = s_.B, s_.V
        G = -(-b_ // 32)
        masks = 4 * (2 * G * R + T * G)
        rules_in = eval_rules_bytes(s_) - b_ * R
        return {"glob_nfa": nfa_bytes + v_ * 64 + v_ * 4 + N * v_,
                "eval_rules": eval_rules_bytes(s_),
                "eval_rules_scan": rules_in + masks,
                "scan_counts": masks + 8 * R + b_,
                "scan_blob": (s_.blob.numel() * 4 + N * v_ + plan_bytes
                              + nfa_bytes + 8 * R + b_)}

    def calls_for(s_, m_, masks_):
        return {"glob_nfa": lambda: s_.k1(),
                "eval_rules": lambda: s_.rules(m_),
                "eval_rules_scan": lambda: s_.scan_form(m_),
                "scan_counts": lambda: s_.k5(masks_),
                "scan_blob": lambda: s_.scan()}

    def ops_for(s_):
        """The integer operations of eval_rules' forms (eval_rules_ops);
        K1, K5 and scan_blob are held to their bytes."""
        return {"eval_rules": eval_rules_ops(plan, s_.B, s_.E),
                "eval_rules_scan": eval_rules_ops(plan, s_.B, s_.E, "scan")}

    m = st.k1()
    v = st.rules(m)
    masks = st.scan_form(m)
    bytes_of = bytes_for(st)
    ops_of = ops_for(st)
    calls = calls_for(st, m, masks)
    plains = {"glob_nfa": lambda: st.k1(plain=True),
              "eval_rules": lambda: st.rules(m, plain=True),
              "eval_rules_scan": lambda: st.scan_form_plain(m),
              "scan_counts": lambda: st.k5(masks, plain=True),
              "scan_blob": lambda: ev.scan_counts_plain(
                  plain_pipeline(plan, st.blob, st.shape))}
    smi = nvidia_smi_line()
    rows = {}
    for name in list(MAIN_KERNELS) + ["scan_blob"]:
        a, b = calls[name](), plains[name]()
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        max_err = max(float((x.to(torch.int64) - y.to(torch.int64)).abs().max())
                      if x.numel() else 0.0 for x, y in zip(a, b))
        check(max_err == 0, f"{name} differs from its plain version at 10k")
        ms = cuda_ms(calls[name], 50)
        dev_only_ms = device_ms(calls[name])
        plain_ms = cuda_ms(plains[name], 20)
        bound_ms, bound_by = rules_bound(bytes_of[name], ops_of.get(name, 0))
        rows[name] = {"name": name, "route": "cuda", "launches": launches.get(name),
                      "evaluate_launches": eval_launches.get(name),
                      "pipelined_launches": pipe_launches.get(name),
                      "admission_launches":
                          admission["burst"]["launches"].get(name),
                      "mutate_launches": {
                          half: {"router": r["auto_launches"].get(name),
                                 "device_lane": r["device_launches"].get(name)}
                          for half, r in mutate.items()},
                      "autogen_launches": autogen["launches"].get(name),
                      "autogen_burst_launches":
                          autogen["burst_launches"].get(name),
                      "webhook_launches": webhook["launches"].get(name),
                      "controller_launches": {
                          "scan": controller["scan"]["launches"].get(name),
                          "http": controller["http"]["launches"].get(name),
                          "stream": controller["stream"]["launches"].get(
                              name)},
                      "analysis_launches": analysis["launches"].get(name),
                      "fleet_launches": fleet["launches"].get(name),
                      "workload_launches": {
                          "legs": {leg: la.get(name) for leg, la in
                                   workload["leg_launches"].items()},
                          "dryrun": workload["dry_launches"].get(name)},
                      "chaos_launches": chaos["launches"].get(name),
                      "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": None, "bytes": bytes_of[name],
                      "operations": ops_of.get(name),
                      "device_ms": dev_only_ms}
        log(f"[times] {name} at B={B}: {ms:.4f} ms a call between events, "
            f"{dev_only_ms:.4f} ms on the card back to back (plain "
            f"{plain_ms:.4f} ms); bound {bound_ms:.5f} ms by {bound_by} "
            f"({bytes_of[name]} bytes, {ops_of.get(name, 0)} integer "
            f"operations); {100 * bound_ms / dev_only_ms:.2f}% of the bound "
            f"back to back; {smi}")
    log(f"[times] glob_nfa's kernel reads {table_bytes} bytes of plan-built "
        f"tables for its {N} patterns, which its bound leaves out: the "
        f"function's input is the {nfa_bytes} bytes of NFA rows")
    st.rules(m)
    geo = st.launch()
    log(f"[times] eval_rules at B={B}: {plan.n_tiles} rule tile(s), "
        f"{geometry(geo)}")
    dev_ms = cuda_ms(lambda: ev.evaluate_blob(plan, st.blob, *st.shape), 50)
    dev_back = device_ms(lambda: ev.evaluate_blob(plan, st.blob, *st.shape))
    e2e = []
    for _ in range(5):
        t0 = time.perf_counter()
        cps.evaluate_device(batch)
        e2e.append((time.perf_counter() - t0) * 1e3)
    path_bound = (st.blob.numel() * 4 + plan_bytes + B * R) / HBM_BYTES_PER_S * 1e3
    log(f"[times] evaluate_blob on the device (K1 + eval_rules): {dev_ms:.4f} ms "
        f"a call between events, {dev_back:.4f} ms back to back; bound "
        f"{path_bound:.5f} ms; "
        f"evaluate_device with copies, median of 5: {statistics.median(e2e):.3f} ms "
        f"for {B} x {R} verdicts; shapes B={B} P={P} E={E} V={V} N={N} C={C} "
        f"X={X} NCOND={NC} R={R}")

    # eval_rules at smaller tile budgets, same inputs
    sweep = []
    for words in (4096, 8192):
        pw = Plan(cps.tensors, cps.device, tile_words=words)
        same(f"eval_rules tile_words={words}", st.rules(m, plan=pw), v)
        gs = int(ev.LAST_LAUNCH[0])
        sweep.append(f"tile_words={words} ({pw.n_tiles} tiles, {gs} resources "
                     f"a group): {device_ms(lambda: st.rules(m, plan=pw)):.4f} ms")
    log(f"[times] eval_rules at B={B}, on the card back to back, equal at "
        f"each: " + "; ".join(sweep))
    del st, m, v, masks, calls, plains

    # B = 100,000: where the bytes bound passes a launch's latency
    t0 = time.perf_counter()
    st100 = Stages(cps, [mixed_resource(i) for i in range(100_000)])
    flat100_s = time.perf_counter() - t0
    m100 = st100.k1()
    v100 = st100.rules(m100)
    geo100 = st100.launch()
    same("eval_rules B=100000", v100, st100.rules(m100, plain=True))
    masks100 = st100.scan_form(m100)
    same("eval_rules scan form B=100000", masks100,
         ev.scan_masks_plain(plan, v100))
    same("K5 B=100000", st100.k5(masks100), st100.k5(masks100, plain=True))
    same("scan_blob B=100000", st100.scan(), ev.scan_counts_plain(v100))
    # scan_blob launches K1, the scan form and K5 once each and never
    # holds the [B, R] matrix
    del v100
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    st100.scan()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    scan_launches = dict(_build.LAUNCHES)
    check(scan_launches == {"glob_nfa": 1, "eval_rules": 0, "eval_rules_scan": 1,
                            "eval_rules_counts": 0, "scan_counts": 1},
          f"scan_blob launched {scan_launches}")
    check(peak < st100.B * R, f"scan_blob took {peak} bytes at its peak, "
          f"the [B, R] matrix is {st100.B * R}")
    log(f"[scan] scan_blob at B={st100.B}: launches {scan_launches}; "
        f"{peak} bytes allocated at its peak, against {st100.B * R} for the "
        f"[B, R] matrix")
    bytes100 = bytes_for(st100)
    ops100 = ops_for(st100)
    calls100 = calls_for(st100, m100, masks100)
    for name in list(MAIN_KERNELS) + ["scan_blob"]:
        ms100 = cuda_ms(calls100[name], 30)
        dev100 = device_ms(calls100[name], 30)
        bound100, by100 = rules_bound(bytes100[name], ops100.get(name, 0))
        rows[name]["at_100k"] = {"ms": ms100, "device_ms": dev100,
                                 "bound_ms": bound100, "bound_by": by100,
                                 "bytes": bytes100[name],
                                 "operations": ops100.get(name)}
        log(f"[times] {name} at B={st100.B} (V={st100.V}): {ms100:.4f} ms a "
            f"call between events, {dev100:.4f} ms on the card back to back; "
            f"bound {bound100:.5f} ms by {by100} ({bytes100[name]} bytes, "
            f"{ops100.get(name, 0)} integer operations); "
            f"{100 * bound100 / dev100:.2f}% of the bound back to back; {smi}")
    st100.scan_form(m100)
    geo_s = st100.launch()
    log(f"[times] at B={st100.B}: making, flattening and copying the resources "
        f"{flat100_s:.3f} s; eval_rules at {geometry(geo100)}; its scan form "
        f"at {geometry(geo_s)}")
    # K7's counts form at the mesh scan's chunk and at 10k
    rows["eval_rules"]["autogen_670"] = autogen["eval_rules"]
    rows["eval_rules_counts"] = {
        **counts_times(cps),
        "launches": mesh["launches"]["eval_rules_counts"],
        "mesh2d_launches": mesh2d_launches["eval_rules_counts"],
        "background_launches": {k: v["launches"]["eval_rules_counts"]
                                for k, v in background.items()},
        "mesh_k7_ms": mesh["k7_ms"]}
    kernels = []
    for name, row in rows.items():
        if name in KERNEL_SOURCES:
            src, repl = KERNEL_SOURCES[name]
            kernels.append({**row, "source": src, "replaces": repl})
    mark("scan and times")
    log(f"[clock] {CLOCK}")
    log(f"{smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
