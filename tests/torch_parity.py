"""Shared inputs and JAX-side references for the tests/test_torch_*.py
parity suite: the PyTorch port (``kyverno_tpu_torch``, on the CPU, where
every kernel wrapper runs its plain PyTorch version) against the JAX
package on the same inputs.

The JAX side runs ``build_eval_fn_blob``, its own device entry, jitted: at
the suite's small batches one compile costs 2-5 s, about a quarter of the
first eager run of the same program.
"""

from __future__ import annotations

import glob as _glob
import os
import random
from dataclasses import fields

import numpy as np

import bench
import chip_smoke
from kyverno_tpu.analysis import difffuzz
from kyverno_tpu.api.load import load_policies_from_path
from kyverno_tpu.api.load import load_policy as jax_load_policy
from kyverno_tpu.models import CompiledPolicySet as JaxPolicySet
from kyverno_tpu.models.flatten import flatten_batch as jax_flatten_batch
from kyverno_tpu.ops.eval import build_eval_fn_blob, build_scan_fn_blob
from kyverno_tpu_torch.api.load import load_policy as torch_load_policy
from kyverno_tpu_torch.models import CompiledPolicySet as TorchPolicySet
from tests.ops.test_cross_check import (
    ADVERSARIAL_POLICIES,
    SYNTHETIC_POLICIES,
    random_pod,
)

POLICY_DIR = os.path.join(os.path.dirname(__file__), "policies")
FUZZ_SEEDS = (3, 17, 41)

DENY_ONLY = [
    {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
     "metadata": {"name": "deny-ns"},
     "spec": {"rules": [{
         "name": "deny-ns", "match": {"resources": {"kinds": ["Pod"]}},
         "validate": {"deny": {"conditions": {"any": [
             {"key": "{{ request.object.metadata.namespace }}",
              "operator": "In", "value": ["prod", "dev"]}]}}}}]}},
    {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
     "metadata": {"name": "deny-replicas"},
     "spec": {"rules": [{
         "name": "deny-replicas",
         "match": {"resources": {"kinds": ["Deployment"]}},
         "validate": {"deny": {"conditions": {"all": [
             {"key": "{{ request.object.spec.replicas }}",
              "operator": "GreaterThan", "value": 3}]}}}}]}},
]


def policy_files() -> list[str]:
    return sorted(_glob.glob(os.path.join(POLICY_DIR, "*.yaml")))


def corpus_docs(name: str) -> list[dict]:
    """Policy documents of a named corpus (YAML files load on the JAX
    side and are handed over as their raw dicts)."""
    if name == "library250":
        return bench._synth_policy_docs(250)
    if name == "library1000":
        return bench._synth_policy_docs(1000)
    if name == "crosscheck":
        return SYNTHETIC_POLICIES + ADVERSARIAL_POLICIES
    if name == "deny_only":
        return DENY_ONLY
    if name == "wide":
        return chip_smoke.wide_policy_docs()
    if name.startswith("fuzz"):
        seed = int(name[4:])
        return difffuzz.gen_policy_docs(random.Random(seed), seed, n_policies=6)
    if name.startswith("file:"):
        return [p.raw for p in load_policies_from_path(
            os.path.join(POLICY_DIR, name[5:]))]
    raise KeyError(name)


def corpus_resources(name: str, n: int) -> list[dict]:
    if name == "library250":
        return [bench.mixed_resource(i) for i in range(n)]
    if name == "wide":
        rng = np.random.default_rng(3)
        return [chip_smoke.wide_resource(rng, containers=16 if i == 0 else 0)
                for i in range(n)]
    if name.startswith("fuzz"):
        rng = random.Random(1000 + int(name[4:]))
        return [difffuzz.gen_resource(rng, rng.choice(("Pod", "Deployment",
                                                       "Scale")))
                for _ in range(n)]
    rng = random.Random(20260729)
    return [random_pod(rng) for _ in range(n)]


def both_sets(docs: list[dict]):
    """(JAX CompiledPolicySet, port CompiledPolicySet on the CPU)."""
    jset = JaxPolicySet([jax_load_policy(d) for d in docs])
    tset = TorchPolicySet([torch_load_policy(d) for d in docs], device="cpu")
    return jset, tset


def tensor_fields(tensors) -> dict:
    """Every dataclass field of a PolicyTensors, keyed by name."""
    return {f.name: getattr(tensors, f.name) for f in fields(tensors)}


def jax_blob(jset, resources):
    return jax_flatten_batch(resources, jset.tensors).packed_blob()


def jax_verdicts(jset, resources) -> np.ndarray:
    blob, shp = jax_blob(jset, resources)
    v = np.asarray(build_eval_fn_blob(jset.tensors)(blob, *shp))
    return v[:, :jset.tensors.n_rules_live]


def jax_scan(jset, resources):
    blob, shp = jax_blob(jset, resources)
    return tuple(np.asarray(x) for x in build_scan_fn_blob(jset.tensors)(blob, *shp))
