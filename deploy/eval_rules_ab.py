"""``eval_rules`` (stages 2-6) timed on one card, for the port in another
tree (a parent commit beside this one), so that two versions compare
within one call.

    python3 deploy/eval_rules_ab.py --root build/parent   # that tree's port
    python3 deploy/eval_rules_ab.py --root .              # this tree's

Loads ``kyverno_tpu_torch`` from ``--root`` and ``chip_smoke.py`` from
this tree (its libraries, resources and ``k6_split``), builds the
kernels of that tree, and times, at the shapes the main path gives them:

- the matrix form over the 250-policy library at 10,000 and 100,000
  mixed resources, and over the autogen'd library (670 rule columns,
  three rule tiles) at 10,000 of ``autogen_resource``;
- the scan form over the library at 10,000;
- the matrix form at the admission flush's 16 resources, and on two
  corpora whose rows repeat less than the library's: the anchor corpus
  (70 check rows, 40 distinct) at 4,000 and the wide corpus (E = 16) at
  1,000;
- the counts form over the library at 65,536 (the mesh scan's chunk),
  every live rule counted, and K7's program there (K1 -> the counts
  form, ``evaluate_live_counts``);
- K6's whole call and its graph's replay on the card at the admission
  flush shape (16, 4, 1, 32) (``chip_smoke.k6_split``; the 250 policies
  in enforce mode, the Pod population).

Each kernel time is a median of ``--n`` samples: ``b2b``, ten calls
queued back to back behind a sleep kernel, between two CUDA events,
over ten (the card's own time a call); ``ev``, one call between two
events. Beside each: the launch geometry the kernel reported
(``ops.eval.LAST_LAUNCH``) and the sha256 of its output bytes, which
must be equal between the two trees. Prints one JSON line: the root,
the card's name and power limit, and each shape. Run it in turns
(parent, this, this, parent) in one call; it needs a card and exits 2
without one.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def b2b_ms(fn, n: int, calls: int = 10) -> float:
    """Median over ``n`` samples of ``calls`` calls of ``fn`` queued
    behind a sleep kernel (so that the host's enqueueing overlaps it),
    between two CUDA events, per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / calls)
    return statistics.median(out)


def shape_inputs(cs) -> dict:
    """label -> (call, its output's tensors from a result): the kernel
    calls this script times, on inputs made once."""
    from kyverno_tpu_torch.api.load import load_policy
    from kyverno_tpu_torch.models import CompiledPolicySet
    from kyverno_tpu_torch.ops import eval as ev

    lib = CompiledPolicySet([load_policy(d) for d in cs._synth_policy_docs(250)])
    policies, errors = cs.autogen_policies(cs._synth_policy_docs(250),
                                           cs.policy_steps())
    if errors:
        raise SystemExit(f"eval_rules_ab: autogen errors {errors[:3]}")
    full = CompiledPolicySet(policies)
    st10 = cs.Stages(lib, [cs.mixed_resource(i) for i in range(10_000)])
    st100 = cs.Stages(lib, [cs.mixed_resource(i) for i in range(100_000)])
    st670 = cs.Stages(full, [cs.autogen_resource(i) for i in range(10_000)])
    st65 = cs.Stages(lib, [cs.mixed_resource(i) for i in range(65_536)])
    st16 = cs.Stages(lib, [cs.mixed_resource(i) for i in range(16)])
    anchor = CompiledPolicySet([load_policy(d)
                                for d in cs.anchor_policy_docs(7)])
    rng = np.random.default_rng(11)
    sta = cs.Stages(anchor, [cs.random_resource(rng) for _ in range(4000)])
    wide = CompiledPolicySet([load_policy(d) for d in cs.wide_policy_docs()])
    rng = np.random.default_rng(3)
    stw = cs.Stages(wide, [cs.wide_resource(rng, containers=16 if i == 0
                                            else 0) for i in range(1000)])
    live = lib.tensors.n_rules_live
    m10, m100, m670, m65, m16, ma, mw = (
        s.k1() for s in (st10, st100, st670, st65, st16, sta, stw))
    return {
        "eval_rules 10k": (lambda: st10.rules(m10), lambda v: (v,)),
        "eval_rules 100k": (lambda: st100.rules(m100), lambda v: (v,)),
        "eval_rules 670-column plan 10k": (lambda: st670.rules(m670),
                                           lambda v: (v,)),
        "scan form 10k": (lambda: st10.scan_form(m10), lambda m: m),
        "counts form 65,536": (
            lambda: ev.eval_rules_counts(lib.plan, st65.blob, *st65.shape,
                                         m65, live), lambda r: r),
        "K7 program 65,536": (
            lambda: ev.evaluate_live_counts(lib.plan, st65.blob, *st65.shape,
                                            live), lambda r: r),
        "eval_rules flush 16": (lambda: st16.rules(m16), lambda v: (v,)),
        "eval_rules anchor 4,000": (lambda: sta.rules(ma), lambda v: (v,)),
        "eval_rules wide 1,000": (lambda: stw.rules(mw), lambda v: (v,)),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True,
                    help="the tree whose kyverno_tpu_torch is timed")
    ap.add_argument("--n", type=int, default=50,
                    help="samples a median is taken over")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        print("eval_rules_ab: no CUDA device", file=sys.stderr)
        return 2
    import kyverno_tpu_torch
    from kyverno_tpu_torch.api.load import load_policy
    from kyverno_tpu_torch.models import native_flatten
    from kyverno_tpu_torch.ops import _build
    from kyverno_tpu_torch.ops import eval as ev
    from kyverno_tpu_torch.runtime.batch import AdmissionBatcher
    from kyverno_tpu_torch.runtime.policycache import PolicyCache, PolicyType

    pkg = os.path.dirname(os.path.abspath(kyverno_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise SystemExit(f"eval_rules_ab: loaded {pkg}, not {root}'s")
    build_s = _build.build_all()
    native_flatten._load_lib()
    out = {"root": args.root, "card": cs.nvidia_smi_line(),
           "build_s": round(build_s, 3)}
    for label, (call, parts) in shape_inputs(cs).items():
        got = parts(call())
        torch.cuda.synchronize()
        launch = [int(x) for x in ev.LAST_LAUNCH]
        row = {"b2b_ms": b2b_ms(call, args.n),
               "ev_ms": cs.cuda_ms(call, args.n),
               "launch": launch, "sha": digest(*got)}
        cs.log(f"[eval_rules ab] {args.root} {label}: {row['b2b_ms']:.4f} ms "
               f"back to back, {row['ev_ms']:.4f} ms between events; launch "
               f"{launch}; output sha {row['sha']}")
        out[label] = row
    enf = PolicyType.VALIDATE_ENFORCE
    cache = PolicyCache()
    for d in cs._synth_policy_docs(250):
        cache.add(load_policy(dict(d, spec=dict(
            d["spec"], validationFailureAction="enforce"))))
    cps = cache.compiled(enf, "Pod", "default")
    pods = [cs.admission_request(i, "ab")[0] for i in range(16)]
    batch = AdmissionBatcher._pad_admission(cps.flatten_packed(pods))[0]
    split = cs.k6_split(cps, batch, n=args.n)
    cs.log(f"[eval_rules ab] {args.root} K6 at {split['shape']}, ms, "
           f"medians: {cs.split_line(split)}")
    on = split["on"]
    out["k6 flush"] = {"shape": list(split["shape"]), "wall_ms": on["wall"],
                       "replay_ms": on.get("replay", on.get("launches")),
                       "plain_wall_ms": split["off"]["wall"]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
