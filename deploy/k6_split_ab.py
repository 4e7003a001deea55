"""K6's phase split on one card, for the port in another tree (a parent
commit beside this one), so that two versions compare within one call.

    python3 deploy/k6_split_ab.py --root build/parent   # that tree's port
    python3 deploy/k6_split_ab.py --root .              # this tree's

Loads ``kyverno_tpu_torch`` from ``--root`` and ``chip_smoke.py`` from
this tree (its ``k6_split``, library and Pods), builds the kernels of
that tree, compiles the 250-policy library in enforce mode through a
``PolicyCache`` (the Pod population, as ``[admission]`` does), and times
``evaluate_device_async(batch).get()`` with K6 and on the plain route
(``chip_smoke.k6_split``: medians of 50 calls, then the same calls timing
their own steps) at the admission flush shape (16 Pods) and at 10,000
mixed resources. Prints one JSON line: the root, the card's name and
power limit, and each shape's split. Run it in turns (parent, this,
this, parent) in one call; it needs a card and exits 2 without one.
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True,
                    help="the tree whose kyverno_tpu_torch is timed")
    ap.add_argument("--n", type=int, default=50,
                    help="calls a median is taken over")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        print("k6_split_ab: no CUDA device", file=sys.stderr)
        return 2
    import kyverno_tpu_torch
    from kyverno_tpu_torch.api.load import load_policy
    from kyverno_tpu_torch.models import native_flatten
    from kyverno_tpu_torch.ops import _build
    from kyverno_tpu_torch.runtime.batch import AdmissionBatcher
    from kyverno_tpu_torch.runtime.policycache import PolicyCache, PolicyType

    pkg = os.path.dirname(os.path.abspath(kyverno_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise SystemExit(f"k6_split_ab: loaded {pkg}, not {root}'s")
    build_s = _build.build_all()
    native_flatten._load_lib()
    enf = PolicyType.VALIDATE_ENFORCE
    cache = PolicyCache()
    for d in cs._synth_policy_docs(250):
        cache.add(load_policy(dict(d, spec=dict(
            d["spec"], validationFailureAction="enforce"))))
    cps = cache.compiled(enf, "Pod", "default")
    pods = [cs.admission_request(i, "split")[0] for i in range(16)]
    shapes = {
        "flush": AdmissionBatcher._pad_admission(cps.flatten_packed(pods))[0],
        "10k": cps.flatten_packed([cs.mixed_resource(i)
                                   for i in range(10_000)])}
    out = {"root": args.root, "card": cs.nvidia_smi_line(),
           "build_s": round(build_s, 3)}
    for label, batch in shapes.items():
        split = cs.k6_split(cps, batch, n=args.n)
        cs.log(f"[k6 split] {args.root} at the {label} shape "
               f"{split['shape']}, ms, medians: {cs.split_line(split)}")
        out[label] = {"shape": list(split["shape"]),
                      "bound_ms": split["bound_ms"],
                      "on": split["on"], "off": split["off"]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
