"""Device kernels, each beside its plain PyTorch version: the glob NFA
(K1, ``glob.py``), stages 2-6 from the blob to the verdicts
(``eval_rules``), scan counts (K5) and K7's per-rule counts in
``eval.py``, the static plan in ``plan.py`` and the nvcc build in
``_build.py``."""
