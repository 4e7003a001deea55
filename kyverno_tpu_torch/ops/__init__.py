"""Device kernels, each beside its plain PyTorch version: the glob NFA
(K1, ``glob.py``), check evaluation (K2+K3), verdict reduction (K4) and
scan counts (K5) in ``eval.py``, the static plan in ``plan.py`` and the
nvcc build in ``_build.py``."""
