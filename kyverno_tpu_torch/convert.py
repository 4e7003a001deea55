"""Carry compiled state across from numpy.

:func:`tensors_from_numpy` builds this package's ``PolicyTensors`` from
the fields of another compile of the same policies (numpy arrays, lists,
dicts and ints keyed by field name), and :func:`batch_from_numpy` a batch
from the four packed arrays. With these a test feeds identical compiled
state to two implementations, and holds the device evaluation to account
apart from the compiler and the flattener.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np

from .models.compiler import PolicyTensors
from .models.flatten import PackedBatch

# host-side provenance that stays with the compile that made it
_SKIP = {"rules", "segments"}


def tensors_from_numpy(fields_in: dict) -> PolicyTensors:
    """``PolicyTensors`` with every array, list, dict and int field taken
    from ``fields_in``; arrays keep their dtype. The rule IRs and segment
    spans are not carried (they name the other compile's objects)."""
    kw = {}
    for f in fields(PolicyTensors):
        if f.name in _SKIP:
            continue
        if f.name not in fields_in:
            if f.name in ("dict_base", "dict_epoch", "n_rules_logical"):
                continue    # dataclass defaults
            raise KeyError(f"tensors_from_numpy: missing field {f.name!r}")
        v = fields_in[f.name]
        if isinstance(v, np.ndarray):
            v = np.array(v, copy=True)
        elif isinstance(v, list):
            v = list(v)
        elif isinstance(v, dict):
            v = dict(v)
        kw[f.name] = v
    return PolicyTensors(**kw)


def batch_from_numpy(cells, bmeta, str_bytes, dictv) -> PackedBatch:
    """A packed batch from (cells [B,P,E,2], bmeta [B], str_bytes
    [V,STR_LEN], dictv [V,5]); the integer arrays become uint32."""
    cells = np.ascontiguousarray(cells, dtype=np.uint32)
    return PackedBatch(
        n=int(cells.shape[0]), e=int(cells.shape[2]), cells=cells,
        bmeta=np.ascontiguousarray(bmeta, dtype=np.uint32),
        str_bytes=np.ascontiguousarray(str_bytes, dtype=np.uint8),
        dictv=np.ascontiguousarray(dictv, dtype=np.uint32))
