"""Mesh sharding of the policy x resource evaluation matrix (K7)."""

from .mesh import (
    Mesh,
    make_mesh,
    mesh_from_env,
    pad_batch,
    parse_mesh_shape,
    shard_eval_fns,
    sharded_eval_fn,
    sharded_scan,
)

__all__ = ["Mesh", "make_mesh", "mesh_from_env", "pad_batch",
           "parse_mesh_shape", "shard_eval_fns", "sharded_eval_fn",
           "sharded_scan"]
