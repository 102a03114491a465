"""Elastic re-placement of a tree of state onto another mesh.

The port of ``repro.distributed.elastic``. Elasticity is a placement move,
never a value move: the leaves keep their global shapes and values.

* :func:`reshard_tree` places every leaf of a tree under its spec on a new
  mesh. A serving fleet restoring after a shard loss lands each surviving
  shard's checkpointed engine carry with it (DESIGN.md §17).
* :func:`remesh_pspecs` re-resolves every LM parameter's logical axes
  (``Model.param_specs()``) against a new mesh with the rules of
  ``distributed.sharding``. Resolution is pure (priority and
  divisibility), so any surviving mesh gets legal shardings. It reads only
  shapes: a model built on the meta device gives them for any config.
* :func:`reshard_state` places an LM train state on a new mesh: parameters
  under their specs, optimizer moments and the step count on the mesh's
  home device, values unchanged.
"""

from __future__ import annotations

from repro_torch.convert import repro_path
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.mesh import DeviceMesh, NamedSharding, PartitionSpec, tree_map

__all__ = ["remesh_pspecs", "reshard_state", "reshard_tree"]


def reshard_tree(tree, pspec_tree, new_mesh: DeviceMesh):
    """Every leaf of ``tree`` (tensor or numpy) placed on ``new_mesh`` under
    the matching :class:`PartitionSpec` of ``pspec_tree``."""
    return tree_map(lambda spec, x: NamedSharding(new_mesh, spec).place(x), pspec_tree, tree,
                    is_leaf=lambda s: isinstance(s, PartitionSpec))


def remesh_pspecs(model, params_shapes: dict, new_mesh) -> dict[str, PartitionSpec]:
    """Every parameter's :class:`PartitionSpec` on ``new_mesh``, by name.

    ``params_shapes`` maps the parameter names of ``model.param_specs()`` to
    shapes (``{n: p.shape for n, p in model.named_parameters()}``, from a
    model built on the meta device for a full config). A layer of a scanned
    period resolves as ``repro`` resolves its stacked leaf: ``(None,
    *logical)`` against ``(n_periods, *shape)``, the period dim dropped
    after (the "embed" fallback reads the stacked tensor's size). The
    encoder's layers are scanned periods too, as ``repro``'s
    ``launch/dryrun.py`` resolves them (``repro``'s own ``remesh_pspecs``
    resolves the encoder unstacked and fails on its shapes). The prefix,
    the remainder, the shared block and MTP resolve unstacked. Only
    ``new_mesh.shape`` is read."""
    cfg = model.cfg
    periods = {"stack": cfg.n_periods, "encoder": cfg.n_enc_layers}
    out = {}
    for name, logical in model.param_specs().items():
        shape = tuple(params_shapes[name])
        path, period = repro_path(cfg, name)
        if period is None:
            out[name] = shd.resolve(tuple(logical), shape, new_mesh)
        else:
            spec = shd.resolve((None, *logical), (periods[path[0]], *shape), new_mesh)
            out[name] = PartitionSpec(*spec[1:])
    return out


def reshard_state(state: dict, pspecs: dict, new_mesh: DeviceMesh) -> dict:
    """An in-memory train state (``{"params": {name: tensor}, "opt": {"m",
    "v", "step"}}``) on ``new_mesh``: each parameter placed under its spec
    (:func:`reshard_tree`), the optimizer state (float32, bfloat16 or q8
    ``{"q", "scale"}`` moments and ``step``) on the mesh's home device as it
    is, as ``repro`` puts it with ``jax.device_put``. Values are unchanged."""
    params = reshard_tree(state["params"], pspecs, new_mesh)
    opt = tree_map(lambda x: x.to(new_mesh.home), state["opt"])
    return {"params": params, "opt": opt}
