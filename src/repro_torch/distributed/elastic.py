"""Elastic re-placement of a tree of state onto another mesh.

Counterpart of ``repro.distributed.elastic.reshard_tree``: a serving fleet
restoring after a shard loss lands each surviving shard's checkpointed
engine carry on its own mesh under the engine's ``carry_pspecs()``
(DESIGN.md §17). Elasticity is a placement move, never a value move: the
leaves keep their global shapes and values. ``repro``'s ``remesh_pspecs``
and ``reshard_state`` place LM training state and come with the ROADMAP
item "LM remainder".
"""

from __future__ import annotations

from repro_torch.distributed.mesh import DeviceMesh, NamedSharding, PartitionSpec, tree_map

__all__ = ["reshard_tree"]


def reshard_tree(tree, pspec_tree, new_mesh: DeviceMesh):
    """Every leaf of ``tree`` (tensor or numpy) placed on ``new_mesh`` under
    the matching :class:`PartitionSpec` of ``pspec_tree``."""
    return tree_map(lambda spec, x: NamedSharding(new_mesh, spec).place(x), pspec_tree, tree,
                    is_leaf=lambda s: isinstance(s, PartitionSpec))
