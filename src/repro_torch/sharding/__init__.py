"""Sharding over a mesh (counterpart of ``repro/sharding``): logical-axis
rules, collectives over named mesh axes, the "model"-axis split of a block
(``tp``), FSDP's gathers (``fsdp``) and the GPipe pipeline."""
from repro_torch.sharding.rules import (
    MeshRules,
    MeshShape,
    constrain,
    distribute_tree,
    logical_to_spec,
    shard_tree,
)
