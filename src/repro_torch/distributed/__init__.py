"""Distribution: the logical-axis sharding rules of multi-device training
on a ``DeviceMesh`` and the serving engine's gather-TP (``sharding``),
ZeRO optimizer-state sharding (``zero``), the int8 gradient all-reduce
(``collectives``) and elastic re-meshing (``elastic``)."""

from repro_torch.distributed.sharding import (  # noqa: F401
    ShardingContext,
    activate,
    current_context,
    gather_tp_spec,
    logical_spec,
    model_axis_size,
    shard,
    sharding_for,
    tp_allgather,
    tp_axis,
    tp_body,
)
