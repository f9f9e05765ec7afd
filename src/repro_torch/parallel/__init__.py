"""The reference's sharded serving and train steps on
``torch.distributed``: the mesh and its differentiable collectives
(``mesh``), the sharding rules and spec trees (``sharding``) and
distributed flash-decoding (``distributed_attention``). The layers that
run at a rank's shard are ``models.layers``, ``models.moe`` and
``models.transformer``, under ``sharding.use_rules``; the train step
that runs them is ``training.train``.
"""
