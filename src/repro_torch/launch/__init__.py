"""Launchers: the step programs, the train and serve CLIs, the roofline
arithmetic and the multi-card layer.

Counterpart of ``repro.launch``: ``steps`` (the train, prefill and decode
programs of every arch and input shape), ``train`` (``python -m
repro_torch.launch.train``), ``serve`` (``python -m
repro_torch.launch.serve``), ``roofline`` (the H100's constants and
``analyze_program``), ``mesh`` (``DeviceMesh`` factories over a
``torch.distributed`` group), ``sharding`` (the reference's logical-axis
rules as specs, and their DTensor placements), ``federated`` (the
``shard`` backend), ``dryrun`` (``python -m repro_torch.launch.dryrun``:
every program placed on the production mesh of a ``fake`` group, each
record with the op log of what a rank ran beside it) and ``reanalyze``
(``python -m repro_torch.launch.reanalyze``: the records re-scored from
their op logs, where the reference re-reads its cached HLO), with
``ranks`` to start ranks without ``torchrun``.
"""
