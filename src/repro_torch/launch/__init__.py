"""Launchers: the step programs, the train and serve CLIs, the roofline
arithmetic and the multi-card layer.

Counterpart of ``repro.launch``: ``steps`` (the train, prefill and decode
programs of every arch and input shape), ``train`` (``python -m
repro_torch.launch.train``), ``serve`` (``python -m
repro_torch.launch.serve``), ``roofline`` (the H100's constants and
``analyze_program``), ``mesh`` (``DeviceMesh`` factories over a
``torch.distributed`` group), ``sharding`` (the reference's logical-axis
rules as specs, and their DTensor placements), ``federated`` (the
``shard`` backend) and ``dryrun`` (``python -m repro_torch.launch.dryrun``:
every program placed on the production mesh of a ``fake`` group), with
``ranks`` to start ranks without ``torchrun``.  Not ported:
``reanalyze``, which re-reads cached XLA HLO that a torch program does
not have.
"""
