"""Launchers on one card: the step programs, the train and serve CLIs
and the roofline arithmetic.

Counterpart of ``repro.launch``: ``steps`` (the train, prefill and decode
programs of every arch and input shape), ``train`` (``python -m
repro_torch.launch.train``), ``serve`` (``python -m
repro_torch.launch.serve``) and ``roofline`` (the H100's constants and
``analyze_program``).  Not ported: the production mesh, its sharding rules
and the multi-pod dry run (``mesh``, ``sharding``, ``dryrun``,
``federated``), which belong with the multi-card work, and ``reanalyze``,
which re-reads cached XLA HLO that a torch program does not have.
"""
