"""Entry points of the port: ``serve`` (the serving driver: in-process
instances, engine-server processes, a pod inventory or the HTTP front
door), ``pod`` (the inventory launcher and the per-node engine server,
``python -m repro_torch.launch.pod --serve tcp://HOST:PORT``), ``train``
(the training driver), ``mesh`` (a rank's production or host mesh) and
``dryrun`` (one rank's step of every arch and input shape on the meta
device, ``python -m repro_torch.launch.dryrun``).
"""
