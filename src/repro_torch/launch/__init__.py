"""Entry points of the port: ``serve`` (the serving driver: in-process
instances, engine-server processes, a pod inventory or the HTTP front
door) and ``pod`` (the inventory launcher and the per-node engine
server, ``python -m repro_torch.launch.pod --serve tcp://HOST:PORT``).
"""
