"""Training of the port: AdamW (``optimizer``), the loss and the train
steps (``train``) and checkpoints in the reference's file format
(``checkpoint``). The driver is ``repro_torch.launch.train``.
"""
