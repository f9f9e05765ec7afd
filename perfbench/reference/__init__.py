"""The plain references the served tokens are judged against, one module
a layout, named by a configuration file's ``"reference"`` key. A module
gives ``shapes(m)`` (the parameters, drawn by ``weights.py``),
``work(m)`` (the sizes ``roofline.py`` counts with) and ``Reference``
(the plain float32 forward, ``logits(seqs, rows)``)."""
import importlib


def layout(m: dict):
    """The reference module of the configuration file ``m``."""
    return importlib.import_module(f"perfbench.reference.{m['reference']}")
