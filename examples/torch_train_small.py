"""End-to-end training driver on the PyTorch port: train a small model on
synthetic packed LM data, with checkpointing. The port's counterpart of
``examples/train_small.py``: it runs ``repro_torch.launch.train.main``
with the flags given, or with none the reduced tinyllama config for 300
steps on the card.

    PYTHONPATH=src python examples/torch_train_small.py --device cpu \\
        --arch tinyllama-1.1b --reduce --steps 50 --ckpt /tmp/t.ckpt
"""
import os
import sys
import tempfile

from repro_torch.launch import train

DEFAULT_ARGS = ["--arch", "tinyllama-1.1b", "--reduce", "--steps", "300",
                "--batch", "8", "--seq", "128", "--ckpt",
                os.path.join(tempfile.gettempdir(), "torch_train_small.ckpt")]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    return train.main(argv or DEFAULT_ARGS)


if __name__ == "__main__":
    main()
