"""End-to-end serving driver on the PyTorch port: a continuous-batching
engine under a Poisson workload with the CoCoServe Monitor -> Controller
closed loop making live scale-up/scale-down decisions. The port's
counterpart of ``examples/serve_autoscale.py``: it wraps
``repro_torch.launch.serve.main`` and takes its flags.

    PYTHONPATH=src python examples/torch_serve_autoscale.py --device cpu \\
        --requests 24 --rps 6
    PYTHONPATH=src python examples/torch_serve_autoscale.py \\
        --arch llama2-13b --no-reduced --instances 2 --requests 24 --rps 4
"""
import sys

from repro_torch.launch.serve import main

if __name__ == "__main__":
    main(sys.argv[1:])
