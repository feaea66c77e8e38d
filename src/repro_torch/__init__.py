"""PyTorch/CUDA port of the CCE system (the JAX package ``repro`` is the
reference).  Module names and layout follow ``repro`` one for one; every
Pallas kernel on a ported path is a hand-written Hopper kernel here, with
its plain PyTorch version beside it (``kernels/ref.py``)."""
