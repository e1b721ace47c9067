"""PyTorch + CUDA port of the IRLI system (``src/repro`` is the JAX reference).

The port mirrors the reference path for path (``repro/core/query.py`` ->
``repro_torch/core/query.py``). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; without a card they raise. The kernels on
the query path are hand-written CUDA C++ for Hopper (``kernels/``).

fp32 matmuls stay IEEE: with TF32 the scorer's top-m bucket choice drifts
from the reference.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
