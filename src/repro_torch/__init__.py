"""PyTorch + CUDA port of the IRLI system (``src/repro`` is the JAX reference).

The port mirrors the reference path for path (``repro/core/query.py`` ->
``repro_torch/core/query.py``). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; without a card they raise. The kernels on
the query, fit, streaming and LM paths are hand-written CUDA C++ for
Hopper (``kernels/``).

fp32 matmuls stay IEEE: with TF32 the scorer's top-m bucket choice drifts
from the reference. bf16 matmuls (the LM family's projections and MLPs)
accumulate in fp32 as the reference's do: cuBLAS may otherwise reduce part
of the sum in bf16.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
