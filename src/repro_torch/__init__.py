"""PyTorch/CUDA port of the model substrate, for an NVIDIA H100.

Sits beside the JAX package ``repro`` and imports nothing of it: what it
needs of that package's framework-free modules it keeps as its own copy.
The serving path (tokenizer -> continuous batcher -> model -> hand-written
Hopper kernels: two attention kernels for the dense decoder, the SSD scan
for the Mamba2 stack, the expert FFN for the MoE layers) runs on ``cuda``
unless a caller passes ``device="cpu"``; on CPU tensors the kernels'
plain PyTorch versions run instead.
"""
