"""repro_torch — the PyTorch/CUDA port of the D4M.jl database reproduction.

Beside the JAX package ``repro`` (the reference), this package runs the
paper's Listing-1 database path — connector → sharded store → leveled LSM
engine — on an NVIDIA GPU, with hand-written Hopper kernels for the batched
rank search, the row rank and the pair-rank merge (``kernels/``, sources in
``csrc/``). Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.
"""
