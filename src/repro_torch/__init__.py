"""repro_torch — the PyTorch/CUDA port of the D4M.jl database reproduction.

Beside the JAX package ``repro`` (the reference), this package runs on an
NVIDIA GPU:

- the paper's Listing-1 database path — connector → sharded store →
  leveled LSM engine — the D4M 2.0 schema with its degree table, the
  legacy single-run engine and Graphulo's SpMV (``db/``);
- the LM serving path for the dense family — ``launch/serve.py`` →
  ``serve.Engine`` → ``models.transformer`` prefill / decode (``models/``,
  ``configs/``).

Seven hand-written Hopper kernels carry them (``kernels/``, sources in
``csrc/``): the batched and 1-D rank searches, the row rank, the pair-rank
merge, the segment sum, the ELL SpMV and flash attention. Entry points run
on ``device="cuda"`` unless the caller passes ``device="cpu"``.
"""
