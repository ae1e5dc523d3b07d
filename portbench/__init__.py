"""The benchmark of the PyTorch and CUDA port (``repro_torch``): its
harness, configurations, traffic mixes, metric readers and reference."""
