"""Serve a small LM with batched requests on the PyTorch port (continuous
prefill+decode engine).

  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]

On the card it serves smollm-135m at full width (head dim 64). With
``--device cpu`` it serves the reduced config (head dim 16), a size the
CPU runs in seconds.
"""
import argparse

from repro_torch.launch.serve import main as serve_main

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args().device
    argv = ["--arch", "smollm-135m", "--requests", "8", "--max-new", "16",
            "--slots", "4", "--device", device]
    if device == "cpu":
        argv.append("--reduced")
    stats = serve_main(argv)
    assert stats["tokens_out"] >= 8 * 8
    print("OK")
