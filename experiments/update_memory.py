"""The peak device memory of qwen2.5-3b's full-depth train step (36
layers, bf16, float32 AdamW moments) through ``launch.train.main``: one
step of 4 x 512 tokens in 2 microbatches, first with the AdamW update
taken a whole leaf at a time (``optimizer.UPDATE_ELEMENTS`` above the
largest leaf: the update's float32 temporaries, the float64 root among
them, are a whole leaf's, as before the update went by blocks), then a
block of rows at a time (the default). A run that does not fit records
its out-of-memory error.

    python3 experiments/update_memory.py [OUT.json]

Writes {"whole_leaf": ..., "blocks": ...} (each the peak GB, or the
error) with the card's name and power limit and the torch version to
OUT.json (default ``build/update_memory.json``) and prints it.
"""
import gc
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

ARGV = ["--arch", "qwen2.5-3b", "--steps", "1", "--batch", "4", "--seq",
        "512", "--microbatches", "2", "--seed", "0"]


def peak_of_step(update_elements=None):
    """One step's peak; ``update_elements`` None keeps the default."""
    from repro_torch.launch import train as launch_train
    from repro_torch.train import optimizer
    default = optimizer.UPDATE_ELEMENTS
    optimizer.UPDATE_ELEMENTS = update_elements or default
    torch.cuda.reset_peak_memory_stats()
    try:
        launch_train.main(ARGV)
        out = {"peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    except torch.OutOfMemoryError as e:
        out = {"error": str(e).split(". ")[0],
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    finally:
        optimizer.UPDATE_ELEMENTS = default
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    out_path = argv[0] if argv else os.path.join(ROOT, "build",
                                                 "update_memory.json")
    if not torch.cuda.is_available():
        print("update_memory: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    res = {"device": smi, "torch": torch.__version__,
           "total_gb": torch.cuda.get_device_properties(0).total_memory
           / 1e9,
           "whole_leaf": peak_of_step(1 << 40),
           "blocks": peak_of_step()}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
