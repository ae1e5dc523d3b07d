"""End-to-end training on the PyTorch port: a smollm-family LM, data
streamed from the store-backed pipeline, with a simulated failure and a
restart from the checkpoint halfway through.

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--device cpu]

On the card it trains smollm-135m at full width (head dim 64). With
``--device cpu`` it trains the reduced config (head dim 16), a size the
CPU runs in seconds.
"""
import argparse
import shutil
import tempfile

from repro_torch.launch.train import main as train_main


def run(steps: int = 200, device: str = "cuda"):
    ckpt = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    common = ["--arch", "smollm-135m", "--device", device,
              "--batch", "8", "--seq", "128", "--ckpt-dir", ckpt]
    if device == "cpu":
        common.append("--reduced")
    try:
        half = steps // 2
        print(f"== phase 1: steps 0..{half} ==")
        train_main(common + ["--steps", str(half), "--ckpt-every", "20"])
        print("== simulated failure; restart from checkpoint ==")
        losses = train_main(common + ["--steps", str(steps), "--resume"])
        assert losses[-1] < losses[0], "loss should decrease"
        print("training-loss sanity: PASS")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.steps, args.device)
    print("OK")
