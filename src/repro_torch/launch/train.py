"""Training entry point: the store-backed data pipeline -> train steps on
one device, with checkpoint/restart.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ck --device cpu

The weights are the port's seeded random init (``--seed``), drawn on the
device that trains them; the corpus is synthetic and lives in a
``TokenStore``. Runs on the card unless ``--device cpu`` (the card's
attention kernel takes head dims 64, 80, 112 and 128, so the reduced
configs, hd 16, train on the CPU). An enc-dec (VLM) batch also holds
seeded frames (image embeddings), drawn after the tokens as the JAX
package's ``launch/train.py`` draws them. On ``--resume`` the batches of
the steps before the checkpoint, their frames or image embeddings
included, are drawn and dropped, so step s trains on the batch an
uninterrupted run gives it.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_reduced
from ..data import TokenStore, synthetic_corpus
from ..kernels.common import resolve_device
from ..models import build, init_params
from ..models.api import prefix_input
from ..train import AdamWConfig, adamw_init, checkpoint
from ..train.train_step import make_train_step


def draw_batch(cfg, store, batch: int, seq: int, rng) -> dict:
    """One step's batch of host tensors, drawn as the JAX package's
    ``launch/train.py`` draws it: ``tokens`` [batch, seq] from the store,
    then for a VLM ``img_embeds`` [batch, n_img, d_model] and for an
    enc-dec ``frames`` [batch, n_frames, d_model], ``rng.normal() * 0.02``
    in float64, rounded to float32 and then to the parameter dtype
    (``jnp.asarray`` rounds a float64 array to float32 first)."""
    out = {"tokens": torch.from_numpy(store.sample_batch(batch, seq, rng))}
    prefix = prefix_input(cfg)
    if prefix is not None:
        name, n = prefix
        x = rng.normal(size=(batch, n, cfg.d_model)) * 0.02
        out[name] = torch.from_numpy(x.astype(np.float32)).to(cfg.dtype)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--docs", type=int, default=64)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = build(cfg)

    # ---- the paper's data plane: corpus lives in the sharded KV store ----
    store = TokenStore(num_shards=4, device=device)
    store.ingest(synthetic_corpus(args.docs, args.seq * 4, cfg.vocab - 1))

    opt_cfg = AdamWConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    params = init_params(model.param_specs,  # drawn where it trains
                         torch.Generator(device=device).manual_seed(args.seed))
    opt = adamw_init(params, opt_cfg)
    start = 0
    if args.resume and args.ckpt_dir:
        try:
            state, manifest = checkpoint.restore(
                args.ckpt_dir, {"params": params, "opt": opt}, device=device)
            params, opt = state["params"], state["opt"]
            start = manifest["step"]
            print(f"resumed from step {start}")
        except FileNotFoundError:
            pass

    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches)
    rng = np.random.default_rng(args.seed)
    for _ in range(start):  # the batches the checkpoint already took
        draw_batch(cfg, store, args.batch, args.seq, rng)
    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = {k: x.to(device) for k, x in
                 draw_batch(cfg, store, args.batch, args.seq, rng).items()}
        params, opt, loss = step_fn(params, opt, batch)
        losses.append(float(loss))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            tput = args.batch * args.seq * (step - start + 1) / max(dt, 1e-9)
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"({tput:,.0f} tok/s)")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt_dir, step + 1,
                            {"params": params, "opt": opt})
    if args.ckpt_dir:
        checkpoint.save(args.ckpt_dir, args.steps,
                        {"params": params, "opt": opt})
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
