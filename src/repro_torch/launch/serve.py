"""Serving entry point: batched requests against an LM on one device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --reduced --device cpu

The weights are the port's seeded random init (``--seed``); the prompts
are drawn from the same seed. Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_config, get_reduced
from ..kernels.common import resolve_device
from ..models import build, init_params
from ..serve.engine import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = build(cfg)
    params = init_params(model.param_specs,
                         torch.Generator().manual_seed(args.seed),
                         device=device)
    engine = Engine(model, params, batch_slots=args.slots,
                    max_len=args.max_len, device=device)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab, rng.integers(4, 24))
                    .astype(np.int32), max_new=args.max_new)
            for _ in range(args.requests)]
    stats = engine.run(reqs)
    print(f"served {len(reqs)} requests, {stats['tokens_out']} tokens in "
          f"{stats['wall_s']:.2f}s -> {stats['tok_per_s']:.1f} tok/s "
          f"({device})")
    if not all(r.out is not None and len(r.out) > 0 for r in reqs):
        raise RuntimeError("a request came back empty")
    return stats


if __name__ == "__main__":
    main()
