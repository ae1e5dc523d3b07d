#!/usr/bin/env python3
"""Where the tensor-core prefill of ``flash_attention.cu`` spends its time,
on one NVIDIA GPU: builds the kernel source as it is and three cut-down
copies of it, then times each at serving run b's prefill ([4, 1920, 9, 64]
over a [4, 2048, 3, 64] cache, bf16) and one of its decode steps, through
the C entry point, by CUDA-graph replay.

    python3 experiments/flash_attention_ablation.py

Variants (each an exact text edit of the source; the script stops if an
edit no longer matches):
  full        the kernel as committed;
  single_p    P V with P_hi only (P rounded to bf16: not the function, a
              measure of what the lo products cost);
  no_pv       no P V product at all (scores and softmax only);
  staging     no math: the K/V tiles staged, waited for and released only.
Prints one JSON object per variant, with the card's name and power limit.
"""
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
OUT = ROOT / "build" / "ablation"
EDITS = {
    "full": [],
    "single_p": [("for (int part = 0; part < 2; ++part)",
                  "for (int part = 0; part < 1; ++part)")],
    "no_pv": [("for (int kk = 0; kk < kN / 2; ++kk) {",
               "for (int kk = 0; kk < 0; ++kk) {")],
    "staging": [("if (!causal || k0 <= warp_last) {", "if (false) {")],
}


def build():
    """Write and compile every variant in parallel; returns {name: .so}."""
    text = SRC.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    procs = {}
    for name, edits in EDITS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"{name}: edit {old!r} matches "
                                 f"{src.count(old)} times")
            src = src.replace(old, new)
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(src)
        procs[name] = (so, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-shared", str(cu), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (so, p) in procs.items():
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        libs[name] = so
    return libs


def main():
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import graph_ms
    from repro_torch.kernels.flash_attention.ops import decode_splits
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    P, I = ctypes.c_void_p, ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(sq):
        return [torch.randn(s, device="cuda", generator=gen).bfloat16()
                for s in ((4, sq, 9, 64), (4, 2048, 3, 64), (4, 2048, 3, 64))]
    prefill, decode = inputs(1920), inputs(1)
    for name, so in build().items():
        fn = ctypes.CDLL(str(so)).flash_attention
        fn.argtypes = [P] * 5 + [I] * 10 + [P]
        fn.restype = I

        def call(q, k, v, off):
            sq = q.shape[1]
            splits = decode_splits(4, sq, 2048, 9, 3, True, off) \
                if sq < 16 else 0
            o = torch.empty_like(q)
            ws = torch.empty(4 * splits * sq * 9 * 66, device="cuda") \
                if splits > 1 else None
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     0 if ws is None else ws.data_ptr(), 4, sq, 2048, 9, 3,
                     64, 1, off, 1, splits,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            return o
        print(json.dumps({
            "variant": name, "card": card,
            "prefill_ms": graph_ms(lambda: call(*prefill, 0), 30),
            "decode_ms": graph_ms(lambda: call(*decode, 2000), 50)}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
