"""Quickstart on the PyTorch port: associative arrays + the paper's
Listing-1 database workflow.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

On the card (the default) the store runs the hand kernels; with
``--device cpu`` it runs their plain PyTorch versions.
"""
import argparse

import torch

from repro_torch.core import Assoc
from repro_torch.db import dbinit, dbsetup, delete, put

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda")
dev = torch.device(ap.parse_args().device)

# --- associative arrays (paper §II) ---------------------------------------
A = Assoc("alice,alice,bob,carl,", "bob,carl,alice,alice,", [1.0, 2.0, 3.0, 4.0])
print("A =\n", A)

print("\nrow query     A['alice,',:]        ->\n", A["alice,", :])
print("\nprefix query  A['al*,',:]          ->\n", A["al*,", :])
print("\nrange query   A['alice,:,bob,',:]  ->\n", A["alice,:,bob,", :])
print("\nvalue filter  A == 4.0             ->\n", A == 4.0)

B = Assoc("alice,dan,", "carl,alice,", [10.0, 20.0])
print("\nA + B ->\n", A + B)
print("\nA & B ->\n", A & B)

# BFS == matrix-vector multiply (paper Fig. 1)
seed = Assoc("q,", "alice,", 1.0)
print("\nneighbors of alice via seed*A ->\n", seed * A)

# --- database workflow (paper Listing 1) ----------------------------------
dbinit()
DB = dbsetup("mydb02", num_shards=4, capacity_per_shard=4096,
             batch_cap=2048, id_capacity=1 << 16,
             use_pallas=dev.type == "cuda", device=dev)
Tedge = DB["my_Tedge", "my_TedgeT"]
TedgeDeg = DB["my_TedgeDeg"]

put(Tedge, A)
print("\nTedge['alice,',:] ->\n", Tedge["alice,", :])
print("\nTedge[:,'alice,'] (transpose-routed) ->\n", Tedge[:, "alice,"])
assert Tedge["alice,", :].nnz() == 2 and Tedge[:, "alice,"].nnz() == 2

delete(Tedge)
delete(TedgeDeg)
print("\ntables after delete:", DB.ls())
assert DB.ls() == []
print("OK")
