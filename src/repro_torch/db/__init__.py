# The Accumulo-analogue database layer on PyTorch: sharded sorted KV store
# (LSM engine, or the legacy single-run engine) + the paper's Listing-1
# connector API + D4M 2.0 schema, and the SPMD ingest mesh (``spmd``, on
# torch.distributed).
from .connector import (DBserver, ReadPlan, Table, TablePair, TransposedView,
                        dbinit, dbsetup, delete, put, putTriple,
                        recover_connector)
from .kvstore import ShardedTable, StoreConfig
from .schema import DegreeTable, EdgeSchema
from .naive import NaiveTable
from .spmd import (L0Stack, from_jax_stacked, l0_stacked_empty, make_mesh,
                   merge_process_metrics, stacked_empty, to_stacked_numpy)
from . import graphulo
from . import lsm
from . import spmd

__all__ = [
    "DBserver", "DegreeTable", "EdgeSchema", "L0Stack", "NaiveTable",
    "ReadPlan", "ShardedTable", "StoreConfig", "Table", "TablePair",
    "TransposedView", "dbinit", "dbsetup", "delete", "from_jax_stacked",
    "graphulo", "l0_stacked_empty", "lsm", "make_mesh",
    "merge_process_metrics", "put", "putTriple", "recover_connector",
    "spmd", "stacked_empty", "to_stacked_numpy",
]
