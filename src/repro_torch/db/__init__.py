# The Accumulo-analogue database layer on PyTorch: sharded sorted KV store
# (LSM engine) + the paper's Listing-1 connector API.
from .connector import (DBserver, ReadPlan, Table, TablePair, TransposedView,
                        dbinit, dbsetup, delete, put, putTriple)
from .kvstore import ShardedTable, StoreConfig
from . import lsm

__all__ = [
    "DBserver", "ReadPlan", "ShardedTable", "StoreConfig", "Table",
    "TablePair", "TransposedView", "dbinit", "dbsetup", "delete", "lsm",
    "put", "putTriple",
]
