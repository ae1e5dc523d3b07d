# The Accumulo-analogue database layer on PyTorch: sharded sorted KV store
# (LSM engine, or the legacy single-run engine) + the paper's Listing-1
# connector API + D4M 2.0 schema.
from .connector import (DBserver, ReadPlan, Table, TablePair, TransposedView,
                        dbinit, dbsetup, delete, put, putTriple,
                        recover_connector)
from .kvstore import ShardedTable, StoreConfig
from .schema import DegreeTable, EdgeSchema
from .naive import NaiveTable
from . import graphulo
from . import lsm

__all__ = [
    "DBserver", "DegreeTable", "EdgeSchema", "NaiveTable", "ReadPlan",
    "ShardedTable", "StoreConfig", "Table", "TablePair", "TransposedView",
    "dbinit", "dbsetup", "delete", "graphulo", "lsm", "put", "putTriple",
    "recover_connector",
]
