from .graph500 import graph500_triples, kronecker_edges, vertex_strings
from .tokens import TokenStore, synthetic_corpus

__all__ = ["graph500_triples", "kronecker_edges", "vertex_strings",
           "TokenStore", "synthetic_corpus"]
