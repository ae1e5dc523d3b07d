from .graph500 import graph500_triples, kronecker_edges, vertex_strings

__all__ = ["graph500_triples", "kronecker_edges", "vertex_strings"]
