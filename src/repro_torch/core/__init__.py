# The paper's primary contribution: associative arrays (core/assoc.py) and
# the string-interning boundary (core/dictionary.py). The database layer
# built on top of these lives in repro_torch.db.
from .assoc import Assoc, split_str
from .dictionary import StringDict

__all__ = ["Assoc", "StringDict", "split_str"]
