"""Edge generators, one module a configuration's ``generator``."""
