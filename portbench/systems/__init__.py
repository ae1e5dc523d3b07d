"""Systems under test, one module a kind of configuration (named by the
configuration file's ``system``), each with its plain reference beside it."""
