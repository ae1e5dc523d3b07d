"""Operation handlers, one module an ``op`` name of a traffic mix
(``traffic.py`` says what a handler gives)."""
