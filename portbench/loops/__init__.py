"""Loops that offer a mix's operations through the window, one module a
mix's ``loop``."""
