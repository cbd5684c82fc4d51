"""Builders of the systems under test, one module a program."""
